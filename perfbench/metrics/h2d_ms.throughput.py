"""Mean milliseconds of the serving function's host-to-device copy of a
batch, per dispatched batch (the program's ``serve.h2d`` over
``batcher.batch`` spans)."""

from perfbench.spans import per_batch_ms

LAYER = "model forward (models/, serve.py)"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "serve_samples_per_s"


def read(rec):
    return per_batch_ms(rec, "serve.h2d")
