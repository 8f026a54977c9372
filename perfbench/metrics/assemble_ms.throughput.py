"""Mean milliseconds the dispatch thread took to build a batch's bucket
(its ``np.zeros`` and the requests' rows copied in), per dispatched batch
(the program's ``batcher.assemble`` over ``batcher.batch`` spans)."""

from perfbench.spans import per_batch_ms

LAYER = "server.py batcher"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "serve_samples_per_s"


def read(rec):
    return per_batch_ms(rec, "batcher.assemble")
