"""95th percentile (nearest rank) of the time a request's chunk waited in
the batcher: from its enqueue to the start of the serving call of the batch
that carried it (the program's ``batcher.queue`` spans that ended in the
window)."""

from perfbench.schedule import nearest_rank
from perfbench.spans import ms, recorded

LAYER = "server.py batcher"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "serve_p95_ms"


def read(rec):
    waits = [ms(s) for s in recorded(rec, "batcher.queue")]
    return nearest_rank(waits, 0.95) if waits else None
