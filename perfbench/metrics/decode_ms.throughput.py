"""Mean milliseconds the HTTP front end took to read a request's body,
decode its ``.npy`` and check its rank, per request (the program's
``http.decode`` spans)."""

from perfbench.spans import ms, recorded

LAYER = "server.py batcher"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "serve_samples_per_s"


def read(rec):
    spans = recorded(rec, "http.decode")
    return sum(ms(s) for s in spans) / len(spans) if spans else None
