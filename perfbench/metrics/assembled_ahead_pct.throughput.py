"""Share of the window's dispatched batches (``batcher.batch`` spans) whose
bucket the program had sealed before the previous batch's serving call
returned: the spans that count ``batcher.assembled_ahead`` over those that
count it or ``batcher.assembled_inline``, in percent; None where neither
was counted (a program that builds each bucket on its dispatch thread)."""

from perfbench.spans import recorded

LAYER = "server.py batcher"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "serve_samples_per_s"


def read(rec):
    counts = [s["counts"] for s in recorded(rec, "batcher.batch")]
    ahead = sum(1 for c in counts if c.get("batcher.assembled_ahead"))
    inline = sum(1 for c in counts if c.get("batcher.assembled_inline"))
    if not ahead + inline:
        return None
    return 100.0 * ahead / (ahead + inline)
