"""Share of the window's dispatched batches (``batcher.batch`` spans) that
the program served through its channel-aligned R(2+1)D trunk: the batches
whose span counts ``serve.aligned_trunk``, in percent of all."""

from perfbench.spans import recorded

LAYER = "model forward (models/, serve.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "serve_samples_per_s"


def read(rec):
    batches = recorded(rec, "batcher.batch")
    if not batches:
        return None
    aligned = sum(1 for s in batches if s["counts"].get("serve.aligned_trunk"))
    return 100.0 * aligned / len(batches)
