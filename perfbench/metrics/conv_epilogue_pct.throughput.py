"""Share of the served R(2+1)D trunk's conv epilogues in the window's
dispatched batches (``batcher.batch`` spans) that ran the hand-written
kernel: the counts ``serve.conv_epilogue`` over those and
``serve.conv_epilogue.plain``, in percent; None where neither was counted
(a program without the epilogue)."""

from perfbench.spans import recorded

LAYER = "model forward (models/, serve.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "serve_samples_per_s"


def read(rec):
    counts = [s["counts"] for s in recorded(rec, "batcher.batch")]
    kernel = sum(c.get("serve.conv_epilogue", 0) for c in counts)
    plain = sum(c.get("serve.conv_epilogue.plain", 0) for c in counts)
    if not kernel + plain:
        return None
    return 100.0 * kernel / (kernel + plain)
