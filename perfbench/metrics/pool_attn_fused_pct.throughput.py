"""Share of the pooling attention calls in the window's dispatched batches
(``batcher.batch`` spans) that ran the fused kernel: the counts
``mvit.pool_attn`` over those and ``mvit.pool_attn.plain``, in percent."""

from perfbench.spans import recorded

LAYER = "model forward (models/, serve.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "serve_samples_per_s"


def read(rec):
    counts = [s["counts"] for s in recorded(rec, "batcher.batch")]
    fused = sum(c.get("mvit.pool_attn", 0) for c in counts)
    plain = sum(c.get("mvit.pool_attn.plain", 0) for c in counts)
    if not fused + plain:
        return None
    return 100.0 * fused / (fused + plain)
