"""The shifted-window attention kernel's share of its roofline in the
window: the least time its calls could take (perfbench/kernels/
window_attn.py, one call a block a dispatched batch at the bucket's size)
over the device time of the kernels named window_attn_kernel."""

from perfbench.kernels import window_attn

LAYER = "window attention kernel"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "serve_samples_per_s"


def read(rec):
    peak = rec["peaks"].get(rec["device_name"])
    spent = sum(t for name, t in rec.get("kernels", {}).items()
                if window_attn.KERNEL in name)
    if peak is None or not spent:
        return None
    elem = 2 if rec["config"]["dtype"] == "bfloat16" else 4
    bound = sum(count * window_attn.bound_s(n, rec["config"], elem, peak)
                for n, count in rec["buckets"].items())
    return 100.0 * bound / spent
