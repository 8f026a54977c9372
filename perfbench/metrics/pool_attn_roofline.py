"""The pooling attention kernel's share of its roofline in the window: the
least time its calls could take (perfbench/kernels/pool_attn.py, one call a
block a dispatched batch at the bucket's size) over the device time of the
kernels named pool_attn_kernel."""

from perfbench.kernels import pool_attn

LAYER = "pooling attention kernel"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "serve_samples_per_s"


def read(rec):
    peak = rec["peaks"].get(rec["device_name"])
    spent = sum(t for name, t in rec.get("kernels", {}).items()
                if pool_attn.KERNEL in name)
    if peak is None or not spent or rec["config"]["dtype"] != "bfloat16":
        return None
    bound = sum(count * pool_attn.bound_s(n, rec["config"], peak)
                for n, count in rec["buckets"].items())
    return 100.0 * bound / spent
