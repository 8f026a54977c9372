"""The program's own spans for the per-layer readers: what
``protoasnet_tpu_torch/utils/profiling.py`` recorded in this process. The
program records spans only while a torch profiler is open; a traced run
opens one 1 s before its window (no traffic, no step yet) and closes it
after, and the close stalls the program for about a second (the batch in
flight then took 1.26-1.29 s on the card against ~0.4 s). So a reader
takes the spans that ended inside the window: the window opens with the
first span and lasts the trace's ``window_s``. A program without the
recorder gives none, and its readers return None."""

from __future__ import annotations

from typing import Dict, List


def recorded(rec: Dict, name: str) -> List[Dict]:
    """The spans named ``name`` that ended inside the window."""
    from protoasnet_tpu_torch.utils import profiling

    get = getattr(profiling, "spans", None)
    spans = [] if get is None else get()
    if spans and rec.get("window_s"):
        end = min(s["start_ns"] for s in spans) + rec["window_s"] * 1e9
        spans = [s for s in spans if s["end_ns"] <= end]
    return [s for s in spans if s["name"] == name]


def ms(span: Dict) -> float:
    return (span["end_ns"] - span["start_ns"]) * 1e-6


def per_batch_ms(rec: Dict, name: str):
    """Milliseconds in spans ``name`` over the batches the daemon
    dispatched (``batcher.batch``), or None without either."""
    batches = {s["id"] for s in recorded(rec, "batcher.batch")}
    parts = [s for s in recorded(rec, name) if s["parent"] in batches]
    if not parts:
        return None
    return sum(ms(s) for s in parts) / len(batches)
