"""Process group, data mesh and batch helpers: the port's distributed layer
(the JAX package's ``parallel/mesh.py`` on ``torch.distributed``).

One process per card, launched by PyTorch's launcher::

    python -m torch.distributed.run --nproc_per_node=N \
        -m protoasnet_tpu_torch.main --config_path=...

The processes form a 1-D ``data`` mesh. Each global batch is split on the
batch axis into equal blocks of rows, rank r holding block r on
``cuda:LOCAL_RANK``. Data parallelism is explicit, where GSPMD made it
implicit in the JAX package:

* every mean of the step is over the global batch: BatchNorm's moments
  (``models/norm.py``), the losses' valid counts and the batch-free terms
  (``losses/bundle.py``), each rank's loss being its share of the global
  loss;
* the gradients are summed across ranks once per optimiser step
  (``sync_grads``), so accumulation micro-steps communicate nothing;
* the push takes the global first minimum over every rank's winners
  (``first_min_across_ranks``); epoch metrics and prediction CSVs gather
  the rows (``gather_rows``).

``fsdp_param_shardings`` is the ZeRO-3 placement of the JAX package: FSDP2
(``fully_shard``) over the same mesh. Without a process group every helper
is the identity, so a single-process run is the port as it was.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["distributed_requested", "maybe_initialize_distributed",
           "shutdown_distributed", "joined_group", "world_size", "rank",
           "is_main",
           "local_device", "make_mesh", "row_slice", "shard_batch",
           "global_batch_from_local", "replicate", "fsdp_placements",
           "fsdp_param_shardings", "all_reduce_sum", "sync_grads",
           "gather_rows", "first_min_across_ranks", "broadcast_object",
           "barrier"]

# the batch fields split on the batch axis (the rest is passed through)
_ARRAY_KEYS = (
    "cine", "target_AS", "t_len", "interval_idx", "window_start",
    "window_end", "original_length", "valid", "target_dev", "valid_dev",
)

_BUCKET_BYTES = 32 << 20  # the gradient all-reduce's bucket


def distributed_requested() -> bool:
    """From the environment alone: did PyTorch's launcher start this
    process as one of a group (``WORLD_SIZE`` > 1, or ``MASTER_ADDR``
    set, as ``torch.distributed.run`` does even for one process)?"""
    return (int(os.environ.get("WORLD_SIZE", "1") or 1) > 1
            or "MASTER_ADDR" in os.environ)


def local_device(device: Optional[Union[str, torch.device]] = None
                 ) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for a CUDA request under the
    launcher (plain ``cuda`` otherwise), the CPU as asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in \
            os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def maybe_initialize_distributed(
        device: Optional[Union[str, torch.device]] = None,
        backend: Optional[str] = None) -> bool:
    """Join the launcher's process group; call once at process entry
    (``main.py`` and ``explain`` do).

    Without the launcher's variables this does nothing and returns False.
    With them the group is NCCL's on a CUDA ``device`` (the default; this
    rank's card becomes the current one) and gloo's on the CPU;
    ``backend`` overrides that choice. When the group cannot be joined
    this raises rather than fall back to independent single-process
    runs, each training on its own batches and writing the same run
    directory. Returns True when more than one process runs."""
    if not distributed_requested():
        return False
    if dist.is_initialized():
        return world_size() > 1
    dev = local_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend)
    except Exception as e:  # noqa: BLE001 — re-raised with the reason
        raise RuntimeError(
            "multi-process run requested (WORLD_SIZE / MASTER_ADDR set) but "
            f"init_process_group({backend!r}) failed; refusing to fall back "
            "to an independent single-process run") from e
    return world_size() > 1


def shutdown_distributed() -> None:
    """Tear the process group down, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def joined_group(device: Optional[Union[str, torch.device]] = None):
    """An entry point's process group: ``maybe_initialize_distributed`` on
    entry, and on exit the group torn down if this joined it (a caller's
    own group is left as it was)."""
    joined = not _active()
    maybe_initialize_distributed(device)
    try:
        yield
    finally:
        if joined:
            shutdown_distributed()


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if _active() else 1


def rank() -> int:
    return dist.get_rank() if _active() else 0


def is_main() -> bool:
    """Rank 0, or no process group: the process that writes files."""
    return rank() == 0


def make_mesh(device_type: Optional[str] = None):
    """The 1-D ``data`` mesh over all ranks (a ``DeviceMesh``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, (world_size(),),
                            mesh_dim_names=("data",))


def row_slice(n: int) -> slice:
    """This rank's rows of a global batch of ``n`` (equal blocks)."""
    w = world_size()
    if n % w:
        raise ValueError(f"global batch {n} does not split into {w} equal "
                         f"blocks")
    r, k = rank(), n // w
    return slice(r * k, (r + 1) * k)


def shard_batch(batch: Dict[str, Any],
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """This rank's rows of the array fields of a global batch (numpy or
    tensors; onto ``device`` when given); other fields pass through."""
    out = dict(batch)
    for k in _ARRAY_KEYS:
        if k in out and hasattr(out[k], "shape"):
            part = out[k][row_slice(out[k].shape[0])]
            if device is not None:
                part = torch.as_tensor(part).to(device)
            out[k] = part
    return out


def global_batch_from_local(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``shard_batch`` for the tensor fields: every rank's
    rows gathered in rank order; other fields pass through."""
    out = dict(batch)
    for k in _ARRAY_KEYS:
        if isinstance(out.get(k), torch.Tensor):
            out[k] = gather_rows(out[k])
    return out


@torch.no_grad()
def replicate(module: nn.Module) -> nn.Module:
    """Rank 0's parameters and buffers broadcast to every rank, in place."""
    if _active():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, 0)
    return module


def fsdp_placements(model: nn.Module, n: int, min_size: int = 1 << 14
                    ) -> Dict[str, Optional[int]]:
    """The JAX package's ZeRO-3 rule per parameter name: a parameter of at
    least ``min_size`` elements shards its largest dimension divisible by
    ``n`` (the dim's index), anything else stays whole (None)."""
    out: Dict[str, Optional[int]] = {}
    for name, p in model.named_parameters():
        dims = list(p.shape)
        cands = [i for i, d in enumerate(dims) if d % n == 0 and d >= n]
        out[name] = (max(cands, key=lambda j: dims[j])
                     if p.numel() >= min_size and cands else None)
    return out


def fsdp_param_shardings(model: nn.Module, mesh=None,
                         min_size: int = 1 << 14
                         ) -> Dict[str, Optional[int]]:
    """ZeRO-3 placement of ``model`` over the data mesh with FSDP2, in
    place; returns ``fsdp_placements``.

    The whole model is one ``fully_shard`` unit: each parameter's dim of
    ``fsdp_placements`` is sharded (``Shard(dim)``), so the parameters,
    their gradients and the Adam moments made from them (``GroupAdam``;
    the JAX package's ``opt_state_shardings``) live 1/N per rank between
    steps, and are gathered for the step's forward and backward. A small
    parameter stays whole and replicated (FSDP2's ``ignored_params``); its
    gradient is summed by ``sync_grads`` with the data-parallel ones. The
    gradient reduction sums (divide factor 1), as ``sync_grads`` does:
    each rank's loss is its share of the global one."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    mesh = mesh if mesh is not None else make_mesh()
    plan = fsdp_placements(model, mesh.size(), min_size)
    by_param = {p: plan[name] for name, p in model.named_parameters()}
    whole = {p for p, dim in by_param.items() if dim is None}
    replicate(model)
    fully_shard(model, mesh=mesh, ignored_params=whole,
                shard_placement_fn=lambda p: Shard(by_param[p]))
    model.set_gradient_divide_factor(1.0)
    model.set_force_sum_reduction_for_comms(True)  # gloo has no PREMUL_SUM
    return plan


class _AllReduceSum(torch.autograd.Function):
    """Sum across ranks whose gradient is the sum across ranks of the
    gradients: the backward of a global sum that every rank's loss
    reads."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over ranks (differentiable); ``t`` itself without a
    group."""
    return _AllReduceSum.apply(t) if _active() else t


@torch.no_grad()
def sync_grads(params: Sequence[nn.Parameter]) -> None:
    """Sum every plain parameter's ``.grad`` over ranks, in buckets of
    ``_BUCKET_BYTES`` per dtype; a missing gradient takes part as zeros
    (a frozen group on one rank is frozen on all). FSDP2's sharded
    parameters are skipped: their reduce-scatter ran in the backward."""
    if not _active():
        return
    from torch.distributed.tensor import DTensor

    plain = [p for p in params if not isinstance(p, DTensor)]
    for p in plain:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype: Dict[torch.dtype, list] = {}
    for p in plain:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        bucket, size = [], 0
        for g in grads + [None]:
            if g is not None:
                bucket.append(g)
                size += g.numel() * g.element_size()
            if bucket and (g is None or size >= _BUCKET_BYTES):
                flat = torch.cat([b.reshape(-1) for b in bucket])
                dist.all_reduce(flat)
                for b, part in zip(bucket, flat.split(
                        [b.numel() for b in bucket])):
                    b.copy_(part.view_as(b))
                bucket, size = [], 0


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` stacked on dim 0 in rank order (the global
    batch's rows from each rank's block); ``t`` without a group."""
    if not _active() or world_size() == 1:
        return t
    t = t.contiguous()
    out = t.new_empty((world_size() * t.shape[0],) + tuple(t.shape[1:]))
    if t.dtype == torch.bool:  # no bool collectives on every backend
        dist.all_gather_into_tensor(out.view(torch.uint8),
                                    t.view(torch.uint8))
    else:
        dist.all_gather_into_tensor(out, t)
    return out


def first_min_across_ranks(best: torch.Tensor, idx: torch.Tensor,
                           rows: int, *payload: torch.Tensor):
    """Merge per-rank winners into the global first minimum.

    best (P,) each rank's least value per column, idx (P,) its row in the
    rank's block of ``rows``, payload (P, ...) what goes with the winner.
    Returns (best, global row, *payload) of the rank holding the least
    value, the lowest rank on a tie: ranks hold consecutive blocks, so
    that is the lowest global row, as ``argmin`` over the whole batch
    gives. Without a group: (best, idx, *payload)."""
    if not _active() or world_size() == 1:
        return (best, idx, *payload)
    w, p = world_size(), best.shape[0]
    all_best = gather_rows(best[None]).reshape(w, p)
    all_idx = gather_rows(idx[None]).reshape(w, p)
    win = torch.argmin(all_best, dim=0)  # first minimum: the lowest rank
    ar = torch.arange(p, device=best.device)
    merged = [gather_rows(t[None]).reshape(w, *t.shape)[win, ar]
              for t in payload]
    return (all_best[win, ar], all_idx[win, ar] + win * rows, *merged)


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (a picklable object)."""
    if not _active() or world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]


def barrier() -> None:
    if _active():
        dist.barrier()
