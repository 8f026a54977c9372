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

Prototype tensor parallelism (the JAX package's ``make_mesh_2d`` and
``prototype_param_shardings``): ``make_mesh_2d(n_data, n_model)`` lays the
ranks out row-major on a (data, model) grid, rank = d * n_model + m, and
forms the two families of groups. Every collective above names its group
and defaults to the ``data`` group, which is the world on the 1-D mesh: the
batch rows, BatchNorm's moments, the losses' counts, the gradient sum and
the push's winners are counted once per data rank. ``prototype_param_
shardings`` keeps each model rank's P / n_model prototypes: the rows of
``prototype_vectors``, the readout's columns and the occurrence module's
final rows (``PrototypeShard``). GSPMD partitioned the JAX head; here the
head is split explicitly, Megatron's way, with three differentiable
collectives over ``model`` (``copy_to_model``, ``reduce_from_model``,
``gather_from_model``; ``models/xprotonet.py``, ``models/protopnet.py``).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["distributed_requested", "maybe_initialize_distributed",
           "shutdown_distributed", "joined_group", "world_size", "rank",
           "is_main", "data_group", "data_size", "data_rank",
           "local_device", "make_mesh", "Mesh2D", "make_mesh_2d",
           "row_slice", "shard_batch",
           "global_batch_from_local", "replicate", "fsdp_placements",
           "fsdp_param_shardings", "PrototypeShard", "prototype_placements",
           "prototype_param_shardings", "local_shard", "gather_shard",
           "copy_to_model", "reduce_from_model", "gather_from_model",
           "gather_objects_from_model",
           "all_reduce_sum", "sync_grads",
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
    """Tear the process group down, if there is one (its 2-D mesh too)."""
    global _MESH
    _MESH = None
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


@dataclass
class Mesh2D:
    """A (data, model) grid of the ranks, rank = d * n_model + m: this
    rank's ``data`` group (the ranks of its column m) and ``model`` group
    (those of its row d); None for a one-rank axis of a run without a
    process group."""

    n_data: int
    n_model: int
    data_group: Any
    model_group: Any
    world: Any  # the default group the mesh was made in

    @property
    def data_rank(self) -> int:
        return rank() // self.n_model

    @property
    def model_rank(self) -> int:
        return rank() % self.n_model


_MESH: Optional[Mesh2D] = None


def _default_group():
    return dist.distributed_c10d._get_default_group() if _active() else None


def make_mesh_2d(n_data: int, n_model: int) -> Mesh2D:
    """The 2-D (data, model) mesh for data x prototype-tensor parallelism.

    Raises, as the JAX package's does, when the mesh needs more ranks than
    the group has; and when it has fewer (each process is one cell of the
    grid), or when the groups cannot be formed: never a 1-D mesh instead.
    The mesh becomes the process's: the collectives' ``data`` group."""
    global _MESH
    n_data, n_model = int(n_data), int(n_model)
    w = world_size()
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh {n_data}x{n_model}: both axes need >= 1")
    if n_data * n_model > w:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} "
                         f"devices, have {w}")
    if n_data * n_model < w:
        raise ValueError(f"mesh {n_data}x{n_model} covers "
                         f"{n_data * n_model} of the group's {w} ranks; "
                         f"each rank must be one cell of the mesh")
    if w == 1:
        _MESH = Mesh2D(1, 1, None, None, None)
        return _MESH
    try:
        model_group, _ = dist.new_subgroups_by_enumeration(
            [list(range(d * n_model, (d + 1) * n_model))
             for d in range(n_data)])
        data_group, _ = dist.new_subgroups_by_enumeration(
            [list(range(m, w, n_model)) for m in range(n_model)])
    except Exception as e:  # noqa: BLE001 — re-raised with the reason
        raise RuntimeError(
            f"the groups of mesh {n_data}x{n_model} could not be formed; "
            f"refusing to fall back to a 1-D mesh") from e
    _MESH = Mesh2D(n_data, n_model, data_group, model_group,
                   _default_group())
    return _MESH


def _mesh() -> Optional[Mesh2D]:
    """The process's 2-D mesh, if one was made in the live group."""
    m = _MESH
    if m is None or m.world is None or not _active() or \
            m.world is not _default_group():
        return None
    return m


def data_group():
    """The ``data`` group: the 2-D mesh's, else the world (None)."""
    m = _mesh()
    return None if m is None else m.data_group


def _group_size(group) -> int:
    return dist.get_world_size(group) if _active() else 1


def data_size() -> int:
    """The number of data ranks: the batch is split this many ways."""
    return _group_size(data_group())


def data_rank() -> int:
    """This rank's place on the ``data`` axis (its block of rows)."""
    return dist.get_rank(data_group()) if _active() else 0


def row_slice(n: int) -> slice:
    """This rank's rows of a global batch of ``n`` (equal blocks, one a
    data rank)."""
    w = data_size()
    if n % w:
        raise ValueError(f"global batch {n} does not split into {w} equal "
                         f"blocks")
    r, k = data_rank(), n // w
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


def _group(group):
    """A collective's group: the ``data`` group unless one is named."""
    return data_group() if group is None else group


def _wire(t: torch.Tensor) -> torch.Tensor:
    """At least fp32 on the wire (gloo sums no bf16); float64 stays."""
    return t if t.dtype in (torch.float32, torch.float64) else t.float()


def _all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank of ``group``'s ``t`` concatenated on ``dim`` in rank
    order (a list all-gather: gloo takes it on card tensors too)."""
    t = t.contiguous()
    wire = t.view(torch.uint8) if t.dtype == torch.bool else t
    parts = [torch.empty_like(wire) for _ in range(_group_size(group))]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim)
    return out.view(torch.bool) if t.dtype == torch.bool else out


class _AllReduceSum(torch.autograd.Function):
    """Sum across the ranks of a group whose gradient is the sum across
    them of the gradients: the backward of a global sum that every rank's
    loss reads (each rank's loss a share of the objective)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (the ``data`` group by
    default; differentiable); ``t`` itself without a process group."""
    return _AllReduceSum.apply(t, _group(group)) if _active() else t


@torch.no_grad()
def sync_grads(params: Sequence[nn.Parameter]) -> None:
    """Sum every plain parameter's ``.grad`` over the ``data`` group (a
    prototype shard's gradient and a replicated parameter's, made whole
    over ``model`` in the backward, are data-all-reduced only), in buckets
    of ``_BUCKET_BYTES`` per dtype; a missing gradient takes part as zeros
    (a frozen group on one rank is frozen on all). FSDP2's sharded
    parameters are skipped: their reduce-scatter ran in the backward."""
    group = data_group()
    if not _active() or _group_size(group) == 1:
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
                dist.all_reduce(flat, group=group)
                for b, part in zip(bucket, flat.split(
                        [b.numel() for b in bucket])):
                    b.copy_(part.view_as(b))
                bucket, size = [], 0


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` (the ``data`` group by default)
    stacked on dim 0 in rank order: the global batch's rows from each data
    rank's block; ``t`` without a process group."""
    group = _group(group)
    if not _active() or _group_size(group) == 1:
        return t
    return _all_gather(t, group)


def first_min_across_ranks(best: torch.Tensor, idx: torch.Tensor,
                           rows: int, *payload: torch.Tensor):
    """Merge per-rank winners into the global first minimum over the
    ``data`` group.

    best (P,) each rank's least value per column, idx (P,) its row in the
    rank's block of ``rows``, payload (P, ...) what goes with the winner.
    Returns (best, global row, *payload) of the rank holding the least
    value, the lowest rank on a tie: ranks hold consecutive blocks, so
    that is the lowest global row, as ``argmin`` over the whole batch
    gives. Without a group: (best, idx, *payload)."""
    group = data_group()
    if not _active() or _group_size(group) == 1:
        return (best, idx, *payload)
    w, p = _group_size(group), best.shape[0]
    all_best = gather_rows(best[None], group).reshape(w, p)
    all_idx = gather_rows(idx[None], group).reshape(w, p)
    win = torch.argmin(all_best, dim=0)  # first minimum: the lowest rank
    ar = torch.arange(p, device=best.device)
    merged = [gather_rows(t[None], group).reshape(w, *t.shape)[win, ar]
              for t in payload]
    return (all_best[win, ar], all_idx[win, ar] + win * rows, *merged)


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` (picklable) on every rank of the world (a run
    directory, a decision rank 0 made)."""
    if not _active() or world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]


def barrier() -> None:
    """Every rank of the world waits for the others."""
    if _active():
        dist.barrier()


# ---------------- prototype tensor parallelism ----------------


@dataclass
class PrototypeShard:
    """This model rank's prototypes: ``size`` equal blocks of the ``total``
    P over ``group``, this rank's block ``rank``."""

    group: Any
    size: int
    rank: int
    total: int

    @property
    def local(self) -> int:
        return self.total // self.size

    @property
    def offset(self) -> int:
        return self.rank * self.local


def _occurrence_final(model: nn.Module) -> Optional[str]:
    """The occurrence module's last Dense, as the JAX rule picks it."""
    occ = getattr(model, "occurrence_module", None)
    if occ is None:
        return None
    return sorted(n for n, _ in occ.named_children()
                  if n.startswith("Dense"))[-1]


def prototype_placements(model: nn.Module) -> Dict[str, Optional[int]]:
    """The JAX package's ``prototype_param_shardings`` rule in the port's
    layouts, per parameter name: the dim sharded over ``model``, or None
    (replicated). ``prototype_vectors`` (P, D) dim 0 (JAX: rows); the
    readout's weight (K, P) dim 1 (JAX kernel (P, K): rows); the occurrence
    module's final weight (P, D/2) dim 0 (JAX kernel (D/2, P): columns)."""
    occ = _occurrence_final(model)
    out: Dict[str, Optional[int]] = {}
    for name, _ in model.named_parameters():
        if name == "prototype_vectors":
            out[name] = 0
        elif name.startswith("last_layer.") and name.endswith(".weight"):
            out[name] = 1
        elif occ is not None and name == f"occurrence_module.{occ}.weight":
            out[name] = 0
        else:
            out[name] = None
    return out


def local_shard(t: torch.Tensor, param: nn.Parameter) -> torch.Tensor:
    """A full tensor shaped as ``param``'s whole: ``param``'s block of it
    when ``param`` is a prototype shard, else ``t``."""
    shard = getattr(param, "prototype_shard", None)
    if shard is None or t.shape == param.shape:
        return t
    return t.narrow(param.prototype_shard_dim, shard.offset,
                    shard.local).contiguous()


def gather_shard(t: torch.Tensor, param: nn.Parameter) -> torch.Tensor:
    """A tensor shaped as ``param`` made whole: gathered over ``model``
    when ``param`` is a prototype shard (every model rank calls it), else
    ``t``."""
    shard = getattr(param, "prototype_shard", None)
    if shard is None or shard.size == 1:
        return t
    return _all_gather(t.detach(), shard.group, param.prototype_shard_dim)


@torch.no_grad()
def prototype_param_shardings(model: nn.Module, mesh: Mesh2D
                              ) -> Dict[str, Optional[int]]:
    """Prototype tensor parallelism over ``mesh``'s ``model`` axis, in
    place; returns ``prototype_placements``.

    Rank 0's parameters go to every rank (``replicate``), then each model
    rank keeps its block of P / n_model prototypes in every parameter of
    the rule; the rest stays whole. P must split into n_model equal blocks,
    or this raises (as a JAX ``device_put`` onto that sharding does). Each
    sharded parameter's ``prototype_shard`` / ``prototype_shard_dim``
    record the block (the model's ``prototype_shard`` reads
    ``prototype_vectors``')."""
    plan = prototype_placements(model)
    p = int(model.prototype_vectors.shape[0])
    if p % mesh.n_model:
        raise ValueError(f"{p} prototypes do not split into {mesh.n_model} "
                         f"equal blocks over the model axis")
    shard = PrototypeShard(mesh.model_group, mesh.n_model, mesh.model_rank,
                           p)
    replicate(model)
    params = dict(model.named_parameters())
    for name, dim in plan.items():
        if dim is None:
            continue
        param = params[name]
        param.data = param.data.narrow(dim, shard.offset,
                                       shard.local).contiguous()
        param.prototype_shard, param.prototype_shard_dim = shard, dim
    model.last_layer.Dense_0.in_features = shard.local
    occ = _occurrence_final(model)
    if occ is not None:
        getattr(model.occurrence_module, occ).out_features = shard.local
    return plan


class _CopyToModel(torch.autograd.Function):
    """Megatron's "f": the identity forward; the backward sums the
    gradient over ``model``, since each model rank's head reads the
    replicated input for its own prototypes only."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        out = _wire(g).clone()
        dist.all_reduce(out, group=ctx.group)
        return out.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's "g": the partial sums over ``model`` added up forward;
    the backward is the identity (every model rank's loss reads the same
    sum)."""

    @staticmethod
    def forward(ctx, t, group):
        out = _wire(t).clone()
        dist.all_reduce(out, group=group)
        return out.to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The model ranks' blocks concatenated on ``dim``; the backward keeps
    this rank's block of the gradient (the loss that reads the whole is
    computed alike on every model rank)."""

    @staticmethod
    def forward(ctx, t, dim, shard):
        ctx.dim, ctx.n, ctx.offset = dim, t.shape[dim], shard.rank * t.shape[
            dim]
        return _all_gather(t, shard.group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.offset, ctx.n).contiguous(), None, None


def _split(shard: Optional[PrototypeShard]) -> bool:
    return shard is not None and shard.size > 1


def copy_to_model(t: torch.Tensor, shard: Optional[PrototypeShard]
                  ) -> torch.Tensor:
    """A replicated tensor entering the prototype-sharded head."""
    return _CopyToModel.apply(t, shard.group) if _split(shard) else t


def reduce_from_model(t: torch.Tensor, shard: Optional[PrototypeShard]
                      ) -> torch.Tensor:
    """The sum over the model ranks of their partial ``t``."""
    return _ReduceFromModel.apply(t, shard.group) if _split(shard) else t


def gather_from_model(t: torch.Tensor, dim: int,
                      shard: Optional[PrototypeShard]) -> torch.Tensor:
    """The whole P from the model ranks' blocks on ``dim``."""
    return _GatherFromModel.apply(t, dim, shard) if _split(shard) else t


def gather_objects_from_model(obj: Any, shard: Optional[PrototypeShard]
                              ) -> List[Any]:
    """Every model rank's ``obj`` (picklable), in model-rank order (the
    order of the prototype blocks); ``[obj]`` when P is not split."""
    if not _split(shard):
        return [obj]
    parts = [None] * shard.size
    dist.all_gather_object(parts, obj, group=shard.group)
    return parts
