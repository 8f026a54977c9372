"""On-device epoch metric accumulation (the JAX package's
``train/device_metrics.py`` in torch).

The host path copies each step's loss terms, logits and similarities to
the host, a synchronisation per step. Here each step's outputs are written
into buffers preallocated on the model's device (in-place slice copies, a
loss-sum vector and a batch count, no host synchronisation); at the
epoch's end one device -> host copy feeds the port's ``EpochMetrics`` as
one mega-batch. ``train.on_device_metrics`` (default true, as in the JAX
package) picks this path; val_push and test keep the host path, because
their prediction CSVs need per-sample metadata.

Under data parallelism each rank's buffers hold its rows of every batch;
``finalize`` gathers them from all ranks back into the global batches'
order, so every rank's summary is the single-process one. The loss sums
are already the global batch's (``losses/bundle.py::global_terms``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import torch

from protoasnet_tpu_torch.parallel.mesh import gather_rows, world_size

__all__ = ["DeviceEpochBuffer"]


class DeviceEpochBuffer:
    """Preallocated device buffers for one epoch's outputs: fp32 logits and
    similarities, int32 targets, bool valid, the loss terms' sums and the
    number of batches."""

    def __init__(self, n_batches: int, batch_size: int, num_logits: int,
                 num_prototypes: int, loss_names: Iterable[str],
                 device: torch.device):
        n = n_batches * batch_size
        self.batch_size = batch_size
        self.loss_names = list(loss_names)
        f32 = dict(dtype=torch.float32, device=device)
        self.logits = torch.zeros((n, num_logits), **f32)
        self.sims = torch.zeros((n, num_prototypes), **f32)
        self.target = torch.zeros((n,), dtype=torch.int32, device=device)
        self.valid = torch.zeros((n,), dtype=torch.bool, device=device)
        self.loss_sums = torch.zeros((len(self.loss_names),), **f32)
        self.n_batches = torch.zeros((), dtype=torch.int32, device=device)
        self._offset = 0

    def update(self, metrics: Dict[str, Any], target: torch.Tensor,
               valid: torch.Tensor) -> None:
        """Write this step's outputs into the buffers (device work only)."""
        rows = slice(self._offset, self._offset + metrics["logits"].shape[0])
        self.logits[rows].copy_(metrics["logits"])
        self.sims[rows].copy_(metrics["similarities"])
        self.target[rows].copy_(target)
        self.valid[rows].copy_(valid)
        self.loss_sums += torch.stack(
            [metrics[k].to(torch.float32) for k in self.loss_names])
        self.n_batches += 1
        self._offset = rows.stop

    def _global_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t``, in the global batches' order."""
        w = world_size()
        if w == 1:
            return t
        rest = tuple(t.shape[1:])
        per_rank = gather_rows(t).reshape(w, -1, self.batch_size, *rest)
        return per_rank.transpose(0, 1).reshape(-1, *rest)

    def finalize(self, epoch_metrics) -> Dict[str, float]:
        """One device -> host copy; feeds ``epoch_metrics`` one mega-batch
        and returns the per-batch means of the loss terms."""
        bufs = tuple(self._global_rows(b) for b in (
            self.logits, self.sims, self.target, self.valid)) + (
            self.loss_sums, self.n_batches)
        host = torch.cat([b.reshape(-1).to(torch.float32) for b in bufs]
                         ).cpu()
        logits, sims, target, valid, sums, n_b = (
            h.view(b.shape).numpy() for h, b in zip(
                host.split([b.numel() for b in bufs]), bufs))
        n_b = max(int(n_b), 1)
        # per-batch means; EpochMetrics sees one mega-batch (n_batches=1),
        # so its compute() returns these unchanged
        loss_terms = {name: float(v) / n_b
                      for name, v in zip(self.loss_names, sums)}
        epoch_metrics.update(logits, target.astype("int32"),
                             valid.astype(bool), similarities=sims,
                             loss_terms=loss_terms)
        return loss_terms
