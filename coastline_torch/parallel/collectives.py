"""The collectives of the multi-device layer, written on `all_reduce` only.

`all_reduce` (and `broadcast`) are what gloo offers for CUDA tensors as
well as CPU ones, so the same code runs over NCCL on one card a rank, over
gloo on the CPU, and over gloo with two ranks sharing one card:

  * `all_reduce_grad`: a sum that autograd sees (its backward sums the
    cotangents the same way), for train-mode statistics over a batch that
    is split over the ranks;
  * `all_reduce_sum` / `all_reduce_max`: a detached sum or maximum;
  * `gather`: every rank's tensor, stacked in rank order, bit for bit: each
    rank writes its bytes into its slot of a zeroed uint8 buffer and the
    buffers are summed (one non-zero term a byte, so no rounding, and the
    sign of a float zero survives);
  * `barrier`: an all-reduce of one element.

`split_batch(group)` marks the code inside it as running on this rank's
rows of a batch split over `group`: `ops/primitives.py::Norm` then takes
its train-mode statistics over the whole batch.
"""

import contextlib
import warnings
from typing import Optional

import torch
import torch.distributed as dist

# the autograd-visible all-reduce this module builds on, kept while it exists
warnings.filterwarnings("ignore", message="torch.distributed.nn.functional.all_reduce is "
                        "deprecated")

_batch_group = None


def group_size(group=None) -> int:
    """Ranks in `group` (the default group when None); 1 without one."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group=None) -> int:
    """This process's rank in `group`; 0 without a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_main() -> bool:
    """Whether this process writes the run's files and prints its lines:
    rank 0 of the default group, or the only process."""
    return group_rank() == 0


def all_reduce_grad(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `t` over `group`, recorded by autograd."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `t` over `group`, as a new tensor without a graph."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of `t` over `group`, without a graph."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """(ranks, *t.shape): every rank's `t` (same shape and dtype on each) in
    rank order, bit for bit, on `t`'s device."""
    n, r = group_size(group), group_rank(group)
    t = t.detach().contiguous()
    buf = torch.zeros((n, t.numel() * t.element_size()), dtype=torch.uint8, device=t.device)
    buf[r] = t.reshape(-1).view(torch.uint8)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.view(t.dtype).reshape(n, *t.shape)


def barrier(device, group=None):
    """Return once every rank of `group` has reached this call."""
    dist.all_reduce(torch.zeros(1, device=device), group=group)


@contextlib.contextmanager
def split_batch(group):
    """Inside, train-mode batch statistics are taken over `group`'s ranks."""
    global _batch_group
    prev, _batch_group = _batch_group, group
    try:
        yield
    finally:
        _batch_group = prev


def batch_group() -> Optional[object]:
    """The group the current batch is split over (`split_batch`), or None."""
    return _batch_group
