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

The `space` axis (`parallel/mesh.py`) splits image rows: `split_rows(group,
height, width)` marks the code inside it as running on this rank's rows
(`row_share`) of images `height` rows tall, split over `group`. Inside it
(`row_split()`), the layers of `ops/primitives.py` fetch the rows their
windows read from the ranks that own them (`fetch_rows`), and the
differentiable `all_reduce_grad`, `global_max` and `gather_rows` combine what
the ranks of the group hold:

  * `fetch_rows`: each rank's rows [a, b) of a row-split NCHW tensor, rows
    outside the image taken as a fill value. One `all_reduce` of a zeroed
    byte buffer that holds, for each rank, only the rows it lacks (each
    written by the rank that owns it, so the byte sums are exact); its
    backward sends each fetched row's gradient back to its owner the same
    way, a row's gradients summed there;
  * `all_reduce_grad` (the sum), `global_max` (a differentiable
    bitwise gather of the per-rank maxima and their max on every rank, so
    autograd routes the gradient to the rank that holds the maximum) and
    `gather_rows` (every rank's rows in image order, for the few small maps
    every rank must see whole: attention's reduced keys and values).
"""

import contextlib
import warnings
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the autograd-visible all-reduce this module builds on, kept while it exists
warnings.filterwarnings("ignore", message="torch.distributed.nn.functional.all_reduce is "
                        "deprecated")

_batch_group = None
_row_split = None


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


# ---------------------------------------------------------------------------
# Image rows split over ranks (the mesh's `space` axis)
# ---------------------------------------------------------------------------


def row_share(height: int, index: int, count: int) -> Tuple[int, int]:
    """[lo, hi): rank `index` of `count`'s rows of a `height`-row image. The
    first ranks hold the larger shares (33 rows over 2: 17 and 16), as
    GSPMD's padded split puts its padding at the end; a share is empty
    only where height < count."""
    return -(-index * height // count), -(-(index + 1) * height // count)


class RowSplit:
    """The rows of a row-split forward (`split_rows`): `group` of `size`
    ranks, this one `rank`, and every row-split tensor's global height.

    A layer derives its output's global height from its input's and every
    rank's share from `row_share`, so all ranks agree on who needs which
    rows without a collective. A tensor's global height is looked up from
    its local (height, width): each height a layer makes is registered for
    every rank's share, and two global heights that give some rank the
    same local shape at one width raise (the row rule could not tell them
    apart), on every rank alike."""

    def __init__(self, group, height: int, width: int, whole_group=None):
        self.group = group
        self.size, self.rank = group_size(group), group_rank(group)
        self.whole_group = whole_group
        self._heights = {}
        self.register(height, width)

    def share(self, height: int, rank: Optional[int] = None) -> Tuple[int, int]:
        return row_share(height, self.rank if rank is None else rank, self.size)

    def shares(self, height: int) -> List[Tuple[int, int]]:
        return [self.share(height, r) for r in range(self.size)]

    def register(self, height: int, width: int) -> int:
        """Record a row-split tensor of global `height` x `width`."""
        if height < self.size:
            raise ValueError(f"a map of {height} rows does not split over {self.size} ranks")
        for r in range(self.size):
            lo, hi = self.share(height, r)
            known = self._heights.setdefault((r, hi - lo, width), height)
            if known != height:
                raise ValueError(
                    f"maps of {known} and {height} rows at width {width} give rank {r} the "
                    f"same {hi - lo} rows: the row split cannot tell them apart")
        return height

    def height(self, x: torch.Tensor) -> int:
        """The global height of row-split NCHW `x` (rows at dim 2)."""
        key = (self.rank, x.shape[2], x.shape[3])
        if key not in self._heights:
            raise ValueError(f"no row-split map has {x.shape[2]} local rows at width "
                             f"{x.shape[3]}: the tensor was not made by a row-split layer")
        return self._heights[key]


@contextlib.contextmanager
def split_rows(group, height: int, width: int, whole_group=None):
    """Inside, NCHW activations are this rank's rows (`row_share`) of images
    `height` x `width` split over `group`'s ranks; `whole_group`, the ranks
    that hold the other samples of a split batch at this rank's rows, is
    the group of a train-mode BN over maps every rank holds whole
    (`whole_rows`)."""
    global _row_split
    prev, _row_split = _row_split, RowSplit(group, height, width, whole_group)
    try:
        yield _row_split
    finally:
        _row_split = prev


def row_split() -> Optional[RowSplit]:
    """The active row split (`split_rows`), or None."""
    return _row_split


@contextlib.contextmanager
def whole_rows():
    """Inside a row split: the maps are whole on every rank (a pyramid
    level's pooled map), so layers take them as one process does, and a
    train-mode BN sums over `whole_group`, not over the row-split ranks,
    which hold copies. Outside a row split: nothing changes."""
    global _row_split, _batch_group
    prev = _row_split, _batch_group
    if _row_split is not None:
        _batch_group = _row_split.whole_group if _batch_group is not None else None
        _row_split = None
    try:
        yield
    finally:
        _row_split, _batch_group = prev


def _raw_buffer(shape, dtype, device):
    """(bytes, typed view): a zeroed contiguous byte buffer and its NCHW
    `shape` view of `dtype`, NHWC in memory on every rank whatever the
    layout of the tensors written into it, so the ranks' bytes line up."""
    nb, c, h, w = shape
    n = nb * c * h * w * torch.empty((), dtype=dtype).element_size()
    raw = torch.zeros(n, dtype=torch.uint8, device=device)
    return raw, raw.view(dtype).view(nb, h, w, c).permute(0, 3, 1, 2)


def _is_channels_last(x):
    return x.ndim == 4 and not x.is_contiguous() and x.is_contiguous(
        memory_format=torch.channels_last)


def _plan(split: RowSplit, height: int, needs: Sequence[Tuple[int, int]]):
    """The exchange's slots: (rank, first row, end row, buffer offset) for
    each run of in-image rows a rank needs and does not own, and the
    buffer's row count."""
    slots, total = [], 0
    for r, (a, b) in enumerate(needs):
        lo, hi = split.share(height, r)
        for g0, g1 in ((max(a, 0), min(b, lo)), (max(a, hi), min(b, height))):
            if g1 > g0:
                slots.append((r, g0, g1, total))
                total += g1 - g0
    return slots, total


def _exchange(split, slots, total, like, write):
    """All-reduce a zeroed buffer of `total` rows shaped as `like` after
    `write(buf, slot)` fills this rank's part of each slot; returns the
    typed buffer, or None when no rank needs a row."""
    if total == 0:
        return None
    shape = (like.shape[0], like.shape[1], total, like.shape[3])
    raw, buf = _raw_buffer(shape, like.dtype, like.device)
    for slot in slots:
        write(buf, slot)
    dist.all_reduce(raw, op=dist.ReduceOp.SUM, group=split.group)
    return buf


class _FetchRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, height, needs, fill):
        lo, hi = split.share(height)
        slots, total = _plan(split, height, needs)
        ctx.split, ctx.height, ctx.slots, ctx.total = split, height, slots, total
        ctx.needs, ctx.shape = needs, x.shape

        def write(buf, slot):  # the rows of the slot this rank owns
            _, g0, g1, off = slot
            o0, o1 = max(g0, lo), min(g1, hi)
            if o1 > o0:
                buf[:, :, off + o0 - g0:off + o1 - g0] = x[:, :, o0 - lo:o1 - lo]

        buf = _exchange(split, slots, total, x, write)
        a, b = needs[split.rank]
        parts = []
        if a < 0:
            parts.append(_filled(x, min(b, 0) - a, fill))
        mine = {g0: (g1, off) for r, g0, g1, off in slots if r == split.rank}
        g = max(a, 0)
        while g < min(b, height):
            if lo <= g < hi:
                end = min(b, hi)
                parts.append(x[:, :, g - lo:end - lo])
            else:
                end, off = mine[g]
                parts.append(buf[:, :, off:off + end - g])
            g = end
        if b > height:
            parts.append(_filled(x, b - max(a, height), fill))
        out = torch.cat(parts, dim=2) if len(parts) > 1 else parts[0].clone()
        return out.contiguous(memory_format=torch.channels_last) if _is_channels_last(x) else out

    @staticmethod
    def backward(ctx, grad):
        split, height, slots = ctx.split, ctx.height, ctx.slots
        lo, hi = split.share(height)
        a, b = ctx.needs[split.rank]
        gx = grad.new_zeros(ctx.shape)
        o0, o1 = max(a, lo), min(b, hi)
        if o1 > o0:
            gx[:, :, o0 - lo:o1 - lo] += grad[:, :, o0 - a:o1 - a]

        def write(buf, slot):  # the gradient of each row this rank fetched
            r, g0, g1, off = slot
            if r == split.rank:
                buf[:, :, off:off + g1 - g0] = grad[:, :, g0 - a:g1 - a]

        buf = _exchange(split, slots, ctx.total, grad, write)
        for r, g0, g1, off in slots:
            o0, o1 = max(g0, lo), min(g1, hi)
            if r != split.rank and o1 > o0:
                gx[:, :, o0 - lo:o1 - lo] += buf[:, :, off + o0 - g0:off + o1 - g0]
        return gx, None, None, None, None


def _filled(x, n, fill):
    shape = (x.shape[0], x.shape[1], n, x.shape[3])
    out = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return out.contiguous(memory_format=torch.channels_last) if _is_channels_last(x) else out


def fetch_rows(x: torch.Tensor, split: RowSplit, height: int,
               needs: Sequence[Tuple[int, int]], fill=0.0) -> torch.Tensor:
    """Rows [a, b) = `needs[split.rank]` of the row-split NCHW map whose
    rank-r share `x` is (global `height`), rows outside [0, height) set to
    `fill`. `needs` holds every rank's range: all ranks call this together
    with the same `needs`. Differentiable: a fetched row's gradient goes
    back to the rank that owns it."""
    return _FetchRows.apply(x, split, height, [tuple(n) for n in needs], fill)


class _GatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.rank = group, group_rank(group)
        return gather(t, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad[ctx.rank], None


def global_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of `t` over `group`, differentiable: the
    gradient goes to the rank (or ranks, split evenly) holding the maximum."""
    return _GatherGrad.apply(t, group).amax(0)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, height):
        lo, hi = split.share(height)
        ctx.split, ctx.lo, ctx.hi = split, lo, hi
        shape = (x.shape[0], x.shape[1], height, x.shape[3])
        raw, buf = _raw_buffer(shape, x.dtype, x.device)
        buf[:, :, lo:hi] = x
        dist.all_reduce(raw, op=dist.ReduceOp.SUM, group=split.group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.split.group)
        return grad[:, :, ctx.lo:ctx.hi], None, None


def gather_rows(x: torch.Tensor, split: RowSplit, height: Optional[int] = None) -> torch.Tensor:
    """The whole map (every rank's rows in image order) of row-split NCHW
    `x`, bit for bit, on every rank; differentiable. `height` defaults to
    the split's record of x's global height."""
    return _GatherRows.apply(x, split, split.height(x) if height is None else height)
