"""The CBAM eval tail of a ResidualBlock: three CUDA kernels and their orchestrator.

Replaces the TPU kernels of `coastline/pallas/cbam.py`:

  * `avg_max_pool` (`cbam.py:141`, and `pallas/pools.py:56`
    `fused_avg_max_pool`, the same function; see `kernels/pools.py`) ->
    `csrc/avg_max_pool.cu`: per-image, per-channel mean and max over H x W;
  * `gated_spatial_stats` (`cbam.py:213`) -> `csrc/gated_spatial_stats.cu`:
    the spatial-attention input [mean_c(z), max_c(z)] of z = x * gate;
  * the XLA part of `fused_cbam_tail` (`cbam.py:328`: the 7x7 conv, its
    sigmoid, and relu(y * gate * att + shortcut)) -> `csrc/cbam_tail.cu`.

`fused_cbam_tail` runs them in the TPU orchestrator's order with the shared
channel MLP between them as two tiny `torch.matmul`s, as XLA computes it
outside any Pallas kernel. The arithmetic is the module path's
(`coastline/ops/blocks.py:79-133,203-207`): every op rounds to the compute
dtype; the channel gate takes its sigmoid in float32 and is cast back; the
spatial gate's sigmoid is in the compute dtype.

What bounds the kernels on an H100: all three are memory-bound streaming
passes (a few operations an element). At (8, 512, 512, 64) bf16 the byte
bounds at 3.35 TB/s are 0.080 ms (pool: one read), 0.083 ms (stats: one
read, a 2/C-sized write) and 0.243 ms (tail: two reads, one write); each
source says how its design keeps to one pass.

The pool is one launch a call: a thread block cluster per (image, channel
chunk) splits the pixels, and its CTAs fold their partials through
distributed shared memory in a fixed order, so two calls give the same
bits; `pool_geometry` picks the chunk, the cluster and the grid per shape
and SM count. At the deep levels the kernel is shorter than a launch, so
its wrapper's host path is kept short: one (2, B, C) output, the C entry
point bound once (`_fn`), the raw stream handle, the device context only
when x is not on the current device.

Layout: activations are NHWC (the JAX package's layout, and the NHWC view
of the port's channels_last tensors); a wrapper raises on a CUDA tensor
whose NHWC view is not contiguous rather than copy it. The TPU dispatch
gates (`COASTLINE_PALLAS*`, `wins`, `fits`) encode Mosaic's 128-lane
padding and VMEM limits, which this card does not have: the kernels take
any B, H, W, C, and the port's ResidualBlock always takes this tail at eval.

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs its
`*_plain` version, the same arithmetic in torch ops with the same roundings,
only for a tensor on the CPU. `.launches` counts kernel launches.

In a row split (`parallel.collectives.split_rows`, the mesh's `space`
axis) each rank holds its rows of y and shortcut. The pool then runs in its
partials mode (float32 sums and maxima of the rank's rows, `partials=True`),
all-reduced over the ranks and divided by the global area in float32, so a
bf16 mean rounds once, as in one process; the stats are per pixel; and the
tail's 7x7 conv reads a stats map that carries 3 rows of halo above and
below (`halo=3`: fetched from the neighbouring ranks, zeros outside the
image), so y, gate and shortcut, of 64-1024 channels, are never exchanged.
"""

import collections
import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from coastline_torch.kernels import _build
from coastline_torch.parallel import collectives

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def avg_max_pool_plain(x, partials: bool = False):
    """(B, H, W, C) -> (avg, max), each (B, C) in x.dtype; the mean is a
    float32 sum divided by H * W, then cast. With `partials` the float32
    sum and the max as float32, undivided and uncast."""
    b, h, w, c = x.shape
    if partials:
        return x.float().sum((1, 2)), x.amax((1, 2)).float()
    avg = (x.float().sum((1, 2)) / (h * w)).to(x.dtype)
    return avg, x.amax((1, 2))


def gated_spatial_stats_plain(x, gate):
    """(B, H, W, C), (B, C) -> (B, 2, H, W): z = x * gate in x.dtype, then
    [float32 sum of z over C / C cast to x.dtype, max of z over C]."""
    z = x * gate[:, None, None, :]
    mean = (z.float().sum(-1) / x.shape[-1]).to(x.dtype)
    return torch.stack([mean, z.amax(-1)], dim=1)


def cbam_tail_apply_plain(y, shortcut, gate, stats, w, halo: int = 0):
    """relu(y * gate * att + shortcut), att = sigmoid(conv7x7(stats, w)) with
    the conv summed in float32 on dt-rounded weights and rounded to dt, the
    sigmoid rounded to dt, and every product and sum rounded to dt. y,
    shortcut (B, H, W, C); gate (B, C); stats (B, 2, H + 2 halo, W), its
    first and last `halo` rows (0..3) the rows around y's; w (7, 7, 2, 1)
    HWIO. A float32 conv on CUDA needs cuDNN's TF32 off to be float32."""
    dt = y.dtype
    wf = w.to(dt).float().permute(3, 2, 0, 1)  # (1, 2, 7, 7)
    att = F.conv2d(stats.float(), wf, padding=(3 - halo, 3)).to(dt)
    att = torch.sigmoid(att.float()).to(dt).permute(0, 2, 3, 1)  # (B, H, W, 1)
    return torch.relu(y * gate[:, None, None, :] * att + shortcut)


def channel_gate(avg, mx, fc1, fc2):
    """sigmoid(mlp(avg) + mlp(max)) with mlp(v) = relu(v @ fc1) @ fc2 in the
    pooled vectors' dtype, the sigmoid in float32, cast back.
    fc1 (C, C // r), fc2 (C // r, C): the Dense layout of the JAX package."""
    dt = avg.dtype
    fc1, fc2 = fc1.to(dt), fc2.to(dt)

    def mlp(v):
        return torch.relu(v @ fc1) @ fc2

    return torch.sigmoid((mlp(avg) + mlp(mx)).float()).to(dt)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name, t, ndim, dtype=None):
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got shape {tuple(t.shape)}")
    if t.dtype not in ((dtype,) if dtype is not None else tuple(_DTYPES)):
        raise TypeError(f"{name} must be {dtype or 'float32 or bfloat16'}, got {t.dtype}")
    if t.numel() == 0:
        raise ValueError(f"{name} is empty: {tuple(t.shape)}")


def _on_card(name, *tensors, params=()) -> bool:
    """False for CPU tensors (run the plain version); True for CUDA tensors
    that kernel `name` can read; raises otherwise, and for a CUDA call that
    autograd would record (`_build.refuse_grad`). `params` (weights, copied
    into the kernel's layout by the wrapper) need only the device."""
    dev = tensors[0].device
    if any(t.device != dev for t in (*tensors, *params)):
        raise ValueError("all tensors must be on one device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _build.refuse_grad(name, *tensors, *params)
    _build.check_card_inputs(*tensors)
    return True


def _vec(c, *tensors) -> int:
    """Channels a 16-byte load, or 1 where C or an address does not allow it."""
    v = 16 // tensors[0].element_size()
    return v if c % v == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_SIGNATURES = {  # C entry point -> (pointer args, int args)
    "avg_max_pool": (2, 9),
    "avg_max_pool_partials": (2, 9),
    "gated_spatial_stats": (3, 5),
    "cbam_tail": (6, 7),
}


@functools.cache
def _fn(name):
    """The C entry point `coastline_<name>` of its source
    (`csrc/avg_max_pool.cu` for both pool entries, else `csrc/<name>.cu`),
    built, loaded and bound once."""
    source = "avg_max_pool" if name.startswith("avg_max_pool") else name
    fn = getattr(_build.library(source), f"coastline_{name}")
    n_ptr, n_int = _SIGNATURES[name]
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _stream(t):
    """The raw handle of the current stream on t's device: the launch's
    stream. `torch.cuda.current_stream(dev).cuda_stream` gives the same
    handle but builds a Stream object, 3-9 us of host time a call on the
    H100's host (`scripts/torch_avg_max_pool_vs_earlier.py --host`), as
    long as the pool kernel at its deep levels."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _on_device(dev):
    """`dev` as the current CUDA device for a launch; no context when it already is."""
    return contextlib.nullcontext() if dev.index == torch.cuda.current_device() \
        else torch.cuda.device(dev)


POOL_THREADS = 256  # threads a CTA of the pool kernel
POOL_UNROLL = 8  # independent loads a thread issues before it adds them (`UNROLL`)
MAX_CLUSTER = 16  # above 8 the non-portable cluster size, which an H100 allows

PoolGeometry = collections.namedtuple("PoolGeometry", "groups cluster px threads grid")


def _ceil(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def pool_geometry(b, hw, c, vec, sms) -> PoolGeometry:
    """The pool kernel's launch geometry for x (b, hw, c) read `vec`
    channels a load on a card of `sms` SMs: `groups` channel groups a chunk
    (a power of two), `cluster` CTAs per (image, chunk) splitting the
    pixels, `px` pixels a CTA, `threads` a CTA, `grid` CTAs in all (b x
    chunks x cluster).

    A chunk is one 128-byte line of a pixel on the 16-byte path (8 groups)
    and one warp of channels on the scalar one (32). The cluster doubles
    while the grid stays within one CTA an SM, every thread keeps a full
    round of `POOL_UNROLL` loads and no CTA is left without pixels. On the
    H100 this grid came within 8% of the fastest geometry at every level
    shape, and grids of more than one CTA an SM (a second CTA on some SMs)
    were up to 8% slower in bf16 at 512^2 x 64 and 64^2 x 512 (PERF.md;
    `scripts/torch_avg_max_pool_vs_earlier.py --scan`). Where even the
    largest cluster fills less than half the card (few images of few
    channels), the chunk halves, down to one 32-byte sector a pixel."""
    groups = c // vec
    width = min(1 << (groups - 1).bit_length(), 8 if vec > 1 else 32)
    while True:
        chunks = _ceil(groups, width)
        lanes = POOL_THREADS // width
        cluster = 1
        while (cluster < MAX_CLUSTER and 2 * b * chunks * cluster <= sms
               and _ceil(hw, 2 * cluster) >= lanes * POOL_UNROLL):
            cluster *= 2
        grid = b * chunks * cluster
        if cluster < MAX_CLUSTER or 2 * grid > sms or width <= (2 if vec > 1 else 32):
            return PoolGeometry(width, cluster, _ceil(hw, cluster), POOL_THREADS, grid)
        width //= 2


def run_avg_max_pool(x, wrapper, partials: bool = False):
    """The body of `avg_max_pool` and of `kernels.pools.fused_avg_max_pool`,
    which launch the same kernel under their own counts: checks `x`, runs
    the plain version for a CPU tensor, else launches the pool kernel once
    and adds one to `wrapper.launches`. avg and max are the two rows of one
    (2, B, C) tensor; with `partials` (float32 sums and maxima) of one
    float32 one. In a row split the ranks' partials are combined into the
    image's mean and max (the module docstring)."""
    _check("x", x, 4)
    split = collectives.row_split()
    if split is not None and not partials:
        total, mx = run_avg_max_pool(x, wrapper, partials=True)
        total = collectives.all_reduce_sum(total, split.group)
        mx = collectives.all_reduce_max(mx, split.group)
        area = split.height(x.permute(0, 3, 1, 2)) * x.shape[2]
        return (total / area).to(x.dtype), mx.to(x.dtype)
    if not _on_card(wrapper.__name__, x):
        return avg_max_pool_plain(x, partials)
    b, h, w, c = x.shape
    vec = _vec(c, x)
    dev = x.device
    geo = pool_geometry(b, h * w, c, vec, _sm_count(dev.index))
    out = x.new_empty((2, b, c), dtype=torch.float32 if partials else x.dtype)
    with _on_device(dev):
        entry = _fn("avg_max_pool_partials" if partials else "avg_max_pool")
        status = entry(x.data_ptr(), out.data_ptr(), b, h * w, c, _DTYPES[x.dtype], vec,
                       geo.groups, geo.cluster, geo.px, geo.threads, _stream(x))
    _build.check(status, "avg_max_pool launch")
    wrapper.launches += 1
    return out.unbind(0)


def avg_max_pool(x, partials: bool = False):
    """(B, H, W, C) float32 or bfloat16 -> (avg (B, C), max (B, C)) in x.dtype,
    one read of x; with `partials` (float32 sum (B, C), float32 max (B, C))."""
    return run_avg_max_pool(x, avg_max_pool, partials)


def gated_spatial_stats(x, gate):
    """(B, H, W, C), gate (B, C) in x.dtype -> (B, 2, H, W) in x.dtype:
    [mean_c(x * gate), max_c(x * gate)]; x * gate is never written."""
    _check("x", x, 4)
    _check("gate", gate, 2, x.dtype)
    b, h, w, c = x.shape
    if tuple(gate.shape) != (b, c):
        raise ValueError(f"gate must be {(b, c)}, got {tuple(gate.shape)}")
    if not _on_card("gated_spatial_stats", x, gate):
        return gated_spatial_stats_plain(x, gate)
    out = torch.empty((b, 2, h, w), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = _fn("gated_spatial_stats")(x.data_ptr(), gate.data_ptr(), out.data_ptr(),
                                            b, h * w, c, _DTYPES[x.dtype], _vec(c, x),
                                            _stream(x))
    _build.check(status, "gated_spatial_stats launch")
    gated_spatial_stats.launches += 1
    return out


def cbam_tail_apply(y, shortcut, gate, stats, w, halo: int = 0):
    """relu(y * gate * sigmoid(conv7x7(stats, w)) + shortcut) in one pass.

    y, shortcut (B, H, W, C); gate (B, C); stats (B, 2, H + 2 halo, W), all
    in one dtype, the stats' first and last `halo` rows (0..3) the rows
    around y's (another rank's, or zeros outside the image); w (7, 7, 2, 1)
    HWIO (cast to that dtype) -> (B, H, W, C)."""
    _check("y", y, 4)
    dt = y.dtype
    for name, t, nd in (("shortcut", shortcut, 4), ("gate", gate, 2), ("stats", stats, 4)):
        _check(name, t, nd, dt)
    b, h, ww, c = y.shape
    if not 0 <= halo <= 3:
        raise ValueError(f"halo must be 0..3 rows, got {halo}")
    if (tuple(shortcut.shape) != tuple(y.shape) or tuple(gate.shape) != (b, c)
            or tuple(stats.shape) != (b, 2, h + 2 * halo, ww) or tuple(w.shape) != (7, 7, 2, 1)):
        raise ValueError(f"shapes do not fit: y {tuple(y.shape)}, shortcut "
                         f"{tuple(shortcut.shape)}, gate {tuple(gate.shape)}, stats "
                         f"{tuple(stats.shape)} (halo {halo}), w {tuple(w.shape)}")
    if not _on_card("cbam_tail", y, shortcut, gate, stats, params=(w,)):
        return cbam_tail_apply_plain(y, shortcut, gate, stats, w, halo)
    taps = w.to(dt).float().permute(2, 3, 0, 1).contiguous()  # (2, 7, 7) [in][ky][kx]
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        status = _fn("cbam_tail")(y.data_ptr(), shortcut.data_ptr(), gate.data_ptr(),
                                  stats.data_ptr(), taps.data_ptr(), out.data_ptr(), b, h, ww,
                                  c, halo, _DTYPES[dt], _vec(c, y, shortcut, out), _stream(y))
    _build.check(status, "cbam_tail launch")
    cbam_tail_apply.launches += 1
    return out


def fused_cbam_tail(y, shortcut, fc1, fc2, sconv):
    """relu(SpatialAttention(ChannelAttention(y)) + shortcut), NHWC.

    fc1 (C, C // r), fc2 (C // r, C): ChannelAttention's MLP in the JAX
    Dense layout; sconv (7, 7, 2, 1): SpatialAttention's conv, HWIO. On CUDA
    tensors it launches the pool, stats and tail kernels once each. In a
    row split y and shortcut are this rank's rows (the module docstring)."""
    avg, mx = avg_max_pool(y)
    gate = channel_gate(avg, mx, fc1, fc2)
    stats = gated_spatial_stats(y, gate)
    split = collectives.row_split()
    if split is None:
        return cbam_tail_apply(y, shortcut, gate, stats, sconv)
    height = split.height(stats)
    needs = [(lo - 3, hi + 3) for lo, hi in split.shares(height)]
    stats = collectives.fetch_rows(stats, split, height, needs)
    return cbam_tail_apply(y, shortcut, gate, stats.contiguous(), sconv, halo=3)


avg_max_pool.launches = 0
gated_spatial_stats.launches = 0
cbam_tail_apply.launches = 0
