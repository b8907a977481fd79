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

Layout: activations are NHWC (the JAX package's layout, and the NHWC view
of the port's channels_last tensors); a wrapper raises on a CUDA tensor
whose NHWC view is not contiguous rather than copy it. The TPU dispatch
gates (`COASTLINE_PALLAS*`, `wins`, `fits`) encode Mosaic's 128-lane
padding and VMEM limits, which this card does not have: the kernels take
any B, H, W, C, and the port's ResidualBlock always takes this tail at eval.

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs its
`*_plain` version, the same arithmetic in torch ops with the same roundings,
only for a tensor on the CPU. `.launches` counts kernel launches.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from coastline_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256  # threads a block in every CBAM kernel (`cbam_common.cuh`)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def avg_max_pool_plain(x):
    """(B, H, W, C) -> (avg, max), each (B, C) in x.dtype; the mean is a
    float32 sum divided by H * W, then cast."""
    b, h, w, c = x.shape
    avg = (x.float().sum((1, 2)) / (h * w)).to(x.dtype)
    return avg, x.amax((1, 2))


def gated_spatial_stats_plain(x, gate):
    """(B, H, W, C), (B, C) -> (B, 2, H, W): z = x * gate in x.dtype, then
    [float32 sum of z over C / C cast to x.dtype, max of z over C]."""
    z = x * gate[:, None, None, :]
    mean = (z.float().sum(-1) / x.shape[-1]).to(x.dtype)
    return torch.stack([mean, z.amax(-1)], dim=1)


def cbam_tail_apply_plain(y, shortcut, gate, stats, w):
    """relu(y * gate * att + shortcut), att = sigmoid(conv7x7(stats, w)) with
    the conv summed in float32 on dt-rounded weights and rounded to dt, the
    sigmoid rounded to dt, and every product and sum rounded to dt. y,
    shortcut (B, H, W, C); gate (B, C); stats (B, 2, H, W); w (7, 7, 2, 1)
    HWIO. A float32 conv on CUDA needs cuDNN's TF32 off to be float32."""
    dt = y.dtype
    wf = w.to(dt).float().permute(3, 2, 0, 1)  # (1, 2, 7, 7)
    att = F.conv2d(stats.float(), wf, padding=3).to(dt)
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
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(
                "CUDA inputs must be contiguous: pass the NHWC view of a channels_last "
                f"activation (got shape {tuple(t.shape)}, strides {t.stride()})")
    return True


def _vec(c, *tensors) -> int:
    """Channels a 16-byte load, or 1 where C or an address does not allow it."""
    v = 16 // tensors[0].element_size()
    return v if c % v == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_SIGNATURES = {  # C entry point -> (pointer args, int args)
    "avg_max_pool": (5, 8),
    "gated_spatial_stats": (3, 5),
    "cbam_tail": (6, 6),
}


def _fn(name):
    fn = getattr(_build.library(name), f"coastline_{name}")
    if fn.argtypes is None:
        n_ptr, n_int = _SIGNATURES[name]
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def pool_geometry(b, hw, c, vec, sms):
    """(channel groups a block, pixel slices, pixels a slice) of the pool
    kernel: a block's 256 threads are channel groups of `vec` channels times
    pixel lanes; the slices give about 8 blocks an SM over the whole grid, and
    each thread at least 4 loads."""
    groups = c // vec
    gb = min(groups, THREADS)
    chunks = -(-groups // gb)
    lanes = THREADS // gb
    slices = max(1, min(-(-8 * sms // (b * chunks)), -(-hw // (4 * lanes)), 65535))
    px = -(-hw // slices)
    return gb, -(-hw // px), px


def run_avg_max_pool(x, wrapper):
    """The body of `avg_max_pool` and of `kernels.pools.fused_avg_max_pool`,
    which launch the same kernel under their own counts: checks `x`, runs
    the plain version for a CPU tensor, else launches the pool kernel and
    adds one to `wrapper.launches`."""
    _check("x", x, 4)
    if not _on_card(wrapper.__name__, x):
        return avg_max_pool_plain(x)
    b, h, w, c = x.shape
    vec = _vec(c, x)
    gb, slices, px = pool_geometry(b, h * w, c, vec, _sm_count(x.device.index))
    psum = torch.empty((b, slices, c), dtype=torch.float32, device=x.device)
    pmax = torch.empty_like(psum)
    avg = torch.empty((b, c), dtype=x.dtype, device=x.device)
    mx = torch.empty_like(avg)
    with torch.cuda.device(x.device):
        status = _fn("avg_max_pool")(x.data_ptr(), psum.data_ptr(), pmax.data_ptr(),
                                     avg.data_ptr(), mx.data_ptr(), b, h * w, c,
                                     _DTYPES[x.dtype], vec, gb, slices, px, _stream(x))
    _build.check(status, "avg_max_pool launch")
    wrapper.launches += 1
    return avg, mx


def avg_max_pool(x):
    """(B, H, W, C) float32 or bfloat16 -> (avg (B, C), max (B, C)) in x.dtype,
    one read of x."""
    return run_avg_max_pool(x, avg_max_pool)


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


def cbam_tail_apply(y, shortcut, gate, stats, w):
    """relu(y * gate * sigmoid(conv7x7(stats, w)) + shortcut) in one pass.

    y, shortcut (B, H, W, C); gate (B, C); stats (B, 2, H, W), all in one
    dtype; w (7, 7, 2, 1) HWIO (cast to that dtype) -> (B, H, W, C)."""
    _check("y", y, 4)
    dt = y.dtype
    for name, t, nd in (("shortcut", shortcut, 4), ("gate", gate, 2), ("stats", stats, 4)):
        _check(name, t, nd, dt)
    b, h, ww, c = y.shape
    if (tuple(shortcut.shape) != tuple(y.shape) or tuple(gate.shape) != (b, c)
            or tuple(stats.shape) != (b, 2, h, ww) or tuple(w.shape) != (7, 7, 2, 1)):
        raise ValueError(f"shapes do not fit: y {tuple(y.shape)}, shortcut "
                         f"{tuple(shortcut.shape)}, gate {tuple(gate.shape)}, stats "
                         f"{tuple(stats.shape)}, w {tuple(w.shape)}")
    if not _on_card("cbam_tail", y, shortcut, gate, stats, params=(w,)):
        return cbam_tail_apply_plain(y, shortcut, gate, stats, w)
    taps = w.to(dt).float().permute(2, 3, 0, 1).contiguous()  # (2, 7, 7) [in][ky][kx]
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        status = _fn("cbam_tail")(y.data_ptr(), shortcut.data_ptr(), gate.data_ptr(),
                                  stats.data_ptr(), taps.data_ptr(), out.data_ptr(), b, h, ww,
                                  c, _DTYPES[dt], _vec(c, y, shortcut, out), _stream(y))
    _build.check(status, "cbam_tail launch")
    cbam_tail_apply.launches += 1
    return out


def fused_cbam_tail(y, shortcut, fc1, fc2, sconv):
    """relu(SpatialAttention(ChannelAttention(y)) + shortcut), NHWC.

    fc1 (C, C // r), fc2 (C // r, C): ChannelAttention's MLP in the JAX
    Dense layout; sconv (7, 7, 2, 1): SpatialAttention's conv, HWIO. On CUDA
    tensors it launches the pool, stats and tail kernels once each."""
    avg, mx = avg_max_pool(y)
    gate = channel_gate(avg, mx, fc1, fc2)
    return cbam_tail_apply(y, shortcut, gate, gated_spatial_stats(y, gate), sconv)


avg_max_pool.launches = 0
gated_spatial_stats.launches = 0
cbam_tail_apply.launches = 0
