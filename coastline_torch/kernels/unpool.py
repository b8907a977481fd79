"""SegNet's indexed 2x2 max pool and max unpool (counterpart of `coastline/pallas/unpool.py`).

Replaces the TPU kernels `coastline/pallas/unpool.py:67`
`max_pool_with_indices_pallas` and `:94` `max_unpool_pallas` with one CUDA
source, `csrc/unpool.cu`, and its two entry points. The function is that of
the XLA formulation SegNet runs in the JAX package
(`coastline/ops/primitives.py:340-375`), on NHWC:

  * pool: (B, H, W, C) -> values (B, H/2, W/2, C) in x.dtype and int32 codes,
    the row-major position 0..3 of each 2x2 window's first maximum
    (`jnp.argmax`: a tie goes to the first, a NaN counts as the maximum and
    the first NaN wins). The values are XLA's max, which takes +0.0 over
    -0.0: the element at the code, except that a window whose maximum is a
    zero of both signs gives +0.0. H and W must be even;
  * unpool: values, codes (B, h, w, C) -> (B, 2h, 2w, C), values * (codes ==
    k) at window position k. It multiplies, as the JAX package does: the
    zeros carry the value's sign, and an inf or NaN value writes NaN into the
    other three positions (torch's MaxUnpool2d writes plain zeros).

What bounds the kernels on an H100: bytes. Each moves its input once and its
output once, the int32 codes (the JAX interface) being 2/3 of the pool's
output: 469.8 MB at (8, 512, 512, 64) bf16, 0.140 ms at 3.35 TB/s. The
source says how its design keeps to one coalesced pass.

Both also take int8: SegNet's int8 PTQ forward (`infer/quant.py`) pools and
unpools the activations' codes, as the JAX package's int8 SegNet runs its
primitives on them (`coastline/infer/quant.py:794`).

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs its
`*_plain` version only for a tensor on the CPU. A CUDA input must be
contiguous: the NHWC view of a channels_last activation, read without a copy.
`.launches` counts kernel launches.
"""

import ctypes

import torch

from coastline_torch.kernels import _build
from coastline_torch.kernels.cbam import _DTYPES, _on_card, _stream, _vec

_POOL_DTYPES = {**_DTYPES, torch.int8: 2}  # the dtype codes of `csrc/unpool.cu`

# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _check(name, t, ndim, dtype=None):
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got shape {tuple(t.shape)}")
    if t.dtype not in ((dtype,) if dtype is not None else tuple(_POOL_DTYPES)):
        raise TypeError(f"{name} must be {dtype or 'float32, bfloat16 or int8'}, got {t.dtype}")
    if t.numel() == 0:
        raise ValueError(f"{name} is empty: {tuple(t.shape)}")


def _check_even(x):
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"max_pool_with_indices expects even H and W, got shape {tuple(x.shape)}")


def max_pool_with_indices_plain(x):
    """(B, H, W, C) -> (values (B, H/2, W/2, C) in x.dtype, int32 codes 0..3):
    the kernel's scan over the window in row-major order, a strict > so the
    first maximum stays, a NaN taken once and kept, and +0.0 over -0.0."""
    _check_even(x)
    b, h, w, c = x.shape
    xw = x.reshape(b, h // 2, 2, w // 2, 2, c)
    window = [xw[:, :, dy, :, dx] for dy in (0, 1) for dx in (0, 1)]
    vals = window[0]
    codes = torch.zeros(vals.shape, dtype=torch.int32, device=x.device)
    for k, v in enumerate(window[1:], 1):
        take = ~torch.isnan(vals) & ((v > vals) | torch.isnan(v))
        plus_zero_tie = (v == vals) & ~torch.signbit(v)
        vals = torch.where(take | plus_zero_tie, v, vals)
        codes = torch.where(take, k, codes)
    return vals, codes


def max_unpool_plain(vals, codes):
    """values, int32 codes (B, h, w, C) -> (B, 2h, 2w, C): values * (codes == k)
    at window position k, as `coastline/ops/primitives.py:359-368`."""
    b, h, w, c = vals.shape
    pos = torch.arange(4, dtype=codes.dtype, device=codes.device)[:, None]
    xw = vals[:, :, :, None, :] * (codes[:, :, :, None, :] == pos).to(vals.dtype)
    return xw.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _fn(name):
    fn = getattr(_build.library("unpool"), f"coastline_{name}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def max_pool_with_indices(x):
    """(B, H, W, C) float32, bfloat16 or int8, H and W even -> (values (B, H/2,
    W/2, C) in x.dtype, int32 codes), both contiguous NHWC."""
    _check("x", x, 4)
    _check_even(x)
    if not _on_card("max_pool_with_indices", x):
        return max_pool_with_indices_plain(x)
    b, h, w, c = x.shape
    vals = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    codes = torch.empty(vals.shape, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        status = _fn("max_pool_with_indices")(x.data_ptr(), vals.data_ptr(), codes.data_ptr(),
                                              b, h, w, c, _POOL_DTYPES[x.dtype],
                                              _vec(c, x, vals, codes), _stream(x))
    _build.check(status, "max_pool_with_indices launch")
    max_pool_with_indices.launches += 1
    return vals, codes


def max_unpool(vals, codes):
    """values (B, h, w, C) float32, bfloat16 or int8, int32 codes of the same shape
    -> (B, 2h, 2w, C) contiguous NHWC in values' dtype."""
    _check("vals", vals, 4)
    _check("codes", codes, 4, torch.int32)
    if codes.shape != vals.shape:
        raise ValueError(f"codes {tuple(codes.shape)} must match vals {tuple(vals.shape)}")
    if not _on_card("max_unpool", vals, codes):
        return max_unpool_plain(vals, codes)
    b, h, w, c = vals.shape
    out = torch.empty((b, 2 * h, 2 * w, c), dtype=vals.dtype, device=vals.device)
    with torch.cuda.device(vals.device):
        status = _fn("max_unpool")(vals.data_ptr(), codes.data_ptr(), out.data_ptr(), b, h, w, c,
                                   _POOL_DTYPES[vals.dtype], _vec(c, vals, codes, out),
                                   _stream(vals))
    _build.check(status, "max_unpool launch")
    max_unpool.launches += 1
    return out


max_pool_with_indices.launches = 0
max_unpool.launches = 0
