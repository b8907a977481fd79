"""Int8 convolution with a fused epilogue (no Pallas counterpart).

The JAX package runs the int8 convs of its PTQ path as XLA `s8 x s8 -> s32`
convolutions with the epilogue, and the next site's quantization, fused by
XLA (`coastline/infer/quant.py:546-578`); no Pallas kernel is involved.
PyTorch has no such conv on CUDA (`F.conv2d` refuses int8), so the port
computes the same function with its own CUDA kernel, `csrc/int8_conv.cu`:

    y[n, oy, ox, co] = cast( f32(acc) * (x_step * w_step[co]) + bias[co] )
    acc = sum over (ky, kx, ci) of x_q[n, iy, ix, ci] * w_q[ky, kx, ci, co]
    iy = stride * oy - pad_top + ky * dilation (ix alike)

x_q int8 NHWC, w_q int8 HWIO, acc int32 (exact: 127^2 * 9 * 1024 < 2^31),
x_step a float32 scalar, w_step and bias float32 per output channel, the
result in float32 or bfloat16 (one round to nearest even). The float32
epilogue runs in that order, first x_step * w_step, then acc * that, then
+ bias, each rounded, as XLA computes it. `act` then applies, in the output
dtype: "relu" max(y, 0); "leaky" `jax.nn.leaky_relu(y, 0.1)`, y where y >= 0
else y * 0.1 with the slope rounded to the output dtype (a weak-typed
scalar in JAX) and the product rounded once (`leaky_relu`).

Two output modes. Values (`out_step=None`): y as above. Codes (`out_step`
a float32 value): the int8 codes of the site that y feeds,
`clamp(rint(f32(y) / out_step), -127, 127)` with a true division and round
half to even, which is `_Ctx.site` of `infer/quant.py` bit for bit (y is
rounded to the output dtype before the division, as the site reads it).
Codes mode writes one byte a value and keeps the float tensor out of
device memory.

Options: any kh x kw, per-side `padding` ((top, bottom), (left, right)) or
an int, rhs `dilation`, `stride` 1, 2 or 4, and `lhs_dilation=(2, 2)` with a
k x k kernel, k = 2, 3 or 4, and padding ((lo, k - lo), (lo, k - lo)), lo =
k // 2, stride 1: the transposed convs of the UNets' decoders (2x2),
DeepLabV3+'s and YOLO-SEG's (4x4) and ENet's (3x3 with output padding, pads
(1, 2)); each gives a 2H x 2W output. The kernel splits such a conv into its
four output-parity sub-problems, each a dense n x n conv over the input
grid, n = (k + 1) // 2 (`parity_taps`, `pack_weights`; a tap loop over the
zero-inserted input would multiply zeros for 3/4 of its taps; the 3x3's
sub-problems are padded with zero taps to 2x2). The plain version takes any
lhs dilation and padding.

What bounds it on an H100: at the UNet's first level (8, 512, 512, 64 -> 64,
3x3) the bytes (134 MB in; 268 MB out in bf16, 0.120 ms at 3.35 TB/s, or
134 MB as codes, 0.080 ms); at its bottleneck (8, 32, 32, 1024 -> 1024) the
154.6 GOP (0.078 ms at 1979 int8 TOPS). The kernel is an implicit GEMM on
Hopper's wgmma (s8 x s8 -> s32, both operands in shared memory), fed by TMA
tap boxes on mbarriers from one producer thread, in a persistent grid (see
the source).

The conv is the custom op `coastline_torch::int8_conv` (`int8_conv_op`),
so a `torch.export` program of a forward carries it as one node. Its CUDA
registration launches the kernel (or raises); its CPU registration runs
`int8_conv_plain`, only for tensors on the CPU. `int8_conv` checks its
arguments and, run eagerly, calls the registration for x's device itself,
without the dispatcher's Python path; traced, it calls the op
(`_build.tracing`). `int8_conv` takes the weights as
`PackedWeights`, whose kernel layout `packed` builds once on the card. The
card needs C_in % 16 == 0 (a row of 16-byte multiples for TMA; HRNet-Water's
fuse conv reads 144 channels), C_out % 8 == 0 and a contiguous NHWC input on
a 16-byte boundary.
`int8_conv.launches` counts kernel launches, a program's too.
"""

import ctypes
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from coastline_torch.kernels import _build


class PackedWeights(NamedTuple):
    """An int8 conv's weights: `hwio` (kh, kw, C_in, C_out), the JAX layout
    the plain version reads, and `mat`, the kernel's layout on the card
    (`pack_weights`), or None on the CPU."""

    hwio: torch.Tensor
    mat: Optional[torch.Tensor]
    transposed: bool


ACTS = ("none", "relu", "leaky")  # the epilogue's activations, in the kernel's enum order
LEAKY_SLOPE = 0.1


def leaky_relu(t: torch.Tensor) -> torch.Tensor:
    """`jax.nn.leaky_relu(t, 0.1)` bit for bit: t where t >= 0, else t times
    0.1 rounded to t's dtype (JAX's weak-typed scalar), the product rounded
    once (in bfloat16 it is exact in float32 first). `F.leaky_relu` rounds
    the product of the bf16 value and float32(0.1) instead."""
    slope = float(torch.tensor(LEAKY_SLOPE, dtype=t.dtype))
    return torch.where(t >= 0, t, t * slope)


def activation(y: torch.Tensor, act: str) -> torch.Tensor:
    """The epilogue's `act` on y, in y's dtype (`ACTS`)."""
    if act == "relu":
        return torch.relu(y)
    if act == "leaky":
        return leaky_relu(y)
    if act != "none":
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    return y


def parity_taps(k: int, p: int):
    """A transposed conv with a k x k kernel (k = 2, 3 or 4), lhs dilation 2
    and padding (lo, k - lo), lo = k // 2, split by output parity p: output
    row 2a + p sums the stored taps t with p + t - lo even, reading input row
    a + (p + t - lo) / 2. As a dense sub-problem of n = (k + 1) // 2 taps
    over the input grid: tap j reads row a - lead + j, lead = (lo - p) >> 1,
    and is stored tap t0 + 2j, t0 = (lo - p) % 2, or a zero tap where that
    is past k - 1 (the 3x3's parity 0: tap 1 at row a, a zero at row a + 1).
    -> (the n stored taps, None for a zero one; lead)."""
    lo, n = k // 2, (k + 1) // 2
    t0 = (lo - p) % 2
    return [t0 + 2 * j if t0 + 2 * j < k else None for j in range(n)], (lo - p) >> 1


def _parity_kernel(wq: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """The n x n HWIO sub-kernel of output parity (py, px) (`parity_taps`)."""
    k = wq.shape[0]
    rows, cols = parity_taps(k, py)[0], parity_taps(k, px)[0]
    sub = wq.new_zeros((len(rows), len(cols)) + tuple(wq.shape[2:]))
    for i, ty in enumerate(rows):
        for j, tx in enumerate(cols):
            if ty is not None and tx is not None:
                sub[i, j] = wq[ty, tx]
    return sub


def pack_weights(wq: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """int8 HWIO -> the kernel's K-major matrix: (C_out, kh * kw * C_in) with
    k = (ky * kw + kx) * C_in + ci; for a transposed conv (k x k, k = 2, 3 or
    4, lhs dilation 2, padding (k // 2, k - k // 2)) (4, C_out, n * n * C_in),
    n = (k + 1) // 2, sub-problem p = 2 * py + px holding the n x n taps that
    reach output parity (py, px) (`parity_taps`) in the same K order: for k =
    2 tap (1 - py, 1 - px)."""
    kh, kw, cin, cout = wq.shape
    if transposed:
        if kh != kw or kh not in (2, 3, 4):
            raise ValueError(f"a transposed conv takes a 2x2, 3x3 or 4x4 kernel, got {kh}x{kw}")
        subs = [_parity_kernel(wq, py, px) for py in (0, 1) for px in (0, 1)]
        return torch.stack([pack_weights(sub) for sub in subs]).contiguous()
    return wq.permute(3, 0, 1, 2).reshape(cout, kh * kw * cin).contiguous()


def packed(wq: torch.Tensor, transposed: bool = False) -> PackedWeights:
    """`PackedWeights` of int8 HWIO `wq` on its device (the matrix only on CUDA)."""
    mat = pack_weights(wq, transposed) if wq.device.type == "cuda" else None
    return PackedWeights(wq, mat, transposed)


def normalize_padding(padding):
    """An int or ((top, bottom), (left, right)) -> ((top, bottom), (left, right))."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    (pt, pb), (pl, pr) = padding
    return (int(pt), int(pb)), (int(pl), int(pr))


def _out_hw(h, w, kh, kw, pads, dilation, lhs, stride=1):
    (pt, pb), (pl, pr) = pads
    ly, lx = lhs or (1, 1)
    return (((h - 1) * ly + pt + pb - dilation * (kh - 1)) // stride + 1,
            ((w - 1) * lx + pl + pr - dilation * (kw - 1)) // stride + 1)


def _epilogue(acc, x_step, w_step, bias, out_dtype):
    """int32 NHWC accumulator -> out_dtype, in the kernel's order and roundings."""
    scale = torch.tensor(x_step, dtype=torch.float32, device=acc.device) * w_step.float()
    return (acc.float() * scale + bias.float()).to(out_dtype)


def quantize_codes(t, step) -> torch.Tensor:
    """A site's int8 codes of float tensor `t`: clamp(rint(f32(t) / step),
    -127, 127). `step`, a float32 value, divides as a 0-d float32 tensor on
    t's device (given as one, or made here), so CUDA divides too: by a host
    scalar it would multiply by the reciprocal."""
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(step, dtype=torch.float32, device=t.device)
    return (t.float() / step).round_().clamp_(-127, 127).to(torch.int8)


def int8_conv_plain(x, wq, x_step, w_step, bias, padding=0, dilation: int = 1,
                    lhs_dilation=None, out_dtype=torch.float32, act: str = "none",
                    out_step: Optional[float] = None, stride: int = 1):
    """The plain version: the conv in float64 on the codes (exact for these
    sums, < 2^53), zero-inserted first for `lhs_dilation`, at `stride`, then
    int32 and the float32 epilogue, then `act` (`activation`), then with
    `out_step` the site's codes (`quantize_codes`). x int8 (N, H, W, C_in);
    wq int8 HWIO -> (N, Ho, Wo, C_out) in out_dtype, or int8 codes, NHWC.
    Bit-equal to XLA's `preferred_element_type=int32` conv followed by the
    same epilogue (and the JAX package's `_Ctx.site`)."""
    (pt, pb), (pl, pr) = normalize_padding(padding)
    xd = x.permute(0, 3, 1, 2).double()
    if lhs_dilation is not None:
        ly, lx = lhs_dilation
        b, c, h, w = xd.shape
        z = xd.new_zeros((b, c, (h - 1) * ly + 1, (w - 1) * lx + 1))
        z[:, :, ::ly, ::lx] = xd
        xd = z
    xd = F.pad(xd, (pl, pr, pt, pb))
    acc = F.conv2d(xd, wq.permute(3, 2, 0, 1).double(), stride=stride, dilation=dilation)
    acc = acc.to(torch.int32).permute(0, 2, 3, 1)
    y = activation(_epilogue(acc, x_step, w_step, bias, out_dtype).contiguous(), act)
    return y if out_step is None else quantize_codes(y, out_step)


def _fn():
    fn = _build.library("int8_conv").coastline_int8_conv
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# The custom op: `torch.export` carries it as one node
# ---------------------------------------------------------------------------


@torch.library.custom_op("coastline_torch::int8_conv", mutates_args=(), device_types="cpu")
def int8_conv_op(x: torch.Tensor, w: torch.Tensor, w_step: torch.Tensor, bias: torch.Tensor,
                 kh: int, kw: int, padding: List[int], dilation: int, stride: int,
                 lhs_dilation: Optional[List[int]], x_step: float, act: str,
                 out_dtype: torch.dtype, out_step: Optional[float]) -> torch.Tensor:
    """The conv as an op, called by `int8_conv` once it has checked its
    arguments. `w` is the weights in the device's layout: int8 HWIO on the
    CPU, where this registration runs the plain version, and the kernel's
    matrix (`pack_weights`) on CUDA; `padding` is [top, bottom, left, right]."""
    pt, pb, pl, pr = padding
    return int8_conv_plain(x, w, x_step, w_step, bias, ((pt, pb), (pl, pr)), dilation,
                           lhs_dilation, out_dtype, act, out_step, stride)


@int8_conv_op.register_kernel("cuda")
def _int8_conv_cuda(x, w, w_step, bias, kh, kw, padding, dilation, stride, lhs_dilation, x_step,
                    act, out_dtype, out_step):
    """The kernel's launch: the checks of the storage it reads (one device,
    contiguous, x on a 16-byte boundary), then one launch, counted in
    `int8_conv.launches`. `int8_conv` calls it directly when it runs
    eagerly, a program through the op."""
    w_step = w_step.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    _build.check_card_inputs(x, w, w_step, bias)
    if x.data_ptr() % 16:
        raise ValueError("x must be a contiguous NHWC tensor on a 16-byte boundary (the NHWC "
                         f"view of a channels_last activation); got address {x.data_ptr():#x}")
    dev = x.device
    n, hx, wd, cin = x.shape
    cout = w_step.shape[0]
    pt, pb, pl, pr = padding
    transposed = lhs_dilation is not None
    ho, wo = _out_hw(hx, wd, kh, kw, ((pt, pb), (pl, pr)), dilation, lhs_dilation, stride)
    codes = out_step is not None
    out = torch.empty((n, ho, wo, cout), dtype=torch.int8 if codes else out_dtype, device=dev)
    if transposed:  # four n x n sub-problems over the input grid; the pads carry lo
        n_sub, lo = (kh + 1) // 2, kh // 2
        geom = (n_sub, n_sub, lo, lo, 1, 1, hx, wd)
    else:
        geom = (kh, kw, pt, pl, dilation, stride, ho, wo)
    with torch.cuda.device(dev):
        status = _fn()(x.data_ptr(), w.data_ptr(), w_step.data_ptr(), bias.data_ptr(),
                       out.data_ptr(), n, hx, wd, cin, cout, *geom, int(transposed),
                       float(x_step), int(out_dtype == torch.bfloat16), ACTS.index(act),
                       int(codes), float(out_step) if codes else 1.0,
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "int8_conv launch")
    int8_conv.launches += 1
    return out


@int8_conv_op.register_fake
def _int8_conv_fake(x, w, w_step, bias, kh, kw, padding, dilation, stride, lhs_dilation, x_step,
                    act, out_dtype, out_step):
    pt, pb, pl, pr = padding
    ho, wo = _out_hw(x.shape[1], x.shape[2], kh, kw, ((pt, pb), (pl, pr)), dilation,
                     lhs_dilation, stride)
    dtype = torch.int8 if out_step is not None else out_dtype
    return x.new_empty((x.shape[0], ho, wo, w_step.shape[0]), dtype=dtype)


def int8_conv(x, w: PackedWeights, x_step: float, w_step, bias, padding=0, dilation: int = 1,
              lhs_dilation=None, out_dtype=torch.float32, act: str = "none",
              out_step: Optional[float] = None, stride: int = 1):
    """x int8 (N, H, W, C_in) NHWC; w the conv's `PackedWeights` (`packed`
    of int8 HWIO (kh, kw, C_in, C_out), on x's device, built once); x_step a
    float (a float32 value); w_step, bias float32 (C_out,) -> (N, Ho, Wo,
    C_out) contiguous NHWC in out_dtype (float32 or bfloat16), `act` applied
    ("none", "relu" or "leaky"); with `out_step` (a float32 value) the int8
    codes of that site instead. See the module docstring for the options.
    Checks its arguments, then runs the op's body for x's device (the plain
    version with the HWIO weights on the CPU, the launch with the kernel's
    layout on CUDA); traced, it calls `int8_conv_op` instead (`_build.tracing`)."""
    if not isinstance(w, PackedWeights):
        raise TypeError(f"w must be PackedWeights (`packed` of the int8 HWIO weights, built "
                        f"once), got {type(w).__name__}")
    wq = w.hwio
    if x.ndim != 4 or x.dtype != torch.int8:
        raise TypeError(f"x must be int8 (N, H, W, C), got {x.dtype} {tuple(x.shape)}")
    if wq.ndim != 4 or wq.dtype != torch.int8 or wq.shape[2] != x.shape[3]:
        raise ValueError(f"w must be int8 HWIO with C_in {x.shape[3]}, got {wq.dtype} "
                         f"{tuple(wq.shape)}")
    kh, kw, cin, cout = wq.shape
    if tuple(w_step.shape) != (cout,) or tuple(bias.shape) != (cout,):
        raise ValueError(f"w_step and bias must be ({cout},), got {tuple(w_step.shape)} "
                         f"and {tuple(bias.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    pads = normalize_padding(padding)
    lhs = tuple(lhs_dilation) if lhs_dilation is not None else None
    transposed = lhs is not None
    if w.transposed != transposed:
        raise ValueError("packed weights of a transposed conv need lhs_dilation, and only they")
    ho, wo = _out_hw(x.shape[1], x.shape[2], kh, kw, pads, dilation, lhs, stride)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output {ho}x{wo} for input {tuple(x.shape)}")
    dev = x.device
    if any(t.device != dev for t in (wq, w_step, bias)):
        raise ValueError("x, w, w_step and bias must be on one device")
    (pt, pb), (pl, pr) = pads
    args = ([pt, pb, pl, pr], dilation, stride, list(lhs) if transposed else None,
            float(x_step), act, out_dtype, None if out_step is None else float(out_step))
    traced = _build.tracing(x)
    if dev.type == "cpu":
        if traced:
            return int8_conv_op(x, wq, w_step, bias, kh, kw, *args)
        return int8_conv_plain(x, wq, x_step, w_step, bias, pads, dilation, lhs, out_dtype, act,
                               out_step, stride)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _build.refuse_grad("int8_conv", x, w_step, bias)
    if cin % 16 or cout % 8:
        raise ValueError(f"the int8 conv kernel needs C_in % 16 == 0 and C_out % 8 == 0, "
                         f"got C_in {cin}, C_out {cout}")
    if stride not in (1, 2, 4):
        raise ValueError(f"the int8 conv kernel takes stride 1, 2 or 4, got {stride}")
    lo = kh // 2
    if transposed and (lhs != (2, 2) or kh != kw or kh not in (2, 3, 4)
                       or pads != ((lo, kh - lo), (lo, kh - lo)) or stride != 1 or dilation != 1):
        raise ValueError("the kernel's transposed conv is lhs_dilation (2, 2), a k x k kernel "
                         "(k = 2, 3 or 4), padding (k // 2, k - k // 2), stride 1; got "
                         f"{lhs}, {kh}x{kw}, {pads}, stride {stride}, dilation {dilation}")
    if w.mat is None or w.mat.device != dev:
        raise ValueError("w has no kernel layout on this device: build it once with `packed` "
                         "of the weights on the card")
    return (int8_conv_op if traced else _int8_conv_cuda)(x, w.mat, w_step, bias, kh, kw, *args)


int8_conv.launches = 0
