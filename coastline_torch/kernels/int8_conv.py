"""Int8 convolution with a fused dequantizing epilogue (no Pallas counterpart).

The JAX package runs the int8 convs of its PTQ path as XLA `s8 x s8 -> s32`
convolutions with the epilogue fused by XLA (`coastline/infer/quant.py:573-578`);
no Pallas kernel is involved. PyTorch has no such conv on CUDA (`F.conv2d`
refuses int8), so the port computes the same function with its own CUDA
kernel, `csrc/int8_conv.cu`:

    y[n, oy, ox, co] = cast( f32(acc) * (x_step * w_step[co]) + bias[co] )
    acc = sum over (ky, kx, ci) of x_q[n, iy, ix, ci] * w_q[ky, kx, ci, co]

x_q int8 NHWC, w_q int8 HWIO, acc int32 (exact: 127^2 * 9 * 1024 < 2^31),
x_step a float32 scalar, w_step and bias float32 per output channel, the
result in float32 or bfloat16 (one round to nearest even). The float32
epilogue runs in that order, first x_step * w_step, then acc * that, then
+ bias, each rounded, as XLA computes it.

Options (stride 1 only): any kh x kw, per-side `padding` ((top, bottom),
(left, right)) or an int, rhs `dilation`, and `lhs_dilation=(2, 2)` with a
2x2 kernel and padding ((1, 1), (1, 1)): the transposed convs of the UNets'
decoders. The kernel splits such a conv into its four output-parity
sub-problems, each a dense 1x1 GEMM (a tap loop over the zero-inserted
input would multiply zeros for 3/4 of its taps).

What bounds it on an H100: at the UNet's first level (8, 512, 512, 64 -> 64,
3x3) the bytes (134 MB in, 268 MB out in bf16: 0.120 ms at 3.35 TB/s); at
its bottleneck (8, 32, 32, 1024 -> 1024) the 154.6 GOP (0.078 ms at 1979
int8 TOPS). The kernel is a plain implicit GEMM on `mma.sync` (see the
source); wgmma and TMA are later work.

`int8_conv` launches the kernel for CUDA tensors (or raises) and runs
`int8_conv_plain` only for tensors on the CPU. It takes the weights as
`PackedWeights`, whose kernel layout `packed` builds once on the card. The
card needs C_in % 32 == 0, C_out % 8 == 0 and a contiguous NHWC input on a
16-byte boundary.
`.launches` counts kernel launches.
"""

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from coastline_torch.kernels import _build

_TRANSPOSED_PAD = ((1, 1), (1, 1))


class PackedWeights(NamedTuple):
    """An int8 conv's weights: `hwio` (kh, kw, C_in, C_out), the JAX layout
    the plain version reads, and `mat`, the kernel's layout on the card
    (`pack_weights`), or None on the CPU."""

    hwio: torch.Tensor
    mat: Optional[torch.Tensor]
    transposed: bool


def pack_weights(wq: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """int8 HWIO -> the kernel's K-major matrix: (C_out, kh * kw * C_in) with
    k = (ky * kw + kx) * C_in + ci; for a transposed conv (2x2, lhs dilation
    2) (4, C_out, C_in), sub-problem p = 2 * py + px holding tap (1 - py,
    1 - px), the one that reaches output parity (py, px)."""
    kh, kw, cin, cout = wq.shape
    if transposed:
        if (kh, kw) != (2, 2):
            raise ValueError(f"a transposed conv takes a 2x2 kernel, got {kh}x{kw}")
        return wq.flip(0, 1).permute(0, 1, 3, 2).reshape(4, cout, cin).contiguous()
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


def _out_hw(h, w, kh, kw, pads, dilation, lhs):
    (pt, pb), (pl, pr) = pads
    ly, lx = lhs or (1, 1)
    return ((h - 1) * ly + 1 + pt + pb - dilation * (kh - 1),
            (w - 1) * lx + 1 + pl + pr - dilation * (kw - 1))


def _epilogue(acc, x_step, w_step, bias, out_dtype):
    """int32 NHWC accumulator -> out_dtype, in the kernel's order and roundings."""
    scale = torch.tensor(x_step, dtype=torch.float32, device=acc.device) * w_step.float()
    return (acc.float() * scale + bias.float()).to(out_dtype)


def int8_conv_plain(x, wq, x_step, w_step, bias, padding=0, dilation: int = 1,
                    lhs_dilation=None, out_dtype=torch.float32):
    """The plain version: the conv in float64 on the codes (exact for these
    sums, < 2^53), zero-inserted first for `lhs_dilation`, then int32 and the
    float32 epilogue. x int8 (N, H, W, C_in); wq int8 HWIO -> (N, Ho, Wo,
    C_out) in out_dtype, NHWC. Bit-equal to XLA's `preferred_element_type=
    int32` conv followed by the same epilogue."""
    (pt, pb), (pl, pr) = normalize_padding(padding)
    xd = x.permute(0, 3, 1, 2).double()
    if lhs_dilation is not None:
        ly, lx = lhs_dilation
        b, c, h, w = xd.shape
        z = xd.new_zeros((b, c, (h - 1) * ly + 1, (w - 1) * lx + 1))
        z[:, :, ::ly, ::lx] = xd
        xd = z
    xd = F.pad(xd, (pl, pr, pt, pb))
    acc = F.conv2d(xd, wq.permute(3, 2, 0, 1).double(), dilation=dilation)
    acc = acc.to(torch.int32).permute(0, 2, 3, 1)
    return _epilogue(acc, x_step, w_step, bias, out_dtype).contiguous()


def _fn():
    fn = _build.library("int8_conv").coastline_int8_conv
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_float]
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def int8_conv(x, w: PackedWeights, x_step: float, w_step, bias, padding=0, dilation: int = 1,
              lhs_dilation=None, out_dtype=torch.float32):
    """x int8 (N, H, W, C_in) NHWC; w the conv's `PackedWeights` (`packed`
    of int8 HWIO (kh, kw, C_in, C_out), on x's device, built once); x_step a
    float (a float32 value); w_step, bias float32 (C_out,) -> (N, Ho, Wo,
    C_out) contiguous NHWC in out_dtype (float32 or bfloat16). Stride 1;
    see the module docstring for the options."""
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
    pads = normalize_padding(padding)
    lhs = tuple(lhs_dilation) if lhs_dilation is not None else None
    transposed = lhs is not None
    if w.transposed != transposed:
        raise ValueError("packed weights of a transposed conv need lhs_dilation, and only they")
    ho, wo = _out_hw(x.shape[1], x.shape[2], kh, kw, pads, dilation, lhs)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output {ho}x{wo} for input {tuple(x.shape)}")
    dev = x.device
    if any(t.device != dev for t in (wq, w_step, bias)):
        raise ValueError("x, w, w_step and bias must be on one device")
    if dev.type == "cpu":
        return int8_conv_plain(x, wq, x_step, w_step, bias, pads, dilation, lhs, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _build.refuse_grad("int8_conv", x, w_step, bias)
    if cin % 32 or cout % 8:
        raise ValueError(f"the int8 conv kernel needs C_in % 32 == 0 and C_out % 8 == 0, "
                         f"got C_in {cin}, C_out {cout}")
    if transposed and (lhs != (2, 2) or (kh, kw) != (2, 2) or pads != _TRANSPOSED_PAD):
        raise ValueError("the kernel's transposed conv is lhs_dilation (2, 2), a 2x2 kernel "
                         f"and padding {_TRANSPOSED_PAD}; got {lhs}, {kh}x{kw}, {pads}")
    if w.mat is None or w.mat.device != dev:
        raise ValueError("w has no kernel layout on this device: build it once with `packed` "
                         "of the weights on the card")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous NHWC tensor on a 16-byte boundary (the NHWC "
                         f"view of a channels_last activation); got strides {x.stride()}")
    mat = w.mat
    w_step = w_step.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    n, h, wd, _ = x.shape
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=dev)
    (pt, _), (pl, _) = pads
    if transposed:  # four 1x1 sub-problems over the input grid
        geom = (1, 1, 0, 0, 1, h, wd)
    else:
        geom = (kh, kw, pt, pl, dilation, ho, wo)
    with torch.cuda.device(dev):
        status = _fn()(x.data_ptr(), mat.data_ptr(), w_step.data_ptr(), bias.data_ptr(),
                       out.data_ptr(), n, h, wd, cin, cout, *geom, int(transposed),
                       float(x_step), int(out_dtype == torch.bfloat16),
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "int8_conv launch")
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
