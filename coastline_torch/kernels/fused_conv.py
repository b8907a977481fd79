"""Fused conv3x3 + folded BN + ReLU for NHWC bf16 at C = 64.

Replaces the TPU kernel `coastline/pallas/fused_conv.py::fused_conv3x3_bn_relu`
with the CUDA C++ kernel `coastline_torch/csrc/fused_conv3x3_bn_relu.cu`.
It computes `relu(conv3x3_same(x, w) * scale + bias)` with float32
accumulation and a bf16 result; `relu=False` gives the plain affine.

Bound on an H100 SXM at the serving shape (8, 512, 512, 64): 154.6 GFLOP
against 989 TFLOP/s (0.156 ms) and 537 MB against 3.35 TB/s (0.160 ms), so
it sits on the ridge between the two roofs. The kernel keeps the 576 x 64
weight matrix resident in shared memory in persistent CTAs and reads each
activation tile once with its halo; see the source for the tiling.

`fused_conv3x3_bn_relu` launches the kernel for a CUDA tensor (or raises),
and runs `fused_conv3x3_bn_relu_plain` only for a tensor on the CPU.
"""

import ctypes

import torch
import torch.nn.functional as F

from coastline_torch.kernels import _build

C = 64


def fused_conv3x3_bn_relu_plain(x, w, scale, bias, relu: bool = True):
    """Plain version: float32 conv of the bf16-rounded inputs, the float32
    epilogue, then one bf16 rounding — the kernel's arithmetic up to the
    order of the sums."""
    xf = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wf = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)
    y = F.conv2d(xf, wf, padding=1)
    y = y * scale.float()[:, None, None] + bias.float()[:, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def _lib():
    lib = _build.library("fused_conv3x3_bn_relu")
    fn = lib.coastline_fused_conv3x3_bn_relu
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_conv3x3_bn_relu(x, w, scale, bias, relu: bool = True):
    """x (B, H, W, 64) bf16 NHWC; w (3, 3, 64, 64) HWIO (cast to bf16);
    scale, bias (64,) float32 -> (B, H, W, 64) bf16.

    The BN fold: scale = gamma / sqrt(var + eps), bias = beta + (b - mean) *
    scale for a conv with bias b."""
    if x.ndim != 4 or x.shape[-1] != C or tuple(w.shape) != (3, 3, C, C):
        raise ValueError(f"expected x (B,H,W,{C}) and w (3,3,{C},{C}), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if tuple(scale.shape) != (C,) or tuple(bias.shape) != (C,):
        raise ValueError("scale and bias must have shape (64,)")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return fused_conv3x3_bn_relu_plain(x, w, scale, bias, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous NHWC tensor (channels_last "
                         "activations permuted to NHWC) aligned to 16 bytes")
    for t in (w, scale, bias):
        if t.device != x.device:
            raise ValueError("x, w, scale and bias must be on one device")
    wmat = w.to(torch.bfloat16).reshape(9 * C, C).contiguous()
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    b, h, ww, _ = x.shape
    with torch.cuda.device(x.device):
        status = _lib()(x.data_ptr(), wmat.data_ptr(), scale.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), b, h, ww, int(relu),
                        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "fused_conv3x3_bn_relu launch")
    fused_conv3x3_bn_relu.launches += 1
    return out


fused_conv3x3_bn_relu.launches = 0
