"""Int8 post-training quantization of the UNet, the Robust U-Net and SegNet
(counterpart of `coastline/infer/quant.py`).

  * Eval only. Every BatchNorm folds into its conv (weights and bias in
    float32) before quantization; a transposed conv has no BN and keeps its
    bias. The folds read the port's `state_dict` (reference names) and give
    the JAX package's folded tree: the same keys (`dc0/c1`, `rb3/short`,
    `db/b2`, `ag1/psi`, `up2`, `head`, ...), HWIO weights, float32, bit for
    bit (`fold_unet`, `fold_robust_unet`, `fold_segnet`).
  * Weights: symmetric per-output-channel int8, step = absmax / 127.
  * Activations: symmetric per-tensor int8 at named sites (conv inputs and
    the tensors the CBAM and gate epilogues read again), scaled by the
    absmax a calibration pass records at each site.
  * One forward per architecture serves both modes: the float mode
    (`scales=None`, the calibration recorder and the correctness anchor) and
    the int8 mode, in which a conv whose input is int8 and whose channel
    counts are both >= `conv_min_ch` runs as an int8 x int8 -> int32
    implicit GEMM with the dequantizing epilogue fused
    (`kernels/int8_conv.py`, the CUDA kernel on the card); a smaller conv
    (the RGB stem, the gates' psi and spatial-attention convs, the heads)
    dequantizes its int8 input and runs in the compute dtype.

Everything is a function on tensors in the JAX package's NHWC layout; the
float convs hand cuDNN the NCHW views of the same (channels_last) memory.
SegNet's indexed pool and unpool run on the int8 codes through the kernels
of `kernels/unpool.py`. `ARCHS` holds the three ported architectures;
`quant_arch_for` returns None for the other nine of the registry.
"""

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from coastline_torch.kernels import unpool
from coastline_torch.kernels.int8_conv import (PackedWeights, int8_conv, normalize_padding,
                                               packed)
from coastline_torch.utils.device import resolve_device
from coastline_torch.utils.torch_import import (ROBUST_BLOCKS, ROBUST_GATES, ROBUST_UPCONVS,
                                                SEGNET_STAGES, UNET_BLOCKS, UNET_UPCONVS)

_EPS = 1e-5  # BatchNorm epsilon (torch default)


# ---------------------------------------------------------------------------
# BN folding
# ---------------------------------------------------------------------------


def _arr(sd, key) -> np.ndarray:
    v = sd[key]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def _hwio(w: np.ndarray) -> np.ndarray:
    """torch (out, in, kh, kw) -> HWIO: a permutation, no arithmetic."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _bn_affine(sd, prefix):
    """Per-channel (inv, shift): y_bn = y * inv + shift (eval-mode BN); inv is
    computed in float64 and rounded to float32, as the JAX package does."""
    scale, bias = _arr(sd, f"{prefix}.weight"), _arr(sd, f"{prefix}.bias")
    mean, var = _arr(sd, f"{prefix}.running_mean"), _arr(sd, f"{prefix}.running_var")
    inv = np.asarray(scale / np.sqrt(np.asarray(var, np.float64) + _EPS), np.float32)
    return inv, np.asarray(bias - mean * inv, np.float32)


def _fold(sd, conv, bn=None, inv=None, shift=None):
    """Fold an eval-mode BN affine into conv `conv`'s weight and bias -> (w, b)."""
    w = _hwio(_arr(sd, f"{conv}.weight"))
    b0 = (_arr(sd, f"{conv}.bias") if f"{conv}.bias" in sd
          else np.zeros(w.shape[-1], np.float32))
    if inv is None:
        if bn is None:
            return w, b0
        inv, shift = _bn_affine(sd, bn)
    return w * inv[None, None, None, :], b0 * inv + shift


def _conv_t(sd, name):
    """A torch ConvTranspose2d (in, out, kh, kw) -> the JAX kernel (kh, kw, in,
    out), stored spatially flipped: the bridge's `_convT_inv` inverted."""
    k = np.transpose(_arr(sd, f"{name}.weight"), (2, 3, 0, 1))[::-1, ::-1]
    return np.ascontiguousarray(k), _arr(sd, f"{name}.bias")


def fold_unet(sd) -> Dict:
    """Fold the BNs of the 2-class UNet (`models/unet.py`)."""
    out: Dict = {}
    for i, name in enumerate(UNET_BLOCKS):
        out[f"dc{i}"] = {"c1": _fold(sd, f"{name}.0", f"{name}.1"),
                         "c2": _fold(sd, f"{name}.3", f"{name}.4")}
    for i, name in enumerate(UNET_UPCONVS):
        out[f"up{i}"] = _conv_t(sd, name)
    out["head"] = _fold(sd, "final")
    return out


def fold_robust_unet(sd) -> Dict:
    """Fold the BNs of the Robust U-Net (`models/robust_unet.py`): per
    residual block its shortcut (None for an identity), c1, c2 and the CBAM
    weights (fc1, fc2 in the Dense layout, sa HWIO); the dilated block's
    four branches, each with its quarter of the shared BN; the gates."""
    out: Dict = {}
    for i, name in enumerate(ROBUST_BLOCKS):
        short = (_fold(sd, f"{name}.shortcut.0", f"{name}.shortcut.1")
                 if f"{name}.shortcut.0.weight" in sd else None)
        out[f"rb{i}"] = {
            "short": short,
            "c1": _fold(sd, f"{name}.conv1", f"{name}.bn1"),
            "c2": _fold(sd, f"{name}.conv2", f"{name}.bn2"),
            "fc1": np.ascontiguousarray(_arr(sd, f"{name}.ca.fc.0.weight")[:, :, 0, 0].T),
            "fc2": np.ascontiguousarray(_arr(sd, f"{name}.ca.fc.2.weight")[:, :, 0, 0].T),
            "sa": _hwio(_arr(sd, f"{name}.sa.conv1.weight")),
        }
    inv, shift = _bn_affine(sd, "bottleneck.1.bn")
    f4 = inv.shape[0] // 4
    out["db"] = {f"b{k}": _fold(sd, f"bottleneck.1.conv{k + 1}", inv=inv[k * f4:(k + 1) * f4],
                                shift=shift[k * f4:(k + 1) * f4]) for k in range(4)}
    for i, (gate, up) in enumerate(zip(ROBUST_GATES, ROBUST_UPCONVS)):
        out[f"ag{i}"] = {"g": _fold(sd, f"{gate}.W_g.0", f"{gate}.W_g.1"),
                         "x": _fold(sd, f"{gate}.W_x.0", f"{gate}.W_x.1"),
                         "psi": _fold(sd, f"{gate}.psi.0", f"{gate}.psi.1")}
        out[f"up{i}"] = _conv_t(sd, up)
    out["head"] = _fold(sd, "outc.0")
    return out


def fold_segnet(sd) -> Dict:
    """Fold the BNs of SegNet (`models/segnet.py`): its 19 ConvBNAct layers in
    call order (10 encoder, 9 decoder) as c0..c18, and the 3x3 head."""
    out: Dict = {}
    i = 0
    for name, widths in SEGNET_STAGES:
        for j in range(len(widths) - 1):
            out[f"c{i}"] = _fold(sd, f"{name}.{3 * j}", f"{name}.{3 * j + 1}")
            i += 1
    out["head"] = _fold(sd, "dec1.3")
    return out


# ---------------------------------------------------------------------------
# Weight quantization
# ---------------------------------------------------------------------------


def _quant_w(w: np.ndarray):
    """Symmetric per-output-channel int8: w ~= wq * step[None, None, None, :]."""
    absmax = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0)
    step = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    wq = np.clip(np.round(w / step), -127, 127).astype(np.int8)
    return wq, step


def quantize_folded(folded: Dict) -> Dict:
    """Add (wq, wstep) int8 views beside every conv of a folded tree."""

    def q(entry):
        if entry is None:
            return None
        w, b = entry
        wq, step = _quant_w(w)
        return {"w": w, "b": b, "wq": wq, "wstep": step}

    out = {}
    for k, v in folded.items():
        if isinstance(v, dict):
            out[k] = {kk: (q(vv) if isinstance(vv, tuple) or vv is None else vv)
                      for kk, vv in v.items()}
        else:
            out[k] = q(v)
    return out


# ---------------------------------------------------------------------------
# The tree on a device
# ---------------------------------------------------------------------------


DEFAULT_POLICY = {
    "conv_min_ch": 64,   # int8 conv iff min(C_in, C_out) >= this
    "convT_int8": True,  # int8 path for the transposed (lhs-dilated) convs
    # quantize the CBAM gated tensor at its own `.gated` site (calibration
    # records the site either way); off, as in the JAX package
    "gated_int8": False,
    # the decoder's conv(concat(a, b)) as two int8 convs summed in float32
    # instead of a requantized concat; off, as in the JAX package
    "split_cat": False,
}


def int8_eligible(cin: int, cout: int, transposed: bool, policy: Dict) -> bool:
    """Whether `policy` runs a conv with these channel counts on the int8
    path once its input is int8 (the JAX package's rule, `_conv`): both
    counts >= `conv_min_ch`, and a transposed conv only under `convT_int8`.
    The one copy of the rule: `to_device` packs by it, `_conv` and
    `_conv_cat` dispatch by it, and a slim artifact drops float weights by
    it."""
    return min(cin, cout) >= policy["conv_min_ch"] and (policy["convT_int8"] or not transposed)


class DeviceTree(dict):
    """A (folded or quantized) tree moved to one device by `to_device`."""


def to_device(tree, device, policy: Optional[Dict] = None) -> DeviceTree:
    """Move a tree of numpy arrays to `device` once: every array becomes a
    tensor, a folded (w, b) entry a tuple of tensors, and a quantized entry
    a dict whose `wq` is `PackedWeights`. A conv the policy runs on the int8
    path (`int8_eligible`; a transposed conv is an `up*` entry, as in the
    JAX package's forwards) gets the kernel's layout here and leaves its
    float32 `w`, which that path never reads, on the host."""
    if isinstance(tree, DeviceTree):
        return tree
    device = torch.device(device)
    pol = dict(DEFAULT_POLICY, **(policy or {}))

    def t(a):
        return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a)).to(device)

    def entry(key, v):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(t(a) for a in v)
        if isinstance(v, dict) and "wq" in v:
            wq, transposed = t(v["wq"]), key.startswith("up")
            if int8_eligible(wq.shape[2], wq.shape[3], transposed, pol):
                out = {k: t(a) for k, a in v.items() if k not in ("wq", "w")}
                out["wq"] = packed(wq, transposed)
            else:
                out = {k: t(a) for k, a in v.items() if k != "wq"}
                out["wq"] = PackedWeights(wq, None, transposed)
            return out
        if isinstance(v, dict):
            return {k: entry(k, a) for k, a in v.items()}
        return t(v)

    return DeviceTree({k: entry(k, v) for k, v in tree.items()})


# ---------------------------------------------------------------------------
# Forward (shared float / int8 implementation)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _QT:
    """A tensor either in float form or as (int8 codes, dequant step)."""

    q: torch.Tensor
    step: Optional[float] = None  # a float32 value; None => q is float

    def f(self, dtype=torch.bfloat16):
        """The tensor in `dtype`: the codes times the step, both in `dtype`
        first (the step rounded to bf16 in a bf16 computation)."""
        if self.step is None:
            return self.q.to(dtype)
        step = float(torch.tensor(self.step, dtype=torch.float32).to(dtype))
        return self.q.to(dtype) * step


class _Ctx:
    """The mode (float / calibration vs int8), the scales and the absmax
    records of one forward. `steps` caches each site's step as a tensor on
    the device, for the quantizing division (a CUDA division by a host
    scalar multiplies by its reciprocal, which rounds otherwise)."""

    def __init__(self, scales: Optional[Dict[str, float]], collect=None,
                 dtype=torch.bfloat16, policy: Optional[Dict] = None, steps=None):
        self.scales = scales
        self.collect = collect
        self.dtype = dtype
        self.policy = dict(DEFAULT_POLICY, **(policy or {}))
        self.steps = {} if steps is None else steps

    @property
    def quant(self):
        return self.scales is not None

    def site(self, name: str, t: torch.Tensor, optional: bool = False) -> _QT:
        """Quantize float tensor `t` at a named site (or record its range):
        step = float32(scale / 127), codes = clip(round(t / step), -127, 127),
        a true division and round half to even. `optional` sites quantize
        only when the scales have them."""
        if self.collect is not None:
            m = t.float().abs().amax()
            prev = self.collect.get(name)
            self.collect[name] = m if prev is None else torch.maximum(prev, m)
        if not self.quant or (optional and name not in self.scales):
            return _QT(t.to(self.dtype))
        key = (name, t.device)
        if key not in self.steps:
            step = float(np.float32(self.scales[name] / 127.0))
            self.steps[key] = (step, torch.tensor(step, dtype=torch.float32, device=t.device))
        step, step_t = self.steps[key]
        q = (t.float() / step_t).round_().clamp_(-127, 127).to(torch.int8)
        return _QT(q, step)


def _sigmoid(t):
    """`jax.nn.sigmoid`'s arithmetic: in bfloat16 XLA expands it to 1 / (1 +
    exp(-x)) with every op rounded to bfloat16 (torch.sigmoid rounds once,
    one ulp off for a third of the values); in float32 torch.sigmoid."""
    if t.dtype == torch.bfloat16:
        return 1 / (1 + torch.exp(-t))
    return torch.sigmoid(t)


def _float_conv(x, w, b, pads, dilation, lhs_dilation, dtype):
    """The float path: `x` NHWC in `dtype`, `w` HWIO -> NHWC + bias, in dtype.
    A transposed conv (lhs dilation 2, 2x2 kernel, padding 1) is torch's
    stride-2 transposed conv with the stored (flipped) kernel flipped back."""
    wt = w.to(dtype)
    xc = x.permute(0, 3, 1, 2)
    if lhs_dilation is not None:
        if (tuple(lhs_dilation) != (2, 2) or tuple(wt.shape[:2]) != (2, 2)
                or pads != ((1, 1), (1, 1))):
            raise ValueError(f"unsupported transposed conv: lhs_dilation {lhs_dilation}, "
                             f"kernel {tuple(wt.shape[:2])}, padding {pads}")
        y = F.conv_transpose2d(xc, wt.flip(0, 1).permute(2, 3, 0, 1), stride=2)
    else:
        (pt, pb), (pl, pr) = pads
        if pt != pb or pl != pr:
            xc, pt, pl = F.pad(xc, (pl, pr, pt, pb)), 0, 0
        y = F.conv2d(xc, wt.permute(3, 2, 0, 1), padding=(pt, pl), dilation=dilation)
    return y.permute(0, 2, 3, 1) + b.to(dtype)


def _conv(ctx: _Ctx, x: _QT, entry, padding=0, dilation=1, lhs_dilation=None) -> torch.Tensor:
    """Conv on a site tensor -> NHWC in the compute dtype, bias added.

    The int8 path when the context quantizes, the input is int8 and the
    policy sends the conv there (`int8_eligible`; stride 1)."""
    pads = normalize_padding(padding)
    if isinstance(entry, dict):
        w, b, wq, wstep = entry.get("w"), entry["b"], entry["wq"], entry["wstep"]
        if ctx.quant and x.step is not None and int8_eligible(
                wq.hwio.shape[2], wq.hwio.shape[3], wq.transposed, ctx.policy):
            return int8_conv(x.q.contiguous(), wq, x.step, wstep, b, pads, dilation,
                             lhs_dilation, out_dtype=ctx.dtype)
        if w is None:
            raise KeyError("a conv without float weights on the float path: an int8-path conv "
                           "leaves them on the host, and a slim artifact restores them only "
                           "through `load_quantized`")
    else:
        w, b = entry
    return _float_conv(x.f(ctx.dtype), w, b, pads, dilation, lhs_dilation, ctx.dtype)


def _conv_cat(ctx: _Ctx, a: _QT, b: _QT, entry, padding=0) -> torch.Tensor:
    """`conv(concat([a, b], -1), W)` without the concat on the int8 path: each
    operand's own codes convolve their half of W (two kernel launches in
    float32, bias 0) and the halves are summed with the bias in the JAX
    package's order. Otherwise the concat in the compute dtype and `_conv`."""
    c0 = a.q.shape[-1]
    use_int8 = ctx.quant and a.step is not None and b.step is not None and isinstance(entry, dict)
    if use_int8:
        bias, wq, wstep = entry["b"], entry["wq"], entry["wstep"]
        cin, cout = wq.hwio.shape[2], wq.hwio.shape[3]
        use_int8 = (int8_eligible(c0, cout, False, ctx.policy)
                    and int8_eligible(cin - c0, cout, False, ctx.policy))
    if not use_int8:
        xcat = _QT(torch.cat([a.f(ctx.dtype), b.f(ctx.dtype)], dim=-1))
        return _conv(ctx, xcat, entry, padding=padding)
    halves = entry.setdefault("_split", {})
    if c0 not in halves:  # packed once per model, at the first call
        halves[c0] = (packed(wq.hwio[:, :, :c0].contiguous()),
                      packed(wq.hwio[:, :, c0:].contiguous()))
    zero = torch.zeros_like(bias)
    y1 = int8_conv(a.q.contiguous(), halves[c0][0], a.step, wstep, zero, padding)
    y2 = int8_conv(b.q.contiguous(), halves[c0][1], b.step, wstep, zero, padding)
    return (y1 + y2 + bias).to(ctx.dtype)


def _maxpool(x: _QT) -> _QT:
    """2x2 / stride-2 max pool directly on the codes (monotonic under dequant)."""
    q = x.q
    n, h, w, c = q.shape
    q = q[:, :h // 2 * 2, :w // 2 * 2].reshape(n, h // 2, 2, w // 2, 2, c).amax((2, 4))
    return _QT(q, x.step)


def _residual_block(ctx: _Ctx, name: str, x: Optional[_QT], p, pair=None) -> _QT:
    """`pair=(a, b)`: the block's input is concat([a, b], -1), its two input
    convs through `_conv_cat` (the int8 split-cat path)."""
    dt = ctx.dtype
    if pair is not None:
        short = ctx.site(f"{name}.short", _conv_cat(ctx, *pair, p["short"]))
        t1 = torch.relu(_conv_cat(ctx, *pair, p["c1"], padding=1))
    else:
        short = ctx.site(f"{name}.short", _conv(ctx, x, p["short"])) \
            if p["short"] is not None else x
        t1 = torch.relu(_conv(ctx, x, p["c1"], padding=1))
    t1 = ctx.site(f"{name}.t1", t1)
    mid = ctx.site(f"{name}.mid", _conv(ctx, t1, p["c2"], padding=1))

    # CBAM channel gate: mean (float32 sum) and max of the raw codes, the
    # pooled vectors dequantized exactly (mean and max commute with the step)
    hw = mid.q.shape[1] * mid.q.shape[2]
    avg = mid.q.sum((1, 2), dtype=torch.float32) / hw
    mx = mid.q.amax((1, 2)).float()
    if mid.step is not None:
        avg, mx = avg * mid.step, mx * mid.step
    fc1, fc2 = p["fc1"].float(), p["fc2"].float()
    gate = torch.relu(avg @ fc1) @ fc2 + torch.relu(mx @ fc1) @ fc2
    gc = torch.sigmoid(gate).to(dt)  # (N, C)

    # CBAM spatial gate on the channel-gated tensor
    gated = mid.f(dt) * gc[:, None, None, :]
    if ctx.quant and not ctx.policy.get("gated_int8", True):
        gq = _QT(gated)
    else:
        gq = ctx.site(f"{name}.gated", gated, optional=True)
    gb = gq.f(dt)
    att = torch.stack([(gb.sum(-1, dtype=torch.float32) / gb.shape[-1]).to(dt),
                       gb.amax(-1)], dim=1)  # (N, 2, H, W)
    sa = F.conv2d(att, p["sa"].to(dt).permute(3, 2, 0, 1), padding=3)
    gs = _sigmoid(sa).permute(0, 2, 3, 1)  # (N, H, W, 1), compute dtype
    return ctx.site(f"{name}.out", torch.relu(gb * gs + short.f(dt)))


def _attention_gate(ctx: _Ctx, name: str, g: _QT, x: _QT, p) -> _QT:
    g1 = _conv(ctx, g, p["g"])
    x1 = _conv(ctx, x, p["x"])
    psi = ctx.site(f"{name}.psi", torch.relu(g1 + x1))
    psi = _conv(ctx, psi, p["psi"])
    gate = torch.sigmoid(psi.float()).to(ctx.dtype)
    return ctx.site(f"{name}.out", x.f(ctx.dtype) * gate)


def _double_conv(ctx: _Ctx, name: str, x: Optional[_QT], p, pair=None) -> _QT:
    t1_raw = _conv_cat(ctx, *pair, p["c1"], padding=1) if pair is not None \
        else _conv(ctx, x, p["c1"], padding=1)
    t1 = ctx.site(f"{name}.t1", torch.relu(t1_raw))
    return ctx.site(f"{name}.out", torch.relu(_conv(ctx, t1, p["c2"], padding=1)))


def _split_cat(ctx: _Ctx, a: _QT, b: _QT) -> bool:
    return (ctx.quant and ctx.policy.get("split_cat", True)
            and a.step is not None and b.step is not None)


def _forward_unet(qp, scales, x, collect=None, dtype=torch.bfloat16, policy=None, steps=None):
    """The plain UNet on folded params: logits, concat order [up, skip]."""
    ctx = _Ctx(scales, collect, dtype, policy, steps)
    cur = ctx.site("input", x.float())
    enc = []
    for i in range(4):
        cur = _double_conv(ctx, f"dc{i}", cur, qp[f"dc{i}"])
        enc.append(cur)
        cur = _maxpool(cur)
    cur = _double_conv(ctx, "dc4", cur, qp["dc4"])
    for i in range(4):
        up = ctx.site(f"up{i}.out", _conv(ctx, cur, qp[f"up{i}"], lhs_dilation=(2, 2),
                                          padding=((1, 1), (1, 1))))
        skip = enc[3 - i]
        if _split_cat(ctx, up, skip):
            cur = _double_conv(ctx, f"dc{5 + i}", None, qp[f"dc{5 + i}"], pair=(up, skip))
        else:
            cat = ctx.site(f"cat{i}", torch.cat([up.f(ctx.dtype), skip.f(ctx.dtype)], dim=-1))
            cur = _double_conv(ctx, f"dc{5 + i}", cat, qp[f"dc{5 + i}"])
    return _conv(ctx, cur, qp["head"]).float()


def _forward(qp, scales, x, collect=None, dtype=torch.bfloat16, policy=None, steps=None):
    """The Robust U-Net on folded params (scales=None: the float mode)."""
    ctx = _Ctx(scales, collect, dtype, policy, steps)
    cur = ctx.site("input", x.float())
    enc = []
    for i in range(4):
        cur = _residual_block(ctx, f"rb{i}", cur, qp[f"rb{i}"])
        enc.append(cur)
        cur = _maxpool(cur)

    # bottleneck: the four-branch dilated block -> BN (folded) -> ReLU -> rb4
    db = qp["db"]
    branches = [_conv(ctx, cur, db["b0"]),
                _conv(ctx, cur, db["b1"], padding=1, dilation=1),
                _conv(ctx, cur, db["b2"], padding=2, dilation=2),
                _conv(ctx, cur, db["b3"], padding=4, dilation=4)]
    cur = ctx.site("db.out", torch.relu(torch.cat(branches, dim=-1)))
    cur = _residual_block(ctx, "rb4", cur, qp["rb4"])

    for i in range(4):
        up = ctx.site(f"up{i}.out", _conv(ctx, cur, qp[f"up{i}"], lhs_dilation=(2, 2),
                                          padding=((1, 1), (1, 1))))
        skip = _attention_gate(ctx, f"ag{i}", up, enc[3 - i], qp[f"ag{i}"])
        if _split_cat(ctx, skip, up):
            cur = _residual_block(ctx, f"rb{5 + i}", None, qp[f"rb{5 + i}"], pair=(skip, up))
        else:
            cat = ctx.site(f"cat{i}", torch.cat([skip.f(ctx.dtype), up.f(ctx.dtype)], dim=-1))
            cur = _residual_block(ctx, f"rb{5 + i}", cat, qp[f"rb{5 + i}"])
    return _conv(ctx, cur, qp["head"]).float()


def _forward_segnet(qp, scales, x, collect=None, dtype=torch.bfloat16, policy=None,
                    steps=None):
    """SegNet on folded params. The indexed pool and unpool run directly on
    the int8 codes (placing codes and zero-filling commute with the dequant:
    0 dequantizes to 0.0 under symmetric quantization)."""
    ctx = _Ctx(scales, collect, dtype, policy, steps)
    cur = ctx.site("input", x.float())
    k = 0

    def convs(cur, n):
        nonlocal k
        for _ in range(n):
            cur = ctx.site(f"c{k}", torch.relu(_conv(ctx, cur, qp[f"c{k}"], padding=1)))
            k += 1
        return cur

    idx = []
    for n in (2, 2, 3, 3):
        cur = convs(cur, n)
        vals, codes = unpool.max_pool_with_indices(cur.q.contiguous())
        idx.append(codes)
        cur = _QT(vals, cur.step)
    for n, codes in zip((3, 3, 2), (idx[3], idx[2], idx[1])):
        cur = convs(_QT(unpool.max_unpool(cur.q, codes), cur.step), n)
    cur = convs(_QT(unpool.max_unpool(cur.q, idx[0]), cur.step), 1)
    return _conv(ctx, cur, qp["head"], padding=1).float()


# arch -> (fold, forward, sigmoid head?)
ARCHS = {
    "robust_unet": (fold_robust_unet, _forward, True),
    "unet": (fold_unet, _forward_unet, False),
    "segnet": (fold_segnet, _forward_segnet, True),
}


def default_calibration(image_size: int, images_u8=None, n_scenes: int = 4, device="cuda"):
    """The one calibration batch every entry point shares: uint8 (N, S, S, 3)
    images (given, or `n_scenes` synthetic coastal scenes from
    `default_rng(0)`, the JAX package's) -> /255 -> ImageNet-normalized
    float32 on `device`."""
    from coastline_torch.data.pipeline import normalize_u8

    device = resolve_device(device)
    if images_u8 is None:
        from coastline_torch.data.synthetic import make_scene

        rng = np.random.default_rng(0)
        images_u8 = np.stack([make_scene(rng, image_size)[0] for _ in range(n_scenes)])
    x = torch.as_tensor(np.ascontiguousarray(images_u8), dtype=torch.uint8)
    return normalize_u8(x.to(device))


def quant_arch_for(name) -> Optional[str]:
    """Any model-registry name or alias -> its `ARCHS` key, or None for a
    model whose int8 fold is not ported."""
    from coastline_torch.models.registry import canonical_name

    canon = canonical_name(name)
    for key in ARCHS:
        if key == name or canonical_name(key) == canon:
            return key
    return None


def _input(x, device=None):
    x = torch.as_tensor(x, dtype=torch.float32)
    return x.to(device) if device is not None else x


def float_forward(folded, x, return_logits: bool = False, dtype=torch.bfloat16,
                  arch: str = "robust_unet"):
    """The float forward on BN-folded params, on `x`'s device; it must match
    the model's eval forward (at float32 within float32 rounding)."""
    _, fwd, sig = ARCHS[arch]
    x = _input(x)
    with torch.inference_mode():
        logits = fwd(to_device(folded, x.device), None, x, dtype=dtype)
    return torch.sigmoid(logits) if sig and not return_logits else logits


def int8_forward(qparams, scales, x, return_logits: bool = False, arch: str = "robust_unet",
                 policy: Optional[Dict] = None, steps=None):
    """The int8-activation forward (bf16 float path) on `x`'s device;
    `scales` maps site name -> absmax; `steps` is a cache of the sites'
    device steps that a caller keeps across calls (`QuantizedModel`)."""
    _, fwd, sig = ARCHS[arch]
    x = _input(x)
    with torch.inference_mode():
        logits = fwd(to_device(qparams, x.device, policy), scales, x, policy=policy, steps=steps)
    return torch.sigmoid(logits) if sig and not return_logits else logits


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def calibration_sites(folded, example, arch: str = "robust_unet"):
    """The sorted site names of the float forward, from one run on `example`
    (on its device)."""
    collect: Dict[str, torch.Tensor] = {}
    x = _input(example)
    with torch.inference_mode():
        ARCHS[arch][1](to_device(folded, x.device), None, x, collect)
    return sorted(collect)


def calibrate(folded, images, batch_size: int = 2, arch: str = "robust_unet") -> Dict[str, float]:
    """Run the bf16 float forward over normalized (N, H, W, 3)
    float32 `images` on their device and return absmax per site; the last
    chunk is padded by repetition to keep the batch shape, and a zero absmax
    becomes 1.0."""
    fwd = ARCHS[arch][1]
    images = _input(images)
    params = to_device(folded, images.device)
    out: Dict[str, float] = {}
    n = images.shape[0]
    for i in range(0, n, batch_size):
        chunk = images[i:i + batch_size]
        if chunk.shape[0] != batch_size:
            reps = -(-batch_size // chunk.shape[0])
            chunk = torch.cat([chunk] * reps)[:batch_size]
        collect: Dict[str, torch.Tensor] = {}
        with torch.inference_mode():
            fwd(params, None, chunk, collect)
        values = torch.stack(list(collect.values())).cpu().tolist()
        for k, v in zip(collect, values):
            out[k] = max(out.get(k, 0.0), float(v))
    return {k: (v if v > 0 else 1.0) for k, v in out.items()}


# ---------------------------------------------------------------------------
# High-level wrapper
# ---------------------------------------------------------------------------


class QuantizedModel:
    """A PTQ int8 model on one device: built once, then called.

    `qparams` is the quantized tree of numpy arrays (what `deploy.py`
    saves); the constructor moves it to the device and packs every int8
    conv's weights into the kernel's layout once (the JAX package measured
    a 5.8x loss from re-uploading the tree per call), and keeps each site's
    step as a device tensor after the first call.

    >>> q = QuantizedModel.from_state_dict(model.state_dict(), calib, arch="unet")
    >>> logits = q(x)   # (N, H, W, 3) normalized float32 -> NHWC
    """

    def __init__(self, qparams, scales, arch: str = "robust_unet",
                 policy: Optional[Dict] = None, device="cuda"):
        if arch not in ARCHS:
            raise ValueError(f"{arch!r} has no int8 forward in the port yet; ported: "
                             f"{sorted(ARCHS)}")
        self.device = resolve_device(device)
        self.qparams = qparams
        self.scales = scales
        self.arch = arch
        self.policy = policy
        self.params = to_device(qparams, self.device, policy)
        self._steps: Dict = {}

    @classmethod
    def from_state_dict(cls, sd, calib_images, batch_size: int = 2, arch: str = "robust_unet",
                        policy: Optional[Dict] = None, device="cuda"):
        """Fold `sd` (the model's state_dict), calibrate on `calib_images`
        (normalized float32 NHWC, moved to the device) and quantize."""
        dev = resolve_device(device)
        folded = ARCHS[arch][0](sd)
        scales = calibrate(folded, _input(calib_images, dev), batch_size, arch=arch)
        return cls(quantize_folded(folded), scales, arch, policy, dev)

    def __call__(self, x, return_logits: bool = False):
        """(N, H, W, 3) normalized float32 -> the arch's output, NHWC float32
        on the model's device (probabilities for a sigmoid head, else logits)."""
        return int8_forward(self.params, self.scales, _input(x, self.device), return_logits,
                            arch=self.arch, policy=self.policy, steps=self._steps)


class QuantizedRobustUNet(QuantizedModel):
    """The flagship's alias."""

    @classmethod
    def from_state_dict(cls, sd, calib_images, batch_size: int = 2, device="cuda"):
        return QuantizedModel.from_state_dict(sd, calib_images, batch_size,
                                              arch="robust_unet", device=device)
