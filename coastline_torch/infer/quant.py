"""Int8 post-training quantization of all twelve architectures of the zoo:
the UNet, the Robust U-Net, SegNet, WaterNet, MSWNet, HRNet-Water, PSPNet,
DeepLabV3+, YOLO-SEG, Fast-SCNN, ENet and SegFormer-Lite (counterpart of
`coastline/infer/quant.py`).

  * Eval only. Every BatchNorm folds into its conv (weights and bias in
    float32) before quantization; a transposed conv keeps its bias and
    takes the BN that follows it where there is one (the decoders of
    DeepLabV3+, YOLO-SEG and ENet); ENet's initial BN keeps its pool slice
    as an explicit affine. The folds read the port's `state_dict`
    (reference names) and give the JAX package's folded tree: the same keys
    (`dc0/c1`, `rb3/short`, `db/b2`, `ag1/psi`, `ms2/b3`, `aspp_fuse`,
    `ds4/pw`, `bn7/mid2`, `esa1/sr`, `up2`, `head`, ...), HWIO weights,
    float32, bit for bit (`fold_*`).
  * Weights: symmetric per-output-channel int8, step = absmax / 127.
  * Activations: symmetric per-tensor int8 at named sites (conv inputs and
    the tensors the CBAM and gate epilogues read again), scaled by the
    absmax a calibration pass records at each site.
  * One forward per architecture serves both modes: the float mode
    (`scales=None`, the calibration recorder and the correctness anchor) and
    the int8 mode, in which a conv whose input is int8 and whose channel
    counts are both >= `conv_min_ch` runs as an int8 x int8 -> int32
    implicit GEMM with the dequantizing epilogue fused
    (`kernels/int8_conv.py`, the CUDA kernel on the card: stride 1, 2 or 4,
    the 2x2, 3x3 and 4x4 transposed convs); a smaller or grouped conv (the
    RGB stems, the gates' psi and spatial-attention convs, MSWNet's first
    two blocks, HRNet-Water's narrow branch, the depthwise 3x3s, ENet's
    bottlenecks, SegFormer-Lite's first stage, the heads) dequantizes its
    int8 input and runs in the compute dtype.
  * Where one such int8 conv feeds a site (`_Ctx.conv_site`: the double
    convs, the up-convs, the strided stems, the fusion convs, the residual
    blocks' shortcut, t1 and mid, YOLO-SEG's leaky convs, Fast-SCNN's
    pointwise 1x1s, SegFormer-Lite's spatial reductions and Mix-FFN inputs),
    the kernel's epilogue also applies the ReLU or leaky ReLU and quantizes
    to the site's codes, so on the card the site's float tensor is never
    written; the codes are those `_Ctx.site` would give, bit for bit. The
    sites after a concat, a resize, a pool, a residual add or a GELU stay
    eager.
  * The activations follow JAX's arithmetic in the compute dtype, each op
    rounded: `_sigmoid`, `_gelu` and the leaky ReLU of the int8 conv's
    epilogue (`kernels/int8_conv.py::leaky_relu`, the float path's too).

Everything is a function on tensors in the JAX package's NHWC layout; the
float convs hand cuDNN the NCHW views of the same (channels_last) memory.
SegNet's indexed pool and unpool run on the int8 codes through the kernels
of `kernels/unpool.py`; the other max pools run on the codes too
(`_maxpool`). `ARCHS` holds the twelve architectures, the JAX package's
keys; `quant_arch_for` maps any registry name or alias onto them.
"""

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from coastline_torch.kernels import unpool
from coastline_torch.ops.primitives import adaptive_avg_pool, bilinear_resize
from coastline_torch.parallel import collectives
from coastline_torch.kernels.int8_conv import (PackedWeights, activation, int8_conv,
                                               normalize_padding, packed, quantize_codes)
from coastline_torch.utils.device import resolve_device
from coastline_torch.utils.torch_import import (ENET_BOTTLENECKS, FASTSCNN_DSCONVS,
                                                ROBUST_BLOCKS, ROBUST_GATES, ROBUST_UPCONVS,
                                                SEGNET_STAGES, UNET_BLOCKS, UNET_UPCONVS,
                                                YOLO_BACKBONE_CONVS)

#: Entries whose float32 `w` an arch's forward reads whatever the policy
#: (not through `_conv`): DeepLabV3+'s global ASPP branch is a matmul of the
#: pooled codes with it. `to_device` keeps their `w` on the device and a slim
#: artifact keeps it on disk (the JAX package's `deploy._SLIM_KEEP`).
SLIM_KEEP = {"deeplabv3p": {"aspp_b4"}}

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


def _fold_t(sd, conv, bn):
    """A transposed conv with the BN that follows it folded in (the JAX
    kernel layout, flipped): DeepLabV3+'s decoder stages."""
    w, b = _conv_t(sd, conv)
    inv, shift = _bn_affine(sd, bn)
    return w * inv[None, None, None, :], b * inv + shift


def fold_deeplabv3p(sd) -> Dict:
    """Fold the BNs of DeepLabV3+ (`models/deeplabv3p.py`): the four backbone
    ConvBNActs (c0..c3; conv2 leads with its max pool), the ASPP's five
    branches with their biases and no BN (aspp_b0..b4), its fusion conv
    with `aspp.bn` (aspp_fuse), the four transposed convs with the BNs after
    them (up0..up3), the 3x3 head."""
    out: Dict = {f"c{i}": _fold(sd, f"conv{i + 1}.{j}", f"conv{i + 1}.{j + 1}")
                 for i, j in enumerate((0, 1, 0, 0))}
    for k in range(5):
        out[f"aspp_b{k}"] = _fold(sd, f"aspp.conv{k + 1}")
    out["aspp_fuse"] = _fold(sd, "aspp.conv_out", "aspp.bn")
    for i in range(4):
        out[f"up{i}"] = _fold_t(sd, f"decoder.{3 * i}", f"decoder.{3 * i + 1}")
    out["head"] = _fold(sd, "decoder.12")
    return out


def _double_folds(sd, prefixes, first: int, out: Dict):
    """The two ConvBNActs of each Sequential in `prefixes` as c{first}, ..."""
    for i, prefix in enumerate(prefixes):
        for j in range(2):
            out[f"c{first + 2 * i + j}"] = _fold(sd, f"{prefix}.{3 * j}", f"{prefix}.{3 * j + 1}")


def fold_waternet(sd) -> Dict:
    """Fold the BNs of WaterNet (`models/waternet.py`): the water-index head
    (wim1 with its BN, wim2), the 14 double-conv ConvBNActs in call order
    (c0..c7 the encoder and bottleneck, c8..c13 the decoder), the
    bottleneck's channel-gate MLP (`ca`, the Dense layout), the three
    transposed convs, the 1x1 head."""
    out: Dict = {"wim1": _fold(sd, "water_index.index_conv.0", "water_index.index_conv.1"),
                 "wim2": _fold(sd, "water_index.index_conv.3"),
                 "ca": {f"fc{k}": np.ascontiguousarray(
                     _arr(sd, f"water_attention.fc.{2 * k - 2}.weight")[:, :, 0, 0].T)
                     for k in (1, 2)}}
    _double_folds(sd, ("enc1", "enc2", "enc3", "bottleneck", "dec3", "dec2", "dec1"), 0, out)
    for i, level in enumerate((3, 2, 1)):
        out[f"up{i}"] = _conv_t(sd, f"up{level}")
    out["head"] = _fold(sd, "outc.0")
    return out


def fold_pspnet(sd) -> Dict:
    """Fold the BNs of PSPNet (`models/pspnet.py`): the four strided stem
    ConvBNActs (c0..c3), the pyramid's four branch convs (ppm0..ppm3), the
    fusion ConvBNAct (c4), the 1x1 head."""
    out: Dict = {f"c{i}": _fold(sd, f"conv{i + 1}.0", f"conv{i + 1}.1") for i in range(4)}
    out["c4"] = _fold(sd, "final_conv.0", "final_conv.1")
    for k in range(4):
        out[f"ppm{k}"] = _fold(sd, f"ppm.convs.{k}.1", f"ppm.convs.{k}.2")
    out["head"] = _fold(sd, "final_conv.4")
    return out


def fold_mswnet(sd) -> Dict:
    """Fold the BNs of MSWNet (`models/mswnet.py`): each encoder block's four
    branches (ms{i}/b0..b3; branch 4 leads with its max pool), the two
    bridge convs and the four decoder convs (c0..c5), the four transposed
    convs, the 1x1 head."""
    out: Dict = {}
    for i in range(4):
        out[f"ms{i}"] = {f"b{k}": _fold(sd, f"enc{i + 1}.branch{k + 1}.{j}",
                                        f"enc{i + 1}.branch{k + 1}.{j + 1}")
                         for k, j in enumerate((0, 0, 0, 1))}
    _double_folds(sd, ("bridge",), 0, out)
    for t, level in enumerate((4, 3, 2, 1)):
        out[f"c{t + 2}"] = _fold(sd, f"dec{level}.0", f"dec{level}.1")
        out[f"up{t}"] = _conv_t(sd, f"up{level}")
    out["head"] = _fold(sd, "outc.0")
    return out


def fold_hrnet_water(sd) -> Dict:
    """Fold the BNs of HRNet-Water (`models/hrnet_water.py`): the stem and
    the three branches, two ConvBNActs each (c0..c7), the head's ConvBNAct
    (c8), the two 1x1 projections with their BNs, the 1x1 head."""
    out: Dict = {}
    _double_folds(sd, ("stem", "hr_branch", "mr_branch", "lr_branch"), 0, out)
    out["c8"] = _fold(sd, "head.0", "head.1")
    out["mr_proj"] = _fold(sd, "mr_to_hr.0", "mr_to_hr.1")
    out["lr_proj"] = _fold(sd, "lr_to_hr.0", "lr_to_hr.1")
    out["head"] = _fold(sd, "head.4")
    return out


def fold_yoloseg(sd) -> Dict:
    """Fold the BNs of YOLO-SEG (`models/yoloseg.py`): the eight backbone
    ConvBNActs (c0..c7, LeakyReLU 0.1 in the forward), the head's four
    transposed convs with the BNs after them (up0..up3), the 3x3 head."""
    out: Dict = {f"c{i}": _fold(sd, f"backbone.{ci}", f"backbone.{ci + 1}")
                 for i, ci in enumerate(YOLO_BACKBONE_CONVS)}
    for i in range(4):
        out[f"up{i}"] = _fold_t(sd, f"seg_head.{3 * i}", f"seg_head.{3 * i + 1}")
    out["head"] = _fold(sd, "seg_head.12")
    return out


def fold_fastscnn(sd) -> Dict:
    """Fold the BNs of Fast-SCNN (`models/fastscnn.py`): the stem ConvBNAct
    (c0), the 13 depthwise-separable convs in call order (ds0..ds12: the BN
    folds into the pointwise 1x1, `pw`; the depthwise 3x3 `dw` keeps its
    weights and a zero bias), the pyramid's four branch convs, the two
    fusion projections with their BNs, the 1x1 head."""
    out: Dict = {"c0": _fold(sd, "learning_to_downsample.conv1.0",
                             "learning_to_downsample.conv1.1")}
    for i, prefix in enumerate(FASTSCNN_DSCONVS):
        wdw = _hwio(_arr(sd, f"{prefix}.depthwise.weight"))
        out[f"ds{i}"] = {"dw": (wdw, np.zeros(wdw.shape[-1], np.float32)),
                         "pw": _fold(sd, f"{prefix}.pointwise", f"{prefix}.bn")}
    for k in range(4):
        out[f"ppm{k}"] = _fold(sd, f"global_feature_extractor.ppm.convs.{k}.1",
                               f"global_feature_extractor.ppm.convs.{k}.2")
    out["low_proj"] = _fold(sd, "feature_fusion.conv_low.0", "feature_fusion.conv_low.1")
    out["high_proj"] = _fold(sd, "feature_fusion.conv_high.0", "feature_fusion.conv_high.1")
    out["head"] = _fold(sd, "classifier.conv3")
    return out


#: ENet's bottlenecks in call order (`models/enet.py`; the JAX package's
#: `_ENET_SPECS`): (kind, dilation), beside `ENET_BOTTLENECKS`' module names
_ENET_SPECS = (
    ("down", 1), ("reg", 1), ("reg", 1), ("reg", 1),       # encoder1, 64 channels
    ("down", 1), ("reg", 1), ("reg", 2), ("asym", 1),      # encoder2, 128 channels
    ("reg", 4), ("reg", 1), ("reg", 8), ("asym", 1), ("reg", 16),
)


def fold_enet(sd) -> Dict:
    """Fold the BNs of ENet (`models/enet.py`): the initial block's BN spans
    the concat of the conv (13 channels) and the max pool (3): its conv
    slice folds into the conv, its pool slice stays an explicit (pool_inv,
    pool_shift) affine; each bottleneck by its kind (`_ENET_SPECS`: reduce,
    the downsampling ones' pooled projection, mid1 (and the asymmetric
    ones' mid2), expand); the two decoder transposed convs with the BNs
    after them (up0, up1); the final 2x2 transposed conv with its bias."""
    inv, shift = _bn_affine(sd, "initial.bn")
    ncv = sd["initial.conv.weight"].shape[0]
    out: Dict = {"init": {"conv": _fold(sd, "initial.conv", inv=inv[:ncv], shift=shift[:ncv]),
                          "pool_inv": inv[ncv:], "pool_shift": shift[ncv:]}}
    for i, ((prefix, _, _), (kind, _)) in enumerate(zip(ENET_BOTTLENECKS, _ENET_SPECS)):
        entry = {"reduce": _fold(sd, f"{prefix}.conv1.0", f"{prefix}.conv1.1")}
        if kind == "down":
            entry["proj"] = _fold(sd, f"{prefix}.conv_down.0", f"{prefix}.conv_down.1")
        entry["mid1"] = _fold(sd, f"{prefix}.conv2.0", f"{prefix}.conv2.1")
        if kind == "asym":
            entry["mid2"] = _fold(sd, f"{prefix}.conv2.3", f"{prefix}.conv2.4")
        entry["expand"] = _fold(sd, f"{prefix}.conv3.0", f"{prefix}.conv3.1")
        out[f"bn{i}"] = entry
    for i in range(2):
        out[f"up{i}"] = _fold_t(sd, f"decoder.{3 * i}", f"decoder.{3 * i + 1}")
    out["head"] = _conv_t(sd, "decoder.6")
    return out


def fold_segformer_lite(sd) -> Dict:
    """Fold the BNs of SegFormer-Lite (`models/segformer_lite.py`): the four
    patch-embed ConvBNActs (c0..c3; the GELU stays in the forward), the
    fusion and head ConvBNActs (c4, c5); the attention (q, sr, kv, proj)
    and Mix-FFN (c1, dw, c2) convs of the first three stages and the four
    decoder projections (f4..f1) keep their biases, no BN; the 1x1 head."""
    out: Dict = {f"c{i}": _fold(sd, f"patch_embed{i + 1}.0", f"patch_embed{i + 1}.1")
                 for i in range(4)}
    out["c4"] = _fold(sd, "linear_fuse.0", "linear_fuse.1")
    out["c5"] = _fold(sd, "head.0", "head.1")
    for i in range(3):
        out[f"esa{i}"] = {k: _fold(sd, f"attn{i + 1}.{name}")
                          for k, name in (("q", "q"), ("sr", "reduction"), ("kv", "kv"),
                                          ("proj", "proj"))}
        out[f"ffn{i}"] = {k: _fold(sd, f"ffn{i + 1}.{name}")
                          for k, name in (("c1", "fc1"), ("dw", "dwconv"), ("c2", "fc2"))}
    for level in (4, 3, 2, 1):
        out[f"f{level}"] = _fold(sd, f"linear_c{level}")
    out["head"] = _fold(sd, "head.3")
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


def to_device(tree, device, policy: Optional[Dict] = None,
              arch: Optional[str] = None) -> DeviceTree:
    """Move a tree of numpy arrays to `device` once: every array becomes a
    tensor, a folded (w, b) entry a tuple of tensors, and a quantized entry
    a dict whose `wq` is `PackedWeights`. A conv the policy runs on the int8
    path (`int8_eligible`; a transposed conv is an `up*` entry, as in the
    JAX package's forwards) gets the kernel's layout here and leaves its
    float32 `w`, which that path never reads, on the host, unless `arch`'s
    forward reads it elsewhere (`SLIM_KEEP`). Under the `split_cat` policy
    each conv `_conv_cat` splits gets its two halves packed here too, as
    `_split` {c0: (first, second)} (`split_cat_entries`)."""
    if isinstance(tree, DeviceTree):
        return tree
    device = torch.device(device)
    pol = dict(DEFAULT_POLICY, **(policy or {}))
    keep = SLIM_KEEP.get(arch, set())

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
                out = {k: t(a) for k, a in v.items()
                       if k != "wq" and (k != "w" or key in keep)}
                out["wq"] = packed(wq, transposed)
            else:
                out = {k: t(a) for k, a in v.items() if k != "wq"}
                out["wq"] = PackedWeights(wq, None, transposed)
            return out
        if isinstance(v, dict):
            return {k: entry(k, a) for k, a in v.items()}
        return t(v)

    out = DeviceTree({k: entry(k, v) for k, v in tree.items()})
    if pol["split_cat"]:
        for e, c0 in split_cat_entries(out, arch):
            if split_eligible(e["wq"], c0, pol):
                hwio = e["wq"].hwio
                e["_split"] = {c0: (packed(hwio[:, :, :c0].contiguous()),
                                    packed(hwio[:, :, c0:].contiguous()))}
    return out


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
            step = self.step_of(name)
            self.steps[key] = (step, torch.tensor(step, dtype=torch.float32, device=t.device))
        step, step_t = self.steps[key]
        return _QT(quantize_codes(t, step_t), step)

    def conv_site(self, name: str, x: "_QT", entry, act: str = "none", padding=0,
                  dilation=1, lhs_dilation=None, stride: int = 1) -> "_QT":
        """`site(name, act(_conv(x, entry, ...)))` with the activation and the
        quantization in the conv's epilogue where the int8 path applies
        (`_int8_path`; `act` "none", "relu" or "leaky"): on the
        card one `int8_conv` launch in codes mode, whose codes go through
        `fused_codes`; on the CPU the kernel's plain version in values mode,
        then `site`, so a site sees its own float input there."""
        if not _int8_path(self, x, entry):
            return self.site(name, _conv(self, x, entry, padding, dilation, lhs_dilation,
                                         stride, act))
        args = (x.q.contiguous(), entry["wq"], x.step, entry["wstep"], entry["b"],
                normalize_padding(padding), dilation, lhs_dilation, self.dtype, act)
        if not _codes_in_kernel(x.q):
            return self.fused_codes(name, self.site(name, int8_conv(*args, stride=stride)))
        step = self.step_of(name)
        return self.fused_codes(name, _QT(int8_conv(*args, out_step=step, stride=stride), step))

    def step_of(self, name: str) -> float:
        """Site `name`'s step, float32(scale / 127), as a float."""
        return float(np.float32(self.scales[name] / 127.0))

    def fused_codes(self, name: str, codes: "_QT") -> "_QT":
        """The codes of site `name` as `conv_site` made them; a hook for
        checks that watch every site."""
        return codes


def _sigmoid(t):
    """`jax.nn.sigmoid`'s arithmetic: in bfloat16 XLA expands it to 1 / (1 +
    exp(-x)) with every op rounded to bfloat16 (torch.sigmoid rounds once,
    one ulp off for a third of the values); in float32 torch.sigmoid."""
    if t.dtype == torch.bfloat16:
        return 1 / (1 + torch.exp(-t))
    return torch.sigmoid(t)


def _gelu(t):
    """`jax.nn.gelu(t, approximate=False)`'s arithmetic, 0.5 * t * erfc(-t *
    sqrt(0.5)) op by op in t's dtype: sqrt(0.5) rounded to the dtype, each
    product rounded, erfc in float32 (XLA upcasts a bf16 erfc) rounded back.
    In bf16 bit-equal to JAX but at subnormal outputs; `F.gelu` rounds once
    (41% of bf16 values differ). In float32 torch's erfc is not XLA's
    polynomial: a few ulps apart."""
    sqrt_half = float(torch.tensor(0.5 ** 0.5, dtype=torch.float32).to(t.dtype))
    erfc = torch.special.erfc((-t * sqrt_half).float()).to(t.dtype)
    return t * 0.5 * erfc


def _float_conv(x, w, b, pads, dilation, lhs_dilation, dtype, stride: int = 1,
                groups: int = 1):
    """The float path: `x` NHWC in `dtype`, `w` HWIO (C_in / groups inputs)
    -> NHWC + bias, in dtype. A transposed conv (lhs dilation 2, a k x k
    kernel, padding (lo, hi) on each axis, lo <= k - 1, hi - lo 0 or 1: the
    2x2 ones at (1, 1), the 4x4 at (2, 2), ENet's 3x3 at (1, 2)) is torch's
    stride-2 transposed conv, padding k - 1 - lo, output padding hi - lo,
    with the stored (flipped) kernel flipped back."""
    wt = w.to(dtype)
    xc = x.permute(0, 3, 1, 2)
    if lhs_dilation is not None:
        k = wt.shape[0]
        (lo, hi), (lo_x, hi_x) = pads
        if (tuple(lhs_dilation) != (2, 2) or wt.shape[1] != k or (lo, hi) != (lo_x, hi_x)
                or not 0 <= k - 1 - lo or hi - lo not in (0, 1) or stride != 1
                or dilation != 1 or groups != 1):
            raise ValueError(f"unsupported transposed conv: lhs_dilation {lhs_dilation}, "
                             f"kernel {tuple(wt.shape[:2])}, padding {pads}, stride {stride}")
        y = F.conv_transpose2d(xc, wt.flip(0, 1).permute(2, 3, 0, 1), stride=2,
                               padding=k - 1 - lo, output_padding=hi - lo)
    else:
        (pt, pb), (pl, pr) = pads
        if pt != pb or pl != pr:
            xc, pt, pl = F.pad(xc, (pl, pr, pt, pb)), 0, 0
        y = F.conv2d(xc, wt.permute(3, 2, 0, 1), stride=stride, padding=(pt, pl),
                     dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 1) + b.to(dtype)


def _codes_in_kernel(t: torch.Tensor) -> bool:
    """Whether `conv_site` takes a site's codes from the conv's epilogue:
    for tensors on the card. On the CPU the kernel's plain values go through
    `_Ctx.site`, the same arithmetic."""
    return t.device.type == "cuda"


def _int8_path(ctx: _Ctx, x: _QT, entry) -> bool:
    """Whether a conv runs on the int8 path: the context quantizes, the
    input is int8 and the policy sends the conv there (`int8_eligible`)."""
    if not (ctx.quant and x.step is not None and isinstance(entry, dict)):
        return False
    wq = entry["wq"]
    return int8_eligible(wq.hwio.shape[2], wq.hwio.shape[3], wq.transposed, ctx.policy)


def _conv(ctx: _Ctx, x: _QT, entry, padding=0, dilation=1, lhs_dilation=None,
          stride: int = 1, act: str = "none", groups: int = 1) -> torch.Tensor:
    """Conv on a site tensor -> NHWC in the compute dtype, bias added, then
    `act` ("none", "relu" or "leaky"; in the kernel's epilogue on the int8
    path, where `_int8_path` says so). A grouped conv (`groups` > 1: the
    depthwise 3x3s) always takes the float path, as in the JAX package."""
    pads = normalize_padding(padding)
    if isinstance(entry, dict):
        w, b, wq, wstep = entry.get("w"), entry["b"], entry["wq"], entry["wstep"]
        if groups == 1 and _int8_path(ctx, x, entry):
            return int8_conv(x.q.contiguous(), wq, x.step, wstep, b, pads, dilation,
                             lhs_dilation, out_dtype=ctx.dtype, act=act, stride=stride)
        if w is None:
            raise KeyError("a conv without float weights on the float path: an int8-path conv "
                           "leaves them on the host, and a slim artifact restores them only "
                           "through `load_quantized`")
    else:
        w, b = entry
    y = _float_conv(x.f(ctx.dtype), w, b, pads, dilation, lhs_dilation, ctx.dtype, stride,
                    groups)
    return activation(y, act)


def _conv_cat(ctx: _Ctx, a: _QT, b: _QT, entry, padding=0) -> torch.Tensor:
    """`conv(concat([a, b], -1), W)` without the concat on the int8 path: each
    operand's own codes convolve their half of W (two kernel launches in
    float32, bias 0) and the halves are summed with the bias in the JAX
    package's order. Otherwise the concat in the compute dtype and `_conv`."""
    c0 = a.q.shape[-1]
    use_int8 = (ctx.quant and a.step is not None and b.step is not None
                and isinstance(entry, dict) and split_eligible(entry["wq"], c0, ctx.policy))
    if not use_int8:
        xcat = _QT(torch.cat([a.f(ctx.dtype), b.f(ctx.dtype)], dim=-1))
        return _conv(ctx, xcat, entry, padding=padding)
    first, second = entry["_split"][c0]  # packed once, by `to_device`
    bias, wstep = entry["b"], entry["wstep"]
    zero = torch.zeros_like(bias)
    y1 = int8_conv(a.q.contiguous(), first, a.step, wstep, zero, padding)
    y2 = int8_conv(b.q.contiguous(), second, b.step, wstep, zero, padding)
    return (y1 + y2 + bias).to(ctx.dtype)


def split_eligible(wq: PackedWeights, c0: int, policy: Dict) -> bool:
    """Whether `_conv_cat` splits a conv over concat([a, b]) whose first part
    has c0 channels: both halves go to the int8 path (`int8_eligible`)."""
    cin, cout = wq.hwio.shape[2], wq.hwio.shape[3]
    return int8_eligible(c0, cout, False, policy) and int8_eligible(cin - c0, cout, False, policy)


#: The decoders' split-cat convs (`_conv_cat`, under the `split_cat` policy):
#: arch -> (block prefix, the block's convs that read the concat, whether
#: up{i}'s output is the concat's first part). Block `{prefix}{5 + i}` reads
#: the concat of up{i}'s output and a skip (`_forward_unet`, `_forward`).
SPLIT_CATS = {"unet": ("dc", ("c1",), True), "robust_unet": ("rb", ("short", "c1"), False)}


def split_cat_entries(tree, arch: str):
    """[(entry, c0)] of every conv `_conv_cat` may split in `arch`'s forward,
    from a `to_device` tree: c0 is the channel count of the concat's first
    part, the one `_conv_cat` reads from its input."""
    if arch not in SPLIT_CATS:
        return []
    prefix, convs, up_first = SPLIT_CATS[arch]
    out = []
    for i in range(4):
        c_up = tree[f"up{i}"]["wq"].hwio.shape[3]
        for name in convs:
            entry = tree[f"{prefix}{5 + i}"][name]
            cin = entry["wq"].hwio.shape[2]
            out.append((entry, c_up if up_first else cin - c_up))
    return out


def _maxpool(x: _QT, window: int = 2, stride: int = 2, padding: int = 0) -> _QT:
    """A window x window max pool at `stride` directly on the codes (monotonic
    under dequant), as `lax.reduce_window`: `padding` on each side of H and
    W holds -128 for codes and -inf for a float tensor, never the maximum of
    a window that reaches the input (every window does)."""
    q = x.q
    if padding:
        fill = -128 if x.step is not None else float("-inf")
        q = F.pad(q, (0, 0, padding, padding, padding, padding), value=fill)
    return _QT(q.unfold(1, window, stride).unfold(2, window, stride).amax((-2, -1)), x.step)


def _residual_block(ctx: _Ctx, name: str, x: Optional[_QT], p, pair=None) -> _QT:
    """`pair=(a, b)`: the block's input is concat([a, b], -1), its two input
    convs through `_conv_cat` (the int8 split-cat path)."""
    dt = ctx.dtype
    if pair is not None:
        short = ctx.site(f"{name}.short", _conv_cat(ctx, *pair, p["short"]))
        t1 = ctx.site(f"{name}.t1", torch.relu(_conv_cat(ctx, *pair, p["c1"], padding=1)))
    else:
        short = ctx.conv_site(f"{name}.short", x, p["short"]) \
            if p["short"] is not None else x
        t1 = ctx.conv_site(f"{name}.t1", x, p["c1"], act="relu", padding=1)
    mid = ctx.conv_site(f"{name}.mid", t1, p["c2"], padding=1)

    gc = _channel_gate(mid, p["fc1"], p["fc2"], dt)  # (N, C)

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


def _channel_gate(x: _QT, fc1, fc2, dtype) -> torch.Tensor:
    """The CBAM channel gate of a site tensor, (N, C) in `dtype`: the mean
    (`_pooled_codes`) and max of the raw codes, the pooled vectors
    dequantized exactly (mean and max commute with the step), the shared
    MLP and the sigmoid in float32."""
    avg = _pooled_codes(x.q, x.step)
    mx = x.q.amax((1, 2)).float()
    if x.step is not None:
        mx = mx * x.step
    fc1, fc2 = fc1.float(), fc2.float()
    gate = torch.relu(avg @ fc1) @ fc2 + torch.relu(mx @ fc1) @ fc2
    return torch.sigmoid(gate).to(dtype)


def _pooled_codes(q: torch.Tensor, step: Optional[float]) -> torch.Tensor:
    """`jnp.mean(q, axis=(1, 2), dtype=float32)` of a site's codes (or float
    tensor), dequantized exactly: (N, C) float32. The division is by a
    float32 tensor, as XLA divides (a CUDA division by a host scalar
    multiplies by its reciprocal)."""
    count = torch.tensor(q.shape[1] * q.shape[2], dtype=torch.float32, device=q.device)
    avg = q.sum((1, 2), dtype=torch.float32) / count
    return avg if step is None else avg * step


def _attention_gate(ctx: _Ctx, name: str, g: _QT, x: _QT, p) -> _QT:
    g1 = _conv(ctx, g, p["g"])
    x1 = _conv(ctx, x, p["x"])
    psi = ctx.site(f"{name}.psi", torch.relu(g1 + x1))
    psi = _conv(ctx, psi, p["psi"])
    gate = torch.sigmoid(psi.float()).to(ctx.dtype)
    return ctx.site(f"{name}.out", x.f(ctx.dtype) * gate)


def _double_conv(ctx: _Ctx, name: str, x: Optional[_QT], p, pair=None) -> _QT:
    if pair is not None:
        t1 = ctx.site(f"{name}.t1", torch.relu(_conv_cat(ctx, *pair, p["c1"], padding=1)))
    else:
        t1 = ctx.conv_site(f"{name}.t1", x, p["c1"], act="relu", padding=1)
    return ctx.conv_site(f"{name}.out", t1, p["c2"], act="relu", padding=1)


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
        up = ctx.conv_site(f"up{i}.out", cur, qp[f"up{i}"], lhs_dilation=(2, 2),
                           padding=((1, 1), (1, 1)))
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
        up = ctx.conv_site(f"up{i}.out", cur, qp[f"up{i}"], lhs_dilation=(2, 2),
                           padding=((1, 1), (1, 1)))
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
            cur = ctx.conv_site(f"c{k}", cur, qp[f"c{k}"], act="relu", padding=1)
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


def _resize(t, size):
    """`bilinear_resize` of an NHWC tensor (on its NCHW view)."""
    return bilinear_resize(t.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)


def _forward_deeplabv3p(qp, scales, x, collect=None, dtype=torch.bfloat16, policy=None,
                        steps=None):
    """DeepLabV3+ on folded params: the strided stem (a 3x3/2 max pool on the
    codes), the ASPP (dilations 6, 12, 18; the global branch pools the codes
    and runs its 1x1 conv as a float32 matmul, broadcast back), four 4x4
    transposed convs with their BNs folded, each then ReLU'd."""
    ctx = _Ctx(scales, collect, dtype, policy, steps)
    cur = ctx.site("input", x.float())
    cur = ctx.conv_site("c0", cur, qp["c0"], act="relu", padding=3, stride=2)
    cur = _maxpool(cur, 3, 2, 1)
    cur = ctx.conv_site("c1", cur, qp["c1"], act="relu", padding=1)
    cur = ctx.conv_site("c2", cur, qp["c2"], act="relu", padding=1, stride=2)
    cur = ctx.conv_site("c3", cur, qp["c3"], act="relu", padding=1, stride=2)

    n, h, w, _ = cur.q.shape
    branches = [_conv(ctx, cur, qp["aspp_b0"])]
    branches += [_conv(ctx, cur, qp[f"aspp_b{k}"], padding=d, dilation=d)
                 for k, d in ((1, 6), (2, 12), (3, 18))]
    b4 = qp["aspp_b4"]
    wb5, bb5 = (b4["w"], b4["b"]) if isinstance(b4, dict) else b4
    v = _pooled_codes(cur.q, cur.step) @ wb5.float()[0, 0] + bb5
    branches.append(v[:, None, None, :].to(dtype).expand(n, h, w, v.shape[-1]))
    cat = ctx.site("aspp.cat", torch.cat(branches, dim=-1))
    cur = ctx.conv_site("aspp.out", cat, qp["aspp_fuse"], act="relu")
    for i in range(4):
        cur = ctx.conv_site(f"up{i}.out", cur, qp[f"up{i}"], act="relu", lhs_dilation=(2, 2),
                            padding=((2, 2), (2, 2)))
    return _conv(ctx, cur, qp["head"], padding=1).float()


def _forward_waternet(qp, scales, x, collect=None, dtype=torch.bfloat16, policy=None,
                      steps=None):
    """WaterNet on folded params: the water-index head's sigmoid maps
    concatenated to RGB (the 7-channel `in7` site), the double-conv U-Net,
    the bottleneck's CBAM channel gate pooling the codes (as the Robust
    U-Net's), concat skips [up, skip]."""
    ctx = _Ctx(scales, collect, dtype, policy, steps)
    xin = ctx.site("input", x.float())

    def double(name, cur: _QT, k: int) -> _QT:
        cur = ctx.conv_site(f"{name}.t1", cur, qp[f"c{k}"], act="relu", padding=1)
        return ctx.conv_site(f"{name}.out", cur, qp[f"c{k + 1}"], act="relu", padding=1)

    t = ctx.conv_site("wim.t", xin, qp["wim1"], act="relu")
    idx = torch.sigmoid(_conv(ctx, t, qp["wim2"]).float()).to(dtype)
    cur = ctx.site("in7", torch.cat([xin.f(dtype), idx], dim=-1))
    e1 = double("e1", cur, 0)
    e2 = double("e2", _maxpool(e1), 2)
    e3 = double("e3", _maxpool(e2), 4)
    b = double("b", _maxpool(e3), 6)

    gate = _channel_gate(b, qp["ca"]["fc1"], qp["ca"]["fc2"], dtype)
    cur = ctx.site("ca.out", b.f(dtype) * gate[:, None, None, :])

    for i, (skip, k) in enumerate(((e3, 8), (e2, 10), (e1, 12))):
        up = ctx.conv_site(f"up{i}.out", cur, qp[f"up{i}"], lhs_dilation=(2, 2),
                           padding=((1, 1), (1, 1)))
        cat = ctx.site(f"cat{i}", torch.cat([up.f(dtype), skip.f(dtype)], dim=-1))
        cur = double(f"d{3 - i}", cat, k)
    return _conv(ctx, cur, qp["head"]).float()


def _forward_pspnet(qp, scales, x, collect=None, dtype=torch.bfloat16, policy=None,
                    steps=None):
    """PSPNet on folded params: four 3x3/2 stem convs (/16), the pyramid's
    1x1 convs on the adaptive average pools (1, 2, 3, 6) of the map in the
    compute dtype (`ppm{k}.in` sites, int8 convs on 1^2 to 6^2 maps), the
    fusion conv, the 1x1 head and a float32 bilinear resize to the input."""
    ctx = _Ctx(scales, collect, dtype, policy, steps)
    h, w = x.shape[1], x.shape[2]
    cur = ctx.site("input", x.float())
    for i in range(4):
        cur = ctx.conv_site(f"c{i}", cur, qp[f"c{i}"], act="relu", padding=1, stride=2)

    size = (cur.q.shape[1], cur.q.shape[2])
    feat = cur.f(dtype)
    outs = [feat]
    for k, level in enumerate((1, 2, 3, 6)):
        pooled = adaptive_avg_pool(feat.permute(0, 3, 1, 2), level).permute(0, 2, 3, 1)
        p = ctx.site(f"ppm{k}.in", pooled)
        outs.append(_resize(_conv(ctx, p, qp[f"ppm{k}"], act="relu"), size))
    cat = ctx.site("ppm.cat", torch.cat(outs, dim=-1))
    cur = ctx.conv_site("c4", cat, qp["c4"], act="relu", padding=1)
    return _resize(_conv(ctx, cur, qp["head"]).float(), (h, w))


def _forward_mswnet(qp, scales, x, collect=None, dtype=torch.bfloat16, policy=None,
                    steps=None):
    """MSWNet on folded params: the multi-scale blocks' four branches read
    one int8 input (1x1, 3x3, 5x5, and a 3x3/1 max pool on the codes before
    a 1x1), each ReLU'd, concatenated at the `ms{i}.out` site; the bridge;
    transposed convs and one conv a decoder level on [up, skip]."""
    ctx = _Ctx(scales, collect, dtype, policy, steps)

    def block(name, inp: _QT, p) -> _QT:
        branches = [_conv(ctx, inp, p["b0"], act="relu"),
                    _conv(ctx, inp, p["b1"], padding=1, act="relu"),
                    _conv(ctx, inp, p["b2"], padding=2, act="relu"),
                    _conv(ctx, _maxpool(inp, 3, 1, 1), p["b3"], act="relu")]
        return ctx.site(f"{name}.out", torch.cat(branches, dim=-1))

    cur = ctx.site("input", x.float())
    enc = []
    for i in range(4):
        cur = block(f"ms{i}", cur if i == 0 else _maxpool(cur), qp[f"ms{i}"])
        enc.append(cur)
    cur = ctx.conv_site("c0", _maxpool(cur), qp["c0"], act="relu", padding=1)
    cur = ctx.conv_site("c1", cur, qp["c1"], act="relu", padding=1)
    for i in range(4):
        up = ctx.conv_site(f"up{i}.out", cur, qp[f"up{i}"], lhs_dilation=(2, 2),
                           padding=((1, 1), (1, 1)))
        cat = ctx.site(f"cat{i}", torch.cat([up.f(dtype), enc[3 - i].f(dtype)], dim=-1))
        cur = ctx.conv_site(f"c{2 + i}", cat, qp[f"c{2 + i}"], act="relu", padding=1)
    return _conv(ctx, cur, qp["head"]).float()


def _forward_hrnet_water(qp, scales, x, collect=None, dtype=torch.bfloat16, policy=None,
                         steps=None):
    """HRNet-Water on folded params: the /2 stem, three branches (/2, /4 and
    /8: stride-2 convs), the 1x1 projections of the two lower ones resized
    bilinearly to the high one and concatenated with it (the 144-channel
    `fused` site), the head conv, a 2x resize (`head.in`), the 1x1 head."""
    ctx = _Ctx(scales, collect, dtype, policy, steps)

    def cba(name, cur: _QT, k: int, stride: int = 1) -> _QT:
        return ctx.conv_site(name, cur, qp[f"c{k}"], act="relu", padding=1, stride=stride)

    cur = ctx.site("input", x.float())
    stem = cba("c1", cba("c0", cur, 0, 2), 1)
    hr = cba("c3", cba("c2", stem, 2), 3)
    mr = cba("c5", cba("c4", stem, 4, 2), 5)
    lr = cba("c7", cba("c6", mr, 6, 2), 7)

    size = (hr.q.shape[1], hr.q.shape[2])
    mr_up = _resize(_conv(ctx, mr, qp["mr_proj"]), size)
    lr_up = _resize(_conv(ctx, lr, qp["lr_proj"]), size)
    fused = ctx.site("fused", torch.cat([hr.f(dtype), mr_up, lr_up], dim=-1))
    h = cba("c8", fused, 8)
    h = ctx.site("head.in", _resize(h.f(dtype), (2 * size[0], 2 * size[1])))
    return _conv(ctx, h, qp["head"]).float()


def _forward_yoloseg(qp, scales, x, collect=None, dtype=torch.bfloat16, policy=None,
                     steps=None):
    """YOLO-SEG on folded params: LeakyReLU(0.1) after every conv (in the
    int8 conv's epilogue where it runs), four 2x2 max pools on the codes,
    four folded 4x4 transposed convs, the 3x3 head."""
    ctx = _Ctx(scales, collect, dtype, policy, steps)

    def cba(name, cur: _QT, k: int, padding: int) -> _QT:
        return ctx.conv_site(name, cur, qp[f"c{k}"], act="leaky", padding=padding)

    cur = ctx.site("input", x.float())
    cur = _maxpool(cba("c0", cur, 0, 1))
    cur = _maxpool(cba("c1", cur, 1, 1))
    cur = cba("c3", cba("c2", cur, 2, 1), 3, 0)
    cur = _maxpool(cba("c4", cur, 4, 1))
    cur = cba("c6", cba("c5", cur, 5, 1), 6, 0)
    cur = _maxpool(cba("c7", cur, 7, 1))
    for i in range(4):  # ConvTranspose k4 s2 p1: lhs dilated, padding k - 1 - p = 2
        cur = ctx.conv_site(f"up{i}.out", cur, qp[f"up{i}"], act="leaky", lhs_dilation=(2, 2),
                            padding=((2, 2), (2, 2)))
    return _conv(ctx, cur, qp["head"], padding=1).float()


def _forward_fastscnn(qp, scales, x, collect=None, dtype=torch.bfloat16, policy=None,
                      steps=None):
    """Fast-SCNN on folded params: the depthwise 3x3s grouped on the float
    path (dequantizing their int8 input), the pointwise 1x1s with the BN
    folded and the ReLU in the epilogue; the (1, 2, 3, 6) pyramid on the /32
    map; both fusion projections; a float32 bilinear resize of the logits."""
    ctx = _Ctx(scales, collect, dtype, policy, steps)
    h, w = x.shape[1], x.shape[2]

    def ds(name, cur: _QT, k: int, stride: int = 1) -> _QT:
        p = qp[f"ds{k}"]
        t = ctx.site(f"{name}.mid", _conv(ctx, cur, p["dw"], padding=1, stride=stride,
                                          groups=cur.q.shape[-1]))
        return ctx.conv_site(f"{name}.out", t, p["pw"], act="relu")

    cur = ctx.site("input", x.float())
    cur = ctx.conv_site("c0", cur, qp["c0"], act="relu", padding=1, stride=2)
    low = ds("ds1", ds("ds0", cur, 0, 2), 1, 2)
    g = low
    for k in (2, 3, 4):
        g = ds(f"ds{k}", g, k)
    g = ds("ds5", g, 5, 2)
    for k in (6, 7, 8, 9, 10):
        g = ds(f"ds{k}", g, k)

    size = (g.q.shape[1], g.q.shape[2])
    feat = g.f(dtype)
    outs = [feat]
    for k, level in enumerate((1, 2, 3, 6)):
        pooled = adaptive_avg_pool(feat.permute(0, 3, 1, 2), level).permute(0, 2, 3, 1)
        p = ctx.site(f"ppm{k}.in", pooled)
        outs.append(_resize(_conv(ctx, p, qp[f"ppm{k}"], act="relu"), size))
    g = ctx.site("ppm.cat", torch.cat(outs, dim=-1))

    lowp = _conv(ctx, low, qp["low_proj"])
    high = _resize(_conv(ctx, g, qp["high_proj"]), (low.q.shape[1], low.q.shape[2]))
    cur = ctx.site("fuse.out", torch.relu(lowp + high))
    cur = ds("ds12", ds("ds11", cur, 11), 12)
    return _resize(_conv(ctx, cur, qp["head"]).float(), (h, w))


def _forward_enet(qp, scales, x, collect=None, dtype=torch.bfloat16, policy=None,
                  steps=None):
    """ENet on folded params: the initial block (its conv slice folded, its
    pool slice the codes' 2x2 max pool through the BN affine in the compute
    dtype), the 13 bottlenecks of `_ENET_SPECS` (a downsampling one's
    identity the pooled codes' 1x1 projection), two folded 3x3 transposed
    convs with output padding (pads (1, 2)), the 2x2 transposed head."""
    ctx = _Ctx(scales, collect, dtype, policy, steps)

    def bottleneck(name, cur: _QT, spec, p) -> _QT:
        kind, dil = spec
        ident = _conv(ctx, _maxpool(cur), p["proj"]) if kind == "down" else cur.f(dtype)
        t = ctx.conv_site(f"{name}.r", cur, p["reduce"], act="relu",
                          stride=2 if kind == "down" else 1)
        if kind == "asym":
            t = ctx.conv_site(f"{name}.m1", t, p["mid1"], act="relu", padding=((2, 2), (0, 0)))
            t = ctx.conv_site(f"{name}.m2", t, p["mid2"], act="relu", padding=((0, 0), (2, 2)))
        else:
            t = ctx.conv_site(f"{name}.m1", t, p["mid1"], act="relu", padding=dil, dilation=dil)
        return ctx.site(f"{name}.out", torch.relu(_conv(ctx, t, p["expand"]) + ident))

    cur = ctx.site("input", x.float())
    init = qp["init"]
    conv_part = _conv(ctx, cur, init["conv"], padding=1, stride=2)
    pool_part = _maxpool(cur).f(dtype) * init["pool_inv"].to(dtype) + init["pool_shift"].to(dtype)
    cur = ctx.site("init.out", torch.relu(torch.cat([conv_part, pool_part], dim=-1)))
    for i, spec in enumerate(_ENET_SPECS):
        cur = bottleneck(f"bn{i}", cur, spec, qp[f"bn{i}"])
    for i in range(2):  # ConvTranspose k3 s2 p1 op1: padding (k - 1 - p, k - 1 - p + op)
        cur = ctx.conv_site(f"up{i}.out", cur, qp[f"up{i}"], act="relu", lhs_dilation=(2, 2),
                            padding=((1, 2), (1, 2)))
    return _conv(ctx, cur, qp["head"], lhs_dilation=(2, 2), padding=((1, 1), (1, 1))).float()


def _forward_segformer_lite(qp, scales, x, collect=None, dtype=torch.bfloat16, policy=None,
                            steps=None):
    """SegFormer-Lite on folded params (the logits upsampled, then the
    sigmoid): GELU patch embeds (`_gelu` after the conv in values mode),
    spatial-reduction attention whose two products run in the compute dtype
    (`torch.matmul`, as JAX's einsums outside any kernel) with the softmax
    in float32, Mix-FFNs with grouped depthwise 3x3s, the all-MLP decoder;
    the convs follow the int8 policy."""
    ctx = _Ctx(scales, collect, dtype, policy, steps)
    h, w = x.shape[1], x.shape[2]

    def esa(name, cur: _QT, p, heads: int, red: int) -> torch.Tensor:
        n, hh, ww, c = cur.q.shape
        dh = c // heads
        q = _conv(ctx, cur, p["q"])
        xr = ctx.conv_site(f"{name}.xr", cur, p["sr"], stride=red)
        kv = _conv(ctx, xr, p["kv"])
        keys = xr.q.shape[1] * xr.q.shape[2]
        q = q.reshape(n, hh * ww, heads, dh).transpose(1, 2)
        k = kv[..., :c].reshape(n, keys, heads, dh).transpose(1, 2)
        v = kv[..., c:].reshape(n, keys, heads, dh).transpose(1, 2)
        # the scale rounded to the dtype first (JAX's weak-typed scalar)
        scale = float(torch.tensor(dh ** -0.5, dtype=torch.float32).to(dtype))
        attn = torch.matmul(q, k.transpose(-1, -2)) * scale
        attn = torch.softmax(attn.float(), dim=-1).to(dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(n, hh, ww, c)
        return _conv(ctx, ctx.site(f"{name}.o", out), p["proj"])

    def ffn(name, cur: _QT, p) -> torch.Tensor:
        t = ctx.conv_site(f"{name}.h", cur, p["c1"])
        t = _conv(ctx, t, p["dw"], padding=1, groups=t.q.shape[-1])
        return _conv(ctx, ctx.site(f"{name}.g", _gelu(t)), p["c2"])

    def stage(i, cur: _QT, stride, pad, heads, red) -> _QT:
        c = ctx.site(f"c{i}", _gelu(_conv(ctx, cur, qp[f"c{i}"], padding=pad, stride=stride)))
        if heads is None:
            return c
        c = ctx.site(f"c{i}.a", c.f(dtype) + esa(f"esa{i}", c, qp[f"esa{i}"], heads, red))
        return ctx.site(f"c{i}.f", c.f(dtype) + ffn(f"ffn{i}", c, qp[f"ffn{i}"]))

    cur = ctx.site("input", x.float())
    c1 = stage(0, cur, 4, 3, 1, 8)
    c2 = stage(1, c1, 2, 1, 2, 4)
    c3 = stage(2, c2, 2, 1, 4, 2)
    c4 = stage(3, c3, 2, 1, None, None)

    size = (c1.q.shape[1], c1.q.shape[2])
    fs = [_resize(_conv(ctx, c, qp[f"f{level}"]), size)
          for c, level in ((c4, 4), (c3, 3), (c2, 2))] + [_conv(ctx, c1, qp["f1"])]
    cat = ctx.site("dec.cat", torch.cat(fs, dim=-1))
    fused = ctx.conv_site("c4f", cat, qp["c4"], act="relu")
    head = ctx.conv_site("c5h", fused, qp["c5"], act="relu", padding=1)
    return _resize(_conv(ctx, head, qp["head"]).float(), (h, w))


# arch -> (fold, forward, sigmoid head?)
ARCHS = {
    "robust_unet": (fold_robust_unet, _forward, True),
    "unet": (fold_unet, _forward_unet, False),
    "segnet": (fold_segnet, _forward_segnet, True),
    "deeplabv3p": (fold_deeplabv3p, _forward_deeplabv3p, True),
    "mswnet": (fold_mswnet, _forward_mswnet, True),
    "waternet": (fold_waternet, _forward_waternet, True),
    "pspnet": (fold_pspnet, _forward_pspnet, True),
    "yoloseg": (fold_yoloseg, _forward_yoloseg, True),
    "hrnet_water": (fold_hrnet_water, _forward_hrnet_water, True),
    "fastscnn": (fold_fastscnn, _forward_fastscnn, True),
    "enet": (fold_enet, _forward_enet, True),
    "segformer_lite": (fold_segformer_lite, _forward_segformer_lite, True),
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
    name that is none of them."""
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
    device steps that a caller keeps across calls (`QuantizedModel`). A
    row split (a mesh's 'space' axis) raises: the int8 convs take no halo."""
    if collectives.row_split() is not None:
        raise NotImplementedError(
            "int8 forwards on a mesh with a 'space' axis are not ported: the int8 convs "
            "call int8_conv directly, with no halo exchange (ROADMAP.md, queue 1: int8 "
            "under space)")
    _, fwd, sig = ARCHS[arch]
    x = _input(x)
    with torch.inference_mode():
        logits = fwd(to_device(qparams, x.device, policy, arch), scales, x, policy=policy,
                     steps=steps)
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
            raise ValueError(f"{arch!r} has no int8 forward; ported: {sorted(ARCHS)}")
        self.device = resolve_device(device)
        self.qparams = qparams
        self.scales = scales
        self.arch = arch
        self.policy = policy
        self.params = to_device(qparams, self.device, policy, arch)
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
