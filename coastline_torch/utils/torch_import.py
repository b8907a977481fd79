"""Weight bridge: JAX-package variables (as numpy) -> port state_dicts.

The port's own copy of the JAX package's twelve exporters
(`coastline/utils/torch_import.py:765-1122`): flax NHWC conv kernels
(kh, kw, in, out) become torch (out, in, kh, kw); the JAX ConvTranspose
kernel, stored spatially flipped, is un-flipped into torch's
(in, out, kh, kw); ChannelAttention's Dense kernels (in, out) become 1x1
convs (out, in, 1, 1); BN parameters and running statistics carry across.
The result is the reference state_dict layout, which the port's models load
with `strict=True`.
"""

from typing import Dict, Mapping

import numpy as np
import torch

UNET_BLOCKS = ("enc1", "enc2", "enc3", "enc4", "bottleneck",
               "dec4", "dec3", "dec2", "dec1")
UNET_UPCONVS = ("upconv4", "upconv3", "upconv2", "upconv1")
UNET_WIDTHS = ((None, 64), (64, 128), (128, 256), (256, 512), (512, 1024),
               (1024, 512), (512, 256), (256, 128), (128, 64))


def _conv_inv(tree):
    out = {"weight": np.transpose(np.asarray(tree["kernel"]), (3, 2, 0, 1))}
    if "bias" in tree:
        out["bias"] = np.asarray(tree["bias"])
    return out


def _convT_inv(tree):
    k = np.asarray(tree["kernel"])[::-1, ::-1]
    out = {"weight": np.transpose(k, (2, 3, 0, 1)).copy()}
    if "bias" in tree:
        out["bias"] = np.asarray(tree["bias"])
    return out


def _bn_inv(prefix: str, p, s, out: Dict):
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])
    out[f"{prefix}.running_mean"] = np.asarray(s["mean"])
    out[f"{prefix}.running_var"] = np.asarray(s["var"])
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _emit(out: Dict, prefix: str, tensors: Mapping):
    for k, v in tensors.items():
        out[f"{prefix}.{k}"] = v


def export_reference_unet(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX UNet {'params', 'batch_stats'} -> reference state_dict as numpy."""
    p, s = variables["params"], variables["batch_stats"]
    out: Dict = {}
    for i, name in enumerate(UNET_BLOCKS):
        dc_p, dc_s = p[f"DoubleConv_{i}"], s[f"DoubleConv_{i}"]
        for j in range(2):
            cba_p, cba_s = dc_p[f"ConvBNAct_{j}"], dc_s[f"ConvBNAct_{j}"]
            _emit(out, f"{name}.{3 * j}", _conv_inv(cba_p["Conv_0"]["Conv_0"]))
            _bn_inv(f"{name}.{3 * j + 1}", cba_p["Norm_0"]["BatchNorm_0"],
                    cba_s["Norm_0"]["BatchNorm_0"], out)
    for i, name in enumerate(UNET_UPCONVS):
        _emit(out, name, _convT_inv(p[f"ConvTranspose_{i}"]))
    _emit(out, "final", _conv_inv(p["Conv_0"]["Conv_0"]))
    return out


def _tensors(state: Mapping) -> Dict[str, torch.Tensor]:
    """numpy state_dict -> float32 tensors (the BN step counters stay int64)."""
    return {k: torch.from_numpy(np.array(v, np.int64 if k.endswith("num_batches_tracked")
                                         else np.float32))
            for k, v in state.items()}


def unet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX UNet variables -> port UNet state_dict."""
    return _tensors(export_reference_unet(variables))


def random_unet_variables(seed: int = 0) -> Dict:
    """A JAX-layout 2-class UNet variables tree of numpy arrays drawn from `seed`.

    Kernels are He-uniform (fan_in = kh * kw * in), so activations keep
    their scale through the depth; BN statistics and affines are drawn away
    from 0/1 so a wrong fold or epsilon shows."""
    rng = np.random.default_rng(seed)

    def kernel(kh, cin, cout):
        bound = np.sqrt(6.0 / (kh * kh * cin))
        return {"kernel": rng.uniform(-bound, bound, (kh, kh, cin, cout)).astype(np.float32),
                "bias": rng.uniform(-0.1, 0.1, cout).astype(np.float32)}

    params, stats = {}, {}
    for i, (cin, cout) in enumerate(UNET_WIDTHS):
        cin = 3 if cin is None else cin
        dc_p, dc_s = {}, {}
        for j, c_in in enumerate((cin, cout)):
            dc_p[f"ConvBNAct_{j}"] = {
                "Conv_0": {"Conv_0": kernel(3, c_in, cout)},
                "Norm_0": {"BatchNorm_0": {
                    "scale": rng.uniform(0.8, 1.2, cout).astype(np.float32),
                    "bias": rng.normal(0.0, 0.1, cout).astype(np.float32)}}}
            dc_s[f"ConvBNAct_{j}"] = {"Norm_0": {"BatchNorm_0": {
                "mean": rng.normal(0.0, 0.1, cout).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}}}
        params[f"DoubleConv_{i}"], stats[f"DoubleConv_{i}"] = dc_p, dc_s
    for i, cout in enumerate((512, 256, 128, 64)):
        params[f"ConvTranspose_{i}"] = kernel(2, 2 * cout, cout)
    params["Conv_0"] = {"Conv_0": kernel(1, 64, 2)}
    return {"params": params, "batch_stats": stats}


ROBUST_BLOCKS = ("inc", "down1.1", "down2.1", "down3.1", "bottleneck.2",
                 "dec4", "dec3", "dec2", "dec1")
ROBUST_GATES = ("att4", "att3", "att2", "att1")
ROBUST_UPCONVS = ("up4", "up3", "up2", "up1")


def _dense_to_1x1(tree):
    return {"weight": np.asarray(tree["kernel"]).T[:, :, None, None]}


def _residual_block_inv(prefix: str, p, s, out: Dict):
    i = 0
    if sum(1 for k in p if k.startswith("Conv_")) == 3:  # 1x1 shortcut (in != out)
        _emit(out, f"{prefix}.shortcut.0", _conv_inv(p["Conv_0"]["Conv_0"]))
        _bn_inv(f"{prefix}.shortcut.1", p["Norm_0"]["BatchNorm_0"],
                s["Norm_0"]["BatchNorm_0"], out)
        i = 1
    for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
        _emit(out, f"{prefix}.{conv}", _conv_inv(p[f"Conv_{i}"]["Conv_0"]))
        _bn_inv(f"{prefix}.{bn}", p[f"Norm_{i}"]["BatchNorm_0"],
                s[f"Norm_{i}"]["BatchNorm_0"], out)
        i += 1
    _emit(out, f"{prefix}.ca.fc.0", _dense_to_1x1(p["ChannelAttention_0"]["Dense_0"]))
    _emit(out, f"{prefix}.ca.fc.2", _dense_to_1x1(p["ChannelAttention_0"]["Dense_1"]))
    _emit(out, f"{prefix}.sa.conv1", _conv_inv(p["SpatialAttention_0"]["Conv_0"]["Conv_0"]))


def export_reference_robust_unet(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX RobustUNet {'params', 'batch_stats'} -> reference state_dict as numpy."""
    p, s = variables["params"], variables["batch_stats"]
    out: Dict = {}
    for i, name in enumerate(ROBUST_BLOCKS):
        _residual_block_inv(name, p[f"ResidualBlock_{i}"], s[f"ResidualBlock_{i}"], out)
    db_p, db_s = p["DilatedBlock_0"], s["DilatedBlock_0"]
    for j in range(4):
        _emit(out, f"bottleneck.1.conv{j + 1}", _conv_inv(db_p[f"Conv_{j}"]["Conv_0"]))
    _bn_inv("bottleneck.1.bn", db_p["Norm_0"]["BatchNorm_0"], db_s["Norm_0"]["BatchNorm_0"], out)
    for i, name in enumerate(ROBUST_GATES):
        ag_p, ag_s = p[f"AttentionGate_{i}"], s[f"AttentionGate_{i}"]
        for j, seq in enumerate(("W_g", "W_x", "psi")):
            _emit(out, f"{name}.{seq}.0", _conv_inv(ag_p[f"Conv_{j}"]["Conv_0"]))
            _bn_inv(f"{name}.{seq}.1", ag_p[f"Norm_{j}"]["BatchNorm_0"],
                    ag_s[f"Norm_{j}"]["BatchNorm_0"], out)
    for i, name in enumerate(ROBUST_UPCONVS):
        _emit(out, name, _convT_inv(p[f"ConvTranspose_{i}"]))
    _emit(out, "outc.0", _conv_inv(p["Conv_0"]["Conv_0"]))
    return out


def robust_unet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX RobustUNet variables -> port RobustUNet state_dict."""
    return _tensors(export_reference_robust_unet(variables))


def random_robust_unet_variables(seed: int = 0, base: int = 64, n_classes: int = 1) -> Dict:
    """A JAX-layout RobustUNet variables tree of numpy arrays drawn from `seed`.

    Kernels are uniform with variance 1.5 / fan_in (a transposed conv's
    fan_in counted as its input channels, the taps that reach one output
    pixel). He's 2 / fan_in grows the activations about 1.7x a level through
    the residual sums; 1.5 keeps every block's output std between 0.7 and
    2.2 and the logits' near 1.3 at 64^2. BN statistics and affines are drawn
    away from 0/1, so a wrong fold or epsilon shows."""
    rng = np.random.default_rng(seed)

    def kernel(kh, cin, cout, bias=True, fan_in=None):
        bound = np.sqrt(4.5 / (fan_in or kh * kh * cin))
        tree = {"kernel": rng.uniform(-bound, bound, (kh, kh, cin, cout)).astype(np.float32)}
        if bias:
            tree["bias"] = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
        return tree

    def norm(c):
        return ({"BatchNorm_0": {"scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                                 "bias": rng.normal(0.0, 0.1, c).astype(np.float32)}},
                {"BatchNorm_0": {"mean": rng.normal(0.0, 0.1, c).astype(np.float32),
                                 "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}})

    def residual(cin, cout):
        p, s = {}, {}
        convs = ([(1, cin)] if cin != cout else []) + [(3, cin), (3, cout)]
        for i, (kh, c_in) in enumerate(convs):
            p[f"Conv_{i}"] = {"Conv_0": kernel(kh, c_in, cout, bias=False)}
            p[f"Norm_{i}"], s[f"Norm_{i}"] = norm(cout)
        hidden = cout // 16
        p["ChannelAttention_0"] = {
            "Dense_0": {"kernel": kernel(1, cout, hidden, bias=False)["kernel"][0, 0]},
            "Dense_1": {"kernel": kernel(1, hidden, cout, bias=False)["kernel"][0, 0]}}
        p["SpatialAttention_0"] = {"Conv_0": {"Conv_0": kernel(7, 2, 1, bias=False)}}
        return p, s

    b = base
    widths = ((3, b), (b, 2 * b), (2 * b, 4 * b), (4 * b, 8 * b), (16 * b, 16 * b),
              (16 * b, 8 * b), (8 * b, 4 * b), (4 * b, 2 * b), (2 * b, b))
    params, stats = {}, {}
    for i, (cin, cout) in enumerate(widths):
        params[f"ResidualBlock_{i}"], stats[f"ResidualBlock_{i}"] = residual(cin, cout)
    db = {f"Conv_{j}": {"Conv_0": kernel(kh, 8 * b, 4 * b)} for j, kh in enumerate((1, 3, 3, 3))}
    db["Norm_0"], db_s = norm(16 * b)
    params["DilatedBlock_0"], stats["DilatedBlock_0"] = db, {"Norm_0": db_s}
    for i, c in enumerate((8 * b, 4 * b, 2 * b, b)):
        ag_p, ag_s = {}, {}
        for j, (cin, cout) in enumerate(((c, c // 2), (c, c // 2), (c // 2, 1))):
            ag_p[f"Conv_{j}"] = {"Conv_0": kernel(1, cin, cout)}
            ag_p[f"Norm_{j}"], ag_s[f"Norm_{j}"] = norm(cout)
        params[f"AttentionGate_{i}"], stats[f"AttentionGate_{i}"] = ag_p, ag_s
        params[f"ConvTranspose_{i}"] = kernel(2, 2 * c, c, fan_in=2 * c)
    params["Conv_0"] = {"Conv_0": kernel(1, b, n_classes)}
    return {"params": params, "batch_stats": stats}


SEGNET_STAGES = (("enc1", (3, 64, 64)), ("enc2", (64, 128, 128)),
                 ("enc3", (128, 256, 256, 256)), ("enc4", (256, 512, 512, 512)),
                 ("dec4", (512, 512, 512, 256)), ("dec3", (256, 256, 256, 128)),
                 ("dec2", (128, 128, 64)), ("dec1", (64, 64)))


def export_reference_segnet(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX SegNet {'params', 'batch_stats'} -> reference state_dict as numpy:
    ConvBNAct_0..18 in call order onto conv 3j / BN 3j + 1 of each stage, the
    head `Conv_0` onto `dec1.3`."""
    p, s = variables["params"], variables["batch_stats"]
    out: Dict = {}
    i = 0
    for name, widths in SEGNET_STAGES:
        for j in range(len(widths) - 1):
            cba_p, cba_s = p[f"ConvBNAct_{i}"], s[f"ConvBNAct_{i}"]
            _emit(out, f"{name}.{3 * j}", _conv_inv(cba_p["Conv_0"]["Conv_0"]))
            _bn_inv(f"{name}.{3 * j + 1}", cba_p["Norm_0"]["BatchNorm_0"],
                    cba_s["Norm_0"]["BatchNorm_0"], out)
            i += 1
    _emit(out, "dec1.3", _conv_inv(p["Conv_0"]["Conv_0"]))
    return out


def segnet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX SegNet variables -> port SegNet state_dict."""
    return _tensors(export_reference_segnet(variables))


def random_segnet_variables(seed: int = 0, n_classes: int = 1) -> Dict:
    """A JAX-layout SegNet variables tree of numpy arrays drawn from `seed`:
    He-uniform kernels (fan_in = 9 * in), biases U(+-0.1), BN statistics and
    affines drawn away from 0/1 so a wrong fold or epsilon shows, as
    `random_unet_variables` draws them."""
    rng = np.random.default_rng(seed)

    def conv(cin, cout):
        bound = np.sqrt(6.0 / (9 * cin))
        return {"kernel": rng.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32),
                "bias": rng.uniform(-0.1, 0.1, cout).astype(np.float32)}

    params, stats = {}, {}
    widths = [w for _, stage in SEGNET_STAGES for w in zip(stage, stage[1:])]
    for i, (cin, cout) in enumerate(widths):
        params[f"ConvBNAct_{i}"] = {
            "Conv_0": {"Conv_0": conv(cin, cout)},
            "Norm_0": {"BatchNorm_0": {"scale": rng.uniform(0.8, 1.2, cout).astype(np.float32),
                                       "bias": rng.normal(0.0, 0.1, cout).astype(np.float32)}}}
        stats[f"ConvBNAct_{i}"] = {"Norm_0": {"BatchNorm_0": {
            "mean": rng.normal(0.0, 0.1, cout).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}}}
    params["Conv_0"] = {"Conv_0": conv(64, n_classes)}
    return {"params": params, "batch_stats": stats}


def _convbnact_inv(conv_prefix: str, bn_prefix: str, p, s, out: Dict):
    """A JAX ConvBNAct -> the reference's conv and BN keys."""
    _emit(out, conv_prefix, _conv_inv(p["Conv_0"]["Conv_0"]))
    _bn_inv(bn_prefix, p["Norm_0"]["BatchNorm_0"], s["Norm_0"]["BatchNorm_0"], out)


def export_reference_deeplabv3plus(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX DeepLabV3Plus -> reference state_dict: ConvBNAct_0..3 onto
    conv1..conv4 (conv2's max pool puts its conv and BN at 1 and 2), ASPP_0
    onto `aspp`, the decoder's ConvTranspose_i / Norm_i onto decoder 3i /
    3i + 1, Conv_0 onto decoder.12."""
    p, s = variables["params"], variables["batch_stats"]
    out: Dict = {}
    for i, (name, ci, bi) in enumerate((("conv1", 0, 1), ("conv2", 1, 2), ("conv3", 0, 1),
                                        ("conv4", 0, 1))):
        _convbnact_inv(f"{name}.{ci}", f"{name}.{bi}", p[f"ConvBNAct_{i}"], s[f"ConvBNAct_{i}"],
                       out)
    ap, as_ = p["ASPP_0"], s["ASPP_0"]
    for i, name in enumerate(("conv1", "conv2", "conv3", "conv4", "conv5", "conv_out")):
        _emit(out, f"aspp.{name}", _conv_inv(ap[f"Conv_{i}"]["Conv_0"]))
    _bn_inv("aspp.bn", ap["Norm_0"]["BatchNorm_0"], as_["Norm_0"]["BatchNorm_0"], out)
    _seg_head_inv("decoder", p, s, out, 4)
    _emit(out, "decoder.12", _conv_inv(p["Conv_0"]["Conv_0"]))
    return out


def _seg_head_inv(prefix: str, p, s, out: Dict, n: int):
    """ConvTranspose_i / Norm_i (i < n) onto `prefix` 3i / 3i + 1: a flat
    Sequential of (transposed conv, BN, activation) triples."""
    for i in range(n):
        _emit(out, f"{prefix}.{3 * i}", _convT_inv(p[f"ConvTranspose_{i}"]))
        _bn_inv(f"{prefix}.{3 * i + 1}", p[f"Norm_{i}"]["BatchNorm_0"],
                s[f"Norm_{i}"]["BatchNorm_0"], out)


YOLO_BACKBONE_CONVS = (0, 4, 8, 11, 14, 18, 21, 24)


def export_reference_yoloseg(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX YOLOSeg -> reference state_dict: ConvBNAct_0..7 onto the backbone
    convs (BN after each), the head's ConvTranspose_i / Norm_i onto seg_head
    3i / 3i + 1, Conv_0 onto seg_head.12."""
    p, s = variables["params"], variables["batch_stats"]
    out: Dict = {}
    for i, ci in enumerate(YOLO_BACKBONE_CONVS):
        _convbnact_inv(f"backbone.{ci}", f"backbone.{ci + 1}", p[f"ConvBNAct_{i}"],
                       s[f"ConvBNAct_{i}"], out)
    _seg_head_inv("seg_head", p, s, out, 4)
    _emit(out, "seg_head.12", _conv_inv(p["Conv_0"]["Conv_0"]))
    return out


def _pyramid_pooling_inv(prefix: str, p, s, out: Dict, n_branches: int = 4):
    for i in range(n_branches):
        _emit(out, f"{prefix}.convs.{i}.1", _conv_inv(p[f"Conv_{i}"]["Conv_0"]))
        _bn_inv(f"{prefix}.convs.{i}.2", p[f"Norm_{i}"]["BatchNorm_0"],
                s[f"Norm_{i}"]["BatchNorm_0"], out)


def export_reference_pspnet(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX PSPNet -> reference state_dict: ConvBNAct_0..3 onto conv1..conv4,
    PyramidPooling_0 onto `ppm.convs`, ConvBNAct_4 and Conv_0 onto
    final_conv 0/1 and 4."""
    p, s = variables["params"], variables["batch_stats"]
    out: Dict = {}
    for i in range(4):
        _convbnact_inv(f"conv{i + 1}.0", f"conv{i + 1}.1", p[f"ConvBNAct_{i}"],
                       s[f"ConvBNAct_{i}"], out)
    _pyramid_pooling_inv("ppm", p["PyramidPooling_0"], s["PyramidPooling_0"], out)
    _convbnact_inv("final_conv.0", "final_conv.1", p["ConvBNAct_4"], s["ConvBNAct_4"], out)
    _emit(out, "final_conv.4", _conv_inv(p["Conv_0"]["Conv_0"]))
    return out


def _dsconv_inv(prefix: str, p, s, out: Dict):
    _emit(out, f"{prefix}.depthwise", _conv_inv(p["Conv_0"]["Conv_0"]))
    _emit(out, f"{prefix}.pointwise", _conv_inv(p["Conv_1"]["Conv_0"]))
    _bn_inv(f"{prefix}.bn", p["Norm_0"]["BatchNorm_0"], s["Norm_0"]["BatchNorm_0"], out)


FASTSCNN_DSCONVS = (("learning_to_downsample.dsconv1", "learning_to_downsample.dsconv2")
                    + tuple(f"global_feature_extractor.block{b}.{j}"
                            for b in (1, 2, 3) for j in range(3))
                    + ("classifier.conv1", "classifier.conv2"))


def export_reference_fastscnn(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX FastSCNN -> reference state_dict: ConvBNAct_0 onto
    learning_to_downsample.conv1, DepthwiseSeparableConv_0..12 in call
    order, PyramidPooling_0 onto the extractor's ppm, Conv_0/Norm_0 and
    Conv_1/Norm_1 onto feature_fusion conv_low and conv_high, Conv_2 onto
    classifier.conv3."""
    p, s = variables["params"], variables["batch_stats"]
    out: Dict = {}
    _convbnact_inv("learning_to_downsample.conv1.0", "learning_to_downsample.conv1.1",
                   p["ConvBNAct_0"], s["ConvBNAct_0"], out)
    for i, prefix in enumerate(FASTSCNN_DSCONVS):
        _dsconv_inv(prefix, p[f"DepthwiseSeparableConv_{i}"], s[f"DepthwiseSeparableConv_{i}"],
                    out)
    _pyramid_pooling_inv("global_feature_extractor.ppm", p["PyramidPooling_0"],
                         s["PyramidPooling_0"], out)
    for i, seq in enumerate(("conv_low", "conv_high")):
        _emit(out, f"feature_fusion.{seq}.0", _conv_inv(p[f"Conv_{i}"]["Conv_0"]))
        _bn_inv(f"feature_fusion.{seq}.1", p[f"Norm_{i}"]["BatchNorm_0"],
                s[f"Norm_{i}"]["BatchNorm_0"], out)
    _emit(out, "classifier.conv3", _conv_inv(p["Conv_2"]["Conv_0"]))
    return out


def _enet_bottleneck_inv(prefix: str, p, s, out: Dict, downsample: bool, asymmetric: bool):
    i = 0
    if downsample:  # the identity path's 1x1 + BN is declared first
        _emit(out, f"{prefix}.conv_down.0", _conv_inv(p["Conv_0"]["Conv_0"]))
        _bn_inv(f"{prefix}.conv_down.1", p["Norm_0"]["BatchNorm_0"], s["Norm_0"]["BatchNorm_0"],
                out)
        i = 1
    _convbnact_inv(f"{prefix}.conv1.0", f"{prefix}.conv1.1", p["ConvBNAct_0"], s["ConvBNAct_0"],
                   out)
    mid = [("conv2.0", "conv2.1")] + ([("conv2.3", "conv2.4")] if asymmetric else [])
    for conv, bn in mid + [("conv3.0", "conv3.1")]:
        _emit(out, f"{prefix}.{conv}", _conv_inv(p[f"Conv_{i}"]["Conv_0"]))
        _bn_inv(f"{prefix}.{bn}", p[f"Norm_{i}"]["BatchNorm_0"], s[f"Norm_{i}"]["BatchNorm_0"],
                out)
        i += 1


# ENet's bottlenecks in call order: (prefix, downsample, asymmetric)
ENET_BOTTLENECKS = ([(f"encoder1.{j}", j == 0, False) for j in range(4)]
                    + [(f"encoder2.{j}", j == 0, j in (3, 7)) for j in range(9)])


def export_reference_enet(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX ENet -> reference state_dict: ENetInitialBlock_0 onto `initial`,
    ENetBottleneck_0..12 onto encoder1.0-3 and encoder2.0-8, the decoder's
    ConvTranspose_0/1 + Norm_0/1 onto decoder 0/1 and 3/4, ConvTranspose_2
    onto decoder.6."""
    p, s = variables["params"], variables["batch_stats"]
    out: Dict = {}
    ip, is_ = p["ENetInitialBlock_0"], s["ENetInitialBlock_0"]
    _emit(out, "initial.conv", _conv_inv(ip["Conv_0"]["Conv_0"]))
    _bn_inv("initial.bn", ip["Norm_0"]["BatchNorm_0"], is_["Norm_0"]["BatchNorm_0"], out)
    for i, (prefix, down, asym) in enumerate(ENET_BOTTLENECKS):
        _enet_bottleneck_inv(prefix, p[f"ENetBottleneck_{i}"], s[f"ENetBottleneck_{i}"], out,
                             down, asym)
    _seg_head_inv("decoder", p, s, out, 2)
    _emit(out, "decoder.6", _convT_inv(p["ConvTranspose_2"]))
    return out


def _double_inv(prefix: str, p, s, out: Dict, first: int):
    """ConvBNAct_first and _first + 1 onto `prefix` 0/1 and 3/4."""
    for j in range(2):
        _convbnact_inv(f"{prefix}.{3 * j}", f"{prefix}.{3 * j + 1}", p[f"ConvBNAct_{first + j}"],
                       s[f"ConvBNAct_{first + j}"], out)


def export_reference_waternet(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX WaterNet -> reference state_dict: WaterIndexModule_0 onto
    water_index.index_conv 0/1/3, ConvBNAct_0..7 onto enc1..enc3 and
    bottleneck, ChannelAttention_0 onto water_attention.fc, ConvTranspose_t
    onto up3..up1 and ConvBNAct_8..13 onto dec3..dec1, Conv_0 onto outc.0."""
    p, s = variables["params"], variables["batch_stats"]
    out: Dict = {}
    wp, ws = p["WaterIndexModule_0"], s["WaterIndexModule_0"]
    _emit(out, "water_index.index_conv.0", _conv_inv(wp["Conv_0"]["Conv_0"]))
    _bn_inv("water_index.index_conv.1", wp["Norm_0"]["BatchNorm_0"], ws["Norm_0"]["BatchNorm_0"],
            out)
    _emit(out, "water_index.index_conv.3", _conv_inv(wp["Conv_1"]["Conv_0"]))
    for i, seq in enumerate(("enc1", "enc2", "enc3", "bottleneck")):
        _double_inv(seq, p, s, out, 2 * i)
    _emit(out, "water_attention.fc.0", _dense_to_1x1(p["ChannelAttention_0"]["Dense_0"]))
    _emit(out, "water_attention.fc.2", _dense_to_1x1(p["ChannelAttention_0"]["Dense_1"]))
    for t, level in enumerate((3, 2, 1)):
        _emit(out, f"up{level}", _convT_inv(p[f"ConvTranspose_{t}"]))
        _double_inv(f"dec{level}", p, s, out, 8 + 2 * t)
    _emit(out, "outc.0", _conv_inv(p["Conv_0"]["Conv_0"]))
    return out


def export_reference_mswnet(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX MSWNet -> reference state_dict: MultiScaleBlock_0..3 onto
    enc1..enc4 (branch4's max pool puts its conv and BN at 1 and 2),
    ConvBNAct_0/1 onto the bridge, ConvTranspose_t and ConvBNAct_t+2 onto
    up4..up1 and dec4..dec1, Conv_0 onto outc.0."""
    p, s = variables["params"], variables["batch_stats"]
    out: Dict = {}
    layout = (("branch1", 0, 1), ("branch2", 0, 1), ("branch3", 0, 1), ("branch4", 1, 2))
    for i in range(4):
        mp, ms = p[f"MultiScaleBlock_{i}"], s[f"MultiScaleBlock_{i}"]
        for j, (branch, ci, bi) in enumerate(layout):
            _convbnact_inv(f"enc{i + 1}.{branch}.{ci}", f"enc{i + 1}.{branch}.{bi}",
                           mp[f"ConvBNAct_{j}"], ms[f"ConvBNAct_{j}"], out)
    _double_inv("bridge", p, s, out, 0)
    for t, level in enumerate((4, 3, 2, 1)):
        _emit(out, f"up{level}", _convT_inv(p[f"ConvTranspose_{t}"]))
        _convbnact_inv(f"dec{level}.0", f"dec{level}.1", p[f"ConvBNAct_{t + 2}"],
                       s[f"ConvBNAct_{t + 2}"], out)
    _emit(out, "outc.0", _conv_inv(p["Conv_0"]["Conv_0"]))
    return out


def export_reference_hrnet_water(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX HRNetWater -> reference state_dict: ConvBNAct_0..7 onto stem,
    hr_branch, mr_branch and lr_branch, Conv_j/Norm_j onto mr_to_hr and
    lr_to_hr, ConvBNAct_8 and Conv_2 onto head 0/1 and 4."""
    p, s = variables["params"], variables["batch_stats"]
    out: Dict = {}
    for i, seq in enumerate(("stem", "hr_branch", "mr_branch", "lr_branch")):
        _double_inv(seq, p, s, out, 2 * i)
    for j, seq in enumerate(("mr_to_hr", "lr_to_hr")):
        _emit(out, f"{seq}.0", _conv_inv(p[f"Conv_{j}"]["Conv_0"]))
        _bn_inv(f"{seq}.1", p[f"Norm_{j}"]["BatchNorm_0"], s[f"Norm_{j}"]["BatchNorm_0"], out)
    _convbnact_inv("head.0", "head.1", p["ConvBNAct_8"], s["ConvBNAct_8"], out)
    _emit(out, "head.4", _conv_inv(p["Conv_2"]["Conv_0"]))
    return out


def export_reference_segformer_lite(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX SegFormerLite -> reference state_dict: ConvBNAct_0..3 onto
    patch_embed1..4, EfficientSelfAttention_i's Conv_0..3 onto attn{i+1}
    q / reduction / kv / proj (call order), MixFFN_i onto ffn{i+1} fc1 /
    dwconv / fc2, Conv_0..3 onto linear_c4..c1, ConvBNAct_4/5 onto
    linear_fuse and head 0/1, Conv_4 onto head.3."""
    p, s = variables["params"], variables["batch_stats"]
    out: Dict = {}
    for i in range(4):
        _convbnact_inv(f"patch_embed{i + 1}.0", f"patch_embed{i + 1}.1", p[f"ConvBNAct_{i}"],
                       s[f"ConvBNAct_{i}"], out)
    for i in range(3):
        for j, name in enumerate(("q", "reduction", "kv", "proj")):
            _emit(out, f"attn{i + 1}.{name}",
                  _conv_inv(p[f"EfficientSelfAttention_{i}"][f"Conv_{j}"]["Conv_0"]))
        for j, name in enumerate(("fc1", "dwconv", "fc2")):
            _emit(out, f"ffn{i + 1}.{name}", _conv_inv(p[f"MixFFN_{i}"][f"Conv_{j}"]["Conv_0"]))
    for i, level in enumerate((4, 3, 2, 1)):
        _emit(out, f"linear_c{level}", _conv_inv(p[f"Conv_{i}"]["Conv_0"]))
    _convbnact_inv("linear_fuse.0", "linear_fuse.1", p["ConvBNAct_4"], s["ConvBNAct_4"], out)
    _convbnact_inv("head.0", "head.1", p["ConvBNAct_5"], s["ConvBNAct_5"], out)
    _emit(out, "head.3", _conv_inv(p["Conv_4"]["Conv_0"]))
    return out


def deeplabv3plus_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX DeepLabV3Plus variables -> port DeepLabV3Plus state_dict."""
    return _tensors(export_reference_deeplabv3plus(variables))


def yoloseg_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX YOLOSeg variables -> port YOLOSeg state_dict."""
    return _tensors(export_reference_yoloseg(variables))


def pspnet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX PSPNet variables -> port PSPNet state_dict."""
    return _tensors(export_reference_pspnet(variables))


def fastscnn_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX FastSCNN variables -> port FastSCNN state_dict."""
    return _tensors(export_reference_fastscnn(variables))


def enet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ENet variables -> port ENet state_dict."""
    return _tensors(export_reference_enet(variables))


def waternet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX WaterNet variables -> port WaterNet state_dict."""
    return _tensors(export_reference_waternet(variables))


def mswnet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX MSWNet variables -> port MSWNet state_dict."""
    return _tensors(export_reference_mswnet(variables))


def hrnet_water_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX HRNetWater variables -> port HRNetWater state_dict."""
    return _tensors(export_reference_hrnet_water(variables))


def segformer_lite_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX SegFormerLite variables -> port SegFormerLite state_dict."""
    return _tensors(export_reference_segformer_lite(variables))
