"""Weight bridge: JAX-package variables (as numpy) -> port state_dicts.

The port's own copy of the UNet, Robust U-Net and SegNet exporters in
`coastline/utils/torch_import.py:765-888`: flax NHWC conv kernels
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
