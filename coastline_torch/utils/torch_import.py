"""Weight bridge: JAX-package UNet variables (as numpy) -> port state_dict.

The port's own copy of the UNet exporter in
`coastline/utils/torch_import.py:765-820`: flax NHWC conv kernels
(kh, kw, in, out) become torch (out, in, kh, kw); the JAX ConvTranspose
kernel, stored spatially flipped, is un-flipped into torch's
(in, out, kh, kw); BN parameters and running statistics carry across. The
result is the reference state_dict layout, which `coastline_torch`'s UNet
loads with `strict=True`.
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


def unet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX UNet variables -> port state_dict of float32 tensors (the BN
    step counters stay int64)."""
    return {k: torch.from_numpy(np.array(v, np.int64 if k.endswith("num_batches_tracked")
                                         else np.float32))
            for k, v in export_reference_unet(variables).items()}


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
