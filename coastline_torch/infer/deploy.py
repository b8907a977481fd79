"""The int8 serving artifacts (counterpart of `coastline/infer/deploy.py`).

`save_quantized` / `load_quantized` write and read one `.npz` holding the
BN-folded int8 weights, their per-channel steps and the calibration scales;
a serving host loads it straight into a `QuantizedModel`, with no float
checkpoint and no calibration data. The format is the JAX package's, key
for key: `q/<path>/<leaf>` arrays, a `q/<path>/__none__` marker for an
absent entry (a Robust U-Net block without a shortcut), and `__meta__`, the
UTF-8 bytes of a JSON object with `arch`, `policy`, `slim` and `scales`; a
slim artifact drops the float32 `w` of every conv the saved policy runs on
the int8 path but those its arch's forward reads elsewhere (`SLIM_KEEP`:
DeepLabV3+'s `aspp_b4`). An artifact written by either package serves in the
other.

`export_serving` / `load_serving` write and read an ahead-of-time program of
the int8 forward at a fixed batch shape: a `torch.export` program, saved as
`.pt2` bytes, that calls as `fn(weights, x)` with x the normalized (B, S, S,
3) float32 batch and returns what `QuantizedModel.__call__` returns (the
sigmoid for a sigmoid head, else the logits). As in the JAX package the
weights are an argument, not a part of the program: `serving_weights` builds
the tree the program takes (plain dicts of tensors, on one device) and the
`.pt2` holds the graph and the sites' step constants only. The int8 conv and
SegNet's pool and unpool appear in the graph as the custom ops
`coastline_torch::int8_conv`, `::max_pool_with_indices` and `::max_unpool`,
registered when `coastline_torch.kernels` is imported; a loading process
imports them but needs no model class. A program runs on the device type it
was exported for: its CUDA ops launch the port's kernels.

`save_serving_bundle` / `load_serving_bundle` write and read a directory
that serves with no Python model: `weights.npz` (`save_quantized`),
`serving_fn.pt2` and `serving.json` (arch, batch, size, device, torch
version). The `.pt2` is the port's own format: the JAX package's bundle
holds a `jax.export` program, `serving_fn.bin`, instead, and neither package
loads the other's program; the `.npz` is the part both share.
"""

import io
import json
import os
from typing import Dict

import numpy as np
import torch

from coastline_torch.infer.quant import (ARCHS, DEFAULT_POLICY, SLIM_KEEP, QuantizedModel,
                                         int8_eligible, to_device)
from coastline_torch.kernels.int8_conv import PackedWeights
from coastline_torch.utils.device import resolve_device

_NONE = "__none__"  # npz marker key suffix for absent entries (e.g. rb shortcuts)


def _flatten(prefix: str, node, out: Dict[str, np.ndarray]) -> None:
    if node is None:
        out[prefix + "/" + _NONE] = np.zeros((0,), np.int8)
    elif isinstance(node, dict):
        for k, v in node.items():
            _flatten(f"{prefix}/{k}", v, out)
    else:
        out[prefix] = np.asarray(node)


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        if parts[-1] == _NONE:
            parts, val = parts[:-1], None
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _map_entries(prefix, node, fn):
    """Apply fn to every conv entry (a dict holding 'wq') of a tree."""
    if isinstance(node, dict) and "wq" not in node:
        return {k: _map_entries(f"{prefix}/{k}", v, fn) for k, v in node.items()}
    return fn(prefix, node)


def save_quantized(path, qm: QuantizedModel, slim: bool = True) -> None:
    """Write `qm` as one .npz (weights, scales, metadata).

    With `slim=True` the float32 `w` is dropped for every conv the model's
    policy runs on the int8 path (which reads only wq, wstep and b), unless
    the arch's forward reads it elsewhere (`SLIM_KEEP`).
    Loading a slim artifact under another policy rebuilds those `w` as
    wq * wstep; under the saved policy the forward is bit-exact either way."""
    policy = dict(DEFAULT_POLICY, **(qm.policy or {}))
    keep = SLIM_KEEP.get(qm.arch, set())

    def maybe_slim(prefix, node):
        if not (isinstance(node, dict) and "wq" in node):
            return node
        kh, kw, cin, cout = node["w"].shape
        key = prefix.rsplit("/", 1)[-1]
        transposed = key.startswith("up")  # as `quant.to_device`
        if key in keep or not int8_eligible(cin, cout, transposed, policy):
            return node
        return {k: v for k, v in node.items() if k != "w"}

    flat: Dict[str, np.ndarray] = {}
    _flatten("q", qm.qparams, flat)
    if slim:
        tree = _unflatten(flat)["q"]
        flat = {}
        _flatten("q", _map_entries("q", tree, maybe_slim), flat)
    meta = {"arch": qm.arch, "policy": qm.policy, "slim": slim,
            "scales": {k: float(v) for k, v in qm.scales.items()}}
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **flat)


def load_quantized(path, device="cuda") -> QuantizedModel:
    """Load a .npz written by `save_quantized` (of either package) into a
    `QuantizedModel` on `device`."""
    device = resolve_device(device)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__meta__")).decode("utf-8"))
    qparams = _unflatten(flat)["q"]
    if meta.get("slim"):
        def restore(prefix, node):
            if isinstance(node, dict) and "wq" in node and "w" not in node:
                node = dict(node)
                node["w"] = node["wq"].astype(np.float32) * node["wstep"][None, None, None, :]
            return node

        qparams = _map_entries("q", qparams, restore)
    return QuantizedModel(qparams, meta["scales"], arch=meta["arch"], policy=meta["policy"],
                          device=device)


# ---------------------------------------------------------------------------
# The serving program
# ---------------------------------------------------------------------------


def _lower_packed(w: PackedWeights) -> Dict:
    return {"wq": w.hwio} if w.mat is None else {"wq": w.hwio, "mat": w.mat}


def serving_weights(qm: QuantizedModel, device=None) -> Dict:
    """The weights a serving program takes, on `device` (`qm.device` by
    default): `qm`'s tree as `to_device` puts it there, lowered to plain
    dicts (keys sorted), tensors and None. An int8 conv's `PackedWeights`
    becomes `wq` (HWIO) and, where the kernel reads it, `mat` (its layout);
    a split-cat conv (`_conv_cat`, under the `split_cat` policy) also gets
    the two halves `to_device` packed, as `split`, so a program packs no
    weight per call. Export and load both build the tree with this function,
    so it is the program's input spec."""
    device = qm.device if device is None else resolve_device(device)
    params = (qm.params if device == qm.device
              else to_device(qm.qparams, device, qm.policy, qm.arch))

    def lower(node):
        if isinstance(node, dict):
            out = {k: lower(node[k]) for k in sorted(node) if k != "_split"}
            if isinstance(node.get("wq"), PackedWeights):
                out.update(_lower_packed(node["wq"]))
            if "_split" in node:
                (halves,) = node["_split"].values()
                out["split"] = [_lower_packed(h) for h in halves]
            return out
        if isinstance(node, tuple):
            return tuple(lower(v) for v in node)
        return node

    return lower(params)


def _forward_tree(node, key: str = ""):
    """`serving_weights`' tree -> the tree the arch forwards read: each
    conv's `PackedWeights` again (a transposed conv is an `up*` entry, as in
    `to_device`), and the split halves keyed as `to_device` keys them. No
    tensor op."""
    if isinstance(node, tuple):
        return tuple(_forward_tree(v, key) for v in node)
    if not isinstance(node, dict):
        return node
    if "wq" not in node:
        return {k: _forward_tree(v, k) for k, v in node.items()}
    out = {k: v for k, v in node.items() if k not in ("wq", "mat", "split")}
    out["wq"] = PackedWeights(node["wq"], node.get("mat"), key.startswith("up"))
    if "split" in node:
        lo, hi = (PackedWeights(h["wq"], h.get("mat"), False) for h in node["split"])
        out["_split"] = {lo.hwio.shape[2]: (lo, hi)}
    return out


class _Serving(torch.nn.Module):
    """The int8 forward of one model as `export` traces it: `fn(weights, x)`
    with the scales and policy fixed, and a fresh cache of the sites' steps
    (each step a constant of the program)."""

    def __init__(self, arch: str, scales: Dict[str, float], policy):
        super().__init__()
        self.arch, self.scales, self.policy = arch, scales, policy

    def forward(self, weights, x):
        _, fwd, sig = ARCHS[self.arch]
        logits = fwd(_forward_tree(weights), self.scales, x, policy=self.policy, steps={})
        return torch.sigmoid(logits) if sig else logits


def export_serving(qm: QuantizedModel, batch_size: int, image_size: int, device=None) -> bytes:
    """Export `qm`'s int8 forward at (batch_size, image_size, image_size, 3)
    -> the `.pt2` bytes of a `torch.export` program (the port's format; see
    the module docstring). It calls as `fn(weights, x)`, weights from
    `serving_weights` and x normalized float32, both on `device`
    (`qm.device` by default: the role of JAX's `platforms`), and returns what
    `qm(x)` returns, bit for bit. The program holds no weight: the example
    inputs are dropped before it is saved."""
    device = qm.device if device is None else resolve_device(device)
    weights = serving_weights(qm, device)
    x = torch.zeros((batch_size, image_size, image_size, 3), dtype=torch.float32, device=device)
    program = torch.export.export(_Serving(qm.arch, qm.scales, qm.policy), (weights, x),
                                  strict=False)
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_serving(data: bytes):
    """`export_serving`'s bytes -> `fn(weights, x)`, run under `no_grad`. A
    batch of another shape than the exported one raises."""
    module = torch.export.load(io.BytesIO(data)).module()

    def fn(weights, x):
        with torch.no_grad():
            return module(weights, x)

    return fn


_WEIGHTS, _PROGRAM, _META = "weights.npz", "serving_fn.pt2", "serving.json"


def save_serving_bundle(dirpath, qm: QuantizedModel, batch_size: int, image_size: int,
                        device=None) -> None:
    """A serving bundle that needs no Python model: `weights.npz`
    (`save_quantized`, the format both packages share), `serving_fn.pt2`
    (`export_serving` on `device`, `qm.device` by default) and
    `serving.json` (arch, batch, size, device type, torch version)."""
    device = qm.device if device is None else resolve_device(device)
    os.makedirs(dirpath, exist_ok=True)
    save_quantized(os.path.join(dirpath, _WEIGHTS), qm)
    data = export_serving(qm, batch_size, image_size, device)
    with open(os.path.join(dirpath, _PROGRAM), "wb") as f:
        f.write(data)
    meta = {"arch": qm.arch, "batch_size": batch_size, "image_size": image_size,
            "device": device.type, "torch": torch.__version__}
    with open(os.path.join(dirpath, _META), "w") as f:
        json.dump(meta, f)


def load_serving_bundle(dirpath, device="cuda"):
    """A bundle of `save_serving_bundle` -> (fn(x), QuantizedModel). `fn`
    closes over the serving weights, put on `device` once, and takes the
    normalized batch. Refuses a directory without `serving_fn.pt2` (a JAX
    bundle holds `serving_fn.bin`, which the port does not load) and a
    device of another type than the program's."""
    program = os.path.join(dirpath, _PROGRAM)
    if not os.path.exists(program):
        raise FileNotFoundError(
            f"{program} not found: not a serving bundle of the port. A JAX bundle's "
            f"serving_fn.bin is a jax.export program, which the port does not load; its "
            f"{_WEIGHTS} loads with load_quantized")
    with open(os.path.join(dirpath, _META)) as f:
        meta = json.load(f)
    if torch.device(device).type != meta["device"]:
        raise ValueError(f"{program} was exported for {meta['device']} and does not run on "
                         f"{device}: export it again there")
    device = resolve_device(device)
    qm = load_quantized(os.path.join(dirpath, _WEIGHTS), device)
    with open(program, "rb") as f:
        fn = load_serving(f.read())
    weights = serving_weights(qm)

    def serve(x):
        return fn(weights, torch.as_tensor(x, dtype=torch.float32).to(device))

    return serve, qm
