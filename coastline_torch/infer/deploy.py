"""The int8 serving artifact (counterpart of `coastline/infer/deploy.py`).

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

Not ported: the JAX package's `export_serving` / `load_serving` /
`save_serving_bundle` (an AOT `jax.export` program of the forward).
"""

import json
from typing import Dict

import numpy as np

from coastline_torch.infer.quant import DEFAULT_POLICY, SLIM_KEEP, QuantizedModel, int8_eligible
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
