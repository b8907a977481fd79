"""The int8 serving program (CPU): the custom ops of `kernels/int8_conv.py`
and `kernels/unpool.py`, and `export_serving` / `load_serving` /
`save_serving_bundle` / `load_serving_bundle` of `coastline_torch/infer/deploy.py`
(counterparts of `coastline/infer/deploy.py:133-198`, `tests/test_deploy.py:65-108`).

Tolerance: none. On the CPU each op's registration is its plain version, so
an op returns what the plain version returns, bit for bit, and its fake
gives the real output's shape, dtype and strides (`torch.library.opcheck`).
A program of an int8 forward runs the same ops as the eager
`QuantizedModel` on the same weights and input, so its output is bit-equal
to the eager one's; a batch of another shape raises. The other archs are in
`test_torch_serving_export_zoo.py`, the check against the JAX package's
bundle in `test_torch_serving_export_jax.py`.
"""

import io
import json
import warnings

import numpy as np
import pytest
import torch

from coastline_torch.infer import deploy, quant
from coastline_torch.kernels import unpool
from coastline_torch.kernels.int8_conv import int8_conv, int8_conv_op, int8_conv_plain, packed
from coastline_torch.models.registry import create_model
from coastline_torch.utils import torch_import as ti

torch.set_num_threads(1)

#: int8 conv calls of one forward (`chip_smoke.INT8_CONVS`), the op's nodes in a program
INT8_CONVS = {"unet": 21, "robust_unet": 38, "segnet": 18, "waternet": 16, "mswnet": 18,
              "hrnet_water": 6, "pspnet": 8, "deeplabv3p": 10, "yoloseg": 8, "fastscnn": 13,
              "enet": 2, "segformer_lite": 19}
_VARIABLES = {"unet": (ti.random_unet_variables, ti.unet_state_dict),
              "robust_unet": (ti.random_robust_unet_variables, ti.robust_unet_state_dict),
              "segnet": (ti.random_segnet_variables, ti.segnet_state_dict)}


def quantized(arch, size, policy=None):
    """An int8 model of `arch` on the CPU, calibrated on two synthetic scenes
    at size^2 (`default_calibration`), and those scenes, (2, S, S, 3). The
    UNets and SegNet from the bridge's seeded variables, the zoo from its
    constructors under `torch.manual_seed(0)`."""
    if arch in _VARIABLES:
        make, to_sd = _VARIABLES[arch]
        sd = to_sd(make(seed=0))
    else:
        torch.manual_seed(0)
        sd = create_model(arch).state_dict()
    calib = quant.default_calibration(size, n_scenes=2, device="cpu")
    return quant.QuantizedModel.from_state_dict(sd, calib, arch=arch, policy=policy,
                                                device="cpu"), calib


def op_counts(data: bytes) -> dict:
    """The custom ops' nodes in a program's graph, by op name."""
    program = torch.export.load(io.BytesIO(data))
    counts = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("coastline_torch."):
            op = name.split(".")[1]
            counts[op] = counts.get(op, 0) + 1
    return counts


def exported_matches_eager(arch, size, policy=None):
    """Export `arch`'s int8 forward at batch 2; the program on the serving
    weights is bit-equal to the eager model, and its graph holds one
    int8_conv op per int8 conv (SegNet: 4 pools and 4 unpools) -> the bytes."""
    qm, x = quantized(arch, size, policy)
    ref = qm(x)
    data = deploy.export_serving(qm, 2, size)
    got = deploy.load_serving(data)(deploy.serving_weights(qm), x)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    want = {"int8_conv": INT8_CONVS[arch]}
    if arch == "segnet":
        want.update(max_pool_with_indices=4, max_unpool=4)
    assert op_counts(data) == want
    return data


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------

CONV_ARGS = {  # kh, kw, [top, bottom, left, right], dilation, stride, lhs, x_step, act, dtype, out_step
    "values_relu": (3, 3, [1, 1, 1, 1], 1, 1, None, 0.0123, "relu", torch.bfloat16, None),
    "codes_leaky_stride2": (3, 3, [1, 2, 0, 1], 1, 2, None, 0.0123, "leaky", torch.float32, 0.0371),
    "dilated": (3, 3, [2, 2, 2, 2], 2, 1, None, 0.0123, "none", torch.float32, None),
    "transposed_codes": (3, 3, [1, 2, 1, 2], 1, 1, [2, 2], 0.0123, "relu", torch.bfloat16, 0.02),
}


@pytest.mark.parametrize("case", sorted(CONV_ARGS))
def test_int8_conv_op_is_the_plain_version(case):
    rng = np.random.default_rng(len(case))
    x = torch.from_numpy(rng.integers(-127, 128, (2, 6, 7, 32), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, 32, 16), dtype=np.int8))
    ws = torch.from_numpy((rng.random(16) * 1e-3).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    kh, kw, (pt, pb, pl, pr), dil, stride, lhs, x_step, act, dtype, out_step = CONV_ARGS[case]
    args = (x, wq, ws, b) + CONV_ARGS[case]
    got = int8_conv_op(*args)
    ref = int8_conv_plain(x, wq, x_step, ws, b, ((pt, pb), (pl, pr)), dil, lhs, dtype, act,
                          out_step, stride)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    assert set(torch.library.opcheck(int8_conv_op, args).values()) == {"SUCCESS"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_pool_ops_are_the_plain_versions(dtype):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-3, 4, (2, 6, 8, 5)).astype(np.float32)).to(dtype)  # ties
    vals, codes = unpool.max_pool_with_indices_op(x)
    r_vals, r_codes = unpool.max_pool_with_indices_plain(x)
    assert vals.dtype == dtype and torch.equal(vals, r_vals) and torch.equal(codes, r_codes)
    out = unpool.max_unpool_op(vals, codes)
    assert torch.equal(out, unpool.max_unpool_plain(r_vals, r_codes))
    for op, args in ((unpool.max_pool_with_indices_op, (x,)), (unpool.max_unpool_op, (vals, codes))):
        assert set(torch.library.opcheck(op, args).values()) == {"SUCCESS"}


# ---------------------------------------------------------------------------
# Programs of the UNet, the Robust U-Net and SegNet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def unet():
    """The UNet at 32^2 and its exported program's bytes."""
    qm, x = quantized("unet", 32)
    return qm, x, deploy.export_serving(qm, 2, 32)


@pytest.mark.parametrize("arch", ["robust_unet", "segnet"])
def test_exported_forward_equals_eager(arch):
    exported_matches_eager(arch, 32)


def test_serving_export_round_trip(unet):
    qm, x, data = unet
    assert isinstance(data, bytes) and data
    assert op_counts(data) == {"int8_conv": INT8_CONVS["unet"]}
    fn = deploy.load_serving(data)
    weights = deploy.serving_weights(qm)
    assert torch.equal(fn(weights, x), qm(x))  # the UNet's logits


@pytest.mark.parametrize("shape", [(3, 32, 32, 3), (2, 64, 64, 3), (1, 32, 32, 3)])
def test_export_rejects_wrong_shape(unet, shape):
    qm, _, data = unet
    fn = deploy.load_serving(data)
    with pytest.raises(Exception):
        fn(deploy.serving_weights(qm), torch.zeros(shape))


def test_program_holds_no_weights_and_loads_without_fallback(unet):
    """The `.pt2` carries the graph and the sites' 0-d step constants, no
    weight; loading it takes no `weights_only=False` fallback."""
    qm, _, data = unet
    assert len(data) < 4 * 2**20
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        program = torch.export.load(io.BytesIO(data))
        deploy.load_serving(data)
    assert not [w for w in seen if "weights_only" in str(w.message)], [str(w.message) for w in seen]
    assert program.example_inputs is None and not program.state_dict
    assert program.constants and all(t.ndim == 0 for t in program.constants.values())
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       torch.utils._pytree.tree_leaves(deploy.serving_weights(qm)))
    assert len(data) < weight_bytes / 10


def test_serving_bundle(unet, tmp_path):
    qm, x, _ = unet
    d = tmp_path / "bundle"
    deploy.save_serving_bundle(d, qm, batch_size=2, image_size=32)
    assert sorted(p.name for p in d.iterdir()) == ["serving.json", "serving_fn.pt2", "weights.npz"]
    meta = json.loads((d / "serving.json").read_text())
    assert meta == {"arch": "unet", "batch_size": 2, "image_size": 32, "device": "cpu",
                    "torch": torch.__version__}
    fn, back = deploy.load_serving_bundle(d, device="cpu")
    assert back.arch == "unet" and back.scales == qm.scales
    assert torch.equal(fn(x.numpy()), qm(x))


def test_serving_bundle_weights_live_on_device(unet, tmp_path):
    """The bundle's fn closes over the serving weights, already on the
    requested device (the counterpart of `tests/test_deploy.py:85`)."""
    qm, x, _ = unet
    d = tmp_path / "bundle"
    deploy.save_serving_bundle(d, qm, batch_size=2, image_size=32)
    fn, back = deploy.load_serving_bundle(d, device="cpu")
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    leaves = torch.utils._pytree.tree_leaves(cells["weights"].cell_contents)
    assert leaves and all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in leaves)
    assert back.device.type == "cpu"


def test_bundle_refusals(unet, tmp_path):
    qm, _, _ = unet
    jax_dir = tmp_path / "jax_bundle"  # what the JAX package's save_serving_bundle writes
    jax_dir.mkdir()
    deploy.save_quantized(jax_dir / "weights.npz", qm)
    (jax_dir / "serving_fn.bin").write_bytes(b"\0")
    with pytest.raises(FileNotFoundError, match="serving_fn.pt2.*serving_fn.bin"):
        deploy.load_serving_bundle(jax_dir, device="cpu")
    d = tmp_path / "bundle"
    deploy.save_serving_bundle(d, qm, batch_size=2, image_size=32)
    with pytest.raises(ValueError, match="exported for cpu and does not run on cuda"):
        deploy.load_serving_bundle(d, device="cuda")
    meta = json.loads((d / "serving.json").read_text())
    (d / "serving.json").write_text(json.dumps(dict(meta, device="cuda")))
    with pytest.raises(ValueError, match="exported for cuda and does not run on cpu"):
        deploy.load_serving_bundle(d, device="cpu")


# ---------------------------------------------------------------------------
# The split-cat policy: halves packed once, before the export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n_split", [("unet", 4), ("robust_unet", 8)])
def test_split_cat_halves_are_packed_once(arch, n_split):
    """Under `split_cat` the serving weights carry each split conv's two
    halves, the ones `to_device` packed for `_conv_cat`, so the program's
    inputs do not depend on whether the model served before and its graph
    slices no weight; the program is bit-equal to eager."""
    policy = {"split_cat": True}
    qm, x = quantized(arch, 32, policy)
    before = deploy.serving_weights(qm)
    ref = qm(x)  # reads the halves; packs nothing
    after = deploy.serving_weights(qm)
    spec = torch.utils._pytree.tree_structure
    assert spec(before) == spec(after)
    cached = [(e["_split"], c0) for e, c0 in quant.split_cat_entries(qm.params, arch)]
    assert len(cached) == n_split
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            if "split" in node:
                flat[path] = node["split"]
            for k, v in node.items():
                walk(v, f"{path}/{k}")

    walk(after, "")
    assert len(flat) == n_split
    for halves, c0 in cached:
        lo, hi = halves[c0]
        assert any(torch.equal(s[0]["wq"], lo.hwio) and torch.equal(s[1]["wq"], hi.hwio)
                   for s in flat.values())
    data = deploy.export_serving(qm, 2, 32)
    assert torch.equal(deploy.load_serving(data)(after, x), ref)
    program = torch.export.load(io.BytesIO(data))
    inputs = {n for n in program.graph.nodes if n.op == "placeholder"}
    assert not [n for n in program.graph.nodes
                if "slice" in str(n.target) and n.args and n.args[0] in inputs]


# ---------------------------------------------------------------------------
# Eager calls on the CPU: the plain versions, gradients included
# ---------------------------------------------------------------------------


def test_eager_cpu_wrappers_keep_the_plain_gradients():
    """Run eagerly on CPU tensors, the wrappers are their plain versions,
    autograd included: only a traced call goes through the custom ops, which
    have no backward. The gradients equal the plain versions' bit for bit."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, 8, 5)).astype(np.float32))
    grads = []
    for pool, unpool_ in ((unpool.max_pool_with_indices, unpool.max_unpool),
                          (unpool.max_pool_with_indices_plain, unpool.max_unpool_plain)):
        xg = x.clone().requires_grad_()
        vals, codes = pool(xg)
        (unpool_(vals * 2, codes) * torch.arange(5.0)).sum().backward()
        grads.append(xg.grad)
    assert torch.equal(grads[0], grads[1]) and grads[0].abs().sum() > 0
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 6, 7, 32), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, 32, 16), dtype=np.int8))
    ws = torch.from_numpy((rng.random(16) * 1e-3).astype(np.float32))
    grads = []
    for conv, w in ((int8_conv, packed(wq)), (int8_conv_plain, wq)):
        bias = torch.zeros(16, requires_grad=True)
        (conv(xq, w, 0.0123, ws, bias, 1, act="relu") ** 2).sum().backward()
        grads.append(bias.grad)
    assert torch.equal(grads[0], grads[1]) and grads[0].abs().sum() > 0
