"""The port's row split (a mesh's `space` axis) against one process and JAX:
halo fetches, a conv stack at an uneven height, every registry model's
eval forward, the kernels' plain versions, a scene, the int8 refusal (CPU,
two gloo ranks on `make_mesh(2, space=2)`).

One two-rank group (`torch_space_workers.model_checks`) runs every check:
  * `fetch_rows` at H = 33 (17 + 16 rows) for a conv, a dilated conv and a
    stride-2 window, and at H = 4 for a dilation-4 halo wider than a
    neighbour's 2 rows (rows from beyond it and from outside the image):
    each rank's rows equal the padded map's, and the gradient sent back
    equals one process's;
  * `tests/test_parallel.py:104-137`'s conv stack at H = 33 (dilated and
    strided convs at the ragged seam): forward and gradients against one
    process, forward against JAX;
  * every registry model's float32 eval forward at 64^2 (Fast-SCNN also at
    66 rows, HRNet-Water at 72: odd shares at their deeper levels) against
    one process at `test_parallel.py`'s atol 2e-5 / rtol 1e-5; YOLO-SEG
    against JAX's `make_mesh(8, space=2)` forward at the bridge's 2e-4 / 1e-3;
  * the kernel wrappers' plain versions inside the row split;
  * `predict_scene` bit-identical to one process (`test_parallel.py:581-608`),
    and an int8 forward and an int8 scene refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_space_workers as workers
from coastline.models.yoloseg import YOLOSeg as JaxYOLOSeg
from coastline.ops.primitives import Conv as JaxConv
from coastline.parallel.mesh import make_mesh as jax_make_mesh
from coastline.utils import torch_import as jax_import
from coastline_torch.data.synthetic import synthetic_dataset_arrays
from coastline_torch.parallel.launch import run

torch.set_num_threads(1)
SCENE = (np.random.default_rng(7).integers(0, 255, (150, 200, 3), dtype=np.uint8), 64, 4, 16, 5)


@pytest.fixture(scope="module")
def ranks():
    return run(workers.model_checks, 2, device="cpu", args=(SCENE,))


@pytest.mark.parametrize("case", ["h33_conv", "h33_dilated", "h33_stride2", "h4_wide"])
def test_fetch_rows_matches_one_process(ranks, case):
    for r in ranks:
        got = r["fetch"][case]
        assert got["fetched"], (case, got)
        assert got["grad_err"] == 0.0, (case, got)
    assert [r["fetch"]["h33_conv"]["share"] for r in ranks] == [(0, 17), (17, 33)]


def test_halo_wider_than_a_share(ranks):
    """A dilation-4 conv on 4 rows, 2 a rank: every rank reads rows of the
    other and of the zero padding."""
    assert ranks[1]["fetch"]["h4_wide"]["needs"] == (-2, 8)
    for r in ranks:
        assert r["wide_conv"] < 1e-6


def test_conv_stack_uneven_height_matches_one_process(ranks):
    for r in ranks:
        s = r["stack"]
        np.testing.assert_allclose(s["out"], s["ref"], atol=2e-5, rtol=1e-5)
        assert s["x_grad_err"] < 1e-6
        assert s["w_grad_err"] < 1e-4


class _Stack(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = jax.nn.relu(JaxConv(8, 3, 1, 1)(x))
        x = jax.nn.relu(JaxConv(8, 3, 1, 2, dilation=2)(x))
        return JaxConv(4, 3, 2, 1)(x)


def test_conv_stack_uneven_height_matches_jax(ranks):
    """The same weights in JAX's stack (`tests/test_parallel.py:104-137`)."""
    w = ranks[0]["stack"]["weights"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 33, 40)).astype(
        np.float32))
    params = {f"Conv_{i}": {"Conv_0": {
        "kernel": jnp.asarray(w[f"c{i + 1}.weight"].transpose(2, 3, 1, 0)),
        "bias": jnp.asarray(w[f"c{i + 1}.bias"])}} for i in range(3)}
    xj = jnp.asarray(x.numpy().transpose(0, 2, 3, 1))
    template = _Stack().init(jax.random.PRNGKey(0), xj)["params"]
    assert jax.tree_util.tree_structure(template) == jax.tree_util.tree_structure(params)
    ref = np.asarray(_Stack().apply({"params": params}, xj)).transpose(0, 3, 1, 2)
    for r in ranks:
        np.testing.assert_allclose(r["stack"]["out"], ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("case", workers.MODEL_CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_model_eval_forward_matches_one_process(ranks, case):
    got0, ref0 = ranks[0]["models"][case]
    got1, ref1 = ranks[1]["models"][case]
    ref = ref0 if ref0 is not None else ref1
    assert got0.shape == ref.shape
    np.testing.assert_array_equal(got0, got1)  # gathered whole on both ranks
    np.testing.assert_allclose(got0, ref, atol=2e-5, rtol=1e-5)


def test_yoloseg_matches_jax_space_mesh(ranks):
    """`tests/test_parallel.py:69-101`: JAX's forward with the image rows
    sharded over `make_mesh(8, space=2)`, from the port's weights."""
    images, _ = synthetic_dataset_arrays(4, 64, seed=3)
    x = jnp.asarray(images, jnp.float32) / 255.0
    model = JaxYOLOSeg()
    variables = jax_import.import_reference_yoloseg(ranks[0]["yolo_sd"])
    mesh = jax_make_mesh(8, space=2)
    xsh = NamedSharding(mesh, P("data", "space"))

    @jax.jit
    def fwd(v, xx):
        return model.apply(v, jax.lax.with_sharding_constraint(xx, xsh), train=False)

    ref = np.asarray(fwd(jax.device_put(variables, NamedSharding(mesh, P())), x))
    for r in ranks:
        np.testing.assert_allclose(r["yolo"].transpose(0, 2, 3, 1), ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("key", [
    "fused_conv", "pool_unpool", "avg_max_pool", "fused_avg_max_pool", "cbam_tail",
    "cbam_tail_halo"])
def test_kernel_plain_versions_in_a_row_split(ranks, key):
    """The fused conv (1-row halo) and SegNet's pool and unpool (48 rows:
    the fourth pool on 3 + 3 rows) equal one process bit for bit; the CBAM
    pool's partials combine to one process's mean (bf16: the same bits)
    and max; the fused CBAM tail with its 3-row stats halo is within
    float32 rounding (bf16: the same bits); the plain tail on a halo'd
    stats map equals the unsplit tail's rows (float32: within rounding,
    the 7x7 conv's CPU sums depend on the map's height)."""
    for r in ranks:
        k = r["kernels"]
        if key in ("fused_conv", "pool_unpool"):
            assert k[key] is True
            continue
        for dt, bound in (("torch.float32", 1e-6), ("torch.bfloat16", 0.0)):
            got = k[f"{key}_{dt}"]
            if isinstance(got, list):
                assert max(got) <= max(bound, 1e-7) and got[1] == 0.0, (key, dt, got)
            else:
                assert got <= bound, (key, dt, got)


@pytest.mark.parametrize("name", sorted({**workers.PRIMITIVE_CASES, **workers.WHOLE_CASES}))
def test_primitives_in_a_row_split(ranks, name):
    """Ragged pool windows, nearest and bilinear resizes up and down, a
    3x3/2 transposed conv, and the global and adaptive pools (whole on every
    rank) at H = 13 (7 + 6 rows): the forward and the gradient of a weighted
    sum equal one process's within float32 rounding (of a whole map, each
    rank's sum counts once: the gradient is twice one process's)."""
    for r in ranks:
        err, grad_err = r["primitives"][name]
        assert err <= 1e-5 and grad_err <= 1e-5, (name, err, grad_err)


def test_int8_forward_refused_in_a_row_split(ranks):
    for r in ranks:
        assert r["int8_refused"] and "queue 1" in r["int8_refused"]
        assert r["scene"]["int8_refused"] and "space" in r["scene"]["int8_refused"]


def test_scene_bit_identical_to_one_process(ranks):
    """`tests/test_parallel.py:581-608`'s scene (150 x 200, tiles of 64,
    overlap 16) with the band, each tile's rows split over two ranks."""
    for r in ranks:
        s = r["scene"]
        assert s["mask"].shape == (150, 200) and s["mask"].any()
        np.testing.assert_array_equal(s["mask"], s["ref_mask"])
        np.testing.assert_array_equal(s["band"], s["ref_band"])
