"""Port SegNet, its weight bridge and its kernels' layout vs the JAX package (CPU).

The same numpy-seeded weights and inputs go through the JAX `SegNet` and the
port; BN running statistics and affines are drawn away from 0/1 so a wrong
fold or epsilon shows. On the CPU the pool, unpool and fused conv wrappers
run their plain versions.

Tolerance: float32 logits atol 2e-4 / rtol 1e-3, the bound the JAX package
holds itself to against torch (tests/test_torch_import.py:114). SegNet's
pools make that comparison discontinuous: a window whose top two distinct
inputs differ by less than the two frameworks' difference may take another
position, which moves an O(1) value. So each case first checks, level by
level, that the JAX and port pool inputs differ by less than half of every
window's gap between its top two distinct values (JAX's intermediates from
`capture_intermediates`) and that the codes are equal; input seed 2 passes
at both sizes. The gap bound is the two packages' measured difference, up
to about 5e-5 at the deepest level; a fixed 1e-4 is not reachable at 64^2,
where some 14 of the 122,880 windows fall below it, seed after seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coastline.models.segnet import SegNet as JaxSegNet
from coastline.ops.primitives import max_pool_with_indices as jax_max_pool_with_indices
from coastline.utils.torch_import import export_reference_segnet as jax_export_reference_segnet
from coastline_torch.kernels import unpool
from coastline_torch.models import segnet as segnet_module
from coastline_torch.models.registry import create_model
from coastline_torch.models.segnet import SegNet
from coastline_torch.ops import blocks
from coastline_torch.utils.torch_import import (export_reference_segnet, random_segnet_variables,
                                                segnet_state_dict)

torch.set_num_threads(1)
F32 = dict(atol=2e-4, rtol=1e-3)
SEGNET_PARAMS = 15_278_593
POOL_INPUTS = ("ConvBNAct_1", "ConvBNAct_3", "ConvBNAct_6", "ConvBNAct_9")  # enc1..enc4 outputs


@pytest.fixture(scope="module")
def variables():
    return random_segnet_variables(seed=0)


@pytest.fixture(scope="module")
def model_f32(variables):
    model = SegNet()
    model.load_state_dict(segnet_state_dict(variables), strict=True)
    return model.eval()


def _nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def test_bridge_matches_jax_exporter_and_loads_strict(variables):
    ours = export_reference_segnet(variables)
    ref = jax_export_reference_segnet(variables)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    result = SegNet().load_state_dict(segnet_state_dict(variables), strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_random_variables_have_the_jax_tree(variables):
    init = jax.eval_shape(lambda: JaxSegNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    want = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), dict(init))
    got = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), variables)
    assert got == want


def test_param_count_keys_and_seeded_init():
    model = create_model("segnet")
    assert isinstance(model, SegNet) and sum(p.numel() for p in model.parameters()) == SEGNET_PARAMS
    keys = model.state_dict()
    assert "enc4.6.weight" in keys and "dec1.3.bias" in keys and "dec1.4.weight" not in keys
    assert tuple(keys["dec1.3.weight"].shape) == (1, 64, 3, 3)
    for p, q in zip(SegNet().state_dict().values(), keys.values()):
        assert torch.equal(p, q)


def _window_gaps(a):
    """Each 2x2 window's top value minus its largest value below the top
    (inf for a window of equal values), NHWC."""
    b, h, w, c = a.shape
    win = a.reshape(b, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 5, 2, 4).reshape(-1, 4)
    top = win.max(1, keepdims=True)
    return top[:, 0] - np.where(win < top, win, -np.inf).max(1)


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 64, 64, 3)])
def test_f32_logits_match_jax(variables, model_f32, monkeypatch, shape):
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    ref, state = JaxSegNet().apply(variables, x, train=False, return_logits=True,
                                   capture_intermediates=True)
    pooled = []

    def spy(t, **kw):
        pooled.append(_nhwc(t))
        return segnet_pool(t, **kw)

    segnet_pool = segnet_module.max_pool_with_indices
    monkeypatch.setattr(segnet_module, "max_pool_with_indices", spy)
    with torch.no_grad():
        got = model_f32(_nchw(x), return_logits=True)
        probs = model_f32(_nchw(x))
    assert len(pooled) == 8
    for name, ours in zip(POOL_INPUTS, pooled):
        theirs = np.asarray(state["intermediates"][name]["__call__"][0])
        diff = np.abs(ours - theirs).max()
        assert _window_gaps(ours).min() > 2 * diff, name  # no window is near a tie
        codes = unpool.max_pool_with_indices_plain(torch.from_numpy(ours))[1]
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jax_max_pool_with_indices(theirs)[1]))
    assert got.dtype == torch.float32 and got.shape == (shape[0], 1) + shape[1:3]
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **F32)
    assert np.asarray(ref).std() > 0.2  # logits O(1): the comparison has something to see
    np.testing.assert_allclose(probs.numpy(), torch.sigmoid(got).numpy(), rtol=1e-6)


@pytest.mark.parametrize("dtype,fused_convs", [(torch.bfloat16, 2), (torch.float32, 0)])
def test_kernel_inputs_are_channels_last_views(monkeypatch, dtype, fused_convs):
    """Every pool and unpool input, and in bf16 the two 64->64 convs' input
    (`enc1` conv 2, `dec1` conv 0), is the NHWC view of a channels_last
    activation, so the kernels read it without a copy."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            tensors = args[:2] if name == "max_unpool" else args[:1]  # (vals, codes) or x
            calls.append((name, tuple(t.is_contiguous() for t in tensors), tuple(tensors[0].shape)))
            return fn(*args, **kw)
        return wrapped

    for name in ("max_pool_with_indices", "max_unpool"):
        monkeypatch.setattr(unpool, name, spy(name, getattr(unpool, name)))
    monkeypatch.setattr(blocks, "fused_conv3x3_bn_relu", spy("conv", blocks.fused_conv3x3_bn_relu))
    with torch.no_grad():
        SegNet(dtype=dtype).eval()(torch.zeros(1, 3, 32, 32))
    pools = [c for c in calls if c[0] == "max_pool_with_indices"]
    unpools = [c for c in calls if c[0] == "max_unpool"]
    convs = [c for c in calls if c[0] == "conv"]
    assert [c[1:] for c in pools] == [((True,), (1, 32, 32, 64)), ((True,), (1, 16, 16, 128)),
                                      ((True,), (1, 8, 8, 256)), ((True,), (1, 4, 4, 512))]
    assert [c[1:] for c in unpools] == [((True, True), (1, 2, 2, 512)), ((True, True), (1, 4, 4, 256)),
                                        ((True, True), (1, 8, 8, 128)), ((True, True), (1, 16, 16, 64))]
    assert [c[1:] for c in convs] == [((True,), (1, 32, 32, 64))] * fused_convs


@pytest.mark.parametrize("size", [36, 40, 24])
def test_sizes_not_divisible_by_16_raise(size):
    with pytest.raises(ValueError, match="even H and W"):
        SegNet().eval()(torch.zeros(1, 3, size, size))
