"""SegNet's indexed pool and unpool in the port vs the JAX package (CPU).

On the CPU the kernel wrappers run their plain PyTorch versions; those are
held here against `coastline/pallas/unpool.py` in interpret mode (as
tests/test_pallas.py runs it) and against the XLA formulation SegNet runs,
`coastline/ops/primitives.py:340-375`. The CUDA kernels are held against the
same plain versions on the card (tests/test_torch_cuda.py and
`chip_smoke.py`).

Tolerance: none. Codes are bit-equal, and so are the values, the sign of a
zero included, against the XLA formulation. The Pallas kernels in interpret
mode are compared by value (`==`, finite inputs): the interpreted unpool
selects rather than multiplies in float32, so its zeros are all +0.0 where
the XLA formulation, which the port follows, writes -0.0 under a negative
value and NaN around an inf.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coastline.ops import primitives as jax_primitives
from coastline.pallas.unpool import max_pool_with_indices_pallas, max_unpool_pallas
from coastline_torch.kernels import unpool
from coastline_torch.kernels.unpool import (max_pool_with_indices, max_pool_with_indices_plain,
                                            max_unpool, max_unpool_plain)
from coastline_torch.ops import primitives

torch.set_num_threads(1)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tie_input(shape, seed=0):
    """A float32 activation, representable in bf16, with the ties a ReLU
    network makes: ReLU zeros (whole windows of them), equal non-zero values
    at window positions 0 and 3 in channels 0::3, negated channels 1::5 (-0.0
    ties and negative maxima), zeros of random sign in channels 2::7."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    x = np.maximum(rng.normal(size=shape), 0.0).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    xw = x.reshape(b, h // 2, 2, w // 2, 2, c)
    xw[:, :, 1, :, 1, ::3] = xw[:, :, 0, :, 0, ::3]
    x[..., 1::5] = -x[..., 1::5]
    x[..., 2::7] = np.where(rng.random(x[..., 2::7].shape) < 0.5, 0.0, -0.0)
    return x


def _bits(a):
    """A float array's bit patterns (NaN collapsed to one pattern) as int32."""
    a = np.asarray(a, np.float32)
    return np.where(np.isnan(a), np.int32(0x7FC00000), a.view(np.int32))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1, 20, 64])
def test_plain_pool_and_unpool_match_jax(dtype, c):
    jdt, tdt = DTYPES[dtype]
    x = _tie_input((2, 8, 12, c), seed=c)
    j_vals, j_codes = jax_primitives.max_pool_with_indices(jnp.asarray(x, jdt))
    p_vals, p_codes = max_pool_with_indices_pallas(jnp.asarray(x, jdt), interpret=True)
    vals, codes = max_pool_with_indices_plain(torch.from_numpy(x).to(tdt))
    assert vals.dtype == tdt and codes.dtype == torch.int32 and codes.shape == (2, 4, 6, c)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(p_codes))
    np.testing.assert_array_equal(_bits(_np(vals)), _bits(j_vals))
    np.testing.assert_array_equal(_np(vals), np.asarray(p_vals, np.float32))
    assert np.any(np.asarray(j_codes) != 0)  # ties go first, but not every window ties

    out = max_unpool_plain(vals, codes)
    j_out = jax_primitives.max_unpool(j_vals, j_codes)
    assert out.dtype == tdt and out.shape == x.shape and out.is_contiguous()
    np.testing.assert_array_equal(_bits(_np(out)), _bits(j_out))
    np.testing.assert_array_equal(_np(out), np.asarray(max_unpool_pallas(j_vals, j_codes,
                                                                         interpret=True), np.float32))


def test_ties_take_the_first_position_and_plus_zero():
    windows = [[0.0, 0.0, 0.0, 0.0],  # ReLU zeros: code 0
               [-0.0, 0.0, -1.0, -2.0],  # -0 first: code 0, value +0 (XLA's max)
               [-1.0, -0.0, -0.0, -3.0],  # only -0: code 1, value -0
               [2.0, 1.0, 2.0, 2.0],  # equal pair: code 0
               [1.0, 3.0, 2.0, 3.0]]
    x = np.array(windows, np.float32).reshape(1, len(windows), 2, 2, 1).transpose(
        0, 2, 1, 3, 4).reshape(1, 2, 2 * len(windows), 1)
    vals, codes = max_pool_with_indices_plain(torch.from_numpy(x))
    j_vals, j_codes = jax_primitives.max_pool_with_indices(jnp.asarray(x))
    assert codes.flatten().tolist() == [0, 0, 1, 0, 1] == np.asarray(j_codes).flatten().tolist()
    assert _np(vals).flatten().tolist() == [0.0, 0.0, -0.0, 2.0, 3.0]
    assert torch.signbit(vals).flatten().tolist() == [False, False, True, False, False]
    np.testing.assert_array_equal(_bits(_np(vals)), _bits(j_vals))


def test_nan_is_the_maximum_and_the_first_nan_wins():
    x = np.array([[1.0, np.nan, 3.0, np.nan], [np.nan, 5.0, np.nan, 0.0],
                  [-np.inf, -np.inf, -np.inf, -np.inf]], np.float32)
    x = x.reshape(1, 3, 2, 2, 1).transpose(0, 2, 1, 3, 4).reshape(1, 2, 6, 1)
    vals, codes = max_pool_with_indices_plain(torch.from_numpy(x))
    j_vals, j_codes = jax_primitives.max_pool_with_indices(jnp.asarray(x))
    assert codes.flatten().tolist() == [1, 0, 0] == np.asarray(j_codes).flatten().tolist()
    np.testing.assert_array_equal(_bits(_np(vals)), _bits(j_vals))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unpool_multiplies_signs_and_inf_as_jax(dtype):
    """-0.0 under a negative value, NaN around an inf or a NaN, as the XLA
    formulation's vals * onehot."""
    jdt, tdt = DTYPES[dtype]
    v = np.array([np.inf, -np.inf, np.nan, -2.0, 3.0, -0.0], np.float32).reshape(1, 2, 3, 1)
    k = np.array([1, 2, 0, 3, 0, 2], np.int32).reshape(1, 2, 3, 1)
    out = max_unpool_plain(torch.from_numpy(v).to(tdt), torch.from_numpy(k))
    ref = np.asarray(jax_primitives.max_unpool(jnp.asarray(v, jdt), jnp.asarray(k)), np.float32)
    np.testing.assert_array_equal(_bits(_np(out)), _bits(ref))
    o = _np(out)[0, :, :, 0]
    assert np.isnan(o[0, 0]) and o[0, 1] == np.inf  # inf * 0 = NaN beside the inf
    assert np.signbit(o[2, 0]) and o[3, 1] == -2.0  # -2 * 0 = -0.0 beside the -2


@pytest.mark.parametrize("size", [(9, 13), (11, 11), (10, 12)])
def test_unpool_output_size_crops_then_pads(size):
    x = _tie_input((2, 10, 12, 3), seed=7)
    j_vals, j_codes = jax_primitives.max_pool_with_indices(jnp.asarray(x))
    ref = np.asarray(jax_primitives.max_unpool(j_vals, j_codes, output_size=size))
    t = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    vals, codes = primitives.max_pool_with_indices(t)
    out = primitives.max_unpool(vals, codes, output_size=size)
    assert out.shape == (2, 3) + size and out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_bits(out.permute(0, 2, 3, 1).numpy()), _bits(ref))


def test_layer_functions_hand_nhwc_views_to_the_wrappers(monkeypatch):
    seen = []

    def spy(name):
        fn = getattr(unpool, name)

        def wrapped(*tensors):
            seen.append((name, [(t.is_contiguous(), tuple(t.shape)) for t in tensors]))
            return fn(*tensors)
        return wrapped

    for name in ("max_pool_with_indices", "max_unpool"):
        monkeypatch.setattr(unpool, name, spy(name))
    x = torch.randn(2, 8, 6, 4).contiguous(memory_format=torch.channels_last)
    vals, codes = primitives.max_pool_with_indices(x)
    y = primitives.max_unpool(vals, codes)
    assert seen == [("max_pool_with_indices", [(True, (2, 6, 4, 8))]),
                    ("max_unpool", [(True, (2, 3, 2, 8)), (True, (2, 3, 2, 8))])]
    assert vals.shape == codes.shape == (2, 8, 3, 2) and y.shape == x.shape
    assert y.is_contiguous(memory_format=torch.channels_last)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    x = torch.from_numpy(_tie_input((1, 4, 6, 16), seed=3)).to(torch.bfloat16)
    before = (max_pool_with_indices.launches, max_unpool.launches)
    vals, codes = max_pool_with_indices(x)
    out = max_unpool(vals, codes)
    assert (max_pool_with_indices.launches, max_unpool.launches) == before
    r_vals, r_codes = max_pool_with_indices_plain(x)
    assert torch.equal(codes, r_codes) and torch.equal(vals, r_vals)
    assert torch.equal(out, max_unpool_plain(r_vals, r_codes))


def test_odd_sizes_and_bad_inputs_raise():
    with pytest.raises(ValueError, match="even H and W"):
        max_pool_with_indices(torch.zeros(1, 5, 4, 3))
    with pytest.raises(ValueError, match="even H and W"):
        max_pool_with_indices_plain(torch.zeros(1, 4, 7, 3))
    with pytest.raises(ValueError, match="even H and W"):
        primitives.max_pool_with_indices(torch.zeros(1, 3, 6, 9))
    with pytest.raises(TypeError, match="int32"):
        max_unpool(torch.zeros(1, 2, 2, 3), torch.zeros(1, 2, 2, 3, dtype=torch.int64))
    with pytest.raises(ValueError, match="must match"):
        max_unpool(torch.zeros(1, 2, 2, 3), torch.zeros(1, 2, 3, 3, dtype=torch.int32))
