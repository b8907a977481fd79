"""Port kernels vs the JAX package's TPU kernels and cv2 (CPU, small sizes).

On the CPU the kernel wrappers run their plain PyTorch versions; those are
held here against cv2 and against the Pallas kernels in interpret mode. The
CUDA kernels themselves are held against the same plain versions on the card
(tests/test_torch_cuda.py and `chip_smoke.py`).

Tolerances:
  * dilation: exact (a max of the same inputs, no rounding anywhere);
  * fused conv: both sides round the same float32 sums of exact bf16
    products once to bf16, so they may differ by the last bf16 bit where
    the two summation orders straddle a rounding boundary: |d| <= 2^-7 |ref|
    (one bf16 ulp, relative) + 1e-3 absolute for near-zero outputs.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coastline.infer.morphology import elliptical_kernel as jax_elliptical_kernel
from coastline.pallas.fused_conv import fused_conv3x3_bn_relu as jax_fused_conv
from coastline.pallas.morphology import dilate_disk as jax_dilate_disk
from coastline_torch.infer.morphology import elliptical_kernel
from coastline_torch.kernels.fused_conv import (fused_conv3x3_bn_relu,
                                                fused_conv3x3_bn_relu_plain, pack_weights)
from coastline_torch.kernels.morphology import (dilate_disk, dilate_disk_plain,
                                                se_row_groups)

torch.set_num_threads(1)


def _port_dilate(mask, ker):
    return dilate_disk(torch.from_numpy(np.ascontiguousarray(mask)), ker).numpy()


@pytest.mark.parametrize("size", range(1, 60))
def test_elliptical_kernel_matches_cv2(size):
    ref = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))
    np.testing.assert_array_equal(elliptical_kernel(size), ref)


def test_se_row_groups_sorted_and_nested():
    """Disk row groups come sorted by width and each interval contains the
    previous one, the order the kernel grows its windows in."""
    for size in (2, 5, 20, 41):
        groups = se_row_groups(elliptical_kernel(size))
        widths = [hi - lo for (lo, hi), _ in groups]
        assert widths == sorted(widths)
        for ((lo0, hi0), _), ((lo1, hi1), _) in zip(groups, groups[1:]):
            assert lo1 <= lo0 and hi1 >= hi0
        assert sum(len(s) for _, s in groups) == int(elliptical_kernel(size).any(1).sum())
    with pytest.raises(ValueError, match="not contiguous"):
        se_row_groups(np.array([[1, 0, 1]], np.uint8))


@pytest.mark.parametrize("size", [3, 5, 20, 41])
def test_dilate_matches_cv2_and_jax_kernel(size):
    rng = np.random.default_rng(size)
    mask = (rng.random((64, 96)) < 0.05).astype(np.uint8)
    ker = elliptical_kernel(size)
    out = _port_dilate(mask, ker)
    np.testing.assert_array_equal(out, cv2.dilate(mask, ker, iterations=1))
    np.testing.assert_array_equal(
        out, np.asarray(jax_dilate_disk(mask, jax_elliptical_kernel(size), interpret=True)))


def test_dilate_batch_and_grayscale():
    rng = np.random.default_rng(0)
    ker = elliptical_kernel(7)
    batch = rng.integers(0, 255, (3, 40, 40), dtype=np.uint8)
    out = _port_dilate(batch, ker)
    assert out.dtype == np.uint8 and out.shape == batch.shape
    for i in range(3):
        np.testing.assert_array_equal(out[i], cv2.dilate(batch[i], ker, iterations=1))
    np.testing.assert_array_equal(out, np.asarray(jax_dilate_disk(batch, ker, interpret=True)))
    outf = dilate_disk(torch.from_numpy(batch.astype(np.float32)), ker).numpy()
    assert outf.dtype == np.float32
    np.testing.assert_array_equal(outf, out.astype(np.float32))


@pytest.mark.parametrize("shape", [(16, 128), (24, 256), (8, 512)])
def test_dilate_lane_aligned_width_right_edge(shape):
    """Widths that are multiples of 128 with right-edge seeds: the class of
    input where the TPU kernel once dropped the right edge's window."""
    rng = np.random.default_rng(1)
    ker = elliptical_kernel(5)
    mask = (rng.random(shape) < 0.05).astype(np.uint8)
    mask[:, -1] = 1
    out = _port_dilate(mask, ker)
    np.testing.assert_array_equal(out, cv2.dilate(mask, ker, iterations=1))
    np.testing.assert_array_equal(out, np.asarray(jax_dilate_disk(mask, ker, interpret=True)))


@pytest.mark.parametrize("shape,size", [((1500, 700), 20), ((1030, 1024), 41),
                                        ((2200, 480), 5), ((3000, 333), 7),
                                        ((64, 10980), 20), ((48, 25600), 5)])
def test_dilate_banded_shapes_match_cv2(shape, size):
    """The shapes the TPU kernel bands (rows, or rows and columns); the port
    has no banding, one tile-and-halo scheme covers them all."""
    rng = np.random.default_rng(shape[0] + shape[1] + size)
    ker = elliptical_kernel(size)
    mask = (rng.random(shape) < 0.02).astype(np.uint8)
    mask[:, 0] = 1
    mask[:, -1] = 1
    mask[-1, :] = 1
    np.testing.assert_array_equal(_port_dilate(mask, ker), cv2.dilate(mask, ker, iterations=1))


def test_dilate_plain_rect_and_non_nested_groups():
    """A rectangle (one group) and an SE whose row intervals are not nested
    (a window is rebuilt, not grown) stay exact against cv2."""
    rng = np.random.default_rng(3)
    mask = rng.integers(0, 255, (33, 47), dtype=np.uint8)
    rect = np.ones((3, 6), np.uint8)
    skew = np.array([[1, 1, 0, 0, 0], [0, 0, 1, 1, 1], [0, 1, 1, 0, 0]], np.uint8)
    for ker in (rect, skew):
        np.testing.assert_array_equal(_port_dilate(mask, ker), cv2.dilate(mask, ker))


def test_dilate_wrapper_rejects_bad_inputs():
    ker = elliptical_kernel(5)
    with pytest.raises(TypeError):
        dilate_disk(torch.zeros(4, 4, dtype=torch.int64), ker)
    with pytest.raises(ValueError):
        dilate_disk(torch.zeros(4, dtype=torch.uint8), ker)


def _conv_inputs(seed=0, shape=(2, 16, 128, 64)):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, w, scale, bias


@pytest.mark.parametrize("relu", [True, False])
def test_fused_conv_plain_matches_tpu_kernel(relu):
    x, w, scale, bias = _conv_inputs()
    ref = np.asarray(jax_fused_conv(jnp.asarray(x, jnp.bfloat16), w, scale, bias,
                                    relu=relu, interpret=True), np.float32)
    got = fused_conv3x3_bn_relu(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                                torch.from_numpy(scale), torch.from_numpy(bias), relu=relu)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape and got.is_contiguous()
    got = got.float().numpy()
    assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-3)
    assert np.mean(got != ref) < 0.01  # sum order flips the last bit rarely
    if relu:
        assert got.min() == 0.0


def test_fused_conv_wrapper_checks():
    x, w, scale, bias = _conv_inputs(shape=(1, 4, 8, 64))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    with pytest.raises(TypeError):
        fused_conv3x3_bn_relu(xt, wt, st, bt)  # float32 activations
    with pytest.raises(ValueError):
        fused_conv3x3_bn_relu(xt[..., :32].to(torch.bfloat16), wt, st, bt)
    before = fused_conv3x3_bn_relu.launches
    fused_conv3x3_bn_relu(xt.to(torch.bfloat16), wt, st, bt)
    assert fused_conv3x3_bn_relu.launches == before  # the plain version launches nothing


def test_pack_weights_is_the_tpu_kernels_matrix_transposed_per_tap():
    """The CUDA kernel's B operand: for tap t = 3 dy + dx, rows t * 64 + o hold
    the 64 input channels of output channel o, the transpose of each tap's
    block of the (9 * 64, 64) matrix that the TPU kernel multiplies by."""
    _, w, _, _ = _conv_inputs()
    jax_wmat = np.asarray(jnp.asarray(w, jnp.bfloat16).reshape(9 * 64, 64), np.float32)
    got = pack_weights(torch.from_numpy(w))
    assert got.dtype == torch.bfloat16 and got.shape == (9 * 64, 64) and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy().reshape(9, 64, 64),
                                  jax_wmat.reshape(9, 64, 64).transpose(0, 2, 1))
