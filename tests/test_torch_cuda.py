"""CUDA kernels vs their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one. They import neither jax
nor `coastline`, so they run on a machine that has only the port's
dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: dilation is exact; the fused conv may differ from its plain
version by one bf16 ulp (2^-7 relative) + 1e-3, the same float32 sums taken
in another order before one bf16 rounding.
"""

import numpy as np
import pytest
import torch

from coastline_torch.infer.morphology import elliptical_kernel
from coastline_torch.kernels.fused_conv import (fused_conv3x3_bn_relu,
                                                fused_conv3x3_bn_relu_plain)
from coastline_torch.kernels.morphology import dilate_disk, dilate_disk_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels do not run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape,size", [((8, 512, 512), 20), ((3, 97, 301), 41),
                                        ((1, 64, 10980), 20), ((2, 40, 40), 1),
                                        ((1, 130, 129), 2), ((2, 5, 7), 9)])
def test_dilate_kernel_matches_plain(dev, shape, size):
    rng = np.random.default_rng(size)
    ker = elliptical_kernel(size)
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    for t in (x, (x > 250).to(torch.uint8), x.float(), x[0]):
        before = dilate_disk.launches
        got = dilate_disk(t, ker)
        torch.cuda.synchronize()
        assert dilate_disk.launches == before + 1
        assert got.dtype == t.dtype and got.shape == t.shape
        assert torch.equal(got.cpu(), dilate_disk_plain(t.cpu(), ker))


def test_dilate_kernel_non_nested_se(dev):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (2, 70, 150), dtype=np.uint8)).to(dev)
    skew = np.array([[1, 1, 0, 0, 0], [0, 0, 1, 1, 1], [0, 1, 1, 0, 0]], np.uint8)
    assert torch.equal(dilate_disk(x, skew).cpu(), dilate_disk_plain(x.cpu(), skew))


def _conv_case(shape, dev, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)).to(dev)
    scale = torch.from_numpy((rng.standard_normal(c) * 0.1 + 1).astype(np.float32)).to(dev)
    bias = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32)).to(dev)
    return x, w, scale, bias


@pytest.mark.parametrize("shape", [(2, 16, 128, 64), (1, 7, 45, 64), (3, 33, 17, 64)])
@pytest.mark.parametrize("relu", [True, False])
def test_fused_conv_kernel_matches_plain(dev, shape, relu):
    x, w, scale, bias = _conv_case(shape, dev)
    before = fused_conv3x3_bn_relu.launches
    got = fused_conv3x3_bn_relu(x, w, scale, bias, relu=relu)
    torch.cuda.synchronize()
    assert fused_conv3x3_bn_relu.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    ref = fused_conv3x3_bn_relu_plain(x.cpu(), w.cpu(), scale.cpu(), bias.cpu(), relu=relu)
    got, ref = got.float().cpu(), ref.float()
    assert torch.all((got - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-3)


def test_fused_conv_rejects_non_contiguous(dev):
    x, w, scale, bias = _conv_case((1, 8, 16, 64), dev)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv3x3_bn_relu(x.transpose(1, 2), w, scale, bias)


@pytest.mark.parametrize("batch,tta,forwards", [(2, False, 1), (1, False, 1), (2, True, 8)])
def test_unet_bf16_on_card_launches_the_fused_conv_twice(dev, batch, tta, forwards):
    """Two launches a forward (8 forwards with the square-input TTA, whose
    flipped and transposed inputs must still reach the kernel as NHWC)."""
    from coastline_torch.infer.extract import CoastlineExtractor
    from coastline_torch.utils.torch_import import random_unet_variables

    v = random_unet_variables(seed=0)
    x = np.random.default_rng(1).integers(0, 256, (batch, 64, 64, 3), dtype=np.uint8)
    gpu = CoastlineExtractor(variables=v, dtype=torch.bfloat16, image_size=64, tta=tta)
    cpu = CoastlineExtractor(variables=v, dtype=torch.bfloat16, image_size=64, tta=tta,
                             device="cpu")
    before = fused_conv3x3_bn_relu.launches
    got = gpu.predict_masks_batch(x)
    assert fused_conv3x3_bn_relu.launches == before + 2 * forwards
    assert np.mean(got == cpu.predict_masks_batch(x)) >= 0.95
