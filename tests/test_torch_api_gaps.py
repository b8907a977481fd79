"""The JAX package's small APIs in the port, against the JAX package (CPU):
`LOSS_REGISTRY["bce_probs"]`, `models.registry.register`, `bn_frozen` /
`set_bn_frozen`, `detect_reference_architecture`, and the extractor's
refusal of a reference `.pth` that is not a UNet.

Tolerances: `bce_on_probs` at 1e-6 (float32 logs of the same values); the
UNet's train-mode forward under `bn_frozen` at atol 2e-4 / rtol 1e-3, the
bound the JAX package holds itself to against torch
(`tests/test_torch_import.py:114`)."""

import jax
import numpy as np
import pytest
import torch

from coastline.models.unet import UNet as JaxUNet
from coastline.ops import primitives as jax_prims
from coastline.train import losses as jax_losses
from coastline.utils import torch_import as jax_import
from coastline_torch.infer.extract import CoastlineExtractor
from coastline_torch.models import registry
from coastline_torch.models.unet import UNet
from coastline_torch.ops import primitives
from coastline_torch.train import losses
from coastline_torch.utils.torch_import import (REFERENCE_SIGNATURES,
                                                detect_reference_architecture,
                                                random_unet_variables, unet_state_dict)

torch.set_num_threads(1)
F32 = dict(atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("eps", [1e-12, 0.0])
def test_bce_probs_matches_jax_with_the_log_clamp(eps):
    """Probabilities include exact 0 and 1 against both targets, so the
    -100 clamp decides those terms (with eps = 0 on both logs)."""
    rng = np.random.default_rng(3)
    probs = rng.uniform(0, 1, (2, 16, 16)).astype(np.float32)
    probs.flat[:4] = [0.0, 1.0, 0.0, 1.0]
    targets = (rng.uniform(0, 1, probs.shape) > 0.5).astype(np.float32)
    targets.flat[:4] = [1.0, 0.0, 0.0, 1.0]
    got = losses.LOSS_REGISTRY["bce_probs"](torch.from_numpy(probs), torch.from_numpy(targets),
                                            eps=eps)
    ref = jax_losses.LOSS_REGISTRY["bce_probs"](probs, targets, eps=eps)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-6)
    assert float(got) > 200.0 / probs.size  # two terms of 100 are in the mean


def test_register_adds_a_class_under_its_aliases():
    class Probe(torch.nn.Module):
        def __init__(self, width=3):
            super().__init__()
            self.width = width

    try:
        assert registry.register("Probe-Net", "probe_net", "PROBE")(Probe) is Probe
        assert "Probe-Net" in registry.available_models()
        for name in ("Probe-Net", "probe-net", "probe_net", "Probe"):
            assert registry.canonical_name(name) == "Probe-Net"
        model = registry.create_model("PROBE_NET".lower(), width=5)
        assert isinstance(model, Probe) and model.width == 5
    finally:
        registry._REGISTRY.pop("Probe-Net", None)
        for a in [a for a, n in registry._ALIASES.items() if n == "Probe-Net"]:
            del registry._ALIASES[a]
    assert "Probe-Net" not in registry.available_models()
    with pytest.raises(KeyError, match="unknown model"):
        registry.create_model("probe_net")


def _stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def test_bn_frozen_train_forward_matches_jax_and_keeps_the_statistics():
    variables = random_unet_variables(seed=0)
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32)
    with jax_prims.bn_frozen():
        ref, updated = JaxUNet(n_classes=2).apply(variables, x, train=True,
                                                   mutable=["batch_stats"])
    for a, b in zip(jax.tree_util.tree_leaves(updated["batch_stats"]),
                    jax.tree_util.tree_leaves(variables["batch_stats"])):
        np.testing.assert_array_equal(np.asarray(a), b)

    model = UNet()
    model.load_state_dict(unet_state_dict(variables), strict=True)
    model.train()
    before = _stats(model)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        with primitives.bn_frozen():
            got = model(xt)
        assert primitives._BN_FROZEN is False
        for k, v in _stats(model).items():
            assert torch.equal(v, before[k]), k
        live = model(xt)  # the control: batch statistics, running ones moved
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), **F32)
    assert float((live - got).abs().max()) > 1e-2
    assert any(not torch.equal(v, before[k]) for k, v in _stats(model).items())


def test_bn_frozen_restores_the_flag_after_an_error():
    primitives.set_bn_frozen(True)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            with primitives.bn_frozen(False):
                assert primitives._BN_FROZEN is False
                raise RuntimeError("boom")
        assert primitives._BN_FROZEN is True
    finally:
        primitives.set_bn_frozen(False)
    with pytest.raises(RuntimeError):
        with primitives.bn_frozen():
            assert primitives._BN_FROZEN is True
            raise RuntimeError("again")
    assert primitives._BN_FROZEN is False


@pytest.mark.parametrize("name", sorted(jax_import.REFERENCE_EXPORTERS))
def test_detect_reference_architecture_matches_jax(name):
    """The port's state_dict of each model (its seeded init), and JAX's
    export of the same tree, through the JAX importer."""
    sd = registry.create_model(name).state_dict()
    importer = jax_import.REFERENCE_IMPORTERS[name][1]
    exported = jax_import.REFERENCE_EXPORTERS[name](importer({k: v.numpy()
                                                              for k, v in sd.items()}))
    assert set(exported) == set(sd)
    assert detect_reference_architecture(sd) == \
        jax_import.detect_reference_architecture(exported) == name


def test_detect_refuses_an_unknown_tree_as_jax_does():
    assert REFERENCE_SIGNATURES == {k: v[0] for k, v in jax_import.REFERENCE_IMPORTERS.items()}
    tree = {"head.weight": np.zeros(1), "body.0.bias": np.zeros(1)}
    with pytest.raises(ValueError) as ours:
        detect_reference_architecture(tree)
    with pytest.raises(ValueError) as theirs:
        jax_import.detect_reference_architecture(tree)
    assert str(ours.value) == str(theirs.value)


def test_extractor_refuses_a_segnet_pth(tmp_path):
    path = str(tmp_path / "segnet.pth")
    torch.save(registry.create_model("SegNet").state_dict(), path)
    with pytest.raises(ValueError, match="'SegNet' checkpoint") as err:
        CoastlineExtractor(torch_checkpoint=path, image_size=32, device="cpu")
    assert path in str(err.value)
