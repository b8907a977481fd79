"""Model registry of the ported architectures (counterpart of
`coastline/models/registry.py`): the reference's display names, and the
same snake_case aliases."""

from coastline_torch.models.robust_unet import RobustUNet
from coastline_torch.models.segnet import SegNet
from coastline_torch.models.unet import UNet

_REGISTRY = {"Robust UNet": RobustUNet, "SegNet": SegNet, "UNet": UNet}
_ALIASES = {"robust unet": "Robust UNet", "robust_unet": "Robust UNet",
            "robustunet": "Robust UNet", "segnet": "SegNet", "unet": "UNet"}


def available_models():
    return sorted(_REGISTRY)


def canonical_name(name: str) -> str:
    """A registry name or alias -> its display name; unknown names pass
    through unchanged (callers decide how to fail)."""
    return _ALIASES.get(name.lower(), name)


def model_class(name: str):
    """The class of a ported model by name or alias; a KeyError that lists
    the ported models for any other name (the rest of the JAX zoo too)."""
    canonical = canonical_name(name)
    if canonical not in _REGISTRY:
        raise KeyError(f"unknown model {name!r} (not ported); available: {available_models()}")
    return _REGISTRY[canonical]


def create_model(name: str, **kwargs):
    """Build a ported model by name or alias; `kwargs` go to its constructor
    (`n_classes`, `dtype`, and `base` and `remat` for the Robust U-Net)."""
    return model_class(name)(**kwargs)
