"""Model registry of the ported architectures (counterpart of
`coastline/models/registry.py`): the twelve models of the JAX registry
under the reference's display names, and the same aliases (each name
lower-cased, plus its snake_case forms). `register` adds a class under a
name and aliases, as the JAX package's decorator does."""

from coastline_torch.models.deeplabv3p import DeepLabV3Plus
from coastline_torch.models.enet import ENet
from coastline_torch.models.fastscnn import FastSCNN
from coastline_torch.models.hrnet_water import HRNetWater
from coastline_torch.models.mswnet import MSWNet
from coastline_torch.models.pspnet import PSPNet
from coastline_torch.models.robust_unet import RobustUNet
from coastline_torch.models.segformer_lite import SegFormerLite
from coastline_torch.models.segnet import SegNet
from coastline_torch.models.unet import UNet
from coastline_torch.models.waternet import WaterNet
from coastline_torch.models.yoloseg import YOLOSeg

_ENTRIES = (
    ("Robust UNet", RobustUNet, ("robust_unet", "robustunet")),
    ("UNet", UNet, ("unet",)),
    ("DeepLabV3+", DeepLabV3Plus, ("deeplabv3plus", "deeplabv3p", "deeplab")),
    ("YOLO-SEG", YOLOSeg, ("yoloseg", "yolo_seg")),
    ("SegNet", SegNet, ("segnet",)),
    ("PSPNet", PSPNet, ("pspnet",)),
    ("Fast-SCNN", FastSCNN, ("fastscnn", "fast_scnn")),
    ("ENet", ENet, ("enet",)),
    ("WaterNet", WaterNet, ("waternet",)),
    ("MSWNet", MSWNet, ("mswnet",)),
    ("HRNet-Water", HRNetWater, ("hrnetwater", "hrnet_water")),
    ("SegFormer-Lite", SegFormerLite, ("segformerlite", "segformer_lite")),
)
_REGISTRY = {name: cls for name, cls, _ in _ENTRIES}
_ALIASES = {a: name for name, _, aliases in _ENTRIES for a in (name.lower(), *aliases)}


def register(name: str, *aliases: str):
    """Class decorator: `create_model(name)` (or any alias, in any case)
    builds the class (`coastline/models/registry.py:14-21`)."""
    def wrap(cls):
        _REGISTRY[name] = cls
        for a in (name.lower(), *aliases):
            _ALIASES[a.lower()] = name
        return cls

    return wrap


def available_models():
    return sorted(_REGISTRY)


def canonical_name(name: str) -> str:
    """A registry name or alias -> its display name; unknown names pass
    through unchanged (callers decide how to fail)."""
    return _ALIASES.get(name.lower(), name)


def model_class(name: str):
    """The class of a model by name or alias; a KeyError that lists the
    registry's names for any other name."""
    canonical = canonical_name(name)
    if canonical not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {available_models()}")
    return _REGISTRY[canonical]


def create_model(name: str, **kwargs):
    """Build a model by name or alias; `kwargs` go to its constructor
    (`n_classes`, `dtype`; `base` and `remat` for the Robust U-Net,
    `reference_ordering` for SegFormer-Lite)."""
    return model_class(name)(**kwargs)
