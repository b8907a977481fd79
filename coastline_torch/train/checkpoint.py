"""Full-state checkpoints with the reference's best-by-IoU export
(counterpart of `coastline/train/checkpoint.py`, Orbax there, `torch.save`
here).

A step's checkpoint holds the whole train state: the model's state_dict
(parameters and BN statistics), the Adam state, the plateau, the step
count and the device generator's state, so a run resumes bit for bit. It
is written to a temporary file and renamed into place, so a crash leaves
the previous one. `maybe_save_best` writes `best/model.pth`, the bare
state_dict in the reference's layout (`train_water_segmentation.py:
597-606`), which loads with `strict=True` into the port's UNet, the
reference's, and `CoastlineExtractor(torch_checkpoint=...)`.

On a mesh the files stay what one process writes, so a checkpoint resumes
at any world size: the full state dict (gathered from an FSDP-sharded model
with `torch.distributed.checkpoint.state_dict.get_state_dict(...,
full_state_dict=True, cpu_offload=True)`, the optimizer's state keyed by
parameter index as `Optimizer.state_dict` keys it), written by rank 0 while
the others wait; every rank reads it back and, when sharded, keeps its
shard (`set_state_dict`).
"""

import dataclasses
import os
import re
from typing import Optional

import torch

from coastline_torch.parallel import collectives
from coastline_torch.train.lr import PlateauState

_STEP_FILE = re.compile(r"^step_(\d+)\.pth$")


def _atomic_save(obj, path: str):
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _sharded(model) -> bool:
    from coastline_torch.parallel.mesh import is_sharded

    return is_sharded(model)


def _by_index(osd):
    """A full optimizer state dict keyed by parameter name -> by index."""
    names = [n for g in osd["param_groups"] for n in g["params"]]
    index = {n: i for i, n in enumerate(names)}
    return {"state": {index[n]: v for n, v in osd["state"].items()},
            "param_groups": [{**g, "params": [index[n] for n in g["params"]]}
                             for g in osd["param_groups"]]}


def _by_name(osd, model):
    """The inverse of `_by_index` for an optimizer made over `model.parameters()`."""
    names = [n for n, _ in model.named_parameters()]
    return {"state": {names[i]: v for i, v in osd["state"].items()},
            "param_groups": [{**g, "params": [names[i] for i in g["params"]]}
                             for g in osd["param_groups"]]}


def full_state_dicts(model, optimizer=None):
    """(model state_dict, optimizer state_dict or None), unsharded; for an
    FSDP-sharded model a collective every rank calls, whose result only
    rank 0 holds (the others get empty dicts)."""
    if not _sharded(model):
        return model.state_dict(), None if optimizer is None else optimizer.state_dict()
    from torch.distributed.checkpoint.state_dict import (StateDictOptions, get_model_state_dict,
                                                         get_state_dict)

    opts = StateDictOptions(full_state_dict=True, cpu_offload=True)
    if optimizer is None:
        return get_model_state_dict(model, options=opts), None
    msd, osd = get_state_dict(model, optimizer, options=opts)
    return msd, (_by_index(osd) if osd else osd)


def _wait_for_rank0(device):
    if collectives.group_size() > 1:
        collectives.barrier(device)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_iou = -1.0

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pth")

    def steps(self):
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def save(self, step: int, state, metrics: Optional[dict] = None, force: bool = False):
        """Write the full state under `step`, keeping the newest
        `max_to_keep`. An existing step raises unless `force` (a resumed run
        that crashed between this save and its sidecar re-saves the epoch)."""
        path = self._path(step)
        if os.path.exists(path) and not force:
            raise ValueError(f"checkpoint for step {step} exists in {self.directory}")
        msd, osd = full_state_dicts(state.model, state.optimizer)
        if collectives.is_main():
            _atomic_save({"model": msd, "optimizer": osd,
                          "plateau": dataclasses.asdict(state.plateau),
                          "step": state.step,
                          "generator": state.generator.get_state(),
                          "metrics": dict(metrics or {})}, path)
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        _wait_for_rank0(state.generator.device)

    def maybe_save_best(self, step: int, state, iou: float) -> bool:
        """Export `best/model.pth` when `iou` beats the best so far (the
        reference's strictly-greater rule, `train_water_segmentation.py:595`)."""
        if iou <= self.best_iou:
            return False
        self.best_iou = iou
        msd, _ = full_state_dicts(state.model)
        if collectives.is_main():
            os.makedirs(os.path.join(self.directory, "best"), exist_ok=True)
            _atomic_save({k: v.detach().cpu() for k, v in msd.items()},
                         os.path.join(self.directory, "best", "model.pth"))
        _wait_for_rank0(state.generator.device)
        return True

    def restore(self, state_template, step: Optional[int] = None):
        """Load the checkpoint of `step` (default: the latest) into
        `state_template`'s model, optimizer and generator, in place, and
        return the state with its plateau and step; None if there is none."""
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self._path(step)):
            return None
        # onto the CPU: loading copies each tensor to its parameter's device,
        # and Adam's step counters stay on the host, as in a run never saved
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        model, opt = state_template.model, state_template.optimizer
        if _sharded(model):
            from torch.distributed.checkpoint.state_dict import StateDictOptions, set_state_dict

            set_state_dict(model, opt, model_state_dict=payload["model"],
                           optim_state_dict=_by_name(payload["optimizer"], model),
                           options=StateDictOptions(full_state_dict=True, strict=True))
        else:
            model.load_state_dict(payload["model"], strict=True)
            opt.load_state_dict(payload["optimizer"])
        state_template.generator.set_state(payload["generator"])
        return dataclasses.replace(state_template, plateau=PlateauState(**payload["plateau"]),
                                   step=payload["step"])

    def restore_best(self):
        """The best model's state_dict (CPU tensors), or None."""
        path = os.path.join(self.directory, "best", "model.pth")
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location="cpu", weights_only=True)

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self):
        """Saves are synchronous: every file is in place when `save` returns."""

    def close(self):
        """Nothing is held open between calls."""
