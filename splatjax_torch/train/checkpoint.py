"""Checkpoint / resume and viewer export (PyTorch port of
``splatjax/train/checkpoint.py``).

* :class:`CheckpointManager`: the training state (parameters, optimizer
  state, step, and whatever else the trainer passes, such as densify's
  slot mask, gradient sums and generator state) in one ``torch.save`` file
  a step, read back with ``torch.load(weights_only=True)``. splatjax keeps
  orbax checkpoints; this format is torch's own, so a checkpoint of one
  package does not load in the other.
* :func:`export_splat` / :func:`export_ply`: a trained scene in the
  viewer's .splat bytes or as a 3DGS .ply.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Union

import torch

from splatjax_torch.io.ply_format import save_ply
from splatjax_torch.io.splat_format import save_splat
from splatjax_torch.scene import GaussianScene, TrainableGaussians

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """Checkpoints ``step_<step>.pt`` in ``directory``, the newest
    ``max_to_keep`` kept. A checkpoint is written under a temporary name
    and renamed, so a crash leaves no partial one."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> list[int]:
        """The steps that have a checkpoint, ascending."""
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, params: TrainableGaussians,
             opt: torch.optim.Optimizer,
             extra: Optional[dict] = None) -> None:
        """Write step ``step``: the leaves of ``params``, ``opt``'s
        ``state_dict()`` and ``extra`` (tensors, numbers, strings and
        containers of them)."""
        leaves = {name: getattr(params, name).detach().cpu()
                  for name in TrainableGaussians.LEAVES
                  if getattr(params, name) is not None}
        state = {"step": int(step), "params": leaves,
                 "opt": opt.state_dict(), "extra": extra or {}}
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            torch.save(state, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, params_like: TrainableGaussians,
                opt_like: torch.optim.Optimizer, step=None):
        """Read step ``step`` (default: the latest). Returns (params, opt,
        step, extra): new parameters on ``params_like``'s device, with the
        saved row count (densify may have grown it), and a new optimizer of
        ``opt_like``'s type and hyperparameters over them holding the saved
        state."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        ckpt = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        dev = params_like.means.device
        params = TrainableGaussians(**{
            name: ckpt["params"][name].to(dev) if name in ckpt["params"]
            else None for name in TrainableGaussians.LEAVES})
        leaf_of = {id(getattr(params_like, n)): n
                   for n in TrainableGaussians.LEAVES
                   if getattr(params_like, n) is not None}
        opt = type(opt_like)([
            {**{k: v for k, v in g.items() if k != "params"},
             "params": [getattr(params, leaf_of[id(p)])
                        for p in g["params"]]}
            for g in opt_like.param_groups])
        opt.load_state_dict(ckpt["opt"])
        return params, opt, ckpt["step"], ckpt["extra"]


def _scene(params: Union[TrainableGaussians, GaussianScene]
           ) -> GaussianScene:
    if isinstance(params, TrainableGaussians):
        with torch.no_grad():
            return params.to_scene()
    return params


def export_splat(path: str,
                 params: Union[TrainableGaussians, GaussianScene]) -> None:
    """Write a trained scene as .splat for the reference viewer."""
    save_splat(path, _scene(params))


def export_ply(path: str,
               params: Union[TrainableGaussians, GaussianScene]) -> None:
    """Write a trained scene as a 3DGS .ply (keeps the SH bands)."""
    save_ply(path, _scene(params))
