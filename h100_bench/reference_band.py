"""Plain PyTorch reference of the mean-view training step that a
(view x band) mesh takes: every step renders several views at the same
parameters, and one Adam step follows on the mean of their gradients.

It is built from ``reference.py``'s own functions and imports neither the
program nor JAX: each view's loss and gradient is ``reference.train_step``
with its Adam step held back, the views' gradients are averaged leaf by
leaf, and ``reference.Adam`` takes the mean. The band split, the
redistribution and the collectives have no counterpart here: the
reference renders each whole view on one device, in float32 with TF32
off (``reference.no_tf32``), blending in its own batches.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

import reference


class _Held:
    """Stands in for ``reference.Adam`` inside ``reference.train_step``:
    keeps the gradients it is given and steps nothing."""

    grads: Optional[dict] = None

    def step(self, raw: dict, grads: dict) -> None:
        self.grads = grads


def mean_view_step(raw: dict, adam: reference.Adam, views: Sequence,
                   targets: Sequence, *, rows, alpha_clip, early_stop,
                   ssim_weight, dtype=torch.float32,
                   rows_in_loss: Optional[int] = None,
                   reduce: Optional[Callable] = None):
    """One step on the raw leaves (updated in place): each view's loss and
    gradient at the same parameters, then one Adam step on the mean
    gradient. Returns the views' mean loss, the mean gradient and the
    views' blends.

    ``reduce``, where several processes share a step, each rendering its
    own ``views`` from the same ``raw``, sums a list of tensors in place
    over them (the loss, the view count and each leaf's gradient); the
    mean is then over every process's views. ``dtype`` and
    ``rows_in_loss`` are ``reference.train_step``'s."""
    losses, grads, blends = [], [], []
    for view, target in zip(views, targets):
        held = _Held()
        loss, _, done = reference.train_step(
            raw, held, view, target, rows=rows, alpha_clip=alpha_clip,
            early_stop=early_stop, ssim_weight=ssim_weight, dtype=dtype,
            rows_in_loss=rows_in_loss)
        losses.append(loss)
        grads.append(held.grads)
        blends.append(done)
    total = {k: sum(g[k] for g in grads) for k in grads[0]}
    dev = next(iter(total.values())).device
    counts = torch.tensor([sum(losses), len(grads)],
                          dtype=torch.float64, device=dev)
    if reduce is not None:
        reduce([counts] + list(total.values()))
    n = float(counts[1])
    mean = {k: g / n for k, g in total.items()}
    adam.step(raw, mean)
    return float(counts[0]) / n, mean, blends


def run_steps(raw: dict, lrs: dict, views: Sequence, targets: Sequence,
              steps: int, **kw):
    """``steps`` mean-view steps from ``raw`` (updated in place) with a
    fresh ``reference.Adam`` of learning rates ``lrs``: step j renders the
    views ``views[j]`` against ``targets[j]``. Returns each step's mean
    loss, the first step's mean gradient and every step's blends;
    ``kw`` goes to :func:`mean_view_step`."""
    adam = reference.Adam(lrs)
    losses, blends, first = [], [], None
    for j in range(steps):
        loss, grad, done = mean_view_step(raw, adam, views[j], targets[j],
                                          **kw)
        losses.append(loss)
        blends.extend(done)
        if first is None:
            first = grad
    return losses, first, blends
