"""Adaptive density control: clone / split / prune, 3DGS-style (PyTorch
port of ``splatjax/train/densify.py``).

Gaussians whose accumulated positional gradient is large under-reconstruct
their region: small ones are CLONED, large ones SPLIT into two smaller
samples; near-transparent ones are PRUNED. Parameter rows live in capacity
buckets (1024-aligned, grown 1.5x when full), so the training step is
rebuilt only O(log growth) times; dead and pruned slots stay allocated as
gaussians of opacity ~3e-7 and scale ~6e-6, which the projection's size x
opacity cull drops (``ops/projection.py``).

The bookkeeping runs on the host in NumPy, as splatjax's does, between
steps: the same inputs and the same ``np.random.Generator`` give splatjax's
result (the children's samples are drawn in the same order). The rows then
go back to the parameters' device, and the Adam state is grown with them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from splatjax_torch.scene import TrainableGaussians

DEAD_LOGIT = -15.0     # sigmoid(-15) ~ 3e-7: culled by the size-opacity test
DEAD_LOG_SCALE = -12.0


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """splatjax's ``DensifyConfig``: same fields and defaults."""

    start: int = 50                # first step eligible
    stop: int = 10 ** 9            # last step eligible
    every: int = 50                # densify cadence (steps)
    grad_threshold: float = 2e-4   # avg |d loss/d mean| trigger
    split_scale: float = 0.02      # world size: clone below, split above
    split_factor: float = 1.6      # scale shrink of split children
    prune_opacity: float = 0.005   # prune below this opacity
    max_gaussians: int = 1 << 22
    bucket_growth: float = 1.5


def _bucket(n: int, growth: float) -> int:
    """Smallest capacity bucket >= n (1024-aligned, growth-factor spaced)."""
    cap = 1024
    while cap < n:
        cap = int(np.ceil(cap * growth / 1024)) * 1024
    return cap


def _pad_rows(x: np.ndarray, rows: int, fill: float = 0.0) -> np.ndarray:
    if x.shape[0] >= rows:
        return x
    pad = np.full((rows - x.shape[0],) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad], axis=0)


def _quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vectors v (N, 3) by unit quaternions q (N, 4) (w, x, y, z)."""
    w, x, y, z = q[:, 0:1], q[:, 1:2], q[:, 2:3], q[:, 3:4]
    u = np.concatenate([x, y, z], axis=1)
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def _host(t: torch.Tensor) -> np.ndarray:
    """A writable host copy (a CPU tensor's numpy view would alias it)."""
    return np.array(t.detach().cpu().numpy())


def _grow_optimizer(opt: torch.optim.Optimizer, old: TrainableGaussians,
                    new: TrainableGaussians, cap: int,
                    placed: np.ndarray) -> torch.optim.Optimizer:
    """The optimizer over ``new``'s leaves: each group's hyperparameters
    kept, each leaf's per-row state (Adam's ``exp_avg``/``exp_avg_sq``)
    zero-padded to ``cap`` rows with the ``placed`` children's rows reset,
    and its scalar state (``step``) copied, as splatjax's ``_grow_leaf``
    treats optax's moments and shared count."""
    leaf_of = {id(getattr(old, name)): name
               for name in TrainableGaussians.LEAVES
               if getattr(old, name) is not None}
    groups, state = [], {}
    placed_t = None
    for group in opt.param_groups:
        names = [leaf_of[id(p)] for p in group["params"]]
        groups.append({**{k: v for k, v in group.items() if k != "params"},
                       "params": [getattr(new, n) for n in names]})
        for p, name in zip(group["params"], names):
            grown = {}
            for key, value in opt.state.get(p, {}).items():
                if torch.is_tensor(value) and value.dim() >= 1 \
                        and value.shape[0] == p.shape[0]:
                    value = torch.cat([value, value.new_zeros(
                        (cap - value.shape[0],) + value.shape[1:])])
                    if placed.size and value.is_floating_point():
                        if placed_t is None:
                            placed_t = torch.as_tensor(
                                placed, dtype=torch.long,
                                device=value.device)
                        value.index_fill_(0, placed_t, 0.0)
                else:
                    value = value.clone() if torch.is_tensor(value) \
                        else value
                grown[key] = value
            if grown:
                state[getattr(new, name)] = grown
    out = type(opt)(groups)
    out.state.update(state)
    return out


def densify_and_prune(
    params: TrainableGaussians,
    opt: torch.optim.Optimizer,
    grad_sum: np.ndarray,
    grad_cnt: np.ndarray,
    alive: np.ndarray,
    cfg: DensifyConfig,
    rng: np.random.Generator,
):
    """One adaptive-density pass on the host.

    grad_sum/grad_cnt: accumulated ||d loss/d mean|| and update counts since
    the previous pass (numpy, (cap,)). alive: (cap,) bool slot mask.
    Returns (params, opt, alive, report). When anything changed, ``params``
    is a new :class:`TrainableGaussians` on the same device (its rows may
    have grown to a larger bucket; the caller rebuilds its step for the new
    capacity) and ``opt`` a new optimizer of the same type over it, its
    state grown by :func:`_grow_optimizer`; otherwise both are the inputs.
    """
    dev = params.means.device
    means = _host(params.means)
    log_scales = _host(params.log_scales)
    quats = _host(params.quats)
    logit_op = _host(params.logit_opacities)
    colors = _host(params.colors)
    sh = None if params.sh is None else _host(params.sh)
    cap = means.shape[0]
    alive = alive.copy()

    avg = grad_sum / np.maximum(grad_cnt, 1)
    opac = 1.0 / (1.0 + np.exp(-logit_op))
    scales = np.exp(log_scales)
    max_scale = scales.max(axis=1)

    # prune: transparent slots die (stay allocated, culled by the renderer)
    prune = alive & (opac < cfg.prune_opacity)
    alive &= ~prune
    logit_op[prune] = DEAD_LOGIT
    log_scales[prune] = DEAD_LOG_SCALE

    hot = alive & (avg > cfg.grad_threshold) & (grad_cnt > 0)
    clone_idx = np.flatnonzero(hot & (max_scale <= cfg.split_scale))
    split_idx = np.flatnonzero(hot & (max_scale > cfg.split_scale))
    n_alive = int(alive.sum())
    # Budget the children before killing any parent: clones fill first,
    # then split parents in whole 2-child pairs. A split parent whose
    # children do not fit max_gaussians keeps living (its children are
    # dropped and counted).
    n_children = len(clone_idx) + 2 * len(split_idx)
    budget = max(cfg.max_gaussians - n_alive, 0)
    n_clone_placed = min(len(clone_idx), budget)
    n_split_placed = min((budget - n_clone_placed) // 2, len(split_idx))
    clone_idx = clone_idx[:n_clone_placed]
    split_idx = split_idx[:n_split_placed]
    n_new = n_clone_placed + 2 * n_split_placed
    dropped_children = n_children - n_new
    if n_new <= 0 and not prune.any():
        report = {"cloned": 0, "split": 0, "pruned": int(prune.sum()),
                  "dropped_children": dropped_children,
                  "alive": n_alive, "capacity": cap}
        return params, opt, alive, report

    # children: clones duplicate in place; splits sample two children from
    # the parent's own distribution with scales / split_factor, parent dies
    new_rows = []
    qn = quats / np.maximum(np.linalg.norm(quats, axis=1, keepdims=True),
                            1e-12)
    for idx, k_children, shrink in (
        (clone_idx, 1, 1.0),
        (split_idx, 2, cfg.split_factor),
    ):
        if len(idx) == 0:
            continue
        rep = np.repeat(idx, k_children)
        offs = rng.normal(size=(len(rep), 3)).astype(np.float32) \
            * scales[rep]
        offs = _quat_rotate(qn[rep], offs) if shrink > 1.0 else 0.0 * offs
        new_rows.append((
            means[rep] + offs,
            log_scales[rep] - np.log(shrink),
            quats[rep],
            logit_op[rep],
            colors[rep],
            None if sh is None else sh[rep],
        ))
    if split_idx.size:
        # only parents whose children were budgeted above die
        alive[split_idx] = False
        logit_op[split_idx] = DEAD_LOGIT
        log_scales[split_idx] = DEAD_LOG_SCALE

    placed = np.zeros((0,), np.int64)
    if new_rows and n_new > 0:
        def cat(i):
            return np.concatenate([r[i] for r in new_rows], axis=0)

        nm, nls, nq, nlo, nc = cat(0), cat(1), cat(2), cat(3), cat(4)
        nsh = None if sh is None else cat(5)
        free = np.flatnonzero(~alive)
        n_place = min(len(free), nm.shape[0])
        grow = nm.shape[0] - n_place
        if grow > 0:
            new_cap = _bucket(cap + grow, cfg.bucket_growth)
            means = _pad_rows(means, new_cap)
            log_scales = _pad_rows(log_scales, new_cap, DEAD_LOG_SCALE)
            quats = _pad_rows(quats, new_cap)
            quats[cap:, 0] = 1.0
            logit_op = _pad_rows(logit_op, new_cap, DEAD_LOGIT)
            colors = _pad_rows(colors, new_cap)
            if sh is not None:
                sh = _pad_rows(sh, new_cap)
            alive = _pad_rows(alive, new_cap, False)
            free = np.flatnonzero(~alive)
            cap = new_cap
        placed = free[: nm.shape[0]]
        means[placed] = nm
        log_scales[placed] = nls
        quats[placed] = nq
        logit_op[placed] = nlo
        colors[placed] = nc
        if sh is not None:
            sh[placed] = nsh
        alive[placed] = True

    def dev_leaf(x):
        return None if x is None else torch.from_numpy(x).to(dev)

    new_params = TrainableGaussians(
        means=dev_leaf(means),
        log_scales=dev_leaf(log_scales),
        quats=dev_leaf(quats),
        logit_opacities=dev_leaf(logit_op),
        colors=dev_leaf(colors),
        sh=dev_leaf(sh),
    )
    # optimizer moments: existing rows kept, zero-extended for a grown
    # capacity, and the rows of newly placed children reset (a dead slot's
    # stale moments would kick a fresh gaussian with unrelated momentum)
    new_opt = _grow_optimizer(opt, params, new_params, cap, placed)
    report = {
        "cloned": int(len(clone_idx)), "split": int(len(split_idx)),
        "pruned": int(prune.sum()),
        "dropped_children": dropped_children,
        "alive": int(alive.sum()),
        "capacity": cap,
    }
    return new_params, new_opt, alive, report
