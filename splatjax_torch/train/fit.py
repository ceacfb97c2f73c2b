"""Fit-from-scratch training loop: Adam over all Gaussian parameters
(PyTorch port of ``splatjax/train/fit.py``).

Optimizes means / scales / rotations / opacities / colors (and SH) against
target images through the differentiable tiled renderer, with per-leaf
learning rates as in standard 3DGS practice, adaptive density control
(:mod:`.densify`) and checkpoint/resume (:mod:`.checkpoint`), on one card
or over a ``torch.distributed`` mesh (:func:`make_dp_train_step`, and
:mod:`splatjax_torch.parallel.dist_train` for view x band meshes).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from splatjax_torch import trace
from splatjax_torch.camera import Camera
from splatjax_torch.device import resolve_device
from splatjax_torch.parallel.dist_render import all_reduce
from splatjax_torch.parallel.mesh import (
    axis_group,
    mesh_axis_size,
    mesh_group,
)
from splatjax_torch.render import default_capacity, render
from splatjax_torch.scene import GaussianScene, TrainableGaussians
from splatjax_torch.train.checkpoint import CheckpointManager
from splatjax_torch.train.densify import DensifyConfig, densify_and_prune
from splatjax_torch.train.loss import combined_loss, psnr


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """splatjax's ``FitConfig``: same fields and defaults."""

    steps: int = 2000
    lr_means: float = 1.6e-4
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacities: float = 5e-2
    lr_colors: float = 2.5e-2
    lr_sh: float = 1.25e-3
    ssim_weight: float = 0.2
    alpha_clip: float = 0.999
    early_stop: float = 1e-4
    capacity: Optional[int] = None
    log_every: int = 100
    # 16-byte training rows (fixed-point mean / bf16 conic / RGBA8 color);
    # 32 for full-precision rows
    feature_bytes: int = 16
    # steps per call of the step function; the port runs them as a Python
    # loop of single steps (same order, same result), so this only groups
    # logging and the summed densify signal
    steps_per_call: int = 1


def _optimizer(params: TrainableGaussians, cfg: FitConfig
               ) -> torch.optim.Adam:
    """Adam with one parameter group per leaf and its learning rate
    (optax's adam and torch's Adam apply the same update)."""
    rates = {
        "means": cfg.lr_means,
        "log_scales": cfg.lr_scales,
        "quats": cfg.lr_quats,
        "logit_opacities": cfg.lr_opacities,
        "colors": cfg.lr_colors,
        "sh": cfg.lr_sh,
    }
    groups = [{"params": [getattr(params, name)], "lr": lr}
              for name, lr in rates.items()
              if getattr(params, name) is not None]
    return torch.optim.Adam(groups)


def make_train_step(cameras: Sequence[Camera], cfg: FitConfig,
                    capacity: int) -> Callable:
    """Build ``step(params, opt, modelview, projection, target) -> (loss,
    psnr, gnorm)``: one render, loss, backward and Adam update of
    ``params`` in place. loss/psnr are 0-d tensors of the step's (pre-
    update) render; gnorm is the (N,) norm of the means' gradient.

    With ``cfg.steps_per_call = k > 1`` the step takes stacked (k, 4, 4)
    matrices and (k, H, W, 4) targets, runs k steps in order and returns
    the last step's loss/psnr and the sum of the k gnorm vectors."""
    w, h = cameras[0].width, cameras[0].height

    def one_step(params, opt, modelview, projection, target):
        with trace.root("sj.step"):
            cam = Camera(modelview=modelview, projection=projection,
                         width=w, height=h)
            opt.zero_grad(set_to_none=True)
            img = render(params.to_scene(), cam, capacity=capacity,
                         alpha_clip=cfg.alpha_clip,
                         early_stop=cfg.early_stop,
                         feature_bytes=cfg.feature_bytes)
            with trace.span("sj.loss"):
                loss = combined_loss(img, target,
                                     ssim_weight=cfg.ssim_weight)
            # the backward in two calls, so the loss's part and the
            # render's part are timed apart: the same nodes in the same
            # order as one loss.backward(), so the same gradients
            with trace.span("sj.loss_bwd"):
                g_img, = torch.autograd.grad(loss, img)
            with trace.span("sj.render_bwd"):
                img.backward(g_img)
            opt.step()
            with torch.no_grad():
                return loss.detach(), psnr(img, target), \
                    params.means.grad.norm(dim=-1)

    if cfg.steps_per_call <= 1:
        return one_step

    def step_multi(params, opt, mvs, prs, targets):
        gnorm = None
        for j in range(mvs.shape[0]):
            loss, p, gn = one_step(params, opt, mvs[j], prs[j], targets[j])
            gnorm = gn if gnorm is None else gnorm + gn
        return loss, p, gnorm

    return step_multi


def make_dp_train_step(cameras: Sequence[Camera], cfg: FitConfig,
                       capacity: int, mesh, axis="dev") -> Callable:
    """Data-parallel step over ``mesh``'s ``axis`` (a name or a tuple of
    names): parameters replicated, one view per rank, gradients summed over
    the ranks in one all_reduce and averaged before Adam, so a B-view step
    equals a one-card step on the mean loss of those B views.

    Build ``step(params, opt, mvs, prs, targets) -> (loss, psnr, gnorm)``;
    every rank passes the same stacked (B, 4, 4) matrices and (B, H, W, 4)
    targets, B the axis size, renders view ``index along the axis`` and
    updates ``params`` in place, identically on every rank. loss/psnr are
    the views' means, gnorm the (N,) norm of the means' mean gradient.
    With ``cfg.steps_per_call = k > 1`` it takes (k, B, ...) stacks and
    runs k steps in order, returning the last loss/psnr and the summed
    gnorm."""
    from splatjax_torch.parallel.dist_train import reduce_gradients

    w, h = cameras[0].width, cameras[0].height
    ag = axis_group(mesh, axis)

    def one_step(params, opt, mvs, prs, targets):
        j = ag.index
        cam = Camera(modelview=mvs[j], projection=prs[j], width=w, height=h)
        opt.zero_grad(set_to_none=True)
        img = render(params.to_scene(), cam, capacity=capacity,
                     alpha_clip=cfg.alpha_clip, early_stop=cfg.early_stop,
                     feature_bytes=cfg.feature_bytes)
        loss = combined_loss(img, targets[j], ssim_weight=cfg.ssim_weight)
        loss.backward()
        reduce_gradients(params, ag.group, ag.size)
        opt.step()
        with torch.no_grad():
            stats = all_reduce(torch.stack([loss.detach(),
                                            psnr(img, targets[j])]),
                               ag.group) / ag.size
            return stats[0], stats[1], params.means.grad.norm(dim=-1)

    if cfg.steps_per_call <= 1:
        return one_step

    def step_multi(params, opt, mvs, prs, targets):
        gnorm = None
        for t in range(mvs.shape[0]):
            loss, p, gn = one_step(params, opt, mvs[t], prs[t], targets[t])
            gnorm = gn if gnorm is None else gnorm + gn
        return loss, p, gnorm

    return step_multi


def fit(
    initial: TrainableGaussians | GaussianScene,
    cameras: Sequence[Camera],
    targets: Sequence[torch.Tensor],
    cfg: FitConfig = FitConfig(),
    *,
    checkpoint_fn: Optional[Callable[[int, TrainableGaussians], None]] = None,
    checkpoint_every: int = 0,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    densify: Optional[DensifyConfig] = None,
    densify_seed: int = 0,
    log_fn: Optional[Callable[[dict], None]] = None,
    mesh=None,
    dp_axis="dev",
    band_axis: Optional[str] = None,
):
    """Optimize gaussians to match target images on the parameters' device.
    Returns (params, history). ``params`` is updated in place until a
    densify pass or a resume replaces it with a new object (densify can
    grow its rows), so use the returned one; a ``GaussianScene`` start is
    converted first.

    targets: (H, W, 3|4) tensors aligned with ``cameras`` (all cameras share
    one size); step i renders view i mod len(cameras). history holds
    {"step", "loss", "psnr", "elapsed_s"} every ``log_every`` steps and at
    the last step. ``checkpoint_fn(step, params)`` runs every
    ``checkpoint_every`` steps.

    ``checkpoint_dir``: the training state is saved there every
    ``checkpoint_every`` steps and at the end (:class:`CheckpointManager`);
    ``resume=True`` restores the latest checkpoint in it and continues
    from the step after it. With ``densify`` the checkpoint also holds the
    slot mask, the gradient sums and the generator's state, so a resumed
    run takes the steps an uninterrupted one takes (splatjax restores only
    the parameters and the optimizer).

    ``densify=DensifyConfig(...)``: clone/split/prune passes between steps
    (:func:`densify_and_prune`, children drawn from
    ``np.random.default_rng(densify_seed)``); when the row count changes,
    the step is rebuilt for ``cfg.capacity`` or, without one,
    ``default_capacity`` of the new count.

    Multi-card (every rank of the mesh calls ``fit`` with the same
    arguments and returns the same parameters and history):
      * ``mesh=make_mesh(...)``: data parallelism over ``dp_axis``,
        parameters replicated, one view per rank (:func:`make_dp_train_step`);
      * ``mesh=make_mesh_2d((v, b), ("view", "band")), dp_axis="view",
        band_axis="band"``: views over ``dp_axis``, the gaussians sharded
        over ``band_axis`` (``parallel.make_dp_band_train_step``); the row
        count must divide the band size, and each record holds ``drops``,
        the instances lost to capacity that step.
    Step i takes views ``((i + t) * n_dp + j) % len(cameras)``, j the
    rank's index along ``dp_axis``. The mesh's first rank writes the
    checkpoints and runs ``checkpoint_fn``; every rank waits for it."""
    if isinstance(initial, GaussianScene):
        params = TrainableGaussians.from_scene(initial)
    else:
        params = initial
    dev = params.means.device
    k = max(cfg.steps_per_call, 1)
    if k > 1 and densify is not None:
        raise ValueError(
            "steps_per_call > 1 is incompatible with densify (the "
            "clone/split/prune pass needs per-step python control); set "
            "steps_per_call=1 or drop densify")

    n_dp = 1 if mesh is None else mesh_axis_size(mesh, dp_axis)
    group = None if mesh is None else mesh_group(mesh)
    lead = group is None or dist.get_rank(group) == 0

    def build_step(n):
        capacity = cfg.capacity or default_capacity(n)
        if mesh is not None and band_axis is not None:
            from splatjax_torch.parallel.dist_train import (
                make_dp_band_train_step,
            )

            d_band = mesh_axis_size(mesh, band_axis)
            if n % d_band:
                raise ValueError(
                    f"gaussian count {n} must divide the band-axis size "
                    f"{d_band} (pad the scene or pick a bucket-aligned N)")
            return make_dp_band_train_step(
                cameras, cfg, mesh, view_axis=dp_axis, band_axis=band_axis,
                capacity=cfg.capacity, steps_per_call=k)
        if mesh is not None:
            return make_dp_train_step(cameras, cfg, capacity, mesh,
                                      axis=dp_axis)
        return make_train_step(cameras, cfg, capacity)

    opt = _optimizer(params, cfg)
    n_rows = params.num_gaussians
    alive = np.ones((n_rows,), bool)
    grad_sum = torch.zeros((n_rows,), dtype=torch.float64, device=dev)
    grad_cnt = torch.zeros((n_rows,), dtype=torch.int64, device=dev)
    dense_rng = None
    if densify is not None:
        dense_rng = np.random.default_rng(densify_seed)

    start_step = 0
    mgr = None
    if checkpoint_dir is not None:
        mgr = CheckpointManager(checkpoint_dir)
        if resume and mgr.latest_step() is not None:
            params, opt, start_step, extra = mgr.restore(params, opt)
            n_rows = params.num_gaussians
            if densify is not None and "alive" in extra:
                alive = extra["alive"].numpy()
                grad_sum = extra["grad_sum"].to(dev)
                grad_cnt = extra["grad_cnt"].to(dev)
                dense_rng.bit_generator.state = extra["rng"]
            else:  # saved without densify: its state starts afresh
                alive = np.ones((n_rows,), bool)
                grad_sum = grad_sum.new_zeros((n_rows,))
                grad_cnt = grad_cnt.new_zeros((n_rows,))
    step_fn = build_step(n_rows)

    mvs = [c.modelview.to(dev, torch.float32) for c in cameras]
    prs = [c.projection.to(dev, torch.float32) for c in cameras]
    targets = [torch.as_tensor(t, device=dev)[..., :4].to(torch.float32)
               for t in targets]

    if k > 1 and (cfg.steps - start_step) % k:
        raise ValueError(f"steps ({cfg.steps}, resuming at {start_step}) "
                         f"must be a multiple of steps_per_call ({k})")
    history = []
    drops = None
    t_start = time.time()
    for i in range(start_step, cfg.steps, k):
        vis = [(i + j) % len(cameras) for j in range(k)]
        if mesh is not None:
            def batch(src):
                per_step = [torch.stack([
                    src[((i + t) * n_dp + j) % len(cameras)]
                    for j in range(n_dp)]) for t in range(k)]
                return per_step[0] if k == 1 else torch.stack(per_step)

            out = step_fn(params, opt, batch(mvs), batch(prs),
                          batch(targets))
            if band_axis is not None:
                loss, p, gnorm, drops = out
            else:
                loss, p, gnorm = out
        elif k > 1:
            loss, p, gnorm = step_fn(
                params, opt,
                torch.stack([mvs[v] for v in vis]),
                torch.stack([prs[v] for v in vis]),
                torch.stack([targets[v] for v in vis]),
            )
        else:
            loss, p, gnorm = step_fn(params, opt, mvs[vis[0]], prs[vis[0]],
                                     targets[vis[0]])
        if densify is not None:
            grad_sum += gnorm
            grad_cnt += 1
            if (densify.start <= i <= densify.stop
                    and (i - densify.start) % densify.every
                    == densify.every - 1):
                params, opt, alive, rep = densify_and_prune(
                    params, opt, grad_sum.cpu().numpy(),
                    grad_cnt.cpu().numpy(), alive, densify, dense_rng)
                if params.num_gaussians != n_rows:
                    n_rows = params.num_gaussians
                    step_fn = build_step(n_rows)
                grad_sum = grad_sum.new_zeros((n_rows,))
                grad_cnt = grad_cnt.new_zeros((n_rows,))
                if log_fn is not None:
                    log_fn({"step": i, "densify": rep})
        if cfg.log_every and (i % cfg.log_every < k or i + k >= cfg.steps):
            rec = {
                "step": i + k - 1,
                "loss": float(loss),
                "psnr": float(p),
                "elapsed_s": time.time() - t_start,
            }
            if drops is not None:
                rec["drops"] = int(drops)
            history.append(rec)
            if log_fn is not None:
                log_fn(rec)
        done = i + k
        if mgr is not None and checkpoint_every and (
                done % checkpoint_every < k or done == cfg.steps):
            extra = None
            if densify is not None:
                extra = {"alive": torch.from_numpy(alive),
                         "grad_sum": grad_sum.cpu(),
                         "grad_cnt": grad_cnt.cpu(),
                         "rng": dense_rng.bit_generator.state}
            if lead:
                mgr.save(done, params, opt, extra)
            if group is not None:
                dist.barrier(group=group)
        if lead and checkpoint_fn is not None and checkpoint_every and (
                done % checkpoint_every < k):
            checkpoint_fn(done, params)
    return params, history


def init_random(n: int, generator: torch.Generator, *, extent: float = 1.0,
                initial_scale: float = 0.02, device="cuda"
                ) -> TrainableGaussians:
    """Random initialization for fit-from-scratch, drawn on the CPU from
    ``generator`` (so a seed gives the same start on every device)."""
    dev = resolve_device(device)
    f32 = torch.float32
    means = (torch.rand((n, 3), generator=generator, dtype=f32) * 2.0 - 1.0
             ) * extent
    quats = torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=f32).repeat(n, 1)
    quats = quats + 0.01 * torch.randn((n, 4), generator=generator,
                                       dtype=f32)
    colors = torch.randn((n, 3), generator=generator, dtype=f32) * 0.3
    return TrainableGaussians(
        means=means.to(dev),
        log_scales=torch.full((n, 3), float(torch.log(
            torch.tensor(initial_scale, dtype=f32))), dtype=f32, device=dev),
        quats=quats.to(dev),
        logit_opacities=torch.full((n,), -1.0, dtype=f32, device=dev),
        colors=colors.to(dev),
    )
