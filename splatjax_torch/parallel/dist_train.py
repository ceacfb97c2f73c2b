"""Training on a 2-D (view x band) mesh: views data-parallel, gaussians
sharded over bands (PyTorch port of ``splatjax/parallel/dist_train.py``).

Every rank holds the full parameters and Adam state in original row
order and passes the full per-step batch. Rank (v, b) renders view v of
the batch from its dealt band shard of the gaussians (the body of
``render_sharded``), all-gathers the view's band tiles so every rank of
the view assembles the full image and takes the same loss (SSIM windows
stay exact across band boundaries), and runs its backward: the tile
all_gather transposes into a reduce_scatter and the all_to_all into the
reverse all_to_all, so rank (v, b)'s gradient sits on its own rows. One
all_reduce over the whole mesh then sums the views and assembles the
bands' disjoint rows at once; divided by d_view * d_band as in splatjax
(every band rank backpropagates the same loss), it is the mean-view
gradient on every rank, and Adam steps the same parameters everywhere.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from splatjax_torch import trace
from splatjax_torch.camera import Camera
from splatjax_torch.ops.binning import TileConfig
from splatjax_torch.parallel.dist_render import (
    _assemble_band_tiles,
    _band_layout,
    _band_render_body,
    _default_pair_capacity,
    _gather_band_tiles,
    all_reduce,
)
from splatjax_torch.parallel.mesh import axis_group, mesh_group
from splatjax_torch.render import default_capacity, resolve_alpha_clip
from splatjax_torch.scene import TrainableGaussians
from splatjax_torch.train.loss import combined_loss, psnr


def reduce_gradients(params: TrainableGaussians, group, divisor: int
                     ) -> None:
    """Sum every leaf's gradient over ``group`` in one all_reduce and
    divide by ``divisor``, in place; the result is bit-identical on every
    rank."""
    with trace.span("sj.grad_reduce"):
        grads = [p.grad for p in params.parameters()]
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
        flat = flat / divisor
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def make_dp_band_train_step(
    cameras: Sequence[Camera],
    cfg,
    mesh,
    *,
    view_axis: str = "host",
    band_axis: str = "chip",
    tile_size: int = 16,
    capacity: Optional[int] = None,
    pair_capacity: Optional[int] = None,
    redistribute: str = "all_to_all",
    steps_per_call: int = 1,
    balance: str = "load",
):
    """Build ``step(params, opt, mvs, prs, targets) -> (loss, psnr,
    gnorm, drops)`` for ``mesh``'s (view, band) axes.

    Every rank calls it with the same stacked (D_view, 4, 4) camera
    matrices and (D_view, H, W, 4) targets; it updates ``params`` (a
    :class:`TrainableGaussians`, gaussian count divisible by the band
    size) and ``opt`` (``train.fit._optimizer``) in place, identically on
    every rank. loss/psnr are the views' means, ``gnorm`` the (N,) norm of
    the means' mean-view gradient (the densify signal), ``drops`` the
    instances lost to transfer, span or binning capacity over every band
    and view. With ``steps_per_call=k > 1`` the step takes (k, D_view,
    ...) stacks and runs k steps in order, returning the last loss/psnr
    and the summed gnorm and drops. ``fit(mesh=..., band_axis=...)``
    routes here."""
    w, h = cameras[0].width, cameras[0].height
    band = axis_group(mesh, band_axis)
    view = axis_group(mesh, view_axis)
    whole = mesh_group(mesh)
    alpha_clip = resolve_alpha_clip(cfg.alpha_clip, False)
    band_rows, n_rows = _band_layout(h, band.size, tile_size, balance)
    cfg_band = TileConfig(w, band_rows * tile_size, tile_size, tile_size)

    def one_step(params, opt, mvs, prs, targets):
        with trace.root("sj.step"):
            return _one_step(params, opt, mvs, prs, targets)

    def _one_step(params, opt, mvs, prs, targets):
        target = targets[view.index]
        n_loc = params.num_gaussians // band.size
        pc = pair_capacity or _default_pair_capacity(n_loc, band.size)
        cap = capacity or max(default_capacity(band.size * pc), 2048)
        dev = params.means.device
        opt.zero_grad(set_to_none=True)
        scene = params.to_scene()

        def deal(x):
            return None if x is None else x[band.index::band.size]

        out_tiles, my_drop, bounds = _band_render_body(
            deal(scene.means), deal(scene.scales), deal(scene.quats),
            deal(scene.colors), deal(scene.opacities), deal(scene.sh),
            mvs[view.index].to(dev, torch.float32),
            prs[view.index].to(dev, torch.float32),
            ag=band, width=w, height=h, n_rows=n_rows, cfg_band=cfg_band,
            pair_capacity=pc, capacity=cap, alpha_clip=alpha_clip,
            early_stop=cfg.early_stop, redistribute=redistribute,
            packed16=cfg.feature_bytes == 16, balance=balance,
        )
        img = _assemble_band_tiles(_gather_band_tiles(out_tiles, band.group),
                                   bounds, cfg_band, n_rows, h)
        loss = combined_loss(img, target, ssim_weight=cfg.ssim_weight)
        loss.backward()
        reduce_gradients(params, whole, view.size * band.size)
        opt.step()
        with torch.no_grad():
            stats = all_reduce(torch.stack([loss.detach(),
                                            psnr(img, target)]),
                               view.group) / view.size
            drops = all_reduce(my_drop, whole)
            return stats[0], stats[1], params.means.grad.norm(dim=-1), drops

    if steps_per_call <= 1:
        return one_step

    def step_multi(params, opt, mvs, prs, targets):
        gnorm = drops = None
        for j in range(mvs.shape[0]):
            loss, p, gn, dr = one_step(params, opt, mvs[j], prs[j],
                                       targets[j])
            gnorm = gn if gnorm is None else gnorm + gn
            drops = dr if drops is None else drops + dr
        return loss, p, gnorm, drops

    return step_multi
