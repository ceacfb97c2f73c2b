"""The numbers that decide ``correct``: what the timed path produced against
the plain reference."""
from __future__ import annotations

import statistics

import torch

# a pixel whose worst channel misses the reference by more than this is
# counted (the viewer-parity budget)
PIXEL_TOL = 1e-3


def images(pairs: list) -> dict:
    """(program, reference) image pairs -> the widest gap over every
    channel and the pixels (per million) over the parity budget."""
    worst, bad, total = 0.0, 0, 0
    for got, want in pairs:
        err = (got.float() - want.float()).abs().amax(dim=-1)
        err = torch.nan_to_num(err, nan=float("inf"))
        worst = max(worst, float(err.max()))
        bad += int((err > PIXEL_TOL).sum())
        total += err.numel()
    return {"max_err": worst, "bad_px_ppm": 1e6 * bad / max(total, 1)}


def _gap(got: float, want: float, scale: float) -> float:
    return abs(got - want) / scale if scale > 0 else abs(got - want)


def training(prog: dict, ref: dict) -> dict:
    """Three steps of the program against the reference's.

    ``loss``: each step's loss; ``grad``: each leaf's norm of the first
    step's gradient; ``change``: each leaf's norm of its change over three
    steps. Norms compare by the worst leaf: the gap of the two norms over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger. Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and stay out of ``change``."""
    loss_gap = max(_gap(p, r, abs(r)) for p, r in zip(prog["loss"],
                                                      ref["loss"]))
    med_g = statistics.median(ref["grad"].values())
    grad_gap = max(_gap(prog["grad"][k], g, max(g, med_g))
                   for k, g in ref["grad"].items())
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][k] for k in moved)
    change_gap = max(_gap(prog["change"][k], ref["change"][k],
                          max(ref["change"][k], med_c)) for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}
