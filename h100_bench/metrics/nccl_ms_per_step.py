"""NCCL's device time per traced band step, in ms: the NCCL kernels
launched inside any of the program's collective spans (``sj.redistribute``,
``sj.redistribute_bwd``, ``sj.band_gather``, ``sj.band_gather_bwd``,
``sj.grad_reduce``), on rank 0. A collective's kernel runs until every
rank has joined it, so this holds the wait for the slowest rank too."""
import spans

SPANS = ("sj.redistribute", "sj.redistribute_bwd", "sj.band_gather",
         "sj.band_gather_bwd", "sj.grad_reduce")


def read(run):
    t = run.trace
    if t is None or run.unit != "step" or not t.units:
        return None
    inside = [iv for name in SPANS for iv in spans.intervals(t, name)]
    if not inside:
        return None
    us = sum(d for name, _, d, at in t.kernels
             if at is not None and "nccl" in name.lower()
             and any(a <= at <= b for a, b in inside))
    return us / 1e3 / t.units
