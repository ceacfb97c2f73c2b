#!/usr/bin/env python3
"""The control readings that a band cell's limits are set from, on one
card:

    python3 h100_bench/control_band.py --workload sharded_4m_4k.band_step \\
        --seeds 1,2

For each seed it runs the cell's plain mean-view reference
(``reference_band``) over the compared steps from the cell's start and
targets, as ``drivers/band.py`` does after a run, and then two controls
against it, each printed as the numbers the cell compares:

* ``dtype``: the reference blending in the traffic file's ``control``
  dtype (bfloat16), the precision below the configuration's;
* ``half``: the reference taking its loss over half of the image's rows
  (a planted fault).

The program's own readings, the lower end of each limit, are those its
runs print (``run.py``'s ``[check]`` lines). The benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _readings(band, cell, seed, device) -> list:
    import torch

    import compare
    import reference

    st = band.steps.Steps(cell, seed, device, HERE)
    fit, k = st.fit, int(cell.traffic["reference_steps"])
    n_view = int(cell.config["mesh"]["view"])
    pairs = len(st.views) // n_view
    views = [st.views[(j % pairs) * n_view:(j % pairs + 1) * n_view]
             for j in range(k)]
    scene = band.inputs.tiled_scene(st.base, st.cfg, seed, device)
    images = {}
    for vs in views:
        for v in vs:
            if id(v) not in images:
                images[id(v)] = reference.render(
                    scene, v, rows=None, alpha_clip=fit["alpha_clip"],
                    early_stop=fit["early_stop"]).image
    del scene
    targets = [[images[id(v)] for v in vs] for vs in views]
    lrs = {n: fit[f"lr_{band.steps.LR_NAMES[n]}"] for n in band.steps.LEAVES}

    def steps(**kw):
        raw = st.start()
        raw0 = {n: v.clone() for n, v in raw.items() if v is not None}
        losses, grad, _ = band.reference_band.run_steps(
            raw, lrs, views, targets, k, rows=str(fit["feature_bytes"]),
            alpha_clip=fit["alpha_clip"], early_stop=fit["early_stop"],
            ssim_weight=fit["ssim_weight"], **kw)
        return {"loss": losses,
                "grad": {n: float(g.norm()) for n, g in grad.items()},
                "change": {n: float((raw[n] - raw0[n]).norm())
                           for n in grad}}

    ref = steps()
    dtype = getattr(torch, cell.traffic["control"]["dtype"])
    return [
        {"seed": seed, "control": "dtype",
         **compare.training(steps(dtype=dtype), ref)},
        {"seed": seed, "control": "half",
         **compare.training(steps(rows_in_loss=int(st.cfg["height"]) // 2),
                            ref)},
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import harness

    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    if args.device == "cuda":
        harness.require_cards(1)
    band = bench.driver(cell)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        for row in _readings(band, cell, seed, args.device):
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload, "controls": {
        c: {k: [r[k] for r in rows if r["control"] == c]
            for k in ("loss_gap", "grad_gap", "change_gap")}
        for c in ("dtype", "half")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
