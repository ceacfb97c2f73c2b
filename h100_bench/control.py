#!/usr/bin/env python3
"""The readings that a cell's limits are set from:

    python3 h100_bench/control.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--faults half] [--seconds 1]

For each of ``--seeds`` it makes a short run of the cell as
``h100_bench/run.py`` does (the same driver, at the cell's own size) and
prints the numbers it compares: the program's readings, whose largest sets
the lower end of each limit. For each of ``--control-seeds`` it prints the
control's readings against the same reference, whose smallest sets the
upper end: the control is the traffic file's ``control``, the program's
own lower-precision path (``feature_bytes``) or the reference itself run
in bfloat16 (``dtype``). ``--faults half`` also reads a training cell's
planted fault: the reference, put in the program's place, taking its loss
over half of the image's rows. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def frames_control(driver, cell, seed, device):
    import torch

    import compare
    import inputs

    fr = driver.Frames(cell, seed, device, HERE)
    scene = fr.scene()
    demands = fr.demands(scene)
    sample = fr.sample(list(range(fr.n)), demands)
    refs = {r: fr.reference(scene, r).image for r in sample}
    ctl = fr.tr["control"]
    if "feature_bytes" in ctl:
        cap = inputs.capacity(demands, float(fr.tr["capacity_margin"]))
        frame = fr.frame_fn(fr.renderer(scene, cap, ctl["feature_bytes"]))
        warm = int(fr.tr["warmup_frames"])
        got = {}
        for g in range(warm + fr.n):
            img, _ = frame(g)
            if g >= warm and g % fr.n in sample:
                got[g % fr.n] = img
    else:
        dtype = getattr(torch, ctl["dtype"])
        got = {r: fr.reference(scene, r, dtype=dtype).image for r in sample}
    return compare.images([(got[r], refs[r]) for r in sample])


def steps_control(driver, cell, seed, device, fault=None):
    import torch

    import compare

    st = driver.Steps(cell, seed, device, HERE)
    targets = st.targets()
    k = int(st.tr["reference_steps"])
    ref, _ = st.reference_steps(targets, k)
    if fault == "half":
        got, _ = st.reference_steps(targets, k,
                                    rows_in_loss=int(st.cfg["height"]) // 2)
    else:
        got, _ = st.reference_steps(
            targets, k, dtype=getattr(torch, st.tr["control"]["dtype"]))
    return compare.training(got, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import harness

    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    harness.require_cards(cell.chips)
    driver = bench.driver(cell)
    rows = []
    for seed in _seeds(args.seeds):
        run = driver.run(cell, seed=seed, seconds=args.seconds, trace=False,
                         device="cuda", t0=time.perf_counter(),
                         bench_dir=HERE)
        rows.append({"seed": seed, "side": "program", **run.checks})
        print(json.dumps(rows[-1]), flush=True)
    for seed in _seeds(args.control_seeds):
        if cell.traffic["driver"] == "frames":
            got = frames_control(driver, cell, seed, "cuda")
        else:
            got = steps_control(driver, cell, seed, "cuda")
        rows.append({"seed": seed, "side": "control", **got})
        print(json.dumps(rows[-1]), flush=True)
        for fault in [f for f in args.faults.split(",") if f]:
            got = steps_control(driver, cell, seed, "cuda", fault)
            rows.append({"seed": seed, "side": f"fault:{fault}", **got})
            print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for side in sorted({r["side"] for r in rows}):
        mine = [r for r in rows if r["side"] == side]
        keys = [k for k in mine[0] if k not in ("seed", "side")]
        pick = max if side == "program" else min
        summary[side] = {k: pick(r[k] for r in mine) for k in keys}
    print(json.dumps({"workload": args.workload, "lower_is_max_of_program":
                      summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
