"""Asset converter CLI: .ply <-> .splat with the viewer's activation and
quantization semantics (the port's counterpart of
``splatjax/tools/convert.py``; host only, nothing touches a device):

    python -m splatjax_torch.tools.convert scene.ply scene.splat
    python -m splatjax_torch.tools.convert scene.splat scene.ply
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help=".ply or .splat input")
    ap.add_argument("output", help=".splat or .ply output")
    ap.add_argument(
        "--no-importance-sort",
        action="store_true",
        help="skip the descending exp(scale)*sigmoid(opacity) sort",
    )
    ap.add_argument(
        "--max-sh-degree", type=int, default=3,
        help="SH bands to keep when reading .ply (only .ply output "
        "preserves them; .splat stores DC color only)",
    )
    args = ap.parse_args(argv)

    from splatjax_torch.io import load_ply, load_splat, save_ply, save_splat

    if args.input.endswith(".ply"):
        scene = load_ply(
            args.input,
            importance_sort=not args.no_importance_sort,
            max_sh_degree=args.max_sh_degree,
            device="cpu",
        )
    elif args.input.endswith(".splat"):
        scene = load_splat(args.input, device="cpu")
    else:
        print(f"unsupported input format: {args.input}", file=sys.stderr)
        return 2

    if args.output.endswith(".splat"):
        save_splat(args.output, scene)
    elif args.output.endswith(".ply"):
        save_ply(args.output, scene)
    else:
        print(f"unsupported output format: {args.output}", file=sys.stderr)
        return 2
    print(f"{args.input} -> {args.output}: {scene.num_gaussians} gaussians")
    return 0


if __name__ == "__main__":
    sys.exit(main())
