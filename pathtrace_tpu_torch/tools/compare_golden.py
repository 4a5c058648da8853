"""Image parity against an external reference PNG (counterpart of
``tools/compare_golden.py``).

Two renderers with different random streams cannot agree bit for bit, so
this checks *statistical* parity: a noise-averaging downsample, then
MAE, bias and PSNR limits (``utils/compare.py``). Compare two PNGs, or a
preset rendered here by the port's general integrator on ``--device``
against a reference PNG.

Usage:
  # two PNGs
  python -m pathtrace_tpu_torch.tools.compare_golden ref.png --png test.png

  # render a preset here (the card by default) and compare
  python -m pathtrace_tpu_torch.tools.compare_golden ref.png --preset small -W 200 -H 100 -S 64

Exit code 0 within tolerance, 1 otherwise, 2 for an unknown preset; prints
one JSON line. The comparison is in sRGB PNG space, what both write.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="compare_golden")
    ap.add_argument("reference", help="Reference PNG (external ground truth)")
    ap.add_argument("--png", default=None, help="Test PNG to compare")
    ap.add_argument("--preset", default=None, help="Render this preset instead")
    ap.add_argument("-W", "--width", type=int, default=200)
    ap.add_argument("-H", "--height", type=int, default=100)
    ap.add_argument("-S", "--samples", type=int, default=64)
    ap.add_argument("-D", "--depth", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mae-tol", type=float, default=0.02)
    ap.add_argument("--bias-tol", type=float, default=0.008)
    ap.add_argument("--downsample", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device of a --preset render (default: cuda)")
    args = ap.parse_args(argv)
    if (args.png is None) == (args.preset is None):
        ap.error("provide exactly one of --png or --preset")

    from pathtrace_tpu_torch.render import film
    from pathtrace_tpu_torch.utils.compare import compare_images, downsample

    ref = film.read_png(args.reference).astype(np.float64) / 255.0
    if args.png:
        test = film.read_png(args.png).astype(np.float64) / 255.0
    else:
        import torch

        from pathtrace_tpu_torch.models import presets
        from pathtrace_tpu_torch.models.types import SceneFeatures
        from pathtrace_tpu_torch.render.frame import render_frame
        from pathtrace_tpu_torch.utils.threefry import PRNGKey

        try:
            scene, cam = presets.from_name(
                args.preset, args.width / args.height, seed=args.seed)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        dev = torch.device(args.device)
        img, _ = render_frame(scene.to(dev), cam.to(dev), args.width,
                              args.height, args.samples, args.depth,
                              PRNGKey(args.seed),
                              features=SceneFeatures.from_scene(scene))
        # PNG space: sRGB and the save-time vertical flip
        test = film.to_srgb_u8(img.cpu().numpy()[::-1]).astype(
            np.float64) / 255.0

    if ref.shape != test.shape:
        print(json.dumps({"error": "shape mismatch", "ref": list(ref.shape),
                          "test": list(test.shape)}))
        return 1
    f = max(args.downsample, 1)
    rep = compare_images(downsample(ref, f), downsample(test, f))
    ok = (rep.mean_abs_error < args.mae_tol
          and abs(rep.mean_signed_error) < args.bias_tol)
    print(json.dumps({
        "bench": "compare_golden",
        "reference": args.reference,
        "mae": round(rep.mean_abs_error, 6),
        "bias": round(rep.mean_signed_error, 6),
        "p99": round(rep.p99_abs_error, 6),
        "psnr_db": round(rep.psnr_db, 2),
        "pass": bool(ok),
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
