"""Command-line interface of the port: ``python -m pathtrace_tpu_torch``.

The reference CLI's render flags (``-W -H -S -D -P -F -O --seed --out``),
the render path (``--mode auto|fast|general``: ``auto`` takes the fast
path where it can and the general integrator otherwise; ``compacted`` and
``sharded`` are refused as not ported yet), Latin-hypercube pixel samples
(``--stratify``), next-event estimation (``--nee``), Russian roulette
(``--rr DEPTH``), a user's own texture map for ``earth`` (``--image
PNG``), resumable renders (``--checkpoint PATH``: resume if it exists,
save every 50 frames and at the end) and snapshots of the accumulation
(``--snapshot-every N``, to ``--out``), plus ``--device`` (default
``cuda``). Every other flag of the JAX
package's CLI is refused as not ported yet. With ``-O`` (offline) the render runs
``-F`` accumulated frames (default 1); without ``-O`` the reference opens
its live preview, which is not ported, so ``-F`` is required.

``--out`` takes a ``.png`` (sRGB, flipped like the reference) or a ``.npy``
(the linear float image).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

from pathtrace_tpu_torch.config import Params
from pathtrace_tpu_torch.models import presets
from pathtrace_tpu_torch.models.types import SceneFeatures


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtrace_tpu_torch",
        description="Path tracer, PyTorch/CUDA port: the fast path (spheres, "
                    "rects, boxes, media and image textures) and the general "
                    "wavefront integrator (every scene, instances and nested "
                    "checkers included)",
    )
    p.add_argument("-W", "--width", type=int, default=1280, help="Image width")
    p.add_argument("-H", "--height", type=int, default=720, help="Image height")
    p.add_argument("-S", "--samples", type=int, default=4,
                   help="Samples per pixel per frame")
    p.add_argument("-D", "--depth", type=int, default=10,
                   help="Max bounces per ray")
    p.add_argument("-P", "--preset", default="two_perlin_spheres",
                   help=f"Scene preset ({', '.join(presets.names())})")
    p.add_argument("-F", "--frames", type=int, default=None,
                   help="Number of accumulated frames")
    p.add_argument("-O", "--offline", action="store_true",
                   help="Offline render (no live preview)")
    p.add_argument("--seed", type=int, default=0, help="Base RNG seed")
    p.add_argument("--mode", default="auto",
                   choices=("auto", "fast", "general", "compacted", "sharded"),
                   help="Render path: auto (the fast path where it takes the "
                        "scene, else the general integrator), fast, general; "
                        "compacted and sharded are not ported yet")
    p.add_argument("--stratify", action="store_true",
                   help="Latin-hypercube pixel sampling: each pixel's S "
                        "samples in distinct 1/S strata on both film axes "
                        "(unbiased; lower variance than iid jitter)")
    p.add_argument("--nee", action="store_true",
                   help="Next-event estimation: sample lights directly with "
                        "shadow rays, combined with BSDF sampling by MIS "
                        "(unbiased; less noise on light-driven scenes)")
    p.add_argument("--rr", type=int, default=0, metavar="DEPTH",
                   help="Russian-roulette path termination from this bounce "
                        "depth (0 = off). Unbiased")
    p.add_argument("--image", default=None, metavar="PNG",
                   help="Texture map for presets with an image texture "
                        "(earth): a PNG or JPEG; default: a procedural map")
    p.add_argument("--out", default="output.png",
                   help="Output path: .png (sRGB) or .npy (linear float)")
    p.add_argument("--checkpoint", default=None,
                   help="Checkpoint .npz path: resume from it if it exists, "
                        "save to it every 50 frames and at the end")
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="Write the accumulated image to --out every N frames")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        print(f"pathtrace_tpu_torch: {' '.join(unknown)}: not ported yet",
              file=sys.stderr)
        return 2
    if not args.offline and args.frames is None:
        print("pathtrace_tpu_torch: the live preview is not ported yet; "
              "pass -O or -F N", file=sys.stderr)
        return 2

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print(f"pathtrace_tpu_torch: --device {args.device} but CUDA is not "
              "available", file=sys.stderr)
        return 2
    params = Params(width=args.width, height=args.height,
                    samples=args.samples, max_depth=args.depth,
                    seed=args.seed)
    print(f"generating '{args.preset}' preset at {params.width}x{params.height}"
          f" with {params.samples} samples per pixel")
    try:
        scene, camera = presets.from_name(args.preset, params.aspect,
                                          seed=params.seed,
                                          image_path=args.image)
        features = SceneFeatures.from_scene(scene)
        from pathtrace_tpu_torch.ops.lights import build_light_table
        from pathtrace_tpu_torch.render.progressive import (
            render_progressive,
            route,
            save_image,
        )

        path = route(scene, features, args.mode,
                     build_light_table(scene) if args.nee else None)
    except (ValueError, OSError) as e:
        print(f"pathtrace_tpu_torch: {e}", file=sys.stderr)
        return 2
    print(f"scene features: {features}")
    print(f"render path: {path} (--mode {args.mode})")

    start = time.monotonic()
    result = render_progressive(scene, camera, params,
                                max_frames=args.frames or 1,
                                device=args.device, features=features,
                                nee=args.nee, rr_start=args.rr,
                                stratify=args.stratify, mode=path,
                                checkpoint_path=args.checkpoint,
                                snapshot_path=args.out,
                                snapshot_every=args.snapshot_every)
    elapsed = time.monotonic() - start
    # same report shape as the JAX CLI's offline line
    print(f"{elapsed:.2f}secs {result.total_rays}rays "
          f"{result.total_rays / 1e6 / elapsed:.2f}Mrays/s")
    print(f"frame time ({result.timer}): "
          + " ".join(f"{ms:.2f}ms" for ms in result.frame_ms)
          + "; readbacks per frame: "
          + " ".join(str(r) for r in result.readbacks))
    save_image(args.out, result.image)
    print(f"wrote {args.out} after {result.frames} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
