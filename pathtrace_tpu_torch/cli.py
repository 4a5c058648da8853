"""Command-line interface of the port: ``python -m pathtrace_tpu_torch``.

Every flag of the JAX package's CLI that has a job on CUDA:

* the reference's render flags ``-W -H -S -D -P -F -O -R -B -X`` and
  ``--seed --out``: ``-R`` a random seed, ``-B`` the whole-scene BVH (its
  traversal kernel is the closest hit), ``-X`` the centre ray's trace
  (with ``-B``, the BVH's node walk first) and exit;
* the render path (``--mode auto|fast|general|compacted|sharded``:
  ``auto`` takes the fast path where it can and the general integrator
  otherwise, under the compaction ladder with ``-B``; ``sharded`` splits
  each frame's rays over every visible card) and the fast path's knobs
  (``--group N`` bounces between alive-count readbacks,
  ``--no-compaction``; neither changes an image bit);
* multi-process rendering (``--distributed``: join the NCCL group of
  torchrun's environment, as ``torchrun --nproc_per_node=N -m
  pathtrace_tpu_torch --distributed --mode sharded``; gloo with ``--device
  cpu``; rank 0 writes the files);
* the estimators: Latin-hypercube pixel samples (``--stratify``),
  next-event estimation (``--nee``), Russian roulette (``--rr DEPTH``),
  adaptive sampling (``--adaptive SPP``: one offline render to an average
  of SPP samples a pixel, ``-S`` a round), the à-trous denoiser
  (``--denoise``, guided by 2-sample AOVs) and the first-hit AOVs
  (``--aovs``: ``<out>.normal/.albedo/.depth.png``);
* a user's own texture map for ``earth`` (``--image PNG``), resumable
  renders (``--checkpoint PATH``: resume if it exists, save every 50
  frames and at the end), snapshots of the accumulation
  (``--snapshot-every N``, to ``--out``), a ``torch.profiler`` trace of the
  run (``--profile-dir DIR``: a Chrome trace with the card's kernels);
* ``--device`` (default ``cuda``).

With ``-O`` (offline) the render runs ``-F`` accumulated frames (default
1). Without it the progressive loop runs with the live preview on
(``--no-preview`` turns it off, ``--preview-port`` sets its port) until
``-F`` frames or Ctrl-C, then writes ``--out``. ``--pallas`` and
``--platform`` choose a TPU kernel and a JAX backend: the CLI refuses them
as TPU-only.

``--out`` takes a ``.png`` (sRGB, flipped like the reference) or a ``.npy``
(the linear float image).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import numpy as np

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
                   help="Number of accumulated frames (without -O: run "
                        "until Ctrl-C when not given)")
    p.add_argument("-O", "--offline", action="store_true",
                   help="Offline render (no live preview)")
    p.add_argument("-R", "--random", action="store_true",
                   help="Use a random seed")
    p.add_argument("-X", "--print", dest="print_trace", action="store_true",
                   help="Debug print a single-ray trace and exit")
    p.add_argument("--seed", type=int, default=0, help="Base RNG seed")
    p.add_argument("-B", "--bvh", action="store_true",
                   help="Use bounding volume hierarchy instead of brute force")
    p.add_argument("--mode", default="auto",
                   choices=("auto", "fast", "general", "compacted", "sharded"),
                   help="Render path: auto (the fast path where it takes the "
                        "scene, else the general integrator: compacted with "
                        "-B), fast, general, compacted (the general "
                        "integrator under the host's compaction ladder; no "
                        "NEE or roulette), sharded (each frame's rays split "
                        "over every visible card, or over the processes "
                        "with --distributed)")
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
    p.add_argument("--group", type=int, default=None, metavar="N",
                   help="Bounces between alive-count readbacks on the fast "
                        "path (default: fastpath.GROUP); no image bit "
                        "depends on it")
    p.add_argument("--no-compaction", action="store_true",
                   help="Keep every lane to the last bounce on the fast "
                        "path (no compaction ladder); the same image")
    p.add_argument("--aovs", action="store_true",
                   help="Also write first-hit AOV buffers (<out>.normal/"
                        ".albedo/.depth.png)")
    p.add_argument("--adaptive", type=int, default=0, metavar="SPP",
                   help="Adaptive sampling to an average budget of SPP "
                        "samples a pixel: after a uniform warmup, each "
                        "round refines the quarter of the pixels of "
                        "highest variance (-S samples a pixel a round). "
                        "Implies one offline render")
    p.add_argument("--denoise", action="store_true",
                   help="Edge-avoiding a-trous wavelet filter on the final "
                        "image, guided by first-hit AOVs")
    p.add_argument("--no-preview", action="store_true",
                   help="Without -O: no live HTTP preview")
    p.add_argument("--preview-port", type=int, default=0,
                   help="Port of the live preview (0 = ephemeral)")
    p.add_argument("--profile-dir", default=None,
                   help="Write a torch.profiler trace of the run (CUDA "
                        "activity on the card) into this directory")
    p.add_argument("--pallas", action="store_true",
                   help="TPU-only (the Pallas sphere kernel): refused")
    p.add_argument("--platform", default=None, metavar="NAME",
                   help="TPU-only (a JAX backend): refused; use --device")
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
    p.add_argument("--distributed", action="store_true",
                   help="Join the process group of torchrun's environment "
                        "(NCCL on cuda:LOCAL_RANK; gloo with --device cpu)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        print(f"pathtrace_tpu_torch: unrecognized arguments: "
              f"{' '.join(unknown)}", file=sys.stderr)
        return 2
    for flag, given, what in (
            ("--pallas", args.pallas, "the JAX package's Pallas sphere "
             "kernel; the port's closest hit is its CUDA kernel"),
            ("--platform", args.platform is not None, "a JAX backend; the "
             "port takes --device")):
        if given:
            print(f"pathtrace_tpu_torch: {flag} is TPU-only ({what})",
                  file=sys.stderr)
            return 2

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print(f"pathtrace_tpu_torch: --device {args.device} but CUDA is not "
              "available", file=sys.stderr)
        return 2
    device = args.device
    if args.distributed:
        from pathtrace_tpu_torch.parallel.mesh import init_distributed

        # raises without torchrun's environment or when the group fails
        device = str(init_distributed(args.device))
    try:
        if args.profile_dir:
            return _profiled(args, device)
        return _run(args, device)
    finally:
        if args.distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


def _profiled(args, device: str) -> int:
    """``_run`` under ``torch.profiler`` (CPU activity, and CUDA activity
    on a card); the Chrome trace goes to ``<profile-dir>/trace.json``."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(args.profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        rc = _run(args, device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
    print(f"profiler trace written to {args.profile_dir}")
    return rc


def _run(args, device: str) -> int:
    import torch.distributed as dist

    params = Params(width=args.width, height=args.height,
                    samples=args.samples, max_depth=args.depth,
                    seed=args.seed, random_seed=args.random,
                    use_bvh=args.bvh)
    print(f"generating '{args.preset}' preset at {params.width}x{params.height}"
          f" with {params.samples} samples per pixel")
    try:
        scene, camera = presets.from_name(args.preset, params.aspect,
                                          seed=params.seed,
                                          image_path=args.image)
        features = SceneFeatures.from_scene(scene)
        from pathtrace_tpu_torch.ops.fastpath import (
            fastpath_refusal,
            fused_refusal,
        )
        from pathtrace_tpu_torch.ops.lights import build_light_table
        from pathtrace_tpu_torch.render.progressive import (
            render_progressive,
            route,
            save_image,
        )

        nee_lights = build_light_table(scene) if args.nee else None
        path = route(scene, features, args.mode, args.bvh)
        tree = None
        if args.bvh:
            from pathtrace_tpu_torch.models.bvh import build_scene_bvh

            # "cannot build BVH over empty primitive set" ends here
            tree = build_scene_bvh(scene, seed=params.seed)
    except (ValueError, OSError) as e:
        print(f"pathtrace_tpu_torch: {e}", file=sys.stderr)
        return 2
    print(f"scene features: {features}")
    writer = not dist.is_initialized() or dist.get_rank() == 0
    if args.print_trace:
        from pathtrace_tpu_torch.utils.debug import print_ray_trace

        print_ray_trace(scene, camera, params.max_depth, seed=params.seed,
                        use_bvh=args.bvh, device=device)
        return 0
    if args.aovs:
        from pathtrace_tpu_torch.render.aov import render_aovs, save_aov_pngs
        from pathtrace_tpu_torch.utils.threefry import PRNGKey

        start = time.monotonic()
        aovs = render_aovs(scene.to(device), camera.to(device), params.width,
                           params.height, PRNGKey(params.resolve_seed()),
                           features=features)
        aovs = {k: v.cpu() for k, v in aovs.items()}  # waits for the pass
        print(f"aovs: {(time.monotonic() - start) * 1e3:.1f} ms (one "
              "first-hit pass and its readback)")
        prefix = args.out[:-4] if args.out.endswith(".png") else args.out
        if writer:
            save_aov_pngs(aovs, prefix)
            print(f"wrote {prefix}.normal/.albedo/.depth.png")
    if args.adaptive:
        return _adaptive(args, device, scene, camera, params, features,
                         nee_lights, writer)
    # general shards drop the tree (render_progressive logs it)
    tree_used = args.bvh and not (path == "sharded"
                                  and fused_refusal(features, scene)
                                  is not None)
    line = (f"render path: {path} (--mode {args.mode}, intersect: "
            f"{'bvh' if tree_used else 'sweep'})")
    if args.mode == "auto" and path != "fast":
        # the port's own fallback where the reference takes its fast path
        line += f"; the fast path refuses the scene: " \
                f"{fastpath_refusal(features, scene)}"
    print(line)

    # offline: -F frames (default 1); interactive: until -F or Ctrl-C,
    # with the live preview on unless --no-preview
    frames = (args.frames or 1) if args.offline else args.frames
    # Ctrl-C ends an interactive run on one process; the frames done are
    # written. The newest accumulation is kept by reference: the loop
    # blends each frame into a new tensor, never into a published one.
    interactive = not args.offline and not args.distributed
    kept = {"frames": 0, "acc": None}

    def keep(_done, acc):
        kept["frames"] += 1
        kept["acc"] = acc

    start = time.monotonic()
    try:
        result = render_progressive(
            scene, camera, params, max_frames=frames, device=device,
            features=features, nee=args.nee, rr_start=args.rr,
            stratify=args.stratify, mode=path,
            checkpoint_path=args.checkpoint, snapshot_path=args.out,
            snapshot_every=args.snapshot_every, bvh=tree, group=args.group,
            compaction=not args.no_compaction,
            on_frame=keep if interactive else None,
            preview=not args.offline and not args.no_preview,
            preview_port=args.preview_port)
    except KeyboardInterrupt:
        if not interactive:
            raise
        print(f"interrupted after {kept['frames']} frames")
        n_frames = kept["frames"]
        image = (kept["acc"].cpu().numpy() if kept["acc"] is not None else
                 np.zeros((params.height, params.width, 3), np.float32))
    else:
        elapsed = time.monotonic() - start
        # same report shape as the JAX CLI's offline line
        print(f"{elapsed:.2f}secs {result.total_rays}rays "
              f"{result.total_rays / 1e6 / elapsed:.2f}Mrays/s")
        print(f"frame time ({result.timer}): "
              + " ".join(f"{ms:.2f}ms" for ms in result.frame_ms)
              + "; readbacks per frame: "
              + " ".join(str(r) for r in result.readbacks))
        n_frames, image = result.frames, result.image
    if args.denoise:
        image = _denoise(scene, camera, params, features, image, device)
    if writer:
        save_image(args.out, image)
        print(f"wrote {args.out} after {n_frames} frames")
    return 0


def _denoise(scene, camera, params, features, image, device):
    from pathtrace_tpu_torch.api import denoise_image

    start = time.monotonic()
    out = denoise_image(scene, camera, params, features, image, device)
    print(f"denoise: {(time.monotonic() - start) * 1e3:.1f} ms (2-sample "
          "AOVs and 5 a-trous passes)")
    return out


def _adaptive(args, device, scene, camera, params, features, nee_lights,
              writer) -> int:
    """``--adaptive SPP``: one offline render by the adaptive rounds, then
    ``--denoise``, then ``--out``."""
    from pathtrace_tpu_torch.render.adaptive import render_adaptive
    from pathtrace_tpu_torch.render.progressive import save_image

    timings = {}
    start = time.monotonic()
    image, total_rays, _ = render_adaptive(
        scene, camera, params, args.adaptive, device=device,
        features=features, nee_lights=nee_lights,
        mode="general" if args.mode == "general" else "auto",
        timings=timings)
    elapsed = time.monotonic() - start
    print(f"{elapsed:.2f}secs {total_rays}rays "
          f"{total_rays / 1e6 / elapsed:.2f}Mrays/s")
    print("adaptive time: " + ", ".join(
        f"{k[:-2]} {v * 1e3:.1f} ms" for k, v in timings.items()
        if k.endswith("_s")))
    if args.denoise:
        image = _denoise(scene, camera, params, features, image, device)
    if writer:
        save_image(args.out, image)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
