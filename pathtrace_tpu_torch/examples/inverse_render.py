"""Inverse rendering on the card: recover perturbed albedos from a target
image (counterpart of ``examples/inverse_render.py``).

Renders the target from the preset, perturbs the albedos (+0.2, clipped
to [0, 1]), takes ``--steps`` Adam steps on the image MSE and writes
``target | optimized`` side by side:

    python -m pathtrace_tpu_torch.examples.inverse_render --steps 40 --size 32
    python -m pathtrace_tpu_torch.examples.inverse_render --device cpu --steps 3 --size 16
    python -m pathtrace_tpu_torch.examples.inverse_render --preset random --width 1280 --height 720 --depth 4 --trainable default

``--trainable color`` (the default, as in the reference's example) trains
the texture colours; ``--trainable default`` trains every leaf of the
reference's default selector (sphere centres and radii, texture colours,
fuzz, refractive index; in a scene with moving spheres, such as
``--preset random``, the substring ``spheres.center`` also selects the
motion leaf ``spheres.center_delta``). It trains over
``make_render_mesh()`` (every visible card) with ``--device cuda``, as
the reference's example trains over every device, else on the named
device. Every render is keyed by
``PRNGKey(0)``, as the reference example's, so the target and every step
trace the same rays with the same bounce seed. Each step prints its loss
(before the update) and its time: CUDA events around the step on the card, the host clock on
the CPU.

``--geometry`` trains the texture colours and ``spheres.center`` (by exact
name, so no ``center_delta``) with the silhouette boundary term on, from
centres moved +0.05 in x, as the reference's example does.
``--checkpoint PATH`` resumes from a TrainState checkpoint when one is
there (the step, the parameters, Adam's moments and count, the key: bit
for bit), saves every ``--checkpoint-every`` steps and at the end, in the
reference's layout (:mod:`~pathtrace_tpu_torch.utils.checkpoint`):

    python -m pathtrace_tpu_torch.examples.inverse_render --device cpu --geometry --steps 5 --size 16
    python -m pathtrace_tpu_torch.examples.inverse_render --device cpu --steps 4 --checkpoint train.npz
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pathtrace_tpu_torch.examples.inverse_render")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--size", type=int, default=32,
                    help="square film side (unless --width/--height)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--preset", default="small")
    ap.add_argument("--trainable", choices=("color", "default"),
                    default="color")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="inverse_result.png",
                    help="target | optimized, .png (sRGB) or .npy (linear)")
    ap.add_argument("--checkpoint", default=None,
                    help="TrainState checkpoint (.npz): resume from it if "
                         "present, save every --checkpoint-every steps and "
                         "at the end")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--geometry", action="store_true",
                    help="also train spheres.center, with the silhouette "
                         "boundary term")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    # A resumed run equals an uninterrupted one bit for bit only when each
    # step is deterministic. With a checkpoint the run takes torch's
    # deterministic algorithms (on CUDA, the scatter-add behind the
    # backward of the attribute rows' gather), and restores the setting on
    # return. The closest hit's backward (K6) sums per-sphere gradients
    # with atomics, so a run that trains sphere geometry resumes equal to
    # the last bits of those sums only.
    before = torch.are_deterministic_algorithms_enabled()
    if args.checkpoint:
        torch.use_deterministic_algorithms(True)
    try:
        return _run(args)
    finally:
        torch.use_deterministic_algorithms(before)


def _run(args) -> int:
    prog = "inverse_render"

    import numpy as np
    import torch

    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.parallel.mesh import make_render_mesh
    from pathtrace_tpu_torch.parallel.inverse import (
        default_trainable,
        make_inverse_renderer,
    )
    from pathtrace_tpu_torch.render import film
    from pathtrace_tpu_torch.utils import checkpoint as ckpt
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    dev = torch.device(args.device)
    on_cuda = dev.type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        print(f"{prog}: --device {args.device} but CUDA is not available",
              file=sys.stderr)
        return 2
    # every visible card for --device cuda, as the reference's example
    # trains on make_render_mesh(); a named device alone otherwise
    mesh = make_render_mesh(None if args.device == "cuda" else [dev])
    dev = mesh.home
    print(f"mesh: {mesh.size} shard(s) on {', '.join(map(str, mesh.devices))}")
    width = args.width or args.size
    height = args.height or args.size
    try:
        scene, cam = presets.from_name(args.preset, width / height)
        if args.geometry:
            def trainable(p):
                return "textures.color" in p or p == "spheres.center"
        elif args.trainable == "default":
            trainable = default_trainable
        else:
            def trainable(p):
                return "textures.color" in p
        renderer, state, names = make_inverse_renderer(
            scene, cam, width, height, samples=args.samples,
            max_depth=args.depth, mesh=mesh, trainable=trainable,
            learning_rate=args.lr, silhouette=args.geometry)
    except ValueError as e:
        print(f"{prog}: {e}", file=sys.stderr)
        return 2
    print(f"{args.preset} {width}x{height} {args.samples} spp depth "
          f"{args.depth} on {args.device}; trainable parameters: {names}")

    key = PRNGKey(0)
    with torch.no_grad():
        target = renderer.render(state.params, key)
        for i, name in enumerate(names):
            if name == "spheres.center":
                state.params[i][:, 0] += 0.05
            if name == "textures.color":
                state.params[i].copy_((state.params[i] + 0.2).clamp(0.0, 1.0))
    initial = [p.detach().clone() for p in state.params]

    start_step = 0
    if args.checkpoint:
        try:
            resumed = ckpt.try_load_train(args.checkpoint, state)
        except ValueError as e:
            print(f"{prog}: {args.checkpoint}: {e}", file=sys.stderr)
            return 2
        if resumed is not None:
            state, saved_key = resumed
            start_step = state.step
            if saved_key is not None:
                key = saved_key
            print(f"resumed from {args.checkpoint} at step {start_step}")

    if on_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    for step in range(start_step, args.steps):
        if on_cuda:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        else:
            t0 = time.perf_counter()
        state, loss = renderer.train_step(state, target, key)
        if on_cuda:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        losses.append(float(loss))
        step_ms.append(ms)
        print(f"step {step + 1}/{args.steps}: loss {losses[-1]:.8f}, "
              f"{ms:.2f} ms")
        if args.checkpoint and (step + 1) % args.checkpoint_every == 0:
            ckpt.save_train(args.checkpoint, state, key)
    if args.checkpoint:
        ckpt.save_train(args.checkpoint, state, key)
    moved = [float((p.detach() - p0).abs().max())
             for p, p0 in zip(state.params, initial)]
    print("largest parameter change: " + ", ".join(
        f"{n} {m:.6f}" for n, m in zip(names, moved)))
    if on_cuda:
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"peak device memory: {peak:.3f} GiB")
    if losses:
        print(f"loss: {losses[0]:.8f} -> {losses[-1]:.8f}")

    with torch.no_grad():
        img = renderer.render(state.params, key)
    side_by_side = np.concatenate(
        [target.cpu().numpy(), img.cpu().numpy()], axis=1)
    if args.out.endswith(".npy"):
        np.save(args.out, side_by_side)
    else:
        film.save_frame_png(args.out, side_by_side)
    print(f"wrote {args.out} (target | optimized)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
