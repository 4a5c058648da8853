"""Where one step's device time goes, on the card.

    python -m pathtrace_tpu_torch.tools.profile_step --what train
    python -m pathtrace_tpu_torch.tools.profile_step --what frame
    python -m pathtrace_tpu_torch.tools.profile_step --what frame --preset random_spheres_xl
    python -m pathtrace_tpu_torch.tools.profile_step --what frame --preset random
    python -m pathtrace_tpu_torch.tools.profile_step --what frame --preset simple_light --nee --rr 3
    python -m pathtrace_tpu_torch.tools.profile_step --what frame --preset cornell_smoke --nee --rr 3
    python -m pathtrace_tpu_torch.tools.profile_step --what frame --preset earth
    python -m pathtrace_tpu_torch.tools.profile_step --what megakernel --preset simple_light
    python -m pathtrace_tpu_torch.tools.profile_step --what general --preset random_spheres
    python -m pathtrace_tpu_torch.tools.profile_step --what general --preset final_full --warmup 1 --reps 2

``train``: the inverse-rendering trainer on ``--preset`` (default
random_spheres; every default-trainable leaf, perturbed albedos, as
``examples/inverse_render.py --trainable default``), 1280x720, 4 spp,
depth 4. ``frame``: one frame of the render path (1280x720, 4 spp,
depth 10) of ``--preset``, with next-event estimation (``--nee``) and
Russian roulette from depth ``--rr``, as the CLI's flags; the frame's
alive-count readbacks and segments (shadow rays included) are reported
too. ``general``: one frame of the general integrator
(``render/frame.render_frame``, as ``--mode general`` renders it) at the
same film, with its readbacks (one a bounce), bounces and segments.
``megakernel``: one frame of the megakernel
path at the same film (primary rays, K7 over tables built once per scene,
the sample mean). After warm-up steps, ``--reps`` unprofiled steps are
timed with CUDA events, then one step runs under ``torch.profiler``: the
device time of every kernel, summed by kind, the forward's share, the
step's device launches (kernels, copies and fills), and the device's idle
share two ways: of the profiled step's wall time (the
profiler's own, inflated by its overhead on the host), and of the
unprofiled median (1 - busy / median). ``frame`` and ``megakernel`` also
report host spans (``perf_counter``, medians): the frame's key work
(``fold_in``, ``split`` and the draws' key words), one Threefry draw's
wrapper and ``torch.rand`` of the same shape (each its launch enqueued,
not waited for), and for ``megakernel`` the whole of
``generate_primary_rays`` with the key derivation before it, enqueued in
each timed step. The last line of the output is a JSON object with the
same numbers; ``--out`` writes it to a file too.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Optional, Sequence

# kernel-name fragments -> kind, first match wins
_SCATTER = "scatter-adds and index copies (index_add_, index_copy_)"
_GATHER = "gathers (index_select and indexing)"
_COPY = "copies, concatenations and fills"
KINDS = (
    ("megakernel", "K7 megakernel"),
    ("sphere_nearest_bwd", "K6 closest-hit backward"),
    ("sphere_nearest_culled_kernel<false", "K4 closest hit, flat cull"),
    ("sphere_nearest_culled_kernel<true", "K5 closest hit, two-level cull"),
    ("sphere_nearest_kernel<true", "K3 closest hit, moving spheres"),
    ("sphere_nearest_kernel", "K1 closest hit"),
    ("shade_kernel", "K2 fused shade"),
    ("indexFuncLargeIndex", _SCATTER),
    ("indexFuncSmallIndex", _SCATTER),
    ("index_elementwise", _GATHER),
    ("gather", _GATHER),
    ("scatter", _SCATTER),
    ("multi_tensor_apply", "optimizer (Adam)"),
    ("reduce_kernel", "reductions (sum, mean, any)"),
    ("CatArray", _COPY),
    ("direct_copy", _COPY),
    ("FillFunctor", _COPY),
    ("Memcpy", _COPY),
    ("Memset", _COPY),
    ("<long", "int64 elementwise (the counter-hash RNG)"),
    ("elementwise", "float elementwise (shading, forward and backward)"),
)


def _kind(name: str) -> str:
    for frag, kind in KINDS:
        if frag in name:
            return kind
    return "other"


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def _total_device_us(evt) -> float:
    return float(getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0)))


def device_launches(fn) -> int:
    """Device operations (kernels, copies and fills) that one call of
    ``fn`` puts on the card, counted by ``torch.profiler`` after one
    unprofiled warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(evt.count for evt in prof.key_averages()
               if str(getattr(evt, "device_type", "")).endswith("CUDA"))


def _setup_train(dev, preset):
    import torch

    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.parallel.inverse import make_inverse_renderer
    from pathtrace_tpu_torch.utils import threefry

    scene, cam = presets.from_name(preset, 1280 / 720)
    renderer, state, names = make_inverse_renderer(
        scene, cam, 1280, 720, samples=4, max_depth=4, device=dev)
    key = threefry.PRNGKey(0)  # every render, as the example keys them
    with torch.no_grad():
        target = renderer.render(state.params, key)
        for i, name in enumerate(names):
            if name == "textures.color":
                state.params[i].copy_((state.params[i] + 0.2).clamp(0.0, 1.0))
    box = {"state": state}

    def step():
        from torch.profiler import record_function

        st = box["state"]
        st.optimizer.zero_grad(set_to_none=True)
        with record_function("forward"):
            loss = renderer.loss(st.params, target, key)
        loss.backward()
        st.optimizer.step()
        box["state"] = st._replace(step=st.step + 1)

    return step


def _setup_frame(dev, preset, nee, rr, info):
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops.fastpath import render_frame_fast
    from pathtrace_tpu_torch.ops.lights import build_light_table
    from pathtrace_tpu_torch.utils import threefry

    scene, cam = presets.from_name(preset, 1280 / 720)
    scene, cam = scene.to(dev), cam.to(dev)
    feats = SceneFeatures.from_scene(scene)
    lights = build_light_table(scene) if nee else None
    base_key = threefry.PRNGKey(0)
    box = {"frame": 0}

    def step():
        box["frame"] += 1
        res = render_frame_fast(scene, cam, 1280, 720, 4, 10,
                                threefry.fold_in(base_key, box["frame"]),
                                box["frame"], feats, nee_lights=lights,
                                rr_start=rr)
        info["readbacks"] = res.readbacks
        info["segments"] = res.ray_count

    return step


def _setup_general(dev, preset, nee, rr, info):
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops.lights import build_light_table
    from pathtrace_tpu_torch.render import integrator
    from pathtrace_tpu_torch.render.frame import render_frame
    from pathtrace_tpu_torch.utils import threefry

    scene, cam = presets.from_name(preset, 1280 / 720)
    scene, cam = scene.to(dev), cam.to(dev)
    feats = SceneFeatures.from_scene(scene)
    lights = build_light_table(scene) if nee else None
    base_key = threefry.PRNGKey(0)
    box = {"frame": 0}

    def step():
        box["frame"] += 1
        r0, b0 = integrator.READBACKS, integrator.BOUNCES
        _, count = render_frame(scene, cam, 1280, 720, 4, 10,
                                threefry.fold_in(base_key, box["frame"]),
                                features=feats, nee_lights=lights,
                                rr_start=rr)
        info["readbacks"] = integrator.READBACKS - r0
        info["bounces"] = integrator.BOUNCES - b0
        info["segments"] = count

    return step


def _host_spans(dev, reps: int = 200) -> dict:
    """Host ms (medians of ``reps`` calls, the device idle before each) of
    a frame's key work as ``generate_primary_rays`` does it, of one
    Threefry draw of the jitter's shape and of ``torch.rand`` of it."""
    import torch

    from pathtrace_tpu_torch.utils import threefry

    base = threefry.PRNGKey(0)
    shape = (720, 1280, 4, 2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def keys(n):
        for k in threefry.split(threefry.fold_in(base, n)):
            threefry._words(k)

    def span(fn):
        times = []
        for n in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(n + 1)
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    return {"key_host_ms": span(keys),
            "draw_host_ms": span(lambda n: threefry.uniform(base, shape, dev)),
            "rand_host_ms": span(lambda n: torch.rand(shape, generator=gen,
                                                      device=dev))}


def _setup_megakernel(dev, preset, info):
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops.megakernel import prep_tables, trace_megakernel
    from pathtrace_tpu_torch.render.frame import generate_primary_rays
    from pathtrace_tpu_torch.utils import threefry

    W, H, S, R = 1280, 720, 4, 1280 * 720 * 4
    scene, cam = presets.from_name(preset, W / H)
    scene, cam = scene.to(dev), cam.to(dev)
    feats = SceneFeatures.from_scene(scene)
    tables = prep_tables(scene)
    base_key = threefry.PRNGKey(0)
    box = {"frame": 0}

    def step():
        box["frame"] += 1
        t0 = time.perf_counter()
        ro, rd, t = generate_primary_rays(
            cam, W, H, S, threefry.fold_in(base_key, box["frame"]))
        info.setdefault("rays_host_ms", []).append(
            (time.perf_counter() - t0) * 1e3)
        rad, _ = trace_megakernel(tables, ro.reshape(R, 3), rd.reshape(R, 3),
                                  t.reshape(R), box["frame"], 10, feats)
        rad.reshape(H, W, S, 3).mean(dim=2)

    return step


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="profile_step")
    ap.add_argument("--what", choices=("train", "frame", "general",
                                       "megakernel"),
                    default="train")
    ap.add_argument("--preset", default="random_spheres",
                    help="scene of the frame or of the trainer")
    ap.add_argument("--nee", action="store_true",
                    help="frame: next-event estimation")
    ap.add_argument("--rr", type=int, default=0, metavar="DEPTH",
                    help="frame: Russian roulette from this depth (0: off)")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    info = {}
    if args.what == "frame":
        step = _setup_frame(dev, args.preset, args.nee, args.rr, info)
    elif args.what == "general":
        step = _setup_general(dev, args.preset, args.nee, args.rr, info)
    elif args.what == "megakernel":
        step = _setup_megakernel(dev, args.preset, info)
    else:
        step = _setup_train(dev, args.preset)
    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.reps):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    spans = None
    if args.what != "train":
        spans = _host_spans(dev)
        if "rays_host_ms" in info:
            spans["rays_host_ms"] = statistics.median(
                info["rays_host_ms"][-args.reps:])
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    kinds, kernels, regions = {}, [], {}
    for evt in prof.key_averages():
        if evt.key == "forward":
            # the range's device time: the kernels launched inside it (the
            # backward's run on autograd's own thread, so it gets no range)
            regions["forward"] = _total_device_us(evt) / 1e3
        elif str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = _device_us(evt)
            kernels.append((us, evt.count, evt.key))
            k = _kind(evt.key)
            kinds[k] = kinds.get(k, 0.0) + us / 1e3
    busy_ms = sum(us for us, _, _ in kernels) / 1e3
    launches = sum(c for _, c, _ in kernels)
    if regions:
        regions["backward and optimizer"] = busy_ms - regions["forward"]
    kernels.sort(reverse=True)
    result = {
        "what": args.what,
        "preset": args.preset,
        "card": smi, "torch": torch.__version__,
        "step_ms_median": statistics.median(times), "step_ms": times,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "idle_share_unprofiled": 1.0 - busy_ms / statistics.median(times),
        "peak_gib": peak_gib, "device_launches": launches,
        "nee": args.nee, "rr_start": args.rr,
        "readbacks": info.get("readbacks"),
        "bounces": info.get("bounces"),
        "segments": (int(info["segments"]) if "segments" in info else None),
        "host_spans_ms": spans,
        "regions_device_ms": regions,
        "kinds_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:160], "launches": c, "ms": us / 1e3}
                        for us, c, n in kernels[:15]],
    }
    print(f"{args.what} of {result['preset']}"
          + (f" (nee {args.nee}, rr {args.rr})"
             if args.what in ("frame", "general") else "")
          + f" on {smi} (torch {torch.__version__})")
    if result["segments"] is not None:
        print(f"segments {result['segments']}, readbacks {result['readbacks']}")
    print("step ms (CUDA events, unprofiled): "
          + ", ".join(f"{t:.3f}" for t in times))
    if spans is not None:
        print("host ms (medians): " + ", ".join(
            f"{k[:-3]} {v:.4f}" for k, v in spans.items()))
    print(f"profiled step: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} "
          f"ms, idle {result['idle_share']:.1%} (of the unprofiled median: "
          f"{result['idle_share_unprofiled']:.1%}), peak memory "
          f"{peak_gib:.3f} GiB, {launches} device launches")
    for name, ms in regions.items():
        print(f"  region {name}: {ms:.3f} ms of device time")
    for kind, ms in result["kinds_ms"].items():
        print(f"  {ms:9.3f} ms {ms / busy_ms:6.1%}  {kind}")
    for k in result["top_kernels"]:
        print(f"  {k['ms']:9.3f} ms x{k['launches']:<5d} {k['name'][:110]}")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
