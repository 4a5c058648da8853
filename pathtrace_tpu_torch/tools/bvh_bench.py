"""The flat BVH traversal kernel (``csrc/bvh_traverse.cu``) and the
turbulence kernel (``csrc/turb.cu``) on the card, against their plain
versions and against another tree's build of the same sources, timed in
turns.

    python -m pathtrace_tpu_torch.tools.bvh_bench --what traverse --parent build/parent
    python -m pathtrace_tpu_torch.tools.bvh_bench --what turb --parent build/parent

``traverse`` runs the six scenes of ``chip_smoke.py``'s phase 49
(``random_spheres``, ``random``, ``random_spheres_xl``, ``cornell``,
``cornell_smoke``, ``final_full``) on 1280x720x4 camera rays and their
once-scattered rays (12 sets): each build's (t, gid, visits) must equal
the plain version's bit for bit; then every build runs ``--rounds``
rounds in turns (a, b, ..., b, a), each turn the mean of ``--reps``
launches between two CUDA events, queued behind a device sleep so the
events time the device alone, and the tool prints each build's median,
the profiler's device time (by pass for the turbulence), the bound
(``bvh_kernel.yardsticks``) and the launch plan (grid, instance).
``turb`` does the same for the turbulence on ``final_full``'s camera and
scattered hits.

The builds are this checkout's library (``new``) and, with ``--parent
DIR``, that tree's source built alone (``DIR/pathtrace_tpu_torch/csrc``,
e.g. the parent commit unpacked with ``git archive`` into
``build/parent``) into ``build/bvh_bench/parent/`` with the package's
flags. A parent turbulence source without the list argument is called
with the parent's signature. ``chip_smoke.py`` uses :func:`standalone`,
:func:`traverse_sets`, :func:`in_turns` and :func:`parent_kernels`.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
from typing import Callable, Dict, Optional, Sequence

W, H, S, D = 1280, 720, 4, 10
SCENES = ("random_spheres", "random", "random_spheres_xl", "cornell",
          "cornell_smoke", "final_full")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _vp(x):
    return None if x is None else x.data_ptr()


def standalone(builds: Dict[str, tuple]) -> dict:
    """Build each ``name: (source .cu, extra nvcc flags)`` alone into
    ``build/bvh_bench/<name>/lib.so`` with the package's flags, every
    compile started together. Returns {name: (ctypes.CDLL, ptxas log)};
    raises if one fails."""
    from pathtrace_tpu_torch.ops import _cuda_build

    nvcc = _cuda_build.find_nvcc()
    jobs = {}
    for name, (src, flags) in builds.items():
        out_dir = os.path.join(_ROOT, "build", "bvh_bench", name)
        os.makedirs(out_dir, exist_ok=True)
        lib = os.path.join(out_dir, "lib.so")
        cmd = [nvcc, *_cuda_build.NVCC_FLAGS, *flags, "-shared", "-o", lib,
               src]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    out = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        out[name] = (ctypes.CDLL(lib), log)
    return out


def traverse_fn(lib) -> Callable:
    """``run(op, rays, time, flights) -> (t, gid, visits)`` through the
    ``pt_bvh_traverse`` of ``lib`` (the signature every build shares)."""
    import torch

    from pathtrace_tpu_torch.config import MAX_T, MIN_T
    from pathtrace_tpu_torch.ops import _cuda_build

    fn = lib.pt_bvh_traverse
    fn.argtypes = _cuda_build._SIGNATURES["pt_bvh_traverse"]
    fn.restype = ctypes.c_int

    def run(op, rays, time, flights):
        R = rays.shape[1]
        dev = rays.device
        t = torch.empty(R, dtype=torch.float32, device=dev)
        g = torch.empty(R, dtype=torch.int32, device=dev)
        v = torch.empty(R, dtype=torch.int32, device=dev)
        _, off_r, off_b, off_m = op.offsets
        code = fn(rays.data_ptr(), rays.stride(0), R, _vp(time),
                  op.nodes.data_ptr(), op.n_nodes, op.node_rows,
                  op.prims.data_ptr(), _vp(flights), off_r, off_b, off_m,
                  op.flags, float(MIN_T), float(MAX_T), t.data_ptr(),
                  g.data_ptr(), v.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
        if code:
            raise RuntimeError(f"pt_bvh_traverse failed ({code})")
        return t, g, v

    return run


def turb_fn(lib, source: str) -> Callable:
    """``run(point, mask) -> [R]`` through the ``pt_noise_turb`` of
    ``lib``, called with or without the list's scratch as ``source``
    declares it."""
    import torch

    vp, ci = ctypes.c_void_p, ctypes.c_int
    scratch = "int* list, cudaStream_t" in open(source).read()
    fn = lib.pt_noise_turb
    fn.argtypes = [vp, vp, ci, vp] + ([vp] if scratch else []) + [vp]
    fn.restype = ci

    def run(point, mask):
        R = point.shape[0]
        out = torch.empty(R, dtype=torch.float32, device=point.device)
        extra = ([torch.empty(R, dtype=torch.int32,
                              device=point.device).data_ptr()]
                 if scratch else [])
        code = fn(point.data_ptr(), mask.data_ptr(), R, out.data_ptr(),
                  *extra, torch.cuda.current_stream(point.device).cuda_stream)
        if code:
            raise RuntimeError(f"pt_noise_turb failed ({code})")
        return out

    return run


def traverse_plan(lib, op, R: int) -> Optional[dict]:
    """The launch ``lib``'s ``pt_bvh_traverse_plan`` gives for ``op`` and
    ``R`` rays (None for a build without one)."""
    if not hasattr(lib, "pt_bvh_traverse_plan"):
        return None
    out = (ctypes.c_int * 3)()
    fn = lib.pt_bvh_traverse_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(R, op.flags, ctypes.addressof(out))
    if code:
        raise RuntimeError(f"pt_bvh_traverse_plan failed ({code})")
    return dict(zip(("blocks", "threads", "instance"), list(out)))


def traverse_sets(dev, names: Sequence[str] = SCENES):
    """Yield (scene, label, operand, rays [6, R], time, flights, n_media)
    for each scene's camera rays and once-scattered rays at 1280x720x4:
    K2's bounce where the fast path takes the scene, the general bounce
    through the tree for ``final_full``."""
    import torch

    from pathtrace_tpu_torch.models import bvh as pbvh
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import bvh_kernel
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.ops import shade_kernel as k2
    from pathtrace_tpu_torch.render import integrator as gint
    from pathtrace_tpu_torch.render.frame import generate_primary_rays
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    R = W * H * S
    for name in names:
        scene, cam = presets.from_name(name, W / H)
        feats = SceneFeatures.from_scene(scene)
        flat, _, offsets = pbvh.build_scene_bvh(scene)
        sdev = scene.to(dev)
        op = flat.operand(sdev, feats, offsets, dev)
        n_media = sdev.media.count if feats.has_media else 0
        ro, rd, tm = generate_primary_rays(cam, W, H, S, PRNGKey(0),
                                           device=dev)
        st0 = fp.make_state(ro.reshape(R, 3), rd.reshape(R, 3),
                            tm.reshape(R))

        def flights_at(depth):
            if not feats.has_media:
                return None
            return bvh_kernel.media_flights(op, fp.media_uniforms(
                st0.lane, 7, depth, n_media, 8))

        yield name, "camera", op, st0.planes[:6], st0.time, flights_at(0), \
            n_media
        if fp.fastpath_refusal(feats, sdev) is None:
            tables = fp.prep_tables(sdev, feats, bvh=flat,
                                    bvh_offsets=offsets)
            t_, idx_ = fp.closest_hit(tables, st0, 0, feats, 7)
            planes, _ = k2.shade_from_winners(
                tables.table, idx_, t_, st0.planes, st0.time, st0.alive,
                st0.lane, 7, 0, D, tables.sky4, fp.feature_flags(feats),
                atlas=tables.atlas)
            rays1 = planes[:6].contiguous()
            del tables, planes
        else:  # final_full: the general bounce it renders through
            fn = pbvh.make_bvh_intersect_fn(flat, offsets, feats)
            gt = gint.prep_tables(sdev, feats)
            st1 = gint._bounce(sdev, gt, gint._initial_state(
                ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R)),
                PRNGKey(7), D, feats, intersect_fn=fn)
            rays1 = torch.cat([st1.ro.T, st1.rd.T]).contiguous()
            del gt, st1
        yield name, "scattered", op, rays1, st0.time, flights_at(1), n_media
        del sdev, op, st0, rays1


# device cycles a turn's launches queue behind (~0.1 ms a launch at the
# card's ~2 GHz): longer than the host takes to enqueue them
QUEUE_CYCLES_A_LAUNCH = 200_000


def in_turns(fns: Dict[str, Callable], rounds: int = 5,
             reps: int = 10) -> Dict[str, list]:
    """Each name's times (ms a launch, the mean of ``reps`` launches
    between two CUDA events) over ``rounds`` rounds in turns: the names
    in order, then in reverse (parent, new, new, parent for two), after
    one warm-up call each. Each turn's launches queue behind a device
    sleep (``torch.cuda._sleep``), so the events time the device's work
    and not the host's enqueueing; the host's share shows in the frames
    that call the kernels."""
    import torch

    for fn in fns.values():
        fn()
    order = list(fns) + list(fns)[::-1]
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k in order:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize()
            torch.cuda._sleep(QUEUE_CYCLES_A_LAUNCH * reps)
            start.record()
            for _ in range(reps):
                fns[k]()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / reps)
    return times


def device_split(fn: Callable, reps: int = 10) -> dict:
    """{device operation: ms a call} of ``fn``: the kernels', copies' and
    fills' time that ``torch.profiler`` records over ``reps`` calls,
    divided by ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = float(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0)))
            out[e.key[:60]] = out.get(e.key[:60], 0.0) + us / 1e3 / reps
    return out


def device_ms(fn: Callable, reps: int = 10) -> Optional[float]:
    """The device time of one call of ``fn`` (ms), the sum of
    :func:`device_split` (None when the profiler records none). Events
    around back-to-back calls also count the gaps a slow host leaves."""
    total = sum(device_split(fn, reps).values())
    return total if total > 0 else None


def median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    return float(s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2]))


class _Proxy:
    """The package's kernel library with some entries replaced."""

    def __init__(self, lib, **entries):
        self._lib = lib
        self.__dict__.update(entries)

    def __getattr__(self, name):
        return getattr(self._lib, name)


@contextlib.contextmanager
def parent_kernels(libs: dict, sources: dict):
    """Within the block every call of the package's traversal and
    turbulence wrappers launches the builds in ``libs`` (``{"bvh": CDLL,
    "turb": CDLL}``, from ``sources``' files) instead of this checkout's:
    a frame through the parent tree's two kernels and this tree's
    everything else."""
    from pathtrace_tpu_torch.ops import _cuda_build

    entries = {}
    if "bvh" in libs:
        fn = libs["bvh"].pt_bvh_traverse
        fn.argtypes = _cuda_build._SIGNATURES["pt_bvh_traverse"]
        fn.restype = ctypes.c_int
        entries["pt_bvh_traverse"] = fn
    if "turb" in libs:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn = libs["turb"].pt_noise_turb
        if "int* list, cudaStream_t" in open(sources["turb"]).read():
            fn.argtypes = _cuda_build._SIGNATURES["pt_noise_turb"]
            fn.restype = ci
            entries["pt_noise_turb"] = fn
        else:
            fn.argtypes = [vp, vp, ci, vp, vp]
            fn.restype = ci
            entries["pt_noise_turb"] = (
                lambda p, m, n, o, lanes, s, _f=fn: _f(p, m, n, o, s))
    real = _cuda_build.library
    proxy = _Proxy(real(), **entries)
    _cuda_build.library = lambda: proxy
    try:
        yield
    finally:
        _cuda_build.library = real


def tree_sources(tree: str) -> dict:
    """{"bvh": path, "turb": path} of a tree's two kernel sources."""
    csrc = os.path.join(tree, "pathtrace_tpu_torch", "csrc")
    return {"bvh": os.path.join(csrc, "bvh_traverse.cu"),
            "turb": os.path.join(csrc, "turb.cu")}


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run_traverse(builds: dict, rounds: int, reps: int, dev,
                 log=print) -> dict:
    """The 12 sets through every build in ``builds`` ({name: (CDLL or
    None for this checkout's library, ptxas log)}): bits against the
    plain version, times in turns, plan and bound."""
    import torch

    from pathtrace_tpu_torch.ops import _cuda_build, bvh_kernel
    from pathtrace_tpu_torch.tools.nearest_bench import ptxas_usage

    lib_new = _cuda_build.library()
    fns = {k: traverse_fn(lib if lib is not None else lib_new)
           for k, (lib, _) in builds.items()}
    regs = {k: ptxas_usage("bvh_traverse_kernel", lg) for k, (_, lg) in
            builds.items()}
    log(f"registers: {json.dumps(regs)}")
    out = {}
    for name, label, op, rays, tm, fl, n_media in traverse_sets(dev):
        R = rays.shape[1]
        tp, gp, vp, tests = bvh_kernel.bvh_traverse_plain(op, rays, tm, fl,
                                                          stats=True)
        equal = {}
        for k, fn in fns.items():
            t, g, v = fn(op, rays, tm, fl)
            torch.cuda.synchronize()
            equal[k] = bool(torch.equal(t, tp) and torch.equal(g, gp)
                            and torch.equal(v, vp))
        times = in_turns({k: (lambda f=fn: f(op, rays, tm, fl))
                          for k, fn in fns.items()}, rounds, reps)
        dev_ms = {k: device_ms(lambda f=fn: f(op, rays, tm, fl), reps)
                  for k, fn in fns.items()}
        ys = bvh_kernel.yardsticks(op, R, vp, tests, n_media)
        # a warp of 32 consecutive rays lives as long as its longest ray:
        # the share of its lanes' visit slots that visit a node
        w = vp[:R // 32 * 32].view(-1, 32).double()
        warp_use = float(w.sum() / (32.0 * w.max(dim=1).values.sum()))
        plans = {k: traverse_plan(lib if lib is not None else lib_new, op, R)
                 for k, (lib, _) in builds.items()}
        row = {"rays": R, "nodes": op.n_nodes, "node_rows": op.node_rows,
               "equal": equal,
               "median_ms": {k: median(v) for k, v in times.items()},
               "ms": times, "device_ms": dev_ms, "bound_ms": ys["bound_ms"],
               "bound_by": ys["bound_by"], "mean_visits": ys["mean_visits"],
               "max_visits": ys["max_visits"], "warp_use": warp_use,
               "plans": plans}
        out[f"{name} {label}"] = row
        log(f"{name} {label}: equal {equal}; medians "
            f"{ {k: round(v, 4) for k, v in row['median_ms'].items()} } ms; "
            f"device {dev_ms} ms; "
            f"bound {ys['bound_ms']:.4f} ({ys['bound_by']}); visits "
            f"{ys['mean_visits']:.2f} max {ys['max_visits']}, lanes busy "
            f"{warp_use:.3f} of a warp's visit slots; plans {plans}")
        if not all(equal.values()):
            raise AssertionError(f"{name} {label}: a build differs from the "
                                 "plain version")
    return out


def turb_cases(dev) -> dict:
    """{label: (points [R, 3], mask [R])}: ``final_full``'s camera and
    once-scattered hits at 1280x720x4, the points where the winner wears
    the noise texture in the mask."""
    import torch

    from pathtrace_tpu_torch.config import MAX_T
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import TEX_NOISE, SceneFeatures
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.render.frame import generate_primary_rays
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    R = W * H * S
    scene, cam = presets.from_name("final_full", W / H)
    sdev = scene.to(dev)
    feats = SceneFeatures.from_scene(sdev)
    tables = fp.prep_tables(sdev, feats)
    n_med = sdev.media.count
    ro, rd, tm = generate_primary_rays(cam, W, H, S, PRNGKey(0), device=dev)
    ro, rd, tm = ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R)
    lane, alive = fp.lane_ids(R, dev)
    st0 = fp.FastState(ro=ro, rd=rd, time=tm, radiance=torch.zeros_like(ro),
                       throughput=torch.ones_like(ro), alive=alive,
                       lane=lane)
    out = {}
    with torch.no_grad():
        st1, _ = fp.fast_bounce(tables.table, tables.soa, sdev, st0, 7, 0,
                                D, feats, tables=tables)
        for label, (ro_, rd_, depth) in (("camera", (ro, rd, 0)),
                                         ("scattered", (st1.ro, st1.rd, 1))):
            t_, attrs = fp.nearest_hit_attrs(
                tables.table, tables.soa, sdev, ro_, rd_, tm, feats,
                fp.media_uniforms(lane, 7, depth, n_med, 8),
                box_media=tables.box_media)
            point = (ro_ + torch.where(t_ < MAX_T, t_, 0.0)[:, None]
                     * rd_).contiguous()
            out[label] = (point, attrs[:, 3] == float(TEX_NOISE))
    return out


def run_turb(builds: dict, sources: dict, rounds: int, reps: int, dev,
             log=print) -> dict:
    """The turbulence's cases through every build: bits against
    ``fast_turb_c`` under the mask, times in turns, bound."""
    import torch

    from pathtrace_tpu_torch.ops import _cuda_build
    from pathtrace_tpu_torch.ops import turb_kernel as tk
    from pathtrace_tpu_torch.tools.nearest_bench import ptxas_usage

    own = os.path.join(_ROOT, "pathtrace_tpu_torch", "csrc", "turb.cu")
    lib_new = _cuda_build.library()
    fns = {k: turb_fn(lib if lib is not None else lib_new,
                      sources.get(k, own)) for k, (lib, _) in builds.items()}
    regs = {k: ptxas_usage("turb_cu", lg) for k, (_, lg) in builds.items()}
    log(f"registers: {json.dumps(regs)}")
    out = {}
    for label, (point, mask) in turb_cases(dev).items():
        R = point.shape[0]
        ref = tk.turb_plain(point, mask)
        equal = {}
        for k, fn in fns.items():
            got = fn(point, mask)
            torch.cuda.synchronize()
            equal[k] = bool(torch.equal(got.view(torch.int32),
                                        ref.view(torch.int32)))
        times = in_turns({k: (lambda f=fn: f(point, mask))
                          for k, fn in fns.items()}, rounds, reps)
        split = {k: device_split(lambda f=fn: f(point, mask), reps)
                 for k, fn in fns.items()}
        dev_ms = {k: sum(v.values()) or None for k, v in split.items()}
        log(f"turb {label} device ms by operation: "
            f"{ {k: {n: round(x, 4) for n, x in v.items()} for k, v in split.items()} }")
        ys = tk.yardsticks(R, int(mask.sum()))
        row = {"lanes": R, "noise_lanes": int(mask.sum()), "equal": equal,
               "median_ms": {k: median(v) for k, v in times.items()},
               "ms": times, "device_ms": dev_ms, "bound_ms": ys["bound_ms"],
               "bound_by": ys["bound_by"]}
        out[label] = row
        log(f"turb {label}: {R} lanes, {row['noise_lanes']} noise; equal "
            f"{equal}; medians "
            f"{ {k: round(v, 4) for k, v in row['median_ms'].items()} } ms; "
            f"device {dev_ms} ms; bound {ys['bound_ms']:.4f} "
            f"({ys['bound_by']})")
        if not all(equal.values()):
            raise AssertionError(f"turb {label}: a build differs")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", choices=("traverse", "turb"),
                    default="traverse")
    ap.add_argument("--parent", default=None,
                    help="a tree whose kernel source is built alone")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bvh_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = _smi()
    print(f"card: {smi}", flush=True)
    key = "bvh" if args.what == "traverse" else "turb"
    own = tree_sources(_ROOT)[key]
    specs, sources = {}, {}
    if args.parent:
        sources["parent"] = tree_sources(args.parent)[key]
        specs["parent"] = (sources["parent"], [])
    built = standalone(specs)
    from pathtrace_tpu_torch.ops import _cuda_build

    info = _cuda_build.build()
    _cuda_build.library()
    builds = dict(built)
    builds["new"] = (None, info.log or (info.path.parent
                                        / "build.log").read_text())
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.what == "traverse":
        res = run_traverse(builds, args.rounds, args.reps, dev, log=log)
    else:
        res = run_turb(builds, sources, args.rounds, args.reps, dev, log=log)
    line = json.dumps({"what": args.what, "card": smi, "sets": res})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
