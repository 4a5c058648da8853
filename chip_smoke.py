"""Card check of the PyTorch/CUDA port: builds its kernels, holds each
against its plain PyTorch version, holds a trace against the committed
JAX reference fixture, and renders the main path through the CLI.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints a line before the next starts):

1. the card: ``torch.cuda.is_available()`` or exit non-zero; device name
   and ``nvidia-smi`` name and power limit;
2. build: nvcc on ``pathtrace_tpu_torch/csrc``, with the build seconds;
3. K1 (closest hit) against its plain version on the primary rays of
   ``random_spheres`` at 1280x720x4 and on once-scattered rays: t and idx
   must be equal;
4. K2 (fused shade) against its plain version on the same winners, under
   the lane contract (1e-3, at most 0.5% of lanes outside);
5. the port's CUDA trace of the fixture's rays against the JAX radiance
   in ``tests/goldens/torch_port_random_spheres.npz`` (depth 10: 1e-3, at
   most 1% of rays outside);
6. ``pathtrace_tpu_torch.cli.main`` renders random_spheres at 1280x720,
   4 spp, depth 10, 3 progressive frames; both kernels must have launched
   and the plain versions never run.

The second-to-last line is a JSON object with each kernel's launches in
phase 6, its largest difference from the plain version, and both times;
the last line is ``{"ok": true, "device": {...}}``. Any failure raises:
the script then exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "goldens", "torch_port_random_spheres.npz")
WIDTH, HEIGHT, SAMPLES, DEPTH, FRAMES = 1280, 720, 4, 10, 3
# the slice contract: per-ray radiance to 1e-3 (rtol and atol); the share
# of rays allowed outside is 0.5% per bounce, 1% after ten bounces
RTOL = ATOL = 1e-3


def phase(msg: str) -> None:
    print(msg, flush=True)


def outside_fraction(a, b) -> float:
    import torch

    a64, b64 = a.double(), b.double()
    close = (a64 - b64).abs() <= ATOL + RTOL * b64.abs()
    return 1.0 - close.float().mean().item()


def time_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` runs, after one warm-up."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    from pathtrace_tpu_torch import cli
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.convert import scene_from_numpy
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import _cuda_build
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.ops import intersect_kernel as k1
    from pathtrace_tpu_torch.ops import shade_kernel as k2
    from pathtrace_tpu_torch.render.frame import generate_primary_rays

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    phase(f"[1] device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    phase(f"[1] nvidia-smi: {smi}")

    info = _cuda_build.build()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "registers" in ln or "spill" in ln]
    phase(f"[2] build: {info.seconds:.1f} s nvcc -> {info.path}")
    for ln in ptxas:
        phase(f"[2]   {ln}")
    _cuda_build.library()

    # ---- 3: K1 on primary and once-scattered rays of the slice ----
    scene, camera = presets.random_spheres(WIDTH / HEIGHT)
    scene = scene.to(dev)
    feats = SceneFeatures.from_scene(scene)
    tables = fp.prep_tables(scene, feats)
    flags = fp.feature_flags(feats)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ro, rd, tm = generate_primary_rays(camera, WIDTH, HEIGHT, SAMPLES, gen)
    R = WIDTH * HEIGHT * SAMPLES
    st0 = fp.make_state(ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R))

    def k1_check(st, label):
        rays = st.planes[:6]
        t, idx = k1.sphere_nearest(tables.soa, rays)
        t_p, idx_p = k1.sphere_nearest_plain(tables.soa, rays)
        torch.cuda.synchronize()
        hit = t < 1e30
        err = (t[hit] - t_p[hit]).abs().max().item() if hit.any() else 0.0
        same = torch.equal(t, t_p) and torch.equal(idx, idx_p)
        phase(f"[3] K1 {label}: {R} rays, hit {hit.float().mean().item():.4f}, "
              f"t and idx equal to plain: {same}, max |dt| {err}")
        if not same:
            raise AssertionError(f"K1 differs from its plain version ({label})")
        return t, idx, err

    t0_, idx0, err_a = k1_check(st0, "primary")
    # once-scattered rays: one bounce through the kernels
    planes1, alive1 = k2.shade_from_winners(
        tables.table, idx0, t0_, st0.planes, st0.time, st0.alive, st0.lane,
        7, 0, DEPTH, tables.sky4, flags)
    st1 = fp.FastStateP(planes1, st0.time, alive1, st0.lane)
    t1_, idx1, err_b = k1_check(st1, "scattered")
    k1_ms = time_ms(lambda: k1.sphere_nearest(tables.soa, st0.planes[:6]), 20)
    k1_plain_ms = time_ms(
        lambda: k1.sphere_nearest_plain(tables.soa, st0.planes[:6]), 2)
    phase(f"[3] K1 time at {R} rays x {tables.soa.shape[1]} spheres: kernel "
          f"{k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms")

    # ---- 4: K2 on the same winners ----
    k2_err, k2_out = 0.0, 0.0
    for label, st, t_, idx_, depth in (("primary", st0, t0_, idx0, 0),
                                       ("scattered", st1, t1_, idx1, 1)):
        args = (tables.table, idx_, t_, st.planes, st.time, st.alive,
                st.lane, 7, depth, DEPTH, tables.sky4, flags)
        out, alive = k2.shade_from_winners(*args)
        out_p, alive_p = k2.shade_from_winners_plain(*args)
        frac = max(outside_fraction(out[k], out_p[k]) for k in range(12))
        agree = (alive == alive_p).float().mean().item()
        err = (out - out_p).abs().max().item()
        phase(f"[4] K2 {label}: worst plane {frac:.6f} of lanes outside 1e-3, "
              f"alive agreement {agree:.6f}, max |diff| {err}")
        if frac > 0.005 or agree < 0.995:
            raise AssertionError(f"K2 outside the lane contract ({label})")
        k2_err, k2_out = max(k2_err, err), max(k2_out, frac)
    args0 = (tables.table, idx0, t0_, st0.planes, st0.time, st0.alive,
             st0.lane, 7, 0, DEPTH, tables.sky4, flags)
    k2_ms = time_ms(lambda: k2.shade_from_winners(*args0), 20)
    k2_plain_ms = time_ms(lambda: k2.shade_from_winners_plain(*args0), 3)
    phase(f"[4] K2 time at {R} lanes: kernel {k2_ms:.3f} ms, "
          f"plain {k2_plain_ms:.3f} ms")
    del st0, st1, planes1, out, out_p

    # ---- 5: against the committed JAX reference ----
    ref = np.load(FIXTURE)
    fscene = scene_from_numpy(ref, device=dev)
    res = fp.trace_fast(
        fscene, torch.from_numpy(ref["rays.ro"]).to(dev),
        torch.from_numpy(ref["rays.rd"]).to(dev),
        torch.from_numpy(ref["rays.time"]).to(dev), int(ref["seed"]),
        int(ref["max_depth"]), SceneFeatures.from_scene(fscene),
        min_size=128)
    rad = res.radiance.cpu()
    ref_rad = torch.from_numpy(ref["radiance"])
    a64, b64 = rad.double(), ref_rad.double()
    close = ((a64 - b64).abs() <= ATOL + RTOL * b64.abs()).all(dim=1)
    n_out = int((~close).sum())
    frac = n_out / close.numel()
    count, ref_count = int(res.ray_count), int(ref["ray_count"])
    phase(f"[5] fixture: {close.numel()} rays depth {int(ref['max_depth'])}, "
          f"{frac:.4%} of rays outside 1e-3 (budget 1%), segments {count} vs "
          f"JAX {ref_count}")
    if frac > 0.01 or abs(count - ref_count) > n_out * int(ref["max_depth"]):
        raise AssertionError("port trace outside the slice contract")

    # ---- 6: the main path through the CLI ----
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "random_spheres.npy")
        argv = ["-P", "random_spheres", "-W", str(WIDTH), "-H", str(HEIGHT),
                "-S", str(SAMPLES), "-D", str(DEPTH), "-O", "-F", str(FRAMES),
                "--out", out_path]
        k1.LAUNCHES = k2.LAUNCHES = 0
        k1.PLAIN_CALLS = k2.PLAIN_CALLS = 0
        buf = io.StringIO()
        t_start = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        wall = time.monotonic() - t_start
        launches = (k1.LAUNCHES, k2.LAUNCHES)
        plain = (k1.PLAIN_CALLS, k2.PLAIN_CALLS)
        log = buf.getvalue()
        for ln in log.splitlines():
            phase(f"[6] cli: {ln}")
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        image = np.load(out_path)
    frames = [(float(ms), int(rays), int(rb)) for ms, rays, rb in re.findall(
        r"frame \d+/\d+: ([\d.]+) ms, (\d+) rays, [\d.]+ Mrays/s, (\d+) readbacks",
        log)]
    phase(f"[6] launches K1 {launches[0]}, K2 {launches[1]}; plain calls "
          f"{plain[0]}, {plain[1]}; wall {wall:.2f} s")
    if min(launches) <= 0 or max(plain) != 0:
        raise AssertionError("the main path did not run through both kernels")
    if len(frames) != FRAMES:
        raise AssertionError(f"expected {FRAMES} frame lines, got {frames}")
    mean = float(image.mean())
    if not (np.isfinite(image).all() and image.shape == (HEIGHT, WIDTH, 3)
            and 0.0 < mean <= 1.0):
        raise AssertionError(f"bad image: shape {image.shape}, mean {mean}")
    for i, (ms, rays, rb) in enumerate(frames):
        if rays < WIDTH * HEIGHT * SAMPLES:
            raise AssertionError(f"frame {i}: {rays} rays")
        phase(f"[6] frame {i + 1}: {ms:.2f} ms (CUDA events), {rays} rays, "
              f"{rays / ms / 1e3:.2f} Mrays/s, {rb} readbacks")
    phase(f"[6] image mean {mean:.6f}, finite")

    kernels = [
        {"name": "sphere_nearest", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/sphere_nearest.cu",
         "replaces": "pathtrace_tpu/ops/intersect_pallas.py:50",
         "launches": launches[0], "max_abs_err": max(err_a, err_b),
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "shade_from_winners", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/shade.cu",
         "replaces": "pathtrace_tpu/ops/shade_pallas.py:92",
         "launches": launches[1], "max_abs_err": k2_err,
         "lanes_outside": k2_out, "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
