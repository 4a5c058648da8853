"""The closest-hit sweeps K1 and K3 timed on the card, at the main path's
widths, with their yardsticks.

    python -m pathtrace_tpu_torch.tools.nearest_bench [--out FILE]

K1 (``sphere_nearest``) on ``random_spheres`` and K3
(``sphere_nearest_moving``) on ``random``, 1280x720 at 4 spp: the camera
rays and the once-scattered rays (K2 from the camera rays' winners), each
held bit for bit to the plain version, then timed (CUDA events behind a
device-side sleep, ``_probe.event_ms``). Beside each time its yardsticks
(:func:`yardsticks`, which ``chip_smoke.py`` uses too): the stated bound
(the operations the function needs at 67 TFLOP/s fp32, or the bytes at
3.35 TB/s, whichever takes longer), and the issue ceiling under
``-fmad=false``: the fp32 peak counts an FMA as two operations, while
each operation of these kernels is an instruction of its own, and an SM
sub-partition issues one warp instruction a clock, so the ceiling is half
the peak (33.5 T thread-instructions/s). The camera rays are also timed
at narrower widths (the ladder's late bounces; ``WIDTHS`` reaches each
rays-a-thread instance), and K1 on ``simple_light``'s 128 slots (3 live
spheres). ``branch_share``: the
share of (warp, live sphere) steps in which some ray of the warp has
disc > 0, the steps that take the root branch of
``csrc/sphere_nearest.cu``; a warp is 4 x 32 rays as that kernel maps
them at 4 rays a thread (``warp128``), or 32 consecutive rays at one ray
a thread (``warp32``). Then ``profile_step``'s wavefront frames of
``random_spheres`` and ``random`` and the ``random`` train step, in this
process.

It calls only functions that every version of the port has, so, run by
path with another checkout first on ``PYTHONPATH``, it times that
checkout's kernels (a comparison in turns, within one card call):

    PYTHONPATH=/path/to/checkout python pathtrace_tpu_torch/tools/nearest_bench.py

Each result is one JSON line; ``--out`` writes them to a file too.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from typing import Optional, Sequence

WIDTH, HEIGHT, SAMPLES = 1280, 720, 4
# the card's published peaks (H100 SXM data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# thread-instructions a second: 132 SMs x 4 sub-partitions x 32 lanes at
# 1.98 GHz, half the fp32 peak
ISSUE_PER_S = FP32_FLOP_PER_S / 2
# fp32 operations a ray-sphere pair needs, counted from the plain version
# (csrc/sphere_nearest.cu keeps its order): b 6, c 8, b*b - c 2; a moving
# slot adds s 2, delta.d and delta.ro 10, b's motion term 2 and c's 8 (2s
# once). A static slot of K3's operand needs K1's 16: its motion terms
# are zeros.
OPS_PAIR, OPS_PAIR_MOTION = 16, 38
# the camera rays cut to these widths: 4 rays a thread at the first two,
# 2 at the next two, 1 at the rest (on 132 SMs)
WIDTHS = (921_637, 230_437, 150_037, 120_037, 80_037, 57_637, 14_437)
REPS = 20  # launches a timed sample


def pair_ops(soa) -> int:
    """fp32 operations one ray needs over the operand's spheres: 16 a live
    slot, 38 a live slot of K3's [12, N] operand that moves (a motion row,
    delta, inv_dt, c.delta or |delta|^2, nonzero)."""
    live = soa[4] > 0
    ops = OPS_PAIR * int(live.sum())
    if soa.shape[0] == 12:
        moves = (soa[5:8] != 0).any(dim=0) | (soa[9:12] != 0).any(dim=0)
        ops += (OPS_PAIR_MOTION - OPS_PAIR) * int((live & moves).sum())
    return ops


def yardsticks(soa, R: int) -> dict:
    """Stated bound (the larger of bytes and fp32 operations) and issue
    ceiling of one sweep of ``R`` rays over ``soa`` (K1's [5, N] or K3's
    [12, N] operand): 24 B of ray in (28 with the time), 8 B out, the
    operand once."""
    ops = R * pair_ops(soa)
    nbytes = R * (36 if soa.shape[0] == 12 else 32) + soa.numel() * 4
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "issue_ceiling_ms": max(by_bytes, ops / ISSUE_PER_S * 1e3)}


def branch_share(soa, rays, time=None, chunk: int = 1 << 15) -> dict:
    """Share of (warp, live sphere) steps with some disc > 0 in the warp,
    for 4 x 32-ray warps (rays ``b*1024 + k*256 + w*32 + lane``) and for
    32 consecutive rays; the quadratic in the plain version's order."""
    import torch

    live = soa[4] > 0
    rows = [r[live][None, :] for r in soa]
    R = rays.shape[1]
    hit128 = hit32 = steps128 = steps32 = 0
    chunk -= chunk % 1024
    for lo in range(0, R, chunk):
        hi = min(lo + chunk, R)
        ox, oy, oz, dx, dy, dz = (rays[k, lo:hi][:, None] for k in range(6))
        cx, cy, cz, c2 = rows[:4]
        b = (ox * dx + oy * dy + oz * dz) - (cx * dx + cy * dy + cz * dz)
        c = (ox * ox + oy * oy + oz * oz) - 2.0 * (cx * ox + cy * oy
                                                   + cz * oz) + c2
        if time is not None:
            mx, my, mz, time0, inv_dt, c_dot_d, d2 = rows[5:]
            s = (time[lo:hi][:, None] - time0) * inv_dt
            b = b - s * (mx * dx + my * dy + mz * dz)
            c = (c - 2.0 * s * (mx * ox + my * oy + mz * oz)
                 + 2.0 * s * c_dot_d + s * s * d2)
        pos = (b * b - c) > 0.0
        pad = (-(hi - lo)) % 1024
        if pad:
            pos = torch.cat([pos, pos.new_zeros((pad, pos.shape[1]))])
        n = pos.shape[1]
        w128 = pos.reshape(-1, 4, 8, 32, n).any(dim=3).any(dim=1)
        w32 = pos.reshape(-1, 32, n).any(dim=1)
        hit128 += int(w128.sum())
        steps128 += w128.numel()
        hit32 += int(w32.sum())
        steps32 += w32.numel()
    return {"warp128": hit128 / steps128, "warp32": hit32 / steps32}


def _rays(name: str, dev):
    """The preset's tables and its camera rays as a wavefront state."""
    import torch

    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.render.frame import generate_primary_rays

    scene, camera = presets.from_name(name, WIDTH / HEIGHT)
    scene = scene.to(dev)
    feats = SceneFeatures.from_scene(scene)
    tables = fp.prep_tables(scene, feats)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ro, rd, tm = generate_primary_rays(camera, WIDTH, HEIGHT, SAMPLES, gen)
    R = WIDTH * HEIGHT * SAMPLES
    st = fp.make_state(ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R))
    return scene, feats, tables, st


def sweeps() -> list:
    """The kernel lines: every (scene, ray set, width) timed."""
    import torch

    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.ops import intersect_kernel as k1
    from pathtrace_tpu_torch.ops import shade_kernel as k2
    from pathtrace_tpu_torch.tools._probe import event_ms

    dev = torch.device("cuda")
    lines = []
    for name, kernel, moving in (("random_spheres", "K1", False),
                                 ("random", "K3", True),
                                 ("simple_light", "K1", False)):
        scene, feats, tables, st0 = _rays(name, dev)
        soa = tables.soa
        n_live = int(scene.spheres.mask.sum())

        def run(rays, time):
            if moving:
                return k1.sphere_nearest_moving(soa, rays, time)
            return k1.sphere_nearest(soa, rays)

        t0, idx0 = run(st0.planes[:6], st0.time)
        planes, alive = k2.shade_from_winners(
            tables.table, idx0, t0, st0.planes, st0.time, st0.alive,
            st0.lane, 7, 0, 10, tables.sky4, fp.feature_flags(feats))
        sets = [("primary", st0.planes[:6], st0.time)]
        if name != "simple_light":
            sets.append(("scattered", planes[:6].contiguous(), st0.time))
        for label, rays, time in sets:
            t, idx = run(rays, time)
            t_p, idx_p = k1.sphere_nearest_plain(
                soa, rays, time=time if moving else None)
            same = torch.equal(t, t_p) and torch.equal(idx, idx_p)
            widths = [rays.shape[1]]
            if label == "primary" and name != "simple_light":
                widths += list(WIDTHS)
            for R in widths:
                r_rays, r_time = rays[:, :R], time[:R].contiguous()
                ms = event_ms(lambda: run(r_rays, r_time), REPS)
                ln = {"bench": "nearest", "scene": name, "kernel": kernel,
                      "rays": label, "width": R, "spheres": n_live,
                      "slots": soa.shape[1], "ms": ms,
                      **yardsticks(soa, R)}
                ln["bound_share"] = ln["bound_ms"] / ms
                ln["issue_share"] = ln["issue_ceiling_ms"] / ms
                if R == rays.shape[1]:
                    ln["equal_to_plain"] = same
                    ln["branch_share"] = branch_share(
                        soa, rays, time if moving else None)
                lines.append(ln)
        del planes, alive, st0, tables
    return lines


def frames() -> list:
    """``profile_step``'s frames and train step, in this process."""
    from pathtrace_tpu_torch.tools import profile_step

    lines = []
    for argv in (["--what", "frame", "--preset", "random_spheres"],
                 ["--what", "frame", "--preset", "random"],
                 ["--what", "train", "--preset", "random"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = profile_step.main(argv)
        if rc != 0:
            raise RuntimeError(f"profile_step {argv} returned {rc}")
        res = json.loads(buf.getvalue().splitlines()[-1])
        lines.append({"bench": "profile_step", "what": res["what"],
                      "preset": res["preset"],
                      "step_ms_median": res["step_ms_median"],
                      "step_ms": res["step_ms"],
                      "device_busy_ms": res["device_busy_ms"],
                      "idle_share_unprofiled": res["idle_share_unprofiled"],
                      "kinds_ms": res["kinds_ms"]})
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="nearest_bench")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("nearest_bench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from pathtrace_tpu_torch.tools._probe import device_line

    card = device_line(torch.device("cuda"))
    lines = sweeps() + frames()
    for ln in lines:
        ln["card"] = card
        print(json.dumps(ln), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(ln) + "\n" for ln in lines)
    if not all(ln.get("equal_to_plain", True) for ln in lines):
        print("nearest_bench: a kernel differs from its plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
