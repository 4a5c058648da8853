"""The closest-hit sweeps K1, K3, K4 and K5 timed on the card, at the main
path's widths, with their yardsticks.

    python -m pathtrace_tpu_torch.tools.nearest_bench [--what all|nearest|cull|bwd|mega|shade|p1|shade-turns] [--out FILE]

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

The culls (``--what cull``): K4 (``sphere_nearest_culled``, flat) on the
13-tile cover scene (``presets._random_impl(..., half_extent=20)``) and K5
(two-level) on ``random_spheres_xl``, 1280x720 at 4 spp: the camera rays
in 64x64 tile order and the once-scattered rays, each held bit for bit to
the plain version and to K1's kernel, its (warp, tile) sweep count to the
plain version's, then timed as above at full width and at ``CULL_WIDTHS``
(the ladder's compacted widths: prefixes of each ray set). Beside each
time: the sweeps, the share of (warp, tile) pairs skipped, the (ray, live
slot) pairs swept at the kernel's unit, and :func:`cull_yardsticks`
with its counts at the fixed 32-ray unit (pairs, box tests) and the
extra pairs of the kernel's unit. Then one wavefront frame
of each scene (depth 10, tile order, the cull on every bounce): the
median of ``FRAME_REPS`` frames (CUDA events) and the device busy time of
one more under ``torch.profiler``.

The backward (``--what bwd``): K6 (``sphere_nearest_bwd``) on the
winners of K1 on ``random_spheres`` and of K3 on ``random`` (static and
with motion), camera and once-scattered rays, at full width and at
``BWD_WIDTHS`` (prefixes), with a seeded cotangent: per-ray gradients held
bit for bit and per-sphere sums to relative L2 1e-4 against the plain
version, the time, :func:`k6_yardsticks`, and the sha256 of the per-ray
gradients (g_ro, g_rd, and g_time with motion); then K6 on a 4096-sphere
scene under each of its two instances (``shared_bytes``: the per-block
sums in shared memory, opted in past 48 KB, or added straight into
device memory), and ``profile_step``'s train steps of ``random`` and
``random_spheres``, whose ``kinds_ms`` give K6's device time a step.

The megakernel (``--what mega``): K7 (``trace_megakernel``) on the camera
rays of ``random_spheres``, ``random`` and ``simple_light``, 1280x720 at 4
spp, depth 10: the time, the sha256 of the radiance bytes and the segment
count, and where the checkout has them the lane-passes (K7's own count)
and, from the plain version's per-ray segments, the yardsticks
(:func:`k7_yardsticks`) and the lane-passes of a block-uniform loop
(:func:`k7_lane_passes`, the design before the persistent one); then
``profile_step``'s megakernel and wavefront frames of both sphere
presets.

The fused shade (``--what shade``): K2 (``shade_from_winners``) on the
winners of the camera rays and of the once-scattered rays, 1280x720 at 4
spp, for every flag set ``chip_smoke.py`` times: ``random_spheres``
(spheres), ``random`` (motion), ``simple_light`` (rect, rect + MIS),
``two_perlin_spheres`` (noise without rects), ``cornell`` (box, box + MIS),
``cornell_smoke`` (medium, medium + MIS), ``earth`` (image, image + MIS) and
the image-light scene (rect + image + MIS). Per flag set: the lane contract
against the plain version, the sha256 of the output planes and alive
flags (both ray sets), the time on the camera winners, and
:func:`k2_yardsticks`: the bound, the issue ceiling, and the lanes that
take the noise branch, their share and their occupancy (noise lanes over
32 x the warps with at least one), and where there are noise lanes the
time of the same launch with the noise flag off (``ms_no_noise``). Then K7's lines (as ``--what mega``,
without the frames), whose radiance and segments share the noise with K2
(``csrc/pt_device.cuh``), and ptxas's registers and spills of K2, K7 and P1.

``--what shade --sets sphere,motion`` times those flag sets alone. In
turns (``--what shade-turns --tree parent=PATH --tree change=PATH --sets
... --rounds N``): K2's time on those sets in each tree, a process a run,
N rounds of every tree forth and back, with each tree's quartiles and its
median's distance from the first tree's (:func:`shade_turns`).

The bf16 probe's sweep (``--what p1``): P1 (``bf16_probe.sphere_min_t``)
in float32 and bf16 at the probe's size (2^20 rays x 640 spheres) and on a
ragged shape (2^20 + 3 rays x 1031 spheres: a ragged block, two sphere
tiles, an odd count), each held bit for bit to the plain version, timed,
hashed, with the bound, the issue ceiling (where the checkout's probe has
one), the share of pairs with disc > 0, the all-miss rows, and ptxas's
registers and spills.

It calls only functions that every version of the port has whose
``tools/_probe.py`` holds ``ISSUE_PER_S`` and whose presets hold
``image_light_scene``, so, run by path with another such checkout first on
``PYTHONPATH``, it times that checkout's kernels (a comparison in turns,
within one card call):

    PYTHONPATH=/path/to/checkout python pathtrace_tpu_torch/tools/nearest_bench.py

Each result is one JSON line; ``--out`` writes them to a file too.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
from typing import Optional, Sequence, Tuple

from pathtrace_tpu_torch.tools._probe import (  # the card's peaks
    FP32_FLOP_PER_S, HBM_BYTES_PER_S, ISSUE_PER_S,
)

WIDTH, HEIGHT, SAMPLES = 1280, 720, 4
# fp32 operations a ray-sphere pair needs, counted from the plain version
# (csrc/sphere_nearest.cu keeps its order): b 6, c 8, b*b - c 2; a moving
# slot adds s 2, delta.d and delta.ro 10, b's motion term 2 and c's 8 (2s
# once). A static slot of K3's operand needs K1's 16: its motion terms
# are zeros.
OPS_PAIR, OPS_PAIR_MOTION = 16, 38
# fp32 operations of a ray-box slab test, about: 18 in the three slab
# intervals (2 subtractions, 2 multiplications, min and max each), 4 for
# entry and exit, 3 comparisons and the best's min, and the axis-parallel
# selects (csrc/sphere_nearest_culled.cu any_wants)
OPS_BOX = 30
# the camera rays cut to these widths: 4 rays a thread at the first two,
# 2 at the next two, 1 at the rest (on 132 SMs)
WIDTHS = (921_637, 230_437, 150_037, 120_037, 80_037, 57_637, 14_437)
# the culls' widths below the full one, prefixes of each ray set: the
# ladder's rungs on both scenes (1,048,576 to 65,536) and two between
CULL_WIDTHS = (1_048_576, 524_288, 262_144, 180_000, 131_072, 90_000,
               65_536)
REPS = 20  # launches a timed sample
FRAME_REPS = 5  # timed frames after two warm-up frames
# K6 at full width and at these prefixes of each ray set
BWD_WIDTHS = (262_144, 65_536)
BWD_SPHERE_RTOL = 1e-4  # per-sphere sums, relative L2 (chip_smoke's)
# K6 reads ro, rd, t, idx, g_t (36 B) and writes g_ro, g_rd (24 B) a ray;
# with motion also the time in and g_time out (68 B); ~60 operations a ray
# (~80 with motion), and the sphere leaves in and their gradients out
K6_BYTES, K6_BYTES_MOTION, K6_OPS, K6_OPS_MOTION = 60, 68, 60, 80
# K7's operations, counted from the plain sweep (ops/megakernel.py
# _sphere_sweep) as OPS_PAIR counts K1's, a sphere's own terms once per
# sphere: a static pair b 6, c 9 (c.ro 5, 2x, |ro|^2 -, + |c|^2, - r^2),
# b*b - c 2; a moving pair adds the lerp s 2 and c0 + s delta 6, and
# takes |c|^2 (5) per pair. A (ray, rect) pair (_rect_sweep): the hit
# distance (k - o_n) / d_n 2 and the two in-plane coordinates 2 each (its
# window's comparisons are not counted, as disc > 0 is not). A shaded
# segment ~250 (csrc/megakernel.cu), NOISE_OPS more under the noise
# texture (csrc/pt_device.cuh, which K2 shares)
K7_OPS_PAIR, K7_OPS_PAIR_MOTION, K7_OPS_RECT = 17, 30, 6
K7_OPS_SHADE = 250
MEGA_DEPTH = 10
MEGA_REPS = 5
# K2's operations, counted from its plain version (ops/shade_kernel.py):
# ~300 a lane (the hit point and normal, the sky, four counter draws, the
# scatter and its normalisation), ~100 more for a box winner (the slab
# test redone, the face and its normal mapped back), ~150 for an image
# winner (the UV: an atan2, an asin and ~40 more; the clamps and the
# texel address)
K2_OPS, K2_OPS_BOX, K2_OPS_IMAGE = 300, 100, 150
# the noise texture (csrc/pt_device.cuh fast_turb), counted from
# fast_noise_c and fast_turb_c at the instructions each operation needs,
# a term shared by corners once an octave. Per octave: the floors and
# their ints 6, fractions 3, smoothsteps 12, their complements 3, the
# offsets u - 1 3 (27); the lattice terms: three products and three
# + kHash (6); a corner: the lattice sum (one IADD3), the mix 5 (two
# shift-xors and an IMAD), gy's and gz's words one IMAD each, three units
# of 3 (shift, convert, FMA), the dot 5, the weight and the sum 3 (25);
# wu * wv 4; the turbulence's weight, sum and doublings 6: 243 an octave.
# Once: the abs and the marble around it, 7.
NOISE_OCTAVE, NOISE_LATTICE, NOISE_CORNER, NOISE_WEIGHTS = 27, 6, 25, 4
TURB_STEP, MARBLE = 6, 7
NOISE_OPS = 7 * (NOISE_OCTAVE + NOISE_LATTICE + 8 * NOISE_CORNER
                 + NOISE_WEIGHTS + TURB_STEP) + MARBLE
# K2 reads 65 B a lane (12 planes, time, alive, lane, t, idx) and writes
# 49 (12 planes, alive), the winner table and the atlas once; with
# FLAG_EMIT_SCALE the MIS plane in (4) and it, the normal and the albedo
# out (28)
K2_BYTES, K2_BYTES_EMIT = 114, 32
SHADE_REPS = 20
# P1 at the probe's size and on a ragged shape: a ragged last block, two
# sphere tiles, an odd sphere count
P1_SHAPES = ((1 << 20, 640), ((1 << 20) + 3, 1031))


# integer operations a Threefry-2x32 draw needs (csrc/threefry.cu): the
# counter's two words under the key 2, 20 rounds of an add, a rotate (one
# funnel shift) and a xor 60, five key injections of two adds 10, the
# final xor 1; a uniform adds a shift, an or and the float subtraction
OPS_THREEFRY_BITS, OPS_THREEFRY_UNIFORM = 73, 76


def threefry_yardsticks(n_draws: int, as_float: bool = True) -> dict:
    """Stated bound of ``n_draws`` Threefry draws: 4 B written a draw,
    nothing read, against their integer operations at the issue rate (one
    warp instruction a clock per SM sub-partition, ``ISSUE_PER_S``): the
    card issues no faster, whatever pipe an instruction takes."""
    ops = n_draws * (OPS_THREEFRY_UNIFORM if as_float else OPS_THREEFRY_BITS)
    by_bytes = 4 * n_draws / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ISSUE_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bytes_ms": by_bytes,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "issue_ceiling_ms": max(by_bytes, by_ops)}


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
    nbytes = R * (36 if soa.shape[0] == 12 else 32) + soa.numel() * 4
    return _sticks(nbytes, R * pair_ops(soa))


def k6_yardsticks(R: int, n_spheres: int, moving: bool) -> dict:
    """Stated bound (bytes, as a rule) and issue ceiling of K6 on ``R``
    rays over ``n_spheres`` spheres."""
    nbytes = R * (K6_BYTES_MOTION if moving else K6_BYTES) + n_spheres * (
        9 if moving else 4) * 4 * 2
    return _sticks(nbytes, R * (K6_OPS_MOTION if moving else K6_OPS))


def k7_yardsticks(scene, tables, features, R: int, segments: int,
                  shaded: int, noise: int) -> dict:
    """Stated bound and issue ceiling of one K7 trace of ``R`` rays that
    traced ``segments`` segments, ``shaded`` of them shaded and ``noise``
    of those under the noise texture (``trace_megakernel_plain``'s
    ``work``): every segment sweeps the live spheres (17 operations a
    static one, 30 a moving one under motion) and the live rects (6);
    28 B of ray in and 12 out per ray, the tables once."""
    from pathtrace_tpu_torch.ops.megakernel import static_rows

    live = scene.spheres.mask
    n_moving = (int((live & ~static_rows(tables.spheres)[:live.shape[0]])
                    .sum()) if features.has_motion else 0)
    n_rect = int(scene.rects.mask.sum()) if features.has_rects else 0
    sweep = ((int(live.sum()) - n_moving) * K7_OPS_PAIR
             + n_moving * K7_OPS_PAIR_MOTION + n_rect * K7_OPS_RECT)
    ops = segments * sweep + shaded * K7_OPS_SHADE + noise * NOISE_OPS
    nbytes = R * 40 + 4 * (tables.spheres.numel() + tables.sky4.numel()
                           + (tables.rects.numel() if features.has_rects
                              else 0))
    return {**_sticks(nbytes, ops), "ops_a_segment": sweep}


def k7_lane_passes(ray_segments, warp: int = 32) -> int:
    """Lane-passes of a block-uniform megakernel (one ray a thread, rays
    in order, a warp sweeping while any of its rays lives): ``warp`` times
    the longest ray's segments, summed over warps of consecutive rays."""
    import torch

    segs = ray_segments.to(torch.int64)
    pad = (-segs.numel()) % warp
    if pad:
        segs = torch.cat([segs, segs.new_zeros(pad)])
    return warp * int(segs.reshape(-1, warp).max(dim=1).values.sum())


def k2_yardsticks(table, flags: int, idx, t, atlas=None) -> dict:
    """Stated bound and issue ceiling of one K2 launch on the winners
    (``idx``, ``t``) under ``flags``, and its noise branch: the lanes whose
    winner wears the noise texture (``FLAG_NOISE``) and whose albedo
    reaches an output (a hit, or any lane under ``FLAG_EMIT_SCALE``, whose
    albedo rows every lane writes; a miss's winner is row 0), their share,
    and their occupancy, noise lanes over 32 x the warps (32 consecutive
    lanes, one thread a lane) with at least one. Operations: ``K2_OPS`` a
    lane, ``NOISE_OPS`` more a noise lane, ``K2_OPS_BOX`` a box lane
    that hits, ``K2_OPS_IMAGE`` an image lane (as a noise lane); bytes:
    ``K2_BYTES`` a lane (and ``K2_BYTES_EMIT`` under ``FLAG_EMIT_SCALE``),
    the table and the atlas once."""
    import torch

    from pathtrace_tpu_torch.ops import shade_kernel as k2

    R = t.numel()
    rows = table.index_select(0, idx.long())
    hit = t < 1e30
    textured = hit | bool(flags & k2.FLAG_EMIT_SCALE)
    noise = (textured & (rows[:, 3] == 2.0) if flags & k2.FLAG_NOISE
             else torch.zeros_like(hit))
    n_box = (int((hit & (rows[:, 14] == 2.0)).sum())
             if flags & k2.FLAG_BOX else 0)
    n_image = (int((textured & (rows[:, 3] == 3.0)).sum())
               if flags & k2.FLAG_IMAGE else 0)
    n_noise = int(noise.sum())
    pad = (-R) % 32
    warps = torch.cat([noise, noise.new_zeros(pad)]).reshape(-1, 32)
    n_warps = int(warps.any(dim=1).sum())
    nbytes = (R * (K2_BYTES + (K2_BYTES_EMIT if flags & k2.FLAG_EMIT_SCALE
                               else 0))
              + table.numel() * 4
              + (atlas.numel() * 4 if atlas is not None
                 and flags & k2.FLAG_IMAGE else 0))
    ops = (R * K2_OPS + n_noise * NOISE_OPS + n_box * K2_OPS_BOX
           + n_image * K2_OPS_IMAGE)
    return {**_sticks(nbytes, ops), "noise_lanes": n_noise,
            "noise_lane_share": n_noise / max(R, 1),
            "noise_occupancy": (n_noise / (32 * n_warps) if n_warps
                                else None)}


def ptxas_usage(marker: str, log: Optional[str] = None) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}
    of the kernels whose name holds ``marker``, from ptxas's output in
    ``log`` (by default this checkout's library's build log)."""
    from pathtrace_tpu_torch.ops import _cuda_build

    if log is None:
        info = _cuda_build.build()
        log = info.log or (info.path.parent / "build.log").read_text()
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1) if marker in m.group(1) else None
        elif name is not None and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            out[name] = {"spill_stores": int(st), "spill_loads": int(ld)}
        elif name is not None and "Used" in ln and "registers" in ln:
            out.setdefault(name, {})["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
            name = None
    return out


def cull_yardsticks(soa, cull, rays) -> dict:
    """Stated bound and issue ceiling of one culled sweep (K4/K5) of
    ``rays``: ``OPS_PAIR`` a (ray, live slot) pair of the tiles swept and
    ``OPS_BOX`` a ray-box test, both counted by the plain version at a
    fixed unit, the 32-ray warp (one ray a thread), whatever unit the
    kernel picks: a coarser unit's extra pairs are its own cost, not
    work the function needs. 24 B of ray in and 8 B out, the operand and
    the boxes once. Returns the counts too (``slots_swept``,
    ``box_tests``)."""
    from pathtrace_tpu_torch.ops.intersect_kernel import (
        sphere_nearest_culled_plain)

    plain = sphere_nearest_culled_plain(soa, rays, cull, k_rays=1)
    slots, tests = int(plain.slots), int(plain.tests)
    boxes = [b for b in (cull.tiles, cull.supers) if b is not None]
    nbytes = (rays.shape[1] * 32 + soa.numel() * 4
              + sum(b.numel() * 4 for b in boxes))
    return {**_sticks(nbytes, slots * OPS_PAIR + tests * OPS_BOX),
            "slots_swept": slots, "box_tests": tests}


def _sticks(nbytes: float, ops: float) -> dict:
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
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    scene, camera = presets.from_name(name, WIDTH / HEIGHT)
    scene = scene.to(dev)
    feats = SceneFeatures.from_scene(scene)
    tables = fp.prep_tables(scene, feats)
    ro, rd, tm = generate_primary_rays(camera, WIDTH, HEIGHT, SAMPLES,
                                       PRNGKey(0), device=dev)
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


def frames(argvs=(("frame", "random_spheres"), ("frame", "random"),
                  ("train", "random"))) -> list:
    """``profile_step``'s steps (``--what``, ``--preset`` pairs), in this
    process."""
    from pathtrace_tpu_torch.tools import profile_step

    lines = []
    for what, preset in argvs:
        argv = ["--what", what, "--preset", preset]
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


def _sha256(*tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _rel_l2(a, b) -> float:
    a64, b64 = a.double(), b.double()
    return float((a64 - b64).norm() / max(float(b64.norm()), 1e-30))


def _many_spheres(n: int = 4096):
    """A ground sphere and ``n - 1`` small ones over the random_spheres
    floor (64 KB of K6's static sums a block: past the 48 KB a block gets
    without opting in)."""
    import numpy as np

    from pathtrace_tpu_torch.models.build import SceneBuilder

    b = SceneBuilder()
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian_color((0.5, 0.5, 0.5)))
    mat = b.lambertian_color((0.2, 0.4, 0.6))
    rng = np.random.default_rng(0)
    for x, z in rng.uniform(-11.0, 11.0, (n - 1, 2)):
        b.sphere((float(x), 0.1, float(z)), 0.1, mat)
    return b.finish()


def bwd() -> list:
    """K6's lines: static and moving, camera and scattered winners, every
    width checked against the plain version, timed and hashed; the
    4096-sphere scene under each instance; the train steps."""
    import torch

    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.ops import intersect_kernel as k1
    from pathtrace_tpu_torch.ops import shade_kernel as k2
    from pathtrace_tpu_torch.tools._probe import event_ms

    dev = torch.device("cuda")
    lines = []
    per_ray = {False: (2, 3), True: (2, 3, 7)}
    per_sphere = {False: (0, 1), True: (0, 1, 4, 5, 6)}
    for name, moving in (("random_spheres", False), ("random", True)):
        scene, feats, tables, st0 = _rays(name, dev)
        soa, sp = tables.soa, scene.spheres

        def nearest(st):
            if moving:
                return k1.sphere_nearest_moving(soa, st.planes[:6], st.time)
            return k1.sphere_nearest(soa, st.planes[:6])

        t0, idx0 = nearest(st0)
        planes, alive = k2.shade_from_winners(
            tables.table, idx0, t0, st0.planes, st0.time, st0.alive,
            st0.lane, 7, 0, 10, tables.sky4, fp.feature_flags(feats))
        st1 = fp.FastStateP(planes[:12], st0.time, alive, st0.lane)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        g_full = torch.rand(st0.time.shape[0], generator=gen, device=dev) + 0.5
        for label, st in (("primary", st0), ("scattered", st1)):
            t, idx = nearest(st)
            ro = st.planes[0:3].T.contiguous()
            rd = st.planes[3:6].T.contiguous()
            for R in (t.shape[0], *BWD_WIDTHS):
                args = (sp.center, sp.radius, ro[:R], rd[:R], t[:R], idx[:R],
                        g_full[:R])
                motion = ((sp.center_delta, sp.time0, sp.inv_time_delta,
                           st.time[:R]) if moving else None)
                got = k1.sphere_nearest_bwd(*args, motion=motion)
                ref = k1.sphere_nearest_bwd_plain(*args, motion=motion)
                ms = event_ms(lambda: k1.sphere_nearest_bwd(
                    *args, motion=motion), REPS)
                ln = {"bench": "bwd", "scene": name, "kernel": "K6",
                      "moving": moving, "rays": label, "width": R,
                      "spheres": sp.radius.shape[0], "ms": ms,
                      **k6_yardsticks(R, sp.radius.shape[0], moving),
                      "equal_to_plain": all(torch.equal(got[k], ref[k])
                                            for k in per_ray[moving]),
                      "sphere_rel_l2": [_rel_l2(got[k], ref[k])
                                        for k in per_sphere[moving]],
                      "sha256": _sha256(*(got[k] for k in per_ray[moving]))}
                ln["bound_share"] = ln["bound_ms"] / ms
                ln["sums_within"] = max(ln["sphere_rel_l2"]) <= BWD_SPHERE_RTOL
                lines.append(ln)
        del planes, alive, st0, st1, tables
    lines += _bwd_many(dev)
    return lines + frames((("train", "random"), ("train", "random_spheres")))


def _bwd_many(dev) -> list:
    """K6 on the 4096-sphere scene's camera winners at full width under
    each instance, where the checkout has the choice
    (``intersect_kernel.BWD_SHARED_BYTES``)."""
    import torch

    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.ops import intersect_kernel as k1
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.render.frame import generate_primary_rays
    from pathtrace_tpu_torch.utils.threefry import PRNGKey
    from pathtrace_tpu_torch.tools._probe import event_ms

    scene = _many_spheres().to(dev)
    cam = presets.random_spheres(WIDTH / HEIGHT)[1]
    soa = fp.build_sphere_soa(scene)
    ro, rd, _ = generate_primary_rays(cam, WIDTH, HEIGHT, SAMPLES,
                                      PRNGKey(0), device=dev)
    R = WIDTH * HEIGHT * SAMPLES
    ro, rd = ro.reshape(R, 3).contiguous(), rd.reshape(R, 3).contiguous()
    t, idx = k1.sphere_nearest(soa, torch.cat([ro, rd], 1).T.contiguous())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    g_t = torch.rand(R, generator=gen, device=dev) + 0.5
    sp = scene.spheres
    args = (sp.center, sp.radius, ro, rd, t, idx, g_t)
    ref = k1.sphere_nearest_bwd_plain(*args)
    default = getattr(k1, "BWD_SHARED_BYTES", None)
    limits = (None,) if default is None else (48 * 1024, 232_448)
    lines = []
    for limit in limits:
        if limit is not None:
            k1.BWD_SHARED_BYTES = limit
        got = k1.sphere_nearest_bwd(*args)
        ms = event_ms(lambda: k1.sphere_nearest_bwd(*args), REPS)
        ln = {"bench": "bwd_many", "spheres": sp.radius.shape[0],
              "width": R, "shared_bytes": limit, "ms": ms,
              "instance": (None if limit is None else
                           "shared" if k1.bwd_launch(
                               R, sp.radius.shape[0], False)[1] else "global"),
              **k6_yardsticks(R, sp.radius.shape[0], False),
              "equal_to_plain": bool(torch.equal(got[2], ref[2])
                                     and torch.equal(got[3], ref[3])),
              "sphere_rel_l2": [_rel_l2(got[k], ref[k]) for k in (0, 1)]}
        ln["sums_within"] = max(ln["sphere_rel_l2"]) <= BWD_SPHERE_RTOL
        lines.append(ln)
    if default is not None:
        k1.BWD_SHARED_BYTES = default
    return lines


def mega() -> list:
    """K7's lines on the three presets, then the megakernel and wavefront
    frames of both sphere presets."""
    return k7_lines() + frames((("megakernel", "random_spheres"),
                                ("frame", "random_spheres"),
                                ("megakernel", "random"), ("frame", "random")))


def k7_lines() -> list:
    """K7 on the camera rays of the three presets: time, hashes, and where
    the checkout counts them, lane-passes and yardsticks."""
    import inspect

    import torch

    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import megakernel as k7
    from pathtrace_tpu_torch.render.frame import generate_primary_rays
    from pathtrace_tpu_torch.utils.threefry import PRNGKey
    from pathtrace_tpu_torch.tools._probe import event_ms

    dev = torch.device("cuda")
    R = WIDTH * HEIGHT * SAMPLES
    counted = "work" in inspect.signature(k7.trace_megakernel).parameters
    lines = []
    for name in ("random_spheres", "random", "simple_light"):
        scene, cam = presets.from_name(name, WIDTH / HEIGHT)
        scene = scene.to(dev)
        feats = SceneFeatures.from_scene(scene)
        rays = tuple(x.reshape(R, -1).squeeze(-1) for x in
                     generate_primary_rays(cam, WIDTH, HEIGHT, SAMPLES,
                                           PRNGKey(0), device=dev))
        tables = k7.prep_tables(scene)
        work = {}
        rad, segs = (k7.trace_megakernel(tables, *rays, 7, MEGA_DEPTH, feats,
                                         work=work) if counted else
                     k7.trace_megakernel(tables, *rays, 7, MEGA_DEPTH, feats))
        ms = event_ms(lambda: k7.trace_megakernel(tables, *rays, 7, MEGA_DEPTH,
                                                  feats), MEGA_REPS)
        ln = {"bench": "mega", "scene": name, "kernel": "K7", "width": R,
              "depth": MEGA_DEPTH, "ms": ms, "segments": int(segs),
              "sha256": _sha256(rad, segs.reshape(1))}
        if "lane_passes" in work:
            ln["lane_passes"] = int(work["lane_passes"])
            ln["lane_occupancy"] = ln["segments"] / ln["lane_passes"]
        if counted:  # this checkout's plain version counts the work
            pwork = {}
            rad_p, segs_p = k7.trace_megakernel_plain(
                tables, *rays, 7, MEGA_DEPTH, feats, work=pwork)
            ln.update(k7_yardsticks(scene, tables, feats, R, int(segs_p),
                                    int(pwork["shaded"]),
                                    int(pwork["noise"])))
            ln["issue_share"] = ln["issue_ceiling_ms"] / ms
            passes = k7_lane_passes(pwork["ray_segments"])
            ln["block_uniform_lane_passes"] = passes
            ln["block_uniform_lane_occupancy"] = int(segs_p) / passes
            ln["max_abs_err_plain"] = float((rad - rad_p).abs().max())
            ln["segments_plain"] = int(segs_p)
            del rad_p
        lines.append(ln)
        del rad, tables, rays
    return lines


def _shade_scene(name: str):
    """(scene, camera) of a preset or of the image-light scene."""
    from pathtrace_tpu_torch.models import build, presets

    if name == "image_light":
        scene = presets.image_light_scene(build,
                                          presets._procedural_earth_image())
        return scene, presets.simple_light(WIDTH / HEIGHT)[1]
    return presets.from_name(name, WIDTH / HEIGHT)


# (scene, flag set, FLAG_EMIT_SCALE on): every flag set chip_smoke.py times
SHADE_SETS = (("random_spheres", "sphere", False), ("random", "motion", False),
              ("simple_light", "rect", False),
              ("simple_light", "rect_mis", True),
              ("two_perlin_spheres", "noise", False),
              ("cornell", "box", False), ("cornell", "box_mis", True),
              ("cornell_smoke", "medium", False),
              ("cornell_smoke", "medium_mis", True),
              ("earth", "image", False), ("earth", "image_mis", True),
              ("image_light", "rect_image_mis", True))


def _lanes_outside(out, out_p, alive, alive_p):
    """(worst plane's share of lanes outside 1e-3, alive agreement)."""
    a, b = out.double(), out_p.double()
    close = (a - b).abs() <= 1e-3 + 1e-3 * b.abs()
    worst = 1.0 - float(close.double().mean(dim=1).min())
    return worst, float((alive == alive_p).double().mean())


def shades(sets: Optional[Sequence[str]] = None) -> list:
    """K2's lines, one per flag set (``sets``: those flag sets only): the
    lane contract, hashes of both ray sets, the time and the yardsticks on
    the camera winners."""
    import torch

    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.ops import shade_kernel as k2
    from pathtrace_tpu_torch.render.frame import generate_primary_rays
    from pathtrace_tpu_torch.utils.threefry import PRNGKey
    from pathtrace_tpu_torch.tools._probe import event_ms

    dev = torch.device("cuda")
    R = WIDTH * HEIGHT * SAMPLES
    lines, cache = [], {}
    for name, flag_set, mis in SHADE_SETS:
        if sets is not None and flag_set not in sets:
            continue
        if name not in cache:
            cache.clear()
            scene, camera = _shade_scene(name)
            scene = scene.to(dev)
            feats = SceneFeatures.from_scene(scene)
            tables = fp.prep_tables(scene, feats)
            flags = fp.feature_flags(feats)
            ro, rd, tm = generate_primary_rays(camera, WIDTH, HEIGHT,
                                               SAMPLES, PRNGKey(0),
                                               device=dev)
            st0 = fp.make_state(ro.reshape(R, 3), rd.reshape(R, 3),
                                tm.reshape(R))
            t0, idx0 = fp.closest_hit(tables, st0, 0, feats, seed=7)
            planes, alive = k2.shade_from_winners(
                tables.table, idx0, t0, st0.planes, st0.time, st0.alive,
                st0.lane, 7, 0, 10, tables.sky4, flags, atlas=tables.atlas)
            st1 = fp.FastStateP(planes[:12], st0.time, alive, st0.lane)
            t1, idx1 = fp.closest_hit(tables, st1, 1, feats, seed=7)
            g = torch.Generator(device=dev)
            g.manual_seed(1)
            esc = torch.rand((2, R), generator=g, device=dev)
            cache[name] = (tables, flags, ((st0, t0, idx0), (st1, t1, idx1)),
                           esc)
            del planes, alive
        tables, flags, cases, esc = cache[name]
        fl = flags | (k2.FLAG_EMIT_SCALE if mis else 0)
        ln = {"bench": "shade", "scene": name, "flag_set": flag_set,
              "kernel": "K2", "flags": fl, "width": R, "sha256": {},
              "lanes_outside": {}, "noise_lanes": {}, "noise_lane_share": {},
              "noise_occupancy": {}}
        ok = True
        for k, (label, (st, t_, idx_)) in enumerate(
                zip(("primary", "scattered"), cases)):
            planes = (torch.cat([st.planes[:12], esc[k:k + 1]]) if mis
                      else st.planes)
            args = (tables.table, idx_, t_, planes, st.time, st.alive,
                    st.lane, 7, k, 10, tables.sky4, fl)
            out, alive = k2.shade_from_winners(*args, atlas=tables.atlas)
            out_p, alive_p = k2.shade_from_winners_plain(*args,
                                                         atlas=tables.atlas)
            worst, agree = _lanes_outside(out, out_p, alive, alive_p)
            ok = ok and worst <= 0.005 and agree >= 0.995
            ln["sha256"][label] = _sha256(out, alive)
            ln["lanes_outside"][label] = worst
            ys = k2_yardsticks(tables.table, fl, idx_, t_, tables.atlas)
            for key in ("noise_lanes", "noise_lane_share", "noise_occupancy"):
                ln[key][label] = ys[key]
            if label == "primary":
                ln["ms"] = event_ms(lambda: k2.shade_from_winners(
                    *args, atlas=tables.atlas), SHADE_REPS)
                if ys["noise_lanes"]:
                    # the same launch with the noise branch switched off:
                    # what the noise lanes add
                    off = args[:11] + (fl & ~k2.FLAG_NOISE,)
                    ln["ms_no_noise"] = event_ms(lambda: k2.shade_from_winners(
                        *off, atlas=tables.atlas), SHADE_REPS)
                ln.update({k_: ys[k_] for k_ in ("bound_ms", "bound_by",
                                                 "issue_ceiling_ms")})
                ln["bound_share"] = ln["bound_ms"] / ln["ms"]
                ln["issue_share"] = ln["issue_ceiling_ms"] / ln["ms"]
            del out, alive, out_p, alive_p, planes
        ln["lane_contract"] = ok
        lines.append(ln)
    cache.clear()
    return lines


def shade_turns(trees: Sequence[Tuple[str, str]], sets: Sequence[str],
                rounds: int) -> list:
    """K2's time on ``sets`` in several trees, in turns: each round runs
    this file's ``--what shade --sets`` once a tree with that tree first on
    ``PYTHONPATH``, in the order of ``trees`` and then in reverse, each
    run a process of its own. One line a flag set: each tree's samples
    and their [min, q1, median, q3, max], its median less the first
    tree's, and whether its output hashes equal the first tree's."""
    runs = {name: [] for name, _ in trees}
    for _ in range(rounds):
        for name, path in list(trees) + list(trees)[::-1]:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--what",
                 "shade", "--sets", ",".join(sets)],
                env={**os.environ, "PYTHONPATH": os.path.abspath(path)},
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"{name}: nearest_bench --what shade "
                                   f"failed:\n{proc.stderr[-4000:]}")
            got = [json.loads(ln) for ln in proc.stdout.splitlines()
                   if ln.startswith("{")]
            runs[name].append({ln["flag_set"]: ln for ln in got
                               if ln.get("bench") == "shade"})
    first = trees[0][0]
    lines = []
    for flag_set in sets:
        ms = {name: [r[flag_set]["ms"] for r in rs]
              for name, rs in runs.items()}
        spread = {name: [min(v), *statistics.quantiles(v, n=4), max(v)]
                  for name, v in ms.items()}
        lines.append({
            "bench": "shade_turns", "flag_set": flag_set, "rounds": rounds,
            "ms": ms, "spread_ms": spread,
            "median_less_first_ms": {n: spread[n][2] - spread[first][2]
                                     for n in ms},
            "sha256_equal_first": {n: all(
                r[flag_set]["sha256"] == runs[first][0][flag_set]["sha256"]
                for r in rs) for n, rs in runs.items()}})
    return lines


def p1_lines() -> list:
    """P1's lines: float32 and bf16 on ``P1_SHAPES``, each against the
    plain version bit for bit; at the probe's size also the all-miss rows
    and the share of pairs with disc > 0."""
    import torch

    from pathtrace_tpu_torch.tools import bf16_probe as p1
    from pathtrace_tpu_torch.tools._probe import event_ms

    dev = torch.device("cuda")
    lines = []
    for n_rays, n_spheres in P1_SHAPES:
        cols, rows = p1.make_inputs(n_rays, n_spheres, 0, dev)
        for name, dtype in p1.DTYPES.items():
            t = p1.sphere_min_t(cols, rows, dtype)
            t_p = p1.sphere_min_t_plain(cols, rows, dtype)
            ms = event_ms(lambda: p1.sphere_min_t(cols, rows, dtype), REPS)
            bnd = p1.bound(n_rays, n_spheres, dtype)
            ln = {"bench": "p1", "kernel": "P1", "dtype": name,
                  "rays": n_rays, "spheres": n_spheres, "ms": ms,
                  "equal_to_plain": bool(torch.equal(t, t_p)),
                  "sha256": _sha256(t), "bound_ms": bnd[0],
                  "bound_by": bnd[1], "bound_share": bnd[0] / ms}
            if hasattr(p1, "issue_ceiling"):
                ln["issue_ceiling_ms"] = p1.issue_ceiling(n_rays, n_spheres,
                                                          dtype)
                ln["issue_share"] = ln["issue_ceiling_ms"] / ms
            if (n_rays, n_spheres) == P1_SHAPES[0]:
                miss = rows.clone()
                miss[3] += 1e4  # every disc <= 0
                t_m = p1.sphere_min_t(cols, miss, dtype)
                ln["all_miss_equal"] = bool(
                    torch.equal(t_m, p1.sphere_min_t_plain(cols, miss, dtype))
                    and bool((t_m == p1.MISS_T).all()))
                sub = cols[:, :1 << 16]  # the share on a prefix of the rays
                ln["disc_positive_share"] = (
                    p1.positive_share(sub, rows, dtype)
                    if hasattr(p1, "positive_share") else None)
            lines.append(ln)
            del t, t_p
    return lines


def kernel_usage() -> dict:
    """ptxas's registers and spills of K2, K7 and P1 in this checkout."""
    return {"bench": "ptxas",
            **{k: ptxas_usage(k) for k in ("shade_kernel", "megakernel",
                                           "sphere_min_t_kernel")}}


def _cull_scene(name: str):
    from pathtrace_tpu_torch.models import presets

    if name == "cover20":
        return presets._random_impl(WIDTH / HEIGHT, True, 0, half_extent=20)
    return presets.from_name(name, WIDTH / HEIGHT)


def culls() -> list:
    """The culls' lines: K4 on the cover scene, K5 on xl, every (ray set,
    width) checked and timed."""
    import torch

    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.ops import intersect_kernel as k1
    from pathtrace_tpu_torch.ops import shade_kernel as k2
    from pathtrace_tpu_torch.render.frame import generate_primary_rays
    from pathtrace_tpu_torch.utils.threefry import PRNGKey
    from pathtrace_tpu_torch.tools._probe import event_ms

    dev = torch.device("cuda")
    R = WIDTH * HEIGHT * SAMPLES
    lines = []
    for name, kernel in (("cover20", "K4"), ("random_spheres_xl", "K5")):
        scene, camera = _cull_scene(name)
        scene = scene.to(dev)
        feats = SceneFeatures.from_scene(scene)
        tables = fp.prep_tables(scene, feats, cull=True)
        soa, cull = tables.soa, tables.cull
        n_tiles = cull.tiles.shape[1]
        ro, rd, tm = generate_primary_rays(camera, WIDTH, HEIGHT, SAMPLES,
                                           PRNGKey(0), device=dev)
        order, _ = fp._tile_perm(HEIGHT, WIDTH, dev)
        st = fp.make_state(*fp.permute_rays(ro.reshape(R, 3), rd.reshape(R, 3),
                                            tm.reshape(R), order, SAMPLES))
        t0, idx0 = k1.sphere_nearest(soa, st.planes[:6])
        planes, _ = k2.shade_from_winners(
            tables.table, idx0, t0, st.planes, st.time, st.alive, st.lane, 7,
            0, 10, tables.sky4, fp.feature_flags(feats))
        sets = (("primary", st.planes[:6]),
                ("scattered", planes[:6].contiguous()))
        for label, rays in sets:
            for width in (R, *CULL_WIDTHS):
                r_rays = rays[:, :width]
                t, idx, sweeps = k1.sphere_nearest_culled(
                    soa, r_rays, cull, count_sweeps=True)
                plain = k1.sphere_nearest_culled_plain(soa, r_rays, cull)
                t_1, idx_1 = k1.sphere_nearest(soa, r_rays)
                # the kernel's unit: 32 x rays a thread (32 in a checkout
                # from before the rays-a-thread template)
                k_rays = (k1.culled_kernel_rays(width, kernel == "K5")
                          if hasattr(k1, "culled_kernel_rays") else 1)
                units = -(-width // (32 * k_rays)) * n_tiles
                ms = event_ms(lambda: k1.sphere_nearest_culled(
                    soa, r_rays, cull), REPS)
                # the plain version of a checkout from before the
                # rays-a-thread template returns (t, idx, sweeps, tests)
                # and counts no pairs
                slots = int(plain[4]) if len(plain) > 4 else None
                ln = {"bench": "cull", "scene": name, "kernel": kernel,
                      "rays": label, "width": width, "tiles": n_tiles,
                      "ms": ms,
                      "equal_to_plain": bool(torch.equal(t, plain[0])
                                             and torch.equal(idx, plain[1])),
                      "equal_to_k1": bool(torch.equal(t, t_1)
                                          and torch.equal(idx, idx_1)),
                      "rays_per_thread": k_rays, "sweeps": int(sweeps),
                      "skipped_share": 1.0 - int(sweeps) / units,
                      "sweeps_equal": int(sweeps) == int(plain[2]),
                      "slots_swept_unit": slots, "box_tests": int(plain[3])}
                if slots is not None:
                    # pairs and tests at the 32-ray warp; the kernel's
                    # unit sweeps slots_swept_extra pairs more
                    ln.update(cull_yardsticks(soa, cull, r_rays))
                    ln["slots_swept_extra"] = slots - ln["slots_swept"]
                    ln["issue_share"] = ln["issue_ceiling_ms"] / ms
                if width == R:
                    ln["k1_ms"] = event_ms(lambda: k1.sphere_nearest(
                        soa, r_rays), 5)
                lines.append(ln)
        del planes, st, tables
    return lines


def _frame_line(name: str) -> dict:
    """One wavefront frame of a culled scene at the bench's film: the
    median of ``FRAME_REPS`` frames and one profiled frame's device
    busy time."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops.fastpath import render_frame_fast
    from pathtrace_tpu_torch.utils.threefry import PRNGKey, fold_in

    dev = torch.device("cuda")
    scene, cam = _cull_scene(name)
    scene, cam = scene.to(dev), cam.to(dev)
    feats = SceneFeatures.from_scene(scene)
    base_key = PRNGKey(0)
    box = {"frame": 0}

    def frame():
        box["frame"] += 1
        render_frame_fast(scene, cam, WIDTH, HEIGHT, SAMPLES, 10,
                          fold_in(base_key, box["frame"]), box["frame"], feats)

    for _ in range(2):
        frame()
    torch.cuda.synchronize()
    times = []
    for _ in range(FRAME_REPS):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        frame()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        frame()
        torch.cuda.synchronize()
    busy, culled = 0.0, {}
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = float(getattr(evt, "self_device_time_total",
                               getattr(evt, "self_cuda_time_total", 0.0)))
            busy += us / 1e3
            if "sphere_nearest_culled" in evt.key:
                culled[evt.key[:90]] = {"ms": us / 1e3, "launches": evt.count}
    median = statistics.median(times)
    return {"bench": "cull_frame", "scene": name, "frame_ms_median": median,
            "frame_ms": times, "device_busy_ms": busy,
            "idle_share_unprofiled": 1.0 - busy / median, "culled": culled}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="nearest_bench")
    ap.add_argument("--what", choices=("all", "nearest", "cull", "bwd",
                                       "mega", "shade", "p1", "shade-turns"),
                    default="all", help="K1/K3 and their frames, the culls "
                    "and theirs, or both; K6 and the train steps; K7 and "
                    "the megakernel frames; K2 on every flag set and K7's "
                    "hashes; P1 in both types; K2 in several trees in "
                    "turns")
    ap.add_argument("--sets", default=None,
                    help="comma-separated flag sets of SHADE_SETS: K2 on "
                    "these alone (without K7's lines and ptxas's)")
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=PATH", help="shade-turns: a checkout to "
                    "time (repeat; the first is the one compared against)")
    ap.add_argument("--rounds", type=int, default=6,
                    help="shade-turns: rounds, each every tree forth and "
                    "back")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sets = args.sets.split(",") if args.sets else None
    if sets and not set(sets) <= {fs for _, fs, _ in SHADE_SETS}:
        ap.error(f"--sets: flag sets are {[fs for _, fs, _ in SHADE_SETS]}")
    if args.what == "shade-turns" and (len(args.tree) < 2 or not sets):
        ap.error("shade-turns takes two --tree or more and --sets")

    import torch

    if not torch.cuda.is_available():
        print("nearest_bench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from pathtrace_tpu_torch.tools._probe import device_line

    card = device_line(torch.device("cuda"))
    lines = []
    if args.what in ("all", "nearest"):
        lines += sweeps() + frames()
    if args.what in ("all", "cull"):
        lines += culls() + [_frame_line(n) for n in ("cover20",
                                                    "random_spheres_xl")]
    if args.what == "bwd":
        lines += bwd()
    if args.what == "mega":
        lines += mega()
    if args.what == "shade":
        lines += shades(sets)
        if sets is None:
            lines += k7_lines() + [kernel_usage()]
    if args.what == "shade-turns":
        lines += shade_turns([tuple(t.split("=", 1)) for t in args.tree],
                             sets, args.rounds)
    if args.what == "p1":
        lines += p1_lines() + [kernel_usage()]
    for ln in lines:
        ln["card"] = card
        print(json.dumps(ln), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(ln) + "\n" for ln in lines)
    if not all(ln.get(k, True) for ln in lines
               for k in ("equal_to_plain", "equal_to_k1", "sweeps_equal",
                         "sums_within", "lane_contract", "all_miss_equal")):
        print("nearest_bench: a kernel differs from its plain version or K1",
              file=sys.stderr)
        return 1
    if not all(all(ln.get("sha256_equal_first", {}).values())
               for ln in lines):
        print("nearest_bench: a tree's K2 outputs differ from the first's",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
