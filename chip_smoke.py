"""Card check of the PyTorch/CUDA port: builds its kernels, holds each
against its plain PyTorch version, holds a trace and its gradients
against the committed JAX reference fixtures, renders the main path
through the CLI and trains through the inverse-rendering entry point.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints a line before the next starts):

1. the card: ``torch.cuda.is_available()`` or exit non-zero; device name
   and ``nvidia-smi`` name and power limit;
2. build: nvcc on ``pathtrace_tpu_torch/csrc``, with the build seconds;
3. K1 (closest hit) against its plain version on the primary rays of
   ``random_spheres`` at 1280x720x4 and on once-scattered rays: t and idx
   must be equal; K1's time on both ray sets, each as a share of the
   bound and of the issue ceiling under ``-fmad=false``, and ptxas's
   registers and spills for each rays-a-thread instance;
4. K2 (fused shade) against its plain version on the same winners, under
   the lane contract (1e-3, at most 0.5% of lanes outside), with its
   time, bound and issue ceiling (``tools/nearest_bench.k2_yardsticks``;
   every K2 check of the later phases prints the same);
5. the port's CUDA trace of the fixture's rays against the JAX radiance
   in ``tests/goldens/torch_port_random_spheres.npz`` (depth 10: 1e-3, at
   most 1% of rays outside; K1 at every bounce, no plain version);
6. ``pathtrace_tpu_torch.cli.main`` renders random_spheres at 1280x720,
   4 spp, depth 10, 3 progressive frames; K1 and K2 must have launched
   and the plain versions never run;
7. K6 (the closest hit's backward) against its plain version on the
   winners of phase 3: per-ray g_ro and g_rd equal bit for bit (at most
   ``K6_MAX_ULP`` ULPs allowed), per-sphere sums within relative L2 1e-4
   (warp trees and atomics sum in another order); K6's time, its share
   of the byte bound, its grid and instance (``bwd_launch``) and ptxas's
   registers for each instance;
8. the port's CUDA ``trace_fast_diff`` (depth 4) of the gradient
   fixture's rays: radiance under the lane contract and per-leaf
   gradients within ``FIXTURE_GRAD_TOL`` (``tests/torch_port_util.py``)
   of JAX's in
   ``tests/goldens/torch_port_grad_small.npz``;
9. ``python -m pathtrace_tpu_torch.examples.inverse_render``'s ``main``
   trains random_spheres at 1280x720, 4 spp, depth 4, 5 Adam steps,
   twice: every default-trainable leaf (the full configuration), then the
   texture colours only (the example's own problem). Each run must give
   finite losses, move the parameters and launch K1 and K6 with no plain
   version run; the colour run's loss must be lower at step 5 than at
   step 1 (with the geometry leaves the loss need not fall: see the
   phase);
10. K4 (the flat cull) on the cover scene at half_extent 20 (1604
    spheres, 13 tiles) and 11. K5 (the two-level cull) on
    random_spheres_xl (4100 spheres in 6144 slots, 48 tiles in
    supertiles of 16), each on the 1280x720x4 primary rays in 64x64
    tile order, on once-scattered rays and on ``CULL_NARROW`` of those
    compacted (the first alive lanes, the width of a late rung of the
    ladder; together the three sets reach every rays-a-thread instance the
    path launches, else the phase fails): the rays a thread the
    launcher picks (its C entry, held to its Python mirror), t and idx
    equal to the plain version and to K1's kernel, the (warp, tile) sweep
    count equal to the plain version's at the kernel's unit (a warp's 32
    x rays a thread), the share of sweeps skipped, the (ray, live slot)
    pairs swept, and the times of the kernel on the three ray sets, of K1 on
    the same rays and of the plain version, with the bound, the issue
    ceiling and ptxas's registers for each rays-a-thread instance; phase
    10 then renders 3 frames of its scene through ``render_progressive``
    (K4's path: K4 launched, K1, K5 and every plain version not);
12. the port's CUDA trace of the xl fixture's tile-ordered rays against
    JAX's radiance in ``tests/goldens/torch_port_random_spheres_xl.npz``
    (depth 10, ``XL_DEPTH10_BUDGET`` of the rays outside 1e-3; K5 at
    every bounce);
13. ``cli.main`` renders random_spheres_xl at 1280x720, 4 spp, depth 10,
    3 frames (K5 launched, K1, K4 and every plain version not), then the
    same frames with the cull and the tile order off (``CULL_MIN_TILES``
    patched high: K1 brute force); both frame times are printed;
14. K3 (the moving-sphere closest hit) against its plain version on the
    primary rays of ``random`` at 1280x720x4 (camera times in [0, 1)) and
    on once-scattered rays: t and idx must be equal; K3 on random_spheres
    with its zero motion operand must equal K1 bit for bit; the times of
    K3 (primary and scattered rays), of its plain version and of K1 on the
    same rays, the bound and the issue ceiling and K3's shares of both,
    and ptxas's registers and spills;
15. K2 with the motion flag against its plain version on phase 14's
    winners, under the lane contract;
16. the port's CUDA trace of the rays in ``tests/goldens/torch_port_random.npz``
    against JAX's radiance (depth 10, ``DEPTH10_BUDGET``), through K3 at
    every bounce;
17. ``cli.main`` renders random at 1280x720, 4 spp, depth 10, 3 frames:
    K3 and K2 launched, K1, K4, K5 and every plain version not;
18. K6 for moving spheres against its plain version on phase 14's
    winners: per-ray g_ro, g_rd and g_time within ``K6_MAX_ULP``, the
    per-sphere sums of all nine components (centre, delta, time0,
    inv_dt, radius) within relative L2 ``K6_SPHERE_RTOL``;
19. the CUDA ``trace_fast_diff`` (depth 4) of
    ``tests/goldens/torch_port_grad_random.npz``: per-leaf gradients,
    ``spheres.center_delta`` included, within ``MOTION_FIXTURE_GRAD_TOL``;
20. ``examples.inverse_render.main`` trains random at 1280x720, 4 spp,
    depth 4, 5 Adam steps, every default-trainable leaf: finite losses,
    every leaf moves (``spheres.center_delta`` included), K3 and K6
    launched and no plain version run;
21. K7 (the megakernel: the whole bounce loop in one kernel) against its
    plain version on the 1280x720x4 primary rays of ``random_spheres``
    at depth 10: at most 1% of rays outside 1e-3, the segment counts
    within 0.5%; the resident rows, the lane occupancy (segments over
    K7's lane-passes, and over those of a block-uniform loop, from the
    plain version's per-ray segments), the times of the kernel and of
    the plain version, the bound and the ``-fmad=false`` issue ceiling
    (``tools/nearest_bench.k7_yardsticks``);
22. the same on ``random`` (moving spheres) and ``simple_light`` (a rect,
    diffuse lights, the noise texture, a black sky);
23. K7 on the rays of ``tests/goldens/torch_port_megakernel.npz`` against
    JAX's megakernel (``simple_light`` depth 8: 0.5% of rays; ``random``
    depth 10: ``DEPTH10_BUDGET``), then against the port's ``trace_fast``
    on phases 21-22's full-width rays of ``random_spheres`` and
    ``random``: at least 99% of rays within 1e-3, segments within 1%;
24. 3 frames each of ``random_spheres``, ``random`` and ``simple_light``
    at 1280x720, 4 spp, depth 10 through ``generate_primary_rays``, then
    ``trace_megakernel`` over the scene's tables (built once per scene,
    timed apart), then the sample mean, timed with CUDA events
    beside the wavefront frames of phases 6 and 17: K7 launched once a
    frame, no plain version and no K1, K2 or K3;
25. K2 with the rect flag against its plain version on the winners (K1
    and the rect sweep merged) of ``simple_light``'s 1280x720x4 primary
    rays and once-scattered rays, then with the MIS flag on a random
    ``emit_scale`` plane (its extra rows, the plane copied through, the
    normal and the albedo, included), under the lane contract; then K2
    with the noise flag and no rect on ``two_perlin_spheres``' winners
    (two marble spheres); the times of the kernel, of its plain version,
    its bound and issue ceiling, the share of lanes that take the noise
    branch and their occupancy (noise lanes over 32 x the warps with
    one), and per full-width bounce the rect sweep and the NEE and
    roulette tails (plain PyTorch);
26. the CUDA trace of the rays in ``tests/goldens/torch_port_simple_light.npz``
    against JAX's radiance, plain and with NEE and roulette from depth 3
    (``torch_port_simple_light_nee.npz``), depth 10, ``DEPTH10_BUDGET``;
27. ``cli.main`` renders simple_light at 1280x720, 4 spp, depth 10, 3
    frames, then the same with ``--nee --rr 3``: K1 and K2 launched, K3,
    K4, K5 and every plain version not; frame times, readbacks and
    segments (shadow rays included); the NEE image finite, its mean
    within 5% of the plain image's;
28. the wavefront ``trace_fast`` of ``simple_light`` (no NEE) against K7
    ray by ray on phase 22's full-width rays: at least 99% within 1e-3;
29. boxes and media on the wavefront path, ``cornell`` (two rotated boxes)
    and ``cornell_smoke`` (two media boxes), no sphere: K2 with the box
    flag and with the medium flag, each with and without the MIS flag on a
    random ``emit_scale`` plane, against its plain version on the winners
    (the rect, box and media sweeps merged) of the 1280x720x4 primary rays
    and once-scattered rays, under the lane contract; the times of the
    kernel, of its plain version and its bound; per full-width bounce the
    time and the device launches (``torch.profiler``) of the rect, box and
    media sweeps, of the NEE tail and of whole bounces;
30. the CUDA trace of the rays in ``tests/goldens/torch_port_cornell.npz``
    (plain and NEE + roulette) and ``torch_port_cornell_smoke_nee.npz``
    (NEE + roulette and plain) against JAX's radiance, depth 10,
    ``DEPTH10_BUDGET``: K2 at every bounce, no closest-hit kernel;
31. ``cli.main`` renders cornell and cornell_smoke at 1280x720, 4 spp,
    depth 10, 3 frames each, plain and with ``--nee --rr 3``: K2
    launched, no closest-hit kernel (the scenes have no sphere) and no
    plain version; frame times, readbacks, segments (shadow rays
    included) and Mrays/s; each NEE image finite, its mean within 5% of
    the plain image's;
32. image textures: K2 with the image flag against its plain version on
    ``earth``'s winners (1280x720x4 primary and once-scattered rays; with
    and without the MIS flag) and on the image-light scene's
    (``models/presets.image_light_scene``: ``simple_light`` with an
    image globe and two image walls) with the rect, image and MIS flags:
    lanes outside the contract, the image lanes whose albedo (the texel)
    differs between kernel and plain version (texel-index flips), the
    times of the kernel and its plain version, the bound (bytes: the state
    planes, the table and the atlas, each once), and the plain texel
    pre-pass ``image_rgb_planes`` that the kernel folds in (its time and
    device launches at full width);
33. the CUDA traces of ``tests/goldens/torch_port_earth.npz`` (plain) and
    ``torch_port_image_light_nee.npz`` (NEE + roulette from depth 3)
    against JAX's radiance, depth 10, ``DEPTH10_BUDGET``: K1 and K2 at
    every bounce, no other kernel, no plain version;
34. ``cli.main`` renders ``earth`` at 1280x720, 4 spp, depth 10, 3 frames,
    then again with ``--image`` pointing at a PNG the script writes (the
    globe takes its colour); then the image-light scene through
    ``trace_frame``, plain and with NEE + roulette from depth 3, 3 frames
    each timed with CUDA events: K1 and K2 launched, no other kernel and
    no plain version; frame times, readbacks, segments, image means (NEE
    within 5% of plain);
35. P1, the reduced-precision sphere sweep probe
    (``pathtrace_tpu_torch.tools.bf16_probe``), at the reference's size
    (2^20 rays x 640 spheres, its input distributions): the kernel
    against its plain version in float32 and in bf16, bit for bit, on
    those inputs and on rows whose every disc <= 0 (t = 1e30
    everywhere); the share of rays whose bf16 t leaves the float32 one
    by more than 1e-3 and the rays that hit in one type and miss in the
    other; kernel (device time), plain, bound and issue-ceiling times;
    then both types bit for bit on a ragged shape (``P1_RAGGED``: 2^20 + 3
    rays, 1031 spheres, two tiles of an odd count) with its time, and
    ptxas's registers and spills of each type's instance; then the
    probe's ``main`` at its defaults, which must launch P1 and no plain
    version;
36. P2-P4, the winner-attribute layout probes
    (``pathtrace_tpu_torch.tools.split_probe``), 2^20 winners of a
    640 x 24 table: each kernel against its plain version bit for bit on
    its layout (split planes, (rows, K, 128), (K, rows, 128)),
    ``torch.sum`` within 1e-5 (P3, P4); kernel, gather + layout, plain,
    library and bound times; the kernel and ``torch.sum`` timed in turns
    on inputs rotated past the L2 cache (``_probe.alternated_cold_ms``:
    [min, median, max] of each, the ratio of the medians); then the
    probe's ``main`` at its defaults, which must launch P2, P3 and P4 and
    no plain version;
37. the Threefry draw (``csrc/threefry.cu``, the twin of ``jax.random``
    that keys every frame's primary rays) against the plain twin
    (``utils/threefry.py``, run on the card for the comparison only), bits
    and uniforms bit for bit, on a frame's two draws (1280x720x4 x 2 and
    x 3, 18,432,000 uniforms); the time of that draw, of the plain twin
    and of ``torch.rand`` of the same shapes, its bound
    (``tools/nearest_bench.threefry_yardsticks``: 4 bytes written and 76
    integer operations a draw at the issue rate) and ptxas's registers;
38. ``render_frame_fast`` on the card at the per-pixel goldens' film (64x48,
    8 spp, depth 8, ``PRNGKey(0)``, seed 0) for every ported preset,
    against the JAX package's ``tests/goldens/pixels_<preset>_fast.npz``:
    at most ``1 - (1 - b)^8`` of the pixels outside 1e-3 (b the preset's
    per-ray budget);
39. ``smallpt`` and ``aras``: K1 against its plain version (t, idx equal)
    on 3.69M primary and once-scattered rays, K2 under the lane contract,
    K7 against its plain version (phase 21's check), then the CUDA trace,
    K7 and the bounce chain (``torch_port_util.port_bounce_chain``) of the
    rays of ``tests/goldens/torch_port_<preset>.npz`` against JAX's
    radiance, megakernel and path states (``smallpt``: its own path budget,
    ``SMALLPT_DEPTH10_BUDGET``), and K7 under a white sky against its plain
    version and JAX's megakernel there, ray by ray, to the same budget
    (``smallpt``'s own radiance is black on all but a few rays; under the
    white sky an escaping path returns its throughput); then ``final``: K1
    over its one dead row
    misses every ray, and K2 and K7 leave every lane at the gradient sky;
40. ``cli.main`` renders ``smallpt`` and ``aras`` at 1280x720, 4 spp, depth
    10, 3 frames each, then ``aras`` with ``--stratify``: K1, K2 and the
    Threefry kernel launched (2 draws a frame, 4 stratified), no other
    kernel and no plain version; frame times, segments, finite images, the
    stratified image's mean within 5% of the iid one's;
41. the general integrator (``render/frame.render_frame``) on the card at
    the goldens' film for all 13 presets, ``final_full`` included,
    against ``tests/goldens/pixels_<preset>_general.npz`` to the same
    pixel budget: K1 (K3 in a moving scene) launched, no plain version,
    no K2 or K7;
42. ``render_progressive`` renders ``random_spheres`` with ``mode=
    "general"`` (3 frames) and ``final_full`` with ``mode="auto"`` (1
    frame; routed to the general path), 1280x720, 4 spp, depth 10: frame
    times (CUDA events), segments, Mrays/s, bounces, readbacks, the
    launches of K1, K3 and the Threefry draw; then one more frame of
    ``random_spheres`` under ``torch.profiler`` (device activity only):
    device busy time, idle share, device launches a bounce and the top
    kernels (``final_full``'s are ``tools/profile_step.py``'s: its
    ~430,000 launches a frame keep the profiler busy for ~110 s); the path must be general and
    K1 (K3 for ``final_full``) must have launched, no plain version;
43. ``trace_diff`` on the card: the ``vfov`` gradient of the full-view
    sphere (24x24, 4 spp, depth 3, ``PRNGKey(6)``, tests/test_grad.py's
    ``test_vfov``) finite and within 1e-3 relative of the CPU port's and
    of ``jax.grad``'s (``tests/goldens/torch_port_camera_grads.npz``), K1
    forward and K6 backward launched;
44. the silhouette boundary term (``ops/silhouette.silhouette_grads_all``)
    of the six cases of ``tests/goldens/torch_port_silhouette.npz`` (a
    flat sphere, a moving sphere, an aperture camera, a rect, a box, a
    mixed scene) on the card against the CPU port and the JAX fixture,
    per leaf by relative L2 within ``SIL_WHOLE_TOL``; its pair traces run
    K1 (K3 in the moving scenes), no plain version;
45. the ``--geometry`` trainer at full width: ``random_spheres`` at
    1280x720, 4 spp, depth 4, every default leaf, the silhouette term at
    128 samples, 3 Adam steps: ms a step (CUDA events), the silhouette
    term's ms and share of the step, peak memory, K1 and K6 launched and
    no plain version; then the example's ``--geometry`` run on ``small``
    (10 steps at its defaults), whose loss must fall;
46. one full-width differentiable step (1280x720x4, depth 4, the default
    leaves) on ``cornell`` (boxes), ``cornell_smoke`` (media) and
    ``earth`` (an image): loss, ms, peak memory (a step that does not fit
    runs at half the film, said so); K1 and K6 on ``earth``;
47. bit-exact resume on the card: ``cli.main`` with ``-F 4`` against
    ``-F 2 --checkpoint`` twice (``random_spheres`` 640x360x4, depth 10),
    and the example's 5 steps against 2 steps, a checkpoint, then 3 more
    (the colours, under torch's deterministic algorithms, which the
    example turns on with ``--checkpoint``): images and checkpoint leaves
    equal bit for bit; two identical 3-step ``--geometry`` runs under the
    same deterministic algorithms compared (K6 sums with atomics; printed,
    not required).

Before the kernels line, ``[t]`` gives the seconds of each phase (each
line's time since the line before it, summed by phase).

The line before the last two is a JSON object with, per kernel, its
launches on its path (phase 6 for the render kernels, phase 9 for the
trainer's, phase 10 for K4, phase 13 for K5, phases 17 and 20 for K3
and the motion runs of K2 and K6, phase 31 for K2's box and medium
runs; phase 34's ``earth`` frames for K2's image entry, phases 35 and 36's
probe runs for P1-P4, phase 6 for the Threefry draw), its largest
difference
from the plain version, its time, the plain version's time, its bound
(the larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s fp32,
from this run's shapes; K1 and K3 count the operations their function
needs, 16 a (ray, live sphere) pair and 38 where the sphere moves, with
``tools/nearest_bench.yardsticks``, and also carry ``ms_scattered``, their
time on once-scattered rays, ``issue_ceiling_ms``, the least time when
each fp32 operation is one instruction (``-fmad=false``) at one warp
instruction a clock per SM sub-partition, 33.5 T a second, and ptxas's
``registers``; for K4 and K5 the operations of the sweeps this
run's data needs, 16 a (ray, live slot) pair swept plus ~30 a ray-box
test, both counted at the fixed unit of a 32-ray warp
(``tools/nearest_bench.cull_yardsticks``), with the same
``ms_scattered``, ``issue_ceiling_ms`` and ``registers``, the pairs
swept at that unit (``slots_swept``) and the extra pairs the kernel's
own unit sweeps (``slots_swept_extra``), and ``ms_narrow``, the time on
``narrow_rays`` compacted scattered rays at ``narrow_rays_per_thread``;
for K7 those of the segments this run traced, 17
per (segment, live sphere) pair, 30 where the sphere moves, 6 per
(segment, live rect) pair and ~250 of shading per segment
(``tools/nearest_bench.k7_yardsticks``), with ``issue_ceiling_ms``,
``lane_occupancy`` (and a block-uniform loop's) and ptxas's
``registers``; phase 24 for K7's launches; K6 also carries its
``issue_ceiling_ms``, grid, instance and ``registers``; K2, per flag set
(``random_spheres``' at the top level, then ``motion_``, ``rect_``,
``emit_scale_``, ``noise`` (two_perlin_spheres), ``box``, ``medium`` and
the image entry's), ``issue_ceiling_ms``, counted from the plain
version's operations on the lanes that take each branch (~300 a lane,
1708 more a noise lane, ~100 a box lane, ~150 an image lane:
``tools/nearest_bench.k2_yardsticks``), ``noise_lane_share`` and
``noise_occupancy`` on the timed camera winners, and ptxas's
``registers``; P1 also ``issue_ceiling_ms`` (22 instructions a float32
pair, 16 a bf16 pair: ``bf16_probe.issue_ceiling``),
``rays_per_thread`` (the launcher's, held to its Python mirror),
``registers`` and the ragged shape's results)
and ``library_ms``: ``torch.sum`` over the attribute dimension for P3 and
P4 (device time; a yardstick the port never calls; P2-P4 also carry
``kernel_cold_ms``, ``library_cold_ms`` and ``kernel_over_library``,
phase 36's alternated times on cold inputs), null for the rest
(no single PyTorch call computes them; P2's K planes are K tensors). P1's
bound counts 16 operations a ray-sphere pair in its type (bf16 at the
white paper's packed 133.8 TFLOP/s) and 6 in float32; P2-P4's the bytes,
(K + 1) x 4 per winner.
K4 and K5 also carry the share of sweeps skipped and K1's time on the
same rays. K1, K2 and K7 carry ``sphere_presets`` (phase 39's numbers and
phase 40's launches on ``smallpt`` and ``aras``); the ``threefry`` entry
(``"replaces": "jax.random.uniform (XLA)"``, no TPU kernel) carries its
bound by bytes alone, ``torch_rand_ms`` and phase 38's share of pixels
outside per preset. K1, K3, K6 and the ``threefry`` entry carry
``general_launches`` (phase 42's ``random_spheres`` frames for K1 and the
draw, its ``final_full`` frame for K3, phase 43 for K6); the ``threefry``
entry also phases 41-42's shares and frames. K1 and K3 carry
``silhouette_launches`` (phase 44) and K1 and K6
``geometry_train_launches`` (phase 45) and ``diff_scene_launches``
(phase 46); K6 carries phases 44-46's runs. Then
comes the ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
Any failure raises: the script then exits non-zero and prints no result.
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
GRAD_FIXTURE = os.path.join(ROOT, "tests", "goldens",
                            "torch_port_grad_small.npz")
XL_FIXTURE = os.path.join(ROOT, "tests", "goldens",
                          "torch_port_random_spheres_xl.npz")
RANDOM_FIXTURE = os.path.join(ROOT, "tests", "goldens", "torch_port_random.npz")
RANDOM_GRAD_FIXTURE = os.path.join(ROOT, "tests", "goldens",
                                   "torch_port_grad_random.npz")
MEGA_FIXTURE = os.path.join(ROOT, "tests", "goldens",
                            "torch_port_megakernel.npz")
CAMERA_GRAD_FIXTURE = os.path.join(ROOT, "tests", "goldens",
                                   "torch_port_camera_grads.npz")
SIL_FIXTURE = os.path.join(ROOT, "tests", "goldens",
                           "torch_port_silhouette.npz")
# the --geometry trainer at full width: Adam steps, the silhouette samples
GEO_STEPS, SIL_SAMPLES = 3, 128
WIDTH, HEIGHT, SAMPLES, DEPTH, FRAMES = 1280, 720, 4, 10, 3
TRAIN_DEPTH, TRAIN_STEPS = 4, 5
# the slice contract: per-ray radiance to 1e-3 (rtol and atol); the share
# of rays allowed outside is 0.5% per bounce, 1% after ten bounces
RTOL = ATOL = 1e-3
# K4 and K5 are also checked and timed on this many compacted scattered
# rays: a rung of the ladder's late bounces, below K4's switch to 2 rays a
# thread (202,752 rays on 132 SMs)
CULL_NARROW = 131_072
# K6 per-ray gradients repeat autograd's operations one for one (bitwise
# expected); per-sphere sums are atomics in another order
K6_MAX_ULP = 4
K6_SPHERE_RTOL = 1e-4
LIGHT_FIXTURE = os.path.join(ROOT, "tests", "goldens",
                             "torch_port_simple_light.npz")
NEE_FIXTURE = os.path.join(ROOT, "tests", "goldens",
                           "torch_port_simple_light_nee.npz")
CORNELL_FIXTURE = os.path.join(ROOT, "tests", "goldens",
                               "torch_port_cornell.npz")
SMOKE_FIXTURE = os.path.join(ROOT, "tests", "goldens",
                             "torch_port_cornell_smoke_nee.npz")
RR_START = 3
IMAGE_LIGHT_FIXTURE = os.path.join(ROOT, "tests", "goldens",
                                   "torch_port_image_light_nee.npz")
EARTH_FIXTURE = os.path.join(ROOT, "tests", "goldens", "torch_port_earth.npz")
# the probes at the reference's sizes (tools/bf16_probe.py,
# tools/split_probe.py): P1 2^20 rays x 640 spheres; P2-P4 2^20 winners
# (of the probe's 640 x 24 table)
P1_RAYS, P1_SPHERES = 1 << 20, 640
# and a ragged ray count with an odd sphere count, not a multiple of the
# kernel's tile (1024 spheres): a ragged last block, two tiles
P1_RAGGED = ((1 << 20) + 3, 1031)
P24_RAYS = 1 << 20


_T0 = time.monotonic()
_LAST = [_T0]
PHASE_SECONDS: dict = {}  # tag -> seconds up to the tag's lines


def phase(msg: str) -> None:
    """Print a phase line; the time since the last line goes to its tag."""
    now = time.monotonic()
    m = re.match(r"\[([^\]]+)\]", msg)
    tag = m.group(1) if m else "?"
    PHASE_SECONDS[tag] = PHASE_SECONDS.get(tag, 0.0) + now - _LAST[0]
    _LAST[0] = now
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


def kernel_registers(log: str, tag: str) -> dict:
    """{template arguments after ``tag``: "registers, spill bytes"} of a
    kernel template's instances, from ptxas's build log. ``tag``: the
    mangled name up to those arguments, as "sphere_nearest_kernelILb1E"
    (K3, keyed by rays a thread), "sphere_nearest_culled_kernelILb0E" (K4)
    or "megakernelI" (K7, keyed "<true>", "<false>")."""
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(tag + r"((?:L[bi]\d+E)+)E", m.group(1))
            args = re.findall(r"L([bi])(\d+)E", k.group(1)) if k else []
            key = (None if not args else int(args[0][1])
                   if args == [("i", args[0][1])] else "<" + ", ".join(
                       {"0": "false", "1": "true"}[v] if t == "b" else v
                       for t, v in args) + ">")
        elif key is not None and "spill stores" in ln:
            out[key] = ln.split("stack frame, ")[-1].strip()
        elif key is not None and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out[key] = f"{regs} registers, {out.get(key, '')}".rstrip(", ")
            key = None
    return out


def rays_outside(radiance, ref_radiance):
    """(rays outside, their share): rays whose radiance [R, 3] leaves the
    reference's (numpy) by more than ATOL + RTOL * |ref| in a channel."""
    import torch

    a64 = radiance.cpu().double()
    b64 = torch.from_numpy(ref_radiance).double()
    close = ((a64 - b64).abs() <= ATOL + RTOL * b64.abs()).all(dim=1)
    n_out = int((~close).sum())
    return n_out, n_out / close.numel()


def ulp_distance(a, b) -> int:
    """Largest distance in float32 ULPs between two float tensors."""
    import torch

    def ordered(x):
        i = x.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(a) - ordered(b)).abs().max().item()) if a.numel() else 0


def rel_l2(a, b) -> float:
    a64, b64 = a.double(), b.double()
    return float((a64 - b64).norm() / max(float(b64.norm()), 1e-30))


def reset_counts(k1, k2, k7) -> None:
    """Every launch and plain-call counter of the kernel wrappers to 0."""
    from pathtrace_tpu_torch.tools import bf16_probe, split_probe
    from pathtrace_tpu_torch.utils import threefry

    for name in ("LAUNCHES", "PLAIN_CALLS", "BWD_LAUNCHES", "BWD_PLAIN_CALLS",
                 "FLAT_LAUNCHES", "FLAT_PLAIN_CALLS", "HIER_LAUNCHES",
                 "HIER_PLAIN_CALLS", "MOVING_LAUNCHES", "MOVING_PLAIN_CALLS"):
        setattr(k1, name, 0)
    k2.LAUNCHES = k2.PLAIN_CALLS = 0
    k7.LAUNCHES = k7.PLAIN_CALLS = 0
    threefry.LAUNCHES = threefry.PLAIN_CALLS = 0
    bf16_probe.LAUNCHES = bf16_probe.PLAIN_CALLS = 0
    for kind in ("SPLIT", "MINOR", "MAJOR"):
        setattr(split_probe, f"{kind}_LAUNCHES", 0)
        setattr(split_probe, f"{kind}_PLAIN_CALLS", 0)


def read_counts(k1, k2, k7) -> dict:
    """Launches per kernel, and the plain versions' calls summed."""
    from pathtrace_tpu_torch.tools import bf16_probe as p1
    from pathtrace_tpu_torch.tools import split_probe as p24
    from pathtrace_tpu_torch.utils import threefry as tf

    return {"K1": k1.LAUNCHES, "K2": k2.LAUNCHES, "K3": k1.MOVING_LAUNCHES,
            "K4": k1.FLAT_LAUNCHES, "K5": k1.HIER_LAUNCHES,
            "K6": k1.BWD_LAUNCHES, "K7": k7.LAUNCHES, "P1": p1.LAUNCHES,
            "P2": p24.SPLIT_LAUNCHES, "P3": p24.MINOR_LAUNCHES,
            "P4": p24.MAJOR_LAUNCHES, "threefry": tf.LAUNCHES,
            "plain": (k1.PLAIN_CALLS + k2.PLAIN_CALLS + k1.BWD_PLAIN_CALLS
                      + k1.FLAT_PLAIN_CALLS + k1.HIER_PLAIN_CALLS
                      + k1.MOVING_PLAIN_CALLS + k7.PLAIN_CALLS
                      + p1.PLAIN_CALLS + p24.SPLIT_PLAIN_CALLS
                      + p24.MINOR_PLAIN_CALLS + p24.MAJOR_PLAIN_CALLS
                      + tf.PLAIN_CALLS)}


def probe_main(tag: str, probe, argv, k1, k2, k7):
    """Drive a probe's entry point (``probe.main(argv)``) with every count
    at 0: (the counts just after, its JSON lines). Raises unless it exits
    0 and launched no render or training kernel."""
    reset_counts(k1, k2, k7)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = probe.main(argv)
    counts = read_counts(k1, k2, k7)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    for ln in lines:
        phase(f"[{tag}] {probe.__name__.rsplit('.', 1)[-1]}: {json.dumps(ln)}")
    phase(f"[{tag}] launches {counts}")
    if rc != 0:
        raise AssertionError(f"{probe.__name__}.main returned {rc}")
    if any(counts[k] for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7")):
        raise AssertionError(f"{probe.__name__} launched a render kernel")
    return counts, lines


def inverse_phases(dev, smi: str) -> dict:
    """Phases 44-47, the inverse-rendering slice: the silhouette term, the
    ``--geometry`` trainer at full width, the differentiable step on boxes,
    media and an image, and bit-exact resume. Returns the numbers the
    kernels line carries."""
    import numpy as np
    import torch

    from pathtrace_tpu_torch import cli
    from pathtrace_tpu_torch.camera import make_camera
    from pathtrace_tpu_torch.examples import inverse_render
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import intersect_kernel as k1
    from pathtrace_tpu_torch.ops import megakernel as k7
    from pathtrace_tpu_torch.ops import shade_kernel as k2
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_port_util import (
        SIL_KEY_SEED, SIL_WHOLE_TOL, sil_grad_img, silhouette_cases,
    )

    # ---- 44: the silhouette boundary term on the card ----
    from pathtrace_tpu_torch.models import build as tbuild
    from pathtrace_tpu_torch.ops import silhouette as sil

    sil_ref = np.load(SIL_FIXTURE)
    sil_runs, sil_k1, sil_k3 = {}, 0, 0
    for sname, (sc_, scam, sw, sh, sd, sm) in silhouette_cases(
            tbuild, make_camera).items():
        g_img = torch.from_numpy(sil_grad_img(sname, sh, sw))
        on_cpu = sil.silhouette_grads_all(sc_, scam, sw, sh, g_img,
                                          PRNGKey(SIL_KEY_SEED),
                                          max_depth=sd, n_samples=sm)
        sc_d, cam_d = sc_.to(dev), scam.to(dev)
        reset_counts(k1, k2, k7)
        t_start = time.monotonic()
        on_card = sil.silhouette_grads_all(sc_d, cam_d, sw, sh, g_img.to(dev),
                                           PRNGKey(SIL_KEY_SEED),
                                           max_depth=sd, n_samples=sm)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t_start) * 1e3
        c44 = read_counts(k1, k2, k7)
        names_ = sorted(str(n) for n in sil_ref[f"{sname}.names"])
        err_cpu = {n: rel_l2(on_card[n].cpu(), on_cpu[n]) for n in names_}
        err_jax = {n: rel_l2(on_card[n].cpu(), torch.from_numpy(
            sil_ref[f"{sname}.grad.{n}"])) for n in names_}
        feats_ = SceneFeatures.from_scene(sc_)
        sweep = ("K3" if feats_.has_motion else "K1") if feats_.has_spheres \
            else None
        phase(f"[44] silhouette {sname} ({sw}x{sh}, depth {sd}, {sm} "
              f"samples): card vs CPU port rel L2 "
              + ", ".join(f"{n} {e:.2e}" for n, e in err_cpu.items())
              + "; vs JAX " + ", ".join(f"{n} {e:.2e}" for n, e in
                                       err_jax.items())
              + f" (<= {SIL_WHOLE_TOL}); wall {wall_ms:.1f} ms; launches "
              f"{c44}")
        if (sorted(on_card) != names_ or c44["plain"]
                or any(not np.isfinite(on_card[n].cpu().numpy()).all()
                       for n in names_)
                or max(err_cpu.values()) > SIL_WHOLE_TOL
                or max(err_jax.values()) > SIL_WHOLE_TOL
                or (sweep is not None and c44[sweep] <= 0)):
            raise AssertionError(f"silhouette {sname}: failed its checks")
        sil_k1 += c44["K1"]
        sil_k3 += c44["K3"]
        sil_runs[sname] = {"rel_l2_cpu": err_cpu, "rel_l2_jax": err_jax,
                           "wall_ms": wall_ms, "launches": c44}
        del sc_d, cam_d

    # ---- 45: the --geometry trainer at full width: random_spheres,
    # every default leaf, the silhouette term (128 samples), 3 Adam steps
    from pathtrace_tpu_torch.parallel.inverse import make_inverse_renderer

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def perturb(state_, names_):
        with torch.no_grad():
            for i, n in enumerate(names_):
                if n == "spheres.center":
                    state_.params[i][:, 0] += 0.05
                if n == "textures.color":
                    state_.params[i].copy_(
                        (state_.params[i] + 0.2).clamp(0.0, 1.0))

    g_scene, g_cam = presets.random_spheres(WIDTH / HEIGHT)
    grend, gst, gnames = make_inverse_renderer(
        g_scene, g_cam, WIDTH, HEIGHT, samples=SAMPLES, max_depth=TRAIN_DEPTH,
        device=dev, silhouette=True, silhouette_samples=SIL_SAMPLES)
    gkey = PRNGKey(0)
    with torch.no_grad():
        gtarget = grend.render(gst.params, gkey)
    perturb(gst, gnames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(k1, k2, k7)
    geo_ms, geo_losses = [], []
    for _ in range(GEO_STEPS):
        e0, e1 = events()
        e0.record()
        gst, gloss = grend.train_step(gst, gtarget, gkey)
        e1.record()
        e1.synchronize()
        geo_ms.append(e0.elapsed_time(e1))
        geo_losses.append(float(gloss))
    c45 = read_counts(k1, k2, k7)
    geo_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # the silhouette term alone, at the last step's parameters
    with torch.no_grad():
        gimg = grend.render(gst.params, gkey)
    torch.cuda.synchronize()
    reset_counts(k1, k2, k7)
    e0, e1 = events()
    e0.record()
    gterms = grend.silhouette_terms(gst.params, gtarget, gkey, gimg)
    e1.record()
    e1.synchronize()
    sil_ms = e0.elapsed_time(e1)
    c45s = read_counts(k1, k2, k7)
    step_med = float(np.median(geo_ms))
    phase(f"[45] --geometry trainer, random_spheres {WIDTH}x{HEIGHT}x"
          f"{SAMPLES} depth {TRAIN_DEPTH}, leaves {gnames}, silhouette "
          f"{SIL_SAMPLES} samples: ms per step "
          + ", ".join(f"{ms:.2f}" for ms in geo_ms)
          + f" (CUDA events), losses {[round(x, 8) for x in geo_losses]}; "
          f"the silhouette term {sil_ms:.2f} ms ({sil_ms / step_med:.1%} of "
          f"the median step; launches {c45s}); peak memory {geo_peak:.3f} "
          f"GiB; launches {c45} ({smi})")
    if (not np.isfinite(geo_losses).all() or c45["K1"] <= 0
            or c45["K6"] <= 0 or c45["plain"] or c45s["K1"] <= 0
            or c45s["plain"] or set(gterms) != {"spheres.center",
                                                 "spheres.radius"}
            or not all(torch.isfinite(v).all() for v in gterms.values())):
        raise AssertionError("the --geometry trainer failed its checks")
    geo_run = {"step_ms": geo_ms, "losses": geo_losses,
               "silhouette_ms": sil_ms, "silhouette_share": sil_ms / step_med,
               "peak_gib": geo_peak, "launches": c45,
               "silhouette_launches": c45s}
    del grend, gst, gtarget, gimg, gterms

    # the example's --geometry run on `small` (its defaults: 32x32, 4 spp,
    # depth 3), whose loss must fall
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(k1, k2, k7)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = inverse_render.main(["--geometry", "--steps", "10",
                                      "--device", "cuda", "--out",
                                      os.path.join(tmp, "geo.npy")])
        c45e = read_counts(k1, k2, k7)
    ex_losses = [float(x) for x in re.findall(r"loss ([\d.e+-]+), ",
                                              buf.getvalue())]
    phase(f"[45] inverse_render --geometry (small): rc {rc}, losses "
          f"{ex_losses}; launches {c45e}")
    if (rc != 0 or len(ex_losses) != 10 or not ex_losses[-1] < ex_losses[0]
            or c45e["K1"] <= 0 or c45e["K6"] <= 0 or c45e["plain"]):
        raise AssertionError("the example's --geometry run failed its checks")

    # ---- 46: one full-width differentiable step each on boxes, media and
    # an image (the default leaves; the colours +0.2 against the scene's
    # own render); a step that does not fit runs at half the width
    diff_runs = {}
    for dname in ("cornell", "cornell_smoke", "earth"):
        d_scene, d_cam = presets.from_name(dname, WIDTH / HEIGHT)
        dw, dh = WIDTH, HEIGHT
        while True:
            try:
                drend, dst, dnames = make_inverse_renderer(
                    d_scene, d_cam, dw, dh, samples=SAMPLES,
                    max_depth=TRAIN_DEPTH, device=dev)
                with torch.no_grad():
                    dtarget = drend.render(dst.params, PRNGKey(0))
                perturb(dst, dnames)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                reset_counts(k1, k2, k7)
                e0, e1 = events()
                e0.record()
                dst, dloss = drend.train_step(dst, dtarget, PRNGKey(0))
                e1.record()
                e1.synchronize()
                break
            except torch.cuda.OutOfMemoryError:
                drend = dst = dtarget = None
                torch.cuda.empty_cache()
                phase(f"[46] {dname}: a {dw}x{dh}x{SAMPLES} step does not "
                      f"fit in the card's memory; halving the film")
                dw, dh = dw // 2, dh // 2
        c46 = read_counts(k1, k2, k7)
        dpeak = torch.cuda.max_memory_allocated(dev) / 2**30
        dms = e0.elapsed_time(e1)
        finite = (np.isfinite(float(dloss))
                  and all(torch.isfinite(p.grad).all() for p in dst.params))
        phase(f"[46] {dname} differentiable step at {dw}x{dh}x{SAMPLES} "
              f"depth {TRAIN_DEPTH} (fast path {drend.use_fast_path}): loss "
              f"{float(dloss):.8f}, {dms:.2f} ms (CUDA events), peak memory "
              f"{dpeak:.3f} GiB; launches {c46} ({smi})")
        has_sph = SceneFeatures.from_scene(d_scene).has_spheres
        if (not finite or not drend.use_fast_path or c46["plain"]
                or (has_sph and (c46["K1"] <= 0 or c46["K6"] <= 0))):
            raise AssertionError(f"{dname}: the differentiable step failed")
        diff_runs[dname] = {"width": dw, "height": dh, "ms": dms,
                            "peak_gib": dpeak, "launches": c46}
        del drend, dst, dtarget
        torch.cuda.empty_cache()

    # ---- 47: bit-exact resume on the card: the CLI's -F 4 against -F 2
    # --checkpoint twice, and the example's 5 steps against 2 steps, a
    # checkpoint, then 3 more (the colours, as the reference's resume test)
    with tempfile.TemporaryDirectory() as tmp:
        cli_args = ["-P", "random_spheres", "-W", "640", "-H", "360", "-S",
                    "4", "-D", "10", "--device", "cuda"]
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rcs = [cli.main(cli_args + ["-F", "4", "--out",
                                        os.path.join(tmp, "full.npy")])]
            for _ in range(2):
                rcs.append(cli.main(cli_args + [
                    "-F", "2", "--checkpoint", os.path.join(tmp, "c.npz"),
                    "--out", os.path.join(tmp, "part.npy")]))
        full = np.load(os.path.join(tmp, "full.npy"))
        part = np.load(os.path.join(tmp, "part.npy"))
        cli_equal = bool(np.array_equal(full, part))
        resumed = "resumed from" in buf.getvalue()
        ex = ["--steps", "5", "--device", "cuda"]
        reset_counts(k1, k2, k7)
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rcs.append(inverse_render.main(ex + [
                "--checkpoint", os.path.join(tmp, "a.npz"), "--out",
                os.path.join(tmp, "a.npy")]))
            rcs.append(inverse_render.main(
                ["--steps", "2", "--device", "cuda", "--checkpoint",
                 os.path.join(tmp, "b.npz"), "--out",
                 os.path.join(tmp, "b.npy")]))
            rcs.append(inverse_render.main(ex + [
                "--checkpoint", os.path.join(tmp, "b.npz"), "--out",
                os.path.join(tmp, "b.npy")]))
        c47 = read_counts(k1, k2, k7)
        train_resumed = "resumed from" in buf.getvalue()
        with np.load(os.path.join(tmp, "a.npz")) as za, \
                np.load(os.path.join(tmp, "b.npz")) as zb:
            ck_equal = (za.files == zb.files and all(
                np.array_equal(za[k], zb[k]) for k in za.files))
        img_equal = bool(np.array_equal(np.load(os.path.join(tmp, "a.npy")),
                                        np.load(os.path.join(tmp, "b.npy"))))
        # K6's per-sphere atomics: two identical --geometry runs under
        # the deterministic algorithms (a new checkpoint each), compared
        with contextlib.redirect_stdout(io.StringIO()):
            for tag_ in ("g1", "g2"):
                rcs.append(inverse_render.main(
                    ["--geometry", "--steps", "3", "--device", "cuda",
                     "--checkpoint", os.path.join(tmp, f"{tag_}.npz"),
                     "--out", os.path.join(tmp, f"{tag_}.npy")]))
        geo_repeat = bool(np.array_equal(np.load(os.path.join(tmp, "g1.npy")),
                                         np.load(os.path.join(tmp, "g2.npy"))))
    phase(f"[47] resume on the card: CLI -F 4 == -F 2 --checkpoint x2 "
          f"(random_spheres 640x360x4 depth 10): {cli_equal} (resumed "
          f"{resumed}); example 5 steps == 2 + checkpoint + 3: checkpoint "
          f"leaves {ck_equal}, images {img_equal} (resumed {train_resumed}); "
          f"launches {c47}; two --geometry runs of 3 steps bit-equal: "
          f"{geo_repeat} (K6 sums per sphere with atomics; not required); "
          f"return codes {rcs}")
    if (any(rcs) or not (cli_equal and resumed and ck_equal and img_equal
                         and train_resumed) or c47["plain"]):
        raise AssertionError("resume on the card is not bit-exact")

    return {"sil_k1": sil_k1, "sil_k3": sil_k3, "c45": c45, "c45s": c45s,
            "geo_run": geo_run, "diff_runs": diff_runs, "sil_runs": sil_runs}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    from pathtrace_tpu_torch import cli
    from pathtrace_tpu_torch.examples import inverse_render
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.convert import scene_from_numpy
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import _cuda_build
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.ops import intersect_kernel as k1
    from pathtrace_tpu_torch.ops import megakernel as k7
    from pathtrace_tpu_torch.ops import shade_kernel as k2
    from pathtrace_tpu_torch.ops.intersect_box import box_nearest, media_nearest
    from pathtrace_tpu_torch.ops.intersect_rect import rect_nearest
    from pathtrace_tpu_torch.ops.lights import build_light_table
    from pathtrace_tpu_torch.tools import _probe
    from pathtrace_tpu_torch.tools import bf16_probe as p1
    from pathtrace_tpu_torch.tools import nearest_bench as nb
    from pathtrace_tpu_torch.tools import split_probe as p24
    from pathtrace_tpu_torch.tools.profile_step import device_launches
    from pathtrace_tpu_torch.parallel.inverse import split_scene
    from pathtrace_tpu_torch.camera import make_camera
    from pathtrace_tpu_torch.config import Params
    from pathtrace_tpu_torch.models.build import SceneBuilder
    from pathtrace_tpu_torch.render import integrator as gint
    from pathtrace_tpu_torch.render.frame import (
        generate_primary_rays,
        render_frame,
    )
    from pathtrace_tpu_torch.render.progressive import render_progressive
    from pathtrace_tpu_torch.utils import threefry as tf
    from pathtrace_tpu_torch.utils.threefry import PRNGKey, fold_in

    # the tests' helpers, by path: a ``tests`` package installed elsewhere
    # would shadow the repository's directory
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_port_util import (
        DEPTH10_BUDGET, FIXTURE_GRAD_TOL, MOTION_FIXTURE_GRAD_TOL,
        SMALLPT_DEPTH10_BUDGET, XL_DEPTH10_BUDGET, check_slice_contract,
        check_smallpt_contract, port_bounce_chain, states_outside, white_sky,
    )

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    phase(f"[1] device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    phase(f"[1] nvidia-smi: {smi}")

    info = _cuda_build.build()
    # a library built earlier from the same sources keeps its log beside it
    build_log = info.log or (info.path.parent / "build.log").read_text()
    ptxas = [ln.strip() for ln in build_log.splitlines()
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
    ro, rd, tm = generate_primary_rays(camera, WIDTH, HEIGHT, SAMPLES,
                                       PRNGKey(0), device=dev)
    R = WIDTH * HEIGHT * SAMPLES
    st0 = fp.make_state(ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R))

    def nearest_check(tag, name, soa, st, label, moving=False):
        """K1 (K3 when ``moving``) against its plain version on one state's
        rays: t and idx must be equal. Returns (t, idx, max |dt|)."""
        rays = st.planes[:6]
        if moving:
            t, idx = k1.sphere_nearest_moving(soa, rays, st.time)
        else:
            t, idx = k1.sphere_nearest(soa, rays)
        t_p, idx_p = k1.sphere_nearest_plain(soa, rays,
                                             time=st.time if moving else None)
        torch.cuda.synchronize()
        hit = t < 1e30
        err = (t[hit] - t_p[hit]).abs().max().item() if hit.any() else 0.0
        same = torch.equal(t, t_p) and torch.equal(idx, idx_p)
        phase(f"[{tag}] {name} {label}: {R} rays, hit "
              f"{hit.float().mean().item():.4f}, t and idx equal to plain: "
              f"{same}, max |dt| {err}")
        if not same:
            raise AssertionError(f"{name} differs from its plain version ({label})")
        return t, idx, err

    def scattered(tables_, flags_, st, t_, idx_):
        """The state after one bounce through K2 from the winners (t_, idx_)."""
        planes, alive = k2.shade_from_winners(
            tables_.table, idx_, t_, st.planes, st.time, st.alive, st.lane, 7,
            0, DEPTH, tables_.sky4, flags_, atlas=tables_.atlas)
        return fp.FastStateP(planes[:12], st.time, alive, st.lane)

    t0_, idx0, err_a = nearest_check("3", "K1", tables.soa, st0, "primary")
    st1 = scattered(tables, flags, st0, t0_, idx0)
    t1_, idx1, err_b = nearest_check("3", "K1", tables.soa, st1, "scattered")
    k1_ms = time_ms(lambda: k1.sphere_nearest(tables.soa, st0.planes[:6]), 20)
    k1_ms_scattered = time_ms(
        lambda: k1.sphere_nearest(tables.soa, st1.planes[:6]), 20)
    k1_plain_ms = time_ms(
        lambda: k1.sphere_nearest_plain(tables.soa, st0.planes[:6]), 2)
    k1_ys = nb.yardsticks(tables.soa, R)
    k1_bound = (k1_ys["bound_ms"], k1_ys["bound_by"])
    k1_ceiling = k1_ys["issue_ceiling_ms"]
    k1_regs = kernel_registers(build_log, "sphere_nearest_kernelILb0E")
    phase(f"[3] K1 time at {R} rays x {tables.soa.shape[1]} spheres: kernel "
          f"{k1_ms:.3f} ms (primary), {k1_ms_scattered:.3f} ms (scattered), "
          f"plain {k1_plain_ms:.3f} ms")
    for label, ms in (("primary", k1_ms), ("scattered", k1_ms_scattered)):
        phase(f"[3] K1 {label}: {k1_bound[0] / ms:.1%} of the bound "
              f"{k1_bound[0]:.4f} ms ({k1_bound[1]}), {k1_ceiling / ms:.1%} "
              f"of the -fmad=false issue ceiling {k1_ceiling:.4f} ms")
    phase(f"[3] K1 registers and spills (ptxas, per rays a thread): {k1_regs}")

    # ---- 4: K2 on the same winners ----
    def shade_check(tag, name, tables_, flags_, cases):
        """K2 against its plain version on each (label, state, t, idx,
        depth) case, under the lane contract, then both timed on the
        first case, with that case's yardsticks
        (``tools/nearest_bench.k2_yardsticks``: the bound, the issue
        ceiling, the noise lanes' share and occupancy). Returns the run:
        max |diff|, worst share outside, ms, plain ms and the
        yardsticks."""
        worst_err, worst_out = 0.0, 0.0
        kw = {"atlas": tables_.atlas}
        for label, st, t_, idx_, depth in cases:
            args = (tables_.table, idx_, t_, st.planes, st.time, st.alive,
                    st.lane, 7, depth, DEPTH, tables_.sky4, flags_)
            out, alive = k2.shade_from_winners(*args, **kw)
            out_p, alive_p = k2.shade_from_winners_plain(*args, **kw)
            frac = max(outside_fraction(out[k], out_p[k])
                       for k in range(out.shape[0]))
            agree = (alive == alive_p).float().mean().item()
            err = (out - out_p).abs().max().item()
            phase(f"[{tag}] {name} {label}: worst plane "
                  f"{round(frac * out.shape[1])} lanes ({frac:.6f}) outside "
                  f"1e-3, alive agreement {agree:.6f}, max |diff| {err}")
            if frac > 0.005 or agree < 0.995:
                raise AssertionError(f"{name} outside the lane contract ({label})")
            worst_err, worst_out = max(worst_err, err), max(worst_out, frac)
        _, st, t_, idx_, depth = cases[0]
        args = (tables_.table, idx_, t_, st.planes, st.time, st.alive,
                st.lane, 7, depth, DEPTH, tables_.sky4, flags_)
        ms = time_ms(lambda: k2.shade_from_winners(*args, **kw), 20)
        plain_ms = time_ms(lambda: k2.shade_from_winners_plain(*args, **kw),
                           3)
        ys = nb.k2_yardsticks(tables_.table, flags_, idx_, t_, tables_.atlas)
        occ = ys["noise_occupancy"]
        phase(f"[{tag}] {name} time at {R} lanes: kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {ys['bound_ms']:.4f} ms "
              f"({ys['bound_by']}, {ys['bound_ms'] / ms:.1%}), issue ceiling "
              f"{ys['issue_ceiling_ms']:.4f} ms "
              f"({ys['issue_ceiling_ms'] / ms:.1%}); noise lanes "
              f"{ys['noise_lanes']} ({ys['noise_lane_share']:.4f}), "
              f"occupancy {'-' if occ is None else f'{occ:.4f}'}")
        return {"max_abs_err": worst_err, "lanes_outside": worst_out,
                "ms": ms, "plain_ms": plain_ms, **ys}

    k2_run = shade_check(
        "4", "K2", tables, flags, (("primary", st0, t0_, idx0, 0),
                                   ("scattered", st1, t1_, idx1, 1)))
    def winners_of(cases):
        """K6's inputs per state: [R, 3] rays, time and the (t, idx)."""
        return [(st.planes[0:3].T.contiguous(), st.planes[3:6].T.contiguous(),
                 st.time, t_, idx_) for st, t_, idx_ in cases]

    winners = winners_of(((st0, t0_, idx0), (st1, t1_, idx1)))
    del st0, st1

    # ---- 5: against the committed JAX reference ----
    def fixture_trace(tag, name, scene_, ref, budget, kernel):
        """The CUDA trace of a fixture's rays against JAX's radiance: at
        most ``budget`` of the rays outside 1e-3, the segment counts
        within max_depth per ray outside, ``kernel`` launched at every
        bounce and no other closest hit or plain version."""
        depth = int(ref["max_depth"])
        reset_counts(k1, k2, k7)
        res = fp.trace_fast(scene_, *(torch.from_numpy(ref[k]).to(dev) for k in
                                      ("rays.ro", "rays.rd", "rays.time")),
                            int(ref["seed"]), depth,
                            SceneFeatures.from_scene(scene_), min_size=128)
        counts = read_counts(k1, k2, k7)
        n_out, frac = rays_outside(res.radiance, ref["radiance"])
        count, ref_count = int(res.ray_count), int(ref["ray_count"])
        phase(f"[{tag}] {name}: {len(res.radiance)} rays depth {depth}, "
              f"{frac:.4%} of rays outside 1e-3 (budget {budget:.0%}), segments "
              f"{count} vs JAX {ref_count}; launches {counts}")
        others = [counts[k] for k in ("K1", "K3", "K4", "K5") if k != kernel]
        if (frac > budget or counts[kernel] != depth + 1 or any(others)
                or counts["plain"] or abs(count - ref_count) > n_out * depth):
            raise AssertionError(f"{name}: trace outside the slice contract")

    ref = np.load(FIXTURE)
    fixture_trace("5", "fixture", scene_from_numpy(ref, device=dev), ref,
                  DEPTH10_BUDGET, "K1")

    # ---- 6: the main path through the CLI ----
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "random_spheres.npy")
        argv = ["-P", "random_spheres", "-W", str(WIDTH), "-H", str(HEIGHT),
                "-S", str(SAMPLES), "-D", str(DEPTH), "-O", "-F", str(FRAMES),
                "--out", out_path]
        reset_counts(k1, k2, k7)
        buf = io.StringIO()
        t_start = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        wall = time.monotonic() - t_start
        c6 = read_counts(k1, k2, k7)
        launches = (c6["K1"], c6["K2"])
        log = buf.getvalue()
        for ln in log.splitlines():
            phase(f"[6] cli: {ln}")
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        image = np.load(out_path)
    frames = [(float(ms), int(rays), int(rb)) for ms, rays, rb in re.findall(
        r"frame \d+/\d+: ([\d.]+) ms, (\d+) rays, [\d.]+ Mrays/s, (\d+) readbacks",
        log)]
    phase(f"[6] launches {c6}; wall {wall:.2f} s")
    if min(launches) <= 0 or c6["plain"] != 0:
        raise AssertionError("the main path did not run through both kernels")
    if c6["K4"] or c6["K5"]:
        raise AssertionError("random_spheres (4 tiles) took a culled kernel")
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

    # ---- 7: K6 against its plain version on phase 3's winners ----
    def k6_check(tag, name, sp_, winners_, seed, moving=False):
        """K6 (with motion when ``moving``) against its plain version on
        each winners set: per-ray gradients within ``K6_MAX_ULP``, every
        per-sphere sum non-zero and within ``K6_SPHERE_RTOL``; then both
        timed on the first set. Returns (max |diff|, max ULP, worst rel
        L2, ms, plain ms)."""
        gen_ = torch.Generator(device=dev)
        gen_.manual_seed(seed)
        per_ray = (2, 3, 7) if moving else (2, 3)
        per_sphere = (0, 1, 4, 5, 6) if moving else (0, 1)
        worst = (0.0, 0, 0.0)
        for label, (ro_, rd_, tm_, t_, idx_) in zip(("primary", "scattered"),
                                                    winners_):
            g_t = torch.rand(R, generator=gen_, device=dev) + 0.5
            args = (sp_.center, sp_.radius, ro_, rd_, t_, idx_, g_t)
            motion = ((sp_.center_delta, sp_.time0, sp_.inv_time_delta, tm_)
                      if moving else None)
            got = k1.sphere_nearest_bwd(*args, motion=motion)
            ref_ = k1.sphere_nearest_bwd_plain(*args, motion=motion)
            torch.cuda.synchronize()
            ulp = max(ulp_distance(got[k], ref_[k]) for k in per_ray)
            n_diff = sum(int((got[k] != ref_[k]).sum()) for k in per_ray)
            err = max(float((got[k] - ref_[k]).abs().max()) for k in per_ray)
            sph = [rel_l2(got[k], ref_[k]) for k in per_sphere]
            n_vals = sum(got[k].numel() for k in per_ray)
            phase(f"[{tag}] {name} {label}: per-ray gradients {n_diff} of "
                  f"{n_vals} values differ "
                  f"from plain (max {ulp} ULP, max |diff| {err}); per-sphere "
                  "sums rel L2 " + ", ".join(f"{e:.3e}" for e in sph))
            if not all(bool(torch.isfinite(x).all()) for x in got):
                raise AssertionError(f"{name} gave non-finite gradients ({label})")
            if any(float(got[k].abs().max()) == 0.0 for k in per_sphere):
                raise AssertionError(f"{name} left a leaf without gradient ({label})")
            if ulp > K6_MAX_ULP or max(sph) > K6_SPHERE_RTOL:
                raise AssertionError(f"{name} differs from its plain version ({label})")
            worst = (max(worst[0], err), max(worst[1], ulp), max(worst[2], *sph))
        ro_, rd_, tm_, t_, idx_ = winners_[0]
        args = (sp_.center, sp_.radius, ro_, rd_, t_, idx_, g_t)
        motion = ((sp_.center_delta, sp_.time0, sp_.inv_time_delta, tm_)
                  if moving else None)
        ms = time_ms(lambda: k1.sphere_nearest_bwd(*args, motion=motion), 20)
        plain_ms = time_ms(
            lambda: k1.sphere_nearest_bwd_plain(*args, motion=motion), 3)
        return (*worst, ms, plain_ms)

    sp = scene.spheres
    k6_err, k6_ulp, k6_sph, k6_ms, k6_plain_ms = k6_check("7", "K6", sp,
                                                          winners, 1)
    # K6: per ray ro, rd, t, idx, g_t in (36 B) and g_ro, g_rd out (24 B),
    # the sphere leaves in and their gradients out once; ~60 operations
    k6_ys = nb.k6_yardsticks(R, sp.radius.shape[0], False)
    k6_bound = (k6_ys["bound_ms"], k6_ys["bound_by"])
    k6_launch = k1.bwd_launch(R, sp.radius.shape[0], False)
    phase(f"[7] K6 time at {R} rays: kernel {k6_ms:.3f} ms, plain "
          f"{k6_plain_ms:.3f} ms, bound {k6_bound[0]:.4f} ms ({k6_bound[1]}, "
          f"{k6_bound[0] / k6_ms:.1%} of it); {k6_launch[0]} blocks, sums in "
          f"{'shared' if k6_launch[1] else 'device'} memory; registers "
          f"{kernel_registers(build_log, 'sphere_nearest_bwd_kernelI')}")
    del winners

    # ---- 8: the CUDA trace's gradients against the JAX fixture ----
    def grad_fixture(tag, name, scene_, gref, tol, kernel):
        """The CUDA ``trace_fast_diff`` of a gradient fixture's rays:
        radiance under the lane contract, per-leaf gradients within
        ``tol`` of JAX's, ``kernel`` and K6 launched, no plain version."""
        gparams, rebuild, names = split_scene(scene_.to(dev))
        if names != list(gref["names"]):
            raise AssertionError(f"trainable leaves {names}")
        reset_counts(k1, k2, k7)
        rad, _ = fp.trace_fast_diff(
            rebuild(gparams), *(torch.from_numpy(gref[k]).to(dev)
                                for k in ("rays.ro", "rays.rd", "rays.time")),
            int(gref["seed"]), int(gref["max_depth"]),
            SceneFeatures.from_scene(scene_))
        frac = outside_fraction(rad.detach().cpu(),
                                torch.from_numpy(gref["radiance"]))
        grads = torch.autograd.grad(
            (torch.from_numpy(gref["w"]).to(dev) * rad).sum(), gparams)
        counts = read_counts(k1, k2, k7)
        errs = {n: rel_l2(g.cpu(), torch.from_numpy(gref[f"grad.{n}"]))
                for n, g in zip(names, grads)}
        phase(f"[{tag}] {name}: {rad.shape[0]} rays depth "
              f"{int(gref['max_depth'])}, {frac:.4%} of values outside 1e-3; "
              f"launches {counts}; per-leaf rel L2 vs JAX: "
              + ", ".join(f"{n} {e:.3e} (<= {tol[n]})" for n, e in errs.items()))
        if (frac > 0.005 or counts[kernel] <= 0 or counts["K6"] <= 0
                or counts["plain"] or any(errs[n] > tol[n] for n in names)):
            raise AssertionError(f"{name}: trace gradients outside the contract")

    grad_fixture("8", "gradient fixture", presets.random_spheres(WIDTH / HEIGHT)[0],
                 np.load(GRAD_FIXTURE), FIXTURE_GRAD_TOL, "K1")

    # ---- 9: the trainer through its entry point, twice: every
    # default-trainable leaf (the full configuration), then the example's
    # own problem (the perturbed texture colours), whose loss must fall.
    # With geometry leaves the loss need not fall: their gradients are
    # interior-only (no silhouette term), and Adam moves every centre and
    # radius by about the learning rate from the first step; the
    # reference's trainer does the same (tests/test_torch_grad.py
    # test_train_steps_track_jax holds the port's losses to its, step by
    # step, with every default leaf and with the colours alone).
    def train_run(tag, preset, trainable, every_leaf=False):
        """``inverse_render.main`` at the smoke's film, depth 4, 5 steps:
        (launch counts, losses, the largest change per leaf). The
        parameters must move (``every_leaf``: each trainable leaf)."""
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--preset", preset, "--width", str(WIDTH),
                    "--height", str(HEIGHT), "--samples", str(SAMPLES),
                    "--depth", str(TRAIN_DEPTH), "--steps", str(TRAIN_STEPS),
                    "--trainable", trainable, "--device", "cuda",
                    "--out", os.path.join(tmp, "inverse.npy")]
            reset_counts(k1, k2, k7)
            buf = io.StringIO()
            t_start = time.monotonic()
            with contextlib.redirect_stdout(buf):
                rc = inverse_render.main(argv)
            wall = time.monotonic() - t_start
            counts = read_counts(k1, k2, k7)
            log = buf.getvalue()
            for ln in log.splitlines():
                phase(f"[{tag}] inverse_render --preset {preset} --trainable "
                      f"{trainable}: {ln}")
            if rc != 0:
                raise AssertionError(f"inverse_render.main returned {rc}")
            side = np.load(os.path.join(tmp, "inverse.npy"))
        steps = [(float(loss), float(ms)) for loss, ms in re.findall(
            r"step \d+/\d+: loss ([\d.e+-]+|nan|inf), ([\d.]+) ms", log)]
        moved = {n: float(m) for n, m in re.findall(
            r"(\S+) ([\d.]+)(?:,|$)",
            log.split("largest parameter change:")[1].splitlines()[0])}
        peak = float(re.search(r"peak device memory: ([\d.]+) GiB",
                               log).group(1))
        losses = [loss for loss, _ in steps]
        phase(f"[{tag}] {preset} --trainable {trainable}: launches {counts}; "
              f"loss {losses[0]:.8f} -> {losses[-1]:.8f}; ms per step "
              + ", ".join(f"{ms:.2f}" for _, ms in steps)
              + f" (CUDA events); peak memory {peak:.3f} GiB; wall {wall:.2f} s")
        if len(steps) != TRAIN_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"bad step lines: {steps}")
        if not moved or (min if every_leaf else max)(moved.values()) <= 0.0:
            raise AssertionError(f"a trainable leaf did not move: {moved}")
        if counts["K6"] <= 0 or counts["plain"] != 0:
            raise AssertionError("the trainer did not run through the kernels")
        if not (np.isfinite(side).all()
                and side.shape == (HEIGHT, 2 * WIDTH, 3)):
            raise AssertionError(f"bad target|optimized image {side.shape}")
        return counts, losses, moved

    runs = {}
    for trainable in ("default", "color"):
        c9, losses, _ = train_run("9", "random_spheres", trainable)
        if c9["K1"] <= 0:
            raise AssertionError("the trainer did not run through K1")
        runs[trainable] = ((c9["K1"], c9["K6"]), losses)
    if not runs["color"][1][-1] < runs["color"][1][0]:
        raise AssertionError(f"loss did not fall: {runs['color'][1]}")
    train_launches = runs["default"][0]

    # ---- 10-11: K4 on the 13-tile cover scene, K5 on random_spheres_xl ----
    def cull_check(tag, label, tables_c, rays):
        """K4/K5 on one ray set: kernel == plain (t, idx, sweeps) at the
        kernel's unit (32 x the rays a thread its launcher picks for this
        width) and == K1's kernel (t, idx). Returns (t, idx, max |dt|,
        skipped share, plain counts, rays a thread)."""
        W = rays.shape[1]
        hier = tables_c.cull.supers is not None
        k_rays = k1.culled_kernel_rays(W, hier)
        mirror = k1.culled_rays_per_thread(W, hier, n_sm)
        if k_rays != mirror:
            raise AssertionError(f"[{tag}] the launcher picks {k_rays} rays a "
                                 f"thread at {W} rays, its Python mirror "
                                 f"{mirror}")
        t, idx, sweeps = k1.sphere_nearest_culled(tables_c.soa, rays,
                                                  tables_c.cull,
                                                  count_sweeps=True)
        plain = k1.sphere_nearest_culled_plain(tables_c.soa, rays,
                                               tables_c.cull, k_rays=k_rays)
        t_1, idx_1 = k1.sphere_nearest(tables_c.soa, rays)
        torch.cuda.synchronize()
        hit = t < 1e30
        err = (t[hit] - plain.t[hit]).abs().max().item() if hit.any() else 0.0
        same_p = torch.equal(t, plain.t) and torch.equal(idx, plain.idx)
        same_1 = torch.equal(t, t_1) and torch.equal(idx, idx_1)
        units = -(-W // (32 * k_rays)) * tables_c.cull.tiles.shape[1]
        skipped = 1.0 - int(sweeps) / units
        live = int((tables_c.soa[4] > 0).sum())
        phase(f"[{tag}] {label}: {W} rays, hit {hit.float().mean().item():.4f}; "
              f"t and idx equal to plain: {same_p}, to K1: {same_1}; "
              f"{k_rays} rays a thread; sweeps {int(sweeps)} (plain "
              f"{int(plain.sweeps)}) of {units} (warp, tile) pairs, "
              f"{skipped:.4%} skipped; {int(plain.slots)} (ray, live slot) "
              f"pairs swept ({int(plain.slots) / (W * live):.4%} of all); "
              f"{int(plain.tests)} ray-box tests")
        if not (same_p and same_1 and int(sweeps) == int(plain.sweeps)):
            raise AssertionError(f"culled kernel differs ({tag} {label})")
        return t, idx, err, skipped, plain, k_rays

    def cull_phase(tag, name, scene_c, camera_c, hier):
        feats_c = SceneFeatures.from_scene(scene_c)
        tables_c = fp.prep_tables(scene_c, feats_c, cull=True)
        if (tables_c.cull.supers is not None) != hier:
            raise AssertionError(f"{name}: expected hier={hier}")
        n_tiles = tables_c.cull.tiles.shape[1]
        phase(f"[{tag}] {name}: {int(scene_c.spheres.mask.sum())} spheres in "
              f"{tables_c.soa.shape[1]} slots, {n_tiles} tiles"
              + (f" in supertiles of {tables_c.cull.s_tiles}" if hier else ""))
        ro_, rd_, tm_ = generate_primary_rays(camera_c, WIDTH, HEIGHT, SAMPLES,
                                              PRNGKey(0), device=dev)
        order, _ = fp._tile_perm(HEIGHT, WIDTH, dev)
        st = fp.make_state(*fp.permute_rays(ro_.reshape(R, 3), rd_.reshape(R, 3),
                                            tm_.reshape(R), order, SAMPLES))
        rays = st.planes[:6]
        t_, idx_, err0, skip0, plain0, kr0 = cull_check(
            tag, "primary, tile order", tables_c, rays)
        planes_, alive_ = k2.shade_from_winners(
            tables_c.table, idx_, t_, st.planes, st.time, st.alive, st.lane, 7,
            0, DEPTH, tables_c.sky4, fp.feature_flags(feats_c))
        rays1 = planes_[:6].contiguous()
        _, _, err1, skip1, plain1, _ = cull_check(tag, "scattered", tables_c,
                                                  rays1)
        # a late rung's width of the compaction ladder: the first
        # CULL_NARROW alive lanes of the scattered state, in lane order
        # (K4 takes its 1-ray instance there)
        alive_lanes = torch.nonzero(alive_).reshape(-1)
        if alive_lanes.numel() < CULL_NARROW:
            raise AssertionError(f"[{tag}] only {alive_lanes.numel()} rays alive")
        rays_n = rays1[:, alive_lanes[:CULL_NARROW]].contiguous()
        _, _, err2, _, plain2, kr2 = cull_check(
            tag, "scattered, compacted", tables_c, rays_n)
        instances = {kr0, kr2}
        if instances != ({1} if hier else {1, 2}):
            raise AssertionError(f"[{tag}] checked rays a thread {instances}, "
                                 "not every instance the path runs")
        ms = time_ms(lambda: k1.sphere_nearest_culled(tables_c.soa, rays,
                                                      tables_c.cull), 20)
        ms1 = time_ms(lambda: k1.sphere_nearest_culled(tables_c.soa, rays1,
                                                       tables_c.cull), 20)
        ms2 = time_ms(lambda: k1.sphere_nearest_culled(tables_c.soa, rays_n,
                                                       tables_c.cull), 20)
        k1_ms_ = time_ms(lambda: k1.sphere_nearest(tables_c.soa, rays), 5)
        plain_ms = time_ms(lambda: k1.sphere_nearest_culled_plain(
            tables_c.soa, rays, tables_c.cull), 1)
        # K1's 16 operations per (ray, live slot) pair of the tiles swept
        # and ~30 per ray-box test, counted at the fixed 32-ray warp; 24 B
        # in and 8 B out per ray, the operand and boxes once
        # (tools/nearest_bench.cull_yardsticks)
        sticks = nb.cull_yardsticks(tables_c.soa, tables_c.cull, rays)
        sticks1 = nb.cull_yardsticks(tables_c.soa, tables_c.cull, rays1)
        regs = kernel_registers(
            build_log, f"sphere_nearest_culled_kernelILb{int(hier)}E")
        phase(f"[{tag}] time: kernel {ms:.3f} ms on primary rays at {kr0} "
              f"rays a thread, {ms1:.3f} ms on scattered, {ms2:.3f} ms on "
              f"{CULL_NARROW} compacted scattered rays at {kr2}, K1 "
              f"{k1_ms_:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{sticks['bound_ms']:.4f} ms ({sticks['bound_by']}), issue "
              f"ceiling {sticks['issue_ceiling_ms']:.4f} ms "
              f"({sticks['issue_ceiling_ms'] / ms:.1%} of it), "
              f"{sticks['slots_swept']} pairs at the 32-ray warp, "
              f"{int(plain0.slots) - sticks['slots_swept']} more at the "
              f"kernel's unit; registers and spills (ptxas, per rays a "
              f"thread): {regs}")
        return {"max_abs_err": max(err0, err1, err2), "skipped_share": skip0,
                "skipped_share_scattered": skip1, "ms": ms,
                "ms_scattered": ms1, "ms_narrow": ms2,
                "narrow_rays": CULL_NARROW, "narrow_rays_per_thread": kr2,
                "k1_ms": k1_ms_, "plain_ms": plain_ms, **sticks,
                "slots_swept_extra": int(plain0.slots) - sticks["slots_swept"],
                "registers": regs, "rays_per_thread": kr0,
                "slots_swept_scattered": sticks1["slots_swept"],
                "slots_swept_extra_scattered": (int(plain1.slots)
                                                - sticks1["slots_swept"]),
                "issue_ceiling_ms_scattered": sticks1["issue_ceiling_ms"]}

    def render_counts(tag, scene_c, camera_c, frames):
        """Launch counts of ``render_progressive`` at the smoke's film."""
        from pathtrace_tpu_torch.config import Params
        from pathtrace_tpu_torch.render.progressive import render_progressive

        reset_counts(k1, k2, k7)
        res_ = render_progressive(
            scene_c, camera_c, Params(WIDTH, HEIGHT, SAMPLES, DEPTH), frames,
            dev, log=lambda ln: phase(f"[{tag}] {ln}"))
        if not (np.isfinite(res_.image).all() and 0.0 < res_.image.mean() <= 1.0):
            raise AssertionError(f"[{tag}] bad image")
        return read_counts(k1, k2, k7)

    cover20, cam20 = presets._random_impl(WIDTH / HEIGHT, True, 0, half_extent=20)
    cover20 = cover20.to(dev)
    k4 = cull_phase("10", "cover scene, half_extent 20 (K4)", cover20, cam20, False)
    # K4's path: frames of this scene through render_progressive
    c10 = render_counts("10", cover20, cam20, FRAMES)
    phase(f"[10] render_progressive: launches {c10}")
    if c10["K4"] <= 0 or c10["K1"] or c10["K5"] or c10["plain"]:
        raise AssertionError("the 13-tile frame did not run through K4 alone")
    k4["launches"] = c10["K4"]
    del cover20

    xl, cam_xl = presets.random_spheres_xl(WIDTH / HEIGHT)
    xl = xl.to(dev)
    k5 = cull_phase("11", "random_spheres_xl (K5)", xl, cam_xl, True)

    # ---- 12: the CUDA trace against the committed xl fixture ----
    fixture_trace("12", "xl fixture (tile-ordered rays)", xl, np.load(XL_FIXTURE),
                  XL_DEPTH10_BUDGET, "K5")

    # ---- 13: the scene-scale path through the CLI, culled and brute force ----
    def cli_frames(tag, argv):
        reset_counts(k1, k2, k7)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        counts = read_counts(k1, k2, k7)
        log = buf.getvalue()
        for ln in log.splitlines():
            phase(f"[{tag}] cli: {ln}")
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        got = [(float(ms), int(rays), int(rb)) for ms, rays, rb in re.findall(
            r"frame \d+/\d+: ([\d.]+) ms, (\d+) rays, [\d.]+ Mrays/s, "
            r"(\d+) readbacks", log)]
        if len(got) != FRAMES or min(r for _, r, _ in got) < R:
            raise AssertionError(f"bad frame lines: {got}")
        return counts, got

    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "xl.npy")
        argv = ["-P", "random_spheres_xl", "-W", str(WIDTH), "-H", str(HEIGHT),
                "-S", str(SAMPLES), "-D", str(DEPTH), "-O", "-F", str(FRAMES),
                "--out", out_path]
        c13, xl_frames = cli_frames("13", argv)
        image = np.load(out_path)
        if c13["K5"] <= 0 or c13["K1"] or c13["K4"] or c13["plain"]:
            raise AssertionError(f"the xl path did not run through K5 alone: {c13}")
        if not (np.isfinite(image).all() and image.shape == (HEIGHT, WIDTH, 3)
                and 0.0 < float(image.mean()) <= 1.0):
            raise AssertionError("bad xl image")
        k5["launches"] = c13["K5"]
        # the same frames with the cull and the tile order off: K1 brute force
        cull_min = fp.CULL_MIN_TILES
        fp.CULL_MIN_TILES = 1 << 30
        try:
            c13b, brute_frames = cli_frames("13 brute", argv)
        finally:
            fp.CULL_MIN_TILES = cull_min
        if c13b["K1"] <= 0 or c13b["K5"] or c13b["plain"]:
            raise AssertionError(f"the brute-force run took a culled kernel: {c13b}")
    phase(f"[13] launches culled {c13}, brute force {c13b}")
    for i, ((ms, rays, rb), (bms, brays, brb)) in enumerate(zip(xl_frames,
                                                              brute_frames)):
        phase(f"[13] xl frame {i + 1}: culled {ms:.2f} ms, {rays / ms / 1e3:.2f} "
              f"Mrays/s, {rb} readbacks; brute force {bms:.2f} ms, "
              f"{brays / bms / 1e3:.2f} Mrays/s, {brb} readbacks (CUDA events; "
              f"{smi})")
    del xl

    # ---- 14: K3 on primary and once-scattered rays of random ----
    mscene, mcamera = presets.random(WIDTH / HEIGHT)
    mscene = mscene.to(dev)
    mfeats = SceneFeatures.from_scene(mscene)
    mtables = fp.prep_tables(mscene, mfeats)
    mflags = fp.feature_flags(mfeats)
    if not (mfeats.has_motion and mflags & k2.FLAG_MOTION
            and tuple(mtables.soa.shape) == (12, 512) and mtables.cull is None):
        raise AssertionError("random did not get the motion tables")
    ro, rd, tm = generate_primary_rays(mcamera, WIDTH, HEIGHT, SAMPLES,
                                       PRNGKey(0), device=dev)
    mst0 = fp.make_state(ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R))
    del ro, rd, tm
    phase(f"[14] random: {int(mscene.spheres.mask.sum())} spheres "
          f"({int((mscene.spheres.inv_time_delta != 0).sum())} moving) in "
          f"{mtables.soa.shape[1]} slots; ray times in "
          f"[{mst0.time.min().item():.4f}, {mst0.time.max().item():.4f}]")

    mt0, midx0, k3_err_a = nearest_check("14", "K3", mtables.soa, mst0,
                                         "primary", moving=True)
    mst1 = scattered(mtables, mflags, mst0, mt0, midx0)
    mt1, midx1, k3_err_b = nearest_check("14", "K3", mtables.soa, mst1,
                                         "scattered", moving=True)
    # K3 with a zero motion operand is K1, bit for bit
    sscene, _ = presets.random_spheres(WIDTH / HEIGHT)
    sscene = sscene.to(dev)
    soa12 = fp.build_sphere_soa(sscene, motion=True)
    t3, i3 = k1.sphere_nearest_moving(soa12, mst0.planes[:6], mst0.time)
    t1s, i1s = k1.sphere_nearest(fp.build_sphere_soa(sscene), mst0.planes[:6])
    torch.cuda.synchronize()
    same_k1 = torch.equal(t3, t1s) and torch.equal(i3, i1s)
    phase(f"[14] K3 on random_spheres (zero motion operand) equal to K1: "
          f"{same_k1}")
    if not (same_k1 and not soa12[5:].any()):
        raise AssertionError("K3 differs from K1 on static spheres")
    del soa12, t3, i3, t1s, i1s, sscene
    mrays = mst0.planes[:6]
    k3_ms = time_ms(lambda: k1.sphere_nearest_moving(mtables.soa, mrays,
                                                     mst0.time), 20)
    k3_ms_scattered = time_ms(lambda: k1.sphere_nearest_moving(
        mtables.soa, mst1.planes[:6], mst1.time), 20)
    soa5 = mtables.soa[:5].contiguous()
    k3_k1_ms = time_ms(lambda: k1.sphere_nearest(soa5, mrays), 20)
    k3_plain_ms = time_ms(lambda: k1.sphere_nearest_plain(
        mtables.soa, mrays, time=mst0.time), 2)
    k3_ys = nb.yardsticks(mtables.soa, R)
    k3_bound = (k3_ys["bound_ms"], k3_ys["bound_by"])
    k3_ceiling = k3_ys["issue_ceiling_ms"]
    k3_regs = kernel_registers(build_log, "sphere_nearest_kernelILb1E")
    phase(f"[14] K3 time at {R} rays x {mtables.soa.shape[1]} spheres: kernel "
          f"{k3_ms:.3f} ms (primary), {k3_ms_scattered:.3f} ms (scattered), "
          f"plain {k3_plain_ms:.3f} ms, K1 on the same rays "
          f"{k3_k1_ms:.3f} ms, bound {k3_bound[0]:.4f} ms ({k3_bound[1]})")
    for label, ms in (("primary", k3_ms), ("scattered", k3_ms_scattered)):
        phase(f"[14] K3 {label}: {k3_bound[0] / ms:.1%} of the bound, "
              f"{k3_ceiling / ms:.1%} of the -fmad=false issue ceiling "
              f"{k3_ceiling:.4f} ms")
    phase(f"[14] K3 registers and spills (ptxas, per rays a thread): {k3_regs}")

    # ---- 15: K2 with the motion flag on phase 14's winners ----
    k2m_run = shade_check(
        "15", "K2 (motion)", mtables, mflags,
        (("primary", mst0, mt0, midx0, 0), ("scattered", mst1, mt1, midx1, 1)))
    mwinners = winners_of(((mst0, mt0, midx0), (mst1, mt1, midx1)))
    del mst0, mst1

    # ---- 16: the CUDA trace of random against the committed JAX fixture ----
    fixture_trace("16", "random fixture", mscene, np.load(RANDOM_FIXTURE),
                  DEPTH10_BUDGET, "K3")

    # ---- 17: random through the CLI ----
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "random.npy")
        argv = ["-P", "random", "-W", str(WIDTH), "-H", str(HEIGHT),
                "-S", str(SAMPLES), "-D", str(DEPTH), "-O", "-F", str(FRAMES),
                "--out", out_path]
        c17, m_frames = cli_frames("17", argv)
        image = np.load(out_path)
    phase(f"[17] launches {c17}")
    if (c17["K3"] <= 0 or c17["K2"] <= 0 or c17["K1"] or c17["K4"]
            or c17["K5"] or c17["plain"]):
        raise AssertionError(f"the random frames did not run through K3 and "
                             f"K2 alone: {c17}")
    if not (np.isfinite(image).all() and image.shape == (HEIGHT, WIDTH, 3)
            and 0.0 < float(image.mean()) <= 1.0):
        raise AssertionError("bad random image")
    for i, (ms, rays, rb) in enumerate(m_frames):
        phase(f"[17] random frame {i + 1}: {ms:.2f} ms (CUDA events), {rays} "
              f"rays, {rays / ms / 1e3:.2f} Mrays/s, {rb} readbacks ({smi})")
    phase(f"[17] image mean {float(image.mean()):.6f}, finite")

    # ---- 18: K6 for moving spheres against its plain version ----
    msp = mscene.spheres
    k6m_err, k6m_ulp, k6m_sph, k6m_ms, k6m_plain_ms = k6_check(
        "18", "K6 (motion)", msp, mwinners, 2, moving=True)
    # per ray ro, rd, time, t, idx, g_t in (40 B) and g_ro, g_rd, g_time
    # out (28 B), the nine sphere floats in and their gradients out once;
    # ~80 operations
    k6m_ys = nb.k6_yardsticks(R, msp.radius.shape[0], True)
    k6m_bound = (k6m_ys["bound_ms"], k6m_ys["bound_by"])
    phase(f"[18] K6 (motion) time at {R} rays: kernel {k6m_ms:.3f} ms, plain "
          f"{k6m_plain_ms:.3f} ms, bound {k6m_bound[0]:.4f} ms ({k6m_bound[1]}, "
          f"{k6m_bound[0] / k6m_ms:.1%} of it)")
    del mwinners, mscene

    # ---- 19: the CUDA trace's gradients against the random JAX fixture ----
    grad_fixture("19", "random gradient fixture", presets.random(WIDTH / HEIGHT)[0],
                 np.load(RANDOM_GRAD_FIXTURE), MOTION_FIXTURE_GRAD_TOL, "K3")

    # ---- 20: the trainer on random through its entry point ----
    c20, losses20, moved20 = train_run("20", "random", "default",
                                       every_leaf=True)
    if c20["K3"] <= 0 or c20["K1"] or "spheres.center_delta" not in moved20:
        raise AssertionError(f"the random trainer did not run through K3: {c20}")

    # ---- 21-22: K7 against its plain version at full width ----
    def time_once(fn):
        """(result, ms) of one run of ``fn``, with CUDA events."""
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def k7_check(tag, preset):
        """K7 and its plain version on the primary rays of ``preset`` at
        the smoke's film, depth 10: at most 1% of rays outside 1e-3, the
        segment counts within 0.5%. Returns (the rays and K7's radiance,
        kept for phase 23; the numbers of the kernel line)."""
        scene_, cam_ = presets.from_name(preset, WIDTH / HEIGHT)
        scene_ = scene_.to(dev)
        feats_ = SceneFeatures.from_scene(scene_)
        rays_ = tuple(x.reshape(R, -1).squeeze(-1) for x in
                      generate_primary_rays(cam_, WIDTH, HEIGHT, SAMPLES,
                                            PRNGKey(0), device=dev))
        tables_ = k7.prep_tables(scene_)
        kwork = {}
        rad, segs = k7.trace_megakernel(tables_, *rays_, 7, DEPTH, feats_,
                                        work=kwork)
        work = {}
        (rad_p, segs_p), plain_ms = time_once(
            lambda: k7.trace_megakernel_plain(tables_, *rays_, 7, DEPTH, feats_,
                                              work=work))
        n_out, frac = rays_outside(rad, rad_p.cpu().numpy())
        err = float((rad - rad_p).abs().max())
        count, count_p = int(segs), int(segs_p)
        shaded, noisy = int(work["shaded"]), int(work["noise"])
        ms = time_ms(lambda: k7.trace_megakernel(tables_, *rays_, 7, DEPTH,
                                                 feats_), 5)
        n_sph = int(scene_.spheres.mask.sum())
        n_rect = int(scene_.rects.mask.sum())
        ys = nb.k7_yardsticks(scene_, tables_, feats_, R, count_p, shaded,
                              noisy)
        passes = int(kwork["lane_passes"])
        uniform = nb.k7_lane_passes(work["ray_segments"])
        phase(f"[{tag}] K7 {preset}: {R} rays depth {DEPTH}, {n_sph} live "
              f"spheres in {tables_.spheres.shape[0]} rows "
              f"({tables_.sphere_rows.shape[0]} resident, "
              f"{tables_.n_static} static), {n_rect} live rects "
              f"({tables_.rect_rows.shape[0]} resident); {n_out} rays "
              f"({frac:.6%}) outside 1e-3 of plain, max |diff| {err}; "
              f"segments {count} (plain {count_p}, {count / R:.3f} per ray), "
              f"{shaded} of them shaded, {noisy} with the noise texture")
        phase(f"[{tag}] K7 {preset} lane occupancy (segments / lane-passes): "
              f"{count / passes:.4f} ({passes} lane-passes); a block-uniform "
              f"loop's {count_p / uniform:.4f} ({uniform})")
        phase(f"[{tag}] K7 {preset} time: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {ys['bound_ms']:.4f} ms "
              f"({ys['bound_by']}, {ys['ops_a_segment']} operations a "
              f"segment's sweep), {ys['issue_ceiling_ms'] / ms:.1%} of the "
              f"-fmad=false issue ceiling {ys['issue_ceiling_ms']:.4f} ms "
              f"({smi})")
        if (frac > 0.01 or abs(count - count_p) > 0.005 * count_p
                or not bool(torch.isfinite(rad).all())):
            raise AssertionError(f"K7 differs from its plain version ({preset})")
        return (rays_, rad, count), {
            "max_abs_err": err, "lanes_outside": frac, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": ys["bound_ms"],
            "bound_by": ys["bound_by"],
            "issue_ceiling_ms": ys["issue_ceiling_ms"],
            "ops_a_segment": ys["ops_a_segment"],
            "segments": count, "shaded_segments": shaded,
            "noise_segments": noisy, "lane_passes": passes,
            "lane_occupancy": count / passes,
            "lane_occupancy_block_uniform": count_p / uniform}

    k7_runs = {p: k7_check(tag, p) for tag, p in (
        ("21", "random_spheres"), ("22", "random"), ("22", "simple_light"))}

    # ---- 23: K7 against the JAX fixture and the port's wavefront path ----
    mref = np.load(MEGA_FIXTURE)
    for preset, budget in (("simple_light", 0.005), ("random", DEPTH10_BUDGET)):
        depth = int(mref[f"{preset}.max_depth"])
        scene_ = presets.from_name(preset, WIDTH / HEIGHT)[0].to(dev)
        rad, segs = k7.trace_megakernel(
            k7.prep_tables(scene_),
            *(torch.from_numpy(mref[f"{preset}.rays.{k}"]).to(dev)
              for k in ("ro", "rd", "time")),
            int(mref["seed"]), depth, SceneFeatures.from_scene(scene_))
        n_out, frac = rays_outside(rad, mref[f"{preset}.radiance"])
        count, ref_count = int(segs), int(mref[f"{preset}.ray_count"])
        phase(f"[23] K7 on the {preset} fixture: {len(rad)} rays depth "
              f"{depth}, {frac:.4%} of rays outside 1e-3 (budget "
              f"{budget:.1%}), segments {count} vs JAX {ref_count}")
        if frac > budget or (abs(count - ref_count) > 0.01 * ref_count
                             if n_out else count != ref_count):
            raise AssertionError(f"K7 outside the contract of the {preset} "
                                 "fixture")
    for preset in ("random_spheres", "random"):
        (rays_, rad, count), _ = k7_runs[preset]
        scene_ = presets.from_name(preset, WIDTH / HEIGHT)[0].to(dev)
        res = fp.trace_fast(scene_, *rays_, 7, DEPTH,
                            SceneFeatures.from_scene(scene_))
        n_out, frac = rays_outside(rad, res.radiance.cpu().numpy())
        fcount = int(res.ray_count)
        phase(f"[23] K7 vs the port's trace_fast on {preset}: {R} rays, "
              f"{1.0 - frac:.6%} within 1e-3, segments {count} vs {fcount}")
        if frac > 0.01 or abs(count - fcount) > 0.01 * fcount:
            raise AssertionError(f"K7 disagrees with trace_fast on {preset}")
    sl_k7 = k7_runs["simple_light"][0]
    k7_runs = {p: v for p, (_, v) in k7_runs.items()}

    # ---- 24: megakernel frames (the tables built once per scene) ----
    reset_counts(k1, k2, k7)
    k7_frames = {}
    for preset in ("random_spheres", "random", "simple_light"):
        scene_, cam_ = presets.from_name(preset, WIDTH / HEIGHT)
        scene_, cam_ = scene_.to(dev), cam_.to(dev)
        feats_ = SceneFeatures.from_scene(scene_)
        tables_, tables_ms = time_once(lambda: k7.prep_tables(scene_))
        phase(f"[24] {preset}: the megakernel's tables in {tables_ms:.3f} ms "
              f"(once per scene)")
        def frame(seed):
            ro_, rd_, tm_ = generate_primary_rays(
                cam_, WIDTH, HEIGHT, SAMPLES, fold_in(PRNGKey(0), seed),
                device=dev)
            rad, segs = k7.trace_megakernel(
                tables_, ro_.reshape(R, 3), rd_.reshape(R, 3), tm_.reshape(R),
                seed, DEPTH, feats_)
            return rad.reshape(HEIGHT, WIDTH, SAMPLES, 3).mean(dim=2), segs

        k7_frames[preset] = []
        for i in range(FRAMES):
            (image, segs), ms = time_once(lambda: frame(i))
            mean = float(image.mean())
            if not (bool(torch.isfinite(image).all()) and 0.0 < mean <= 1.0):
                raise AssertionError(f"bad {preset} megakernel image: {mean}")
            k7_frames[preset].append(ms)
            phase(f"[24] megakernel {preset} frame {i + 1}: {ms:.2f} ms (CUDA "
                  f"events), {int(segs)} rays, {int(segs) / ms / 1e3:.2f} "
                  f"Mrays/s, image mean {mean:.6f} ({smi})")
    c24 = read_counts(k1, k2, k7)
    wave = {"random_spheres": [ms for ms, _, _ in frames],
            "random": [ms for ms, _, _ in m_frames]}
    for preset, ms_list in wave.items():
        phase(f"[24] {preset}: megakernel frames "
              + ", ".join(f"{ms:.2f}" for ms in k7_frames[preset])
              + " ms; wavefront frames (phases 6, 17) "
              + ", ".join(f"{ms:.2f}" for ms in ms_list) + " ms")
    phase(f"[24] launches {c24}")
    others = [c24[k] for k in ("K1", "K2", "K3", "K4", "K5", "K6")]
    if c24["K7"] != 3 * FRAMES or any(others) or c24["plain"]:
        raise AssertionError(f"the megakernel frames did not run through K7 "
                             f"alone: {c24}")

    # ---- 25: K2's rect branch and MIS entry on simple_light's winners ----
    lscene, lcamera = presets.simple_light(WIDTH / HEIGHT)
    lscene = lscene.to(dev)
    lfeats = SceneFeatures.from_scene(lscene)
    llights = build_light_table(lscene)
    ltables = fp.prep_tables(lscene, lfeats, lights=llights)
    lflags = fp.feature_flags(lfeats)
    eflags = lflags | k2.FLAG_EMIT_SCALE
    if not (lflags & k2.FLAG_RECT and ltables.rects is not None
            and llights.count == 2 and ltables.table.shape[0] == 256):
        raise AssertionError("simple_light did not get the rect tables")
    ro, rd, tm = generate_primary_rays(lcamera, WIDTH, HEIGHT, SAMPLES,
                                       PRNGKey(0), device=dev)
    lst0 = fp.make_state(ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R))
    del ro, rd, tm
    lt0, lidx0 = fp.closest_hit(ltables, lst0, 0, lfeats)
    lst1 = scattered(ltables, lflags, lst0, lt0, lidx0)
    lt1, lidx1 = fp.closest_hit(ltables, lst1, 1, lfeats)
    # K1 alone on the scene's 128 sphere slots, before the rect merge
    _, _, k1l_err_a = nearest_check("25", "K1", ltables.soa, lst0,
                                    "simple_light primary")
    _, _, k1l_err_b = nearest_check("25", "K1", ltables.soa, lst1,
                                    "simple_light scattered")
    rect_row0 = ltables.table.shape[0] - fp.RECT_ROWS
    for label, t_, idx_ in (("primary", lt0, lidx0), ("scattered", lt1, lidx1)):
        hit = t_ < 1e30
        rows = ltables.table[idx_.long()]
        phase(f"[25] simple_light {label}: {R} rays, hit "
              f"{hit.float().mean().item():.4f}, rect winners "
              f"{int((hit & (idx_ >= rect_row0)).sum())}, light hits "
              f"{int((hit & (rows[:, 0] == 3.0)).sum())}, noise winners "
              f"{int((hit & (rows[:, 3] == 2.0)).sum())}")
    k2r_run = shade_check(
        "25", "K2 (rect)", ltables, lflags,
        (("primary", lst0, lt0, lidx0, 0), ("scattered", lst1, lt1, lidx1, 1)))
    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def with_esc(st):
        esc = torch.rand((1, R), generator=g, device=dev)
        return fp.FastStateP(torch.cat([st.planes[:12], esc]), st.time,
                             st.alive, st.lane)

    est0, est1 = with_esc(lst0), with_esc(lst1)
    k2e_run = shade_check(
        "25", "K2 (rect, emit_scale)", ltables, eflags,
        (("primary", est0, lt0, lidx0, 0), ("scattered", est1, lt1, lidx1, 1)))
    # the noise branch without rects: two_perlin_spheres (marble spheres)
    pscene, pcamera = presets.from_name("two_perlin_spheres", WIDTH / HEIGHT)
    pscene = pscene.to(dev)
    pfeats = SceneFeatures.from_scene(pscene)
    ptables = fp.prep_tables(pscene, pfeats)
    pflags = fp.feature_flags(pfeats)
    if not pflags & k2.FLAG_NOISE or pflags & k2.FLAG_RECT:
        raise AssertionError("two_perlin_spheres did not get the noise flag")
    ro, rd, tm = generate_primary_rays(pcamera, WIDTH, HEIGHT, SAMPLES,
                                       PRNGKey(0), device=dev)
    pst0 = fp.make_state(ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R))
    del ro, rd, tm
    pt0, pidx0 = fp.closest_hit(ptables, pst0, 0, pfeats)
    pst1 = scattered(ptables, pflags, pst0, pt0, pidx0)
    pt1, pidx1 = fp.closest_hit(ptables, pst1, 1, pfeats)
    k2n_run = shade_check(
        "25", "K2 (noise, two_perlin_spheres)", ptables, pflags,
        (("primary", pst0, pt0, pidx0, 0), ("scattered", pst1, pt1, pidx1, 1)))
    if not k2n_run["noise_lanes"]:
        raise AssertionError("two_perlin_spheres: no noise lanes")
    del pst0, pst1, pt0, pt1, pidx0, pidx1, ptables, pscene
    # the plain-PyTorch pieces around K2, per full-width bounce
    rect_ms = time_ms(lambda: rect_nearest(ltables.rects, *lst0.planes[:6]), 10)
    eout, ealive = k2.shade_from_winners(
        ltables.table, lidx0, lt0, est0.planes, est0.time, est0.alive,
        est0.lane, 7, 0, DEPTH, ltables.sky4, eflags)
    # K1 on the shadow rays the NEE tail sweeps at depth 0: the lanes off
    # NEE start at the origin, as in the reference
    sh = fp.shadow_rays(ltables, lidx0, eout, ealive, est0.lane, 7, 0)
    _, _, k1l_err_c = nearest_check(
        "25", "K1", ltables.soa, fp.FastStateP(sh.rays, est0.time, ealive,
                                               est0.lane),
        f"simple_light shadow rays ({int(sh.mask.sum())} on NEE)")
    k1l_ms = time_ms(lambda: k1.sphere_nearest(ltables.soa, lst0.planes[:6]),
                     20)
    k1l_plain_ms = time_ms(
        lambda: k1.sphere_nearest_plain(ltables.soa, lst0.planes[:6]), 2)
    k1l_ys = nb.yardsticks(ltables.soa, R)
    k1l_bound = (k1l_ys["bound_ms"], k1l_ys["bound_by"])
    phase(f"[25] K1 time at {R} rays x {ltables.soa.shape[1]} slots: kernel "
          f"{k1l_ms:.3f} ms, plain {k1l_plain_ms:.3f} ms, bound "
          f"{k1l_bound[0]:.4f} ms ({k1l_bound[1]})")
    del sh
    shadow = fp.nee_tail(ltables, lt0, lidx0, est0, eout, ealive, 7, 0, lfeats)
    phase(f"[25] NEE tail at depth 0: {int(shadow)} shadow rays of {R} lanes "
          f"({int(ealive.sum())} alive after K2)")
    nee_ms = time_ms(lambda: fp.nee_tail(ltables, lt0, lidx0, est0, eout,
                                         ealive, 7, 0, lfeats), 5)
    rr_ms = time_ms(lambda: fp.rr_tail(eout[:13], ealive, est0.lane, 7,
                                       RR_START, RR_START), 10)
    phase(f"[25] per full-width bounce ({R} lanes): rect sweep {rect_ms:.3f} "
          f"ms, NEE tail {nee_ms:.3f} ms, roulette tail {rr_ms:.3f} ms "
          f"(plain PyTorch; {smi})")
    # device launches (kernels, copies, fills) per full-width bounce
    n_launch = {
        "rect sweep": device_launches(
            lambda: rect_nearest(ltables.rects, *lst0.planes[:6])),
        "NEE tail": device_launches(
            lambda: fp.nee_tail(ltables, lt0, lidx0, est0, eout, ealive, 7,
                                0, lfeats)),
        "roulette tail": device_launches(
            lambda: fp.rr_tail(eout[:13], ealive, est0.lane, 7, RR_START,
                               RR_START)),
        "bounce": device_launches(
            lambda: fp.fast_bounce_fused(
                ltables._replace(lights=None, light_rgb=None), lst0, 7, 0,
                DEPTH, lfeats)),
        "bounce with NEE and roulette": device_launches(
            lambda: fp.fast_bounce_fused(ltables, est0, 7, RR_START, DEPTH,
                                         lfeats, rr_start=RR_START)),
    }
    phase(f"[25] device launches per full-width bounce: {n_launch}")
    del lst0, lst1, est0, est1, eout, ealive

    # ---- 26: the CUDA trace of simple_light against the JAX fixtures ----
    lref = np.load(LIGHT_FIXTURE)
    for name, ref_, kw in (
            ("simple_light fixture", lref, {}),
            ("simple_light NEE fixture", np.load(NEE_FIXTURE),
             {"nee_lights": llights, "rr_start": RR_START})):
        depth = int(lref["max_depth"])
        reset_counts(k1, k2, k7)
        res = fp.trace_fast(lscene, *(torch.from_numpy(lref[k]).to(dev) for k in
                                      ("rays.ro", "rays.rd", "rays.time")),
                            int(lref["seed"]), depth, lfeats, min_size=128, **kw)
        counts = read_counts(k1, k2, k7)
        n_out, frac = rays_outside(res.radiance, ref_["radiance"])
        count, ref_count = int(res.ray_count), int(ref_["ray_count"])
        phase(f"[26] {name}: {len(res.radiance)} rays depth {depth}, "
              f"{frac:.4%} of rays outside 1e-3 (budget {DEPTH10_BUDGET:.0%}), "
              f"segments {count} vs JAX {ref_count}; launches {counts}")
        if (frac > DEPTH10_BUDGET or counts["K1"] <= 0 or counts["K2"] <= 0
                or counts["K3"] or counts["K4"] or counts["K5"]
                or counts["plain"] or abs(count - ref_count) > 2 * n_out * depth):
            raise AssertionError(f"{name}: trace outside the slice contract")

    # ---- 27: simple_light through the CLI, plain and with NEE + roulette ----
    light_runs = {}
    for label, extra in (("plain", []), ("nee_rr", ["--nee", "--rr",
                                                    str(RR_START)])):
        with tempfile.TemporaryDirectory() as tmp:
            out_path = os.path.join(tmp, "simple_light.npy")
            argv = ["-P", "simple_light", "-W", str(WIDTH), "-H", str(HEIGHT),
                    "-S", str(SAMPLES), "-D", str(DEPTH), "-O", "-F",
                    str(FRAMES), "--out", out_path, *extra]
            counts, got = cli_frames(f"27 {label}", argv)
            image = np.load(out_path)
        if (counts["K1"] <= 0 or counts["K2"] <= 0 or counts["K3"]
                or counts["K4"] or counts["K5"] or counts["plain"]):
            raise AssertionError(f"simple_light {label} did not run through K1 "
                                 f"and K2 alone: {counts}")
        mean = float(image.mean())
        if not (np.isfinite(image).all() and image.shape == (HEIGHT, WIDTH, 3)
                and 0.0 < mean):
            raise AssertionError(f"bad simple_light {label} image: {mean}")
        light_runs[label] = (counts, got, mean)
        for i, (ms, rays, rb) in enumerate(got):
            phase(f"[27] simple_light {label} frame {i + 1}: {ms:.2f} ms (CUDA "
                  f"events), {rays} segments, {rays / ms / 1e3:.2f} Mrays/s, "
                  f"{rb} readbacks ({smi})")
        phase(f"[27] simple_light {label}: launches {counts}, image mean "
              f"{mean:.6f}")
    (c27, plain_frames, plain_mean) = light_runs["plain"]
    (c27n, nee_frames, nee_mean) = light_runs["nee_rr"]
    segs_plain = sum(r for _, r, _ in plain_frames)
    segs_nee = sum(r for _, r, _ in nee_frames)
    phase(f"[27] NEE + roulette: {segs_nee} segments against {segs_plain} "
          f"plain; image mean {nee_mean:.6f} vs plain {plain_mean:.6f} "
          f"({nee_mean / plain_mean - 1.0:+.3%})")
    if abs(nee_mean / plain_mean - 1.0) > 0.05:
        raise AssertionError("the NEE image's mean is more than 5% off")

    # ---- 28: the wavefront simple_light trace against K7 ray by ray ----
    rays_, rad, count = sl_k7
    res = fp.trace_fast(lscene, *rays_, 7, DEPTH, lfeats)
    n_out, frac = rays_outside(rad, res.radiance.cpu().numpy())
    fcount = int(res.ray_count)
    phase(f"[28] K7 vs the port's trace_fast on simple_light: {R} rays, "
          f"{1.0 - frac:.6%} within 1e-3, segments {count} vs {fcount}")
    if frac > 0.01 or abs(count - fcount) > 0.01 * fcount:
        raise AssertionError("K7 disagrees with trace_fast on simple_light")
    del sl_k7, rays_, rad, res, lscene

    # ---- 29: K2's box and medium branches on cornell and cornell_smoke ----
    box_runs = {}
    for cname, flag_name, row_kind, key in (
            ("cornell", "FLAG_BOX", 2.0, "box"),
            ("cornell_smoke", "FLAG_MEDIUM", 3.0, "medium")):
        cscene, ccamera = presets.from_name(cname, WIDTH / HEIGHT)
        cscene = cscene.to(dev)
        cfeats = SceneFeatures.from_scene(cscene)
        clights = build_light_table(cscene)
        ctables = fp.prep_tables(cscene, cfeats, lights=clights)
        cflags = fp.feature_flags(cfeats)
        if not (cflags & getattr(k2, flag_name) and not cfeats.has_spheres
                and ctables.table.shape[1] == 48 and clights.count == 1):
            raise AssertionError(f"{cname} did not get the {key} tables")
        ro, rd, tm = generate_primary_rays(ccamera, WIDTH, HEIGHT, SAMPLES,
                                           PRNGKey(0), device=dev)
        cst0 = fp.make_state(ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R))
        del ro, rd, tm
        ct0, cidx0 = fp.closest_hit(ctables, cst0, 0, cfeats, seed=7)
        cst1 = scattered(ctables, cflags, cst0, ct0, cidx0)
        ct1, cidx1 = fp.closest_hit(ctables, cst1, 1, cfeats, seed=7)
        n_kind = []
        for label, t_, idx_ in (("primary", ct0, cidx0),
                                ("scattered", ct1, cidx1)):
            hit = t_ < 1e30
            rows = ctables.table[idx_.long()]
            n_kind.append(int((hit & (rows[:, 14] == row_kind)).sum()))
            phase(f"[29] {cname} {label}: {R} rays, hit "
                  f"{hit.float().mean().item():.4f}, {key} winners "
                  f"{n_kind[-1]}, rect winners "
                  f"{int((hit & (rows[:, 14] == 1.0)).sum())}, light hits "
                  f"{int((hit & (rows[:, 0] == 3.0)).sum())}")
        if min(n_kind) <= 0:
            raise AssertionError(f"{cname}: no {key} winners")
        cases = (("primary", cst0, ct0, cidx0, 0),
                 ("scattered", cst1, ct1, cidx1, 1))
        c_run = shade_check(
            "29", f"K2 ({cname}, {flag_name})", ctables, cflags, cases)
        est0, est1 = with_esc(cst0), with_esc(cst1)
        eflags_c = cflags | k2.FLAG_EMIT_SCALE
        e_run = shade_check(
            "29", f"K2 ({cname}, {flag_name} + FLAG_EMIT_SCALE)", ctables,
            eflags_c, (("primary", est0, ct0, cidx0, 0),
                       ("scattered", est1, ct1, cidx1, 1)))
        # the plain-PyTorch pieces around K2, per full-width bounce
        rays = cst0.planes[:6]
        eout, ealive = k2.shade_from_winners(
            ctables.table, cidx0, ct0, est0.planes, est0.time, est0.alive,
            est0.lane, 7, 0, DEPTH, ctables.sky4, eflags_c)
        shadow = fp.nee_tail(ctables, ct0, cidx0, est0, eout, ealive, 7, 0,
                             cfeats)
        phase(f"[29] {cname} NEE tail at depth 0: {int(shadow)} shadow rays "
              f"of {R} lanes ({int(ealive.sum())} alive after K2)")
        pieces = {"rect sweep": lambda: rect_nearest(ctables.rects, *rays)}
        if ctables.boxes is not None:
            pieces["box sweep"] = lambda: box_nearest(ctables.boxes, *rays)
        if ctables.media is not None:
            pieces["media sweep (with its draws)"] = lambda: media_nearest(
                ctables.media, *rays, fp.media_uniforms(
                    cst0.lane, 7, 0, ctables.media.count, 8))
        pieces["NEE tail"] = lambda: fp.nee_tail(
            ctables, ct0, cidx0, est0, eout, ealive, 7, 0, cfeats)
        pieces["bounce"] = lambda: fp.fast_bounce_fused(
            ctables._replace(lights=None, light_rgb=None), cst0, 7, 0, DEPTH,
            cfeats)
        pieces["bounce with NEE and roulette"] = lambda: fp.fast_bounce_fused(
            ctables, est0, 7, RR_START, DEPTH, cfeats, rr_start=RR_START)
        piece_ms = {name: time_ms(fn, 5) for name, fn in pieces.items()}
        piece_launches = {name: device_launches(fn)
                          for name, fn in pieces.items()}
        phase(f"[29] {cname} per full-width bounce ({R} lanes, plain "
              f"PyTorch around K2; {smi}): ms "
              + ", ".join(f"{k} {v:.3f}" for k, v in piece_ms.items()))
        phase(f"[29] {cname} device launches per full-width bounce: "
              f"{piece_launches}")
        box_runs[key] = {
            **c_run, "winners": n_kind,
            **{f"emit_scale_{k}": v for k, v in e_run.items()},
            "bounce_ms": piece_ms, "bounce_device_launches": piece_launches}
        del cst0, cst1, est0, est1, eout, ealive, ct0, ct1, cidx0, cidx1
        del rays, pieces, cscene, ctables

    # ---- 30: the CUDA traces of cornell and cornell_smoke against JAX ----
    for fixture, prefix, cname, nee in (
            (CORNELL_FIXTURE, "", "cornell", False),
            (CORNELL_FIXTURE, "nee.", "cornell", True),
            (SMOKE_FIXTURE, "", "cornell_smoke", True),
            (SMOKE_FIXTURE, "plain.", "cornell_smoke", False)):
        ref_ = np.load(fixture)
        cscene = presets.from_name(cname, WIDTH / HEIGHT)[0].to(dev)
        kw = ({"nee_lights": build_light_table(cscene),
               "rr_start": int(ref_["rr_start"])} if nee else {})
        depth = int(ref_["max_depth"])
        reset_counts(k1, k2, k7)
        res = fp.trace_fast(cscene, *(torch.from_numpy(ref_[k]).to(dev)
                                      for k in ("rays.ro", "rays.rd",
                                                "rays.time")),
                            int(ref_["seed"]), depth,
                            SceneFeatures.from_scene(cscene), min_size=128,
                            **kw)
        counts = read_counts(k1, k2, k7)
        n_out, frac = rays_outside(res.radiance, ref_[prefix + "radiance"])
        count, ref_count = int(res.ray_count), int(ref_[prefix + "ray_count"])
        label = f"{cname} {'NEE + roulette' if nee else 'plain'}"
        phase(f"[30] {label} fixture: {len(res.radiance)} rays depth {depth}, "
              f"{n_out} rays ({frac:.4%}) outside 1e-3 (budget "
              f"{DEPTH10_BUDGET:.0%}), segments {count} vs JAX {ref_count}; "
              f"launches {counts}")
        box_runs.setdefault("fixture_share_outside", {})[label] = frac
        others = [counts[k] for k in ("K1", "K3", "K4", "K5", "K6", "K7")]
        # K2 once a bounce; the ladder stops early once every path has ended
        if (frac > DEPTH10_BUDGET or not 0 < counts["K2"] <= depth + 1
                or any(others) or counts["plain"]
                or abs(count - ref_count) > 2 * n_out * depth):
            raise AssertionError(f"{label}: trace outside the slice contract")

    # ---- 31: cornell and cornell_smoke through the CLI ----
    for cname, key in (("cornell", "box"), ("cornell_smoke", "medium")):
        runs = {}
        for label, extra in (("plain", []), ("nee_rr", ["--nee", "--rr",
                                                        str(RR_START)])):
            with tempfile.TemporaryDirectory() as tmp:
                out_path = os.path.join(tmp, f"{cname}.npy")
                argv = ["-P", cname, "-W", str(WIDTH), "-H", str(HEIGHT),
                        "-S", str(SAMPLES), "-D", str(DEPTH), "-O", "-F",
                        str(FRAMES), "--out", out_path, *extra]
                counts, got = cli_frames(f"31 {cname} {label}", argv)
                image = np.load(out_path)
            others = [counts[k] for k in ("K1", "K3", "K4", "K5", "K6", "K7")]
            if counts["K2"] <= 0 or any(others) or counts["plain"]:
                raise AssertionError(f"{cname} {label} did not run through K2 "
                                     f"alone: {counts}")
            mean = float(image.mean())
            if not (np.isfinite(image).all()
                    and image.shape == (HEIGHT, WIDTH, 3) and 0.0 < mean):
                raise AssertionError(f"bad {cname} {label} image: {mean}")
            runs[label] = (counts, got, mean)
            for i, (ms, rays_n, rb) in enumerate(got):
                phase(f"[31] {cname} {label} frame {i + 1}: {ms:.2f} ms (CUDA "
                      f"events), {rays_n} segments, {rays_n / ms / 1e3:.2f} "
                      f"Mrays/s, {rb} readbacks ({smi})")
            median = sorted(ms for ms, _, _ in got)[len(got) // 2]
            phase(f"[31] {cname} {label}: median {median:.2f} ms, launches "
                  f"{counts}, image mean {mean:.6f}")
            box_runs[key][f"{label}_frame_ms"] = [ms for ms, _, _ in got]
            box_runs[key][f"{label}_launches"] = counts["K2"]
        plain_mean, nee_mean = runs["plain"][2], runs["nee_rr"][2]
        phase(f"[31] {cname} NEE + roulette: image mean {nee_mean:.6f} vs "
              f"plain {plain_mean:.6f} ({nee_mean / plain_mean - 1.0:+.3%})")
        if abs(nee_mean / plain_mean - 1.0) > 0.05:
            raise AssertionError(f"{cname}: the NEE image's mean is more "
                                 f"than 5% off")

    # ---- 32: K2's image branch on earth and the image-light scene ----
    from pathtrace_tpu_torch.models import build as pbuild
    from pathtrace_tpu_torch.render.film import encode_png

    def image_scene(name):
        """(scene on the card, camera) of ``earth`` or the image-light scene
        (``simple_light``'s camera)."""
        if name == "earth":
            scene_, cam_ = presets.earth(WIDTH / HEIGHT)
        else:
            scene_ = presets.image_light_scene(
                pbuild, presets._procedural_earth_image())
            cam_ = presets.simple_light(WIDTH / HEIGHT)[1]
        return scene_.to(dev), cam_

    img_runs = {}
    for iname in ("earth", "image_light"):
        iscene, icamera = image_scene(iname)
        ifeats = SceneFeatures.from_scene(iscene)
        ilights = build_light_table(iscene) if iname != "earth" else None
        itables = fp.prep_tables(iscene, ifeats, lights=ilights)
        iflags = fp.feature_flags(ifeats)
        if not (iflags & k2.FLAG_IMAGE and itables.table.shape[1] == 28
                and itables.atlas is not None
                and bool(iflags & k2.FLAG_RECT) == (iname != "earth")):
            raise AssertionError(f"{iname} did not get the image tables")
        ro, rd, tm = generate_primary_rays(icamera, WIDTH, HEIGHT, SAMPLES,
                                           PRNGKey(0), device=dev)
        ist0 = fp.make_state(ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R))
        del ro, rd, tm
        it0, iidx0 = fp.closest_hit(itables, ist0, 0, ifeats)
        ist1 = scattered(itables, iflags, ist0, it0, iidx0)
        it1, iidx1 = fp.closest_hit(itables, ist1, 1, ifeats)
        n_img, n_noise = [], []
        for label, t_, idx_ in (("primary", it0, iidx0),
                                ("scattered", it1, iidx1)):
            hit = t_ < 1e30
            rows = itables.table[idx_.long()]
            n_img.append(int((hit & (rows[:, 3] == 3.0)).sum()))
            n_noise.append(int((hit & (rows[:, 3] == 2.0)).sum()))
            phase(f"[32] {iname} {label}: {R} rays, hit "
                  f"{hit.float().mean().item():.4f}, image lanes {n_img[-1]} "
                  f"(rect {int((hit & (rows[:, 3] == 3.0) & (rows[:, 14] == 1.0)).sum())}), "
                  f"noise lanes {n_noise[-1]}")
        if n_img[0] <= 0:
            raise AssertionError(f"{iname}: no image lanes")
        g = torch.Generator(device=dev)
        g.manual_seed(1)

        def with_esc_i(st):
            esc = torch.rand((1, R), generator=g, device=dev)
            return fp.FastStateP(torch.cat([st.planes[:12], esc]), st.time,
                                 st.alive, st.lane)

        iest0, iest1 = with_esc_i(ist0), with_esc_i(ist1)
        eflags_i = iflags | k2.FLAG_EMIT_SCALE
        run = {"image_lanes": n_img}
        plain_cases = (("primary", ist0, it0, iidx0, 0),
                       ("scattered", ist1, it1, iidx1, 1))
        emit_cases = (("primary", iest0, it0, iidx0, 0),
                      ("scattered", iest1, it1, iidx1, 1))
        # earth: the image flag alone, then with the MIS flag; the
        # image-light scene: rect, image and MIS flags (its main path)
        variants = [("emit_scale", eflags_i, emit_cases)]
        if iname == "earth":
            variants.insert(0, ("plain", iflags, plain_cases))
        for key, fl, cases in variants:
            run[key] = shade_check(
                "32", f"K2 ({iname}, flags {fl}; {smi})", itables, fl, cases)
        # texel-index flips: image lanes whose albedo rows (the texel)
        # differ between the kernel and its plain version
        flips = []
        for label, st, t_, idx_, depth in emit_cases:
            args = (itables.table, idx_, t_, st.planes, st.time, st.alive,
                    st.lane, 7, depth, DEPTH, itables.sky4, eflags_i)
            out = k2.shade_from_winners(*args, atlas=itables.atlas)[0]
            out_p = k2.shade_from_winners_plain(*args, atlas=itables.atlas)[0]
            is_img = (t_ < 1e30) & (itables.table[idx_.long(), 3] == 3.0)
            flips.append(int((is_img & (out[k2.ALBEDO] != out_p[k2.ALBEDO])
                              .any(dim=0)).sum()))
            phase(f"[32] {iname} {label}: {flips[-1]} of "
                  f"{int(is_img.sum())} image lanes with another texel "
                  f"than the plain version")
        if sum(flips) > 0.005 * max(sum(n_img), 1):
            raise AssertionError(f"{iname}: texel flips beyond the contract")
        run["texel_flips"] = flips
        # the reference's XLA pre-pass, as the plain version computes it:
        # what K2 folds in (UV and one texel read per lane)
        rows0 = itables.table.index_select(0, iidx0.long())
        col0 = list(rows0.unbind(1))
        hit0 = it0 < 1e30
        ts0 = torch.where(hit0, it0, 0.0)
        p0 = [ist0.planes[k] + ts0 * ist0.planes[3 + k] for k in range(3)]

        def prepass():
            return k2.image_rgb_planes(col0, *p0, ist0.time, itables.atlas,
                                       iflags)

        pre_ms = time_ms(prepass, 10)
        pre_launches = device_launches(prepass)
        run["prepass_plain_ms"], run["prepass_launches"] = pre_ms, pre_launches
        phase(f"[32] {iname}: the plain texel pre-pass at {R} lanes "
              f"{pre_ms:.3f} ms, {pre_launches} device launches (folded into "
              f"K2 on the card)")
        img_runs[iname] = run
        del ist0, ist1, iest0, iest1, it0, it1, iidx0, iidx1, rows0, col0, p0

    # ---- 33: the CUDA traces of the image fixtures against JAX ----
    for fixture, iname, nee in ((EARTH_FIXTURE, "earth", False),
                                (IMAGE_LIGHT_FIXTURE, "image_light", True)):
        ref_ = np.load(fixture)
        iscene = image_scene(iname)[0]
        kw = ({"nee_lights": build_light_table(iscene),
               "rr_start": int(ref_["rr_start"])} if nee else {})
        depth = int(ref_["max_depth"])
        reset_counts(k1, k2, k7)
        res = fp.trace_fast(iscene, *(torch.from_numpy(ref_[k]).to(dev)
                                      for k in ("rays.ro", "rays.rd",
                                                "rays.time")),
                            int(ref_["seed"]), depth,
                            SceneFeatures.from_scene(iscene), min_size=128,
                            **kw)
        counts = read_counts(k1, k2, k7)
        n_out, frac = rays_outside(res.radiance, ref_["radiance"])
        count, ref_count = int(res.ray_count), int(ref_["ray_count"])
        label = f"{iname} {'NEE + roulette' if nee else 'plain'}"
        phase(f"[33] {label} fixture: {len(res.radiance)} rays depth {depth}, "
              f"{n_out} rays ({frac:.4%}) outside 1e-3 (budget "
              f"{DEPTH10_BUDGET:.0%}), segments {count} vs JAX {ref_count}; "
              f"launches {counts}")
        img_runs.setdefault("fixture_share_outside", {})[label] = frac
        others = [counts[k] for k in ("K3", "K4", "K5", "K6", "K7")]
        if (frac > DEPTH10_BUDGET or counts["K1"] <= 0
                or not 0 < counts["K2"] <= depth + 1 or any(others)
                or counts["plain"]
                or abs(count - ref_count) > 2 * n_out * depth):
            raise AssertionError(f"{label}: trace outside the slice contract")

    # ---- 34: earth through the CLI, the image-light scene by frames ----
    earth_runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        map_path = os.path.join(tmp, "map.png")
        # a user's map: red land in the north, blue sea in the south
        user_map = np.zeros((64, 128, 3), np.uint8)
        user_map[:32] = (200, 40, 40)
        user_map[32:] = (30, 60, 200)
        with open(map_path, "wb") as f:
            f.write(encode_png(user_map))
        for label, extra in (("default map", []),
                             ("--image", ["--image", map_path])):
            out_path = os.path.join(tmp, "earth.npy")
            argv = ["-P", "earth", "-W", str(WIDTH), "-H", str(HEIGHT),
                    "-S", str(SAMPLES), "-D", str(DEPTH), "-O", "-F",
                    str(FRAMES), "--out", out_path, *extra]
            counts, got = cli_frames(f"34 earth {label}", argv)
            image = np.load(out_path)
            others = [counts[k] for k in ("K3", "K4", "K5", "K6", "K7")]
            if (counts["K1"] <= 0 or counts["K2"] <= 0 or any(others)
                    or counts["plain"]):
                raise AssertionError(f"earth {label} did not run through K1 "
                                     f"and K2 alone: {counts}")
            mean = float(image.mean())
            if not (np.isfinite(image).all()
                    and image.shape == (HEIGHT, WIDTH, 3) and 0.0 < mean):
                raise AssertionError(f"bad earth {label} image: {mean}")
            for i, (ms, rays_n, rb) in enumerate(got):
                phase(f"[34] earth {label} frame {i + 1}: {ms:.2f} ms (CUDA "
                      f"events), {rays_n} segments, {rays_n / ms / 1e3:.2f} "
                      f"Mrays/s, {rb} readbacks ({smi})")
            globe = image[HEIGHT // 2 - 40:HEIGHT // 2 + 40,
                          WIDTH // 2 - 40:WIDTH // 2 + 40].reshape(-1, 3)
            phase(f"[34] earth {label}: launches {counts}, image mean "
                  f"{mean:.6f}, globe centre rgb "
                  f"{np.round(globe.mean(axis=0), 4).tolist()}")
            if label == "--image" and mean == earth_runs["default map"]["mean"]:
                raise AssertionError("--image did not change the earth image")
            earth_runs[label] = {"frame_ms": [ms for ms, _, _ in got],
                                 "segments": [r for _, r, _ in got],
                                 "readbacks": [rb for _, _, rb in got],
                                 "launches": counts, "mean": mean}
    iscene, icamera = image_scene("image_light")
    ifeats = SceneFeatures.from_scene(iscene)
    ilights = build_light_table(iscene)
    il_runs = {}
    for label, kw in (("plain", {}),
                      ("nee_rr", {"nee_lights": ilights,
                                  "rr_start": RR_START})):
        reset_counts(k1, k2, k7)
        frame_ms, segs, rbs, acc = [], [], [], None
        for frame in range(FRAMES):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            ro, rd, tm = generate_primary_rays(
                icamera, WIDTH, HEIGHT, SAMPLES, fold_in(PRNGKey(3), frame),
                device=dev)
            res = fp.trace_frame(iscene, ro.reshape(R, 3), rd.reshape(R, 3),
                                 tm.reshape(R), WIDTH, HEIGHT, SAMPLES, DEPTH,
                                 1000 + frame, ifeats, **kw)
            end.record()
            end.synchronize()
            frame_ms.append(start.elapsed_time(end))
            segs.append(int(res.ray_count))
            rbs.append(res.readbacks)
            acc = res.image if acc is None else acc + res.image
        counts = read_counts(k1, k2, k7)
        image = (acc / FRAMES).cpu().numpy()
        mean = float(image.mean())
        others = [counts[k] for k in ("K3", "K4", "K5", "K6", "K7")]
        if (counts["K1"] <= 0 or counts["K2"] <= 0 or any(others)
                or counts["plain"] or not np.isfinite(image).all()
                or mean <= 0.0):
            raise AssertionError(f"image_light {label}: {counts}, {mean}")
        for i in range(FRAMES):
            phase(f"[34] image_light {label} frame {i + 1}: {frame_ms[i]:.2f} "
                  f"ms (CUDA events), {segs[i]} segments, "
                  f"{segs[i] / frame_ms[i] / 1e3:.2f} Mrays/s, {rbs[i]} "
                  f"readbacks ({smi})")
        phase(f"[34] image_light {label}: launches {counts}, image mean "
              f"{mean:.6f}")
        il_runs[label] = {"frame_ms": frame_ms, "segments": segs,
                          "readbacks": rbs, "launches": counts, "mean": mean}
    plain_mean, nee_mean = il_runs["plain"]["mean"], il_runs["nee_rr"]["mean"]
    phase(f"[34] image_light NEE + roulette: image mean {nee_mean:.6f} vs "
          f"plain {plain_mean:.6f} ({nee_mean / plain_mean - 1.0:+.3%})")
    if abs(nee_mean / plain_mean - 1.0) > 0.05:
        raise AssertionError("image_light: the NEE image's mean is more than "
                             "5% off")

    # ---- 35: P1, the reduced-precision sphere sweep probe ----
    cols, rows = p1.make_inputs(P1_RAYS, P1_SPHERES, 0, dev)
    cols_r, rows_r = p1.make_inputs(*P1_RAGGED, 1, dev)
    rows_miss = rows.clone()
    rows_miss[3] += 1e4  # every disc <= 0: the 1e30 branch
    p1_runs, t_f32 = {}, None
    for name, dtype in p1.DTYPES.items():
        t = p1.sphere_min_t(cols, rows, dtype)
        t_p = p1.sphere_min_t_plain(cols, rows, dtype)
        t_m = p1.sphere_min_t(cols, rows_miss, dtype)
        t_mp = p1.sphere_min_t_plain(cols, rows_miss, dtype)
        n_diff = int((t != t_p).sum()) + int((t_m != t_mp).sum())
        err = max(float((t - t_p).abs().max()), float((t_m - t_mp).abs().max()))
        t_f32 = t if t_f32 is None else t_f32
        outside, flips = p1.compare(t, t_f32)
        run = {"ms": _probe.event_ms(lambda: p1.sphere_min_t(cols, rows, dtype)),
               "plain_ms": time_ms(lambda: p1.sphere_min_t_plain(
                   cols, rows, dtype), 2),
               "max_abs_err": err, "rays_differing": n_diff,
               "share_outside_f32": outside, "miss_flips": flips,
               "all_miss_ok": bool((t_m == p1.MISS_T).all())}
        run["bound_ms"], run["bound_by"] = p1.bound(P1_RAYS, P1_SPHERES, dtype)
        run["issue_ceiling_ms"] = p1.issue_ceiling(P1_RAYS, P1_SPHERES, dtype)
        # a ragged ray count and an odd sphere count over two tiles
        t_r = p1.sphere_min_t(cols_r, rows_r, dtype)
        t_rp = p1.sphere_min_t_plain(cols_r, rows_r, dtype)
        run["ragged_rays_differing"] = int((t_r != t_rp).sum())
        run["ragged_ms"] = _probe.event_ms(
            lambda: p1.sphere_min_t(cols_r, rows_r, dtype))
        p1_runs[name] = run
        phase(f"[35] P1 {name}: {P1_RAYS} rays x {P1_SPHERES} spheres, "
              f"kernel vs plain {n_diff} rays differ (max |diff| {err}; the "
              f"all-miss rows: every t 1e30 {run['all_miss_ok']}); "
              f"share outside 1e-3 of f32 {outside:.6f}, miss flips {flips}; "
              f"kernel {run['ms']:.4f} ms, plain {run['plain_ms']:.3f} ms, "
              f"bound {run['bound_ms']:.4f} ms ({run['bound_by']}, "
              f"{run['bound_ms'] / run['ms']:.1%}), issue ceiling "
              f"{run['issue_ceiling_ms']:.4f} ms "
              f"({run['issue_ceiling_ms'] / run['ms']:.1%})")
        phase(f"[35] P1 {name} ragged: {P1_RAGGED[0]} rays x {P1_RAGGED[1]} "
              f"spheres, kernel vs plain {run['ragged_rays_differing']} rays "
              f"differ; kernel {run['ragged_ms']:.4f} ms")
        if n_diff or run["ragged_rays_differing"] or not run["all_miss_ok"]:
            raise AssertionError(f"P1 {name}: the kernel differs from its "
                                 "plain version")
    p1_regs = {("bf16" if "nv_bfloat16" in k else "f32"): v
               for k, v in nb.ptxas_usage("sphere_min_t_kernel").items()}
    p1_rays = {name: p1.kernel_rays_per_thread(dtype)
               for name, dtype in p1.DTYPES.items()}
    phase(f"[35] P1 registers and spills (ptxas): {p1_regs}; "
          f"rays a thread {p1_rays} (launcher), {p1.RAYS_PER_THREAD} "
          "(Python mirror)")
    if p1_rays != p1.RAYS_PER_THREAD:
        raise AssertionError(f"P1's launcher takes {p1_rays} rays a thread, "
                             f"its Python mirror {p1.RAYS_PER_THREAD}")
    phase(f"[35] P1 bf16 / f32 kernel time: "
          f"{p1_runs['bf16']['ms'] / p1_runs['f32']['ms']:.3f}")
    c35, probe_lines = probe_main("35", p1, [], k1, k2, k7)
    if c35["P1"] <= 0 or c35["plain"] != 0:
        raise AssertionError("bf16_probe did not run through P1")
    if [ln["bench"] for ln in probe_lines] != ["bf16_probe/f32",
                                               "bf16_probe/bf16"]:
        raise AssertionError("bf16_probe printed other lines")

    # ---- 36: P2-P4, the winner-attribute layout probes ----
    table, idx = p24.make_inputs(P24_RAYS, p24.TABLE_ROWS, p24.ATTRS, 0, dev)
    attrs = p24.gather_attrs(table, idx, 0)
    p24_runs = {}
    for name in p24.VARIANTS:
        laid = p24.LAYOUT[name](attrs)
        got, plain = p24.KERNEL[name](laid), p24.PLAIN[name](laid)
        n_diff = int((got != plain).sum())
        library = p24.LIBRARY[name]
        run = {"ms": _probe.event_ms(lambda: p24.KERNEL[name](laid)),
               "plain_ms": time_ms(lambda: p24.PLAIN[name](laid), 5),
               "layout_ms": _probe.event_ms(
                   lambda: p24.LAYOUT[name](p24.gather_attrs(table, idx, 0))),
               "library_ms": (None if library is None else
                              _probe.event_ms(lambda: library(laid))),
               "max_abs_err": float((got - plain).abs().max()),
               "library_max_abs_err": (None if library is None else float(
                   (library(laid) - plain).abs().max())),
               "bound_ms": p24.bound_ms(P24_RAYS, p24.ATTRS), "bound_by": "bytes"}
        run.update(_probe.alternated_cold_ms(p24.KERNEL[name], library,
                                             p24.cold_copies(laid)))
        p24_runs[name] = run
        phase(f"[36] {name}: {P24_RAYS} winners x {p24.ATTRS} attributes, kernel "
              f"vs plain {n_diff} elements differ; kernel {run['ms']:.4f} ms, "
              f"gather + layout {run['layout_ms']:.4f} ms, plain "
              f"{run['plain_ms']:.4f} ms, library {run['library_ms']} ms "
              f"(max |diff| {run['library_max_abs_err']}), bound "
              f"{run['bound_ms']:.4f} ms (bytes)")
        phase(f"[36] {name} cold, in turns with torch.sum: kernel "
              f"[min, median, max] {run['kernel_cold_ms']} ms, library "
              f"{run['library_cold_ms']} ms, kernel / library "
              f"{run['kernel_over_library']}")
        if n_diff:
            raise AssertionError(f"{name}: the kernel differs from its plain "
                                 "version")
        if library is not None and not torch.allclose(
                library(laid), plain, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{name}: torch.sum disagrees beyond 1e-5")
    c36, probe_lines = probe_main("36", p24, [], k1, k2, k7)
    if min(c36["P2"], c36["P3"], c36["P4"]) <= 0 or c36["plain"] != 0:
        raise AssertionError("split_probe did not run through P2, P3 and P4")
    if [ln["bench"] for ln in probe_lines] != [
            f"split_probe/{v}" for v in ("floor", *p24.VARIANTS)]:
        raise AssertionError("split_probe printed other lines")

    # ---- 37: the Threefry draw of the frames' primary rays ----
    draw_shapes = ((HEIGHT, WIDTH, SAMPLES, 2), (HEIGHT, WIDTH, SAMPLES, 3))
    draw_keys = tuple(tf.split(fold_in(PRNGKey(0), 1)))
    n_draws = sum(R * s_[-1] for s_ in draw_shapes)
    for label, key_, shape in zip(("jitter", "lens/time"), draw_keys,
                                  draw_shapes):
        u = tf.uniform(key_, shape, dev)
        b = tf.bits(key_, shape, dev)
        ref_b = tf.bits_plain(key_, shape, dev)  # the plain twin, compared
        same = (torch.equal(b, ref_b) and torch.equal(
            u.view(torch.int32), tf.uniform_from_bits(ref_b).view(torch.int32)))
        phase(f"[37] threefry {label} {tuple(shape)}: bits and uniforms "
              f"equal to the plain twin: {same}; uniforms in "
              f"[{float(u.min())}, {float(u.max())}]")
        if not same:
            raise AssertionError(f"the Threefry kernel differs ({label})")
        del u, b, ref_b

    def frame_draw(draw):
        return [draw(k_, s_) for k_, s_ in zip(draw_keys, draw_shapes)]

    rng = torch.Generator(device=dev)
    rng.manual_seed(0)
    tf_ms = time_ms(lambda: frame_draw(lambda k_, s_: tf.uniform(k_, s_, dev)),
                    20)
    tf_plain_ms = time_ms(lambda: frame_draw(
        lambda k_, s_: tf.uniform_plain(k_, s_, dev)), 3)
    rand_ms = time_ms(lambda: frame_draw(
        lambda k_, s_: torch.rand(s_, generator=rng, device=dev)), 20)
    tf_ys = nb.threefry_yardsticks(n_draws)
    tf_regs = kernel_registers(build_log, "threefry_kernelI")
    phase(f"[37] threefry time of a frame's draw ({n_draws} uniforms, 2 "
          f"launches): kernel {tf_ms:.4f} ms, plain twin {tf_plain_ms:.3f} "
          f"ms, torch.rand of the same shapes {rand_ms:.4f} ms; bound "
          f"{tf_ys['bound_ms']:.4f} ms ({tf_ys['bound_by']}, "
          f"{tf_ys['bound_ms'] / tf_ms:.1%}; bytes alone "
          f"{tf_ys['bytes_ms']:.4f} ms); registers {tf_regs} ({smi})")

    # ---- 38: the port's frames on the card against the pixel goldens ----
    gw, gh, gs, gd = 64, 48, 8, 8
    golden_share = {}
    # final_full: the fast path refuses it (an image texture in a scene
    # with boxes and media); phase 41 holds its general golden
    for preset in [n for n in presets.names() if n != "final_full"]:
        golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                      f"pixels_{preset}_fast.npz"))["img"]
        scene_, cam_ = presets.from_name(preset, gw / gh, seed=0)
        scene_ = scene_.to(dev)
        img = fp.render_frame_fast(scene_, cam_, gw, gh, gs, gd, PRNGKey(0),
                                   0, SceneFeatures.from_scene(scene_)).image
        img = img.cpu().double()
        ref_ = torch.from_numpy(golden).double()
        outside = ~((img - ref_).abs() <= ATOL + RTOL * ref_.abs()).all(dim=-1)
        b = XL_DEPTH10_BUDGET if preset == "random_spheres_xl" else DEPTH10_BUDGET
        budget = 1.0 - (1.0 - b) ** gs
        share = float(outside.double().mean())
        golden_share[preset] = share
        phase(f"[38] {preset}: {int(outside.sum())} of {gw * gh} pixels "
              f"({share:.4%}) outside 1e-3 of the JAX golden (budget "
              f"{budget:.2%}), largest difference "
              f"{float((img - ref_).abs().max()):.6f}")
        if share > budget or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{preset}: the card's frame leaves the "
                                 "pixel golden")

    # ---- 39: K1, K2 and K7 on smallpt, aras and final ----
    sphere_runs = {}
    for name in ("smallpt", "aras"):
        scene_, cam_ = presets.from_name(name, WIDTH / HEIGHT)
        scene_ = scene_.to(dev)
        feats_ = SceneFeatures.from_scene(scene_)
        tables_ = fp.prep_tables(scene_, feats_)
        flags_ = fp.feature_flags(feats_)
        ro, rd, tm = generate_primary_rays(cam_, WIDTH, HEIGHT, SAMPLES,
                                           PRNGKey(0), device=dev)
        sst0 = fp.make_state(ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R))
        del ro, rd, tm
        st_, idx_, e0 = nearest_check("39", f"K1 {name}", tables_.soa, sst0,
                                      "primary")
        sst1 = scattered(tables_, flags_, sst0, st_, idx_)
        st1_, idx1_, e1 = nearest_check("39", f"K1 {name}", tables_.soa, sst1,
                                        "scattered")
        k1s_ms = time_ms(lambda: k1.sphere_nearest(tables_.soa,
                                                   sst0.planes[:6]), 20)
        k1s_plain_ms = time_ms(lambda: k1.sphere_nearest_plain(
            tables_.soa, sst0.planes[:6]), 2)
        k1s_ys = nb.yardsticks(tables_.soa, R)
        phase(f"[39] K1 {name} time at {R} rays x {tables_.soa.shape[1]} "
              f"slots: kernel {k1s_ms:.4f} ms, plain {k1s_plain_ms:.3f} ms, "
              f"bound {k1s_ys['bound_ms']:.4f} ms ({k1s_ys['bound_by']})")
        k2s = shade_check("39", f"K2 {name}", tables_, flags_, (
            ("primary", sst0, st_, idx_, 0), ("scattered", sst1, st1_, idx1_, 1)))
        del sst0, sst1
        _, k7s = k7_check("39", name)
        ref_ = np.load(os.path.join(ROOT, "tests", "goldens",
                                    f"torch_port_{name}.npz"))
        rays_ = tuple(torch.from_numpy(ref_[k]).to(dev)
                      for k in ("rays.ro", "rays.rd", "rays.time"))
        seed_, depth_ = int(ref_["seed"]), int(ref_["max_depth"])
        contract = (check_smallpt_contract if name == "smallpt" else
                    lambda *a: check_slice_contract(*a, DEPTH10_BUDGET))
        reset_counts(k1, k2, k7)
        res = fp.trace_fast(scene_, *rays_, seed_, depth_, feats_,
                            min_size=128)
        c39 = read_counts(k1, k2, k7)
        frac_w = contract(res.radiance.cpu().numpy(), res.ray_count,
                          ref_["radiance"], ref_["ray_count"], depth_)
        rad, segs = k7.trace_megakernel(k7.prep_tables(scene_), *rays_, seed_,
                                        depth_, feats_)
        frac_m = contract(rad.cpu().numpy(), segs, ref_["mega.radiance"],
                          ref_["mega.ray_count"], depth_)
        planes, alive = port_bounce_chain(scene_, *rays_, seed_, depth_)
        out = states_outside(planes.cpu().numpy(), alive.cpu().numpy(),
                             ref_["chain.planes"], ref_["chain.alive"])
        chain_budget = (SMALLPT_DEPTH10_BUDGET if name == "smallpt"
                        else DEPTH10_BUDGET)
        # K7 under a white sky, where each ray's radiance shows its path
        wtables = k7.prep_tables(white_sky(scene_))
        wrad, wsegs = k7.trace_megakernel(wtables, *rays_, seed_, depth_,
                                          feats_)
        wrad_p, wsegs_p = k7.trace_megakernel_plain(wtables, *rays_, seed_,
                                                    depth_, feats_)
        frac_white = check_slice_contract(
            wrad.cpu().numpy(), wsegs, ref_["white.radiance"],
            ref_["white.ray_count"], depth_, chain_budget)
        n_white_p, frac_white_p = rays_outside(wrad, wrad_p.cpu().numpy())
        white_err = float((wrad - wrad_p).abs().max())
        phase(f"[39] K7 {name} under a white sky: {frac_white:.4%} of rays "
              f"outside 1e-3 of JAX, {n_white_p} ({frac_white_p:.4%}) of "
              f"its plain version (max |diff| {white_err}), segments "
              f"{int(wsegs)} (plain {int(wsegs_p)}, JAX "
              f"{int(ref_['white.ray_count'])}); rays lit "
              f"{float((wrad.abs().amax(dim=1) > ATOL).double().mean()):.2%}")
        if (frac_white_p > chain_budget
                or abs(int(wsegs) - int(wsegs_p)) > n_white_p * depth_):
            raise AssertionError(f"{name}: K7 under a white sky leaves its "
                                 "plain version")
        phase(f"[39] {name} fixture ({len(ref_['radiance'])} rays, depth "
              f"{depth_}): wavefront {frac_w:.4%} and K7 {frac_m:.4%} of rays "
              f"outside 1e-3 of JAX, segments {int(res.ray_count)} / "
              f"{int(segs)} vs {int(ref_['ray_count'])} / "
              f"{int(ref_['mega.ray_count'])}; path states after {depth_} "
              f"bounces {int(out.sum())} ({out.mean():.4%}, budget "
              f"{chain_budget:.0%}); trace launches {c39}")
        if (out.mean() > chain_budget or c39["K1"] != depth_ + 1
                or c39["plain"]):
            raise AssertionError(f"{name}: the card's trace leaves its fixture")
        sphere_runs[name] = {
            "k1": {"max_abs_err": max(e0, e1), "ms": k1s_ms,
                   "plain_ms": k1s_plain_ms, "bound_ms": k1s_ys["bound_ms"],
                   "bound_by": k1s_ys["bound_by"]},
            "k2": k2s, "k7": k7s,
            "k7_white_sky": {"max_abs_err": white_err,
                             "lanes_outside": frac_white_p,
                             "segments": int(wsegs),
                             "plain_segments": int(wsegs_p)},
            "fixture_share_outside": {"wavefront": frac_w, "k7": frac_m,
                                      "k7_white_sky": frac_white,
                                      "path_states": float(out.mean())}}
    # final: one dead row; K1, K2 and K7 must leave every lane at the sky
    fscene, fcam = presets.final(WIDTH / HEIGHT)
    fscene = fscene.to(dev)
    ffeats = SceneFeatures.from_scene(fscene)
    ftables = fp.prep_tables(fscene, ffeats)
    ro, rd, tm = (x.reshape(R, -1).squeeze(-1) for x in generate_primary_rays(
        fcam, WIDTH, HEIGHT, SAMPLES, PRNGKey(0), device=dev))
    fst = fp.make_state(ro, rd, tm)
    ft, fidx = k1.sphere_nearest(ftables.soa, fst.planes[:6])
    fplanes, falive = k2.shade_from_winners(
        ftables.table, fidx, ft, fst.planes, fst.time, fst.alive, fst.lane, 7,
        0, DEPTH, ftables.sky4, fp.feature_flags(ffeats))
    frad, fsegs = k7.trace_megakernel(k7.prep_tables(fscene), ro, rd, tm, 7,
                                      DEPTH, ffeats)
    sky_t = 0.5 * (rd[:, 1] + 1.0)
    sky = torch.stack([(1.0 - sky_t) + sky_t * g_ for g_ in (0.15, 0.21, 0.30)],
                      dim=1)
    sky_err = (float((fplanes[6:9].T - sky).abs().max()),
               float((frad - sky).abs().max()))
    phase(f"[39] final ({ftables.soa.shape[1]} slots, none live): K1 misses "
          f"on {int((ft == ft.max()).sum())} of {R} rays (idx 0 on "
          f"{int((fidx == 0).sum())}); sky error K2 {sky_err[0]}, K7 "
          f"{sky_err[1]}; K7 segments {int(fsegs)}; K2 alive "
          f"{int(falive.sum())}")
    if (not bool((ft == float(np.float32(3.402823466e38))).all())
            or max(sky_err) > 1e-6 or int(fsegs) != R or bool(falive.any())):
        raise AssertionError("final: a lane left the sky")
    del ro, rd, tm, fst, fplanes, frad

    # ---- 40: smallpt and aras through the CLI; a stratified frame ----
    cli_runs = {}
    for name, extra in (("smallpt", []), ("aras", []),
                        ("aras", ["--stratify"])):
        label = name + ("_stratify" if extra else "")
        with tempfile.TemporaryDirectory() as tmp:
            out_path = os.path.join(tmp, f"{label}.npy")
            argv = ["-P", name, "-W", str(WIDTH), "-H", str(HEIGHT),
                    "-S", str(SAMPLES), "-D", str(DEPTH), "-O", "-F",
                    str(FRAMES), "--out", out_path, *extra]
            reset_counts(k1, k2, k7)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            counts = read_counts(k1, k2, k7)
            image = np.load(out_path) if rc == 0 else None
        log = buf.getvalue()
        frames_ = [(float(ms), int(rays)) for ms, rays in re.findall(
            r"frame \d+/\d+: ([\d.]+) ms, (\d+) rays", log)]
        finite = image is not None and bool(np.isfinite(image).all())
        mean = float(image.mean()) if finite else float("nan")
        for i, (ms, rays) in enumerate(frames_):
            phase(f"[40] {label} frame {i + 1}: {ms:.2f} ms (CUDA events), "
                  f"{rays} rays, {rays / ms / 1e3:.2f} Mrays/s")
        phase(f"[40] {label}: launches {counts}, image mean {mean:.6f}, "
              f"finite {finite}")
        others = [counts[k] for k in ("K3", "K4", "K5", "K6", "K7")]
        if (rc != 0 or not finite or len(frames_) != FRAMES
                or counts["K1"] <= 0 or counts["K2"] <= 0 or any(others)
                or counts["threefry"] != FRAMES * (4 if extra else 2)
                or counts["plain"]):
            raise AssertionError(f"{label}: the CLI run failed its checks")
        cli_runs[label] = {"frame_ms": [ms for ms, _ in frames_],
                           "segments": [r for _, r in frames_],
                           "launches": counts, "image_mean": mean}
    ratio = cli_runs["aras_stratify"]["image_mean"] / cli_runs["aras"]["image_mean"]
    phase(f"[40] aras stratified / iid image mean: {ratio:.4f}")
    if abs(ratio - 1.0) > 0.05:
        raise AssertionError("the stratified aras image's mean moved")

    # ---- 41: the general integrator's frames against the general goldens ----
    general_share, general_golden_counts = {}, {}
    for preset in presets.names():
        golden = np.load(os.path.join(ROOT, "tests", "goldens",
                                      f"pixels_{preset}_general.npz"))["img"]
        scene_, cam_ = presets.from_name(preset, gw / gh, seed=0)
        scene_ = scene_.to(dev)
        feats_ = SceneFeatures.from_scene(scene_)
        reset_counts(k1, k2, k7)
        img, count_ = render_frame(scene_, cam_, gw, gh, gs, gd, PRNGKey(0),
                                   features=feats_)
        c41 = read_counts(k1, k2, k7)
        img = img.cpu().double()
        ref_ = torch.from_numpy(golden).double()
        outside = ~((img - ref_).abs() <= ATOL + RTOL * ref_.abs()).all(dim=-1)
        b = XL_DEPTH10_BUDGET if preset == "random_spheres_xl" else DEPTH10_BUDGET
        budget = 1.0 - (1.0 - b) ** gs
        share = float(outside.double().mean())
        general_share[preset] = share
        general_golden_counts[preset] = c41
        phase(f"[41] {preset} (general): {int(outside.sum())} of {gw * gh} "
              f"pixels ({share:.4%}) outside 1e-3 of the JAX golden (budget "
              f"{budget:.2%}), largest difference "
              f"{float((img - ref_).abs().max()):.6f}; {int(count_)} segments; "
              f"launches K1 {c41['K1']}, K3 {c41['K3']}, threefry "
              f"{c41['threefry']}, plain {c41['plain']}")
        sweep = c41["K3"] if feats_.has_motion else c41["K1"]
        if (share > budget or not bool(torch.isfinite(img).all())
                or c41["plain"] or c41["K2"] or c41["K7"]
                or (feats_.has_spheres and sweep <= 0)):
            raise AssertionError(f"{preset}: the card's general frame leaves "
                                 "its golden or its kernels")

    # ---- 42: the general path at full width through render_progressive ----
    def profiled(fn):
        """(wall ms, device busy ms, device launches, top kernels) of one
        call of ``fn`` under torch.profiler."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ = (time.perf_counter() - t0) * 1e3
        evts = [e for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")]
        dev_us = [(float(getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))),
                   e.count, e.key) for e in evts]
        dev_us.sort(reverse=True)
        return (wall_, sum(u for u, _, _ in dev_us) / 1e3,
                sum(c for _, c, _ in dev_us),
                [{"name": n[:80], "launches": c, "ms": u / 1e3}
                 for u, c, n in dev_us[:6]])

    general_runs = {}
    for gname, gmode, gframes in (("random_spheres", "general", FRAMES),
                                  ("final_full", "auto", 1)):
        scene_, cam_ = presets.from_name(gname, WIDTH / HEIGHT)
        params_ = Params(width=WIDTH, height=HEIGHT, samples=SAMPLES,
                         max_depth=DEPTH)
        reset_counts(k1, k2, k7)
        b0, r0 = gint.BOUNCES, gint.READBACKS
        t_start = time.monotonic()
        res = render_progressive(scene_, cam_, params_, max_frames=gframes,
                                 device=dev, mode=gmode,
                                 log=lambda ln: phase(f"[42] {gname}: {ln}"))
        wall = time.monotonic() - t_start
        c42 = read_counts(k1, k2, k7)
        bounces = gint.BOUNCES - b0
        finite = bool(np.isfinite(res.image).all())
        mean = float(res.image.mean())
        sweep = "K3" if gname == "final_full" else "K1"
        mrays = [res.total_rays / gframes / ms / 1e3 for ms in res.frame_ms]
        phase(f"[42] {gname} (--mode {gmode} -> {res.path}): {gframes} frames "
              f"of {WIDTH}x{HEIGHT}x{SAMPLES} depth {DEPTH} in {wall:.2f} s; "
              f"frame ms {[round(x, 3) for x in res.frame_ms]} (CUDA events), "
              f"{res.total_rays} segments, Mrays/s {[round(x, 2) for x in mrays]}; "
              f"{bounces} bounces, readbacks {res.readbacks}; launches {c42}; "
              f"image mean {mean:.6f}, finite {finite} ({smi})")
        if (res.path != "general" or not finite or c42["plain"]
                or c42[sweep] <= 0 or c42["K2"] or c42["K7"]):
            raise AssertionError(f"{gname}: the general frame failed its checks")
        general_runs[gname] = {
            "mode": gmode, "path": res.path, "frame_ms": res.frame_ms,
            "segments": res.total_rays, "mrays_per_s": mrays,
            "bounces": bounces, "readbacks": res.readbacks,
            "launches": c42, "image_mean": mean}
        if gname == "final_full":
            # its ~430,000 launches a frame keep the profiler busy for
            # ~110 s: `profile_step --what general --preset final_full`
            # measures its busy time and idle share instead
            phase(f"[42] {gname}: device busy time and idle share not "
                  "measured here (tools/profile_step.py --what general)")
            continue
        # one more frame of the same scene under the profiler: the device's
        # busy time, its idle share and its launches a bounce
        sdev, feats_ = scene_.to(dev), SceneFeatures.from_scene(scene_)
        b0, t_prof = gint.BOUNCES, time.monotonic()
        wall_ms, busy_ms, n_launch, top = profiled(lambda: render_frame(
            sdev, cam_, WIDTH, HEIGHT, SAMPLES, DEPTH,
            fold_in(PRNGKey(0), 7), features=feats_))
        nb_ = gint.BOUNCES - b0
        phase(f"[42] {gname} profiled frame: wall {wall_ms:.2f} ms, device "
              f"busy {busy_ms:.2f} ms (idle {1.0 - busy_ms / wall_ms:.1%}; of "
              f"the unprofiled median {1.0 - busy_ms / float(np.median(res.frame_ms)):.1%}), "
              f"{n_launch} device launches over {nb_} bounces "
              f"({n_launch / max(nb_, 1):.0f} a bounce), "
              f"{time.monotonic() - t_prof:.1f} s with the profiler's own "
              f"work; top {top}")
        general_runs[gname].update(
            profiled_wall_ms=wall_ms, busy_ms=busy_ms,
            device_launches=n_launch, bounces_profiled=nb_, top_kernels=top)
        del sdev

    # ---- 43: trace_diff on the card: the camera's vfov gradient ----
    def vfov_grad(device):
        bld = SceneBuilder()
        bld.sphere((0.0, 0.0, -4.0), 4.0, bld.lambertian_color((0.4, 0.5, 0.6)))
        sc = bld.finish().to(device)
        fov = torch.tensor(40.0, requires_grad=True)
        cam_ = make_camera((0.0, 0.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                           fov, 1.0, 0.0, 3.0)
        img, _ = render_frame(sc, cam_, 24, 24, 4, 3, PRNGKey(6),
                              differentiable=True,
                              features=SceneFeatures.from_scene(sc))
        (g,) = torch.autograd.grad(img.mean(), fov)
        return float(g)

    g_cpu = vfov_grad("cpu")
    reset_counts(k1, k2, k7)
    g_card = vfov_grad(dev)
    c43 = read_counts(k1, k2, k7)
    rel_g = abs(g_card - g_cpu) / max(abs(g_cpu), 1e-30)
    # jax.grad of the reference's loss at the same key and point
    g_jax = float(np.load(CAMERA_GRAD_FIXTURE)["vfov"])
    rel_j = abs(g_card - g_jax) / abs(g_jax)
    phase(f"[43] trace_diff vfov gradient: card {g_card!r}, CPU port "
          f"{g_cpu!r} (rel {rel_g:.3e}), JAX {g_jax!r} (rel {rel_j:.3e}); "
          f"launches {c43}")
    if (not np.isfinite(g_card) or rel_g > 1e-3 or rel_j > 1e-3
            or c43["K6"] <= 0 or c43["K1"] <= 0 or c43["plain"]):
        raise AssertionError("the card's trace_diff gradient failed its checks")

    inv = inverse_phases(dev, smi)
    sil_k1, sil_k3, c45, c45s = (inv[k] for k in ("sil_k1", "sil_k3", "c45",
                                                  "c45s"))
    geo_run, diff_runs, sil_runs = (inv[k] for k in ("geo_run", "diff_runs",
                                                     "sil_runs"))

    kernels = [
        {"name": "sphere_nearest", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/sphere_nearest.cu",
         "replaces": "pathtrace_tpu/ops/intersect_pallas.py:50",
         "launches": launches[0], "train_launches": train_launches[0],
         "simple_light_launches": c27["K1"],
         "simple_light_nee_launches": c27n["K1"],
         "max_abs_err": max(err_a, err_b),
         "simple_light_max_abs_err": max(k1l_err_a, k1l_err_b, k1l_err_c),
         "simple_light_ms": k1l_ms, "simple_light_plain_ms": k1l_plain_ms,
         "simple_light_bound_ms": k1l_bound[0],
         "simple_light_bound_by": k1l_bound[1],
         "ms": k1_ms, "ms_scattered": k1_ms_scattered,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "issue_ceiling_ms": k1_ceiling,
         "registers": k1_regs, "library_ms": None,
         "general_launches": general_runs["random_spheres"]["launches"]["K1"],
         "general_golden_launches": {n_: c_["K1"] for n_, c_ in
                                     general_golden_counts.items()},
         "silhouette_launches": sil_k1,
         "geometry_train_launches": c45["K1"],
         "geometry_silhouette_launches": c45s["K1"],
         "diff_scene_launches": {n_: r_["launches"]["K1"]
                                 for n_, r_ in diff_runs.items()},
         "sphere_presets": {n_: {**r_["k1"],
                                 "cli_launches": cli_runs[n_]["launches"]["K1"]}
                            for n_, r_ in sphere_runs.items()}},
        {"name": "sphere_nearest_moving (K3)", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/sphere_nearest.cu",
         "replaces": "pathtrace_tpu/ops/intersect_pallas.py:340",
         "launches": c17["K3"], "train_launches": c20["K3"],
         "max_abs_err": max(k3_err_a, k3_err_b),
         "ms": k3_ms, "ms_scattered": k3_ms_scattered,
         "plain_ms": k3_plain_ms, "k1_ms": k3_k1_ms,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "issue_ceiling_ms": k3_ceiling, "registers": k3_regs,
         "general_launches": general_runs["final_full"]["launches"]["K3"],
         "silhouette_launches": sil_k3,
         "library_ms": None},
        {"name": "shade_from_winners", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/shade.cu",
         "replaces": "pathtrace_tpu/ops/shade_pallas.py:92",
         "launches": launches[1], **k2_run,
         "motion_launches": c17["K2"],
         **{f"motion_{k}": v for k, v in k2m_run.items()},
         "flags": {"FLAG_RECT": k2.FLAG_RECT,
                   "FLAG_EMIT_SCALE": k2.FLAG_EMIT_SCALE,
                   "FLAG_BOX": k2.FLAG_BOX, "FLAG_MEDIUM": k2.FLAG_MEDIUM},
         "rect_launches": c27["K2"],
         **{f"rect_{k}": v for k, v in k2r_run.items()},
         "emit_scale_launches": c27n["K2"],
         **{f"emit_scale_{k}": v for k, v in k2e_run.items()},
         "noise": k2n_run,
         "registers": next(iter(nb.ptxas_usage("shade_kernel").values()),
                           None),
         "box_launches": box_runs["box"]["plain_launches"],
         "medium_launches": box_runs["medium"]["plain_launches"],
         "box": box_runs["box"], "medium": box_runs["medium"],
         "box_media_fixture_share_outside": box_runs["fixture_share_outside"],
         "sphere_presets": {n_: {**r_["k2"],
                                 "cli_launches": cli_runs[n_]["launches"]["K2"],
                                 "fixture_share_outside":
                                     r_["fixture_share_outside"]}
                            for n_, r_ in sphere_runs.items()},
         "library_ms": None},
        {"name": "sphere_nearest_bwd", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/sphere_nearest_bwd.cu",
         "replaces": "pathtrace_tpu/ops/intersect_pallas.py:670",
         "launches": train_launches[1], "max_abs_err": k6_err,
         "max_ulp": k6_ulp, "sphere_rel_l2": k6_sph,
         "ms": k6_ms, "plain_ms": k6_plain_ms, "bound_ms": k6_bound[0],
         "bound_by": k6_bound[1], "issue_ceiling_ms": k6_ys["issue_ceiling_ms"],
         "blocks": k6_launch[0], "shared_sums": k6_launch[1],
         "registers": kernel_registers(build_log,
                                       "sphere_nearest_bwd_kernelI"),
         "motion_launches": c20["K6"],
         "motion_max_abs_err": k6m_err, "motion_max_ulp": k6m_ulp,
         "motion_sphere_rel_l2": k6m_sph, "motion_ms": k6m_ms,
         "motion_plain_ms": k6m_plain_ms, "motion_bound_ms": k6m_bound[0],
         "motion_bound_by": k6m_bound[1],
         "motion_issue_ceiling_ms": k6m_ys["issue_ceiling_ms"],
         "general_launches": c43["K6"], "general_vfov_grad_rel": rel_g,
         "geometry_train_launches": c45["K6"], "geometry_train": geo_run,
         "diff_scene_launches": {n_: r_["launches"]["K6"]
                                 for n_, r_ in diff_runs.items()},
         "diff_scenes": diff_runs, "silhouette": sil_runs,
         "library_ms": None},
        {"name": "sphere_nearest_culled (K4, flat)", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/sphere_nearest_culled.cu",
         "replaces": "pathtrace_tpu/ops/intersect_pallas.py:111",
         **k4, "library_ms": None},
        {"name": "sphere_nearest_culled (K5, two-level)", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/sphere_nearest_culled.cu",
         "replaces": "pathtrace_tpu/ops/intersect_pallas.py:212",
         **k5, "library_ms": None},
        {"name": "megakernel (K7)", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/megakernel.cu",
         "replaces": "pathtrace_tpu/ops/megakernel.py:264",
         "launches": c24["K7"], "launches_per_frame": c24["K7"] // (3 * FRAMES),
         **k7_runs["random_spheres"],
         "random": k7_runs["random"], "simple_light": k7_runs["simple_light"],
         "registers": kernel_registers(build_log, "megakernelI"),
         "frame_ms": k7_frames,
         "sphere_presets": {n_: {**r_["k7"], "white_sky": r_["k7_white_sky"]}
                            for n_, r_ in sphere_runs.items()},
         "library_ms": None},
        {"name": "shade_from_winners, image branch (FLAG_IMAGE)",
         "route": "cuda", "source": "pathtrace_tpu_torch/csrc/shade.cu",
         "replaces": "pathtrace_tpu/ops/shade_pallas.py:116",
         "launches": earth_runs["default map"]["launches"]["K2"],
         **img_runs["earth"]["plain"],
         "emit_scale": img_runs["earth"]["emit_scale"],
         "texel_flips": img_runs["earth"]["texel_flips"],
         "image_lanes": img_runs["earth"]["image_lanes"],
         "prepass_plain_ms": img_runs["earth"]["prepass_plain_ms"],
         "prepass_launches": img_runs["earth"]["prepass_launches"],
         "image_light": img_runs["image_light"],
         "image_light_launches": il_runs["nee_rr"]["launches"]["K2"],
         "fixture_share_outside": img_runs["fixture_share_outside"],
         "earth_frames": earth_runs, "image_light_frames": il_runs,
         "library_ms": None},
        {"name": "sphere_min_t (P1, bf16 probe)", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/bf16_probe.cu",
         "replaces": "tools/bf16_probe.py:37", "launches": c35["P1"],
         **p1_runs["f32"], "bf16": p1_runs["bf16"],
         "max_abs_err": max(r["max_abs_err"] for r in p1_runs.values()),
         "rays_per_thread": p1_rays, "registers": p1_regs,
         "library_ms": None},
        {"name": "threefry", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/threefry.cu",
         "replaces": "jax.random.uniform (XLA)",
         "launches": c6["threefry"], "max_abs_err": 0.0,
         "draws": n_draws, "ms": tf_ms, "plain_ms": tf_plain_ms,
         "bound_ms": tf_ys["bound_ms"], "bound_by": tf_ys["bound_by"],
         "bytes_ms": tf_ys["bytes_ms"], "torch_rand_ms": rand_ms,
         "registers": tf_regs, "library_ms": None,
         "golden_pixel_share_outside": golden_share,
         "general_launches": general_runs["random_spheres"]["launches"][
             "threefry"],
         "general_final_full_launches": general_runs["final_full"][
             "launches"]["threefry"],
         "general_golden_pixel_share_outside": general_share,
         "general_frames": general_runs},
        *[{"name": f"sum_{name.split('_')[0]} ({pid}, split probe)",
           "route": "cuda", "source": "pathtrace_tpu_torch/csrc/split_probe.cu",
           "replaces": f"tools/split_probe.py:{line}", "launches": c36[pid],
           **p24_runs[name]}
          for pid, name, line in (("P2", "split", 70), ("P3", "minor_t", 95),
                                  ("P4", "major_t", 122))],
    ]
    phase(f"[t] seconds by phase (each line's time since the last line, "
          f"summed by tag): {json.dumps({k: round(v, 1) for k, v in PHASE_SECONDS.items()})}; "
          f"total {time.monotonic() - _T0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
