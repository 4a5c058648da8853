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
   (warp trees, the block's warps in turn, then the blocks' rows: another
   order, a fixed one); K6's time, its share
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
    "general"`` (3 frames) and ``final_full`` with ``mode="general"`` (1
    frame; ``auto`` takes the fast path, phase 65), 1280x720, 4 spp, depth 10: frame
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
    same deterministic algorithms equal bit for bit (K6 sums in a fixed
    order).

48. the whole-scene BVH's native trees (``utils/native.py``, SAH) of
    ``random_spheres``, ``random_spheres_xl``, ``cornell_smoke`` and
    ``final_full``: builder (it must be the native one), build seconds,
    census; ``random_spheres``' and ``cornell_smoke``'s equal to the numpy
    SAH tree;
49. the traversal kernel (``csrc/bvh_traverse.cu``) against its plain
    version on the 1280x720x4 camera rays and one bounce of scattered rays
    (``tools/bvh_bench.traverse_sets``: through K2 from the tree's
    winners; ``final_full``'s through the general bounce) of
    ``random_spheres``, ``random``, ``random_spheres_xl``, ``cornell``,
    ``cornell_smoke`` and ``final_full``: t, gid and the nodes each ray
    visits equal bit for bit; the kernel's median time, and its time in
    turns against the parent tree's kernel (``build/parent``'s source,
    built alone beside the package's build; 5 rounds of parent, this,
    this, parent, 10 launches a turn queued behind a device sleep, so the
    events time the device), the plain version's, mean and max visits,
    the leaf tests by kind, the bound (``ops/bvh_kernel.yardsticks``: 24
    operations a visit
    and 18-80 a leaf test at the 33.5 T/s issue rate, against the rays'
    bytes, the results' and the operand's), the launch
    (``pt_bvh_traverse_plan``: grid and instance) and ptxas's registers
    of each instance; without a parent tree the kernel is timed alone;
50. ``cli.main`` with ``-B`` renders ``random_spheres`` and
    ``random_spheres_xl`` at 1280x720, 4 spp, depth 10, 3 frames (the
    traversal kernel and K2 launched, no K1, K4, K5 or plain version),
    then the same without ``-B`` and in raster order (``CULL_MIN_TILES``
    patched high: K1 over every sphere; xl's tile order would rename the
    lanes, hence their samples): frame times, launches a frame,
    readbacks, and the ``-B`` image against the brute one within the
    per-pixel budget of its 12 samples; then both scenes' ``-B`` frames
    (``render_frame_fast``) in turns against the same frames through the
    parent tree's traversal and turbulence kernels (5 rounds of parent,
    this, this, parent; ``frames_in_turns``), the images equal bit for
    bit;
51. ``config4_1024spp_bvh``'s schedule (``random_spheres`` 200x100, 128
    spp a frame x 8 frames, depth 10) through ``cli.main`` with and without
    ``-B``: seconds to 1024 spp, Mrays/s;
52. the general route: ``cli.main -P final_full -B --mode compacted`` at
    1280x720x4, depth 10 (compacted + BVH: the traversal kernel, no K2,
    no plain version; ``auto`` takes the fast path, phase 67) and a
    profiled compacted frame (device busy, launches a bounce); ``cornell_smoke -B --nee --rr 3`` (3 frames: the traversal
    kernel for the bounces and the shadow rays, and K2), a profiled
    frame, and its frames in turns against the parent tree's kernels;
53. the device-only fast trace (``fastpath.trace_fast_device``: every
    bounce over every lane, no readback, compaction or cull) of
    ``random_spheres`` (K1) and ``random`` (K3) at 1280x720x4, depth 10:
    one shard against a mesh of 4 virtual shards on the card
    (``parallel.mesh.trace_sharded``), bit for bit in radiance and
    segments, then against the ladder's ``trace_fast`` on the same rays
    and seed (rays outside 1e-3, whether bit for bit), with the median
    times of the three and the launches (11 K1 or K3 and 11 K2 a trace);
54. ``cli.main --mode sharded`` at 1280x720x4, depth 10: 3 frames of
    ``random_spheres`` (fast shards: K1, K2), 3 with ``-B`` (the
    traversal kernel, K2) and one of ``final_full`` (general shards: K3
    and the plane loops), frame times, path and launches;
55. the same ``random_spheres`` command through ``torchrun
    --nproc_per_node=1 --standalone`` with ``--distributed`` (an NCCL
    group of world size 1): its image must equal phase 54's bit for bit;
56. one train step of ``random_spheres`` (every default leaf, depth 4,
    1280x720x4) on a one-shard and a 4-shard mesh of the card: loss and
    gradients within ``GRAD_TOL`` of each other (the shards sum in
    another order),
    step time and peak memory; then ``parallel.dryrun.dryrun_multichip``
    on 4 virtual shards;
57. ``cli.main --adaptive 16`` on ``random_spheres`` and ``cornell`` at
    1280x720, ``-S 4``, depth 10: 10 rounds, spp min/mean/max, the total
    time and its split (warmup, refinement rounds, the metric's readback,
    the host's ``argpartition``); K2 launched (and K1 on the sphere
    scene), no plain version;
58. ``cli.main -P cornell --nee --aovs --denoise -O``: the three AOV PNGs
    at full size, the AOV and denoise times, and the denoised image's
    display-domain MSE against 16 x 4 spp under another seed, which must
    be lower than the raw 4-spp image's (``tests/test_denoise.py:33``);
    then ``render_aovs`` of ``random_spheres`` (1 K1) and ``random`` (1
    K3) at 1280x720 (median ms), and on the card against the CPU port
    at 64x48x2 (at most 0.5% of pixels outside 1e-3);
59. the interactive CLI (``-F 5``, no ``-O``) of ``random_spheres`` three
    times: ``--no-preview``, the preview on a free port and unviewed,
    and viewed by a thread that polls ``/stats.json`` and fetches each
    new ``/frame.png``; the frame times of the three, the fetches and
    their ms; each PNG the thread fetched while the loop ran must equal
    the sRGB of a whole frame, the one ``/stats.json`` named or a later
    one (each frame's accumulation is copied on the loop's stream by
    ``on_frame``, no sync); then 3 frames of
    ``render_progressive(preview=True)`` whose ``on_frame`` fetches: the
    served PNG must be that frame's accumulation;
60. ``-X`` of ``small``, ``cornell`` and ``cornell -B`` at 1280x720 on
    the card against the CPU port's lines
    (``torch_port_util.assert_trace_lines_match``), whether identical;
61. ``render_image(preset="random_spheres")`` == the CLI's ``-O``
    ``.npy`` bit for bit;
62. 3 frames of ``random_spheres`` with ``--group 2``, ``--group 3`` and
    ``--no-compaction``, each bit for bit the default's, with frame
    times and readbacks;
63. ``--profile-dir``: the Chrome trace names ``sphere_nearest_kernel``
    and ``shade_kernel`` as often as K1 and K2 launched;
64. ``render_adaptive`` of ``random_spheres`` and ``cornell`` at 64x48,
    2 samples a round, depth 10, budget 8, on the card replaying the CPU
    port's picks: the card's own pick of each round holds >= 99% of the
    CPU's pixels, the spp maps agree on >= 99%, the images agree under
    the golden-pixel budget; the free run's spp agreement is printed
    (the pick's order parts the runs where a metric's last bit does);
65. ``final_full`` on ``auto`` -> fast (``route`` with and without
    ``-B``; the non-fused bounce, ``fastpath.fast_bounce`` on [R, 3]
    state): ``tools/profile_step.main --what frame --preset final_full``
    at 1280x720x4, depth 10 (1 warm-up, 3 timed frames, 1 profiled: frame
    median, readbacks, busy, idle, device launches a bounce, the top
    kernels), K3's launches over those 5 frames (no K1, no K2, no plain
    version); then its 64x48x8 depth-8 frame on the card against
    ``tests/goldens/pixels_final_full_fast.npz`` and against the CPU
    port's frame, each within the golden-pixel budget;
66. ``final_full --nee --rr 3`` on the same route: the card's
    ``trace_fast`` of ``tests/goldens/torch_port_nonfused.npz``'s 2048
    rays against JAX's radiance (``DEPTH10_BUDGET``), then a full-width
    frame after a warm-up (K3, no K2, no plain version);
67. ``final_full -B``: ``render_frame_fast`` with the tree as the
    non-fused bounce's provider (the traversal kernel, no K3, no K2) in
    turns against ``render_frame_compacted`` with the tree (the route of
    ``--mode compacted``), 5 rounds of compacted, fast, fast, compacted,
    then the fast frame in turns against the parent tree's traversal and
    turbulence kernels;
68. the [R, N] box and media sweeps (``intersect_box.box_nearest_rn``,
    ``media_nearest_rn``) and the box and media kernel against the plane
    loops for N = 2, 4, 8, 16, 32, 64 and 400 (``final_full``'s first N
    boxes; N of 400 random slab and sphere media over its floor) on its
    3,686,400 camera rays: equal bit for bit, the medians of the three at
    full width and at 131,072 rays, and the forms' crossover (the port's
    sweeps take the kernel on the card; the [R, N] form is its plain
    version, the loop their reference);
69. NEE for textured lights: ``presets.image_light_scene(
    textured_light=True)`` (fused: K1 and K2) and with ``box=True``
    (non-fused: K1, no K2) against the fixture's JAX radiance, then a
    median full-width frame of each;
70. K6's fixed-order sums: on ``random_spheres``' and ``random``'s camera
    and scattered winners at full width, three runs equal bit for bit,
    per-ray gradients == plain, per-sphere sums within
    ``K6_SPHERE_RTOL``, the kernel's time in turns against the parent
    tree's K6 (``build/parent``, built alone; when present); two
    ``--geometry`` train steps (1280x720x4, depth 4, the silhouette term,
    deterministic algorithms) from one state bit for bit; the example's
    ``--geometry`` 4 steps == 2 + checkpoint + 2 bit for bit;
71. the wide-node tree's traversal kernel (``csrc/bvh_wide_traverse.cu``)
    against its plain version (t, gid and visits bit for bit) and against
    the flat tree's kernel ((t, gid) bit for bit) on 3,686,400 camera
    rays and one bounce of scattered rays of ``random_spheres``, xl,
    ``random`` (motion, ``leaf_m`` 4), ``cornell_smoke`` (media leaves)
    and ``final_full``: both kernels' medians, the plain version's time,
    nodes and visits a ray of both trees, the bound
    (``bvh_kernel.wide_yardsticks``) and the kernel's share of it, and its
    registers;
72. full-width frames (1280x720x4, depth 10) of ``random_spheres`` and
    xl through ``render_frame_fast(bvh=wide)`` equal the flat tree's bit
    for bit, timed in turns; the wide kernel and K2 launched, no K1, no
    flat traversal, no plain version;
73. the interleaved ladder: ``tools/ladder_ab.run_pairs`` on full-width
    ``random_spheres`` frames (one frame key): the one ladder against
    chunks of 2^21 and 2^20, and ``-B`` (one ladder) at the three tiers'
    thresholds against 0.35 for every tier, each pair equal bit for bit,
    in 5 rounds of A, B, B, A, with readbacks and segments a frame;
74. the box and media kernel (``csrc/box_media_nearest.cu``) against the
    plain [R, N] forms, (t, idx) of each kind bit for bit, on
    ``final_full``'s 3,686,400 camera rays and one non-fused bounce's
    scattered rays, ``cornell`` (boxes) and ``cornell_smoke`` (box media)
    camera rays, a ragged 2^20 + 3, one box and one medium, 1000 boxes and
    500 media (several shared-memory tiles, masked entries) and each kind
    alone; the kernel's time (alone and with the flights' plain launches),
    the plain forms' and the bound (``box_media_kernel.yardsticks``: 84
    operations a (ray, box) pair, 114 a (ray, medium) pair, at 33.5 T/s)
    on ``final_full``'s two ray sets; the winners' t recomputed under
    autograd == the kernel's; ``trace_fast_diff`` of
    ``torch_port_util.marble_smoke_scene`` through the kernels == through
    the [R, N] forms (radiance bit for bit, every box and media leaf's
    gradient within relative L2 1e-5);
75. the turbulence kernel (``csrc/turb.cu``) against ``fast_turb_c``
    masked by the winners' noise texture, bit for bit, on the points of
    ``final_full``'s camera and scattered hits (and a ragged 2^20 + 3 of
    each; and on the camera hits' points with no noise lane, every lane
    noise and one noise lane, each twice), with the kernel's time, its
    time in turns against the parent tree's kernel (5 rounds of parent,
    this, this, parent, 20 launches a turn queued behind a device
    sleep), the plain version's and the bound's
    (``turb_kernel.yardsticks``: 1708 operations a noise lane), and both
    kernels' ptxas registers and spills;
76. ``final_full`` at 1280x720x4, depth 10, plain and ``--nee --rr 3``:
    5 rounds of general, fast, fast, general (``render_frame`` against
    ``render_frame_fast``, the route ``auto`` takes), device launches a
    bounce of both and of one fast frame through the plain sweeps and
    turbulence (the parent's route), and the kernels' launches: both
    kernels and K3 launched, no K2, no plain version.

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
outside per preset. The ``bvh_traverse`` entry (``"replaces"``: the
reference's XLA traversal, no TPU kernel) carries phase 50's
``random_spheres -B`` launches, phase 49's ``random_spheres`` camera
numbers at its top level and every scene's under ``scenes``, and phases
48 and 50-52 (``trees``, ``cli_frames``, ``config4``, ``general``).
K1, K3, K6 and the ``threefry`` entry carry
``general_launches`` (phase 42's ``random_spheres`` frames for K1 and the
draw, its ``final_full`` frame for K3, phase 43 for K6); the ``threefry``
entry also phases 41-42's shares and frames. K1 and K3 carry
``silhouette_launches`` (phase 44) and K1 and K6
``geometry_train_launches`` (phase 45) and ``diff_scene_launches``
(phase 46); K6 carries phases 44-46's runs. K1, K2 and K3 carry
``device_trace_launches`` (phase 53's one-shard trace), K1, K2 and the
traversal ``sharded_cli_launches`` (phase 54's 3 frames), K3
``sharded_general_launches`` (phase 54's ``final_full`` frame), K1 and K6
``sharded_train_launches`` (phase 56's 4-shard step), K6 phase 56's
steps and the dryrun, and ``bvh_traverse`` phases 53-55's traces, frames
and the ``torchrun`` run. K1 carries ``adaptive_launches`` (phase 57's
``random_spheres``), ``aov_launches`` (phase 58), ``debug_trace_launches``
(phase 60's ``small``) and ``drivers`` (every run's launches of phases
57, 58 and 60), K3 ``aov_launches`` (phase 58's ``random``), and K2
``adaptive_launches`` (both scenes) and ``drivers``, phases 57-64's
numbers. K3 carries ``final_full_fast_launches`` (phase 65's 5 frames),
``final_full_fast`` and ``final_full_nee`` (phases 65-66), K6
``fixed_order`` (phase 70), and ``bvh_traverse`` phase 67's launches and
times, phase 68's sweeps and crossover and phase 69's textured-light
runs. The ``box_media_nearest`` and ``noise_turb`` entries (no TPU kernel;
``library_ms`` null: no PyTorch call computes either) carry the launches
of phase 76's fast frames, phase 74's and 75's numbers (``final_full``'s
camera rays at the top level, every case under ``cases``), registers,
and (``box_media_nearest``) phase 76's and 67's frames. Then
comes the ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
Any failure raises: the script then exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
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
# expected); per-sphere sums are taken in another (fixed) order
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
    from pathtrace_tpu_torch.ops import box_media_kernel, bvh_kernel
    from pathtrace_tpu_torch.ops import turb_kernel
    from pathtrace_tpu_torch.tools import bf16_probe, split_probe
    from pathtrace_tpu_torch.utils import threefry

    for name in ("LAUNCHES", "PLAIN_CALLS", "BWD_LAUNCHES", "BWD_PLAIN_CALLS",
                 "FLAT_LAUNCHES", "FLAT_PLAIN_CALLS", "HIER_LAUNCHES",
                 "HIER_PLAIN_CALLS", "MOVING_LAUNCHES", "MOVING_PLAIN_CALLS"):
        setattr(k1, name, 0)
    k2.LAUNCHES = k2.PLAIN_CALLS = 0
    k7.LAUNCHES = k7.PLAIN_CALLS = 0
    threefry.LAUNCHES = threefry.PLAIN_CALLS = 0
    bvh_kernel.LAUNCHES = bvh_kernel.PLAIN_CALLS = 0
    bvh_kernel.WIDE_LAUNCHES = bvh_kernel.WIDE_PLAIN_CALLS = 0
    box_media_kernel.LAUNCHES = box_media_kernel.PLAIN_CALLS = 0
    turb_kernel.LAUNCHES = turb_kernel.PLAIN_CALLS = 0
    turb_kernel.BWD_PLAIN_CALLS = 0
    bf16_probe.LAUNCHES = bf16_probe.PLAIN_CALLS = 0
    for kind in ("SPLIT", "MINOR", "MAJOR"):
        setattr(split_probe, f"{kind}_LAUNCHES", 0)
        setattr(split_probe, f"{kind}_PLAIN_CALLS", 0)


def read_counts(k1, k2, k7) -> dict:
    """Launches per kernel, the plain versions' calls summed, and the
    turbulence's backwards (plain by design: no backward kernel)."""
    from pathtrace_tpu_torch.ops import box_media_kernel as bm
    from pathtrace_tpu_torch.ops import bvh_kernel as bvh
    from pathtrace_tpu_torch.ops import turb_kernel as tb
    from pathtrace_tpu_torch.tools import bf16_probe as p1
    from pathtrace_tpu_torch.tools import split_probe as p24
    from pathtrace_tpu_torch.utils import threefry as tf

    return {"K1": k1.LAUNCHES, "K2": k2.LAUNCHES, "K3": k1.MOVING_LAUNCHES,
            "K4": k1.FLAT_LAUNCHES, "K5": k1.HIER_LAUNCHES,
            "K6": k1.BWD_LAUNCHES, "K7": k7.LAUNCHES, "P1": p1.LAUNCHES,
            "P2": p24.SPLIT_LAUNCHES, "P3": p24.MINOR_LAUNCHES,
            "P4": p24.MAJOR_LAUNCHES, "threefry": tf.LAUNCHES,
            "bvh": bvh.LAUNCHES, "bvh_wide": bvh.WIDE_LAUNCHES,
            "box_media": bm.LAUNCHES, "turb": tb.LAUNCHES,
            "turb_bwd_plain": tb.BWD_PLAIN_CALLS,
            "plain": (bvh.PLAIN_CALLS + bvh.WIDE_PLAIN_CALLS + k1.PLAIN_CALLS
                      + bm.PLAIN_CALLS + tb.PLAIN_CALLS
                      + k2.PLAIN_CALLS + k1.BWD_PLAIN_CALLS
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
        # two identical --geometry runs under the deterministic algorithms
        # (a new checkpoint each) give equal bits: K6 sums in a fixed order
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
          f"{geo_repeat}; "
          f"return codes {rcs}")
    if (any(rcs) or not (cli_equal and resumed and ck_equal and img_equal
                         and train_resumed and geo_repeat) or c47["plain"]):
        raise AssertionError("resume on the card is not bit-exact")

    return {"sil_k1": sil_k1, "sil_k3": sil_k3, "c45": c45, "c45s": c45s,
            "geo_run": geo_run, "diff_runs": diff_runs, "sil_runs": sil_runs}


def median_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, each timed on
    its own, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(sorted(times)[len(times) // 2])


def run_cli(tag: str, argv, k1, k2, k7):
    """``cli.main(argv)`` with every count at 0: (rc, counts just after,
    its output, per frame (ms, rays, readbacks))."""
    from pathtrace_tpu_torch import cli

    reset_counts(k1, k2, k7)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    counts = read_counts(k1, k2, k7)
    log = buf.getvalue()
    for ln in log.splitlines():
        phase(f"[{tag}] cli: {ln}")
    frames = [(float(ms), int(rays), int(rb)) for ms, rays, rb in re.findall(
        r"frame \d+/\d+: ([\d.]+) ms, (\d+) rays, [\d.]+ Mrays/s, "
        r"(\d+) readbacks", log)]
    return rc, counts, log, frames


def bvh_phases(dev, smi: str, k1, k2, k7, profiled) -> dict:
    """Phases 48-52, the whole-scene BVH (``-B``): native trees, the
    traversal kernel against its plain version on full-width camera and
    scattered rays, the CLI's ``-B`` frames against the brute frames, the
    ``config4_1024spp_bvh`` schedule, and the general route
    (``final_full -B`` through ``--mode compacted``; ``cornell_smoke -B``
    with NEE and roulette). Returns the numbers of the kernels line."""
    import numpy as np
    import torch

    from pathtrace_tpu_torch.models import bvh as pbvh
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import _cuda_build, bvh_kernel
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.ops.lights import build_light_table
    from pathtrace_tpu_torch.render import compaction
    from pathtrace_tpu_torch.tools import bvh_bench as bb
    from pathtrace_tpu_torch.tools import nearest_bench as nb
    from pathtrace_tpu_torch.utils import native
    from pathtrace_tpu_torch.utils.threefry import PRNGKey, fold_in

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_port_util import DEPTH10_BUDGET, XL_DEPTH10_BUDGET

    out = {}
    R = WIDTH * HEIGHT * SAMPLES

    # ---- 48: native trees ----
    t0 = time.perf_counter()
    lib = native.build()
    native.library()
    out["native_build_s"] = time.perf_counter() - t0
    phase(f"[48] native builder: g++ {' '.join(native.CXX_FLAGS)} "
          f"{native.SOURCE.name} -> {lib} in {out['native_build_s']:.2f} s")
    trees = {}
    for name in ("random_spheres", "random_spheres_xl", "cornell_smoke",
                 "final_full"):
        scene_, _ = presets.from_name(name, WIDTH / HEIGHT)
        mn, mx, mask, offsets = pbvh.scene_aabbs(scene_)
        t0 = time.perf_counter()
        flat, st = pbvh.build_flat_bvh(mn, mx, mask=mask, strategy="sah")
        secs = time.perf_counter() - t0
        entry = {"builder": flat.builder, "build_s": secs,
                 "nodes": st.node_count, "leaves": st.leaf_count,
                 "depth": st.max_depth, "offsets": list(offsets)}
        if name in ("random_spheres", "cornell_smoke"):
            t0 = time.perf_counter()
            ref_, ref_st = pbvh.build_flat_bvh(mn, mx, mask=mask,
                                               use_native=False,
                                               strategy="sah")
            entry["numpy_build_s"] = time.perf_counter() - t0
            entry["equal_to_numpy"] = all(
                np.array_equal(getattr(flat, k), getattr(ref_, k))
                for k in ("bb_min", "bb_max", "escape", "prim")) and (
                    st == ref_st)
        trees[name] = entry
        phase(f"[48] {name}: {entry}")
        if flat.builder != "native" or entry.get("equal_to_numpy") is False:
            raise AssertionError(f"{name}: the tree was not built natively "
                                 "or differs from the numpy SAH tree")
    out["trees"] = trees

    # ---- 49: the traversal kernel against its plain version, and in turns
    # against the parent tree's (build/parent, when present) ----
    regs = nb.ptxas_usage("bvh_traverse_kernel")
    phase(f"[49] bvh_traverse_kernel registers and spills by instance "
          f"(ptxas): {regs}")
    parent = parent_kernels()
    lib = _cuda_build.library()
    fns = {"new": bb.traverse_fn(lib)}
    if parent is not None:
        fns = {"parent": bb.traverse_fn(parent["libs"]["bvh"]), **fns}
        phase(f"[49] the parent tree's kernel ({parent['sources']['bvh']}), "
              f"built alone: "
              f"{nb.ptxas_usage('bvh_traverse', parent['logs']['bvh'])}")
    else:
        phase(f"[49] no parent tree at {PARENT_TREE}: the kernel is timed "
              "alone")
    scenes49 = {}
    max_err = 0.0
    for name, label, op, rays, time_, fl, n_media in bb.traverse_sets(dev):
        R = rays.shape[1]
        t, gid, vis = bvh_kernel.bvh_traverse(op, rays, time_, fl,
                                              visits=True)
        tp, gp, vp, tests = bvh_kernel.bvh_traverse_plain(
            op, rays, time_, fl, stats=True)
        torch.cuda.synchronize()
        same = (torch.equal(t, tp) and torch.equal(gid, gp)
                and torch.equal(vis, vp))
        if "parent" in fns:
            tq, gq, vq = fns["parent"](op, rays, time_, fl)
            torch.cuda.synchronize()
            same_parent = (torch.equal(tq, tp) and torch.equal(gq, gp)
                           and torch.equal(vq, vp))
        else:
            same_parent = None
        hit = t < 1e30
        err = (float((t[hit] - tp[hit]).abs().max()) if bool(hit.any())
               else 0.0)
        max_err = max(max_err, err)
        ms = median_ms(lambda: bvh_kernel.bvh_traverse(op, rays, time_, fl),
                       10)
        plain_ms = median_ms(lambda: bvh_kernel.bvh_traverse_plain(
            op, rays, time_, fl), 1)
        turns = bb.in_turns({k: (lambda f=f_: f(op, rays, time_, fl))
                             for k, f_ in fns.items()}, 5, 10)
        ys = bvh_kernel.yardsticks(op, R, vp, tests, n_media)
        plan = bb.traverse_plan(lib, op, R)
        med = {k: bb.median(v) for k, v in turns.items()}
        row = {
            "rays": R, "hit_share": float(hit.float().mean()),
            "equal": same, "parent_equal": same_parent, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "turns_ms": turns,
            "turns_median_ms": med, "parent_ms": med.get("parent"),
            "bound_ms": ys["bound_ms"], "bound_by": ys["bound_by"],
            "issue_ceiling_ms": ys["issue_ceiling_ms"],
            "bytes_ms": ys["bytes_ms"],
            "share_of_bound": ys["bound_ms"] / med["new"],
            "mean_visits": ys["mean_visits"], "max_visits": ys["max_visits"],
            "leaf_tests": ys["leaf_tests"], "plan": plan, "library_ms": None}
        phase(f"[49] {name} {label}: {R} rays, hit {row['hit_share']:.4f}, "
              f"t, gid and visits equal to plain: {same} (the parent's: "
              f"{same_parent}); kernel {ms:.4f} ms (median of 10); in turns "
              f"(5 rounds of {', '.join(list(fns) + list(fns)[::-1])}, 10 "
              f"launches a turn, queued behind a device sleep) "
              f"{json.dumps({k: round(v, 4) for k, v in med.items()})} ms; "
              f"plain {plain_ms:.1f} ms; bound {ys['bound_ms']:.4f} ms "
              f"({ys['bound_by']}; {row['share_of_bound']:.1%} of it); launch "
              f"{plan} (no tree in shared memory); visits mean "
              f"{ys['mean_visits']:.2f} max {ys['max_visits']}, leaf tests "
              f"{ys['leaf_tests']} ({smi})")
        if not same or same_parent is False:
            raise AssertionError(f"{name} {label}: the traversal kernel "
                                 "differs from its plain version")
        scenes49.setdefault(name, {"nodes": op.n_nodes,
                                   "node_rows": op.node_rows,
                                   "flags": op.flags})[label] = row
    out["scenes"] = scenes49
    out["registers"] = regs
    out["max_abs_err"] = max_err

    # ---- 50: the CLI's -B main path against the brute frames ----
    cli_runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("random_spheres", "random_spheres_xl"):
            imgs = {}
            for flag in ("-B", None):
                path = os.path.join(tmp, f"{name}{flag or ''}.npy")
                argv = ["-P", name, "-W", str(WIDTH), "-H", str(HEIGHT),
                        "-S", str(SAMPLES), "-D", str(DEPTH), "-O", "-F",
                        str(FRAMES), "--out", path] + ([flag] if flag else [])
                tag = "50" if flag else "50 brute"
                # the brute frames in raster order (xl's cull would trace
                # in tile order, which renames lanes and so their
                # samples): K1 over every sphere, the lanes of the -B run
                cull_min = fp.CULL_MIN_TILES
                fp.CULL_MIN_TILES = 1 << 30 if not flag else cull_min
                try:
                    rc, counts, log, frames = run_cli(tag, argv, k1, k2, k7)
                finally:
                    fp.CULL_MIN_TILES = cull_min
                if rc != 0 or len(frames) != FRAMES:
                    raise AssertionError(f"{name} {flag}: rc {rc}, {frames}")
                imgs[flag] = np.load(path)
                ms = [f_[0] for f_ in frames]
                entry = {"frame_ms": ms,
                         "median_ms": float(np.median(ms)),
                         "segments": [f_[1] for f_ in frames],
                         "readbacks": [f_[2] for f_ in frames],
                         "launches": counts,
                         "launches_per_frame": {k: v / FRAMES for k, v in
                                                counts.items()}}
                cli_runs[f"{name}{' -B' if flag else ''}"] = entry
                phase(f"[{tag}] {name} {flag or '(brute)'}: frames "
                      f"{[round(x, 2) for x in ms]} ms (CUDA events), median "
                      f"{entry['median_ms']:.2f}, segments {entry['segments']}, "
                      f"readbacks {entry['readbacks']}; launches {counts} "
                      f"({smi})")
                if flag and (counts["bvh"] <= 0 or counts["K2"] <= 0
                             or counts["K1"] or counts["K4"] or counts["K5"]
                             or counts["plain"]):
                    raise AssertionError(f"{name} -B did not run through the "
                                         "traversal kernel and K2 alone")
            a, b = imgs["-B"], imgs[None]
            close = (np.abs(a.astype(np.float64) - b)
                     <= ATOL + RTOL * np.abs(b)).all(axis=-1)
            budget_ray = (XL_DEPTH10_BUDGET if name == "random_spheres_xl"
                          else DEPTH10_BUDGET)
            budget = 1.0 - (1.0 - budget_ray) ** (SAMPLES * FRAMES)
            share = float(1.0 - close.mean())
            cli_runs[f"{name} -B"]["pixels_outside_brute"] = share
            phase(f"[50] {name}: -B image against the brute image at the same "
                  f"keys: {share:.4%} of pixels outside 1e-3 (budget "
                  f"{budget:.2%}), finite {bool(np.isfinite(a).all())}")
            if share > budget or not np.isfinite(a).all():
                raise AssertionError(f"{name}: the -B frames leave the brute "
                                     "frames")
    # the -B frames in turns against the parent tree's kernels
    for name in ("random_spheres", "random_spheres_xl"):
        scene_, cam_ = presets.from_name(name, WIDTH / HEIGHT)
        feats_ = SceneFeatures.from_scene(scene_)
        flat, _, offsets = pbvh.build_scene_bvh(scene_)
        sdev, cdev = scene_.to(dev), cam_.to(dev)
        key = fold_in(PRNGKey(0), 2)
        phase(f"[50] {name} -B, render_frame_fast {WIDTH}x{HEIGHT}x{SAMPLES} "
              f"depth {DEPTH}:")
        cli_runs[f"{name} -B"]["turns"] = frames_in_turns(
            "50", lambda: fp.render_frame_fast(
                sdev, cdev, WIDTH, HEIGHT, SAMPLES, DEPTH, key, 7, feats_,
                bvh=flat, bvh_offsets=offsets).image, smi)
        del sdev, cdev
    out["cli"] = cli_runs

    # ---- 51: config4_1024spp_bvh's schedule beside its brute twin ----
    c4 = {}
    with tempfile.TemporaryDirectory() as tmp:
        for flag in ("-B", None):
            argv = ["-P", "random_spheres", "-W", "200", "-H", "100", "-S",
                    "128", "-D", str(DEPTH), "-F", "8", "-O", "--out",
                    os.path.join(tmp, "c4.npy")] + ([flag] if flag else [])
            t0 = time.monotonic()
            rc, counts, log, frames = run_cli("51", argv, k1, k2, k7)
            wall = time.monotonic() - t0
            if rc != 0 or len(frames) != 8:
                raise AssertionError(f"config4 {flag}: rc {rc}")
            rays = sum(f_[1] for f_ in frames)
            ms = [f_[0] for f_ in frames]
            c4["bvh" if flag else "brute"] = {
                "seconds_to_1024spp": wall, "frames_ms_sum": sum(ms),
                "frame_ms": ms, "segments": rays,
                "mrays_per_s": rays / sum(ms) / 1e3, "launches": counts}
            phase(f"[51] config4_1024spp {'-B' if flag else 'brute'}: "
                  f"{wall:.2f} s to 1024 spp (cli wall), frames "
                  f"{sum(ms):.1f} ms summed, {rays} segments, "
                  f"{rays / sum(ms) / 1e3:.2f} Mrays/s; launches {counts} "
                  f"({smi})")
            if flag and (counts["bvh"] <= 0 or counts["plain"]):
                raise AssertionError("config4 -B did not run the kernel")
    out["config4"] = c4

    # ---- 52: the general route: final_full -B --mode compacted (auto
    # takes the fast path with the tree: phase 67) and NEE ----
    gen = {}
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["-P", "final_full", "-B", "--mode", "compacted",
                "-W", str(WIDTH), "-H", str(HEIGHT),
                "-S", str(SAMPLES), "-D", str(DEPTH), "-O", "-F", "1",
                "--out", os.path.join(tmp, "ff.npy")]
        r0 = compaction.READBACKS
        rc, counts, log, frames = run_cli("52", argv, k1, k2, k7)
        bounces = compaction.READBACKS - r0
        img = np.load(os.path.join(tmp, "ff.npy"))
        if (rc != 0 or "render path: compacted" not in log
                or counts["bvh"] <= 0 or counts["plain"] or counts["K2"]
                or not np.isfinite(img).all()):
            raise AssertionError(f"final_full -B: rc {rc}, {counts}")
        gen["final_full"] = {"frame_ms": frames[0][0], "segments": frames[0][1],
                             "bounces": bounces, "launches": counts,
                             "image_mean": float(img.mean())}
        scene_, cam_ = presets.from_name("final_full", WIDTH / HEIGHT)
        feats_ = SceneFeatures.from_scene(scene_)
        flat, _, offsets = pbvh.build_scene_bvh(scene_)
        sdev = scene_.to(dev)
        fn = pbvh.make_bvh_intersect_fn(flat, offsets, feats_)
        r0 = compaction.READBACKS
        wall_ms, busy_ms, n_launch, top = profiled(
            lambda: compaction.render_frame_compacted(
                sdev, cam_, WIDTH, HEIGHT, SAMPLES, DEPTH,
                fold_in(PRNGKey(0), 3), features=feats_, intersect_fn=fn))
        nb_ = compaction.READBACKS - r0
        gen["final_full"].update(
            profiled_wall_ms=wall_ms, busy_ms=busy_ms, device_launches=n_launch,
            bounces_profiled=nb_, launches_per_bounce=n_launch / max(nb_, 1),
            top_kernels=top)
        phase(f"[52] final_full -B --mode compacted (bvh): frame "
              f"{frames[0][0]:.2f} ms (CUDA events), {frames[0][1]} segments, "
              f"{bounces} bounces; profiled frame: wall {wall_ms:.2f} ms, busy "
              f"{busy_ms:.2f} ms (idle {1.0 - busy_ms / wall_ms:.1%}), "
              f"{n_launch} device launches over {nb_} bounces "
              f"({n_launch / max(nb_, 1):.0f} a bounce; PR 16's general frame "
              f"39,027); top {top} ({smi})")
        del sdev
        argv = ["-P", "cornell_smoke", "-B", "--nee", "--rr", str(RR_START),
                "-W", str(WIDTH), "-H", str(HEIGHT), "-S", str(SAMPLES),
                "-D", str(DEPTH), "-O", "-F", str(FRAMES), "--out",
                os.path.join(tmp, "cs.npy")]
        rc, counts, log, frames = run_cli("52", argv, k1, k2, k7)
        img = np.load(os.path.join(tmp, "cs.npy"))
        if (rc != 0 or "render path: fast" not in log or counts["bvh"] <= 0
                or counts["K2"] <= 0 or counts["plain"]
                or not np.isfinite(img).all()):
            raise AssertionError(f"cornell_smoke -B --nee: rc {rc}, {counts}")
        scene_, cam_ = presets.from_name("cornell_smoke", WIDTH / HEIGHT)
        feats_ = SceneFeatures.from_scene(scene_)
        flat, _, offsets = pbvh.build_scene_bvh(scene_)
        sdev = scene_.to(dev)
        lights = build_light_table(sdev)
        wall_ms, busy_ms, n_launch, top = profiled(
            lambda: fp.render_frame_fast(
                sdev, cam_, WIDTH, HEIGHT, SAMPLES, DEPTH,
                fold_in(PRNGKey(0), 3), 3, feats_, nee_lights=lights,
                rr_start=RR_START, bvh=flat, bvh_offsets=offsets))
        ms = [f_[0] for f_ in frames]
        gen["cornell_smoke_nee"] = {
            "frame_ms": ms, "median_ms": float(np.median(ms)),
            "segments": [f_[1] for f_ in frames],
            "readbacks": [f_[2] for f_ in frames], "launches": counts,
            "profiled_wall_ms": wall_ms, "busy_ms": busy_ms,
            "device_launches": n_launch,
            "launches_per_bounce": n_launch / (DEPTH + 1), "top_kernels": top,
            "image_mean": float(img.mean())}
        phase(f"[52] cornell_smoke -B --nee --rr {RR_START}: frames "
              f"{[round(x, 2) for x in ms]} ms (CUDA events), segments "
              f"{gen['cornell_smoke_nee']['segments']}; launches {counts}; "
              f"profiled frame: wall {wall_ms:.2f} ms, busy {busy_ms:.2f} ms "
              f"(idle {1.0 - busy_ms / wall_ms:.1%}), {n_launch} device "
              f"launches (~{n_launch / (DEPTH + 1):.0f} a bounce); top {top} "
              f"({smi})")
        phase(f"[52] cornell_smoke -B --nee --rr {RR_START}, "
              f"render_frame_fast:")
        gen["cornell_smoke_nee"]["turns"] = frames_in_turns(
            "52", lambda: fp.render_frame_fast(
                sdev, cam_, WIDTH, HEIGHT, SAMPLES, DEPTH,
                fold_in(PRNGKey(0), 3), 3, feats_, nee_lights=lights,
                rr_start=RR_START, bvh=flat, bvh_offsets=offsets).image, smi)
        del sdev
    out["general"] = gen
    return out


def mesh_phases(dev, k1, k2, k7) -> dict:
    """Phases 53-56, the render mesh: the device-only fast trace on one
    shard and on 4 virtual shards of the card, ``--mode sharded`` through
    the CLI (fast shards, ``-B``, general shards), ``--distributed``
    through ``torchrun`` (an NCCL group of world size 1), and the trainer
    on a one-shard and a 4-shard mesh, then the dryrun twin. Returns the
    numbers of the kernels line."""
    import numpy as np
    import torch

    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.parallel import mesh as pmesh
    from pathtrace_tpu_torch.parallel.dryrun import dryrun_multichip
    from pathtrace_tpu_torch.parallel.inverse import make_inverse_renderer
    from pathtrace_tpu_torch.render.frame import generate_primary_rays
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_port_util import GRAD_TOL, MOTION_GRAD_TOL

    out = {}
    R = WIDTH * HEIGHT * SAMPLES
    mesh4 = pmesh.make_render_mesh([dev] * 4)
    mesh1 = pmesh.make_render_mesh([dev])

    # ---- 53: the device-only trace, one shard against 4 virtual shards
    # and against the ladder ----
    seed = 12345
    out["trace"] = {}
    for name in ("random_spheres", "random"):
        scene_, cam_ = presets.from_name(name, WIDTH / HEIGHT)
        feats_ = SceneFeatures.from_scene(scene_)
        sdev = scene_.to(dev)
        ro, rd, tm = (x.reshape(R, -1).squeeze(-1) for x in
                      generate_primary_rays(cam_, WIDTH, HEIGHT, SAMPLES,
                                            PRNGKey(0), device=dev))

        def one():
            return fp.trace_fast_device(sdev, ro, rd, tm, seed, DEPTH,
                                        feats_)

        def four():
            return pmesh.trace_sharded(sdev, ro, rd, tm, None, DEPTH, mesh4,
                                       features=feats_, mode="fast",
                                       seed=seed)

        def ladder():
            return fp.trace_fast(sdev, ro, rd, tm, seed, DEPTH, feats_)

        reset_counts(k1, k2, k7)
        rad1, cnt1 = one()
        torch.cuda.synchronize()
        c_one = read_counts(k1, k2, k7)
        reset_counts(k1, k2, k7)
        rad4, cnt4 = four()
        torch.cuda.synchronize()
        c_four = read_counts(k1, k2, k7)
        lad = ladder()
        bitwise = bool(torch.equal(rad1, rad4)) and int(cnt1) == int(cnt4)
        n_out, share = rays_outside(rad1, lad.radiance.cpu().numpy())
        ladder_equal = bool(torch.equal(rad1, lad.radiance))
        one_ms = median_ms(one, 5)
        four_ms = median_ms(four, 5)
        ladder_ms = median_ms(ladder, 5)
        run = {"bitwise_4_shards": bitwise, "segments": int(cnt1),
               "ladder_segments": int(lad.ray_count),
               "ladder_rays_outside": n_out, "ladder_share_outside": share,
               "ladder_bitwise": ladder_equal, "ms": one_ms,
               "four_shards_ms": four_ms, "ladder_ms": ladder_ms,
               "launches": c_one, "four_shards_launches": c_four}
        out["trace"][name] = run
        sweep = "K3" if feats_.has_motion else "K1"
        phase(f"[53] {name} trace_fast_device {WIDTH}x{HEIGHT}x{SAMPLES} "
              f"depth {DEPTH}: 4 virtual shards bit for bit {bitwise} "
              f"({int(cnt1)} segments); against the ladder's trace_fast: "
              f"{n_out} rays outside 1e-3 ({share:.4%}), bitwise "
              f"{ladder_equal}, segments {int(lad.ray_count)}; median ms: "
              f"device trace {one_ms:.3f}, 4 shards {four_ms:.3f}, ladder "
              f"{ladder_ms:.3f} (CUDA events); launches one shard {c_one}, "
              f"4 shards {c_four}")
        if (not bitwise or c_one["plain"] or c_four["plain"]
                or c_one[sweep] != DEPTH + 1 or c_one["K2"] != DEPTH + 1
                or c_four[sweep] != 4 * (DEPTH + 1)
                or not torch.isfinite(rad1).all()):
            raise AssertionError(f"[53] {name}: the device trace failed")
        del sdev, ro, rd, tm, rad1, rad4, lad

    # ---- 54: --mode sharded through the CLI ----
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    img54 = os.path.join(tmp, "sharded.npy")
    cli_runs = {}
    for label, argv, frames in (
            ("random_spheres", ["-P", "random_spheres"], FRAMES),
            ("random_spheres -B", ["-P", "random_spheres", "-B"], FRAMES),
            ("final_full", ["-P", "final_full"], 1)):
        path_out = img54 if label == "random_spheres" else os.path.join(
            tmp, "other.npy")
        rc, counts, log, frames_ = run_cli(
            "54", argv + ["-O", "-F", str(frames), "--mode", "sharded",
                          "--out", path_out], k1, k2, k7)
        run = {"rc": rc, "frames": frames_, "launches": counts,
               "frame_ms": [f[0] for f in frames_],
               "path": "sharded" if "(sharded path" in log else None}
        cli_runs[label] = run
        phase(f"[54] {label} --mode sharded: rc {rc}, path {run['path']}, "
              f"frame ms {run['frame_ms']}, launches {counts}")
        fast = label != "final_full"
        ok = (rc == 0 and run["path"] == "sharded" and len(frames_) == frames
              and not counts["plain"] and counts["threefry"] > 0)
        if label == "random_spheres":
            ok &= counts["K1"] == counts["K2"] == frames * (DEPTH + 1)
        elif label == "random_spheres -B":
            ok &= (counts["bvh"] == counts["K2"] == frames * (DEPTH + 1)
                   and counts["K1"] == 0)
        else:
            ok &= "general shards" in log and counts["K3"] > 0
        if not ok or (fast and "fast shards" not in log):
            raise AssertionError(f"[54] {label}: failed its checks")
    out["cli"] = cli_runs
    image54 = np.load(img54)

    # ---- 55: --distributed through torchrun (NCCL, world size 1) ----
    img55 = os.path.join(tmp, "distributed.npy")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", "-m", "pathtrace_tpu_torch", "--distributed",
         "-P", "random_spheres", "-O", "-F", str(FRAMES), "--mode", "sharded",
         "--out", img55], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    wall55 = time.monotonic() - t0
    for ln in proc.stdout.splitlines():
        phase(f"[55] torchrun: {ln}")
    equal55 = (proc.returncode == 0 and os.path.exists(img55)
               and np.array_equal(np.load(img55), image54))
    frames55 = [float(ms) for ms in re.findall(r"frame \d+/\d+: ([\d.]+) ms",
                                               proc.stdout)]
    out["distributed"] = {"rc": proc.returncode, "image_equal": equal55,
                          "frame_ms": frames55, "wall_s": wall55}
    phase(f"[55] torchrun --nproc_per_node=1 ... --distributed --mode "
          f"sharded: rc {proc.returncode}, NCCL group of 1, image == phase "
          f"54's bit for bit: {equal55}; frame ms {frames55}; wall "
          f"{wall55:.1f} s")
    if not equal55 or "mesh: 1 shard(s) (1 process(es)" not in proc.stdout:
        raise AssertionError("[55] --distributed failed: "
                             + proc.stderr[-2000:])

    # ---- 56: the trainer on a one-shard and a 4-shard mesh ----
    t_scene, t_cam = presets.random_spheres(WIDTH / HEIGHT)
    key = PRNGKey(0)
    train = {}
    for label, m in (("one", mesh1), ("four", mesh4)):
        rend, st, names = make_inverse_renderer(
            t_scene, t_cam, WIDTH, HEIGHT, samples=SAMPLES,
            max_depth=TRAIN_DEPTH, mesh=m)
        target = torch.zeros((HEIGHT, WIDTH, 3), device=dev)
        loss = rend.loss(st.params, target, key)
        grads = torch.autograd.grad(loss, st.params)
        del loss
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts(k1, k2, k7)
        e0, e1 = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        e0.record()
        st, step_loss = rend.train_step(st, target, key)
        e1.record()
        e1.synchronize()
        train[label] = {"loss": float(step_loss), "names": names,
                        "grads": [g.detach().cpu() for g in grads],
                        "step_ms": e0.elapsed_time(e1),
                        "peak_gib": torch.cuda.max_memory_allocated(dev)
                        / 2**30, "launches": read_counts(k1, k2, k7)}
        del rend, st, grads
        torch.cuda.empty_cache()
    names = train["one"]["names"]
    errs = {n: rel_l2(b, a) for n, a, b in zip(
        names, train["one"]["grads"], train["four"]["grads"])}
    tol = MOTION_GRAD_TOL if "spheres.center_delta" in errs else GRAD_TOL
    ok56 = (all(e <= tol.get(n, 0.0) for n, e in errs.items())
            and abs(train["four"]["loss"] - train["one"]["loss"])
            <= 1e-6 * abs(train["one"]["loss"]))
    c56 = train["four"]["launches"]
    phase(f"[56] trainer random_spheres {WIDTH}x{HEIGHT}x{SAMPLES} depth "
          f"{TRAIN_DEPTH}, leaves {names}: loss one shard "
          f"{train['one']['loss']!r}, 4 shards {train['four']['loss']!r}; "
          f"gradients 4 shards vs one, rel L2 "
          + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + f" (GRAD_TOL); step ms one {train['one']['step_ms']:.2f}, four "
          f"{train['four']['step_ms']:.2f} (CUDA events); peak GiB one "
          f"{train['one']['peak_gib']:.3f}, four "
          f"{train['four']['peak_gib']:.3f}; launches four {c56}")
    if (not ok56 or c56["plain"] or c56["K1"] != 4 * (TRAIN_DEPTH + 1)
            or c56["K6"] <= 0):
        raise AssertionError("[56] the sharded trainer failed its checks")
    buf = io.StringIO()
    reset_counts(k1, k2, k7)
    with contextlib.redirect_stdout(buf):
        dry = dryrun_multichip(4, device=str(dev))
    c56d = read_counts(k1, k2, k7)
    phase(f"[56] {buf.getvalue().strip()}; launches {c56d}")
    if c56d["plain"] or c56d["K1"] <= 0 or c56d["K6"] <= 0:
        raise AssertionError("[56] dryrun_multichip failed its checks")
    out["train"] = {k: {kk: vv for kk, vv in v.items() if kk != "grads"}
                    for k, v in train.items()}
    out["train"]["grad_rel_l2"] = errs
    out["dryrun"] = {"loss": dry["loss"], "launches": c56d}
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _display_mse(a, b) -> float:
    """Mean squared error in the display domain, ``clip(x, 0, 1)^(1/2.2)``
    (``tests/test_denoise.py``'s measure)."""
    import numpy as np

    def disp(x):
        return np.clip(x, 0.0, 1.0) ** (1.0 / 2.2)

    return float(((disp(a) - disp(b)) ** 2).mean())


def driver_phases(dev, k1, k2, k7) -> dict:
    """Phases 57-64, the drivers and surfaces: ``--adaptive``, ``--aovs
    --denoise``, the interactive loop's live preview, ``-X`` (and ``-X
    -B``), ``render_image``, ``--group`` and ``--no-compaction``,
    ``--profile-dir``, and the adaptive rounds on the card held to the CPU
    port's. Returns the numbers of the kernels line."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from pathtrace_tpu_torch import cli, render_image
    from pathtrace_tpu_torch.config import Params
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.render import film
    from pathtrace_tpu_torch.render import preview as pv
    from pathtrace_tpu_torch.render import progressive as prog
    from pathtrace_tpu_torch.render.adaptive import render_adaptive
    from pathtrace_tpu_torch.render.aov import render_aovs
    from pathtrace_tpu_torch.render.progressive import render_progressive
    from pathtrace_tpu_torch.utils.threefry import PRNGKey

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_port_util import (
        DEPTH10_BUDGET, adaptive_picks, assert_trace_lines_match, lane_close,
    )

    out = {}
    film_args = ["-W", str(WIDTH), "-H", str(HEIGHT), "-S", str(SAMPLES),
                 "-D", str(DEPTH)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_drivers_")

    # ---- 57: --adaptive 16 through the CLI ----
    out["adaptive"] = {}
    for name in ("random_spheres", "cornell"):
        path = os.path.join(tmp, f"ad_{name}.npy")
        rc, c, log, _ = run_cli("57", ["-P", name, *film_args, "--adaptive",
                                       "16", "--out", path], k1, k2, k7)
        m = re.search(r"adaptive: (\d+) rounds, spp min/mean/max "
                      r"([\d.]+)/([\d.]+)/([\d.]+)", log)
        t = dict((k, float(v)) for k, v in re.findall(
            r"(\w+) ([\d.]+) ms", re.search(r"adaptive time: (.*)",
                                           log).group(1)))
        total = re.search(r"([\d.]+)secs (\d+)rays", log)
        img = np.load(path)
        run = {"rounds": int(m.group(1)),
               "spp_min_mean_max": [float(m.group(k)) for k in (2, 3, 4)],
               "total_ms": float(total.group(1)) * 1e3,
               "rays": int(total.group(2)), "split_ms": t, "launches": c,
               "image_mean": float(img.mean())}
        out["adaptive"][name] = run
        phase(f"[57] {name} --adaptive 16 at {WIDTH}x{HEIGHT} -S {SAMPLES} "
              f"depth {DEPTH}: {run['rounds']} rounds, spp min/mean/max "
              f"{run['spp_min_mean_max']}, total {run['total_ms']:.1f} ms "
              f"(split: {t}), launches {c}")
        if (rc != 0 or run["rounds"] != 10 or run["spp_min_mean_max"][1] != 16.0
                or not np.isfinite(img).all() or c["K2"] <= 0 or c["plain"]
                or (name == "random_spheres" and c["K1"] <= 0)):
            raise AssertionError(f"[57] {name}: --adaptive failed its checks")

    # ---- 58: --aovs --denoise -O, and AOVs of sphere scenes ----
    base = ["-P", "cornell", *film_args, "-O", "--nee"]
    raw, den, ref = (os.path.join(tmp, f"{k}.npy") for k in ("raw", "den",
                                                            "ref"))
    rc1, c_raw, _, _ = run_cli("58", base + ["--out", raw], k1, k2, k7)
    rc2, c_den, log, _ = run_cli("58", base + ["--aovs", "--denoise",
                                               "--out", den], k1, k2, k7)
    # 16 frames of 4 spp under another seed: the 64-spp reference
    rc3, _, _, _ = run_cli("58", base + ["-F", "16", "--seed", "1", "--out",
                                         ref], k1, k2, k7)
    aov_ms = float(re.search(r"aovs: ([\d.]+) ms", log).group(1))
    den_ms = float(re.search(r"denoise: ([\d.]+) ms", log).group(1))
    pngs = {k: film.read_png(f"{den}.{k}.png").shape
            for k in ("normal", "albedo", "depth")}
    img_raw, img_den, img_ref = np.load(raw), np.load(den), np.load(ref)
    mse_raw, mse_den = _display_mse(img_raw, img_ref), _display_mse(img_den,
                                                                    img_ref)
    out["denoise"] = {"aov_ms": aov_ms, "denoise_ms": den_ms,
                      "mse_raw": mse_raw, "mse_denoised": mse_den,
                      "ratio": mse_den / mse_raw, "launches": c_den}
    phase(f"[58] cornell --aovs --denoise -O --nee at {WIDTH}x{HEIGHT}x"
          f"{SAMPLES}: AOV pngs {pngs}; aovs {aov_ms:.1f} ms, denoise "
          f"{den_ms:.1f} ms; display MSE against 64 spp: raw {mse_raw:.6f}, "
          f"denoised {mse_den:.6f} (ratio {mse_den / mse_raw:.3f}); "
          f"launches {c_den}")
    if (rc1 or rc2 or rc3 or any(s != (HEIGHT, WIDTH, 3) for s in
                                 pngs.values())
            or not np.isfinite(img_den).all() or not mse_den < mse_raw
            or c_den["plain"]):
        raise AssertionError("[58] --aovs --denoise failed its checks")
    out["aov"] = {}
    for name, kern in (("random_spheres", "K1"), ("random", "K3")):
        scene_, cam_ = presets.from_name(name, WIDTH / HEIGHT)
        feats_ = SceneFeatures.from_scene(scene_)
        sdev, cdev = scene_.to(dev), cam_.to(dev)

        def aov_pass():
            return render_aovs(sdev, cdev, WIDTH, HEIGHT, PRNGKey(0),
                               features=feats_, samples=1)

        reset_counts(k1, k2, k7)
        aov_pass()
        torch.cuda.synchronize()
        c = read_counts(k1, k2, k7)
        ms = median_ms(aov_pass, 5)
        small = {d: render_aovs(scene_.to(d), cam_.to(d), 64, 48, PRNGKey(0),
                                features=feats_, samples=2)
                 for d in ("cpu", dev)}
        outside = np.zeros((48, 64), bool)
        exact = True
        for k in ("normal", "albedo", "depth", "hit"):
            a, b = small[dev][k].cpu().numpy(), small["cpu"][k].numpy()
            close = lane_close(a, b)
            outside |= ~(close.all(axis=-1) if close.ndim == 3 else close)
            exact = exact and bool(np.array_equal(a, b))
        share = float(outside.mean())
        out["aov"][name] = {"ms": ms, "launches": c,
                            "cpu_share_outside": share, "cpu_exact": exact}
        phase(f"[58] render_aovs {name} {WIDTH}x{HEIGHT}x1: {ms:.3f} ms "
              f"(median of 5), launches {c}; card vs CPU port at 64x48x2: "
              f"{share:.4%} of pixels outside 1e-3, bit for bit {exact}")
        if c[kern] != 1 or c["plain"] or share > 0.005:
            raise AssertionError(f"[58] render_aovs {name} failed its checks")

    # ---- 59: the interactive loop and its live preview ----
    runs = {}
    for label, extra, fetch in (("no preview", ["--no-preview"], False),
                                ("preview, not fetched", [], False),
                                ("preview, fetched", [], True)):
        port = _free_port()
        url = f"http://127.0.0.1:{port}/"
        got, stop = [], threading.Event()

        def fetcher():
            # as the viewer page does: poll the stats, fetch each new frame
            seen = 0
            while not stop.is_set():
                try:
                    named = json.loads(urllib.request.urlopen(
                        url + "stats.json", timeout=5).read())["frame"]
                    if named <= seen:
                        time.sleep(0.002)
                        continue
                    t0 = time.monotonic()
                    png = urllib.request.urlopen(url + "frame.png",
                                                 timeout=60).read()
                    got.append((named, png, (time.monotonic() - t0) * 1e3))
                    seen = named
                except OSError:
                    time.sleep(0.002)

        th = threading.Thread(target=fetcher, daemon=True)
        kept = {}
        real_loop = prog.render_progressive
        real_png = pv.PreviewServer._frame_png
        serving = threading.Event()

        def serving_png(self):
            serving.set()
            return real_png(self)

        def keeping_loop(*a, on_frame=None, **kw):
            # each frame's accumulation, copied on the loop's stream right
            # after the frame (no sync), to hold the fetched PNGs to. After
            # frame 1 the loop waits until the handler has taken a
            # /frame.png request, so that fetch reads back while frames 2-5
            # launch (five ~15 ms frames are over before a polling fetcher
            # reliably gets in, and a request queued when the loop closes
            # the server is refused)
            def both(n, acc):
                kept[n] = acc.clone()
                if n == 1:
                    serving.wait(timeout=30)
                if on_frame is not None:
                    on_frame(n, acc)
            return real_loop(*a, on_frame=both, **kw)

        if fetch:
            prog.render_progressive = keeping_loop
            pv.PreviewServer._frame_png = serving_png
            th.start()
        path = os.path.join(tmp, "live.npy")
        try:
            rc, c, log, frames = run_cli(
                "59", ["-P", "random_spheres", *film_args, "-F", "5",
                       "--preview-port", str(port), "--out", path] + extra,
                k1, k2, k7)
        finally:
            prog.render_progressive = real_loop
            pv.PreviewServer._frame_png = real_png
            stop.set()
        if fetch:
            th.join(timeout=120)
        runs[label] = {"frame_ms": [f[0] for f in frames], "launches": c,
                       "fetches": len(got),
                       "fetch_ms": [g[2] for g in got]}
        phase(f"[59] interactive -F 5 ({label}): rc {rc}, frame ms "
              f"{[round(f[0], 3) for f in frames]}, fetches {len(got)} "
              f"(frames {[g[0] for g in got]}, ms "
              f"{[round(g[2], 1) for g in got]})")
        if (rc != 0 or len(frames) != 5 or c["plain"] or c["K1"] <= 0
                or ("live preview at" in log) == (label == "no preview")):
            raise AssertionError(f"[59] interactive ({label}) failed")
        if fetch:
            # each PNG is one whole frame: the one /stats.json named, or a
            # later one published between the two requests
            srgb = {n: film.to_srgb_u8(a.cpu().numpy()[::-1])
                    for n, a in kept.items()}
            matched = []
            for named, png, _ in got:
                p_ = os.path.join(tmp, "fetched.png")
                with open(p_, "wb") as f:
                    f.write(png)
                img_ = film.read_png(p_)
                matched.append((named, [n for n, ref in srgb.items()
                                        if np.array_equal(img_, ref)]))
            runs[label]["fetched_equal_frames"] = matched
            phase(f"[59] fetched (named frame, frames whose sRGB equals the "
                  f"PNG): {matched}")
            if not serving.is_set() or not got:
                raise AssertionError("[59] no fetch reached the preview "
                                     "while the loop ran")
            if (sorted(kept) != [1, 2, 3, 4, 5]
                    or not all(any(n >= named for n in m)
                               for named, m in matched)):
                raise AssertionError("[59] a concurrent fetch served no "
                                     "whole frame it could name")
    # a fetch inside the loop (on_frame, the main thread's HTTP call; the
    # handler thread reads the frame back) serves the frame it names
    scene_, cam_ = presets.from_name("random_spheres", WIDTH / HEIGHT)
    served = []
    servers, orig = [], pv.PreviewServer

    def make(*a, **k):
        servers.append(orig(*a, **k))
        return servers[-1]

    def on_frame(frame_n, acc):
        srv = servers[0]
        named = json.loads(urllib.request.urlopen(
            srv.url + "stats.json", timeout=5).read())["frame"]
        t0 = time.monotonic()
        png = urllib.request.urlopen(srv.url + "frame.png", timeout=60).read()
        ms = (time.monotonic() - t0) * 1e3
        p_ = os.path.join(tmp, "named.png")
        with open(p_, "wb") as f:
            f.write(png)
        same = bool(np.array_equal(film.read_png(p_), film.to_srgb_u8(
            acc.cpu().numpy()[::-1])))
        served.append((frame_n, named, same, ms))

    pv.PreviewServer = make
    try:
        render_progressive(scene_, cam_, Params(width=WIDTH, height=HEIGHT,
                                                samples=SAMPLES,
                                                max_depth=DEPTH),
                           max_frames=3, device=dev, preview=True,
                           on_frame=on_frame, log=lambda _s: None)
    finally:
        pv.PreviewServer = orig
    out["preview"] = {"runs": runs, "named_fetches": served}
    phase(f"[59] fetch from on_frame: (frame, named, equal, ms) {served}")
    if len(served) != 3 or not all(f == n and s for f, n, s, _ in served):
        raise AssertionError("[59] a fetch served another frame")

    # ---- 60: -X and -X -B against the CPU port's lines ----
    out["trace"] = {}
    for name, extra in (("small", []), ("cornell", []), ("cornell", ["-B"])):
        argv = ["-P", name, "-W", str(WIDTH), "-H", str(HEIGHT), "-D",
                str(DEPTH), "-X", *extra]
        rc, c, log, _ = run_cli("60", argv, k1, k2, k7)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_cpu = cli.main(argv + ["--device", "cpu"])

        def trace_lines(text):
            lines = text.splitlines()
            i = next(i for i, ln in enumerate(lines)
                     if ln.startswith(("bvh stats", "center ray")))
            return lines[i:]

        card, cpu = trace_lines(log), trace_lines(buf.getvalue())
        assert_trace_lines_match(card, cpu)
        label = f"{name} {' '.join(extra)}".strip()
        out["trace"][label] = {"lines": len(card), "identical": card == cpu,
                               "launches": c}
        phase(f"[60] -X {label}: {len(card)} lines, identical to the CPU "
              f"port's: {card == cpu}; launches {c}")
        if rc or rc_cpu or c["plain"] or (name == "small" and c["K1"] <= 0):
            raise AssertionError(f"[60] -X {label} failed")

    # ---- 61: render_image == the CLI's .npy ----
    path = os.path.join(tmp, "api.npy")
    reset_counts(k1, k2, k7)
    img_api = render_image(preset="random_spheres", width=WIDTH,
                           height=HEIGHT, samples=SAMPLES, max_depth=DEPTH)
    c_api = read_counts(k1, k2, k7)
    rc, _, _, _ = run_cli("61", ["-P", "random_spheres", *film_args, "-O",
                                 "--out", path], k1, k2, k7)
    api_equal = bool(np.array_equal(img_api, np.load(path)))
    out["api"] = {"bitwise": api_equal, "launches": c_api}
    phase(f"[61] render_image(preset='random_spheres') == cli -O .npy bit "
          f"for bit: {api_equal}; launches {c_api}")
    if rc or not api_equal or c_api["plain"] or c_api["K1"] <= 0:
        raise AssertionError("[61] render_image differs from the CLI")

    # ---- 62: --group and --no-compaction change no bit ----
    knobs = {}
    for label, extra in (("default", []), ("--group 2", ["--group", "2"]),
                         ("--group 3", ["--group", "3"]),
                         ("--no-compaction", ["--no-compaction"])):
        path = os.path.join(tmp, f"knob{len(knobs)}.npy")
        rc, c, _, frames = run_cli("62", ["-P", "random_spheres", *film_args,
                                          "-O", "-F", str(FRAMES), "--out",
                                          path] + extra, k1, k2, k7)
        knobs[label] = {"image": np.load(path), "rc": rc, "launches": c,
                        "frame_ms": [f[0] for f in frames],
                        "readbacks": [f[2] for f in frames]}
    same = {k: bool(np.array_equal(v["image"], knobs["default"]["image"]))
            for k, v in knobs.items()}
    out["knobs"] = {k: {kk: vv for kk, vv in v.items() if kk != "image"}
                    for k, v in knobs.items()}
    for k, v in knobs.items():
        phase(f"[62] {k}: bit for bit the default frame {same[k]}; frame ms "
              f"{[round(x, 3) for x in v['frame_ms']]}, readbacks "
              f"{v['readbacks']}")
    if not all(same.values()) or any(v["rc"] or v["launches"]["plain"]
                                     for v in knobs.values()):
        raise AssertionError("[62] a knob changed the image")

    # ---- 63: --profile-dir ----
    prof = os.path.join(tmp, "prof")
    rc, c, log, _ = run_cli("63", ["-P", "random_spheres", *film_args, "-O",
                                   "--profile-dir", prof, "--out",
                                   os.path.join(tmp, "p.npy")], k1, k2, k7)
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    named = {tag: sum(n for k, n in kernels.items() if tag in k)
             for tag in ("sphere_nearest_kernel", "shade_kernel")}
    out["profile"] = {"kernel_events": sum(kernels.values()),
                      "named": named, "launches": c}
    phase(f"[63] --profile-dir: {sum(kernels.values())} kernel events, "
          f"K1 (sphere_nearest_kernel) {named['sphere_nearest_kernel']}, K2 "
          f"(shade_kernel) {named['shade_kernel']}; launches {c}")
    if (rc or f"profiler trace written to {prof}" not in log
            or named["sphere_nearest_kernel"] != c["K1"]
            or named["shade_kernel"] != c["K2"] or c["K1"] <= 0):
        raise AssertionError("[63] the profiler trace misses K1 or K2")

    # ---- 64: the adaptive rounds on the card against the CPU port's ----
    out["adaptive_vs_cpu"] = {}
    aw, ah, budget = 64, 48, 8
    budget_px = 1.0 - (1.0 - DEPTH10_BUDGET) ** 8
    for name in ("random_spheres", "cornell"):
        scene_, cam_ = presets.from_name(name, aw / ah)
        p = Params(width=aw, height=ah, samples=2, max_depth=DEPTH)
        with adaptive_picks() as cpu_ids:
            img_c, rays_c, spp_c = render_adaptive(scene_, cam_, p, budget,
                                                   device="cpu",
                                                   log=lambda _s: None)
        reset_counts(k1, k2, k7)
        with adaptive_picks(replay=cpu_ids) as own:
            img_g, rays_g, spp_g = render_adaptive(scene_, cam_, p, budget,
                                                   device=dev,
                                                   log=lambda _s: None)
        c = read_counts(k1, k2, k7)
        _, _, spp_f = render_adaptive(scene_, cam_, p, budget, device=dev,
                                      log=lambda _s: None)
        overlap = min(len(set(a.tolist()) & set(b.tolist())) / len(b)
                      for a, b in zip(own, cpu_ids))
        outside = float((~lane_close(img_g, img_c).all(axis=-1)).mean())
        spp_same = float((spp_g == spp_c).mean())
        free_same = float((spp_f == spp_c).mean())
        out["adaptive_vs_cpu"][name] = {
            "rounds": len(cpu_ids) + 2, "min_pick_overlap": overlap,
            "spp_agree": spp_same, "share_outside": outside,
            "rays": [rays_g, rays_c], "free_run_spp_agree": free_same,
            "launches": c}
        phase(f"[64] {name} adaptive {aw}x{ah} -S 2 depth {DEPTH} budget "
              f"{budget}, card replaying the CPU port's picks: own picks "
              f"hold >= {overlap:.4f} of them, spp maps agree {spp_same:.4f}, "
              f"{outside:.4%} of pixels outside 1e-3 (budget "
              f"{budget_px:.4%}), rays {rays_g} / {rays_c}; free run's spp "
              f"maps agree {free_same:.4f}; launches {c}")
        if (overlap < 0.99 or spp_same < 0.99 or outside > budget_px
                or c["K2"] <= 0 or c["plain"]
                or (name == "random_spheres" and c["K1"] <= 0)):
            raise AssertionError(f"[64] {name}: the card's adaptive rounds "
                                 "left the CPU port's")
    shutil.rmtree(tmp, ignore_errors=True)
    return out


# the parent tree whose K6 phase 70 times in turns against this one's:
# ``build/parent`` (unpack the parent commit there with ``git archive``);
# without it the phase times this K6 alone
PARENT_TREE = os.path.join(ROOT, "build", "parent")
NONFUSED_FIXTURE = os.path.join(ROOT, "tests", "goldens",
                                "torch_port_nonfused.npz")


_PARENT_BUILD: dict = {}


def start_parent_kernels() -> None:
    """Start building the parent tree's traversal and turbulence kernels
    (``build/parent``'s ``bvh_traverse.cu`` and ``turb.cu``, each alone,
    ``tools/bvh_bench.standalone``) beside the package's build, when that
    tree holds other sources than this one's."""
    import threading

    from pathtrace_tpu_torch.tools import bvh_bench as bb

    sources = bb.tree_sources(PARENT_TREE)
    own = bb.tree_sources(ROOT)
    if not all(os.path.isfile(p_) for p_ in sources.values()) or all(
            open(sources[k], "rb").read() == open(own[k], "rb").read()
            for k in sources):
        return

    def build():
        try:
            built = bb.standalone({f"parent_{k}": (src, [])
                                   for k, src in sources.items()})
            _PARENT_BUILD["result"] = {
                "libs": {k: built[f"parent_{k}"][0] for k in sources},
                "logs": {k: built[f"parent_{k}"][1] for k in sources},
                "sources": sources}
        except Exception as exc:  # re-raised by parent_kernels
            _PARENT_BUILD["error"] = exc

    _PARENT_BUILD["thread"] = threading.Thread(target=build)
    _PARENT_BUILD["thread"].start()


def parent_kernels():
    """The parent tree's two kernels started by
    :func:`start_parent_kernels` ({"libs", "logs", "sources"}), or None
    when there is no such tree; a failed build raises."""
    thread = _PARENT_BUILD.get("thread")
    if thread is None:
        return None
    thread.join()
    if "error" in _PARENT_BUILD:
        raise _PARENT_BUILD["error"]
    return _PARENT_BUILD["result"]


def frames_in_turns(tag: str, frame, smi: str, rounds: int = 5) -> dict:
    """``frame()`` (a full frame, returning its image) timed with CUDA
    events in turns against the same frame through the parent tree's
    traversal and turbulence kernels (``rounds`` rounds of parent, this
    tree, this tree, parent), the images of both equal bit for bit; this
    tree alone when there is no parent tree."""
    import numpy as np
    import torch

    from pathtrace_tpu_torch.tools import bvh_bench as bb

    parent = parent_kernels()

    def timed(which):
        ctx = (bb.parent_kernels(parent["libs"], parent["sources"])
               if which == "parent" else contextlib.nullcontext())
        with ctx:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            img = frame()
            end.record()
            end.synchronize()
        return start.elapsed_time(end), img

    order = ("parent", "new", "new", "parent") if parent else ("new",)
    imgs = {k: timed(k)[1] for k in dict.fromkeys(order)}  # warm-up
    times = {k: [] for k in imgs}
    for _ in range(rounds):
        for which in order:
            times[which].append(timed(which)[0])
    equal = (torch.equal(imgs["new"], imgs["parent"]) if parent else None)
    row = {f"{k}_ms": v for k, v in times.items()}
    row.update({f"{k}_median_ms": float(np.median(v))
                for k, v in times.items()})
    row["equal_to_parent"] = equal
    phase(f"[{tag}] in turns ({rounds} rounds of {', '.join(order)}): "
          + "; ".join(f"{k} median {row[k + '_median_ms']:.2f} ms "
                      f"{[round(x, 2) for x in v]}" for k, v in times.items())
          + f"; images equal to the parent's kernels' {equal} ({smi})")
    if equal is False:
        raise AssertionError(f"[{tag}] the frame differs through the "
                             "parent's kernels")
    return row


def parent_k6(tree: str):
    """The parent tree's K6 (its ``csrc/sphere_nearest_bwd.cu``, the
    per-sphere sums by atomics), built alone with this package's flags
    into ``build/k6_parent``, as a function of K6's wrapper arguments; or
    None when ``tree`` has no such source or the same one as this tree
    (nothing to time in turns; the launcher's arguments are the atomic
    K6's, which a parent with the fixed-order K6 does not take)."""
    import ctypes

    import torch

    from pathtrace_tpu_torch.ops import _cuda_build

    src = os.path.join(tree, "pathtrace_tpu_torch", "csrc",
                       "sphere_nearest_bwd.cu")
    own = os.path.join(ROOT, "pathtrace_tpu_torch", "csrc",
                       "sphere_nearest_bwd.cu")
    if not os.path.isfile(src) or open(src, "rb").read() == open(
            own, "rb").read():
        return None
    out_dir = os.path.join(ROOT, "build", "k6_parent")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libk6_parent.so")
    subprocess.run([_cuda_build.find_nvcc(), *_cuda_build.NVCC_FLAGS,
                    "-shared", "-o", lib_path, src], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(lib_path).pt_sphere_nearest_bwd
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 6 + [ci] + [vp] * 5 + [ci, cf, cf] + [vp] * 8 + [
        ci, ci, vp]
    fn.restype = ci

    def run(center, radius, ro, rd, t, idx, g_t, motion=None):
        R, N = t.shape[0], radius.shape[0]
        moving = motion is not None
        g = [torch.zeros_like(center), torch.zeros_like(radius),
             torch.empty_like(ro), torch.empty_like(rd)]
        delta = time0 = inv_dt = time_ = None
        if moving:
            delta, time0, inv_dt, time_ = motion
            g += [torch.zeros_like(delta), torch.zeros_like(time0),
                  torch.zeros_like(inv_dt), torch.empty_like(time_)]
        g_c, g_r, g_ro, g_rd, g_d, g_t0, g_i, g_tm = (g + [None] * 4)[:8]

        def p(x):
            return None if x is None else x.data_ptr()

        # the parent's rule: a block per 1024 rays, its sums in shared
        # memory while they fit in 227 KB
        quads = -(-R // 4)
        blocks = max(1, -(-quads // 256))
        shared = (9 if moving else 4) * 4 * N <= 232_448
        code = fn(p(ro), p(rd), p(time_), p(t), p(idx), p(g_t), R, p(center),
                  p(delta), p(time0), p(inv_dt), p(radius), N, 1e-3, 1e30,
                  p(g_ro), p(g_rd), p(g_tm), p(g_c), p(g_d), p(g_t0), p(g_i),
                  p(g_r), blocks, int(shared),
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"the parent's K6 failed to launch ({code})")
        return tuple(g)

    return run


def nonfused_phases(dev, smi: str, k1, k2, k7) -> dict:
    """Phases 65-70, the last render slice: ``final_full`` on the fast
    path (plain, NEE and roulette, ``-B``), the [R, N] sweeps' crossover,
    NEE for textured lights on both routes, and K6's fixed-order sums.
    Returns the numbers the kernels line carries."""
    import dataclasses

    import numpy as np
    import torch

    from pathtrace_tpu_torch.examples import inverse_render
    from pathtrace_tpu_torch.models import build
    from pathtrace_tpu_torch.models import bvh as pbvh
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import box_media_kernel as bmk
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.ops import intersect_box as ib
    from pathtrace_tpu_torch.ops.lights import build_light_table
    from pathtrace_tpu_torch.parallel.inverse import make_inverse_renderer
    from pathtrace_tpu_torch.render import compaction, progressive
    from pathtrace_tpu_torch.render.frame import generate_primary_rays
    from pathtrace_tpu_torch.tools import profile_step
    from pathtrace_tpu_torch.tools.profile_step import device_launches
    from pathtrace_tpu_torch.utils.threefry import PRNGKey, fold_in
    from torch_port_util import DEPTH10_BUDGET, check_slice_contract

    out = {}
    fixture = np.load(NONFUSED_FIXTURE)

    def pixels_outside(img, ref):
        img, ref = img.double(), ref.double()
        bad = ~((img - ref).abs() <= ATOL + RTOL * ref.abs()).all(dim=-1)
        return int(bad.sum()), float(bad.double().mean())

    def fixture_case(tag, case, scene_):
        """``trace_fast`` on the card of a case of the non-fused fixture
        (NEE and roulette): (share outside, launches)."""
        sdev = scene_.to(dev)
        rays = [torch.from_numpy(fixture[f"{case}.{k}"]).to(dev)
                for k in ("ro", "rd", "time")]
        reset_counts(k1, k2, k7)
        res = fp.trace_fast(sdev, *rays, int(fixture["seed"]),
                            int(fixture["max_depth"]),
                            SceneFeatures.from_scene(sdev), min_size=128,
                            nee_lights=build_light_table(sdev),
                            rr_start=int(fixture["rr_start"]))
        rad = res.radiance.cpu().numpy()
        counts = read_counts(k1, k2, k7)
        share = check_slice_contract(
            rad, int(res.ray_count), fixture[f"{case}.radiance"],
            fixture[f"{case}.ray_count"], int(fixture["max_depth"]),
            budget=DEPTH10_BUDGET)
        phase(f"[{tag}] {case}: {share:.4%} of {rad.shape[0]} rays outside "
              f"1e-3 of the JAX fixture (budget {DEPTH10_BUDGET:.0%}), "
              f"segments {int(res.ray_count)} vs "
              f"{int(fixture[f'{case}.ray_count'])}; launches {counts}")
        if counts["plain"] or not np.isfinite(rad).all():
            raise AssertionError(f"[{tag}] {case}: failed its checks")
        return share, counts

    # ---- 65: final_full on auto -> fast (the non-fused bounce) ----
    scene, cam = presets.from_name("final_full", WIDTH / HEIGHT)
    feats = SceneFeatures.from_scene(scene)
    routes = {"auto": progressive.route(scene, feats, "auto"),
              "auto -B": progressive.route(scene, feats, "auto",
                                           use_bvh=True)}
    if (set(routes.values()) != {"fast"}
            or fp.fused_shade_supported(feats)):
        raise AssertionError(f"[65] final_full routes {routes}")
    reset_counts(k1, k2, k7)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = profile_step.main(["--what", "frame", "--preset", "final_full",
                                "--warmup", "1", "--reps", "3"])
    c65 = read_counts(k1, k2, k7)
    prof = json.loads(buf.getvalue().strip().splitlines()[-1])
    frames65 = 5  # profile_step: warm-up 1, timed 3, profiled 1
    per_bounce = prof["device_launches"] / (DEPTH + 1)
    top = [(k_["name"][:60], k_["launches"], round(k_["ms"], 3))
           for k_ in prof["top_kernels"][:6]]
    phase(f"[65] final_full {WIDTH}x{HEIGHT}x{SAMPLES} depth {DEPTH} "
          f"(auto -> fast, non-fused bounce; routes {routes}): frame median "
          f"{prof['step_ms_median']:.2f} ms of {[round(x, 2) for x in prof['step_ms']]} "
          f"(CUDA events, after 1 warm-up), {prof['segments']} segments, "
          f"{prof['readbacks']} readbacks; profiled frame: wall "
          f"{prof['profiled_wall_ms']:.2f} ms, busy {prof['device_busy_ms']:.2f} "
          f"ms (idle {prof['idle_share']:.1%}), {prof['device_launches']} "
          f"device launches (~{per_bounce:.0f} a bounce), peak "
          f"{prof['peak_gib']:.3f} GiB; K3 {c65['K3']} launches over "
          f"{frames65} frames; launches {c65}; top {top} ({smi})")
    if (rc != 0 or c65["K3"] <= 0 or c65["K1"] or c65["K2"] or c65["plain"]
            or c65["threefry"] <= 0 or c65["box_media"] <= 0
            or c65["turb"] <= 0):
        raise AssertionError("[65] final_full's fast frame failed its checks")
    gw, gh, gs, gd = 64, 48, 8, 8
    golden = torch.from_numpy(np.load(os.path.join(
        ROOT, "tests", "goldens", "pixels_final_full_fast.npz"))["img"])
    sc_, cm_ = presets.from_name("final_full", gw / gh, seed=0)
    f_ = SceneFeatures.from_scene(sc_)
    reset_counts(k1, k2, k7)
    img_card = fp.render_frame_fast(sc_.to(dev), cm_, gw, gh, gs, gd,
                                    PRNGKey(0), 0, f_).image.cpu()
    c65g = read_counts(k1, k2, k7)
    t_cpu = time.monotonic()
    img_cpu = fp.render_frame_fast(sc_, cm_, gw, gh, gs, gd, PRNGKey(0), 0,
                                   f_).image
    t_cpu = time.monotonic() - t_cpu
    budget = 1.0 - (1.0 - DEPTH10_BUDGET) ** gs
    n_g, share_g = pixels_outside(img_card, golden)
    n_c, share_c = pixels_outside(img_card, img_cpu)
    phase(f"[65] final_full {gw}x{gh}x{gs} depth {gd}: {n_g} pixels "
          f"({share_g:.4%}) outside 1e-3 of the JAX golden, {n_c} "
          f"({share_c:.4%}) of the CPU port's frame ({t_cpu:.1f} s on the "
          f"host); budget {budget:.2%}; launches {c65g}")
    if (share_g > budget or share_c > budget or c65g["plain"]
            or not bool(torch.isfinite(img_card).all())):
        raise AssertionError("[65] final_full's card frame leaves its golden")
    out["final_full"] = {
        "frame_ms": prof["step_ms"], "median_ms": prof["step_ms_median"],
        "segments": prof["segments"], "readbacks": prof["readbacks"],
        "profiled_wall_ms": prof["profiled_wall_ms"],
        "busy_ms": prof["device_busy_ms"], "idle_share": prof["idle_share"],
        "device_launches": prof["device_launches"],
        "launches_per_bounce": per_bounce, "peak_gib": prof["peak_gib"],
        "launches": c65, "k3_launches_per_frame": c65["K3"] / frames65,
        "top_kernels": prof["top_kernels"][:6],
        "golden_share_outside": share_g, "cpu_share_outside": share_c}

    # ---- 66: final_full --nee --rr 3 on the same route ----
    share66, c66 = fixture_case("66", "final_full_nee",
                                presets.final_full(16 / 9, seed=0)[0])
    sdev = scene.to(dev)
    lights = build_light_table(sdev)
    reset_counts(k1, k2, k7)
    nee_ms = []
    for k_ in range(2):  # a warm-up frame, then 1 timed
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        res = fp.render_frame_fast(sdev, cam, WIDTH, HEIGHT, SAMPLES, DEPTH,
                                   fold_in(PRNGKey(0), k_), k_, feats,
                                   nee_lights=lights, rr_start=RR_START)
        end.record()
        end.synchronize()
        nee_ms.append(start.elapsed_time(end))
    c66f = read_counts(k1, k2, k7)
    phase(f"[66] final_full --nee --rr {RR_START} {WIDTH}x{HEIGHT}x{SAMPLES} "
          f"depth {DEPTH}: frame {nee_ms[1]:.2f} ms (warm-up "
          f"{nee_ms[0]:.2f}), {int(res.ray_count)} segments, "
          f"{res.readbacks} readbacks; launches {c66f} ({smi})")
    if (c66f["K3"] <= 0 or c66f["K2"] or c66f["plain"]
            or c66f["box_media"] <= 0 or c66f["turb"] <= 0
            or not bool(torch.isfinite(res.image).all())):
        raise AssertionError("[66] final_full --nee failed its checks")
    out["final_full_nee"] = {"fixture_share_outside": share66,
                             "fixture_launches": c66, "frame_ms": nee_ms[1:],
                             "median_ms": float(np.median(nee_ms[1:])),
                             "segments": int(res.ray_count),
                             "launches": c66f}
    del res

    # ---- 67: final_full -B: auto -> fast with the tree, in turns against
    # the compacted general frame (--mode compacted) ----
    flat, _, offsets = pbvh.build_scene_bvh(scene)
    isect_fn = pbvh.make_bvh_intersect_fn(flat, offsets, feats)
    key67 = fold_in(PRNGKey(0), 3)

    def old():
        return compaction.render_frame_compacted(
            sdev, cam, WIDTH, HEIGHT, SAMPLES, DEPTH, key67, features=feats,
            intersect_fn=isect_fn)[0]

    def new():
        return fp.render_frame_fast(sdev, cam, WIDTH, HEIGHT, SAMPLES, DEPTH,
                                    key67, 3, feats, bvh=flat,
                                    bvh_offsets=offsets).image

    def timed(fn):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        img_ = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), img_

    old()
    reset_counts(k1, k2, k7)
    _, img_new = timed(new)
    c67 = read_counts(k1, k2, k7)
    t_old, t_new = [], []
    for _ in range(5):
        for which in ("old", "new", "new", "old"):
            ms_, img_ = timed(old if which == "old" else new)
            (t_old if which == "old" else t_new).append(ms_)
    img_old = img_
    per_bounce67 = {"fast": device_launches(new) / (DEPTH + 1),
                    "compacted": device_launches(old) / (DEPTH + 1)}
    phase(f"[67] final_full -B {WIDTH}x{HEIGHT}x{SAMPLES} depth {DEPTH} in "
          f"turns (5 rounds of compacted, fast, fast, compacted): fast with "
          f"the tree median {float(np.median(t_new)):.2f} ms "
          f"{[round(x, 1) for x in t_new]}, compacted median "
          f"{float(np.median(t_old)):.2f} ms {[round(x, 1) for x in t_old]}; "
          f"image means {float(img_new.mean()):.6f} / "
          f"{float(img_old.mean()):.6f}; device launches a bounce "
          f"{ {k: round(v, 1) for k, v in per_bounce67.items()} }; launches "
          f"of a fast frame {c67} ({smi})")
    if (c67["bvh"] <= 0 or c67["K3"] or c67["K2"] or c67["plain"]
            or c67["turb"] <= 0 or c67["box_media"]
            or not bool(torch.isfinite(img_new).all())):
        raise AssertionError("[67] final_full -B failed its checks")
    phase("[67] final_full -B fast, against the parent tree's traversal and "
          "turbulence kernels:")
    turns67 = frames_in_turns("67", new, smi)
    # the tree's frame against the frame without it at phase 65's key and
    # size (the card's, and JAX's golden), within the golden pixel budget
    sc_dev = sc_.to(dev)
    flat_, _, offsets_ = pbvh.build_scene_bvh(sc_dev)
    reset_counts(k1, k2, k7)
    img_tree = fp.render_frame_fast(sc_dev, cm_, gw, gh, gs, gd, PRNGKey(0),
                                    0, f_, bvh=flat_,
                                    bvh_offsets=offsets_).image.cpu()
    c67g = read_counts(k1, k2, k7)
    n_b, share_b = pixels_outside(img_tree, img_card)
    n_bg, share_bg = pixels_outside(img_tree, golden)
    phase(f"[67] final_full -B {gw}x{gh}x{gs} depth {gd}: {n_b} pixels "
          f"({share_b:.4%}) outside 1e-3 of the card's frame without the "
          f"tree (phase 65), {n_bg} ({share_bg:.4%}) of the JAX golden; "
          f"budget {budget:.2%}; launches {c67g}")
    if (share_b > budget or share_bg > budget or c67g["bvh"] <= 0
            or c67g["K3"] or c67g["plain"]
            or not bool(torch.isfinite(img_tree).all())):
        raise AssertionError("[67] final_full -B leaves the frame without "
                             "the tree")
    out["final_full_bvh"] = {
        "fast_ms": t_new, "fast_median_ms": float(np.median(t_new)),
        "compacted_ms": t_old, "compacted_median_ms": float(np.median(t_old)),
        "launches_per_bounce": per_bounce67,
        "launches": c67, "share_outside_no_tree": share_b,
        "share_outside_golden": share_bg, "turns": turns67}
    del sdev, img_new, img_old, sc_dev, img_tree

    # ---- 68: the [R, N] sweeps against the plane loops: the crossover ----
    ro, rd, _ = generate_primary_rays(cam, WIDTH, HEIGHT, SAMPLES,
                                      PRNGKey(0), device=dev)
    planes = (*ro.reshape(-1, 3).T.contiguous(),
              *rd.reshape(-1, 3).T.contiguous())
    del ro, rd
    R = planes[0].shape[0]
    R_late = 131_072  # a late rung of the ladder
    rays68 = torch.stack(planes)

    def first(prims, n):
        return dataclasses.replace(prims, **{
            f.name: getattr(prims, f.name)[:n]
            for f in dataclasses.fields(prims)})

    bld = build.SceneBuilder()
    iso = bld.constant_texture((0.7, 0.7, 0.7))
    g68 = np.random.default_rng(0)
    for i in range(400):
        c = g68.uniform((-1000.0, 0.0, -1000.0), (1000.0, 300.0, 1000.0))
        if i % 3 == 0:
            bld.medium_sphere(tuple(c), float(g68.uniform(30.0, 100.0)),
                              float(g68.uniform(1e-3, 1e-2)), iso)
        else:
            bld.medium_box(tuple(c - 50.0), tuple(c + 50.0),
                           float(g68.uniform(1e-3, 1e-2)), iso)
    media_all = bld.finish().media.to(dev)
    boxes_all = scene.boxes.to(dev)
    u_all = torch.rand((400, R), generator=torch.Generator(
        device=dev).manual_seed(68), device=dev)
    sweep = {"boxes": {}, "media": {}}
    for kind_ in ("boxes", "media"):
        for n in (2, 4, 8, 16, 32, 64, 400):
            if kind_ == "boxes":
                prims = first(boxes_all, n)
                loop_fn, rn_fn, extra = ib.box_nearest, ib.box_nearest_rn, ()
            else:
                prims = first(media_all, n)
                loop_fn, rn_fn = ib.media_nearest, ib.media_nearest_rn
                extra = (u_all[:n],)
            op68 = (bmk.pack_operand(prims, None) if kind_ == "boxes"
                    else bmk.pack_operand(None, prims))
            pick = 0 if kind_ == "boxes" else 1

            def kernel(rays_, *x):
                return bmk.box_media_nearest(op68, rays_, *x)[pick]

            a = loop_fn(prims, *planes, *extra)
            b = rn_fn(prims, *planes, *extra)
            c = kernel(rays68, *extra)
            same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            same_k = torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
            hits = float((a[0] < 1e30).float().mean())
            del a, b, c
            late = [p_[:R_late] for p_ in planes]
            late_x = tuple(x[:, :R_late] for x in extra)
            late68 = rays68[:, :R_late].contiguous()
            row = {"equal": same, "kernel_equal": same_k, "hits": hits,
                   "kernel_ms": median_ms(lambda: kernel(rays68, *extra), 5),
                   "kernel_late_ms": median_ms(
                       lambda: kernel(late68, *late_x), 5),
                   "loop_ms": median_ms(lambda: loop_fn(prims, *planes,
                                                        *extra), 2),
                   "rn_ms": median_ms(lambda: rn_fn(prims, *planes, *extra),
                                      2),
                   "loop_late_ms": median_ms(lambda: loop_fn(prims, *late,
                                                             *late_x), 2),
                   "rn_late_ms": median_ms(lambda: rn_fn(prims, *late,
                                                         *late_x), 2)}
            sweep[kind_][n] = row
            phase(f"[68] {kind_} N={n}: [R, N] == loop bit for bit: {same}, "
                  f"kernel == loop: {same_k} (hit share {hits:.3f}); {R} "
                  f"rays: loop {row['loop_ms']:.3f} ms, [R, N] "
                  f"{row['rn_ms']:.3f} ms, kernel {row['kernel_ms']:.4f} ms; "
                  f"{R_late} rays: loop {row['loop_late_ms']:.3f} ms, [R, N] "
                  f"{row['rn_late_ms']:.3f} ms, kernel "
                  f"{row['kernel_late_ms']:.4f} ms")
            if not (same and same_k):
                raise AssertionError(f"[68] {kind_} N={n}: the [R, N] form "
                                     "or the kernel differs from the loop")
    del u_all
    cross = {}
    for kind_, rows in sweep.items():
        for width, lk, rk in (("full", "loop_ms", "rn_ms"),
                              ("late", "loop_late_ms", "rn_late_ms")):
            loop_wins = [n for n, r_ in rows.items() if r_[lk] < r_[rk]]
            rn_wins = [n for n, r_ in rows.items() if r_[rk] <= r_[lk]]
            cross[f"{kind_} {width}"] = {
                "loop_faster_at": loop_wins, "rn_faster_at": rn_wins,
                "crossover": min(rn_wins) if rn_wins else None}
    phase(f"[68] crossover (the smallest N where the [R, N] form is at least "
          f"as fast): {json.dumps(cross)}; the port sweeps through the "
          f"kernel on the card, the [R, N] form on the CPU ({smi})")
    out["sweeps"] = {"rows": sweep, "crossover": cross}

    # ---- 69: NEE for textured lights, on the fused and non-fused routes ----
    tl = {}
    for case, box in (("textured_light", False), ("textured_light_box", True)):
        sc69 = presets.image_light_scene(build,
                                         presets._procedural_earth_image(),
                                         textured_light=True, box=box)
        share69, c69 = fixture_case("69", case, sc69)
        fused = case == "textured_light"
        if (c69["K1"] <= 0 or (c69["K2"] > 0) != fused
                or build_light_table(sc69).color is not None):
            raise AssertionError(f"[69] {case}: the wrong route {c69}")
        sdev = sc69.to(dev)
        f69 = SceneFeatures.from_scene(sdev)
        cam69 = presets.simple_light(WIDTH / HEIGHT)[1]
        lt = build_light_table(sdev)
        ms69 = median_ms(lambda: fp.render_frame_fast(
            sdev, cam69, WIDTH, HEIGHT, SAMPLES, DEPTH, PRNGKey(5), 5, f69,
            nee_lights=lt, rr_start=RR_START), 2)
        phase(f"[69] {case} ({'fused' if fused else 'non-fused'} route) "
              f"--nee --rr {RR_START} at {WIDTH}x{HEIGHT}x{SAMPLES} depth "
              f"{DEPTH}: median frame {ms69:.2f} ms ({smi})")
        tl[case] = {"fixture_share_outside": share69, "launches": c69,
                    "frame_median_ms": ms69}
        del sdev
    out["textured_light"] = tl

    # ---- 70: K6's fixed-order sums ----
    k6 = {}
    parent = parent_k6(PARENT_TREE)
    for pname in ("random_spheres", "random"):
        moving = pname == "random"
        sc70, cam70 = presets.from_name(pname, WIDTH / HEIGHT)
        sc70 = sc70.to(dev)
        f70 = SceneFeatures.from_scene(sc70)
        tb = fp.prep_tables(sc70, f70)
        ro_, rd_, tm_ = generate_primary_rays(cam70, WIDTH, HEIGHT, SAMPLES,
                                              PRNGKey(0), device=dev)
        st = fp.make_state(ro_.reshape(-1, 3), rd_.reshape(-1, 3),
                           tm_.reshape(-1))
        del ro_, rd_, tm_
        sp = sc70.spheres
        gen = torch.Generator(device=dev)
        gen.manual_seed(70)
        for label in ("camera", "scattered"):
            rays = st.planes[:6]
            if moving:
                t_, idx_ = k1.sphere_nearest_moving(tb.soa, rays, st.time)
            else:
                t_, idx_ = k1.sphere_nearest(tb.soa, rays)
            ro_ = rays[:3].T.contiguous()
            rd_ = rays[3:6].T.contiguous()
            g_t = torch.rand(t_.shape[0], generator=gen, device=dev) + 0.5
            args = (sp.center, sp.radius, ro_, rd_, t_, idx_, g_t)
            motion = ((sp.center_delta, sp.time0, sp.inv_time_delta,
                       st.time.contiguous()) if moving else None)
            runs = [k1.sphere_nearest_bwd(*args, motion=motion)
                    for _ in range(3)]
            repeat = all(torch.equal(a, b) for r_ in runs[1:]
                         for a, b in zip(runs[0], r_))
            ref = k1.sphere_nearest_bwd_plain(*args, motion=motion)
            sph = max(rel_l2(runs[0][k_], ref[k_])
                      for k_ in ((0, 1, 4, 5, 6) if moving else (0, 1)))
            per_ray = all(torch.equal(runs[0][k_], ref[k_])
                          for k_ in ((2, 3, 7) if moving else (2, 3)))
            del runs, ref
            new_ms, old_ms = [], []
            for _ in range(3 if parent is not None else 1):
                order = (("old", "new", "new", "old") if parent is not None
                         else ("new",))
                for which in order:
                    if which == "new":
                        new_ms.append(time_ms(lambda: k1.sphere_nearest_bwd(
                            *args, motion=motion), 20))
                    else:
                        old_ms.append(time_ms(lambda: parent(
                            *args, motion=motion), 20))
            row = {"repeat_bitwise": repeat, "per_ray_equal_plain": per_ray,
                   "sphere_rel_l2": sph, "ms": new_ms,
                   "ms_median": float(np.median(new_ms)),
                   "parent_ms": old_ms or None,
                   "parent_median_ms": (float(np.median(old_ms)) if old_ms
                                        else None),
                   "launch": list(k1.bwd_launch(t_.shape[0],
                                                sp.radius.shape[0], moving))}
            k6[f"{pname} {label}"] = row
            phase(f"[70] K6 {pname} {label} winners ({t_.shape[0]} rays, "
                  f"{'moving' if moving else 'static'}): 3 runs bit for bit "
                  f"{repeat}, per-ray == plain {per_ray}, per-sphere rel L2 "
                  f"{sph:.3e}; {row['launch'][0]} blocks, sums in "
                  f"{'shared' if row['launch'][1] else 'device'} memory; "
                  f"kernel {[round(x, 4) for x in new_ms]} ms, parent "
                  + (f"{[round(x, 4) for x in old_ms]} ms (in turns)"
                     if old_ms else f"not timed (no tree at {PARENT_TREE}, "
                     f"or its K6 source is this tree's)")
                  + f" ({smi})")
            if not (repeat and per_ray) or sph > K6_SPHERE_RTOL:
                raise AssertionError(f"[70] K6 {pname} {label} failed")
            if label == "camera":
                planes_, alive_ = k2.shade_from_winners(
                    tb.table, idx_, t_, st.planes, st.time, st.alive,
                    st.lane, 7, 0, DEPTH, tb.sky4, fp.feature_flags(f70))
                st = fp.FastStateP(planes_[:12].contiguous(), st.time,
                                   alive_, st.lane)
        del sc70, tb, st
    # two --geometry steps from one state, full width, as --checkpoint runs
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        steps = []
        for _ in range(2):
            sc70, cam70 = presets.random_spheres(WIDTH / HEIGHT)
            r_, s_, names_ = make_inverse_renderer(
                sc70, cam70, WIDTH, HEIGHT, samples=SAMPLES, max_depth=4,
                device=dev, silhouette=True,
                trainable=lambda p: ("textures.color" in p
                                     or p == "spheres.center"))
            with torch.no_grad():  # the example's start: centres moved
                target = r_.render(s_.params, PRNGKey(0))
                for name_, p_ in zip(names_, s_.params):
                    if name_ == "spheres.center":
                        p_[:, 0] += 0.05
            reset_counts(k1, k2, k7)
            s_, loss = r_.train_step(s_, target, PRNGKey(0))
            c70 = read_counts(k1, k2, k7)
            steps.append([float(loss)] + [p_.grad.clone() for p_ in s_.params]
                         + [p_.detach().clone() for p_ in s_.params])
            del r_, s_, target
        step_equal = steps[0][0] == steps[1][0] and all(
            torch.equal(a, b) for a, b in zip(steps[0][1:], steps[1][1:]))
    finally:
        torch.use_deterministic_algorithms(before)
    del steps
    # the example's --geometry run: 4 steps against 2, a checkpoint, then 2
    with tempfile.TemporaryDirectory() as tmp:
        ex = ["--geometry", "--preset", "random_spheres", "--size", "96",
              "--device", "cuda"]
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rcs = [inverse_render.main(ex + [
                "--steps", "4", "--checkpoint", os.path.join(tmp, "a.npz"),
                "--out", os.path.join(tmp, "a.npy")])]
            for n in ("2", "4"):
                rcs.append(inverse_render.main(ex + [
                    "--steps", n, "--checkpoint", os.path.join(tmp, "b.npz"),
                    "--out", os.path.join(tmp, "b.npy")]))
        resumed = "resumed from" in buf.getvalue()
        with np.load(os.path.join(tmp, "a.npz")) as za, \
                np.load(os.path.join(tmp, "b.npz")) as zb:
            ck_equal = (za.files == zb.files and all(
                np.array_equal(za[k], zb[k]) for k in za.files))
        img_equal = bool(np.array_equal(np.load(os.path.join(tmp, "a.npy")),
                                        np.load(os.path.join(tmp, "b.npy"))))
    phase(f"[70] two --geometry steps (random_spheres {WIDTH}x{HEIGHT}x"
          f"{SAMPLES} depth 4, silhouette term, deterministic algorithms) "
          f"from one state: loss, gradients and parameters bit for bit "
          f"{step_equal}; launches {c70}; the example's --geometry 4 steps "
          f"== 2 + checkpoint + 2: checkpoint leaves {ck_equal}, images "
          f"{img_equal} (resumed {resumed}); return codes {rcs}")
    if (not (step_equal and ck_equal and img_equal and resumed) or any(rcs)
            or c70["K6"] <= 0 or c70["plain"]):
        raise AssertionError("[70] the geometry runs are not bit-exact")
    out["k6"] = {"runs": k6, "geometry_steps_equal": step_equal,
                 "geometry_resume_equal": ck_equal and img_equal,
                 "geometry_step_launches": c70}
    return out


def wide_phases(dev, smi: str, k1, k2, k7) -> dict:
    """Phases 71-73: the wide-node tree's traversal kernel against its
    plain version and the flat tree's kernel, full-width frames through
    either tree, and the interleaved ladder. Returns the numbers the
    kernels line carries."""
    import torch

    from pathtrace_tpu_torch.models import bvh as pbvh
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import bvh_kernel
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.render import integrator as gint
    from pathtrace_tpu_torch.render.frame import generate_primary_rays
    from pathtrace_tpu_torch.tools import ladder_ab
    from pathtrace_tpu_torch.tools import nearest_bench as nb
    from pathtrace_tpu_torch.utils.threefry import PRNGKey, fold_in

    out = {}
    R = WIDTH * HEIGHT * SAMPLES

    # ---- 71: the wide kernel against its plain version and the flat one
    regs = next(iter(nb.ptxas_usage("bvh_wide_traverse_kernel").values()),
                None)
    phase(f"[71] bvh_wide_traverse_kernel registers and spills (ptxas): "
          f"{regs}")
    scenes = {}
    max_err = 0.0
    for name in ("random_spheres", "random_spheres_xl", "random",
                 "cornell_smoke", "final_full"):
        scene_, cam_ = presets.from_name(name, WIDTH / HEIGHT)
        feats_ = SceneFeatures.from_scene(scene_)
        flat, _, offsets = pbvh.build_scene_bvh(scene_)
        t0 = time.perf_counter()
        wide = pbvh.widen_flat_bvh(flat, scene_, offsets, features=feats_)
        widen_s = time.perf_counter() - t0
        sdev = scene_.to(dev)
        op_f = flat.operand(sdev, feats_, offsets, dev)
        op_w = wide.operand(sdev, feats_, offsets, dev)
        n_media = sdev.media.count if feats_.has_media else 0
        ro, rd, tm = generate_primary_rays(cam_, WIDTH, HEIGHT, SAMPLES,
                                           PRNGKey(0), device=dev)
        st0 = fp.make_state(ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R))

        def flights_at(depth):
            if not feats_.has_media:
                return None
            return bvh_kernel.media_flights(op_w, fp.media_uniforms(
                st0.lane, 7, depth, n_media, 8))

        if fp.fused_refusal(feats_, sdev) is None:
            tables = fp.prep_tables(sdev, feats_, bvh=flat,
                                    bvh_offsets=offsets)
            t_, idx_ = fp.closest_hit(tables, st0, 0, feats_, 7)
            planes, _ = k2.shade_from_winners(
                tables.table, idx_, t_, st0.planes, st0.time, st0.alive,
                st0.lane, 7, 0, DEPTH, tables.sky4, fp.feature_flags(feats_),
                atlas=tables.atlas)
            rays1 = planes[:6].contiguous()
            del tables, planes
        else:  # final_full: the general bounce's scattered rays
            fn = pbvh.make_bvh_intersect_fn(flat, offsets, feats_)
            gt = gint.prep_tables(sdev, feats_)
            st1 = gint._bounce(sdev, gt, gint._initial_state(
                ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R)),
                PRNGKey(7), DEPTH, feats_, intersect_fn=fn)
            rays1 = torch.cat([st1.ro.T, st1.rd.T]).contiguous()
            del gt, st1
        sets = {"camera": (st0.planes[:6], st0.time, flights_at(0)),
                "scattered": (rays1, st0.time, flights_at(1))}
        runs = {}
        for label, (rays, time_, fl) in sets.items():
            t, gid, vis = bvh_kernel.bvh_traverse(op_w, rays, time_, fl,
                                                  visits=True)
            tf_, gf, vf = bvh_kernel.bvh_traverse(op_f, rays, time_, fl,
                                                  visits=True)
            tp, gp, vp, tests = bvh_kernel.wide_traverse_plain(
                op_w, rays, time_, fl, stats=True)
            torch.cuda.synchronize()
            same_plain = (torch.equal(t, tp) and torch.equal(gid, gp)
                          and torch.equal(vis, vp))
            same_flat = torch.equal(t, tf_) and torch.equal(gid, gf)
            hit = t < 1e30
            err = (float((t[hit] - tp[hit]).abs().max()) if bool(hit.any())
                   else 0.0)
            max_err = max(max_err, err)
            ms = median_ms(lambda: bvh_kernel.bvh_traverse(op_w, rays, time_,
                                                           fl), 10)
            flat_ms = median_ms(lambda: bvh_kernel.bvh_traverse(
                op_f, rays, time_, fl), 10)
            t0 = time.perf_counter()
            bvh_kernel.wide_traverse_plain(op_w, rays, time_, fl)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            ys = bvh_kernel.wide_yardsticks(op_w, R, vp, tests, n_media)
            runs[label] = {
                "rays": R, "hit_share": float(hit.float().mean()),
                "equal_to_plain": same_plain, "equal_to_flat": same_flat,
                "max_abs_err": err, "ms": ms, "flat_ms": flat_ms,
                "plain_ms": plain_ms, "bound_ms": ys["bound_ms"],
                "bound_by": ys["bound_by"],
                "issue_ceiling_ms": ys["issue_ceiling_ms"],
                "bytes_ms": ys["bytes_ms"],
                "share_of_bound": ys["bound_ms"] / ms,
                "mean_visits": ys["mean_visits"],
                "max_visits": ys["max_visits"],
                "flat_mean_visits": float(vf.double().mean()),
                "flat_max_visits": int(vf.max()),
                "leaf_tests": ys["leaf_tests"], "library_ms": None}
            phase(f"[71] {name} {label}: {R} rays, hit "
                  f"{runs[label]['hit_share']:.4f}; t, gid, visits equal to "
                  f"plain: {same_plain}; (t, gid) equal to the flat kernel: "
                  f"{same_flat}; wide {ms:.4f} ms, flat {flat_ms:.4f} ms "
                  f"(medians of 10; wide/flat {ms / flat_ms:.3f}), plain "
                  f"{plain_ms:.1f} ms, bound {ys['bound_ms']:.4f} ms "
                  f"({ys['bound_by']}; {ys['bound_ms'] / ms:.1%} of it); "
                  f"visits a ray wide {ys['mean_visits']:.2f} (max "
                  f"{ys['max_visits']}) against flat "
                  f"{runs[label]['flat_mean_visits']:.2f} (max "
                  f"{runs[label]['flat_max_visits']}); leaf tests "
                  f"{ys['leaf_tests']} ({smi})")
            if not (same_plain and same_flat):
                raise AssertionError(f"{name} {label}: the wide kernel "
                                     "differs from its plain version or "
                                     "from the flat kernel")
        scenes[name] = {"nodes": wide.n_nodes, "flat_nodes": flat.n_nodes,
                        "leaf_m": wide.leaf_m, "node_rows": op_w.node_rows,
                        "widen_s": widen_s, **runs}
        phase(f"[71] {name}: wide tree {wide.n_nodes} nodes (leaf_m "
              f"{wide.leaf_m}, {op_w.node_rows} float4 rows a node, widened "
              f"in {widen_s:.3f} s) against the flat tree's {flat.n_nodes}")
        del sdev, op_f, op_w, st0, sets, rays1
    out["scenes"] = scenes
    out["registers"] = regs
    out["max_abs_err"] = max_err

    # ---- 72: full-width frames through either tree, in turns ----
    frames = {}
    for name in ("random_spheres", "random_spheres_xl"):
        scene_, cam_ = presets.from_name(name, WIDTH / HEIGHT)
        feats_ = SceneFeatures.from_scene(scene_)
        flat, _, offsets = pbvh.build_scene_bvh(scene_)
        wide = pbvh.widen_flat_bvh(flat, scene_, offsets, features=feats_)
        sdev, cdev = scene_.to(dev), cam_.to(dev)
        key = fold_in(PRNGKey(0), 2)
        trees = {"flat": flat, "wide": wide}

        def frame(tree):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            res = fp.render_frame_fast(sdev, cdev, WIDTH, HEIGHT, SAMPLES,
                                       DEPTH, key, 7, feats_,
                                       bvh=trees[tree], bvh_offsets=offsets)
            end.record()
            end.synchronize()
            return start.elapsed_time(end), res

        imgs, counts = {}, {}
        for tree in ("flat", "wide"):   # warm-up, the images, the launches
            reset_counts(k1, k2, k7)
            _, res = frame(tree)
            counts[tree] = read_counts(k1, k2, k7)
            imgs[tree] = (res.image, int(res.ray_count), res.readbacks)
        times = {"flat": [], "wide": []}
        for _ in range(3):
            for tree in ("flat", "wide", "wide", "flat"):
                times[tree].append(frame(tree)[0])
        same = (torch.equal(imgs["flat"][0], imgs["wide"][0])
                and imgs["flat"][1] == imgs["wide"][1])
        c = counts["wide"]
        entry = {"equal": same, "segments": imgs["wide"][1],
                 "readbacks": imgs["wide"][2], "launches": c,
                 "flat_launches": counts["flat"],
                 **{f"{t}_ms": times[t] for t in times},
                 **{f"{t}_median_ms": float(sorted(times[t])[len(times[t])
                                                              // 2])
                    for t in times}}
        frames[name] = entry
        phase(f"[72] {name} {WIDTH}x{HEIGHT}x{SAMPLES} depth {DEPTH}: wide "
              f"frame == flat frame bit for bit: {same}; {imgs['wide'][1]} "
              f"segments, {imgs['wide'][2]} readbacks; in turns (3 rounds of "
              f"flat, wide, wide, flat): wide "
              f"{[round(x, 2) for x in times['wide']]} ms (median "
              f"{entry['wide_median_ms']:.2f}), flat "
              f"{[round(x, 2) for x in times['flat']]} (median "
              f"{entry['flat_median_ms']:.2f}); launches of the wide frame "
              f"{c} ({smi})")
        if (not same or c["bvh_wide"] <= 0 or c["K2"] <= 0 or c["K1"]
                or c["bvh"] or c["plain"]):
            raise AssertionError(f"{name}: the wide frame failed its checks")
        del sdev, cdev
    out["frames"] = frames

    # ---- 73: the interleaved ladder and -B's thresholds, in turns ----
    knobs = {k: getattr(fp, k) for k in ("INTERLEAVE_CHUNK", "COUNT_SKIP_SIZE",
                                         "ROW_SHRINK", "COMPACT_SHRINK",
                                         "SMALL_SHRINK")}
    phase(f"[73] ladder knobs: {knobs}")
    lad = ladder_ab.run_pairs(ladder_ab.PAIRS, 5, dev,
                              log=lambda ln: phase(f"[73] {ln}"))
    phase(f"[73] medians B / A: {json.dumps(lad['pairs'])} ({smi})")
    out["ladder"] = {"knobs": knobs, **lad}
    return out


def box_turb_phases(dev, smi: str, k1, k2, k7, build_log: str) -> dict:
    """Phases 74-76: the box and media sweep's kernel
    (``csrc/box_media_nearest.cu``) and the turbulence's (``csrc/turb.cu``)
    against their plain versions, and ``final_full``'s routes in turns.
    Returns the two kernels' rows of the kernels line."""
    import dataclasses

    import numpy as np
    import torch

    from pathtrace_tpu_torch.config import MAX_T, MIN_T
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import TEX_NOISE, SceneFeatures
    from pathtrace_tpu_torch.ops import _cuda_build
    from pathtrace_tpu_torch.ops import box_media_kernel as bmk
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.ops import intersect_box as ib
    from pathtrace_tpu_torch.ops import turb_kernel as tk
    from pathtrace_tpu_torch.tools import bvh_bench as bb
    from pathtrace_tpu_torch.ops.lights import build_light_table
    from pathtrace_tpu_torch.render.frame import (
        generate_primary_rays, render_frame,
    )
    from pathtrace_tpu_torch.tools import nearest_bench as nb
    from pathtrace_tpu_torch.tools.profile_step import device_launches
    from pathtrace_tpu_torch.utils.threefry import PRNGKey, fold_in
    from torch_port_util import (
        diff_box_media_grads, many_boxes_and_media, plain_box_media_and_turb,
    )
    from torch_port_util import rel_l2 as rel_l2_np

    R = WIDTH * HEIGHT * SAMPLES
    scene, cam = presets.from_name("final_full", WIDTH / HEIGHT)
    sdev = scene.to(dev)
    feats = SceneFeatures.from_scene(sdev)
    tables = fp.prep_tables(sdev, feats)
    n_med = sdev.media.count
    ro, rd, tm = generate_primary_rays(cam, WIDTH, HEIGHT, SAMPLES,
                                       PRNGKey(0), device=dev)
    ro, rd, tm = ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R)
    lane, alive = fp.lane_ids(R, dev)
    st0 = fp.FastState(ro=ro, rd=rd, time=tm, radiance=torch.zeros_like(ro),
                       throughput=torch.ones_like(ro), alive=alive,
                       lane=lane)
    with torch.no_grad():  # one non-fused bounce: the scattered rays
        st1, _ = fp.fast_bounce(tables.table, tables.soa, sdev, st0, 7, 0,
                                DEPTH, feats, tables=tables)
    sets = {"camera": (ro, rd, 0), "scattered": (st1.ro, st1.rd, 1)}

    def rays_of(label):
        ro_, rd_, depth = sets[label]
        return (torch.cat([ro_.T, rd_.T]).contiguous(),
                torch.stack(fp.media_uniforms(lane, 7, depth, n_med, 8)))

    def first(prims, n):
        return dataclasses.replace(prims, **{
            f.name: getattr(prims, f.name)[:n]
            for f in dataclasses.fields(prims)})

    def plain_pair(op, rays, u):
        return ((ib.box_nearest_rn(op.boxes, *rays)
                 if op.boxes is not None else None),
                (ib.media_nearest_rn(op.media, *rays, u)
                 if op.media is not None else None))

    # ---- 74: the box and media kernel against the plain [R, N] forms ----
    cam_rays, cam_u = rays_of("camera")
    sc_rays, sc_u = rays_of("scattered")
    cases = [("final_full camera", tables.box_media, cam_rays, cam_u),
             ("final_full scattered", tables.box_media, sc_rays, sc_u)]
    for cname in ("cornell", "cornell_smoke"):
        sc_, cm_ = presets.from_name(cname, WIDTH / HEIGHT)
        sc_ = sc_.to(dev)
        f_ = SceneFeatures.from_scene(sc_)
        ro_, rd_, _ = generate_primary_rays(cm_, WIDTH, HEIGHT, SAMPLES,
                                            PRNGKey(0), device=dev)
        cases.append((
            f"{cname} camera",
            bmk.box_media_operand(sc_, f_),
            torch.cat([ro_.reshape(R, 3).T, rd_.reshape(R, 3).T]).contiguous(),
            (torch.stack(fp.media_uniforms(lane, 7, 0, sc_.media.count, 8))
             if f_.has_media else None)))
        del ro_, rd_
    rag = (1 << 20) + 3
    with torch.no_grad():
        t_b, i_b = ib.box_nearest_rn(sdev.boxes, *cam_rays)
        j = int(torch.mode(i_b[t_b < 1e30]).values)
        one_box = dataclasses.replace(sdev.boxes, **{
            f.name: getattr(sdev.boxes, f.name)[j:j + 1]
            for f in dataclasses.fields(sdev.boxes)})
        del t_b, i_b
    many = many_boxes_and_media(1000, 500).to(dev)
    n_many = 1 << 18
    cases += [
        ("final_full ragged 2^20 + 3", tables.box_media,
         cam_rays[:, :rag].contiguous(), cam_u[:, :rag].contiguous()),
        ("final_full N = 1 (its most hit box, its first medium)",
         bmk.pack_operand(one_box, first(sdev.media, 1)), cam_rays,
         cam_u[:1].contiguous()),
        ("1000 boxes, 500 media (3 box tiles, 2 media tiles)",
         bmk.pack_operand(many.boxes, many.media),
         cam_rays[:, :n_many].contiguous(),
         torch.rand((500, n_many), device=dev, generator=torch.Generator(
             device=dev).manual_seed(74))),
        ("final_full boxes, no media", bmk.pack_operand(sdev.boxes, None),
         cam_rays, None),
        ("final_full media, no boxes", bmk.pack_operand(None, sdev.media),
         cam_rays, cam_u)]
    rows74, max_err, all_equal = {}, 0.0, True
    for name, op, rays, u in cases:
        kern = bmk.box_media_nearest(op, rays, u)
        plain = plain_pair(op, rays, u)
        row = {"rays": rays.shape[1],
               "boxes": op.boxes.count if op.boxes is not None else 0,
               "media": op.media.count if op.media is not None else 0}
        equal = True
        for kind_, a, b in (("box", *(x[0] for x in (kern, plain))),
                            ("media", *(x[1] for x in (kern, plain)))):
            if b is None:
                equal = equal and a is None
                continue
            eq = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            equal = equal and eq
            max_err = max(max_err, float((a[0].double() - b[0].double())
                                         .abs().max()))
            row[f"{kind_}_hit_share"] = float((b[0] < 1e30).float().mean())
        row["equal"] = equal
        all_equal = all_equal and equal
        del kern, plain
        if name.startswith("final_full") and name.endswith(("camera",
                                                            "scattered")):
            flights = bmk.media_flights(op.media.density, u)
            row["ms"] = median_ms(lambda: bmk._launch(op, rays, flights,
                                                      MIN_T, MAX_T), 10)
            row["wrapper_ms"] = median_ms(
                lambda: bmk.box_media_nearest(op, rays, u), 10)
            row["plain_ms"] = median_ms(lambda: plain_pair(op, rays, u), 2)
            row.update(bmk.yardsticks(rays.shape[1], row["boxes"],
                                      row["media"]))
            del flights
        rows74[name] = row
        phase(f"[74] box/media kernel == plain [R, N] forms (t, idx) bit for "
              f"bit on {name} ({row['rays']} rays, {row['boxes']} boxes, "
              f"{row['media']} media): {equal}; hit shares "
              f"{ {k: round(v, 4) for k, v in row.items() if 'hit' in k} }"
              + (f"; kernel {row['ms']:.4f} ms (with the flights' plain "
                 f"launches {row['wrapper_ms']:.4f}), plain {row['plain_ms']:.3f} "
                 f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
                 f"{row['bound_ms'] / row['ms']:.1%} of it) ({smi})"
                 if "ms" in row else ""))
        if not equal:
            raise AssertionError(f"[74] {name}: the kernel differs from the "
                                 "plain version")
    del cases, many
    # the winners' t recomputed where autograd needs it == the kernel's t
    ro_g = ro.clone().requires_grad_(True)
    kb, km = bmk.box_media_nearest(tables.box_media, cam_rays, cam_u)
    gb, gm = bmk.box_media_hits(tables.box_media, ro_g, rd, cam_u)
    recompute_equal = (gb[0].requires_grad and torch.equal(gb[0].detach(), kb[0])
                       and torch.equal(gm[0].detach(), km[0])
                       and torch.equal(gb[1], kb[1])
                       and torch.equal(gm[1], km[1]))
    del ro_g, kb, km, gb, gm
    # trace_fast_diff's gradients through the kernels == the [R, N] forms'
    launches, turb_bwd = bmk.LAUNCHES, tk.BWD_PLAIN_CALLS
    rad, grads = diff_box_media_grads(dev, size=64)
    diff_launches = bmk.LAUNCHES - launches
    turb_bwd = tk.BWD_PLAIN_CALLS - turb_bwd
    with plain_box_media_and_turb():
        rad_p, grads_p = diff_box_media_grads(dev, size=64)
    grad_rel = {n_: rel_l2_np(grads[n_].cpu().numpy(), g_.cpu().numpy())
                for n_, g_ in grads_p.items()}
    diff_ok = (torch.equal(rad, rad_p) and max(grad_rel.values()) <= 1e-5
               and diff_launches > 0
               and float(grads["boxes.p0"].abs().max()) > 0.0
               and float(grads["media.density"].abs().max()) > 0.0)
    phase(f"[74] recomputed winners' t == the kernel's (final_full camera "
          f"rays, under autograd): {recompute_equal}; trace_fast_diff of the "
          f"marble-smoke scene (64x64, depth 4) through the kernel "
          f"({diff_launches} launches; the turbulence's plain backward on "
          f"its masked-in lanes {turb_bwd} times) == through the [R, N] "
          f"forms: radiance "
          f"bit for bit {torch.equal(rad, rad_p)}, gradients rel L2 "
          f"{ {k: float(f'{v:.3e}') for k, v in grad_rel.items()} }")
    if not (recompute_equal and diff_ok):
        raise AssertionError("[74] the recomputed t or the diff gradients "
                             "differ")
    del rad, rad_p, grads, grads_p

    # ---- 75: the turbulence kernel against fast_turb_c, and in turns
    # against the parent tree's (build/parent, when present) ----
    rows75 = {}
    parent = parent_kernels()
    tfns = {"new": bb.turb_fn(_cuda_build.library(),
                              bb.tree_sources(ROOT)["turb"])}
    if parent is not None:
        tfns = {"parent": bb.turb_fn(parent["libs"]["turb"],
                                     parent["sources"]["turb"]), **tfns}
        phase(f"[75] the parent tree's kernel ({parent['sources']['turb']}), "
              f"built alone: "
              f"{nb.ptxas_usage('turb_cu', parent['logs']['turb'])}")
    with torch.no_grad():
        for label in ("camera", "scattered"):
            ro_, rd_, depth = sets[label]
            t_, attrs = fp.nearest_hit_attrs(
                tables.table, tables.soa, sdev, ro_, rd_, tm, feats,
                fp.media_uniforms(lane, 7, depth, n_med, 8),
                box_media=tables.box_media)
            point = (ro_ + torch.where(t_ < MAX_T, t_, 0.0)[:, None]
                     * rd_).contiguous()
            mask = attrs[:, 3] == float(TEX_NOISE)
            del t_, attrs
            # a ragged window of lanes around the first that wears the noise
            lo = max(0, min(int(mask.nonzero()[0]) - rag // 2, R - rag))
            for sub_label, p_, m_ in ((label, point, mask),
                                      (f"{label} ragged 2^20 + 3",
                                       point[lo:lo + rag], mask[lo:lo + rag])):
                got = tk.noise_turb(p_, m_)
                ref = tk.turb_plain(p_, m_)
                equal = torch.equal(got.view(torch.int32),
                                    ref.view(torch.int32))
                row = {"lanes": p_.shape[0], "noise_lanes": int(m_.sum()),
                       "equal": equal,
                       "max_abs_err": float((got - ref).abs().max())}
                if sub_label == label:
                    row["ms"] = median_ms(lambda: tk.noise_turb(p_, m_), 20)
                    row["plain_ms"] = median_ms(
                        lambda: tk.turb_plain(p_, m_), 2)
                    row.update(tk.yardsticks(p_.shape[0], row["noise_lanes"]))
                    # in turns against the parent tree's kernel
                    turns = bb.in_turns({k: (lambda f=f_: f(p_, m_))
                                         for k, f_ in tfns.items()}, 5, 20)
                    row["turns_ms"] = turns
                    row["turns_median_ms"] = {k: bb.median(v)
                                              for k, v in turns.items()}
                    row["parent_ms"] = row["turns_median_ms"].get("parent")
                    if "parent" in tfns:
                        same_parent = torch.equal(
                            tfns["parent"](p_, m_).view(torch.int32),
                            ref.view(torch.int32))
                        if not same_parent:
                            raise AssertionError(f"[75] {label}: the parent's "
                                                 "kernel differs")
                rows75[sub_label] = row
                phase(f"[75] turbulence kernel == fast_turb_c bit for bit on "
                      f"{sub_label} ({row['lanes']} lanes, "
                      f"{row['noise_lanes']} wear the noise): {equal}"
                      + (f"; kernel {row['ms']:.4f} ms (the wrapper, median "
                         f"of 20), in turns (5 rounds of "
                         f"{', '.join(list(tfns) + list(tfns)[::-1])}, 20 "
                         f"launches a turn, queued behind a device sleep) "
                         f"{json.dumps({k: round(v, 4) for k, v in row['turns_median_ms'].items()})} "
                         f"ms; plain {row['plain_ms']:.3f} ms, bound "
                         f"{row['bound_ms']:.4f} ms ({row['bound_by']}) "
                         f"({smi})" if "ms" in row else ""))
                if not equal or row["noise_lanes"] <= 0:
                    raise AssertionError(f"[75] {sub_label}: the turbulence "
                                         "kernel differs")
            if label == "camera":
                # the mask's edges: no noise lane, every lane, one lane
                one = torch.zeros_like(mask)
                one[int(mask.nonzero()[0])] = True
                for edge, m_ in (("no noise lane", torch.zeros_like(mask)),
                                 ("every lane noise", torch.ones_like(mask)),
                                 ("one noise lane", one)):
                    got = tk.noise_turb(point, m_)
                    again = tk.noise_turb(point, m_)
                    ref = tk.turb_plain(point, m_)
                    equal = (torch.equal(got.view(torch.int32),
                                         ref.view(torch.int32))
                             and torch.equal(again.view(torch.int32),
                                             got.view(torch.int32)))
                    rows75[f"camera, {edge}"] = {
                        "lanes": R, "noise_lanes": int(m_.sum()),
                        "equal": equal,
                        "max_abs_err": float((got - ref).abs().max())}
                    phase(f"[75] turbulence kernel == fast_turb_c bit for bit "
                          f"on the camera hits' points, {edge} ({R} lanes), "
                          f"twice: {equal}")
                    if not equal:
                        raise AssertionError(f"[75] {edge}: the turbulence "
                                             "kernel differs")
                    del got, again, ref
            del point, mask
    regs = {"box_media_nearest": kernel_registers(
                build_log, "box_media_nearest_kernelI"),
            "turb": nb.ptxas_usage("turb_cu", build_log)}
    phase(f"[75] ptxas: {regs}")
    del st0, st1, cam_rays, cam_u, sc_rays, sc_u

    # ---- 76: final_full's routes in turns ----
    lights = build_light_table(sdev)
    nee_kw = {"nee_lights": lights, "rr_start": RR_START}

    def fast(nee, k_):
        return fp.render_frame_fast(sdev, cam, WIDTH, HEIGHT, SAMPLES, DEPTH,
                                    fold_in(PRNGKey(0), k_), k_, feats,
                                    **(nee_kw if nee else {})).image

    def general(nee, k_):
        return render_frame(sdev, cam, WIDTH, HEIGHT, SAMPLES, DEPTH,
                            fold_in(PRNGKey(0), k_), features=feats,
                            **(nee_kw if nee else {}))[0]

    def timed(fn):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        img_ = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), img_

    def peak_gib(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) / 2**30

    frames76 = {}
    launches76 = {"box_media": 0, "turb": 0}
    for label, nee in (("final_full", False),
                       (f"final_full --nee --rr {RR_START}", True)):
        fast(nee, 0), general(nee, 0)  # warm-up
        t_fast, t_gen, counts = [], [], []
        for r_ in range(5):
            for which in ("general", "fast", "fast", "general"):
                if which == "fast":
                    reset_counts(k1, k2, k7)
                    ms_, img_ = timed(lambda: fast(nee, r_))
                    counts.append(read_counts(k1, k2, k7))
                    t_fast.append(ms_)
                else:
                    ms_, img_ = timed(lambda: general(nee, r_))
                    t_gen.append(ms_)
                if not bool(torch.isfinite(img_).all()):
                    raise AssertionError(f"[76] {label}: a frame is not finite")
        per_bounce = {
            "fast": device_launches(lambda: fast(nee, 9)) / (DEPTH + 1),
            "general": device_launches(lambda: general(nee, 9)) / (DEPTH + 1)}
        peak = {"fast": peak_gib(lambda: fast(nee, 9)),
                "general": peak_gib(lambda: general(nee, 9))}
        before_ms = None
        if not nee:  # one frame of the parent's route (~13,600 launches a bounce)
            plain_route = "fast, plain sweeps and turbulence (the parent's route)"
            with plain_box_media_and_turb():
                before_ms, _ = timed(lambda: fast(nee, 9))
                per_bounce[plain_route] = (device_launches(lambda: fast(nee, 9))
                                           / (DEPTH + 1))
                peak[plain_route] = peak_gib(lambda: fast(nee, 9))
        c_ = counts[-1]
        plain = sum(c["plain"] for c in counts)
        row = {"fast_ms": t_fast, "fast_median_ms": float(np.median(t_fast)),
               "general_ms": t_gen,
               "general_median_ms": float(np.median(t_gen)),
               "fast_over_general": float(np.median(t_fast)
                                          / np.median(t_gen)),
               "launches_per_bounce": per_bounce, "peak_gib": peak,
               "plain_before_ms": before_ms,
               "launches_a_frame": c_, "plain_calls": plain}
        frames76[label] = row
        for key_ in launches76:
            launches76[key_] += sum(c[key_] for c in counts)
        phase(f"[76] {label} {WIDTH}x{HEIGHT}x{SAMPLES} depth {DEPTH}, 5 "
              f"rounds of general, fast, fast, general: fast median "
              f"{row['fast_median_ms']:.2f} ms {[round(x, 1) for x in t_fast]}, "
              f"general median {row['general_median_ms']:.2f} ms "
              f"{[round(x, 1) for x in t_gen]} (fast / general "
              f"{row['fast_over_general']:.3f}); device launches a bounce "
              f"{ {k: round(v, 1) for k, v in per_bounce.items()} }, peak GiB "
              f"{ {k: round(v, 3) for k, v in peak.items()} }; "
              + (f"one fast frame through the plain sweeps and turbulence "
                 f"{before_ms:.1f} ms; " if before_ms is not None else "")
              + f"launches of a fast frame {c_}, plain calls over the fast "
              f"frames {plain} ({smi})")
        if (plain or c_["box_media"] <= 0 or c_["turb"] <= 0
                or c_["K3"] <= 0 or c_["K2"]):
            raise AssertionError(f"[76] {label}: the fast frames did not run "
                                 "through the kernels alone")
    return {
        "box_media": {"cases": rows74, "max_abs_err": max_err,
                      "all_equal": all_equal,
                      "recompute_equal": recompute_equal,
                      "diff_grad_rel_l2": grad_rel,
                      "diff_launches": diff_launches,
                      "registers": regs["box_media_nearest"],
                      "launches": launches76["box_media"]},
        "turb": {"cases": rows75, "registers": regs["turb"],
                 "launches": launches76["turb"]},
        "frames": frames76}


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
    from pathtrace_tpu_torch.ops.box_media_kernel import box_media_nearest
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

    # the parent tree's traversal and turbulence kernels (phases 49, 50,
    # 52, 67 and 75 time them in turns) build beside the package's library
    start_parent_kernels()
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
        pieces["box/media kernel (with the media's draws)"] = lambda: (
            box_media_nearest(ctables.box_media, rays, fp.media_uniforms(
                cst0.lane, 7, 0, ctables.box_media.media.count, 8)
                if ctables.box_media.media is not None else None))
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
    # final_full: phase 65 holds its fast frame (the non-fused bounce) to
    # its golden and to the CPU port's frame; phase 41 its general golden
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
                                  ("final_full", "general", 1)):
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
    bvh = bvh_phases(dev, smi, k1, k2, k7, profiled)
    bvh_main = bvh["scenes"]["random_spheres"]["camera"]
    mesh = mesh_phases(dev, k1, k2, k7)
    mtrace = mesh["trace"]
    mesh_cli = mesh["cli"]
    drv = driver_phases(dev, k1, k2, k7)
    nf = nonfused_phases(dev, smi, k1, k2, k7)
    wide = wide_phases(dev, smi, k1, k2, k7)
    wide_main = wide["scenes"]["random_spheres"]["camera"]
    bt = box_turb_phases(dev, smi, k1, k2, k7, build_log)
    bm_main = bt["box_media"]["cases"]["final_full camera"]
    tb_main = bt["turb"]["cases"]["camera"]
    drv_launches = {
        "adaptive_launches": {n_: r_["launches"] for n_, r_ in
                              drv["adaptive"].items()},
        "aov_launches": {n_: r_["launches"] for n_, r_ in drv["aov"].items()},
        "debug_trace_launches": {n_: r_["launches"] for n_, r_ in
                                 drv["trace"].items()},
    }

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
         "device_trace_launches": mtrace["random_spheres"]["launches"]["K1"],
         "sharded_cli_launches": mesh_cli["random_spheres"]["launches"]["K1"],
         "sharded_train_launches": mesh["train"]["four"]["launches"]["K1"],
         "geometry_train_launches": c45["K1"],
         "geometry_silhouette_launches": c45s["K1"],
         "diff_scene_launches": {n_: r_["launches"]["K1"]
                                 for n_, r_ in diff_runs.items()},
         "sphere_presets": {n_: {**r_["k1"],
                                 "cli_launches": cli_runs[n_]["launches"]["K1"]}
                            for n_, r_ in sphere_runs.items()},
         "adaptive_launches": drv["adaptive"]["random_spheres"]["launches"][
             "K1"],
         "aov_launches": drv["aov"]["random_spheres"]["launches"]["K1"],
         "debug_trace_launches": drv["trace"]["small"]["launches"]["K1"],
         "drivers": drv_launches},
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
         "device_trace_launches": mtrace["random"]["launches"]["K3"],
         "sharded_general_launches": mesh_cli["final_full"]["launches"]["K3"],
         "aov_launches": drv["aov"]["random"]["launches"]["K3"],
         "final_full_fast_launches": nf["final_full"]["launches"]["K3"],
         "final_full_fast": nf["final_full"],
         "final_full_nee": nf["final_full_nee"],
         "library_ms": None},
        {"name": "shade_from_winners", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/shade.cu",
         "replaces": "pathtrace_tpu/ops/shade_pallas.py:92",
         "launches": launches[1], **k2_run,
         "motion_launches": c17["K2"],
         "device_trace_launches": mtrace["random_spheres"]["launches"]["K2"],
         "sharded_cli_launches": mesh_cli["random_spheres"]["launches"]["K2"],
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
         "adaptive_launches": {n_: r_["launches"]["K2"]
                               for n_, r_ in drv["adaptive"].items()},
         "drivers": drv,
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
         "sharded_train_launches": mesh["train"]["four"]["launches"]["K6"],
         "sharded_train": mesh["train"], "dryrun": mesh["dryrun"],
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
         "fixed_order": nf["k6"],
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
        {"name": "bvh_traverse", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/bvh_traverse.cu",
         "replaces": "pathtrace_tpu/models/bvh.py:635 (bvh_scene_nearest, "
                     "an XLA while_loop; no TPU kernel)",
         "launches": bvh["cli"]["random_spheres -B"]["launches"]["bvh"],
         "max_abs_err": bvh["max_abs_err"],
         **{k: bvh_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "issue_ceiling_ms", "bytes_ms",
                                     "mean_visits", "max_visits",
                                     "parent_ms", "turns_median_ms",
                                     "plan")},
         "registers": bvh["registers"], "scenes": bvh["scenes"],
         "trees": bvh["trees"], "native_build_s": bvh["native_build_s"],
         "sharded_cli_launches": mesh_cli["random_spheres -B"]["launches"][
             "bvh"],
         "sharded_cli_frames": mesh_cli, "device_trace": mtrace,
         "distributed": mesh["distributed"],
         "cli_frames": bvh["cli"], "config4": bvh["config4"],
         "general": bvh["general"],
         "final_full_fast_launches": nf["final_full_bvh"]["launches"]["bvh"],
         "final_full_fast": nf["final_full_bvh"],
         "textured_light": nf["textured_light"], "sweeps": nf["sweeps"],
         "library_ms": None},
        {"name": "bvh_wide_traverse", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/bvh_wide_traverse.cu",
         "replaces": "pathtrace_tpu/models/bvh.py:978 (wide_scene_nearest, "
                     "an XLA while_loop; no TPU kernel)",
         "launches": wide["frames"]["random_spheres"]["launches"]["bvh_wide"],
         "max_abs_err": wide["max_abs_err"],
         **{k: wide_main[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "issue_ceiling_ms",
                                      "bytes_ms", "mean_visits", "max_visits",
                                      "flat_ms", "flat_mean_visits")},
         "ms_scattered": wide["scenes"]["random_spheres"]["scattered"]["ms"],
         "visits": wide_main["mean_visits"],
         "registers": wide["registers"], "scenes": wide["scenes"],
         "frames": wide["frames"], "ladder": wide["ladder"],
         "library_ms": None},
        {"name": "box_media_nearest", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/box_media_nearest.cu",
         "replaces": "pathtrace_tpu/ops/intersect.py:445 box_nearest and "
                     ":606 media_nearest (XLA [R, N] sweeps; no TPU kernel)",
         "launches": bt["box_media"]["launches"],
         "max_abs_err": bt["box_media"]["max_abs_err"],
         **{k: bm_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "issue_ceiling_ms", "bytes_ms",
                                    "wrapper_ms")},
         "ms_scattered": bt["box_media"]["cases"]["final_full scattered"][
             "ms"],
         "registers": bt["box_media"]["registers"],
         "cases": bt["box_media"]["cases"],
         "recompute_equal": bt["box_media"]["recompute_equal"],
         "diff_grad_rel_l2": bt["box_media"]["diff_grad_rel_l2"],
         "final_full_frames": bt["frames"],
         "final_full_bvh": nf["final_full_bvh"],
         "library_ms": None},
        {"name": "noise_turb", "route": "cuda",
         "source": "pathtrace_tpu_torch/csrc/turb.cu",
         "replaces": "pathtrace_tpu/ops/fastpath.py:460-497 fast_turb_c "
                     "(XLA, in fast_bounce; no TPU kernel)",
         "launches": bt["turb"]["launches"],
         "max_abs_err": max(r_["max_abs_err"]
                            for r_ in bt["turb"]["cases"].values()),
         **{k: tb_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "issue_ceiling_ms", "bytes_ms",
                                    "noise_lanes", "lanes", "parent_ms",
                                    "turns_median_ms")},
         "ms_scattered": bt["turb"]["cases"]["scattered"]["ms"],
         "registers": bt["turb"]["registers"],
         "cases": bt["turb"]["cases"],
         "library_ms": None},
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
