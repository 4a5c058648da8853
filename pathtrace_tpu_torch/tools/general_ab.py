"""The general integrator's trace two ways on the card, in alternating
pairs: over its alive lanes only, gathered once a bounce
(``integrator.trace``), against the whole wavefront with the dead lanes
masked, as the reference's ``while_loop`` computes it (the same
``_bounce`` with no lane indices, exiting when no lane is alive).

    python -m pathtrace_tpu_torch.tools.general_ab --preset random_spheres --pairs 10
    python -m pathtrace_tpu_torch.tools.general_ab --preset final_full --pairs 10

Each pair traces the primary rays of one frame (1280x720, 4 spp, depth
10, frame key ``fold_in(PRNGKey(0), pair)``) both ways, the order
alternating from pair to pair; each trace is timed with CUDA events from
its first launch to its result (the per-bounce readbacks included), after
one warm-up of each. The two radiances are compared lane for lane (the
same estimator: a lane's sweep, shading and draws do not depend on the
other lanes). The last line is a JSON object with the times; ``--out``
writes it to a file too.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from typing import Optional, Sequence


def masked_trace(scene, ro, rd, time, key, max_depth, features, tables):
    """``integrator.trace`` over every lane, the dead ones masked: one
    readback a bounce (any lane alive), as ``trace`` reads its alive
    lanes."""
    import torch

    from pathtrace_tpu_torch.render import integrator

    state = integrator._initial_state(ro, rd, time)
    with torch.no_grad():
        for _ in range(max_depth + 1):
            if not bool(state.alive.any()):
                break
            state = integrator._bounce(scene, tables, state, key, max_depth,
                                       features)
    return state.radiance, state.ray_count


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="general_ab")
    ap.add_argument("--preset", default="random_spheres")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.render import integrator
    from pathtrace_tpu_torch.render.frame import generate_primary_rays
    from pathtrace_tpu_torch.utils import threefry

    if not torch.cuda.is_available():
        print("general_ab: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    W, H, S, D = 1280, 720, 4, 10
    scene, cam = presets.from_name(args.preset, W / H)
    scene, cam = scene.to(dev), cam.to(dev)
    feats = SceneFeatures.from_scene(scene)
    tables = integrator.prep_tables(scene, feats)

    def rays(i):
        kray, ktrace = threefry.split(threefry.fold_in(threefry.PRNGKey(0), i))
        ro, rd, tm = generate_primary_rays(cam, W, H, S, kray, device=dev)
        R = W * H * S
        return ro.reshape(R, 3), rd.reshape(R, 3), tm.reshape(R), ktrace

    ways = {
        "lanes": lambda ro, rd, tm, k: integrator.trace(
            scene, ro, rd, tm, k, D, features=feats, tables=tables),
        "masked": lambda ro, rd, tm, k: masked_trace(
            scene, ro, rd, tm, k, D, feats, tables),
    }

    def timed(way, args_):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        rad, count = ways[way](*args_)
        end.record()
        end.synchronize()
        return start.elapsed_time(end), rad, int(count)

    warm = rays(0)
    for way in ways:
        timed(way, warm)
    times = {w: [] for w in ways}
    max_diff, counts = 0.0, {}
    for i in range(args.pairs):
        r = rays(i + 1)
        order = ("lanes", "masked") if i % 2 == 0 else ("masked", "lanes")
        out = {}
        for way in order:
            ms, rad, count = timed(way, r)
            times[way].append(ms)
            out[way] = rad
            counts[way] = count
        max_diff = max(max_diff, float((out["lanes"] - out["masked"])
                                       .abs().max()))
        print(f"pair {i + 1} ({order[0]} first): lanes "
              f"{times['lanes'][-1]:.3f} ms, masked {times['masked'][-1]:.3f} "
              f"ms", flush=True)
    wins = sum(a < b for a, b in zip(times["lanes"], times["masked"]))
    result = {
        "preset": args.preset, "card": smi, "torch": torch.__version__,
        "film": [W, H, S, D], "pairs": args.pairs,
        "lanes_ms": times["lanes"], "masked_ms": times["masked"],
        "lanes_ms_median": statistics.median(times["lanes"]),
        "masked_ms_median": statistics.median(times["masked"]),
        "lanes_faster_in": wins, "segments": counts,
        "max_abs_radiance_diff": max_diff,
    }
    print(f"{args.preset} on {smi}: lanes median "
          f"{result['lanes_ms_median']:.3f} ms, masked median "
          f"{result['masked_ms_median']:.3f} ms; lanes faster in {wins} of "
          f"{args.pairs} pairs; largest radiance difference {max_diff}")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
