"""The fast path's ladder settings on the card, timed in turns: the one
ladder against the interleaved one (``fastpath.INTERLEAVE_CHUNK``), and
``-B``'s compaction thresholds (the ladder's three tiers against one
threshold for every tier).

    python -m pathtrace_tpu_torch.tools.ladder_ab --rounds 5
    python -m pathtrace_tpu_torch.tools.ladder_ab --pairs B_tiers:B0.35 --rounds 20
    python -m pathtrace_tpu_torch.tools.ladder_ab --pool B0.35:B_tiers a.json b.json

Every frame is ``render_frame_fast`` of ``random_spheres`` at 1280x720, 4
spp, depth 10 (3,686,400 rays), one frame key and seed for all, so the
cases of a pair must give the same image bit for bit (lanes keep their
ids; no NEE): the tool checks it. A case sets module knobs for its frames
and restores them after:

* ``single``: ``INTERLEAVE_CHUNK`` above the frame (one ladder);
* ``chunk2M`` / ``chunk1M``: chunks of at most 2^21 / 2^20 rays (two of
  1,843,200 / four of 921,600);
* ``chunk2M_skip64k``: chunks of 2^21 reading counts down to 2^16 lanes
  (``COUNT_SKIP_SIZE``);
* ``B_tiers``: through the scene's flat tree (``-B``, one ladder) at the
  three tiers' thresholds (``ROW_SHRINK`` 0.75, ``COMPACT_SHRINK`` 0.35,
  ``SMALL_SHRINK`` 0.6);
* ``B0.35`` / ``B0.9``: the same with every tier at 0.35 / 0.9.

Each pair runs ``--rounds`` rounds of A, B, B, A after one warm-up frame
of each case; a frame is timed with CUDA events from its first launch to
its image (the readbacks included). The last line is a JSON object: each
case's times, median, quartiles, min and max, readbacks and segments a
frame, each pair's ratio of medians (B / A), and the card's name and
power limit; ``--out`` writes it to a file too.

``--pool A:B`` (no card needed) reads such files and pairs the frames of
each round: B's two frames over A's two, from every pair of the two cases
in either order. It prints the rounds' count, the median ratio, its 95%
bootstrap interval (2,000 draws, seeded) and the rounds in which B took
longer.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import random
import statistics
import subprocess
import sys
from typing import Optional, Sequence

W, H, S, D = 1280, 720, 4, 10
CASES = {
    "single": {"INTERLEAVE_CHUNK": 1 << 40},
    "chunk2M": {"INTERLEAVE_CHUNK": 1 << 21},
    "chunk1M": {"INTERLEAVE_CHUNK": 1 << 20},
    "chunk2M_skip64k": {"INTERLEAVE_CHUNK": 1 << 21,
                        "COUNT_SKIP_SIZE": 1 << 16},
    "B_tiers": {},
    "B0.35": {k: 0.35 for k in ("ROW_SHRINK", "COMPACT_SHRINK",
                                "SMALL_SHRINK")},
    "B0.9": {k: 0.9 for k in ("ROW_SHRINK", "COMPACT_SHRINK",
                              "SMALL_SHRINK")},
}
PAIRS = ("single:chunk2M", "single:chunk1M", "B_tiers:B0.35")


def frame_runner(dev):
    """``run(case) -> (ms, image sha256, readbacks, segments)``: one timed
    frame of ``random_spheres`` under the case's knobs."""
    import torch

    from pathtrace_tpu_torch.models import bvh as pbvh
    from pathtrace_tpu_torch.models import presets
    from pathtrace_tpu_torch.models.types import SceneFeatures
    from pathtrace_tpu_torch.ops import fastpath as fp
    from pathtrace_tpu_torch.utils.threefry import PRNGKey, fold_in

    scene, cam = presets.from_name("random_spheres", W / H)
    feats = SceneFeatures.from_scene(scene)
    flat, _, offsets = pbvh.build_scene_bvh(scene)
    scene, cam = scene.to(dev), cam.to(dev)
    key = fold_in(PRNGKey(0), 1)

    def run(case: str):
        knobs = CASES[case]
        saved = {k: getattr(fp, k) for k in knobs}
        tree = (dict(bvh=flat, bvh_offsets=offsets) if case.startswith("B")
                else {})
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        try:
            for k, v in knobs.items():
                setattr(fp, k, v)
            start.record()
            res = fp.render_frame_fast(scene, cam, W, H, S, D, key, 7, feats,
                                       **tree)
            end.record()
            end.synchronize()
        finally:
            for k, v in saved.items():
                setattr(fp, k, v)
        digest = hashlib.sha256(
            res.image.cpu().numpy().tobytes()).hexdigest()[:16]
        return (start.elapsed_time(end), digest, res.readbacks,
                int(res.ray_count))

    return run


def _summary(ms):
    q = statistics.quantiles(ms, n=4) if len(ms) > 1 else [ms[0]] * 3
    return {"ms": ms, "median_ms": statistics.median(ms), "q1_ms": q[0],
            "q3_ms": q[2], "min_ms": min(ms), "max_ms": max(ms)}


def run_pairs(pairs: Sequence[str], rounds: int, dev, log=print) -> dict:
    """Each pair "A:B" in ``rounds`` rounds of A, B, B, A (after a warm-up
    of each): {"cases": {case: summary}, "pairs": {pair: ratio}}. Raises
    if a pair's two cases give different images."""
    run = frame_runner(dev)
    cases, ratios = {}, {}
    for pair in pairs:
        a, b = pair.split(":")
        times = {a: [], b: []}
        seen = {}
        for c in (a, b):
            seen[c] = run(c)
        for _ in range(rounds):
            for c in (a, b, b, a):
                ms, digest, rb, segs = run(c)
                times[c].append(ms)
                if digest != seen[c][1] or segs != seen[c][3]:
                    raise AssertionError(f"{c}: the frame's bits moved")
        if seen[a][1] != seen[b][1] or seen[a][3] != seen[b][3]:
            raise AssertionError(f"{pair}: the two cases' images differ")
        for c in (a, b):
            s = _summary(times[c])
            s.update(readbacks=seen[c][2], segments=seen[c][3],
                     image_sha256=seen[c][1])
            cases[f"{pair}/{c}"] = s
            log(json.dumps({"pair": pair, "case": c, **s}))
        ratios[pair] = (statistics.median(times[b])
                        / statistics.median(times[a]))
    return {"cases": cases, "pairs": ratios}


def pool(spec: str, paths: Sequence[str]) -> dict:
    """Per-round ratios B / A (each round's two frames summed) over every
    pair of the cases ``spec`` = "A:B" in the ``--out`` files ``paths``."""
    a, b = spec.split(":")
    ratios = []
    for path in paths:
        with open(path) as fh:
            cases = json.load(fh)["cases"]
        for pair in sorted({k.split("/")[0] for k in cases}):
            if set(pair.split(":")) != {a, b}:
                continue
            ta, tb = cases[f"{pair}/{a}"]["ms"], cases[f"{pair}/{b}"]["ms"]
            ratios += [(tb[2 * r] + tb[2 * r + 1]) / (ta[2 * r] + ta[2 * r + 1])
                       for r in range(len(ta) // 2)]
    if not ratios:
        raise ValueError(f"no rounds of {spec} in {list(paths)}")
    rng = random.Random(0)
    boot = sorted(statistics.median(rng.choices(ratios, k=len(ratios)))
                  for _ in range(2000))
    return {"pool": spec, "rounds": len(ratios),
            "median_ratio": statistics.median(ratios),
            "ci95": [boot[50], boot[1949]],
            "rounds_b_slower": sum(r > 1 for r in ratios)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="ladder_ab")
    ap.add_argument("--pairs", default=",".join(PAIRS),
                    help="comma-separated A:B pairs of " + ", ".join(CASES))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--pool", default=None, metavar="A:B",
                    help="pool the rounds of A:B from the files given")
    ap.add_argument("files", nargs="*")
    args = ap.parse_args(argv)
    if args.pool:
        print(json.dumps(pool(args.pool, args.files)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("ladder_ab: needs a CUDA device", file=sys.stderr)
        return 1
    pairs = [p for p in args.pairs.split(",") if p]
    for p in pairs:
        if p.count(":") != 1 or any(c not in CASES for c in p.split(":")):
            ap.error(f"bad pair {p!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    out = run_pairs(pairs, args.rounds, torch.device("cuda"))
    out.update(card=smi, rounds=args.rounds, frame=f"{W}x{H}x{S} depth {D}")
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
