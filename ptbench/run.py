"""Run one benchmark cell of pathtrace_tpu_torch once, on one card.

    python3 ptbench/run.py --workload cover_frames --seed 7 --seconds 30 --trace 0

A cell (``BENCHMARK.json``'s ``workloads``) pairs a configuration
(``ptbench/configs/<name>.json``: a scene recipe of ``ptbench/scenes/``,
its sizes and film) with a traffic mix (``ptbench/traffic/<name>.json``:
the driver, ``frames`` or ``train``, and its settings). The run builds the
scene from ``--seed``, warms up the cell's own shapes (set-up, timed as
``setup_s``), measures for ``--seconds``, then checks what the window
produced against the plain reference of ``ptbench/reference/`` (limits in
``ptbench/checks/<workload>.json``) and prints one JSON line last on
standard output. ``--trace 0`` reports the cell's end-to-end metrics;
``--trace 1`` runs a shorter window under ``torch.profiler`` and reports
its per-layer metrics, each read by ``ptbench/metrics/<name>.py``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the program's build and kernel caches live inside the checkout, at fixed
# paths, so only a checkout's first run builds
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[_var] = str(ROOT / "build" / _sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "pathtrace_tpu")
HOST_TRACE_S = 0.5  # the short traced window that names the idle gaps
GIB = float(1 << 30)


class RunError(RuntimeError):
    """A run that cannot produce a result (exit code ``code``)."""

    def __init__(self, msg: str, code: int = 3):
        super().__init__(msg)
        self.code = code


# ---------------------------------------------------------------------------
# the benchmark's data
# ---------------------------------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_spec(name: str, bench: Optional[dict] = None) -> SimpleNamespace:
    """The cell ``name``: its workload entry, configuration, traffic mix,
    check limits and the metrics it reports."""
    bench = bench or benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise RunError(f"no workload {name!r} in BENCHMARK.json", 2)
    w = work[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(ROOT / conf_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    checks = load_json(HERE / "checks" / f"{name}.json")

    def reported(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return SimpleNamespace(name=name, workload=w, config=config,
                           traffic=traffic, checks=checks,
                           end_to_end=reported(bench["end_to_end"]),
                           per_layer=reported(bench["per_layer"]))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scene_recipe(config: dict):
    return load_module(HERE / "scenes" / f"{config['recipe']}.py",
                       f"ptbench_scene_{config['recipe']}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "ptbench_metric_" + name.replace(".", "_"))


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------

class Device:
    """The card the run measures, or the CPU for the harness's own tests
    (which time nothing)."""

    def __init__(self, kind: str):
        import torch

        self.torch = torch
        self.dev = torch.device(kind)
        self.cuda = self.dev.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated()) if self.cuda else 0

    def describe(self) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 1}
        return {"platform": "gpu",
                "kind": self.torch.cuda.get_device_name(0), "count": 1}


def film_of(spec, film_override=None) -> dict:
    film = dict(spec.config["film"])
    if spec.traffic.get("max_depth") is not None:
        film["max_depth"] = spec.traffic["max_depth"]
    film.update(film_override or {})
    return film


def program_seed(seed: int) -> int:
    """The renderer's seed: the run's seed folded into 31 bits (the CLI's
    seeds are int32)."""
    return seed % (2**31 - 1)


# ---------------------------------------------------------------------------
# the frames driver: render_progressive, as the CLI renders
# ---------------------------------------------------------------------------

class FramesCell:
    def __init__(self, spec, seed: int, device: Device, film=None):
        self.spec, self.seed, self.device = spec, seed, device
        self.film = film_of(spec, film)
        self.pseed = program_seed(seed)
        self.spans = False

    def setup(self):
        from torch.profiler import record_function

        from pathtrace_tpu_torch.config import Params

        tr = self.spec.traffic
        clock = Clock()
        with record_function("ptbench.setup"):
            self.scene, self.camera = scene_recipe(self.spec.config).build(
                self.spec.config, self.seed)
            clock.lap("scene_s")
            f = self.film
            self.params = Params(width=f["width"], height=f["height"],
                                 samples=f["samples"],
                                 max_depth=f["max_depth"], seed=self.pseed,
                                 use_bvh=bool(tr["bvh"]))
            self.bvh = None
            if tr["bvh"]:
                from pathtrace_tpu_torch.models.bvh import build_scene_bvh

                self.bvh = build_scene_bvh(self.scene, seed=self.pseed)
                clock.lap("bvh_s")
            # the first frame loads (or builds) the kernels; then frames
            # for warmup_seconds, which let the card's clocks settle and
            # give the window its pace
            walls = self._render(tr["warmup_frames"])[1]
            clock.lap("first_frames_s")
            more = int(tr["warmup_seconds"] / statistics.median(walls[1:]))
            if more:
                walls = self._render(more)[1]
            clock.lap("warmup_s")
        self.frame_s = statistics.median(walls[1:])
        self.setup_parts = clock.laps

    def _render(self, frames: int, keep=None):
        """``frames`` frames through ``render_progressive``: (result,
        per-frame wall seconds, kept accumulations by frames done)."""
        from pathtrace_tpu_torch.render.progressive import render_progressive

        tr = self.spec.traffic
        stamps, kept = [], {}
        frame_span = Spans("ptbench.frame", self.spans)

        def on_frame(done, acc):
            stamps.append(time.perf_counter())
            if keep and done in keep:
                kept[done] = acc.detach().clone()
            frame_span.next()

        self.device.sync()
        t0 = time.perf_counter()
        frame_span.next()
        try:
            res = render_progressive(
                self.scene, self.camera, self.params, frames,
                self.device.dev, log=lambda line: None, nee=bool(tr["nee"]),
                rr_start=int(tr["rr_start"]), mode=tr["mode"], bvh=self.bvh,
                on_frame=on_frame)
        finally:
            frame_span.close()
        walls = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
        return res, walls, kept, t0

    def window(self, seconds: float, rng) -> dict:
        """Render the frames that fit in ``seconds`` at the warm-up's pace;
        keep the accumulation around one frame drawn from the seed."""
        n = max(3, int(round(seconds / self.frame_s)))
        self.check_frame = int(rng.integers(1, n))
        res, walls, kept, t0 = self._render(
            n, keep={self.check_frame, self.check_frame + 1})
        t1 = time.perf_counter()
        self.kept = kept
        return {"units": res.frames, "wall_s": t1 - t0, "walls": walls,
                "segments": res.total_rays, "readbacks": res.readbacks}

    def end_to_end(self, w: dict) -> dict:
        ms = [x * 1e3 for x in w["walls"]]
        return {"frame_ms": w["wall_s"] * 1e3 / w["units"],
                "frame_ms_p90": statistics.quantiles(ms, n=10)[8]}

    def release(self):
        self.bvh = None

    def check(self) -> dict:
        """Frame ``check_frame``, drawn from the seed, against the
        reference's, every pixel."""
        import torch

        from ptbench.reference import check, threefry, tracer

        k = self.check_frame
        image = check.frame_from_acc(self.kept[k], self.kept[k + 1], k)
        f = self.film
        key = threefry.fold_in(threefry.PRNGKey(self.pseed), k)
        self.reference = lambda dtype: tracer.frame_image(
            tracer.scene_arrays(self.scene, self.device.dev, dtype),
            tracer.camera_arrays(self.camera, self.device.dev, dtype),
            f["width"], f["height"], f["samples"], f["max_depth"], key,
            self.pseed * 1000003 + k)
        self.ref = self.reference(torch.float32)
        return {"pixels_off_pct": check.pixels_off_pct(image, self.ref)}

    def control(self, dtype) -> dict:
        """The check's numbers with the reference computed in ``dtype``
        put in the program's place (after :meth:`check`)."""
        from ptbench.reference import check

        return {"pixels_off_pct": check.pixels_off_pct(self.reference(dtype),
                                                       self.ref)}

    def work(self) -> dict:
        return scene_work(self.scene, self.film)


# ---------------------------------------------------------------------------
# the train driver: InverseRenderer.train_step, as the example trains
# ---------------------------------------------------------------------------

class TrainCell:
    def __init__(self, spec, seed: int, device: Device, film=None):
        self.spec, self.seed, self.device = spec, seed, device
        self.film = film_of(spec, film)
        self.pseed = program_seed(seed)
        self.spans = False

    def setup(self):
        import torch
        from torch.profiler import record_function

        from pathtrace_tpu_torch.parallel.inverse import (
            default_trainable, make_inverse_renderer)
        from pathtrace_tpu_torch.utils import threefry

        tr, f = self.spec.traffic, self.film
        clock = Clock()
        with record_function("ptbench.setup"):
            self.scene, self.camera = scene_recipe(self.spec.config).build(
                self.spec.config, self.seed)
            clock.lap("scene_s")
            self.renderer, self.state, self.names = make_inverse_renderer(
                self.scene, self.camera, f["width"], f["height"],
                samples=f["samples"], max_depth=f["max_depth"],
                device=self.device.dev, trainable=default_trainable,
                learning_rate=tr["learning_rate"])
            self.base = threefry.PRNGKey(self.pseed)
            with torch.no_grad():
                self.target = self.renderer.render(self.state.params,
                                                   self.base)
            clock.lap("trainer_and_target_s")
            self.start = perturbed_leaves(self.scene, self.names,
                                          tr["perturb"])
            with torch.no_grad():
                for p, n in zip(self.state.params, self.names):
                    if n in self.start:
                        p.copy_(self.start[n].to(p.device))
            self.init = [p.detach().clone() for p in self.state.params]
            self.losses, self.first_grad = [], None
            self.n_steps = 0
            for _ in range(tr["checked_steps"]):
                self.losses.append(self._step())
                if self.first_grad is None:
                    opt = self.state.optimizer
                    # Adam's first moment after one step is (1 - beta1) g
                    self.first_grad = {
                        n: opt.state.get(p, {}).get(
                            "exp_avg", torch.zeros_like(p)).detach().clone()
                        / (1.0 - opt.defaults["betas"][0])
                        for p, n in zip(self.state.params, self.names)}
            self.change = {n: (p.detach() - p0) for p, p0, n in zip(
                self.state.params, self.init, self.names)}
            clock.lap("checked_steps_s")
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < tr["warmup_seconds"]:
                self._step()
            self.device.sync()
            clock.lap("warmup_s")
        self.setup_parts = clock.laps

    def _key(self, step: int):
        from pathtrace_tpu_torch.utils import threefry

        return threefry.fold_in(self.base, step + 1)

    def _step(self) -> float:
        """One Adam step, keyed by its number; the loss read back, as
        the example reads it."""
        with span("ptbench.step", self.spans):
            self.state, loss = self.renderer.train_step(
                self.state, self.target, self._key(self.n_steps))
            self.n_steps += 1
            return float(loss)

    def window(self, seconds: float, rng) -> dict:
        walls = []
        self.device.sync()
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            self._step()
            walls.append(time.perf_counter() - a)
            if time.perf_counter() - t0 >= seconds and len(walls) >= 2:
                break
        t1 = time.perf_counter()
        return {"units": len(walls), "wall_s": t1 - t0, "walls": walls}

    def end_to_end(self, w: dict) -> dict:
        return {"step_ms": w["wall_s"] * 1e3 / w["units"]}

    def release(self):
        self.renderer = self.state = self.target = None

    def reference(self, dtype):
        """The reference's target and checked steps in ``dtype``:
        (losses, first gradients, changes)."""
        from ptbench.reference import threefry, train, tracer

        f, tr = self.film, self.spec.traffic
        dev = self.device.dev
        A = tracer.scene_arrays(self.scene, dev, dtype)
        cam = tracer.camera_arrays(self.camera, dev, dtype)
        overrides = {n: v.to(dev, dtype) for n, v in self.start.items()}
        base = threefry.PRNGKey(self.pseed)
        keys = [threefry.fold_in(base, i + 1)
                for i in range(tr["checked_steps"])]
        film = (f["width"], f["height"], f["samples"], f["max_depth"])
        return train.run_steps(A, cam, film, self.names, overrides, base,
                               keys, tr["learning_rate"])

    def check(self) -> dict:
        """The checked steps' losses, first gradients and changes against
        the reference's."""
        import torch

        from ptbench.reference import check

        live = self.scene.spheres.mask

        def live_rows(d):
            return {n: (x[live.to(x.device)] if n.startswith("spheres.")
                        else x) for n, x in d.items()}

        self.ref = self.reference(torch.float32)
        self.detail = {"losses": self.losses, "reference": self.ref[0]}
        return check.train_numbers(self.losses, self.ref[0],
                                   live_rows(self.first_grad), self.ref[1],
                                   live_rows(self.change), self.ref[2])

    def control(self, dtype) -> dict:
        from ptbench.reference import check

        losses, grad, change = self.reference(dtype)
        return check.train_numbers(losses, self.ref[0], grad, self.ref[1],
                                   change, self.ref[2])

    def work(self) -> dict:
        return scene_work(self.scene, self.film)


def perturbed_leaves(scene, names, perturb: dict) -> dict:
    """The leaves the traffic moves off the truth: ``value + delta``
    clipped to [0, 1] (texture colours), from the scene's own arrays."""
    out = {}
    for n, delta in perturb.items():
        if n not in names:
            continue
        group, leaf = n.split(".")
        base = getattr(getattr(scene, group), leaf).detach()
        out[n] = (base + delta).clamp(0.0, 1.0)
    return out


def scene_work(scene, film) -> dict:
    """What the frozen counts of ``ptbench/metrics`` multiply: the film's
    lanes, the depth, the live primitives by kind."""
    sp = scene.spheres
    live = sp.mask
    moving = int((live & (sp.inv_time_delta != 0)).sum())
    return {"lanes": film["width"] * film["height"] * film["samples"],
            "max_depth": film["max_depth"],
            "spheres": int(live.sum()), "moving_spheres": moving,
            "rects": int(scene.rects.mask.sum()),
            "boxes": int(scene.boxes.mask.sum()),
            "media": int(scene.media.mask.sum())}


DRIVERS = {"frames": FramesCell, "train": TrainCell}


class Clock:
    """Host-clock laps of set-up's parts, for the result's
    ``setup_parts``."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps = {}

    def lap(self, name: str):
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now


class Spans:
    """Consecutive ``record_function`` spans of one name (a frame each,
    opened and closed from the driver's ``on_frame`` hook); off, nothing."""

    def __init__(self, name: str, on: bool):
        self.name, self.on, self.cur = name, on, None

    def next(self):
        self.close()
        if self.on:
            from torch.profiler import record_function

            self.cur = record_function(self.name)
            self.cur.__enter__()

    def close(self):
        if self.cur is not None:
            self.cur.__exit__(None, None, None)
            self.cur = None


def span(name: str, on: bool):
    """A ``record_function`` span when ``on``, else a no-op context."""
    import contextlib

    from torch.profiler import record_function

    return record_function(name) if on else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", film=None, keep=None) -> dict:
    """One run of cell ``name``: the result object (without printing).
    ``device`` and ``film`` serve the harness's own tests, on the CPU at a
    small film; ``keep`` (a dict) gets the cell, for ``calibrate.py``."""
    import numpy as np

    spec = cell_spec(name)
    dev = Device(device)
    cell = DRIVERS[spec.traffic["kind"]](spec, seed, dev, film)
    before_setup = time.perf_counter() - T_START
    cell.setup()
    dev.sync()
    setup_s = time.perf_counter() - T_START
    setup_peak = dev.peak()
    rng = np.random.default_rng(seed)
    dev.reset_peak()
    tr = None
    if trace:
        from ptbench import trace as ptrace

        cell.spans = True
        _, named = ptrace.profiled(lambda: cell.window(HOST_TRACE_S, rng),
                                   dev, host_ops=True)
        cell.spans = False
        seconds = min(seconds, spec.traffic["trace_seconds"])
        w, tr = ptrace.profiled(lambda: cell.window(seconds, rng), dev)
    else:
        w = cell.window(seconds, rng)
    dev.sync()
    window_peak = dev.peak()
    found = forbidden_modules()
    if found:
        raise RunError("modules loaded that the benchmark forbids: "
                       + ", ".join(found), 4)
    work = cell.work()
    cell.release()
    if dev.cuda:
        dev.torch.cuda.empty_cache()
    numbers = cell.check()
    if keep is not None:
        keep["cell"] = cell
    limits = spec.checks["limits"]
    check = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(v["value"] == v["value"] and v["value"] <= v["limit"]
                  for v in check.values())

    metrics = {}
    if trace:
        ctx = SimpleNamespace(trace=tr, window=w, work=work, spec=spec,
                              units=w["units"])
        for m in spec.per_layer:
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(cell.end_to_end(w), setup_s=setup_s,
                   peak_mem_gib=window_peak / GIB)
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device_info = dict(dev.describe(),
                       memory_peak_bytes=max(setup_peak, window_peak))
    out = {"correct": correct, "attempted": w["units"],
           "failed": 0 if correct else 1, "metrics": metrics,
           "device": device_info}
    if trace:
        out["device"]["busy_s"] = tr.busy_s
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": named.idle_gaps()}
    # where set-up's seconds went (no metric reads it)
    out["setup_parts"] = dict(imports_and_device_s=before_setup,
                              **cell.setup_parts)
    if getattr(cell, "detail", None):
        out["check_detail"] = cell.detail  # each checked step's loss
    out["check"] = check
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ptbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch

        bench = benchmark()
        spec = cell_spec(args.workload, bench)
        chips = int(spec.workload["chips"])
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is false", 2)
        if torch.cuda.device_count() < chips:
            raise RunError(f"{torch.cuda.device_count()} card(s), the cell "
                           f"asks for {chips}", 2)
        try:
            import pathtrace_tpu_torch
        except ImportError as e:
            raise RunError(f"the program is not in this checkout: {e}", 3)
        if ROOT not in Path(pathtrace_tpu_torch.__file__).resolve().parents:
            raise RunError("the program imported from outside this checkout: "
                           f"{pathtrace_tpu_torch.__file__}", 3)
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except RunError as e:
        print(f"ptbench: {e}", file=sys.stderr)
        return e.code
    except (OSError, KeyError, ValueError) as e:
        print(f"ptbench: {type(e).__name__}: {e}", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
