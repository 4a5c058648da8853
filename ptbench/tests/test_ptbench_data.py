"""The benchmark as data: BENCHMARK.json keeps to its schema's keys, sizes and
characters, every cell finds its configuration, traffic mix, check limits
and metric readers by name, a file added under a new name is found, and a
run's last line has the schema of the result line."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from _util import ROOT, TINY

from ptbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(b["command"]) <= 32
    for word in b["command"]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in b["paths"])


def test_entries_keys_names_and_units():
    b = bench()
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }
    for group, keys in allowed.items():
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names)), group
        for e in b[group]:
            assert set(e) <= keys, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
                    assert "\t" not in e[text]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_finds_its_files_and_reports_enough():
    b = bench()
    for w in b["workloads"]:
        spec = run.cell_spec(w["name"], b)
        assert spec.config["name"] == w["config"]
        assert spec.traffic["kind"] in run.DRIVERS
        assert (run.HERE / "scenes" / f"{spec.config['recipe']}.py").is_file()
        assert set(spec.checks["limits"])
        names = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert spec.per_layer
        for m in spec.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("ptbench/configs/")


def test_metric_files_match_their_entries():
    for m in bench()["per_layer"]:
        mod = run.metric_reader(m["name"])
        assert mod.UNIT == m["unit"], m["name"]
        assert mod.MOVES == m["moves"], m["name"]
        assert callable(mod.read)


def test_a_file_added_under_a_new_name_is_found(tmp_path, monkeypatch):
    tree = tmp_path / "ptbench"
    shutil.copytree(run.HERE, tree, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    b = bench()
    (tree / "traffic" / "frames_fast_short.json").write_text(json.dumps(
        dict(json.loads((tree / "traffic" / "frames_fast.json").read_text()),
             warmup_frames=2)))
    (tree / "checks" / "cover_frames_short.json").write_text(
        (tree / "checks" / "cover_frames.json").read_text())
    (tree / "metrics" / "frames_traced.py").write_text(
        'UNIT = "count"\nMOVES = "frame_ms"\n\n\ndef read(ctx):\n'
        '    return float(ctx.units)\n')
    b["workloads"].append({"name": "cover_frames_short",
                           "config": "rtiow_cover",
                           "traffic": "frames_fast_short", "chips": 1,
                           "why": "a test cell"})
    b["per_layer"].append({"name": "frames_traced", "unit": "count",
                           "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "frame_ms",
                           "workloads": ["cover_frames_short"]})
    monkeypatch.setattr(run, "HERE", tree)
    spec = run.cell_spec("cover_frames_short", b)
    assert spec.traffic["warmup_frames"] == 2
    assert [m["name"] for m in spec.per_layer if m["name"] == "frames_traced"]
    assert run.metric_reader("frames_traced").read(
        type("Ctx", (), {"units": 3})()) == 3.0


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_schema(trace):
    out = run.run_cell("cover_frames", 2**31 + 11, 0.3, bool(trace),
                       device="cpu", film=TINY)
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in out
    assert list(out)[-1] == "check"
    assert isinstance(out["correct"], bool)
    for k, v in out["check"].items():
        assert set(v) == {"value", "limit"}
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"}
    spec = run.cell_spec("cover_frames")
    want = spec.per_layer if trace else spec.end_to_end
    assert set(out["metrics"]) <= {m["name"] for m in want}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(out["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(out["metrics"]) == {m["name"] for m in want}
    json.dumps(out)
