"""The plain reference against the port, on the CPU at a tiny film: the
frames of both scenes (and through the tree) and the train steps come out
correct; the control (the reference in bfloat16 in the program's place)
and each fault planted under the harness, in the program, come out not
correct."""

from __future__ import annotations

import pytest
import torch

from _util import FRAME_CELLS, TINY

from ptbench import run


def _run(cell, seed, keep=None):
    return run.run_cell(cell, seed, 0.2, False, device="cpu", film=TINY,
                        keep=keep)


@pytest.mark.parametrize("cell", FRAME_CELLS + ("cover_train",))
def test_port_matches_the_reference(cell):
    out = _run(cell, 2**31 + 3)
    assert out["correct"], out["check"]


@pytest.mark.parametrize("cell", ("cover_frames", "nextweek_frames",
                                  "cover_train"))
def test_the_control_fails(cell):
    keep = {}
    _run(cell, 91, keep)
    limits = run.cell_spec(cell).checks["limits"]
    numbers = keep["cell"].control(torch.bfloat16)
    assert any(not v <= limits[k] for k, v in numbers.items()), numbers


# ---- faults planted in the program, under the harness ----

def _frames_state_unchanged(mp):
    from pathtrace_tpu_torch.render import progressive

    mp.setattr(progressive, "accumulate", lambda acc, new, n: acc)


def _frames_half_batch(mp):
    from pathtrace_tpu_torch.ops import fastpath

    real = fastpath.trace_fast

    def half(scene, ro, rd, time, *a, **k):
        # every other sample traced: each pixel the mean of half its samples
        res = real(scene, ro[::2], rd[::2], time[::2], *a, **k)
        rad = res.radiance.repeat_interleave(2, dim=0)[:ro.shape[0]]
        return res._replace(radiance=rad)

    mp.setattr(fastpath, "trace_fast", half)


def _frames_answer_altered(mp):
    from pathtrace_tpu_torch.render import progressive

    real = progressive.render_frame_fast

    def altered(*a, **k):
        res = real(*a, **k)
        return res._replace(image=res.image * 1.01)

    mp.setattr(progressive, "render_frame_fast", altered)


def _train_state_unchanged(mp):
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _train_half_batch(mp):
    from pathtrace_tpu_torch.parallel import inverse

    real = inverse.pmesh.render_frame_sharded

    def half(*a, **k):
        img, n = real(*a, **k)
        h = img.shape[0] // 2
        return torch.cat([img[:h], img[:img.shape[0] - h]]), n

    mp.setattr(inverse.pmesh, "render_frame_sharded", half)


def _train_answer_altered(mp):
    from pathtrace_tpu_torch.parallel import inverse

    real = inverse.pmesh.render_frame_sharded

    def altered(*a, **k):
        img, n = real(*a, **k)
        return img * 1.01, n

    mp.setattr(inverse.pmesh, "render_frame_sharded", altered)


FAULTS = [("cover_frames", _frames_state_unchanged),
          ("cover_frames", _frames_half_batch),
          ("cover_frames", _frames_answer_altered),
          ("nextweek_frames", _frames_half_batch),
          ("cover_train", _train_state_unchanged),
          ("cover_train", _train_half_batch),
          ("cover_train", _train_answer_altered)]


@pytest.mark.parametrize("cell,plant", FAULTS,
                         ids=[f"{c}-{p.__name__[1:]}" for c, p in FAULTS])
def test_a_planted_fault_is_not_correct(cell, plant, monkeypatch):
    plant(monkeypatch)
    out = _run(cell, 57)
    assert out["correct"] is False, out["check"]
