"""On the card: one short run of every cell through the benchmark's
command, each correct, with the end-to-end metrics its entry names.
Skipped where there is no card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from _util import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cover_frames", "nextweek_frames",
                                  "cover_train", "nextweek_bvh_frames"])
def test_cell_runs_correct_on_the_card(card, cell):
    p = subprocess.run(
        [sys.executable, "ptbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 101), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["check"]
    assert out["device"]["platform"] == "gpu"
