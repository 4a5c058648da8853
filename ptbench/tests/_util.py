"""What the harness's tests share: the harness imported from the checkout
and a tiny film for the CPU."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"width": 32, "height": 18}
FRAME_CELLS = ("cover_frames", "nextweek_frames", "nextweek_bvh_frames")
