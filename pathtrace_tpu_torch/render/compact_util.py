"""Stream-compaction primitives for the fast path's host ladder.

Counterpart of ``pathtrace_tpu/render/compact_util.py`` on the port's
:class:`~pathtrace_tpu_torch.ops.fastpath.FastStateP`. Compaction moves
lanes, never changes them: lane ids ride along and key the RNG, so a
compacted trace follows the same paths as the uncompacted one. The
radiance rows are flushed into the full-size output (``indices`` maps
slots to rays) and restart at zero, so a lane that gains radiance both
before and after a compaction (next-event estimation adds some at every
bounce) sums it in another grouping, which may differ in the last bit.
"""

from __future__ import annotations

import dataclasses

import torch

ROW = 128  # lanes per compaction row

_RAD = slice(6, 9)  # radiance rows of FastStateP.planes


def rung(n_alive: int, minimum: int) -> int:
    """Smallest power of two >= n_alive (and >= minimum)."""
    size = max(int(n_alive), minimum, 1)
    return 1 << (size - 1).bit_length()


def partition_order(mask: torch.Tensor):
    """Stable partition from one cumsum: True lanes first, both sides in
    original order. Returns ``(order, pos, m)``: ``order[k]`` is the lane
    at slot k, ``pos`` its inverse, ``m`` the True count (a device
    scalar)."""
    n = mask.shape[0]
    prefix = torch.cumsum(mask.to(torch.int64), dim=0)
    m = prefix[-1]
    iota = torch.arange(n, dtype=torch.int64, device=mask.device)
    pos = torch.where(mask, prefix - 1, m + iota - prefix)
    order = torch.empty_like(iota).scatter_(0, pos, iota)
    return order, pos, m


def _flush(out_radiance, state, indices, identity: bool):
    """Add the state's radiance rows into the [3, R0] output. Before the
    first compaction ``indices`` is the identity and the add is dense."""
    rad = state.planes[_RAD]
    if identity:
        return out_radiance + rad
    return out_radiance.index_add(1, indices, rad)


def _take(state, perm):
    planes = state.planes.index_select(1, perm)
    planes[_RAD] = 0.0
    return dataclasses.replace(state, planes=planes, time=state.time[perm],
                               alive=state.alive[perm], lane=state.lane[perm])


def compact(out_radiance, state, indices, next_size: int,
            identity: bool = False):
    """Flush radiance, then gather the alive lanes to the front at
    ``next_size`` slots (stable; the tail holds dead lanes)."""
    out_radiance = _flush(out_radiance, state, indices, identity)
    order, _, _ = partition_order(state.alive)
    perm = order[:next_size]
    return out_radiance, _take(state, perm), indices[perm]


def compact_rows(out_radiance, state, indices, next_rows: int,
                 identity: bool = False):
    """Row-granular compaction: drop whole 128-lane rows whose lanes are
    all dead, keeping survivors' rows intact and in order."""
    out_radiance = _flush(out_radiance, state, indices, identity)
    R = state.size
    rows = R // ROW
    row_alive = state.alive.view(rows, ROW).any(dim=1)
    order, _, _ = partition_order(row_alive)
    row_perm = order[:next_rows]
    lane_perm = (row_perm[:, None] * ROW
                 + torch.arange(ROW, device=row_perm.device)).reshape(-1)
    return out_radiance, _take(state, lane_perm), indices[lane_perm]


def final_flush(out_radiance, state, indices, identity: bool = False):
    return _flush(out_radiance, state, indices, identity)
