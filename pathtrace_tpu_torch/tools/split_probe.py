"""Probe: which layout should the gathered winner attributes take on the
card?

    python -m pathtrace_tpu_torch.tools.split_probe
    python -m pathtrace_tpu_torch.tools.split_probe --device cpu --rays 16384

The port of the JAX package's ``tools/split_probe.py``. Winner rows are
gathered from an [N, K] attribute table (``table[(idx + e) % N]`` ->
[R, K]) and laid out for a kernel that touches every attribute plane
(the sum of the K planes, as the shade kernel would read them):

- ``split``: K column slices, each a (rows, 128) plane (the shipping
  layout); summed by :func:`sum_split` (P2, ``csrc/split_probe.cu``),
  which replaces the reference's ``k_split`` (``pallas_call`` at ``:82``);
- ``minor_t``: reshape (rows, 128, K), transpose to (rows, K, 128);
  :func:`sum_minor` (P3) replaces ``k_minor`` (``:109``);
- ``major_t``: transpose to (K, R), reshape (K, rows, 128);
  :func:`sum_major` (P4) replaces ``k_major`` (``:136``).

XLA materialises each layout before its kernel, so the layout functions
here return contiguous tensors (a PyTorch transpose alone is a view).
Each kernel sums k = 0..K-1 left to right, as its plain version does, and
equals it bit for bit; it is bound by bytes, (K + 1) x 4 x R. P3 and P4
load 16 bytes at a time and refuse an input whose base is not 16-byte
aligned (``ValueError``, on the CPU too).

The entry point runs on the card unless ``--device cpu`` is given (the
plain versions); without a card the default exits non-zero. Defaults are
the reference's size: R = 2^20 rays (``--rays``, a multiple of 128 x 64),
N = 640 rows, K = 24 attributes; the table and the indices come from a
seeded ``torch.Generator`` (not ``jax.random``'s bits). It prints one JSON
line per variant, ``bench`` ``split_probe/floor``, ``split_probe/split``,
``split_probe/minor_t`` and ``split_probe/major_t``, with:

- ``ms``: the reference's clock, host wall time of gather, layout,
  kernel and a readback of the sum, best of 4, ``idx + e`` varied each
  time; ``floor`` is the empty round trip, a one-element add and its
  readback;
- ``ms_minus_floor``;
- ``gather_ms`` (the gather alone), ``layout_ms`` (gather and layout)
  and ``kernel_ms`` (the kernel alone): device time from CUDA events
  (``_probe.event_ms``), null on the CPU and for ``floor``;
- ``major_gather_ms`` (major_t only): device time of the same (K, rows,
  128) array gathered column-major (:func:`gather_major`, the table kept
  as [K, N]), which skips the transpose of the winners;
- ``library_ms``: one PyTorch call that computes the same sum in another
  order (``a3.sum(dim=1)`` for minor_t, ``a3.sum(dim=0)`` for major_t),
  timed as a yardstick only; null for split (no single call sums K
  separate tensors) and on the CPU;
- ``kernel_cold_ms`` and ``library_cold_ms``, each [min, median, max],
  and ``kernel_over_library``, the ratio of the medians: the kernel and
  its yardstick timed in turns (kernel, library, library, kernel; 5
  rounds), each launch on the next of at least 3 copies of the layout (at
  least 300 MB in all), so that no launch finds its input in L2
  (``_probe.alternated_cold_ms``); ``kernel_ms`` and ``library_ms`` time
  20 launches back to back on one copy. split has the kernel's alone;
  null on the CPU;
- ``bound_ms`` (bytes, null on the CPU) and ``device``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from typing import List, Optional, Sequence

import torch

from pathtrace_tpu_torch.tools import _probe

SPLIT_LAUNCHES = 0     # P2 kernel launches (CUDA tensors)
SPLIT_PLAIN_CALLS = 0  # P2 calls served with the plain version (CPU)
MINOR_LAUNCHES = 0     # P3 kernel launches
MINOR_PLAIN_CALLS = 0  # P3 calls served with the plain version
MAJOR_LAUNCHES = 0     # P4 kernel launches
MAJOR_PLAIN_CALLS = 0  # P4 calls served with the plain version

LANES = 128        # minor dimension of every plane
BLOCK_ROWS = 64    # rows per grid step of the reference's kernels
MAX_PLANES = 64    # planes the split kernel takes (csrc/split_probe.cu)
TABLE_ROWS, ATTRS = 640, 24  # the reference probe's table: N rows, K columns
VARIANTS = ("split", "minor_t", "major_t")
# what a line holds only from the card (null on the CPU and for floor)
CARD_KEYS = ("gather_ms", "layout_ms", "kernel_ms", "library_ms",
             "kernel_cold_ms", "library_cold_ms", "kernel_over_library",
             "bound_ms", "bound_by")


# ---------------------------------------------------------------------------
# layouts (plain PyTorch, as the reference builds them in XLA)
# ---------------------------------------------------------------------------

def gather_attrs(table: torch.Tensor, idx: torch.Tensor,
                 e: int) -> torch.Tensor:
    """The winner rows ``table[(idx + e) % N]``: [R, K]."""
    return table.index_select(0, (idx + e) % table.shape[0])


def gather_major(table_t: torch.Tensor, idx: torch.Tensor,
                 e: int) -> torch.Tensor:
    """The major layout gathered column-major: from the table kept as
    [K, N] (``table.t().contiguous()``), ``(K, rows, 128)`` straight from
    one ``index_select`` along the rows, with no transpose of the winners.
    Equals ``layout_major(gather_attrs(table, idx, e))``."""
    K, N = table_t.shape
    return table_t.index_select(1, (idx + e) % N).reshape(
        K, idx.shape[0] // LANES, LANES)


def layout_split(attrs: torch.Tensor) -> List[torch.Tensor]:
    """K (rows, 128) planes, one column of ``attrs`` each."""
    rows = attrs.shape[0] // LANES
    return [attrs[:, k].reshape(rows, LANES).contiguous()
            for k in range(attrs.shape[1])]


def layout_minor(attrs: torch.Tensor) -> torch.Tensor:
    """(rows, K, 128): ``attrs.reshape(rows, 128, K)`` with its last two
    dimensions swapped, materialised."""
    R, K = attrs.shape
    return attrs.reshape(R // LANES, LANES, K).transpose(1, 2).contiguous()


def layout_major(attrs: torch.Tensor) -> torch.Tensor:
    """(K, rows, 128): ``attrs.T.reshape(K, rows, 128)``, materialised."""
    R, K = attrs.shape
    return attrs.t().reshape(K, R // LANES, LANES).contiguous()


# ---------------------------------------------------------------------------
# P2-P4 and their plain versions
# ---------------------------------------------------------------------------

def sum_split_plain(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = planes[0].clone()
    for p in planes[1:]:
        acc = acc + p
    return acc


def sum_minor_plain(a3: torch.Tensor) -> torch.Tensor:
    acc = a3[:, 0, :]
    for k in range(1, a3.shape[1]):
        acc = acc + a3[:, k, :]
    return acc.contiguous()


def sum_major_plain(a3: torch.Tensor) -> torch.Tensor:
    acc = a3[0]
    for k in range(1, a3.shape[0]):
        acc = acc + a3[k]
    return acc.contiguous()


def _check_plane(t: torch.Tensor, what: str, dim: int) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 tensors")
    if t.dim() != dim or t.shape[-1] != LANES:
        raise ValueError(f"{what}: expected {dim} dimensions ending in "
                         f"{LANES}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the input must be contiguous")


def _check_aligned(t: torch.Tensor, what: str) -> None:
    """P3 and P4 load 16 bytes at a time: the base must be 16-byte aligned
    (a contiguous slice at another storage offset is refused)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: the input must start on a 16-byte "
                         f"boundary (data_ptr() % 16 == {t.data_ptr() % 16})")


def _launch(device: torch.device, shape, name: str, *args) -> torch.Tensor:
    """Launch ``pt_<name>``(*args, n, out, stream); the (rows, 128) output."""
    from pathtrace_tpu_torch.ops import _cuda_build

    lib = _cuda_build.library()
    out = torch.empty(shape, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    code = getattr(lib, f"pt_{name}")(*args, out.numel(), out.data_ptr(),
                                      stream)
    _cuda_build.check(code, f"{name} launch")
    return out


def _cuda_or_raise(device: torch.device, what: str) -> None:
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")


def sum_split(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """P2: the sum of K (rows, 128) planes, left to right.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    global SPLIT_LAUNCHES, SPLIT_PLAIN_CALLS
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"sum_split takes 1 to {MAX_PLANES} planes, got "
                         f"{len(planes)}")
    for p in planes:
        _check_plane(p, "sum_split", 2)
        if p.shape != planes[0].shape or p.device != planes[0].device:
            raise ValueError("sum_split: planes differ in shape or device")
    dev = planes[0].device
    if dev.type == "cpu":
        SPLIT_PLAIN_CALLS += 1
        return sum_split_plain(planes)
    _cuda_or_raise(dev, "sum_split")
    ptrs = (ctypes.c_void_p * len(planes))(*[p.data_ptr() for p in planes])
    out = _launch(dev, planes[0].shape, "sum_split", ptrs, len(planes))
    SPLIT_LAUNCHES += 1
    return out


def sum_minor(a3: torch.Tensor) -> torch.Tensor:
    """P3: the sum of a (rows, K, 128) array over its middle dimension."""
    global MINOR_LAUNCHES, MINOR_PLAIN_CALLS
    _check_plane(a3, "sum_minor", 3)
    if a3.shape[1] < 1:
        raise ValueError("sum_minor: K must be at least 1")
    _check_aligned(a3, "sum_minor")
    if a3.device.type == "cpu":
        MINOR_PLAIN_CALLS += 1
        return sum_minor_plain(a3)
    _cuda_or_raise(a3.device, "sum_minor")
    out = _launch(a3.device, (a3.shape[0], LANES), "sum_minor",
                  a3.data_ptr(), a3.shape[1])
    MINOR_LAUNCHES += 1
    return out


def sum_major(a3: torch.Tensor) -> torch.Tensor:
    """P4: the sum of a (K, rows, 128) array over its first dimension."""
    global MAJOR_LAUNCHES, MAJOR_PLAIN_CALLS
    _check_plane(a3, "sum_major", 3)
    if a3.shape[0] < 1:
        raise ValueError("sum_major: K must be at least 1")
    _check_aligned(a3, "sum_major")
    if a3.device.type == "cpu":
        MAJOR_PLAIN_CALLS += 1
        return sum_major_plain(a3)
    _cuda_or_raise(a3.device, "sum_major")
    out = _launch(a3.device, a3.shape[1:], "sum_major", a3.data_ptr(),
                  a3.shape[0])
    MAJOR_LAUNCHES += 1
    return out


LAYOUT = {"split": layout_split, "minor_t": layout_minor,
          "major_t": layout_major}
KERNEL = {"split": sum_split, "minor_t": sum_minor, "major_t": sum_major}
PLAIN = {"split": sum_split_plain, "minor_t": sum_minor_plain,
         "major_t": sum_major_plain}
LIBRARY = {"split": None, "minor_t": lambda a3: a3.sum(dim=1),
           "major_t": lambda a3: a3.sum(dim=0)}


def make_inputs(n_rays: int, n_rows: int, k: int, seed: int,
                device: torch.device):
    """The reference probe's inputs: the table [N, K] uniform in [0, 1),
    the winner indices [R] uniform in [0, N) (int64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    table = torch.rand(n_rows, k, generator=gen, device=device)
    idx = torch.randint(0, n_rows, (n_rays,), generator=gen, device=device)
    return table, idx


def cold_copies(laid) -> list:
    """``laid`` (a layout: one tensor, or P2's list of planes) and clones
    of it, for :func:`_probe.alternated_cold_ms`."""
    if isinstance(laid, torch.Tensor):
        return _probe.cold_copies(laid, laid.nbytes, torch.clone)
    return _probe.cold_copies(laid, sum(p.nbytes for p in laid),
                              lambda planes: [p.clone() for p in planes])


def bound_ms(n_rays: int, k: int) -> float:
    """Bytes over the HBM rate: K planes of R floats read, one written."""
    return (k + 1) * 4 * n_rays / _probe.HBM_BYTES_PER_S * 1e3


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="split_probe")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--rays", type=int, default=1 << 20,
                    help=f"winners, a multiple of {LANES} x {BLOCK_ROWS}")
    args = ap.parse_args(argv)
    if args.rays <= 0 or args.rays % (LANES * BLOCK_ROWS):
        ap.error(f"--rays must be a positive multiple of {LANES * BLOCK_ROWS}")

    dev = _probe.probe_device(args.device, "split_probe")
    if dev is None:
        return 1
    card = _probe.device_line(dev)
    on_card = dev.type == "cuda"
    table, idx = make_inputs(args.rays, TABLE_ROWS, ATTRS, 0, dev)

    def floor(i):
        return (torch.tensor(float(i), device=dev) + 1.0).item()

    lines = {"floor": {"ms": _probe.best_wall_ms(floor)}}
    gather_ms = (_probe.event_ms(lambda: gather_attrs(table, idx, 0))
                 if on_card else None)
    for name in VARIANTS:
        layout, kernel, library = LAYOUT[name], KERNEL[name], LIBRARY[name]

        def run(i, layout=layout, kernel=kernel):
            return kernel(layout(gather_attrs(table, idx, i))).sum().item()

        line = lines[name] = {"ms": _probe.best_wall_ms(run)}
        if not on_card:
            continue
        laid = layout(gather_attrs(table, idx, 0))
        line.update(
            gather_ms=gather_ms,
            layout_ms=_probe.event_ms(
                lambda: layout(gather_attrs(table, idx, 0))),
            kernel_ms=_probe.event_ms(lambda: kernel(laid)),
            library_ms=(None if library is None
                        else _probe.event_ms(lambda: library(laid))),
            **_probe.alternated_cold_ms(kernel, library, cold_copies(laid)),
            bound_ms=bound_ms(args.rays, ATTRS), bound_by="bytes")
        if name == "major_t":
            table_t = table.t().contiguous()
            line["major_gather_ms"] = _probe.event_ms(
                lambda: gather_major(table_t, idx, 0))
    for name, line in lines.items():
        print(json.dumps({
            "bench": f"split_probe/{name}", "ms": line["ms"],
            "ms_minus_floor": line["ms"] - lines["floor"]["ms"],
            **{key: None for key in CARD_KEYS}, **line,
            "rays": args.rays, "attrs": ATTRS, "device": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
