"""The port's probes against the JAX package's (plain versions, CPU).
Their CUDA kernels against the plain versions: tests/test_torch_cuda.py.

P1 (``tools/bf16_probe.py``) and P2-P4 (``tools/split_probe.py``) keep
their Pallas kernels nested inside ``main()``. The tests read each body
from its file by path (``ast``), run it through ``pl.pallas_call(...,
interpret=True)`` with the reference's ``BlockSpec``s, and hold the port's
plain versions to it:

- P1 in float32 to rtol = atol = 1e-5: XLA rounds the expanded sums of
  the quadratic its own way (measured at most 2.6e-6 relative), as with
  the closest hit K1 (tests/test_torch_kernels.py);
- P1 in bf16 bit for bit: PyTorch rounds each bf16 operation to bf16, as
  the reference's interpret mode does;
- P2-P4 bit for bit (float32 adds in one order), and the layouts the port
  builds equal the reference's ``jnp`` expressions.
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from pathtrace_tpu_torch.tools import bf16_probe, split_probe  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
TILE_R, TILE_N = 512, 128
R1, N1 = 1024, 640            # P1: 2 grid steps, 5 sphere tiles
K, ROWS, BS = 24, 128, 64     # P2-P4: 2 grid steps of 64 rows
F32_TOL = 1e-5                # P1 float32 vs XLA (measured 2.6e-6)
LIBRARY_TOL = 1e-5            # torch.sum sums in another order


def _reference_def(path: str, name: str, **env):
    """The function ``name`` defined (nested or not) in ``path``, compiled
    on its own in a namespace holding jax, jnp, pl and ``env``."""
    node = next(n for n in ast.walk(ast.parse((ROOT / path).read_text()))
                if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {"jax": jax, "jnp": jnp, "pl": pl, **env}
    exec(compile(ast.Module(body=[node], type_ignores=[]), str(ROOT / path),
                 "exec"), ns)
    return ns[name]


def _p1_inputs(seed=0, miss=False):
    rng = np.random.default_rng(seed)
    cols = rng.random((6, R1), dtype=np.float32)
    rows = (rng.random((4, N1), dtype=np.float32) * np.float32(20.0))
    if miss:
        # c2 far above b^2 - |ro|^2 + 2 c.ro (at most ~4100 here): every
        # disc <= 0
        rows[3] += np.float32(1e4)
    return cols, rows


def _p1_reference(cols, rows, dtype):
    R, N = cols.shape[1], rows.shape[1]
    make_kernel = _reference_def("tools/bf16_probe.py", "make_kernel",
                                 TILE_R=TILE_R, TILE_N=TILE_N,
                                 n_tiles=N // TILE_N)
    ray_spec = pl.BlockSpec((TILE_R, 1), lambda i: (i, 0),
                            memory_space=pltpu.VMEM)
    sph_spec = pl.BlockSpec((1, N), lambda i: (0, 0), memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        make_kernel(dtype),
        grid=(R // TILE_R,),
        in_specs=[ray_spec] * 6 + [sph_spec] * 4,
        out_specs=pl.BlockSpec((TILE_R, 1), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((R, 1), jnp.float32),
        interpret=True,
    )(*[jnp.asarray(c[:, None]) for c in cols],
      *[jnp.asarray(r[None, :]) for r in rows])
    return np.asarray(out)[:, 0]


_JDTYPE = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.fixture(scope="module")
def p1_refs():
    cols, rows = _p1_inputs()
    return cols, rows, {name: _p1_reference(cols, rows, jd)
                        for name, jd in _JDTYPE.items()}


def _p1_port(cols, rows, name):
    return bf16_probe.sphere_min_t(torch.from_numpy(cols),
                                   torch.from_numpy(rows),
                                   bf16_probe.DTYPES[name]).numpy()


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_p1_plain_matches_reference(name, p1_refs):
    cols, rows, refs = p1_refs
    ref = refs[name]
    assert (ref < bf16_probe.MISS_T).all()  # the origins lie inside: all hit
    got = _p1_port(cols, rows, name)
    if name == "bf16":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_p1_all_miss(name):
    cols, rows = _p1_inputs(seed=1, miss=True)
    ref = _p1_reference(cols, rows, _JDTYPE[name])
    assert (ref == np.float32(bf16_probe.MISS_T)).all()
    np.testing.assert_array_equal(_p1_port(cols, rows, name), ref)


def _padded_reference(cols, rows, dtype):
    """The reference's kernel on a shape its grid cannot take (a ray count
    that is not a multiple of its 512-ray tile, a sphere count that is not
    a multiple of 128): rays padded with copies of the first ray, spheres
    with rows whose disc is <= 0 for every ray (centre 0, c2 = 1e4, as in
    ``_p1_inputs(miss=True)``), which never lower a minimum; the padded
    rays' results are dropped."""
    R, N = cols.shape[1], rows.shape[1]
    pad_r, pad_n = (-R) % TILE_R, (-N) % TILE_N
    cols_p = np.concatenate([cols, np.repeat(cols[:, :1], pad_r, axis=1)],
                            axis=1)
    filler = np.zeros((4, pad_n), np.float32)
    filler[3] = np.float32(1e4)
    rows_p = np.concatenate([rows, filler], axis=1)
    return _p1_reference(cols_p, rows_p, dtype)[:R]


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("n_rays,n_spheres", [
    (517, 128),   # a ragged ray count: not a multiple of 4 x 256 nor of 512
    (512, 131),   # an odd sphere count: the kernel pairs the last with itself
])
def test_p1_plain_matches_reference_on_ragged_shapes(name, n_rays, n_spheres):
    """The plain version, which the card holds P1 to bit for bit, against
    the reference's kernel (interpret mode) on shapes P1 takes raggedly."""
    rng = np.random.default_rng(n_rays + n_spheres)
    cols = rng.random((6, n_rays), dtype=np.float32)
    rows = rng.random((4, n_spheres), dtype=np.float32) * np.float32(20.0)
    ref = _padded_reference(cols, rows, _JDTYPE[name])
    got = _p1_port(cols, rows, name)
    assert got.shape == (n_rays,)
    if name == "bf16":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)


def test_p1_planted_fault_f32_for_bf16(p1_refs):
    """The float32 result passed off as the bf16 one fails the bf16
    comparison: the two types are told apart."""
    cols, rows, refs = p1_refs
    f32 = _p1_port(cols, rows, "f32")
    assert not np.array_equal(f32, refs["bf16"])
    outside, flips = bf16_probe.compare(torch.tensor(refs["bf16"]),
                                        torch.from_numpy(f32))
    assert outside > 0.5 and flips == 0


def test_p1_compare_counts_outside_and_flips():
    miss = bf16_probe.MISS_T
    t32 = torch.tensor([1.0, 2.0, miss, 4.0, 5.0], dtype=torch.float32)
    t16 = torch.tensor([1.0005, 2.5, 3.0, miss, 5.0], dtype=torch.float32)
    outside, flips = bf16_probe.compare(t16, t32)
    assert flips == 2 and outside == pytest.approx(3 / 5)
    assert bf16_probe.compare(t32, t32) == (0.0, 0)


def test_p1_wrapper_counts_plain_calls_and_refuses_bad_inputs():
    cols, rows = (torch.from_numpy(a) for a in _p1_inputs())
    calls, launches = bf16_probe.PLAIN_CALLS, bf16_probe.LAUNCHES
    t = bf16_probe.sphere_min_t(cols[:, :64], rows[:, :130].contiguous(),
                                torch.bfloat16)
    assert t.shape == (64,) and t.dtype == torch.float32
    assert bf16_probe.PLAIN_CALLS == calls + 1
    assert bf16_probe.LAUNCHES == launches
    with pytest.raises(TypeError):
        bf16_probe.sphere_min_t(cols, rows, torch.float16)
    with pytest.raises(ValueError):
        bf16_probe.sphere_min_t(cols[:5], rows)
    with pytest.raises(ValueError):
        bf16_probe.sphere_min_t(cols, rows.t().contiguous().t())


# ---------------------------------------------------------------------------
# P2-P4
# ---------------------------------------------------------------------------

def _p24_inputs(seed=2):
    rng = np.random.default_rng(seed)
    table = rng.random((640, K), dtype=np.float32)
    idx = rng.integers(0, 640, ROWS * 128).astype(np.int32)
    return table, idx


def _reference_layouts(table, idx, e):
    attrs = jnp.asarray(table)[(jnp.asarray(idx) + e) % table.shape[0]]
    return {
        "split": [attrs[:, k].reshape(ROWS, 128) for k in range(K)],
        "minor_t": attrs.reshape(ROWS, 128, K).transpose(0, 2, 1),
        "major_t": attrs.T.reshape(K, ROWS, 128),
    }


def _port_layouts(table, idx, e):
    attrs = split_probe.gather_attrs(torch.from_numpy(table),
                                     torch.from_numpy(idx), e)
    return {name: split_probe.LAYOUT[name](attrs)
            for name in split_probe.VARIANTS}


def _reference_sum(name, laid):
    pspec = pl.BlockSpec((BS, 128), lambda i: (i, 0), memory_space=pltpu.VMEM)
    kname, in_specs, args = {
        "split": ("k_split", [pspec] * K, laid),
        "minor_t": ("k_minor", [pl.BlockSpec(
            (BS, K, 128), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)],
            [laid]),
        "major_t": ("k_major", [pl.BlockSpec(
            (K, BS, 128), lambda i: (0, i, 0), memory_space=pltpu.VMEM)],
            [laid]),
    }[name]
    kernel = _reference_def("tools/split_probe.py", kname, K=K)
    out = pl.pallas_call(
        kernel, grid=(ROWS // BS,), in_specs=in_specs, out_specs=pspec,
        out_shape=jax.ShapeDtypeStruct((ROWS, 128), jnp.float32),
        interpret=True,
    )(*args)
    return np.asarray(out)


def test_layouts_match_reference():
    table, idx = _p24_inputs()
    ref = _reference_layouts(table, idx, 3)
    got = _port_layouts(table, idx, 3)
    assert len(got["split"]) == K
    for r, g in zip(ref["split"], got["split"]):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for name in ("minor_t", "major_t"):
        # materialised, as XLA hands the kernel its operand
        assert got[name].is_contiguous()
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]))


def test_column_major_gather_equals_major_layout():
    table, idx = (torch.from_numpy(a) for a in _p24_inputs())
    got = split_probe.gather_major(table.t().contiguous(), idx, 5)
    assert got.is_contiguous() and got.shape == (K, ROWS, 128)
    want = split_probe.layout_major(split_probe.gather_attrs(table, idx, 5))
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", split_probe.VARIANTS)
def test_sums_match_reference(name):
    table, idx = _p24_inputs()
    ref_laid = _reference_layouts(table, idx, 1)[name]
    ref = _reference_sum(name, ref_laid)
    laid = _port_layouts(table, idx, 1)[name]
    counters = {"split": "SPLIT_PLAIN_CALLS", "minor_t": "MINOR_PLAIN_CALLS",
                "major_t": "MAJOR_PLAIN_CALLS"}
    before = getattr(split_probe, counters[name])
    got = split_probe.KERNEL[name](laid)
    assert getattr(split_probe, counters[name]) == before + 1
    assert got.shape == (ROWS, 128)
    np.testing.assert_array_equal(got.numpy(), ref)
    library = split_probe.LIBRARY[name]
    if library is not None:
        np.testing.assert_allclose(library(laid).numpy(), ref,
                                   rtol=LIBRARY_TOL, atol=LIBRARY_TOL)


def test_sum_wrappers_refuse_bad_inputs():
    a3 = torch.zeros(2, K, 128)
    with pytest.raises(ValueError):
        split_probe.sum_minor(a3.transpose(0, 1))  # not contiguous
    with pytest.raises(ValueError):
        split_probe.sum_major(torch.zeros(K, 2, 64))  # not 128 lanes
    with pytest.raises(ValueError):
        split_probe.sum_split([torch.zeros(2, 128), torch.zeros(3, 128)])
    with pytest.raises(ValueError):
        split_probe.sum_split([torch.zeros(2, 128)] * 65)
    with pytest.raises(TypeError):
        split_probe.sum_major(a3.double())
    # P3 and P4 load 16 bytes at a time: a contiguous view 4 bytes off a
    # 16-byte boundary is refused before the device branch, here too
    base = torch.zeros(K * 2 * 128 + 4)
    assert base.data_ptr() % 16 == 0
    off = base.view(-1)[1:1 + K * 2 * 128]
    with pytest.raises(ValueError, match="16-byte"):
        split_probe.sum_minor(off.view(2, K, 128))
    with pytest.raises(ValueError, match="16-byte"):
        split_probe.sum_major(off.view(K, 2, 128))


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("probe,argv,names", [
    (bf16_probe, ["--rays", "1024", "--spheres", "256"],
     ["bf16_probe/f32", "bf16_probe/bf16"]),
    (split_probe, ["--rays", "16384"],
     ["split_probe/floor", "split_probe/split", "split_probe/minor_t",
      "split_probe/major_t"]),
])
def test_entry_point_on_cpu_prints_reference_names(probe, argv, names,
                                                   capsys):
    assert probe.main(["--device", "cpu", *argv]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["bench"] for ln in lines] == names
    for ln in lines:
        assert ln["device"] == "cpu" and ln["ms"] > 0.0
        # no device metric from a CPU run
        assert ln["kernel_ms"] is None and ln["bound_ms"] is None
        if probe is split_probe:
            assert ln["kernel_cold_ms"] is None
            assert ln["library_cold_ms"] is None
            assert ln["kernel_over_library"] is None
    if probe is bf16_probe:
        assert lines[0]["share_outside_f32"] == 0.0
        assert lines[1]["share_outside_f32"] > 0.5


@pytest.mark.parametrize("probe", [bf16_probe, split_probe])
def test_entry_point_needs_a_card_by_default(probe, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main([]) == 1
    captured = capsys.readouterr()
    assert "is_available() is False" in captured.err
    assert captured.out == ""  # no fallback to the CPU, no result


def test_probes_run_without_jax():
    """The probes import nothing of JAX or of the JAX package: with both
    made unimportable, each entry point runs at --device cpu."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pathtrace_tpu'] = None\n"
        "from pathtrace_tpu_torch.tools import bf16_probe, split_probe\n"
        "assert bf16_probe.main(['--device', 'cpu', '--rays', '512',\n"
        "                        '--spheres', '130']) == 0\n"
        "assert split_probe.main(['--device', 'cpu', '--rays', '8192']) == 0\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(out.stdout.splitlines()) == 6
