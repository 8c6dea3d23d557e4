"""Parity of the port's lookup microbenchmarks with the Pallas kernel
bodies of the JAX package's gather experiments, on the CPU.

The JAX scripts define their kernels inside ``main()``/``make(S)`` or run
timings at import (``tools/exp_gather2.py``), so each body is taken out
of the script's source with ``ast`` by name and run through
``pl.pallas_call(..., interpret=True)`` with the script's own
``BlockSpec``s, shrunk (16-32 rows, BQ 128 with nb 2, NQ 2048).  The
port's side is each wrapper on CPU tensors, which takes its plain
version.  G8's body (``k_transpose``) does not trace: it slices a loaded
array with ``pl.ds`` (exp_gather2.py:79); its case holds the port against
the body's own ``jnp`` operations outside Pallas.

Tolerance: none.  Every kernel is a pure gather, and G10 adds its 16
lookups in order from 0.0 as the JAX body does, so every result must be
exactly equal.
"""

import ast
import pathlib
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mcl_3dl_tpu_torch.ops import build
from mcl_3dl_tpu_torch.ops import gather_bench as ogb
from mcl_3dl_tpu_torch.tools import (exp_gather, exp_gather2, exp_rowsel_shape,
                                     gather_pairs, grouped_pairs)

torch.set_num_threads(2)   # several test workers share the CPU

ROOT = pathlib.Path(__file__).resolve().parents[1]
L = 128
OFF = 5                    # wraps (idx + off) mod W for the top indices
VMEM = dict(memory_space=pltpu.VMEM)


def _body(script, name, **env):
    """The kernel body ``name`` of ``tools/<script>``, defined in a
    namespace holding jax, jnp, pl and ``env``."""
    path = ROOT / "tools" / script
    tree = ast.parse(path.read_text(), str(path))
    node = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = dict(jax=jax, jnp=jnp, pl=pl, **env)
    exec(compile(ast.Module(body=[node], type_ignores=[]), str(path), "exec"),
         ns)
    return ns[name]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _row_case(name, width, dtype, rows=32, block=16):
    """G1, G2, G4: ``pallas_call`` as in exp_gather.py:98-113."""
    rng = np.random.default_rng(1)
    if dtype == np.uint8:
        tab = rng.integers(0, 255, (rows, width), dtype=np.uint8)
    else:
        tab = rng.standard_normal((rows, width)).astype(np.float32)
    idx = rng.integers(0, width, (rows, L), dtype=np.int32)
    i = (jnp.asarray(idx) + OFF) % width
    got = pl.pallas_call(
        _body("exp_gather.py", name),
        out_shape=jax.ShapeDtypeStruct((rows, L), dtype),
        grid=(rows // block,),
        in_specs=[pl.BlockSpec((block, width), lambda b: (b, 0), **VMEM),
                  pl.BlockSpec((block, L), lambda b: (b, 0), **VMEM)],
        out_specs=pl.BlockSpec((block, L), lambda b: (b, 0), **VMEM),
        interpret=True)(jnp.asarray(tab), i)
    return got, (_t(tab), _t(idx), OFF)


def case_g1():
    got, args = _row_case("lane_kernel", L, np.float32)
    return got, ogb.lane_gather(*args)


def case_g2():
    got, args = _row_case("wide_kernel", 512, np.float32)
    return got, ogb.wide_gather(*args)


def case_g4():
    got, args = _row_case("lane_kernel_u8", L, np.uint8)
    return got, ogb.lane_gather_u8(*args)


def case_g3(off=OFF):
    rng = np.random.default_rng(3)
    rows, block = 32, 16
    tab = rng.standard_normal((8, L)).astype(np.float32)
    idx = rng.integers(0, 1024, (rows, L), dtype=np.int32)
    i = (jnp.asarray(idx) + off) % 1024
    got = pl.pallas_call(
        _body("exp_gather.py", "twostage_kernel"),
        out_shape=jax.ShapeDtypeStruct((rows, L), jnp.float32),
        grid=(rows // block,),
        in_specs=[pl.BlockSpec((8, L), lambda b: (0, 0), **VMEM),
                  pl.BlockSpec((block, L), lambda b: (b, 0), **VMEM)],
        out_specs=pl.BlockSpec((block, L), lambda b: (b, 0), **VMEM),
        interpret=True)(jnp.asarray(tab), i)
    return got, ogb.twostage_gather(_t(tab), _t(idx), off)


def case_g5():
    rng = np.random.default_rng(5)
    tab = rng.standard_normal((L, L)).astype(np.float32)
    idx = rng.integers(0, L, (L, L), dtype=np.int32)
    i = (jnp.asarray(idx) + OFF) % L
    got = pl.pallas_call(
        _body("exp_gather.py", "sub_kernel"),
        out_shape=jax.ShapeDtypeStruct((L, L), jnp.float32),
        in_specs=[pl.BlockSpec((L, L), **VMEM), pl.BlockSpec((L, L), **VMEM)],
        out_specs=pl.BlockSpec((L, L), **VMEM),
        interpret=True)(jnp.asarray(tab), i)
    return got, ogb.sub_gather(_t(tab), _t(idx), OFF)


BQ, NB = 128, 2    # nb <= 2: interpret mode places the blocks right (see
                   # exp_gather2.py:61, whose index map is off by BQ)


def _gather2_inputs(seed):
    rng = np.random.default_rng(seed)
    tab = rng.random((L, L), np.float32)
    idx = rng.integers(0, L * L, (NB, BQ, L), dtype=np.int32)
    return tab, idx


def _gather2_case(name, wrapper, seed):
    """G6, G7, G9: ``mk`` of exp_gather2.py:53-64, index map included."""
    tab, idx = _gather2_inputs(seed)
    got = pl.pallas_call(
        _body("exp_gather2.py", name, BQ=BQ),
        grid=(NB,),
        in_specs=[pl.BlockSpec((L, L), lambda b: (0, 0), **VMEM),
                  pl.BlockSpec((1, BQ, L), lambda b: (b, 0, 0), **VMEM)],
        out_specs=pl.BlockSpec((BQ, L), lambda b: (b * BQ, 0), **VMEM),
        out_shape=jax.ShapeDtypeStruct((NB * BQ, L), jnp.float32),
        interpret=True)(jnp.asarray(tab), jnp.asarray(idx))
    return got, wrapper(_t(tab), _t(idx))


def case_g6():
    return _gather2_case("k_fancy", ogb.fancy_gather, 6)


def case_g7():
    return _gather2_case("k_sublane", ogb.sublane_gather, 7)


def case_g9():
    return _gather2_case("k_rowloop", ogb.rowloop_gather, 9)


def case_g8():
    """k_transpose's operations per 128-row chunk, outside Pallas:
    ``take_along_axis(tab.T, chunk >> 7, axis=1)``."""
    tab, idx = _gather2_inputs(8)
    flat = jnp.asarray(idx).reshape(-1, L)
    tt = jnp.asarray(tab).T
    got = jnp.concatenate([
        jnp.take_along_axis(tt, flat[c * L:(c + 1) * L] >> 7, axis=1)
        for c in range(flat.shape[0] // L)])
    return got, ogb.transpose_gather(_t(tab), _t(idx))


def case_g10(kk=16, tiles=(8, 16), outside=False):
    """``make(S)`` of exp_rowsel_shape.py:41-81 for S in ``tiles``; with
    ``outside``, some rows lie outside the table (negative ones too)."""
    rng = np.random.default_rng(10)
    r, nq = 144, 2048
    tab = rng.uniform(0, 1, (r, L)).astype(np.float32)
    rows = rng.integers(0, r, nq).astype(np.int32).reshape(-1, L)
    if outside:
        rows[::3, ::5] = rng.integers(-2 ** 31, 0, rows[::3, ::5].shape)
        rows[1::3, ::7] = rng.integers(r, 2 ** 31, rows[1::3, ::7].shape)
    lanes = rng.integers(0, L, nq).astype(np.int32).reshape(-1, L)
    kern = _body("exp_rowsel_shape.py", "kern", R=r)
    gots, ours = [], []
    for s in tiles:
        gots.append(pl.pallas_call(
            partial(kern, kk=kk),
            grid=(nq // (s * L),),
            in_specs=[pl.BlockSpec((s, L), lambda t: (t, 0), **VMEM),
                      pl.BlockSpec((s, L), lambda t: (t, 0), **VMEM),
                      pl.BlockSpec((r, L), lambda t: (0, 0), **VMEM)],
            out_specs=pl.BlockSpec((s, L), lambda t: (t, 0), **VMEM),
            out_shape=jax.ShapeDtypeStruct((nq // L, L), jnp.float32),
            interpret=True)(jnp.asarray(rows), jnp.asarray(lanes),
                            jnp.asarray(tab)))
        ours.append(ogb.rowsel_accumulate(_t(tab), _t(rows), _t(lanes), kk,
                                          tile_rows=s))
    return jnp.stack(gots), torch.stack(ours)


CASES = {"G1": case_g1, "G2": case_g2, "G3": case_g3, "G4": case_g4,
         "G5": case_g5, "G6": case_g6, "G7": case_g7, "G8": case_g8,
         "G9": case_g9, "G10": case_g10}


@pytest.mark.parametrize("tag", list(CASES))
def test_port_matches_jax_body(tag):
    got, ours = CASES[tag]()
    got = np.asarray(got)
    ours = ours.numpy()
    assert ours.dtype == got.dtype and ours.shape == got.shape
    assert np.array_equal(ours, got)
    assert np.unique(ours).size > 1


@pytest.mark.parametrize("off", [-5, 2 ** 31 - 3])
def test_g3_offset_wraps_like_jax(off):
    """G3's ``(idx + off) % 1024`` where the offset is negative or makes
    the int32 sum overflow."""
    got, ours = case_g3(off)
    assert np.array_equal(ours.numpy(), np.asarray(got))


@pytest.mark.parametrize("kk", [0, 1, 3])
def test_g10_rows_outside_the_table_like_jax(kk):
    """G10 with rows below 0 and past the table, which the JAX body's
    select leaves at 0.0, and with 0, 1 and 3 passes."""
    got, ours = case_g10(kk, tiles=(1,), outside=True)
    got, ours = np.asarray(got), ours.numpy()
    assert np.array_equal(ours, got)
    assert (ours[0, ::3, ::5] == 0).all() and (ours[0, 1::3, ::7] == 0).all()
    assert kk == 0 or np.unique(ours).size > 1


TOOLS = {"exp_gather": (exp_gather, dict(q=128 * 37, risky=True)),
         "exp_gather2": (exp_gather2, dict(q=1 << 15, bq=128)),
         "exp_rowsel_shape": (exp_rowsel_shape, dict(nq=2048, tiles=(8, 16)))}
TAGS = {"exp_gather": ["A", "B", "G1", "G2", "G3", "G4", "G5"],
        "exp_gather2": ["A", "G6", "G7", "G8", "G9"],
        "exp_rowsel_shape": ["G10", "G10"]}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_main_on_cpu(tool, capsys):
    mod, sizes = TOOLS[tool]
    res = mod.main(device="cpu", iters=1, **sizes)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [e.tag for e in res] == TAGS[tool]
    assert all(e.ms > 0 for e in res)
    assert all((e.library_ms is None) == (e.library is None) for e in res)
    # the device/host split of a call is a card measurement: None here
    assert all(v is None for e in res for v in (
        e.device_ms, e.host_ms, e.library_device_ms, e.library_host_ms))
    assert all(" (device " not in s for s in lines)
    assert [s.split()[0] for s in lines] == TAGS[tool]
    for s in lines:
        assert " ms on cpu, " in s and " G lookups/s, bound " in s
        assert "[no card: plain versions on the host]" in s


@pytest.mark.parametrize("tool", list(TOOLS))
def test_library_rows_compute_the_function(tool):
    """Each library yardstick computes its kernel's function (G10's is
    one pass of the 16)."""
    mod, sizes = TOOLS[tool]
    for e in mod.lookups(torch.device("cpu"), **sizes):
        if e.wrapper is None or e.library is None:
            continue
        want = e.plain().reshape(-1)
        lib = e.library().reshape(-1)
        if e.tag == "G10":
            acc = torch.zeros_like(lib)
            for _ in range(16):
                acc = acc + lib
            lib = acc
        assert torch.equal(lib, want), e.tag


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_needs_cuda_by_default(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod, sizes = TOOLS[tool]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(iters=1, **sizes)


def test_g10_lookup_bound_is_the_bank_rate():
    """2^24 lookups at one bank-conflict cycle a clock on each of 132 SMs:
    ~3.5 cycles a warp read for 32 uniform lanes, 0.0020 ms without
    conflicts, 0 ms for no passes."""
    ms, words = exp_rowsel_shape.lookup_bound(1 << 20, 16, 132, 1.98e9,
                                              warps=20_000)
    assert 3.4 < words < 3.65
    free = (1 << 24) / 32 / (132 * 1.98e9) * 1e3
    assert abs(ms - free * words) < 1e-12
    assert abs(free - 0.00201) < 1e-5
    assert exp_rowsel_shape.lookup_bound(1 << 20, 0, 132, 1.98e9,
                                         warps=100)[0] == 0


def test_g10_bound_text_names_the_lookup_rate_where_set():
    """The tools print G10's lookup-rate bound beside its byte bound; the
    rate is the card's, so on the CPU there is none."""
    e, = exp_rowsel_shape.lookups(torch.device("cpu"), nq=2048, tiles=(8,))
    assert e.lookup_bound_ms is None
    assert e.bound_text == f"bound {e.bound_ms:.4f} ms by bytes"
    e.lookup_bound_ms = 0.0071
    assert e.bound_text == (f"bound {e.bound_ms:.4f} ms by bytes, 0.0071 ms"
                            " by the shared-memory lookup rate")


def test_sm_rate_reads_the_card(monkeypatch):
    """SMs from the device properties, the SM clock's maximum from
    ``nvidia-smi`` in MHz."""
    from mcl_3dl_tpu_torch import tools
    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        return types.SimpleNamespace(stdout="1980\n")

    monkeypatch.setattr(tools.subprocess, "run", fake_run)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: (
        types.SimpleNamespace(multi_processor_count=132)))
    assert tools.sm_rate() == (132, 1.98e9)
    assert seen == [["nvidia-smi", "--query-gpu=clocks.max.sm",
                     "--format=csv,noheader,nounits"]]


def test_gather_pairs_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gather_pairs.main(["--pairs", "1"])


def test_gather_pairs_alternates_builds(monkeypatch, capsys):
    """In each round every build is timed once, through its own wrapper,
    in list order in even rounds and reversed in odd ones, then the
    library call."""
    rows = [e for e in exp_gather2.lookups(torch.device("cpu"), q=1 << 15,
                                           bq=128) if e.tag == "G7"]
    calls = []

    def other_wrapper(tab, idx):
        calls.append("other")
        return ogb.sublane_gather_plain(tab, idx)

    other = types.SimpleNamespace(
        gather_bench=types.SimpleNamespace(sublane_gather=other_wrapper))
    order = []

    def fake_time_ms(fn, iters):
        if fn is rows[0].library:
            order.append("library")
        else:
            n = len(calls)
            fn()
            order.append("other" if len(calls) > n else "this")
        return 1.0 + len(order)

    monkeypatch.setattr(gather_pairs, "time_ms", fake_time_ms)
    monkeypatch.setattr(gather_pairs, "device_ms", lambda fn: 0.5)
    monkeypatch.setattr(gather_pairs, "host_ms", lambda fn: 0.25)
    res = gather_pairs.compare(rows, {"other": other}, 4, "cpu",
                               clock=lambda: "1980 MHz, 1980 MHz")
    assert order == ["this", "other", "library", "other", "this", "library"] * 2
    (e, times, dev), = res
    assert e is rows[0] and sorted(times) == ["library", "other", "this"]
    assert dev == {"this": [0.5] * 4, "other": [0.5] * 4}
    out = capsys.readouterr().out
    assert "G7 sublane_gather other: " in out and "this faster in 2 of 4" in out
    assert "equal to plain: True" in out
    assert ("device 0.5000 ms a call, this shorter in 0 of 4, host 0.2500 ms"
            " a call") in out
    assert "SM clock, max after the rounds: 1980 MHz, 1980 MHz" in out


def test_gather_pairs_variant_is_a_copy_with_defines(tmp_path, monkeypatch):
    """A variant is this package copied under ``build/variants/<name>/``
    with ``#define`` lines in front of its ``csrc/gather_bench.cu``; its
    build module compiles that copy (another source hash)."""
    pkg = pathlib.Path(build.__file__).resolve().parents[1]
    fake_build = tmp_path / pkg.name / "ops" / "build.py"
    fake_build.parent.mkdir(parents=True)
    monkeypatch.setattr(gather_pairs.build, "__file__", str(fake_build))
    (tmp_path / pkg.name / "csrc").mkdir()
    for f in ("build.py",) + tuple(f"{m}.py" for m in grouped_pairs.COPY_MODULES):
        (tmp_path / pkg.name / "ops" / f).write_text((pkg / "ops" / f).read_text())
    for f in build.SOURCES + build.HEADERS + (build.BINDING,):
        (tmp_path / pkg.name / "csrc" / f).write_text((pkg / "csrc" / f).read_text())
    mod = gather_pairs.variant("3x256", gather_pairs.VARIANTS["3x256"])
    copy = tmp_path / "build" / "variants" / "3x256" / pkg.name
    assert pathlib.Path(mod.build.CSRC) == copy / "csrc"
    text = (copy / "csrc" / "gather_bench.cu").read_text()
    head = text.splitlines()[:4]
    assert head == ["#define MCL_FLAT_THREADS 256", "#define MCL_FLAT_PER_SM 3",
                    "#define MCL_ROWSEL_THREADS 256",
                    "#define MCL_ROWSEL_PER_SM 3"]
    assert text.endswith((pkg / "csrc" / "gather_bench.cu").read_text())
    assert mod.build._digest() != build._digest()
    assert not list(copy.rglob("__pycache__"))
    # the copy's wrappers launch through the copy's build
    assert mod.gather_bench.build is mod.build and mod.grouped.build is mod.build
    assert mod.gather_bench.lane_gather is not ogb.lane_gather


def test_gather_pairs_variant_refuses_a_macro_the_source_lacks(tmp_path,
                                                               monkeypatch):
    """A macro with no ``#ifndef`` in ``csrc/gather_bench.cu`` would build
    this package's kernels unchanged: no copy is made."""
    pkg = pathlib.Path(build.__file__).resolve().parents[1]
    (tmp_path / "pkg" / "csrc").mkdir(parents=True)
    (tmp_path / "pkg" / "csrc" / "gather_bench.cu").write_text(
        (pkg / "csrc" / "gather_bench.cu").read_text())
    monkeypatch.setattr(gather_pairs.build, "__file__",
                        str(tmp_path / "pkg" / "ops" / "build.py"))
    with pytest.raises(ValueError, match="MCL_FLAT_BATCH"):
        gather_pairs.variant("b4", dict(MCL_FLAT_THREADS=512,
                                        MCL_FLAT_BATCH=4))
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("name", sorted(gather_pairs.VARIANTS))
def test_gather_pairs_variants_set_guarded_macros(name):
    """Every variant's macros are ones ``csrc/gather_bench.cu`` guards with
    ``#ifndef``, so ``variant`` builds it and its defines take effect."""
    pkg = pathlib.Path(build.__file__).resolve().parents[1]
    source = (pkg / "csrc" / "gather_bench.cu").read_text()
    defines = gather_pairs.VARIANTS[name]
    assert defines and all(f"#ifndef {k}\n" in source for k in defines)


def test_gather_pairs_pass_sweep_rows_compute_g10():
    """G10 with 0 and 4 passes: the rows' plain versions add that many
    lookups (none: zeros)."""
    rows = gather_pairs.pass_sweep(torch.device("cpu"))
    assert [e.lookups for e in rows] == [0, 4 << 20]
    assert [e.note for e in rows] == ["S=8, 0 passes", "S=8, 4 passes"]
    zero, four = (e.run() for e in rows)
    assert not zero.any()
    one = rows[1].library().reshape(four.shape)
    assert torch.equal(four, one + one + one + one)


def test_gather_pairs_sweep_rows_compute_g5():
    """The G5 rows beyond the script's size: kernel (plain on the CPU) and
    library call compute the same function."""
    rows = gather_pairs.sub_sweep(torch.device("cpu"), counts=(L * 3, L * 40))
    assert [e.lookups for e in rows] == [L * 3, L * 40]
    for e in rows:
        want = e.plain()
        assert torch.equal(e.run(), want) and torch.equal(e.library(), want)
