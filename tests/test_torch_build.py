"""The port's kernel build (``mcl_3dl_tpu_torch/ops/build.py``) on the CPU,
with the compilers faked: the command lines it runs, the hash that keys
the library and names the operators' namespace, and that a failed build
raises (nothing falls back to ctypes or to the plain versions).

The real build needs nvcc, a host C++ compiler and a CUDA build of torch;
it runs on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py`` phase 2).
"""

import shutil
import subprocess
import sys
import types

import pytest
import torch

from mcl_3dl_tpu_torch.ops import build

INCLUDES = ["/t/include", "/t/include/torch/csrc/api/include", "/cuda/include"]
LIBDIRS = ["/t/lib", "/cuda/lib64"]


@pytest.fixture
def fake_tools(monkeypatch, tmp_path):
    """Fake compilers and torch paths; the build root under ``tmp_path``."""
    monkeypatch.setattr(build, "_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(build, "_host_cxx", lambda: "/usr/bin/g++")
    monkeypatch.setattr(build, "_torch_paths", lambda: (INCLUDES, LIBDIRS))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "torch_kernels")
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_ops", {})
    return tmp_path


def _argv(flag_list, flag):
    return [a for a in flag_list if a.startswith(flag)]


def test_commands_compile_kernels_with_nvcc_and_binding_with_host(fake_tools):
    work = fake_tools / "work"
    compiles, link = build.commands(work, work / "lib.so")
    labels = [label for label, _ in compiles]
    assert labels == [f"nvcc {s}" for s in build.SOURCES] + ["host ops.cpp"]
    for label, argv in compiles[:-1]:
        assert argv[0] == "/cuda/bin/nvcc"
        assert "-fmad=false" in argv
        assert "arch=compute_90a,code=sm_90a" in argv
        assert argv[-2:] == ["-o", str(work / (label.split()[1][:-3] + ".o"))]
    _, host = compiles[-1]
    assert host[0] == "/usr/bin/g++"
    assert "-fPIC" in host and "-O2" in host
    assert _argv(host, "-I") == [f"-I{d}" for d in INCLUDES]
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    assert f"-D_GLIBCXX_USE_CXX11_ABI={abi}" in host
    assert f"-DMCL_OPS_NS=mcl3dl_{build._digest()}" in host
    assert host[host.index("-c") + 1].endswith("csrc/ops.cpp")
    assert "-fmad=false" not in host          # the host compiler's flags only
    # the link: every object, torch's libraries, no Python
    assert link[:2] == ["/cuda/bin/nvcc", "-shared"]
    for _, argv in compiles:
        assert argv[-1] in link
    assert _argv(link, "-L") == [f"-L{d}" for d in LIBDIRS]
    assert _argv(link, "-l") == [f"-l{n}" for n in
                                 ("torch", "torch_cpu", "torch_cuda", "c10",
                                  "c10_cuda")]
    assert not [a for a in link + host if "python" in a.lower()]


def test_namespace_holds_the_digest():
    ns = build.namespace()
    assert ns == f"mcl3dl_{build._digest()}"
    assert ns.isidentifier() and len(build._digest()) == 16


def test_digest_follows_the_binding_and_torch(monkeypatch, tmp_path):
    before = build._digest()
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert build._digest() == before
    (csrc / "ops.cpp").write_text((csrc / "ops.cpp").read_text() + "\n// x\n")
    edited = build._digest()
    assert edited != before
    monkeypatch.setattr(torch, "__version__", torch.__version__ + ".other")
    assert build._digest() not in (before, edited)
    monkeypatch.setattr(build, "HOST_FLAGS", build.HOST_FLAGS + ("-g",))
    assert build.namespace() != f"mcl3dl_{edited}"


def _fake_run(seen, fail=None):
    """``subprocess.run`` that records each argv, writes its ``-o`` file
    and fails the argv whose label source is ``fail``."""
    def run(argv, **kw):
        seen.append(argv)
        if fail and any(a.endswith(fail) for a in argv):
            return types.SimpleNamespace(returncode=1, stdout=f"error in {fail}")
        out = argv[argv.index("-o") + 1]
        with open(out, "w") as f:
            f.write("built")
        return types.SimpleNamespace(returncode=0, stdout="")
    return run


def test_build_runs_the_compiles_then_the_link(fake_tools, monkeypatch):
    seen = []
    monkeypatch.setattr(build.subprocess, "run", _fake_run(seen))
    lib = build.build()
    assert lib == build.BUILD_ROOT / build._digest() / "libmcl3dl_kernels.so"
    assert lib.read_text() == "built"
    assert len(seen) == len(build.SOURCES) + 2
    assert seen[-1][:2] == ["/cuda/bin/nvcc", "-shared"]      # the link last
    assert sorted(build.seconds) == ["host", "link", "nvcc"]
    assert not [p for p in lib.parent.iterdir() if p != lib]  # work dir gone
    seen.clear()
    assert build.build() == lib and seen == []                # kept
    assert build.seconds == {}


@pytest.mark.parametrize("fail", ["ops.cpp", "gather_bench.cu"])
def test_failed_build_raises_with_the_output(fake_tools, monkeypatch, fail):
    seen = []
    monkeypatch.setattr(build.subprocess, "run", _fake_run(seen, fail))
    loaded = []
    monkeypatch.setattr(torch.ops, "load_library", loaded.append)
    with pytest.raises(RuntimeError, match=f"error in {fail}"):
        build.library()
    assert not (build.BUILD_ROOT / build._digest() / "libmcl3dl_kernels.so"
                ).exists()
    assert loaded == [] and build._lib is None
    with pytest.raises(RuntimeError, match=f"error in {fail}"):
        build.op("flat_gather")


def test_missing_compiler_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda tool: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build._host_cxx()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_library_loads_once_and_op_keeps_overloads(fake_tools, monkeypatch):
    """``library`` loads the built file with ``torch.ops.load_library`` and
    returns ``torch.ops.<namespace>``; ``op`` keeps each ``OpOverload``."""
    monkeypatch.setattr(build.subprocess, "run", _fake_run([]))
    loaded = []
    ns = types.SimpleNamespace(flat_gather=types.SimpleNamespace(
        default=object()))
    monkeypatch.setattr(torch.ops, "load_library", loaded.append)
    monkeypatch.setattr(torch.ops, build.namespace(), ns, raising=False)
    assert build.library() is ns and build.library() is ns
    assert loaded == [str(build.BUILD_ROOT / build._digest()
                          / "libmcl3dl_kernels.so")]
    first = build.op("flat_gather")
    assert first is ns.flat_gather.default
    ns.flat_gather = None                     # not looked up again
    assert build.op("flat_gather") is first


def test_cpu_tensors_never_build(monkeypatch):
    """The wrappers take their plain versions for CPU tensors without
    building or loading anything."""
    from mcl_3dl_tpu_torch.ops import gather_bench as ogb

    def refuse(*a, **k):
        raise AssertionError("built on the CPU path")

    monkeypatch.setattr(build, "op", refuse)
    monkeypatch.setattr(build, "library", refuse)
    tab = torch.arange(1024, dtype=torch.float32).reshape(8, 128)
    idx = torch.arange(256, dtype=torch.int32).reshape(2, 128) * 7
    got = ogb.twostage_gather(tab, idx, 3)
    assert torch.equal(got, ogb.flat_gather_plain(tab, idx, 3))
    u8 = (torch.arange(256) % 256).to(torch.uint8).reshape(2, 128)
    assert torch.equal(ogb.lane_gather_u8(u8, idx, 1),
                       ogb.row_gather_plain(u8, idx, 1))


def _package_copy(tmp_path):
    """A copy of the package's kernel modules and sources under
    ``tmp_path``, as ``git archive`` of a commit would give."""
    pkg = build.CSRC.parent
    dst = tmp_path / pkg.name
    shutil.copytree(pkg / "ops", dst / "ops")
    shutil.copytree(pkg / "csrc", dst / "csrc")
    return dst


def test_load_copy_binds_the_copy_build(tmp_path):
    """``grouped_pairs.load_copy``: the copy's wrappers launch through the
    copy's own ``build`` (its hash, its library), while this package's
    wrappers keep theirs; on CPU tensors both take the plain version."""
    from mcl_3dl_tpu_torch.ops import gather_bench as ogb
    from mcl_3dl_tpu_torch.ops import grouped as og
    from mcl_3dl_tpu_torch.tools import grouped_pairs as gp

    dst = _package_copy(tmp_path)
    cu = dst / "csrc" / "gather_bench.cu"
    cu.write_text("#define MCL_U8_ROWS 64\n" + cu.read_text())
    copy = gp.load_copy(dst)
    for name in gp.COPY_MODULES:
        assert getattr(copy, name).build is copy.build
    assert copy.build.CSRC == dst / "csrc"
    assert copy.build.namespace() != build.namespace()
    assert ogb.build is build and og.build is build
    assert gp.this_copy().gather_bench is ogb
    tab = torch.arange(256, dtype=torch.uint8).reshape(2, 128)
    idx = torch.arange(256, dtype=torch.int32).reshape(2, 128) * 3
    assert torch.equal(copy.gather_bench.lane_gather_u8(tab, idx, 1),
                       ogb.lane_gather_u8(tab, idx, 1))
    with pytest.raises(FileNotFoundError):
        gp.load_copy(tmp_path / "nothing")


def test_grouped_pairs_times_each_copy_through_its_own_modules(monkeypatch,
                                                                capsys):
    """Each build's kernel runs through that build's modules, in turns
    (list order in even rounds, reversed in odd ones), and its device and
    host times are printed beside the medians."""
    from mcl_3dl_tpu_torch.tools import grouped_pairs as gp

    seen = []

    def case(c):
        seen.append(c.tag)
        return (torch.ones(4),)

    this = types.SimpleNamespace(tag="this")
    other = types.SimpleNamespace(tag="other")
    monkeypatch.setattr(gp, "this_copy", lambda: this)
    order = []

    def fake_time_ms(fn, iters):
        fn()
        order.append(seen[-1])
        return 1.0 + len(order)

    monkeypatch.setattr(gp, "time_ms", fake_time_ms)
    monkeypatch.setattr(gp, "device_ms", lambda fn: 0.5)
    monkeypatch.setattr(gp, "host_ms", lambda fn: 0.125)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    cases = {"k": (case, lambda: (torch.ones(4),), (4 << 20, 0),
                   torch.arange(4))}
    times = gp.compare(cases, {"other": other}, 4, "cpu")
    assert order == ["this", "other", "other", "this"] * 2
    assert sorted(times["k"]) == ["other", "this"]
    out = capsys.readouterr().out
    assert "k other: median" in out and "this faster in 2 of 4" in out
    assert ("device 0.5000 ms a call, this shorter in 0 of 4, host 0.1250 ms"
            " a call, equal to plain on kept slots: True") in out


def test_step_pairs_runs_each_build_in_its_own_processes(capsys):
    """``step_pairs.compare``: a warm-up child a build, then one child a
    build a round in alternating order, each on its own root; the medians
    are per process and the wins count this checkout's lower ones."""
    from mcl_3dl_tpu_torch.tools import step_pairs

    calls = []
    ms = {"a": iter([60.0, 70.0, 62.0, 61.0]), "b": iter([65.0, 64.0, 63.0, 66.0])}

    def run(root, steps):
        calls.append((root, steps))
        if steps == 1:
            return {}
        m = next(ms[root])
        return {"steady_ms": [m, m + 1.0, m - 1.0], "drive_ms": [m + 2.0],
                "tiers": [[0, 0]], "launches": [3, 5, 1],
                "probe_ms": [0.1, 0.2]}

    got = step_pairs.compare([("this", "a"), ("old", "b")], 4, 3, run=run,
                             where="card")
    assert calls == [("a", 1), ("b", 1)] + [
        ("a", 3), ("b", 3), ("b", 3), ("a", 3)] * 2
    assert got["this"][0] == [60.0, 61.0, 59.0]
    out = capsys.readouterr().out
    assert "process medians 60.00 70.00 62.00 61.00" in out
    assert "this lower in 3 of 4 [card]" in out
    assert "host ms 0.1000 before its library loads and 0.2000 after" in out
    with pytest.raises(RuntimeError, match="launches"):
        step_pairs.compare([("this", "a")], 1, 3, run=lambda root, steps: {
            "steady_ms": [1.0], "drive_ms": [], "tiers": [[0, 0]],
            "launches": [0, 1, 1], "probe_ms": [0.1, 0.1]})


def test_step_pairs_child_imports_only_its_checkout(tmp_path):
    """A child process imports the package of the root it was given, not
    this checkout's: a root whose package exits on import ends the child
    with that package's code before any torch import."""
    from mcl_3dl_tpu_torch.tools import step_pairs

    pkg = tmp_path / "mcl_3dl_tpu_torch"
    pkg.mkdir()
    (pkg / "__init__.py").write_text(
        "import sys\nassert 'torch' not in sys.modules\nsys.exit(42)\n")
    out = subprocess.run([sys.executable, step_pairs.__file__, "--child",
                          str(tmp_path)], cwd=tmp_path, capture_output=True,
                         text=True)
    assert out.returncode == 42, out.stderr
    with pytest.raises(RuntimeError, match="exited 42"):
        step_pairs.run_child(tmp_path, 1)
