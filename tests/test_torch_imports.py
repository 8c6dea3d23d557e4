"""Packaging of the port: it imports neither JAX nor the JAX package, and
its engine runs on the CUDA device unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)   # several test workers share the CPU

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "mcl_3dl_tpu_torch"

_STEP = r"""
import sys
import numpy as np
import mcl_3dl_tpu_torch as m
from mcl_3dl_tpu_torch import worlds
p = m.Params(num_particles=1024, likelihood=m.LikelihoodParams(num_points=4),
             beam=m.BeamParams(clip_far=2.0, clip_z_min=-1.0, clip_z_max=1.0))
eng = m.MCL3DL(p, device="cpu")
eng.load_map(worlds.world_map())
pts = worlds.scan(np.random.default_rng(0), 128)
res = eng.measure_direct(pts, np.array([[0.0, 0.0, worlds.SENSOR_Z]], np.float32),
                         np.zeros(len(pts), np.int32), 0.1)
assert np.isfinite(res.pos).all()
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "jaxlib"
             or k == "mcl_3dl_tpu" or k.startswith("mcl_3dl_tpu."))
print("LOADED:" + ",".join(bad))
"""


def test_port_step_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _STEP], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = [s for s in out.stdout.splitlines() if s.startswith("LOADED:")][-1]
    assert line == "LOADED:", line


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "mcl_3dl_tpu", "__graft_entry__"), (
            f"{path.relative_to(ROOT)} imports {name}")


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_launch_nothing_through_ctypes(path):
    """The kernels launch through torch operators (``ops/build.py`` loads
    them with ``torch.ops.load_library``): no module imports ``ctypes``."""
    for name in _imports(path):
        assert name.split(".")[0] != "ctypes", (
            f"{path.relative_to(ROOT)} imports {name}")


def test_kernel_library_is_loaded_as_torch_operators():
    """``ops/build.py`` loads the kernels with ``torch.ops.load_library``
    and holds ``OpOverload``s, not C function pointers."""
    text = (PORT / "ops" / "build.py").read_text()
    assert "torch.ops.load_library" in text and ".default" in text
    assert "CDLL" not in text and "argtypes" not in text


def test_engine_defaults_to_cuda():
    from mcl_3dl_tpu_torch import MCL3DL, Params

    if torch.cuda.is_available():
        assert MCL3DL(Params(num_particles=64)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            MCL3DL(Params(num_particles=64))


_BLOCKED = r"""
import importlib
import sys
for name in ("jax", "jaxlib", "mcl_3dl_tpu", "__graft_entry__"):
    sys.modules[name] = None          # any import of them raises
mod = importlib.import_module(sys.argv[1])
print("IMPORTED:" + mod.__name__)
"""


@pytest.mark.parametrize("module", [
    "mcl_3dl_tpu_torch.engine", "mcl_3dl_tpu_torch.worlds",
    "mcl_3dl_tpu_torch.map.correlative", "mcl_3dl_tpu_torch.io.replay",
    "mcl_3dl_tpu_torch.tools.tier3", "mcl_3dl_tpu_torch.tools.run_tier3",
    "mcl_3dl_tpu_torch.tools.recovery",
    "mcl_3dl_tpu_torch.map.occupancy", "mcl_3dl_tpu_torch.map.distance_field",
    "mcl_3dl_tpu_torch.models.samplers", "mcl_3dl_tpu_torch.models.landmark",
    "mcl_3dl_tpu_torch.io.pcd", "mcl_3dl_tpu_torch.checkpoint",
    "mcl_3dl_tpu_torch.profiling", "mcl_3dl_tpu_torch.tools.run_replay",
    "mcl_3dl_tpu_torch.tools.all_options",
    "mcl_3dl_tpu_torch.parallel", "mcl_3dl_tpu_torch.parallel.sharding",
    "mcl_3dl_tpu_torch.shard", "mcl_3dl_tpu_torch.tools.fleet",
    "mcl_3dl_tpu_torch.tools.sharded",
])
def test_module_imports_with_jax_blocked(module):
    """The global-mode, correlative, replay and Tier-3 modules, the options
    and services, and the fleet and split modules import with JAX and the
    JAX package made unimportable."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED, module], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"IMPORTED:{module}" in out.stdout.splitlines()


_ALL_OPTIONS = r"""
import sys
for name in ("jax", "jaxlib", "mcl_3dl_tpu", "__graft_entry__"):
    sys.modules[name] = None          # any import of them raises
import numpy as np
import mcl_3dl_tpu_torch as m
from mcl_3dl_tpu_torch import worlds
p = m.Params(num_particles=1024,
             likelihood=m.LikelihoodParams(interp="trilinear", num_points=8),
             use_random_sampler_with_normal=True,
             beam=m.BeamParams(use_raycast_using_dda=True, clip_far=2.0),
             output_pcd=True)
eng = m.MCL3DL(p, device="cpu")
eng.load_map(worlds.world_map())
pts = worlds.scan(np.random.default_rng(0), 256)
res = eng.measure_direct(pts, np.array([[0.0, 0.0, worlds.SENSOR_Z]], np.float32),
                         np.zeros(len(pts), np.int32), 0.1)
assert np.isfinite(res.pos).all()
print("TIERS:%d,%d" % (eng.last_aux["tier_like"], eng.last_aux["tier_beam"]))
"""


def test_every_option_constructs_and_steps_with_jax_blocked():
    """``MCL3DL`` with trilinear sampling, the normal-weighted sampler, the
    DDA raycast and ``output_pcd`` constructs and measures (tiers 2/2)
    with JAX and the JAX package unimportable."""
    out = subprocess.run([sys.executable, "-c", _ALL_OPTIONS], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "TIERS:2,2" in out.stdout.splitlines()
