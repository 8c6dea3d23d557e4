"""``MCL3DL._step`` (``step_graph.py``), the steady step replayed from CUDA
graphs, checked on the CPU with the graphs emulated: a capture runs the
function once and keeps its outputs, a replay runs it again and copies the
results into those outputs, the buffers a graph writes (``emulated``).
Everything else is the card's path: the static input buffers, the split
at the host read of the ``fits`` flags, the warm-up, graph B only at
tiers 0/0, the eager remainder otherwise, outputs copied out, the launch
counts added on a replay, the cache key and the services that drop it.

On the JAX engine's small flagship step (``test_torch_engine.py``: 2048
particles, JAX's draws injected):
* graphed steps equal eager ``_measurement_step`` steps bit for bit,
  chained over 5 steps on the same draws, and on a step whose flags do
  not fit;
* a graphed step equals JAX's ``_measurement_step`` within
  ``test_torch_engine.py``'s tolerances (tiers equal, ``e_pos``/``e_rot``
  atol 1e-5, ``cov`` rtol 1e-3 / atol 1e-9).
"""

import numpy as np
import pytest
import torch

from mcl_3dl_tpu_torch import MCL3DL, Params, StepDraws, step_graph, worlds
from mcl_3dl_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from mcl_3dl_tpu_torch.models.beam import march_fixed
from mcl_3dl_tpu_torch.ops import grouped as og

from test_torch_engine import (_jax_draws, _np, _port_engine, _t,  # noqa: F401
                               jax_world)

torch.set_num_threads(2)   # several test workers share the CPU

STEPS = 5


def _write(dst, src):
    """``dst.copy_(src)``; a broadcast (stride-0) dimension, which a graph
    writes through the one element behind it, is written at index 0."""
    for dim in range(dst.dim()):
        if dst.stride(dim) == 0 and dst.shape[dim] > 1:
            dst, src = dst.narrow(dim, 0, 1), src.narrow(dim, 0, 1)
    dst.copy_(src)


class _Replay:
    """An emulated graph: ``replay`` runs ``fn`` again and copies its
    results into the outputs kept at capture."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        new = self.fn()
        for d, s in zip(step_graph.leaves(self.out), step_graph.leaves(new),
                        strict=True):
            _write(d, s)


@pytest.fixture
def emulated(monkeypatch):
    def capture(fn, pool):
        out = fn()
        return _Replay(fn, out), out

    monkeypatch.setattr(step_graph, "enabled", lambda device: True)
    monkeypatch.setattr(step_graph, "new_pool", lambda device: None)
    monkeypatch.setattr(step_graph, "capture", capture)


def _inputs(eng_j, args):
    eng = _port_engine(eng_j)
    p = eng.params
    state = _port_state(args)
    fp, fa = (_filter(f) for f in args[14:16])
    rest = (eng.map.df, eng.map.df_beam, _t(args[5]), _t(args[6], np.int64),
            _t(args[7]), _t(args[9]), _t(args[10]), _t(args[11]),
            _t(args[12]), _t(args[13]), fp, fa, False,
            (p.std_warn_thresh_xy, p.std_warn_thresh_z, p.std_warn_thresh_yaw))
    return eng, state, rest


def _port_state(args):
    from mcl_3dl_tpu_torch import convert

    return convert.particle_state(*(_np(x) for x in args[0]))


def _filter(f):
    from mcl_3dl_tpu_torch import convert

    return convert.filter_state(*(_np(x) for x in f))


def _same(a, b) -> bool:
    """Every tensor equal bit for bit and every other value equal."""
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and bool(torch.equal(a, b)))
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def _chain(step, state, rest, draws):
    """``len(draws)`` steps, each on the last one's state, filters and
    previous pose; returns every step's outputs."""
    outs = []
    rest = list(rest)
    for d in draws:
        out = step(state, *rest, d)
        outs.append(out)
        state = out[0]
        rest[10], rest[11], rest[8], rest[9] = out[1], out[2], out[3], out[4]
    return outs


def _draws(eng, rest, n, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    keeps = eng.keeps(rest[2], rest[4])
    return [eng.draw_step(*keeps, gen=gen) for _ in range(n)]


def test_step_is_measurement_step_on_the_cpu(jax_world):
    eng, state, rest = _inputs(*jax_world)
    d = _draws(eng, rest, 1)[0]
    got = eng._step(state, *rest, d)
    want = eng._measurement_step(state, *rest, d)
    assert _same(got, want)
    assert eng._graphs == {} and eng.step_routes["eager"] == 1


def test_chained_graphed_steps_equal_eager(jax_world, emulated):
    eng, state, rest = _inputs(*jax_world)
    draws = _draws(eng, rest, STEPS)
    graphed = _chain(eng._step, state, rest, draws)
    eager = _chain(eng._measurement_step, state, rest, draws)
    for i, (g, e) in enumerate(zip(graphed, eager)):
        assert _same(g, e), f"step {i}"
    tiers = [(o[5]["tier_like"], o[5]["tier_beam"]) for o in eager]
    assert tiers[0] == (0, 0)
    routes = eng.step_routes
    assert routes["warm_up"] == 1 and routes["eager"] == 0
    assert routes["graph"] == sum(t == (0, 0) for t in tiers[1:])
    assert routes["graph"] + routes["graph_front"] == STEPS - 1
    assert routes["graph"] >= 1
    assert len(eng._graphs) == 1
    entry = next(iter(eng._graphs.values()))
    assert entry.graph_a is not None and (True, True) in entry.backs
    # the outputs are copies: a later replay leaves them as they were
    before = graphed[-1][0].pos.clone()
    eng._step(graphed[-1][0], *rest, draws[0])
    assert torch.equal(graphed[-1][0].pos, before)


def test_graphed_step_without_fitting_flags_runs_the_rest_eagerly(
        jax_world, emulated):
    eng, state, rest = _inputs(*jax_world)
    draws = _draws(eng, rest, 3)
    _chain(eng._step, state, rest, draws[:2])       # warm-up, then A and B
    assert eng.step_routes["graph"] == 1
    gen = torch.Generator()
    gen.manual_seed(1)
    wide = state._replace(pos=state.pos + torch.randn(
        state.pos.shape, generator=gen))             # 1 m: fits no box
    got = eng._step(wide, *rest, draws[2])
    want = eng._measurement_step(wide, *rest, draws[2])
    assert _same(got, want)
    assert eng.step_routes["graph_front"] == 1
    assert (got[5]["tier_like"], got[5]["tier_beam"]) != (0, 0)
    # the outputs are copies: the next replay of graph A (on a cloud with
    # no valid point: another ``points_not_found``) leaves them
    empty = list(rest)
    empty[4] = torch.zeros_like(rest[4])
    eng._step(state, *empty, draws[0])
    assert _same(got, want)


def test_graphed_step_matches_jax(jax_world, emulated):
    eng_j, args = jax_world
    eng, state, rest = _inputs(eng_j, args)
    draws = _jax_draws(eng_j, args)
    fix = torch.tensor(False)
    for _ in range(3):                   # warm-up, capture, replay
        out = eng._step(state, *rest[:12], fix, rest[13], draws)
    assert eng.step_routes["graph"] == 2
    want = eng._measurement_step(state, *rest, draws)
    assert _same(out, want)
    jaux = eng_j._step(*args)[-1]
    aux = out[-1]
    assert (aux["tier_like"], aux["tier_beam"]) == (0, 0)
    assert (int(jaux["tier_like"]), int(jaux["tier_beam"])) == (0, 0)
    np.testing.assert_allclose(aux["e_pos"].numpy(), _np(jaux["e_pos"]),
                               atol=1e-5)
    np.testing.assert_allclose(aux["e_rot"].numpy(), _np(jaux["e_rot"]),
                               atol=1e-5)
    np.testing.assert_allclose(aux["cov"].numpy(), _np(jaux["cov"]),
                               rtol=1e-3, atol=1e-9)


def test_step_key_changes_with_capacity_bucket_and_origins():
    def key(cap, bucket, n_origins, beam=True):
        state = type("S", (), {"capacity": cap})()
        draws = StepDraws(torch.zeros(96, dtype=torch.int64),
                          torch.zeros(3, dtype=torch.int64), torch.zeros(()),
                          None, None, None)
        return step_graph.step_key(state, torch.zeros(bucket, 3),
                                   torch.zeros(n_origins, 3), draws, beam,
                                   (1.0, 1.0, 1.0), "df", "df_beam")

    base = key(2048, 4096, 1)
    assert key(2048, 4096, 1) == base
    for other in (key(4096, 4096, 1), key(2048, 8192, 1), key(2048, 4096, 2),
                  key(2048, 4096, 1, beam=False)):
        assert other != base


SERVICES = {
    "initial_pose": lambda e, _: e.initial_pose(
        np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]), worlds.TRACKING_COV),
    "resize_particles": lambda e, _: e.resize_particles(128),
    "global_localization": lambda e, _: e.global_localization(),
    "global_localization_correlative":
        lambda e, _: e.global_localization_correlative(
            num_seeds=16, yaw_bins=8,
            scan_points_base=worlds.scan(np.random.default_rng(0), 256)),
    "expansion_reset": lambda e, _: e.expansion_reset(),
    "landmark": lambda e, _: e.landmark(
        np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]), np.eye(6) * 0.1),
    "load_map": lambda e, _: e.load_map(worlds.world_map()),
    "update_map": lambda e, _: e.update_map(
        np.array([[1.0, 1.0, 0.5], [1.0, 1.1, 0.5]])),
    "load_checkpoint": lambda e, path: load_checkpoint(e, path),
}


@pytest.fixture(scope="module")
def service_engine(tmp_path_factory):
    eng = MCL3DL(Params(num_particles=64, global_localization_grid_lin=0.5,
                        global_localization_grid_ang=0.5), device="cpu")
    eng.load_map(worlds.world_map())
    path = tmp_path_factory.mktemp("ckpt") / "engine.npz"
    save_checkpoint(eng, path)
    return eng, path


@pytest.mark.parametrize("service", sorted(SERVICES))
def test_services_drop_the_graphs(service_engine, service):
    eng, path = service_engine
    eng._graphs["a key"] = "a graph"
    SERVICES[service](eng, path)
    assert eng._graphs == {}


def test_replays_add_the_launches_held_by_a_capture(monkeypatch):
    class Noop:
        def replay(self):
            pass

    monkeypatch.setattr(step_graph, "capture", lambda fn, pool: (Noop(), fn()))
    kernels = (og.grouped_like_score, og.grouped_beam_pen, march_fixed)
    for k in kernels:
        monkeypatch.setattr(k, "launches", 5)

    def body():
        og.grouped_like_score.launches += 1
        og.grouped_beam_pen.launches += 1
        march_fixed.launches += 2
        return torch.zeros(1)

    entry = step_graph.StepGraph(None, None, torch.device("cpu"))
    entry.replay_front(body)            # the capture counts none, the replay
    assert [k.launches for k in kernels] == [6, 6, 7]
    entry.replay_front(body)
    entry.replay_back((True, True), body)
    assert [k.launches for k in kernels] == [8, 8, 11]
