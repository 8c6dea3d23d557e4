"""The tier-2 measurement of the port on the CPU: kernels M2-M4's wrappers
(``march_sphere``, ``march_dda``, ``sample_field``), a scalar per-ray (or
per-query) Python reference of each kernel's algorithm, the JAX
functions, the vmap rule that folds robots into rays, and the step
graphs' choice of route per ``fits`` outcome.

Tolerances and why:
* each wrapper on a CPU tensor against its plain version, and the scalar
  reference (numpy float32, each ray marched alone to its own exit, as
  one thread of the kernel marches it) against the vectorised plain
  loop, with and without its early exit: bit-equal;
* ``sample_field`` against JAX's samplers: nearest equal outside queries
  within 1e-4 cell of a .5 rounding boundary, trilinear within 2e-6 of
  ``trunc`` outside queries within 1e-4 cell of a cell face (both found
  in float64; ROADMAP queue 3's accepted deviations, as in
  ``test_torch_trilinear.py``);
* ``march_sphere`` against JAX's ``raycast_df``: hit flags equal,
  collision points and incidence sines within 1e-5, on at least 99% of
  rays (``test_torch_benchmark_raycast.py``'s tolerance: the step
  ``(d - r) / |W u|`` accumulates f32 rounding along the ray);
* ``march_dda`` against JAX's ``raycast_occ``: at least 99% of rays agree
  (hit flags equal, collision points within 1e-6 m), and every ray that
  differs is a boundary ray (``test_torch_dda._boundary_rays``);
* the vmap rule: bit-equal to the operator called robot by robot;
* the routes: exact.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcl_3dl_tpu.map.native as jnative
from mcl_3dl_tpu.map.distance_field import build_distance_field as j_build_df
from mcl_3dl_tpu.map.occupancy import build_occupancy_grid as j_build_occ
from mcl_3dl_tpu.models import beam as jbeam

from mcl_3dl_tpu_torch import convert, step_graph, worlds
from mcl_3dl_tpu_torch.config import BeamParams, LikelihoodParams, Params
from mcl_3dl_tpu_torch.map.distance_field import sample_field
from mcl_3dl_tpu_torch.map.map_data import MapData
from mcl_3dl_tpu_torch.models import beam as tbeam
from mcl_3dl_tpu_torch.models.likelihood import box_path
from mcl_3dl_tpu_torch.ops import build
from mcl_3dl_tpu_torch.tools import bench

from test_torch_dda import _boundary_rays
from test_torch_step_graph import _chain, _same, emulated  # noqa: F401

torch.set_num_threads(2)   # several test workers share the CPU

F = np.float32
FACE = 1e-4
HIT = 0.3
ORIGIN = np.array([0.0, 0.0, worlds.SENSOR_Z])


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(jnative, "build_occupancy_rep_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(jnative, "build_distance_field_native",
                        lambda *a, **k: None)


@functools.lru_cache(maxsize=1)
def _map():
    """The flagship world's maps, labels 0-2 with ``filter_label_max`` 1
    (a label-filtered beam field and grid)."""
    pts = worlds.world_map()
    labels = np.random.default_rng(7).integers(0, 3, len(pts)).astype(
        np.uint32)
    return MapData.build(pts, Params(beam=BeamParams(filter_label_max=1)),
                         labels, device="cpu")


def _rays(seed, n=384, spread=0.5):
    """``(begins, ends)`` [n, 3] f32: from about the sensor origin to scan
    points of the flagship world, poses spread by ``spread`` m and
    0.2 * spread rad of yaw; the first 4 rays have zero length and the
    next 4 begin outside the map."""
    rng = np.random.default_rng(seed)
    pts = worlds.scan(rng, n)
    yaw = rng.normal(0.0, 0.2 * spread, n)
    c, s = np.cos(yaw), np.sin(yaw)
    shift = np.stack([rng.normal(0, spread, n), rng.normal(0, spread, n),
                      rng.normal(0, 0.05, n)], axis=1)
    ends = np.stack([c * pts[:, 0] - s * pts[:, 1],
                     s * pts[:, 0] + c * pts[:, 1], pts[:, 2]], axis=1)
    begins = ORIGIN[None] + shift
    ends = ends + shift
    ends[:4] = begins[:4]
    begins[4:8] += np.array([40.0, -30.0, 5.0])
    return begins.astype(np.float32), ends.astype(np.float32)


# ---- scalar references: one query or one ray at a time, numpy float32


def _cell_f(q, w, o, cell):
    return (F(q) * F(w) - F(o)) / F(cell)


def _ref_nearest(df, q):
    field = df.field.numpy()
    org = df.origin.numpy()
    i = [int(np.rint(_cell_f(q[a], df.weights[a], org[a], df.cell)))
         for a in range(3)]
    if any(i[a] < 0 or i[a] >= field.shape[a] for a in range(3)):
        return F(df.trunc)
    return F(field[i[0], i[1], i[2]]) * F(df.trunc / 255.0)


def _ref_trilinear(df, q, packed):
    field = df.field.numpy()
    org = df.origin.numpy()
    dims = field.shape
    u = [_cell_f(q[a], df.weights[a], org[a], df.cell) for a in range(3)]
    i0 = [int(np.floor(x)) for x in u]
    w = [(F(1.0) - (u[a] - F(i0[a])), u[a] - F(i0[a])) for a in range(3)]
    words = None
    if packed:
        pk = df.packed.numpy()
        ic = [min(max(i0[a], 0), dims[a] - 2) for a in range(3)]
        words = pk[(ic[0] * dims[1] + ic[1]) * dims[2] + ic[2]]
    out = F(0.0)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                c = (i0[0] + dx, i0[1] + dy, i0[2] + dz)
                v = F(df.trunc)
                if all(0 <= c[a] < dims[a] for a in range(3)):
                    code = ((int(words[dx]) >> (8 * (dz + 2 * dy))) & 0xFF
                            if packed else int(field[c]))
                    v = F(code) * F(df.trunc / 255.0)
                out = out + w[0][dx] * w[1][dy] * w[2][dz] * v
    return out


def _ref_sphere(df, b, d, mt, wu, grid, grid_max, num_steps):
    """One ray of M2 to its own exit: ``(found, cpos, d0_hit, t_entry,
    d_entry)``."""
    radius = F(2.0 ** 0.5 * grid_max / 2.0)
    thr = F(df.trunc * 0.99)
    wu_c = max(F(wu), F(1e-6))
    found, t, cpos, d0 = False, F(grid), [F(0.0)] * 3, F(0.0)
    t_entry, d_entry = F(-1.0), F(df.trunc)
    for _ in range(num_steps):
        if not t < mt:
            break
        p = [F(b[a]) + F(d[a]) * t for a in range(3)]
        dist = _ref_nearest(df, p)
        if dist < thr and t_entry < 0.0:
            t_entry, d_entry = t, dist
        if dist <= radius:
            found, cpos, d0 = True, p, dist
            break
        t = t + max((dist - radius) / wu_c, F(grid))
    return found, cpos, d0, t_entry, d_entry


def _ref_dda(occ, b, d, mt, inside, bv, label_max, num_steps, rah, mdts):
    """One ray of M3 to its own exit: ``(found, cpos)``."""
    occupied = occ.occupied.numpy()
    labels = occ.min_label.numpy()
    rep = occ.rep_point.numpy()
    org = occ.origin.numpy()
    cell, step = F(occ.cell), F(occ.cell * 0.5)
    refine = rah > 0.0 or mdts > 0.0
    if not inside:
        return False, [F(0.0)] * 3
    for s in range(num_steps):
        t = F((s + 1) * step)
        if not t < mt:
            break
        p = [F(b[a]) + F(d[a]) * t for a in range(3)]
        v = [int(np.floor((p[a] - org[a]) / cell)) for a in range(3)]
        if not all(0 <= v[a] < occupied.shape[a] for a in range(3)):
            continue
        if not occupied[tuple(v)] or labels[tuple(v)] > label_max:
            continue
        if v == [int(x) for x in bv]:
            continue
        for k in range(rep.shape[3]):
            rp = [org[a] + (F(v[a]) + F(rep[tuple(v)][k, a]) / F(255.0))
                  * cell for a in range(3)]
            if not refine:
                return True, rp
            rel = [rp[a] - F(b[a]) for a in range(3)]
            foot = abs(rel[0] * F(d[0]) + rel[1] * F(d[1]) + rel[2] * F(d[2]))
            ra = F(rah) * foot
            thr = max(ra * ra, F(mdts))
            perp = (rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2]
                    - foot * foot)
            if perp < thr:
                return True, rp
    return False, [F(0.0)] * 3


def _queries(seed, n=1024):
    """Queries [n, 3] f32 over the flagship field and a margin outside
    it, some on exact cell centres and faces."""
    rng = np.random.default_rng(seed)
    q = rng.uniform([-7.0, -7.0, -1.0], [7.0, 7.0, 3.5], (n, 3))
    q[:64] = np.round(q[:64] * 20.0) / 20.0        # on the 0.05 m grid
    q[64:128] = np.round(q[64:128] * 10.0) / 10.0 + 0.025
    return q.astype(np.float32)


@pytest.mark.parametrize("mode", ["nearest", "trilinear", "eight_corners"])
def test_sample_field_equals_plain_and_the_scalar_reference(mode):
    df = _map().df
    if mode == "eight_corners":
        df = convert.distance_field(df.field.numpy(), df.origin.numpy(),
                                    df.cell, df.trunc, df.weights,
                                    df.field2d.numpy(), packed=None)
    assert (df.packed is None) == (mode == "eight_corners")
    q = torch.as_tensor(_queries(1))
    tri = mode != "nearest"
    got = sample_field(df, q, tri)
    plain = df.sample_trilinear(q) if tri else df.sample_nearest(q)
    assert sample_field.launches == 0 and torch.equal(got, plain)
    # a [N, K, 3] query block keeps its shape
    assert sample_field(df, q.reshape(8, -1, 3), tri).shape == (8, 128)
    want = np.array([_ref_trilinear(df, x, df.packed is not None) if tri
                     else _ref_nearest(df, x) for x in q.numpy()], F)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < float((got < F(df.trunc)).float().mean()) < 1.0


@pytest.mark.parametrize("tri", [False, True], ids=["nearest", "trilinear"])
def test_sample_field_matches_jax(no_native, tri):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-3.0, 3.0, (400, 3))
    jdf = j_build_df(pts, 0.1, 0.6, weights=(1.0, 1.0, 2.0),
                     pack_corners=True)
    tdf = convert.distance_field(
        np.asarray(jdf.field), np.asarray(jdf.origin), jdf.cell, jdf.trunc,
        jdf.weights, np.asarray(jdf.field2d), packed=np.asarray(jdf.packed))
    q = rng.uniform(-4.5, 4.5, (8192, 3)).astype(np.float32)
    got = sample_field(tdf, torch.as_tensor(q), tri).numpy()
    want = np.asarray(jdf.sample_trilinear(jnp.asarray(q)) if tri
                      else jdf.sample_nearest(jnp.asarray(q)))
    u = ((q.astype(np.float64) * np.asarray(jdf.weights))
         - np.asarray(jdf.origin, np.float64)) / jdf.cell
    edge = u - np.floor(u) if tri else np.abs(u - np.floor(u) - 0.5)
    near = (np.minimum(edge, 1.0 - edge) < FACE if tri
            else edge < FACE).any(axis=-1)
    assert near.mean() < 2e-3
    if tri:
        np.testing.assert_allclose(got[~near], want[~near], rtol=0,
                                   atol=2e-6 * jdf.trunc)
    else:
        np.testing.assert_array_equal(got[~near], want[~near])


@pytest.mark.parametrize("early_exit", [True, False], ids=["early", "fixed"])
def test_sphere_trace_per_ray_reference_equals_the_loop(early_exit):
    m = _map()
    df = m.df_beam
    p = Params()
    begins, ends = _rays(2)
    b, e = torch.as_tensor(begins), torch.as_tensor(ends)
    steps = p.beam.max_sphere_steps
    direction, max_t, wu = tbeam._sphere_setup(df, b, e, p.map_grid_min, HIT)
    carry, probes = tbeam._sphere_loop(df, b, direction, max_t, wu,
                                       p.map_grid_min, p.map_grid_max, steps,
                                       early_exit)
    assert (probes is None) == (not early_exit)
    refs = [_ref_sphere(df, begins[i], direction[i].numpy(),
                        max_t[i].numpy(), wu[i].numpy(), p.map_grid_min,
                        p.map_grid_max, steps) for i in range(len(begins))]
    found, cpos, d0, t_entry, d_entry = (x.numpy() for x in carry)
    np.testing.assert_array_equal(found, [r[0] for r in refs])
    np.testing.assert_array_equal(cpos, np.array([r[1] for r in refs], F))
    for got, k in ((d0, 2), (t_entry, 3), (d_entry, 4)):
        np.testing.assert_array_equal(got, np.array([r[k] for r in refs], F))
    assert 0.2 < found.mean() < 1.0
    # the wrapper on the CPU is the plain version, with either exit
    args = (df, b, e, p.map_grid_min, p.map_grid_max, HIT, steps)
    for a, w in zip(tbeam.march_sphere(*args, early_exit=early_exit),
                    tbeam.raycast_df(*args)):
        assert torch.equal(a, w)
    assert tbeam.march_sphere.launches == 0


@pytest.mark.parametrize("early_exit", [True, False], ids=["early", "fixed"])
@pytest.mark.parametrize("refine", [True, False], ids=["perp", "voxel"])
def test_dda_per_ray_reference_equals_the_loop(refine, early_exit):
    occ = _map().occ
    p = Params()
    rah, mdts = ((p.beam.ray_angle_half, p.min_dist_thr_sq) if refine
                 else (0.0, 0.0))
    begins, ends = _rays(3, n=256)
    b, e = torch.as_tensor(begins), torch.as_tensor(ends)
    steps = int(np.ceil((p.beam.clip_far + HIT) / (occ.cell * 0.5))) + 2
    direction, max_t, inside, bv = tbeam._dda_setup(occ, b, e, HIT)
    assert not inside[4:8].any() and inside[8:].float().mean() > 0.9
    (found, cpos), probes = tbeam._dda_loop(occ, b, direction, max_t, inside,
                                            bv, 1, steps, rah, mdts,
                                            early_exit)
    assert (probes is None) == (not early_exit)
    refs = [_ref_dda(occ, begins[i], direction[i].numpy(), max_t[i].numpy(),
                     bool(inside[i]), bv[i].numpy(), 1, steps, rah, mdts)
            for i in range(len(begins))]
    np.testing.assert_array_equal(found.numpy(), [r[0] for r in refs])
    np.testing.assert_array_equal(cpos.numpy(), np.array([r[1] for r in refs],
                                                         F))
    assert 0.2 < float(found.float().mean()) < 1.0
    args = (occ, b, e, HIT, 1, steps, rah, mdts)
    for a, w in zip(tbeam.march_dda(*args, early_exit=early_exit),
                    tbeam.raycast_occ(*args)):
        assert torch.equal(a, w)
    assert tbeam.march_dda.launches == 0


def test_march_sphere_matches_jax(no_native):
    pts = worlds.world_map()
    jdf = j_build_df(pts, 0.1, 0.3)
    tdf = convert.distance_field(
        np.asarray(jdf.field), np.asarray(jdf.origin), jdf.cell, jdf.trunc,
        jdf.weights, np.asarray(jdf.field2d))
    begins, ends = _rays(4, n=1024)
    found, cpos, sin_ang = tbeam.march_sphere(
        tdf, torch.as_tensor(begins), torch.as_tensor(ends), 0.1, 0.1, HIT,
        24)
    jfound, jcpos, jsin = jbeam.raycast_df(
        jdf, jnp.asarray(begins), jnp.asarray(ends), 0.1, 0.1, HIT, 24)
    same = ((found.numpy() == np.asarray(jfound))
            & np.all(np.abs(cpos.numpy() - np.asarray(jcpos)) <= 1e-5, -1)
            & (np.abs(sin_ang.numpy() - np.asarray(jsin)) <= 1e-5))
    assert same.mean() >= 0.99, same.mean()
    assert 0.2 < found.float().mean() < 1.0


@pytest.mark.parametrize("refine", [True, False], ids=["perp", "voxel"])
def test_march_dda_matches_jax(no_native, refine):
    pts = worlds.world_map()
    jocc = j_build_occ(pts, 0.2)
    tocc = convert.occupancy_grid(
        np.asarray(jocc.occupied), np.asarray(jocc.min_label),
        np.asarray(jocc.rep_point), np.asarray(jocc.origin), jocc.cell)
    p = Params()
    rah, mdts = ((p.beam.ray_angle_half, p.min_dist_thr_sq) if refine
                 else (0.0, 0.0))
    begins, ends = _rays(5, n=1024)
    steps = int(np.ceil((p.beam.clip_far + HIT) / 0.1)) + 2
    found, cpos, _ = tbeam.march_dda(
        tocc, torch.as_tensor(begins), torch.as_tensor(ends), HIT,
        0xFFFFFFFF, steps, ray_angle_half=rah, min_dist_thr_sq=mdts)
    jfound, jcpos, _ = jbeam.raycast_occ(
        jocc, jnp.asarray(begins), jnp.asarray(ends), HIT, 0xFFFFFFFF, steps,
        ray_angle_half=rah, min_dist_thr_sq=mdts)
    same = ((found.numpy() == np.asarray(jfound))
            & np.all(np.abs(cpos.numpy() - np.asarray(jcpos)) <= 1e-6, -1))
    assert same.mean() >= 0.99, same.mean()
    boundary = _boundary_rays(jocc, begins, ends, steps, rah, mdts)
    assert not (~same & ~boundary).any(), np.argwhere(~same & ~boundary)
    assert 0.2 < found.float().mean() < 1.0


# ---- the vmap rule


@functools.lru_cache(maxsize=1)
def _sphere_op():
    """A CPU operator with M2's leading arguments (begin, direction,
    max_t, wu) and outputs, the plain loop behind it: what the rule folds."""
    df = _map().df_beam
    p = Params()

    @torch.library.custom_op("mcl3dl_tier2_test::sphere", mutates_args=())
    def sphere(begin: torch.Tensor, direction: torch.Tensor,
               max_t: torch.Tensor, wu: torch.Tensor, field: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor, torch.Tensor]:
        carry, _ = tbeam._sphere_loop(df, begin, direction, max_t, wu,
                                      p.map_grid_min, p.map_grid_max, 24,
                                      False)
        return tuple(x.clone() for x in carry)

    sphere.register_vmap(build.fold_rule(lambda: sphere, 4))
    return sphere, df


@pytest.mark.parametrize("shared_begin", [False, True])
def test_fold_rule_gives_each_robots_bits(shared_begin):
    op, df = _sphere_op()
    p = Params()
    robots = []
    for seed in range(3):
        begins, ends = _rays(10 + seed, n=96)
        b, e = torch.as_tensor(begins), torch.as_tensor(ends)
        robots.append((b, *tbeam._sphere_setup(df, b, e, p.map_grid_min,
                                               HIT)))
    b, direction, max_t, wu = (torch.stack(x) for x in zip(*robots))
    if shared_begin:            # an unbatched argument is expanded
        b = b[0]
        got = torch.func.vmap(op, in_dims=(None, 0, 0, 0, None))(
            b, direction, max_t, wu, df.field)
    else:
        got = torch.func.vmap(op, in_dims=(0, 1, 0, 0, None))(
            b, direction.movedim(0, 1), max_t, wu, df.field)
    for i in range(3):
        want = op(b if shared_begin else b[i], direction[i], max_t[i], wu[i],
                  df.field)
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)


# ---- the step graphs' routes


@pytest.mark.parametrize("n,trilinear,local,expect", [
    (64, False, True, False),        # no whole 128-slot rows
    (512, False, True, True),
    (1 << 20, False, True, True),
    (1024, True, True, False),       # trilinear: always tier 2
    (1024, False, False, False),     # the batched fleet
])
def test_box_path_rule(n, trilinear, local, expect):
    assert box_path(n, 0.3, 0.2, trilinear=trilinear,
                    local_kernel=local) is expect
    assert box_path(n, 0.2, 0.2, trilinear=trilinear,
                    local_kernel=local) is False   # trunc within the match


class _Engine:
    def __init__(self, interp):
        self.params = Params(likelihood=LikelihoodParams(interp=interp))


def _front(share_like, grouped_beam):
    group = None
    if share_like or grouped_beam:
        group = type("G", (), {"share_like": share_like})()
    return type("F", (), {"group": group})()


@pytest.mark.parametrize("case,outcome,graphed", [
    # capacity, interp, share_like, grouped beam; then the outcome read
    ((64, "nearest", False, False), (), True),
    ((512, "nearest", False, False), (), False),
    ((512, "trilinear", False, False), (), True),
    ((4096, "nearest", True, True), (True, True), True),
    ((4096, "nearest", True, True), (True, False), True),
    ((4096, "nearest", True, True), (False, True), False),
    ((4096, "nearest", True, True), (False, False), False),
    ((4096, "trilinear", False, True), (True,), True),
    ((4096, "trilinear", False, True), (False,), True),
    ((4096, "nearest", True, False), (True,), True),      # DDA beam
    ((4096, "nearest", True, False), (False,), False),
])
def test_back_graphable_per_outcome(case, outcome, graphed):
    cap, interp, share_like, grouped_beam = case
    state = type("S", (), {"capacity": cap})()
    df = _map().df
    got = step_graph.back_graphable(_Engine(interp), state, df,
                                    _front(share_like, grouped_beam),
                                    list(outcome))
    assert got is graphed


CONFIGS = {
    # name -> (particles, bench.build keywords, the routes after warm-up)
    "small-64": (64, {}, {"graph"}),
    "box-512": (512, {}, {"graph_front"}),
    "trilinear-1024": (1024, dict(interp="trilinear"), {"graph"}),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_graphed_steps_take_their_outcomes_route(emulated, name):
    n, kw, routes = CONFIGS[name]
    eng, _, args = bench.build(n, "cpu", cloud_points=1024, **kw)
    gen = torch.Generator()
    gen.manual_seed(0)
    keeps = eng.keeps(args[2], args[4])
    draws = [eng.draw_step(*keeps, gen=gen) for _ in range(4)]
    graphed = _chain(eng._step, eng.pstate, args, draws)
    eager = _chain(eng._measurement_step, eng.pstate, args, draws)
    for i, (g, e) in enumerate(zip(graphed, eager)):
        assert _same(g, e), f"step {i}"
    taken = {k for k, v in eng.step_routes.items() if v}
    assert eng.step_routes["warm_up"] == 1
    assert taken - {"warm_up"} == routes, eng.step_routes
    entry = next(iter(eng._graphs.values()))
    assert bool(entry.backs) == ("graph" in routes)
    tiers = {(o[5]["tier_like"], o[5]["tier_beam"]) for o in eager}
    if name == "trilinear-1024":
        assert tiers == {(2, 0)}, tiers
    else:
        assert all(t[0] != 0 for t in tiers), tiers
