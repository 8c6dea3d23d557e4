"""The measurement step replayed from CUDA graphs: the port's
counterpart of the JAX engine's ``self._step = jax.jit(
self._measurement_step)`` (mcl_3dl_tpu/engine.py:168).

``run`` has ``MCL3DL._measurement_step``'s signature and outputs.  On a
CUDA device, for a step it can graph (``graphable``: not global mode, not
batched or split, the uniform sampler), it keeps one ``StepGraph`` a key
(``step_key``: what JAX's jit re-traces on — capacity, cloud bucket,
number of origins, both models' slot counts, whether the beam runs, the
thresholds and the map) in the engine's ``_graphs``.  A step is split at
its one host read, the ``fits`` flags (the ``lax.cond`` of the JAX step):

* graph A, ``MCL3DL._step_front``: clip, sampling, the grouping's
  statistics, boxes and flags;
* one graph B a ``fits`` outcome (the tuple read; ``()`` where the step
  has no grouping), ``MCL3DL._step_back`` on it: the layout, both models
  at the outcome's tiers, the weight update and the filter's tail.

A B is kept only for an outcome whose remainder reads nothing on the host
(``back_graphable``): the likelihood at tier 0, or not eligible for the
box path (``likelihood.box_path``: trilinear sampling, a capacity of no
whole 128-slot rows), whose tier-1 check reads flags; the beam at any
tier (K2 and M1 at tier 0, M2 or M3 at tier 2, all kernels).  So the
steady step at tiers 0/0, the trilinear step (M4 with K2, or with M2),
the small-count step without grouping (M4 + M2) and the DDA step (M3)
replay whole; a remainder that may reach the box check (nearest sampling
when tier 0 does not fit at a capacity of whole 128-slot rows) runs
eagerly on A's outputs.

The first step at a key runs eagerly (the warm-up: kernels built, device
constants made, ``math.device_constant``); later steps copy their inputs
into the graphs' static buffers, replay A, read the flags, and replay the
outcome's B, captured at the first step with that outcome after one eager
remainder with it (its own warm-up).  All graphs of a key share one
memory pool, and a step's outputs are copied out of the graphs' buffers
before the next replay.  The draws are made eagerly by the engine's
generator before A replays (the same calls the eager step makes), so a
graphed and an eager step on the same draws see the same bits.  A capture
error raises (a host read inside a capture among them); nothing falls
back to the eager step on the card.

The kernels' wrappers do not run on a replay, so each capture records how
many times each counted kernel (``KERNELS``) launched inside it and every
replay adds that to the wrappers' counts; a capture itself counts none.
Every step adds one to the engine's ``step_routes`` under its route
(``ROUTES``).

Spans (``profiling.spans``), inside the engine's ``step`` span around
``run``: ``step.eager`` (route ``eager``), ``step.warm_up``
(``warm_up``), or ``step.draws``, ``step.load`` (the copy into the
static buffers), ``step.replay_a`` (with ``step.capture_a`` at a key's
first replay), ``read.fits``, then ``step.replay_b`` (with
``step.capture_b``) or ``step.remainder`` (the eager B of
``graph_front``), and ``step.copy_out``.  A capture also counts the
caching allocator's retries and reserved bytes added across it.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from mcl_3dl_tpu_torch.map.distance_field import sample_field
from mcl_3dl_tpu_torch.models.beam import march_dda, march_fixed, march_sphere
from mcl_3dl_tpu_torch.models.likelihood import box_path
from mcl_3dl_tpu_torch.ops import grouped as og
from mcl_3dl_tpu_torch.ops import local_gather as olg
from mcl_3dl_tpu_torch.profiling import spans

# the launch-counted kernel wrappers: K1, K2, K3, M1-M5
KERNELS = (og.grouped_like_score, og.grouped_beam_pen, olg.local_score,
           march_fixed, march_sphere, march_dda, sample_field, og.group_stats)
# "graph": A and a B replayed; "graph_front": A replayed, the rest eager;
# "warm_up": the first step at a key, eager; "eager": not graphable
ROUTES = ("graph", "graph_front", "warm_up", "eager")


class StepInputs(NamedTuple):
    """Everything a graphed step reads besides the map: the graphs' static
    buffers, or one step's values to copy into them."""

    state: tuple
    cloud: torch.Tensor
    cloud_label: torch.Tensor
    cloud_valid: torch.Tensor
    origins: torch.Tensor
    odom_pos: torch.Tensor
    odom_rot: torch.Tensor
    prev_pos: torch.Tensor
    prev_rot: torch.Tensor
    f_pos: tuple
    f_ang: tuple
    fix: torch.Tensor
    draws: tuple


def enabled(device) -> bool:
    """Graphs run on a CUDA device only."""
    return torch.device(device).type == "cuda"


def capture(fn, pool):
    """``(graph, outputs)``: ``fn()`` captured into a CUDA graph whose
    allocations come from ``pool``.  A capture error raises."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    return graph, out


def new_pool(device):
    return torch.cuda.graph_pool_handle() if enabled(device) else None


def graphable(engine, *, global_mode=False, normals=None, spmd_safe=False,
              shard=None) -> bool:
    """Whether ``run`` graphs this step: not global mode (JAX keeps a
    ``_step_global`` of its own), not ``spmd_safe`` or split, and the
    uniform sampler (the normal-weighted one's ``eigh`` waits for the
    card)."""
    return not (global_mode or spmd_safe or shard is not None
                or normals is not None
                or engine.params.use_random_sampler_with_normal)


def back_graphable(engine, state, df, front, fits) -> bool:
    """Whether the remainder after the read of ``fits`` (``front``'s
    flags) reads nothing on the host, so that a graph B may hold it: the
    likelihood at tier 0 (its flag, first where it shares the grouping,
    true) or not eligible for the box path (``likelihood.box_path``, the
    rule ``likelihood_measure`` takes).  The beam reads nothing at any
    tier on the card: K2 and M1 at tier 0, M2 or M3 at tier 2."""
    group = front.group
    if group is not None and group.share_like and fits[0]:
        return True
    p = engine.params
    return not box_path(state.capacity, df.trunc, p.likelihood.match_dist_min,
                        trilinear=p.likelihood.interp != "nearest")


def step_key(state, cloud, origins, draws, use_beam, std_warn_thresh, df,
             df_beam) -> tuple:
    """The graphs' key: capacity, cloud bucket, number of origins, both
    models' slots, whether the beam runs, the thresholds (baked into B)
    and the maps (their tensors are read in place)."""
    return (state.capacity, cloud.shape[0], origins.shape[0],
            draws.like_idx.shape[0], draws.beam_idx.shape[0], bool(use_beam),
            tuple(float(x) for x in std_warn_thresh), id(df), id(df_beam))


def leaves(x):
    """The tensors of ``x`` (tensors, tuples, lists, dicts and objects'
    attributes, in order), ``None`` and Python values skipped."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from leaves(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from leaves(v)
    elif hasattr(x, "__dict__") and not isinstance(x, type):
        for v in vars(x).values():
            yield from leaves(v)


def tree_map(fn, x):
    """``x`` with ``fn`` applied to each tensor of its tuples (named ones
    kept) and dicts; other values as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        vals = [tree_map(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    return x


def copy_into(dst, src) -> None:
    """Copy every tensor of ``src`` into the same place in ``dst``."""
    for d, s in zip(leaves(dst), leaves(src), strict=True):
        d.copy_(s)


def launch_counts():
    return [k.launches for k in KERNELS]


class StepGraph:
    """One key's graphs: the static inputs, graph A and its outputs (a
    ``StepFront``), the launches it holds, one ``BackGraph`` a ``fits``
    outcome, and the outcomes whose eager remainder has run at this key
    (their warm-ups)."""

    def __init__(self, df, df_beam, device):
        self.maps = (df, df_beam)      # kept: the graphs read their tensors
        self.device = torch.device(device)
        self.pool = new_pool(device)
        self.inputs: Optional[StepInputs] = None
        self.graph_a = self.front = self.launches_a = None
        self.backs: dict = {}
        self.warm: set = set()

    def load(self, inputs: StepInputs) -> StepInputs:
        """Copy this step's inputs into the static buffers (made on first
        use); returns the buffers."""
        if self.inputs is None:
            self.inputs = tree_map(lambda t: torch.empty_like(
                t, memory_format=torch.contiguous_format), inputs)
        copy_into(self.inputs, inputs)
        return self.inputs

    def _capture(self, fn, name):
        before = launch_counts()
        with spans.span(name), allocator_deltas(self.device):
            graph, out = capture(fn, self.pool)
        held = [a - b for a, b in zip(launch_counts(), before)]
        for k, n in zip(KERNELS, before):
            k.launches = n             # a capture launches nothing
        return graph, out, held

    @staticmethod
    def _replay(graph, held):
        graph.replay()
        for k, n in zip(KERNELS, held):
            k.launches += n

    def replay_front(self, fn):
        if self.graph_a is None:
            self.graph_a, self.front, self.launches_a = self._capture(
                fn, "step.capture_a")
        self._replay(self.graph_a, self.launches_a)
        return self.front

    def replay_back(self, outcome, fn):
        """The outcome's B outputs, in the graph's buffers (the next
        replay overwrites them)."""
        back = self.backs.get(outcome)
        if back is None:
            back = self.backs[outcome] = BackGraph(
                *self._capture(fn, "step.capture_b"))
        self._replay(back.graph, back.launches)
        return back.out


class BackGraph(NamedTuple):
    """A graph B: the graph, its outputs and the launches it holds."""

    graph: object
    out: tuple
    launches: list


@contextlib.contextmanager
def allocator_deltas(device):
    """Counters ``graph.alloc_retries`` and ``graph.reserved_bytes``: what
    the caching allocator's ``num_alloc_retries`` and reserved bytes
    gained across the block, on a CUDA device while the tracer is on."""
    if not (spans.enabled and device.type == "cuda"):
        yield
        return

    def read():
        m = torch.cuda.memory_stats()
        return (m.get("num_alloc_retries", 0),
                m.get("reserved_bytes.all.current", 0))

    before = read()
    yield
    after = read()
    spans.count("graph.alloc_retries", after[0] - before[0])
    spans.count("graph.reserved_bytes", after[1] - before[1])


def _device_bool(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor) and x.device == torch.device(device):
        return x
    return torch.full((), bool(x), dtype=torch.bool, device=device)


def run(engine, state, df, df_beam, cloud, cloud_label, cloud_valid,
        origins, odom_pos, odom_rot, prev_pos, prev_rot, f_pos, f_ang,
        is_global_fix, std_warn_thresh, draws=None, *, global_mode=False,
        global_slots=None, occ=None, normals=None, spmd_safe=False,
        shard=None):
    """``engine._measurement_step`` on these arguments, from the engine's
    graphs where ``enabled`` and ``graphable`` (module docstring)."""
    routes = engine.step_routes
    if not (enabled(state.device) and graphable(
            engine, global_mode=global_mode, normals=normals,
            spmd_safe=spmd_safe, shard=shard)):
        routes["eager"] += 1
        with spans.span("step.eager"):
            return engine._measurement_step(
                state, df, df_beam, cloud, cloud_label, cloud_valid, origins,
                odom_pos, odom_rot, prev_pos, prev_rot, f_pos, f_ang,
                is_global_fix, std_warn_thresh, draws,
                global_mode=global_mode, global_slots=global_slots, occ=occ,
                normals=normals, spmd_safe=spmd_safe, shard=shard)
    if draws is None:
        with spans.span("step.draws"):
            draws = engine.draw_step(*engine.keeps(cloud, cloud_valid))
    use_beam = engine.slots()[2]
    key = step_key(state, cloud, origins, draws, use_beam, std_warn_thresh,
                   df, df_beam)
    given = StepInputs(state, cloud, cloud_label, cloud_valid, origins,
                       odom_pos, odom_rot, prev_pos, prev_rot, f_pos, f_ang,
                       _device_bool(is_global_fix, state.device), draws)

    def front(x: StepInputs):
        return engine._step_front(x.state, df, df_beam, x.cloud,
                                  x.cloud_label, x.cloud_valid, x.origins,
                                  x.draws)

    def back(fr, fits, x: StepInputs):
        return engine._step_back(fr, fits, x.state, df, df_beam, x.origins,
                                 x.odom_pos, x.odom_rot, x.prev_pos,
                                 x.prev_rot, x.f_pos, x.f_ang, x.fix,
                                 std_warn_thresh)

    entry = engine._graphs.get(key)
    if entry is None:
        with spans.span("step.warm_up"):
            entry = engine._graphs[key] = StepGraph(df, df_beam,
                                                    state.device)
            fr = front(given)
            fits = fr.fits()
            if back_graphable(engine, state, df, fr, fits):
                entry.warm.add(tuple(fits))
            routes["warm_up"] += 1
            return back(fr, fits, given)

    with spans.span("step.load"):
        static = entry.load(given)
    with spans.span("step.replay_a"):
        fr = entry.replay_front(lambda: front(static))
    fits = fr.fits()
    outcome = tuple(fits)
    if back_graphable(engine, state, df, fr, fits):
        if outcome in entry.warm:
            routes["graph"] += 1
            with spans.span("step.replay_b"):
                out = entry.replay_back(outcome,
                                        lambda: back(fr, fits, static))
            with spans.span("step.copy_out"):
                return tree_map(torch.clone, out)
        entry.warm.add(outcome)
    routes["graph_front"] += 1
    with spans.span("step.remainder"):
        out = back(fr, fits, given)
    # copied: some outputs (``aux["points_not_found"]``) are graph A's
    with spans.span("step.copy_out"):
        return tree_map(torch.clone, out)
