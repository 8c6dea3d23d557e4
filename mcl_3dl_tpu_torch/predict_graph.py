"""The odometry prediction and the IMU weigh replayed from CUDA graphs: the
port's counterpart of the JAX engine's ``_predict_jit`` and ``_imu_jit``
(mcl_3dl_tpu/engine.py:175-182).

Each chain (``Chain``) works over the particle axis and reads nothing on
the host: ``ODOMETRY`` is ``predict_differential_drive``
(``MCL3DL.odometry``), ``IMU`` is ``imu_gravity_likelihood`` followed by
``pf.measure`` (``MCL3DL.imu``).  What the engine computes on the host
stays there, in the same f32 bits: the delta of ``OdomDelta.from_poses``
and the low-passed acceleration over its norm.  Those host tensors are
the chain's inputs.

On a CUDA device (``graphable``) the engine keeps one ``ChainGraph`` a
key (``key``: the chain, the capacity, the device and the parameters
baked into the chain; never the map or the particles' values) in
``_predict_graphs``.  The first call at a key runs eagerly (the warm-up:
device constants made, ``math.device_constant``); the second captures
the graph and every call from then on replays it:

* the state's leaves the chain reads are copied into the graph's static
  buffers, one batched copy a dtype (``batched_copy``);
* the host inputs are packed into one fresh pinned f32 vector and copied
  without blocking into one static device buffer (``stage``); the graph
  reads them as views of it (``unpack``);
* the graph replays, and the fields it writes are copied out of its
  buffers (one batched copy) before the next replay.

A key's graph lives as long as the engine: ``drop_step_graphs`` keeps
them, since a re-seed, ``global_localization`` or the decay's resize
replace only the state's values and the capacity is in the key.
Everywhere else (the CPU) every call is eager, the code it always ran:
the inputs moved to the device one by one, then the chain.

Every call adds one to the engine's ``predict_routes`` under its route
(``ROUTES``) and records the counter ``predict.<route>`` inside the
engine's span of the call (``odometry.predict`` or ``imu.weigh``).  A
capture is the span ``odometry.capture`` or ``imu.capture``, with the
counters ``graph.alloc_retries`` and ``graph.reserved_bytes`` of the
step's captures (``step_graph.allocator_deltas``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from mcl_3dl_tpu_torch import pf
from mcl_3dl_tpu_torch import step_graph
from mcl_3dl_tpu_torch.models.imu_gravity import imu_gravity_likelihood
from mcl_3dl_tpu_torch.models.motion import (OdomDelta,
                                             predict_differential_drive)
from mcl_3dl_tpu_torch.profiling import spans
from mcl_3dl_tpu_torch.state import ParticleState

# "graph": replayed (captured first, at a key's second call); "warm_up":
# a key's first call, eager; "eager": not graphable
ROUTES = ("graph", "warm_up", "eager")


class Chain(NamedTuple):
    """A chain: its name (the spans' prefix), the state's fields it reads
    and writes, and ``fn(state, *inputs, *params)``, the new state."""

    name: str
    reads: tuple
    writes: tuple
    fn: Callable


def _predict(state, translation, rotation, angle, norm, dt, lin_tc, ang_tc):
    return predict_differential_drive(
        state, OdomDelta(translation, rotation, angle, norm, dt), lin_tc,
        ang_tc)


def _weigh(state, acc_measure, acc_var):
    lik = imu_gravity_likelihood(state.rot, acc_measure, acc_var)
    return pf.measure(state, lik)[0]


ODOMETRY = Chain("odometry", ("pos", "rot", "odom_err_lin", "odom_err_ang",
                              "noise"),
                 ("pos", "rot", "odom_err_lin", "odom_err_ang"), _predict)
IMU = Chain("imu", ("rot", "prob", "n_active"), ("prob",), _weigh)


def graphable(device) -> bool:
    """Whether the chains replay from graphs: on a CUDA device
    (``step_graph.enabled``).  The engine runs them on its whole state,
    never on a slice of a particle split."""
    return step_graph.enabled(device)


def key(chain: Chain, state: ParticleState, params: tuple) -> tuple:
    """What a chain's graph depends on: the chain, the capacity, the
    device and the parameters baked into it."""
    return (chain.name, state.capacity, str(state.device)) + tuple(
        float(x) for x in params)


def batched_copy(dst, src) -> None:
    """``d.copy_(s)`` for every pair: one ``torch._foreach_copy_`` a
    dtype (a batched copy on the card), a lone pair a plain copy."""
    groups: dict = {}
    for d, s in zip(dst, src, strict=True):
        ds, ss = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        if len(ds) == 1:
            ds[0].copy_(ss[0])
        else:
            torch._foreach_copy_(ds, ss)


def stage(inputs, device) -> torch.Tensor:
    """The host tensors ``inputs`` flattened into one f32 vector, pinned
    where ``device`` is a CUDA device so that its copy does not block: a
    fresh one each call (the host allocator keeps it until a queued copy
    has read it)."""
    n = sum(x.numel() for x in inputs)
    out = torch.empty((n,), dtype=torch.float32,
                      pin_memory=torch.device(device).type == "cuda")
    torch.cat([x.reshape(-1) for x in inputs], out=out)
    return out


def unpack(buf, like) -> list:
    """Views of the vector ``buf`` shaped as the tensors ``like``, in
    order."""
    out, at = [], 0
    for x in like:
        out.append(buf[at:at + x.numel()].view(x.shape))
        at += x.numel()
    return out


class ChainGraph:
    """One key's graph: the static buffers (the state's leaves the chain
    reads and the packed host inputs), the graph and its outputs."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = step_graph.new_pool(device)
        self.leaves = self.values = None
        self.graph = self.out = None

    def load(self, leaves, staged) -> None:
        """Copy this call's leaves and staged inputs into the static
        buffers (made on first use)."""
        if self.leaves is None:
            self.leaves = [torch.empty_like(
                t, memory_format=torch.contiguous_format) for t in leaves]
            self.values = torch.empty(staged.shape, dtype=staged.dtype,
                                      device=self.device)
        batched_copy(self.leaves, leaves)
        self.values.copy_(staged, non_blocking=True)

    def replay(self, fn, name) -> list:
        """Replay the graph (captured from ``fn`` first, span
        ``<name>.capture``); its outputs copied out of its buffers."""
        if self.graph is None:
            with spans.span(name + ".capture"), step_graph.allocator_deltas(
                    self.device):
                self.graph, self.out = step_graph.capture(fn, self.pool)
        self.graph.replay()
        out = [torch.empty_like(t) for t in self.out]
        batched_copy(out, self.out)
        return out


def _static_state(chain: Chain, entry: ChainGraph,
                  state: ParticleState) -> ParticleState:
    """The state a capture reads: the static buffers for the fields the
    chain reads, zero-stride zeros of their shape for the others (read
    for their shape and device only: ``capacity``, ``device``)."""
    leaves = dict(zip(chain.reads, entry.leaves))
    return ParticleState(**{
        f: leaves[f] if f in leaves else torch.zeros(
            (), dtype=x.dtype, device=entry.device).expand(x.shape)
        for f, x in zip(ParticleState._fields, state)})


def run(engine, chain: Chain, state: ParticleState, inputs, params=()):
    """``chain.fn(state, *inputs, *params)`` with ``inputs`` host tensors;
    from the engine's graph at the chain's ``key`` where ``graphable``
    (module docstring)."""
    dev = state.device
    route = "eager"
    if graphable(dev):
        k = key(chain, state, params)
        entry = engine._predict_graphs.get(k)
        if entry is None:
            engine._predict_graphs[k] = ChainGraph(dev)
            route = "warm_up"
        else:
            route = "graph"
    engine.predict_routes[route] += 1
    spans.count("predict." + route)
    if route != "graph":
        return chain.fn(state, *(x.to(dev) for x in inputs), *params)
    entry.load([getattr(state, f) for f in chain.reads], stage(inputs, dev))

    def graphed():
        new = chain.fn(_static_state(chain, entry, state),
                       *unpack(entry.values, inputs), *params)
        return [getattr(new, f) for f in chain.writes]

    out = entry.replay(graphed, chain.name)
    return state._replace(**dict(zip(chain.writes, out)))
