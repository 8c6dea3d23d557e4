"""Checkpoint / resume of the port's engine.

The reference has none (state is lost on restart).  ``save_checkpoint``
writes the whole filter state to one npz: particles and weights, the
smoothing filters, odometry/IMU bookkeeping, and the engine's random
stream, the state of its ``torch.Generator`` (on the card the CUDA
generator's).  ``load_checkpoint`` restores it into an engine with the
map already loaded, which then continues bit for bit as the saved one
would have.

The file layout is the JAX package's (``mcl_3dl_tpu/checkpoint.py``,
format 1: the same array names and meta), with the generator state in
place of the JAX key and the device type in the meta.  A port file loads
only onto a device of the type it was saved from: a generator state
does not carry across device types, so anything else raises.  A JAX
file loads its particles, filters and bookkeeping (through
``convert.py``) but not its random stream, which the engine keeps:
``jax.random`` and torch draw different streams.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from mcl_3dl_tpu_torch import convert

FORMAT_VERSION = 1
PARTICLE_FIELDS = 8     # ParticleState: pos, rot, odom_err_lin/ang, noise,
                        # prob, prob_bias, n_active
FILTERS = ("f_pos", "f_ang", "f_acc", "localize_rate")
HOST_ARRAYS = ("odom_pos", "odom_rot", "odom_prev_pos", "odom_prev_rot",
               "imu_quat")
META_KEYS = ("has_odom", "has_imu", "odom_last", "imu_last",
             "tf_tolerance_base", "localized_last",
             "global_localization_fix_cnt", "cnt_measure")


def save_checkpoint(engine, path) -> None:
    """Write ``engine``'s filter state and random stream to ``path``."""
    arrays = {}

    def put(prefix, tup):
        for i, leaf in enumerate(tup):
            arrays[f"{prefix}.{i}"] = leaf.detach().cpu().numpy()

    put("pstate", engine.pstate)
    for name in FILTERS:
        put(name, getattr(engine, name))
    arrays["generator_state"] = engine._gen.get_state().numpy()
    arrays["state_prev_pos"] = engine.state_prev_pos.cpu().numpy()
    arrays["state_prev_rot"] = engine.state_prev_rot.cpu().numpy()
    for name in HOST_ARRAYS:
        arrays[name] = np.asarray(getattr(engine, name))
    meta = {k: getattr(engine, k) for k in META_KEYS}
    meta.update(version=FORMAT_VERSION, tf_seeded=engine._tf_seeded,
                device=engine.device.type)
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_checkpoint(engine, path) -> None:
    """Restore the state in ``path`` (a port or a JAX package checkpoint)
    into ``engine``."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} unsupported")
    ported = "generator_state" in data
    if ported and meta["device"] != engine.device.type:
        raise ValueError(
            f"checkpoint of a {meta['device']} engine: its random stream "
            f"does not load into a {engine.device.type} engine")
    dev = engine.device
    engine.drop_step_graphs()

    def get(prefix, n):
        return [data[f"{prefix}.{i}"] for i in range(n)]

    engine.pstate = convert.particle_state(*get("pstate", PARTICLE_FIELDS),
                                           device=dev)
    for name in FILTERS:
        # f_pos and f_ang live on the engine's device, f_acc and
        # localize_rate on the host
        where = getattr(engine, name).x.device
        setattr(engine, name, convert.filter_state(*get(name, 4),
                                                   device=where))
    f = dict(dtype=torch.float32, device=dev)
    engine.state_prev_pos = torch.as_tensor(data["state_prev_pos"], **f)
    engine.state_prev_rot = torch.as_tensor(data["state_prev_rot"], **f)
    for name in HOST_ARRAYS:
        setattr(engine, name, np.asarray(data[name], np.float32))
    for k in META_KEYS:
        setattr(engine, k, meta[k])
    engine._n_active_host = int(engine.pstate.n_active)
    # a file saved before the first measurement restores with the
    # first-measurement TF seed still pending; files without the flag
    # predate it and had seeded
    engine._tf_seeded = bool(meta.get("tf_seeded", True))
    if ported:
        engine._gen.set_state(torch.as_tensor(data["generator_state"]))
