"""The fleet and the splits over ``torch.distributed``: the port of
``mcl_3dl_tpu/parallel``.

Ranks of the default process group form a ``("robots", "particles")``
mesh.  ``sharded_filter_step`` splits one robot's particles (the models
on each rank's slice, the filter's boundaries through ``all_reduce`` and
``all_gather``); ``fleet_filter_step_grouped`` runs each rank's robots in
turn through the single-robot step with the grouped kernels;
``fleet_filter_step`` batches the fleet with ``torch.func.vmap`` over the
host-read-free ``spmd_safe`` step.  The map is replicated.
"""

from mcl_3dl_tpu_torch.parallel.sharding import (
    LocalState,
    Mesh,
    fleet_filter_step,
    fleet_filter_step_grouped,
    make_mesh,
    robots_slice,
    shard_state,
    sharded_filter_step,
)

__all__ = [
    "make_mesh",
    "shard_state",
    "sharded_filter_step",
    "fleet_filter_step",
    "fleet_filter_step_grouped",
    "robots_slice",
    "Mesh",
    "LocalState",
]
