"""repro_torch.dist — the mesh, sharding rules, the placement of parameters
on a mesh, the model axis's tensor- and sequence-parallel collectives
(`tp`), and gradient compression (port of repro.dist)."""
from . import tp  # noqa: F401
from .compress import ef_compress_update  # noqa: F401
from .sharding import (  # noqa: F401
    Mesh, MeshContext, MeshSpec, Placed, ShardingPolicy, gather, gather_tree,
    is_placed, param_specs, partwise, place_model_params, place_params,
    placement_policy, position_bytes, replica_devices, roots, sum_copies,
    unplace, with_roots,
)
from .tp import (  # noqa: F401
    TPGroup, add_all, all_gather, all_max, all_reduce, all_to_all, reduce_scatter,
    replica_groups, send,
)
