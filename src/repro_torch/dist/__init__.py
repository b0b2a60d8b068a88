"""repro_torch.dist — the mesh, sharding rules, the placement of parameters
on a mesh, and gradient compression (port of repro.dist)."""
from .compress import ef_compress_update  # noqa: F401
from .sharding import (  # noqa: F401
    Mesh, MeshContext, MeshSpec, Placed, ShardingPolicy, gather, gather_tree,
    is_placed, param_specs, partwise, place_model_params, place_params,
    placement_policy, position_bytes, replica_devices, roots, sum_copies,
    unplace, with_roots,
)
