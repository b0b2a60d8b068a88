"""repro_torch.dist — the mesh and sharding rules (port of repro.dist)."""
from .sharding import (  # noqa: F401
    Mesh, MeshContext, MeshSpec, ShardingPolicy, param_specs,
)
