"""repro_torch.dist — the mesh and sharding rules and gradient compression
(port of repro.dist)."""
from .compress import ef_compress_update  # noqa: F401
from .sharding import (  # noqa: F401
    Mesh, MeshContext, MeshSpec, ShardingPolicy, param_specs,
)
