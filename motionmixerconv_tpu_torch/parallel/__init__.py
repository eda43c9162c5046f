from .mesh import (DataMesh, batch_sharding, launch, make_mesh,
                   replicated_sharding)

__all__ = ["DataMesh", "make_mesh", "batch_sharding", "replicated_sharding",
           "launch"]
