from repro_torch.sharding.context import (batch_axes, constrain, mesh_context,
                                          current_mesh)
from repro_torch.sharding import rules

__all__ = ["batch_axes", "constrain", "mesh_context", "current_mesh", "rules"]
