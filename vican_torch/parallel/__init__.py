"""Multi-card parallelism over ``torch.distributed``: the sharded solver
paths and the process-group mesh they run on."""

from .mesh import EDGE_AXIS, global_mesh, init_distributed, make_mesh  # noqa: F401
from .sharded import pad_to_multiple, se3sync_sharded, so3_sync_sharded  # noqa: F401
