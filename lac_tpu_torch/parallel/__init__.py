from .mesh import make_mesh, mesh_geometry  # noqa: F401
from .shard import lane_share, shard_params  # noqa: F401
