"""Multi-device in ``torch.distributed``: the (data, model) mesh and tensor
parallelism (``lac_tpu``'s exports of ``lac_tpu/parallel/__init__.py``
but ``param_shardings``, a GSPMD placement that is JAX-only:
``shard.py``'s docstring)."""

from .mesh import make_mesh, mesh_geometry  # noqa: F401
from .shard import lane_share, shard_params  # noqa: F401
