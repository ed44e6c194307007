from .mesh import Mesh, init_distributed, make_mesh, shard_rows  # noqa: F401
