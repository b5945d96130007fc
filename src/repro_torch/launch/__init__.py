"""Launch helpers: the device meshes of the sharded Mode A drivers."""
from repro_torch.launch.mesh import (
    Mesh, make_lane_mesh, make_worker_mesh, n_workers, worker_axes,
)

__all__ = ["Mesh", "make_lane_mesh", "make_worker_mesh", "n_workers",
           "worker_axes"]
