"""Launch helpers: the device meshes of the sharded drivers, the sharding
rules of the model zoo's GSPMD path and of Mode B (``launch.sharding``),
Mode B's step builders (``launch.steps``) and its training CLI
(``python -m repro_torch.launch.train``)."""
from repro_torch.launch.mesh import (
    Mesh, make_lane_mesh, make_production_mesh, make_test_mesh,
    make_worker_mesh, n_workers, worker_axes, worker_iota, worker_spec,
)

__all__ = ["Mesh", "make_lane_mesh", "make_production_mesh", "make_test_mesh",
           "make_worker_mesh", "n_workers", "worker_axes", "worker_iota",
           "worker_spec"]
