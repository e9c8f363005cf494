"""Launch helpers of the port: device meshes, of ranks
(:func:`repro_torch.launch.mesh.make_rank_mesh`, ``make_host_mesh``,
``make_production_mesh``) or of logical shards on one device
(:func:`repro_torch.launch.mesh.make_mesh`), the serving driver
(``python -m repro_torch.launch.serve``) and the training driver
(``python -m repro_torch.launch.train``)."""
from .mesh import (Mesh, make_host_mesh, make_mesh, make_production_mesh,
                   make_rank_mesh)

__all__ = ["Mesh", "make_mesh", "make_rank_mesh", "make_host_mesh",
           "make_production_mesh"]
