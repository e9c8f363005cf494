"""Launch helpers of the port: device meshes, of ranks
(:func:`repro_torch.launch.mesh.make_rank_mesh`, ``make_host_mesh``,
``make_production_mesh``) or of logical shards on one device
(:func:`repro_torch.launch.mesh.make_mesh`), the serving driver
(``python -m repro_torch.launch.serve``), training
(``python -m repro_torch.launch.train``), and the tools that size a
production mesh without a card: a rank's step bundles
(:mod:`repro_torch.launch.steps`), the dry-run on fake ranks
(``python -m repro_torch.launch.dryrun``), its roofline
(``python -m repro_torch.launch.roofline``) and the MSTG serving step's
(``python -m repro_torch.launch.dryrun_mstg``)."""
from .mesh import (Mesh, make_host_mesh, make_mesh, make_production_mesh,
                   make_rank_mesh)

__all__ = ["Mesh", "make_mesh", "make_rank_mesh", "make_host_mesh",
           "make_production_mesh"]
