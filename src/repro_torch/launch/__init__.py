"""Launch helpers of the port: the logical device mesh
(:func:`repro_torch.launch.mesh.make_mesh`), the serving driver
(``python -m repro_torch.launch.serve``) and the training driver
(``python -m repro_torch.launch.train``)."""
from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
