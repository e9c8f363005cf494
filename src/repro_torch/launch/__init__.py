"""Launch helpers of the port: the logical device mesh
(:func:`repro_torch.launch.mesh.make_mesh`) and the serving driver
(``python -m repro_torch.launch.serve``)."""
from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
