"""PyTorch/CUDA port of the MSTG range-filtered ANN system.

A second package beside the JAX reference (``repro``): it builds or loads an
MSTG index, stages it on a CUDA device and answers float32 RR-filtered k-NN
requests through :class:`repro_torch.core.QueryEngine` on the graph, pruned
and flat routes. Index construction, the Theorem 4.1 planner, the predicate
algebra and the artifact I/O are host NumPy, kept as this package's own
copies; the device code is PyTorch, and the three kernels of the graph and
flat routes are hand-written CUDA (:mod:`repro_torch.kernels`). Beside the
index it carries the paper's comparison methods
(:mod:`repro_torch.core.baselines`) and the reference's dense LM serving
path (:mod:`repro_torch.configs`, :mod:`repro_torch.models`,
:class:`repro_torch.serving.ServeEngine`, :mod:`repro_torch.launch.serve`).

This package never imports ``jax`` or ``repro``.
"""
