"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions (:mod:`.ref`) and their dispatch (:mod:`.ops`)."""
