"""Hand-written CUDA kernels for Hopper (``csrc/``), their build, their
plain PyTorch versions (:mod:`.ref`) and the wrappers (:mod:`.ops`)."""
