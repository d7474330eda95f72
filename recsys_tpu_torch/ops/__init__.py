"""Hot-op kernels: hand-written CUDA kernels for Hopper (``csrc/``), each
beside its plain PyTorch version. A wrapper takes the plain version only
for tensors on the CPU; for CUDA tensors it launches its kernel or
raises."""
