"""Training layer: the single-GPU trainer, the optimizers, checkpoints,
the inference-bundle I/O and the weight bridge between the packages."""
