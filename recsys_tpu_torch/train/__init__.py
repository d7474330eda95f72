"""Training layer. So far only the inference-bundle I/O and the weight
bridge (``checkpoint``); the trainer is the next slice of the port."""
