"""The plain reference of DLRM-DCNv2 for the port's tests.

It is kept with the benchmark, ``bench_port/reference/dlrm.py``, so that
the benchmark's own checkout holds the reference its ``correct`` compares
with; this module names it for the tests. Both are plain PyTorch in fp32
(TF32 off): they import no JAX, nothing of ``recsys_tpu`` and no kernel of
the port. Its docstring lists the equations and each departure from the
source.
"""

from bench_port.reference.dlrm import (  # noqa: F401
    adagrad_steps, bags, bce_sum, change_norms, cross, dense_leaves, follow_steps, logits, loss_and_grads,
    mm, slot_norms, table_leaf_names)
