"""The plain reference of MLA-MoE for the port's tests.

It is kept with the benchmark, ``bench_port/reference/mla_moe.py``, so that
the benchmark's own checkout holds the reference its ``correct`` compares
with; this module names it for the tests. Both are plain PyTorch in fp32
(TF32 off): they import no JAX, nothing of ``recsys_tpu`` and no kernel of
the port. Its docstring lists the equations and each departure from the
source.
"""

from bench_port.reference.mla_moe import (  # noqa: F401
    TIE, _moe, adam_steps, choices_fault, follow_steps, group_loss_sum, loss_and_grads,
    negatives_fault, reference_choices, rope_tables, tau)
