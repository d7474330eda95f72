"""The plain reference of HSTU for the port's tests.

It is kept with the benchmark, ``bench_port/reference/hstu.py``, so that
the benchmark's own checkout holds the reference its ``correct`` compares
with; this module names it for the tests. Both are plain PyTorch in fp32
(TF32 off): they import no JAX, nothing of ``recsys_tpu`` and no kernel of
the port. Its docstring lists the equations and each departure from the
source.
"""

from bench_port.reference.hstu import (  # noqa: F401
    adam_steps, attention, bucket, change_norms, clone_params, follow_steps, group_loss_sum,
    leaves, loss_and_grads, program_readings)
