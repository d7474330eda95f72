"""Run one cell of the benchmark once:

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``workloads/<cell>.json``) names its configuration, its driver
and its traffic. The run makes its inputs and weights from ``--seed``,
sets up and warms up the program, measures for ``--seconds``, checks what
the timed path produced against the plain reference, and prints one JSON
line as the last line of its standard output. Without a card it fails.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# every build and kernel cache at a fixed directory inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(REPO, "build", "bench_port", sub)
sys.path.insert(0, REPO)

from bench_port import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
