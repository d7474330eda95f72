"""The PyTorch port stands alone: importing every module of
``recsys_tpu_torch`` (and ``chip_smoke.py``) loads neither ``jax``, nor any
module of ``recsys_tpu``, nor ``pandas`` (absent on the card's machine). Each check runs in a fresh interpreter, since
this test process has both packages loaded."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, runpy, sys
import recsys_tpu_torch
names = ["recsys_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(recsys_tpu_torch.__path__, "recsys_tpu_torch.")
]
assert {"recsys_tpu_torch.evaluate", "recsys_tpu_torch.ops.topk",
        "recsys_tpu_torch.data.preprocessing", "recsys_tpu_torch.serve.export",
        "recsys_tpu_torch.preprocess", "recsys_tpu_torch.data.pipeline",
        "recsys_tpu_torch.data.negative_sampling", "recsys_tpu_torch.serve.batcher",
        "recsys_tpu_torch.serve.aio", "recsys_tpu_torch.utils.native",
        "recsys_tpu_torch.parallel", "recsys_tpu_torch.parallel.mesh",
        "recsys_tpu_torch.parallel.collectives",
        "recsys_tpu_torch.parallel.sharding", "recsys_tpu_torch.embed",
        "recsys_tpu_torch.embed.table", "recsys_tpu_torch.train.dryrun"} <= set(names)
for name in names:
    importlib.import_module(name)
runpy.run_path("chip_smoke.py", run_name="chip_smoke_import_only")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "recsys_tpu" or m.startswith("recsys_tpu.")
             or m == "pandas" or m.startswith("pandas."))
print(len(names), "modules")
assert not bad, bad
"""


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


def test_port_imports_no_jax_and_no_recsys_tpu():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 47  # every package and module of the port


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA (as here), and in a directory holding chip_smoke.py
    alone, the script exits non-zero and prints no result line."""
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (REPO, str(lone)):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0, out.stdout
        assert '"ok"' not in out.stdout
