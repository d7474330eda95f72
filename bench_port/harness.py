"""The harness: finds a cell's files by name, checks for the card, runs
the cell's driver, reads the per-layer metrics and prints the result.

A cell, a configuration, a driver and a per-layer metric are each a file
of their own (``workloads/<cell>.json``, ``configs/<config>.json``,
``drivers/<driver>.py``, ``layer_metrics/<metric>.py``); which metrics a
cell reports comes from ``BENCHMARK.json``'s ``workloads`` lists. Adding
a cell or a metric adds files and edits none here.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "recsys_tpu")


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(repo: str = REPO) -> Dict:
    return _json(os.path.join(repo, "BENCHMARK.json"))


def load_cell(name: str, root: str = HERE) -> SimpleNamespace:
    """The cell ``name`` with its configuration, from their files."""
    cell = _json(os.path.join(root, "workloads", f"{name}.json"))
    config = _json(os.path.join(root, "configs", f"{cell['config']}.json"))
    return SimpleNamespace(name=name, spec=cell, config=config)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str, root: str = HERE):
    return _module(os.path.join(root, "drivers", f"{name}.py"), f"bench_port_driver_{name}")


def load_metric(name: str, root: str = HERE):
    return _module(os.path.join(root, "layer_metrics", f"{name}.py"),
                   "bench_port_metric_" + name.replace(".", "_").replace("-", "_"))


def cell_metrics(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package loaded in this process (whole
    top-level names: the port's name begins with the JAX package's)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_facts() -> Dict:
    """The card's name and power limit (``nvidia-smi``), for the record."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return {"nvidia_smi": out}


def log(obj) -> None:
    """An earlier line of standard output (the result is the last)."""
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def run_cell(cell: SimpleNamespace, seed: int, seconds: float, trace: bool, device: str,
             t0: float, bench: Optional[Dict] = None, root: str = HERE) -> Dict:
    """Run ``cell`` once on ``device`` and assemble its result line (the
    card check is the caller's). ``t0`` is the process's start."""
    import torch

    bench = bench if bench is not None else load_benchmark(os.path.dirname(root))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    driver = load_driver(cell.spec["driver"], root)
    with tempfile.TemporaryDirectory(prefix="bench_port_") as tmp:
        ctx = SimpleNamespace(cell=cell.spec, config=cell.config, name=cell.name, seed=seed,
                              seconds=seconds, trace=trace, device=device, t0=t0, tmp=tmp,
                              log=log)
        res = driver.run(ctx)
    metrics = {}
    if trace:
        notes = {}
        for m in cell_metrics(bench, cell.name, "per_layer"):
            value = load_metric(m["name"], root).read(res, ctx)
            if isinstance(value, tuple):
                value, notes[m["name"]] = value
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if notes:
            log({"metric_notes": notes})
    else:
        for m in cell_metrics(bench, cell.name, "end_to_end"):
            if m["name"] in res["e2e"]:
                metrics[m["name"]] = {"value": res["e2e"][m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": 1, "memory_peak_bytes": int(res["memory_peak_bytes"])}
    out = {"correct": bool(res["correct"]), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    if trace and res.get("trace") is not None:
        tr = res["trace"]
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = res["checks"]
    return out


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    import recsys_tpu_torch  # noqa: F401  the program under test: without it, fail here

    need = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"bench_port: {args.workload} needs {need} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    log({"workload": args.workload, "seed": args.seed, "seconds": args.seconds,
         "trace": args.trace, "card": torch.cuda.get_device_name(0), **card_facts()})
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
