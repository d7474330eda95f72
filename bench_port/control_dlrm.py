"""Readings that set the limits of a DLRM-DCNv2 cell's ``correct``, on the
chip at the cell's own size:

    python3 bench_port/control_dlrm.py --workload dlrm-train-mhot --seeds 11 12 13

``control.py``'s readings (the reference against itself, the control with
the bf16 operands rounded to fp8 instead, half of each checked batch left
out), and two faults of the embedding bags planted in the reference put
in the program's place: every bag pooled by its mean instead of its sum,
and the update of one table (the one with the largest bag) left out, its
slots too. A step that leaves its state unchanged reads 1 on
``change_gap`` by construction and needs no run. Each seed prints one JSON
line. The benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port import compare, harness  # noqa: E402


def readings(ctx, drv) -> dict:
    inp = drv.inputs(ctx)
    ref = drv.reference_readings(ctx, inp, "bf16")
    bags = ctx.config["model"]["bag_sizes"]
    dropped = max(range(len(bags)), key=lambda t: bags[t])
    planted = {
        "control_fp8": drv.reference_readings(ctx, inp, "fp8"),
        "fault_half_batch": drv.reference_readings(ctx, inp, "bf16",
                                                   rows_fn=lambda idx: idx[:len(idx) // 2]),
        "fault_mean_bags": drv.reference_readings(ctx, inp, "bf16", fault="mean_bags"),
        "fault_drop_table": drv.reference_readings(ctx, inp, "bf16",
                                                   fault=f"drop_table:{dropped}"),
    }
    out = {"self": compare.train_numbers(ref, ref)}
    out.update({k: compare.train_numbers(v, ref) for k, v in planted.items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    drv = harness.load_driver(cell.spec["driver"])
    for seed in args.seeds:
        ctx = SimpleNamespace(cell=cell.spec, config=cell.config, name=cell.name, seed=seed,
                              seconds=0.0, trace=False, device=args.device, t0=T0, tmp=None,
                              log=harness.log)
        t = time.perf_counter()
        out = readings(ctx, drv)
        harness.log({"workload": args.workload, "seed": seed,
                     "seconds": time.perf_counter() - t, "limits": cell.spec["limits"],
                     **{k: {n: v for n, v in d.items() if not isinstance(v, list)}
                        for k, d in out.items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
