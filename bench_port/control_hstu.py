"""Readings that set the limits of an HSTU cell's ``correct``, on the chip
at the cell's own size:

    python3 bench_port/control_hstu.py --workload hstu-train-longseq --seeds 11 12 13

Per seed the program takes the cell's three checked steps (the driver's
``checked_steps``: its readings against the reference are the sound
reading), then the plain reference follows the recorded steps as the cell
does, and again with the control (the operands of every matrix product
rounded to fp8 (e4m3) instead of bf16), with half of each checked batch
of histories, and with three faults of the attention planted in the
reference put in the program's place: the time bias left out, the scores
divided by each history's own length instead of N, and the causal
diagonal dropped. Each seed prints one JSON line. The benchmark's own
runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port import compare, harness  # noqa: E402

FAULTS = ("no_time_bias", "own_n", "no_diagonal")


def readings(ctx, drv) -> dict:
    import torch
    from recsys_tpu_torch.train.trainer import Trainer

    from bench_port import hstu_datagen

    inp = drv.inputs(ctx)
    trainer = Trainer(drv._config(ctx), output_dir=ctx.tmp, device=ctx.device)
    state = trainer.state_from_params(
        hstu_datagen.weights(ctx.seed, ctx.config["model"], ctx.device), ctx.seed)
    state, prog, recorded = drv.checked_steps(ctx, inp, trainer, state)
    del state, trainer, inp
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    ref = drv.reference_readings(ctx, recorded, "bf16")
    planted = {"control_fp8": drv.reference_readings(ctx, recorded, "fp8"),
               "fault_half_batch": drv.reference_readings(ctx, recorded, "bf16", half=True)}
    for fault in FAULTS:
        planted[f"fault_{fault}"] = drv.reference_readings(ctx, recorded, "bf16", fault=fault)
    out = {"program": compare.train_numbers(prog, ref), "self": compare.train_numbers(ref, ref)}
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
        with tempfile.TemporaryDirectory(prefix="control_hstu_") as tmp:
            ctx = SimpleNamespace(cell=cell.spec, config=cell.config, name=cell.name, seed=seed,
                                  seconds=0.0, trace=False, device=args.device, t0=T0, tmp=tmp,
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
