"""Readings that set the limits of an MLA-MoE cell's ``correct``, on the chip
at the cell's own size:

    python3 bench_port/control_mla_moe.py --workload mlamoe-train-longseq --seeds 11 12 13

Per seed the program takes the cell's three checked steps (its cell driver's
``checked_steps``: its readings against the reference are the sound
reading, with the reference's checks of the negatives and the expert
choices), then the plain reference follows the recorded steps as the cell
does, and again with the control (the operands of every matrix product
rounded to fp8 (e4m3) instead of bf16), with half of each checked batch
of histories, and with four faults planted in the reference put in the
program's place: RoPE's plain frequencies and softmax scale in place of
YaRN's, the gate weights renormalised to sum 1, the shared experts left
out, and the balance loss left out. Each seed prints one JSON line. The
benchmark's own runs never run this.
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

FAULTS = ("plain_rope", "renorm", "no_shared", "no_balance")


def readings(ctx, drv) -> dict:
    import torch
    from recsys_tpu_torch.train.trainer import Trainer

    inp = drv.inputs(ctx)
    trainer = Trainer(drv._config(ctx), output_dir=ctx.tmp, device=ctx.device)
    state = trainer.state_from_params(drv.weights(ctx), ctx.seed)
    state, prog, recorded = drv.checked_steps(ctx, inp, trainer, state)
    del state, trainer, inp
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    check = {}
    ref = drv.reference_readings(ctx, recorded, "bf16", check=check)
    if not ref:
        return {"check": check}
    planted = {"control_fp8": drv.reference_readings(ctx, recorded, "fp8"),
               "fault_half_batch": drv.reference_readings(ctx, recorded, "bf16", half=True)}
    for fault in FAULTS:
        planted[f"fault_{fault}"] = drv.reference_readings(ctx, recorded, "bf16", fault=fault)
    out = {"program": compare.train_numbers(prog, ref), "self": compare.train_numbers(ref, ref),
           "check": check}
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
        with tempfile.TemporaryDirectory(prefix="control_mla_moe_") as tmp:
            ctx = SimpleNamespace(cell=cell.spec, config=cell.config, name=cell.name, seed=seed,
                                  seconds=0.0, trace=False, device=args.device, t0=T0, tmp=tmp,
                                  log=harness.log)
            t = time.perf_counter()
            out = readings(ctx, drv)
        harness.log({"workload": args.workload, "seed": seed,
                     "seconds": time.perf_counter() - t, "limits": cell.spec["limits"],
                     **{k: d if k == "check" else {n: v for n, v in d.items()
                                                   if not isinstance(v, list)}
                        for k, d in out.items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
