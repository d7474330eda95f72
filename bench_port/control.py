"""Readings that set the limits of ``correct``: the control and the
planted faults, on the chip at a cell's own size.

    python3 bench_port/control.py --workload <cell> --seeds 11 12 13

The control is the plain reference in the program's place, computed with
the operands the configuration rounds to bf16 rounded to fp8 (e4m3, one
scale a tensor) instead. Faults are planted in the reference put in the
program's place: for a training cell, half of each checked batch left out
(the mean over the rest); a step that leaves its state unchanged reads 1
on ``change_gap`` by construction and needs no run. For a serving cell,
each answer altered where it is produced: its first item replaced by the
reference's ``rerank``-th candidate. Each reading prints as one JSON line
beside the reference against itself. The benchmark's own runs never run
this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port import compare, harness  # noqa: E402


def train_readings(ctx, drv) -> dict:
    inp = drv.inputs(ctx)
    ref = drv.reference_readings(ctx, inp, "bf16")
    out = {"self": compare.train_numbers(ref, ref)}
    out["control_fp8"] = compare.train_numbers(drv.reference_readings(ctx, inp, "fp8"), ref)
    half = drv.reference_readings(ctx, inp, "bf16", rows_fn=lambda idx: idx[:len(idx) // 2])
    out["fault_half_batch"] = compare.train_numbers(half, ref)
    return out


def serve_readings(ctx) -> dict:
    import torch

    from bench_port import datagen, loadgen
    from bench_port.reference.serve import Scorer

    cfg, tr = ctx.config, ctx.cell["traffic"]
    nu, ni = cfg["data"]["n_users"], cfg["data"]["n_items"]
    torch.backends.cuda.matmul.allow_tf32 = False
    _, users = loadgen.schedule(ctx.seed, tr["rate"], ctx.seconds, nu, tr["user_zipf"])
    picked = sorted(loadgen.sample_indices(ctx.seed, len(users), tr["check_sample"]))
    uids = torch.tensor([int(users[i]) - 1 for i in picked], device=ctx.device)
    params = datagen.weights(ctx.seed, cfg["model"], nu, ni, ctx.device)
    ref = Scorer(params, cfg["model"], cfg["serve"], ni, fmt="bf16")
    ctl = Scorer(params, cfg["model"], cfg["serve"], ni, fmt="fp8")
    k, r = tr["k"], tr["rerank_candidates"]

    def as_answers(items, scores):
        return [(int(u), list(zip(i.tolist(), s.tolist())))
                for u, i, s in zip(uids, items, scores)]

    items, scores, cand, _ = ref.answer(uids, r, k)
    out = {"self": compare.serve_numbers(ref, as_answers(items, scores), r, k, ni)}
    c_items, c_scores, _, _ = ctl.answer(uids, r, k)
    out["control_fp8"] = compare.serve_numbers(ref, as_answers(c_items, c_scores), r, k, ni)
    altered = items.clone()
    altered[:, 0] = cand[:, -1]
    out["fault_altered_answer"] = compare.serve_numbers(ref, as_answers(altered, scores), r, k,
                                                        ni)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    drv = harness.load_driver(cell.spec["driver"])
    for seed in args.seeds:
        ctx = SimpleNamespace(cell=cell.spec, config=cell.config, name=cell.name, seed=seed,
                              seconds=args.seconds, trace=False, device=args.device, t0=T0,
                              tmp=None, log=harness.log)
        t = time.perf_counter()
        if hasattr(drv, "reference_readings"):
            out = train_readings(ctx, drv)
        else:
            out = serve_readings(ctx)
        harness.log({"workload": args.workload, "seed": seed,
                     "seconds": time.perf_counter() - t, "limits": cell.spec["limits"],
                     **{k: {n: v for n, v in d.items() if not isinstance(v, list)}
                        for k, d in out.items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
