"""Find the knee of a serving cell: the highest offered rate at which the
95th percentile stays within a limit with no growing backlog.

    python3 bench_port/knee.py --workload ml1m-serve-poisson --seed N \
        --seconds 10 --limit_ms 50 --rates 600 800 1000 1200

One process sets the cell up once and offers each rate in turn for
``--seconds`` (a new server and generator each time). Each rate prints
one JSON line: the p50, p95 and p99 over every request (failures count as
infinitely late), the rate achieved, the mean coalesced batch, and the
backlog's growth (the mean latency of the last fifth of the requests over
that of the first fifth). Run it on the chip, once, when a cell is
defined; the cells then carry their rates as numbers.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port import harness  # noqa: E402


def pct(vals, q):
    vals = sorted(float("inf") if v is None else v for v in vals)
    return vals[max(int(-(-q * len(vals) // 1)) - 1, 0)] if vals else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--limit_ms", type=float, default=50.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--repeats", type=int, default=1,
                    help="windows at each rate, each on its own seed")
    args = ap.parse_args(argv)
    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("knee: needs a CUDA card", file=sys.stderr)
        return 2
    drv = harness.load_driver(cell.spec["driver"])
    with tempfile.TemporaryDirectory(prefix="bench_port_knee_") as tmp:
        ctx = SimpleNamespace(cell=cell.spec, config=cell.config, name=cell.name,
                              seed=args.seed, seconds=args.seconds, trace=False,
                              device="cuda", t0=T0, tmp=tmp, log=harness.log)
        service = drv.build_service(ctx)
        drv.warm(service, ctx)
        harness.log({"card": torch.cuda.get_device_name(0), **harness.card_facts()})
        for rate, rep in [(r, i) for r in args.rates for i in range(args.repeats)]:
            ctx.seed = args.seed + rep
            w = drv.serve_window(ctx, service, rate, 0)
            lat = w["load"]["latency"]
            n = len(lat)
            fifth = max(n // 5, 1)
            done = [x for x in lat if x is not None]
            first = [x for x in lat[:fifth] if x is not None]
            last = [x for x in lat[-fifth:] if x is not None]
            growth = (sum(last) / len(last)) / (sum(first) / len(first)) if first and last else None
            p95 = pct(lat, 0.95)
            harness.log({"rate": rate, "seed": ctx.seed, "requests": n, "failed": n - len(done),
                         "achieved_rps": len(done) / args.seconds,
                         "p50_ms": 1e3 * pct(lat, 0.50), "p95_ms": 1e3 * p95,
                         "p99_ms": 1e3 * pct(lat, 0.99),
                         "batch_mean": w["served"] / max(w["batches"], 1),
                         "backlog_growth": growth,
                         "late_p95_ms": 1e3 * pct(w["load"]["late"], 0.95),
                         "connections": w["load"]["connections_opened"],
                         "within_limit": p95 * 1e3 <= args.limit_ms})
    return 0


if __name__ == "__main__":
    sys.exit(main())
