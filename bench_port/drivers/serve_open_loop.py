"""Open-loop ``/recommend`` over HTTP: the port's asyncio server
(``AioHttpServer`` with its default ``LoopCoalescer``) in front of
``RecommendationService(backend="device")`` with the DCN rerank, driven by
``loadgen.py`` in a process of its own.

Set-up: weights on the card from the seed, the index built by the
program, the inference bundle written to the run's temporary directory
and loaded by the service, every batch size from 1 to ``warm_batch``
scored once, the server started and ``warm_requests`` requests sent over
HTTP. The window is the generator's schedule. Afterwards a sample of the
answers, drawn from the seed, is held against the plain reference.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def p95(latencies: List) -> float:
    """Nearest-rank 95th percentile over every request, a failed one
    (None) counting as infinitely late."""
    vals = sorted(float("inf") if x is None else x for x in latencies)
    if not vals:
        return float("nan")
    return vals[max(int(-(-0.95 * len(vals) // 1)) - 1, 0)]


def build_service(ctx):
    """Weights from the seed -> the program's index and bundle -> the
    loaded device service."""
    import numpy as np
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig
    from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
    from recsys_tpu_torch.serve.service import RecommendationService
    from recsys_tpu_torch.train.checkpoint import save_inference_bundle

    from bench_port import datagen

    cfg, tr = ctx.config, ctx.cell["traffic"]
    nu, ni = cfg["data"]["n_users"], cfg["data"]["n_items"]
    model_cfg = ModelConfig(**cfg["model"])
    params = datagen.weights(ctx.seed, cfg["model"], nu, ni, ctx.device)
    item_raw = np.arange(1, ni + 1, dtype=np.int64)
    index = RetrievalIndex.build(params["towers"], model_cfg, ni, item_raw, device=ctx.device)
    bundle = os.path.join(ctx.tmp, "serving")
    save_inference_bundle(bundle, params["towers"], RecsysConfig(model=model_cfg),
                          np.arange(1, nu + 1, dtype=np.int64), item_raw, index=index,
                          full_params=params)
    del params, index
    service = RecommendationService(
        bundle, backend="device", rerank_candidates=tr["rerank_candidates"],
        rerank_ctr_weight=cfg["serve"]["rerank_ctr_weight"],
        rerank_rating_weight=cfg["serve"]["rerank_rating_weight"],
        device=ctx.device).load()
    return service


class Window:
    """The thread beside the server's loop: HTTP warm-up, the generator,
    and the window's marks, posted to the loop so that they run on the
    thread the program runs on."""

    def __init__(self, ctx, server, rate: float, sample: int, out: str):
        self.ctx, self.server, self.rate, self.sample, self.out = ctx, server, rate, sample, out
        self.loop = None  # the server's loop, seen from inside its first batch
        self.t_start = self.t_open = self.t_close = None
        self.stats = {}
        self.error = None
        self._span = None
        self.thread = threading.Thread(target=self._run, daemon=True)

    def batch_hook(self, fn):
        """Wrap the service's ``recommend_batch``: note the running loop."""
        import asyncio

        def wrapped(*a, **kw):
            if self.loop is None:
                self.loop = asyncio.get_running_loop()
            return fn(*a, **kw)

        return wrapped

    def _open(self):
        self.t_open = time.perf_counter()
        self.stats["open"] = dict(self.server.coalescer.stats())
        if self.ctx.trace:
            from bench_port import tracing

            self._span = tracing.span("bench.window")
            self._span.__enter__()

    def _close(self):
        self.t_close = time.perf_counter()
        self.stats["close"] = dict(self.server.coalescer.stats())
        if self._span is not None:
            self._span.__exit__(None, None, None)

    def _warm_http(self, port: int, n: int) -> None:
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        for i in range(n):
            body = json.dumps({"user_id": 1 + i, "k": self.ctx.cell["traffic"]["k"]})
            conn.request("POST", "/recommend", body, {"Content-Type": "application/json"})
            r = conn.getresponse()
            r.read()
            if r.status != 200:
                raise RuntimeError(f"warm-up request answered {r.status}")
        conn.close()

    def _run(self):
        proc = None
        try:
            while self.server.bound_port is None:
                time.sleep(0.005)
            tr = self.ctx.cell["traffic"]
            self._warm_http(self.server.bound_port, tr["warm_requests"])
            cfg = self.ctx.config["data"]
            cmd = [sys.executable, os.path.join(HERE, "loadgen.py"),
                   "--port", str(self.server.bound_port), "--rate", repr(self.rate),
                   "--seconds", repr(self.ctx.seconds), "--seed", str(self.ctx.seed),
                   "--users", str(cfg["n_users"]), "--zipf", repr(tr["user_zipf"]),
                   "--k", str(tr["k"]), "--sample", str(self.sample),
                   "--drain", repr(float(tr.get("drain_s", 60.0))), "--out", self.out]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
            for line in proc.stdout:
                word = line.strip()
                if word == "START":
                    self.t_start = time.perf_counter()
                    self.loop.call_soon_threadsafe(self._open)
                elif word == "END":
                    self.loop.call_soon_threadsafe(self._close)
            if proc.wait() != 0:
                raise RuntimeError(f"load generator exited with {proc.returncode}")
        except Exception as e:  # reported by the driver; the server must stop
            self.error = e
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            if self.server.bound_port is not None:
                # stop the loop once the marks posted above have run
                while self.loop is not None and self.t_start and self.t_close is None \
                        and self.error is None:
                    time.sleep(0.01)
                self.server.shutdown()


def serve_window(ctx, service, rate: float, sample: int) -> Dict:
    """One window of open-loop load at ``rate`` -> the generator's record,
    the window's marks and the coalescer's counts (the traced run's trace
    too)."""
    import torch
    from recsys_tpu_torch.models import dcn as dcn_mod
    from recsys_tpu_torch.retrieval import scorer as scorer_mod
    from recsys_tpu_torch.serve.aio import AioHttpServer

    from bench_port import tracing

    server = AioHttpServer(service, host="127.0.0.1", port=0)
    out = os.path.join(ctx.tmp, f"load_{rate:g}.json")
    win = Window(ctx, server, rate, sample, out)
    patches = tracing.Patches()
    patches.wrap(service, "recommend_batch", win.batch_hook)
    trace = None
    with tracing.profiler(ctx.trace) as prof:
        if ctx.trace:
            patches.wrap(service, "recommend_batch", tracing.spanned("bench.service"))
            patches.wrap(scorer_mod, "exact_topk", tracing.spanned(
                "bench.op.topk", lambda u, v, k, *a, **kw: dict(
                    q=u.shape[0], n=v.shape[0], d=v.shape[1], k=k)))
            patches.wrap(dcn_mod, "cross_stack", tracing.spanned(
                "bench.op.dcn_cross_fwd", lambda x0, w, b: dict(
                    n=x0.shape[0], f=x0.shape[1], layers=w.shape[0])))
        win.thread.start()
        try:
            server.serve_forever()
        finally:
            win.thread.join(timeout=120)
            patches.undo()
    if prof is not None:
        trace = tracing.reduce(prof)
    if win.error is not None:
        raise RuntimeError(f"serving window failed: {win.error!r}") from win.error
    with open(out) as f:
        load = json.load(f)
    o, c = win.stats["open"], win.stats["close"]
    batches = c["n_batches"] - o["n_batches"]
    served = c["n_requests"] - o["n_requests"]
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    return {"load": load, "t_start": win.t_start, "window_s": win.t_close - win.t_open,
            "batches": batches, "served": served, "trace": trace}


def warm(service, ctx) -> None:
    """Score every batch size the coalescer can form under this load once."""
    tr = ctx.cell["traffic"]
    nu = ctx.config["data"]["n_users"]
    for q in range(1, tr["warm_batch"] + 1):
        service.recommend_batch([1 + (i * 7919) % nu for i in range(q)], tr["k"])


def check(ctx, load: Dict) -> Dict:
    """The sampled answers against the reference (after the program's
    state is freed)."""
    import torch

    from bench_port import compare, datagen
    from bench_port.loadgen import sample_indices
    from bench_port.reference.serve import Scorer

    cfg, tr = ctx.config, ctx.cell["traffic"]
    nu, ni = cfg["data"]["n_users"], cfg["data"]["n_items"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = datagen.weights(ctx.seed, cfg["model"], nu, ni, ctx.device)
    scorer = Scorer(params, cfg["model"], cfg["serve"], ni)
    answers = []
    for i in sorted(int(s) for s in load["answers"]):
        recs = load["answers"][str(i)].get("recommendations")
        answers.append((load["users"][i] - 1,
                        None if recs is None else [(r["item_id"] - 1, r["score"]) for r in recs]))
    sampled = {int(s) for s in load["answers"]}
    # a sampled request that never answered is a bad answer too
    for i in sample_indices(ctx.seed, load["n"], tr["check_sample"]) - sampled:
        answers.append((load["users"][i] - 1, None))
    return compare.serve_numbers(scorer, answers, tr["rerank_candidates"], tr["k"], ni)


def run(ctx) -> Dict:
    import gc

    import torch

    from bench_port import compare

    tr = ctx.cell["traffic"]
    service = build_service(ctx)
    warm(service, ctx)
    w = serve_window(ctx, service, tr["rate"], tr["check_sample"])
    load = w["load"]
    lat = load["latency"]
    late = sorted(load["late"])
    ctx.log({"generator": {"requests": load["n"], "failed": sum(x is None for x in lat),
                           "late_p95_ms": 1e3 * late[int(0.95 * (len(late) - 1))] if late else 0,
                           "late_max_ms": 1e3 * late[-1] if late else 0,
                           "connections_opened": load["connections_opened"],
                           "batches": w["batches"], "served_in_window": w["served"]}})
    peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0
    del service
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = check(ctx, load)
    ctx.log({"reference_s": time.perf_counter() - t_ref})
    ok, checks = compare.judge(numbers, ctx.cell["limits"])
    p = p95(lat)
    drain = float(tr.get("drain_s", 60.0))
    return {
        "setup_s": w["t_start"] - ctx.t0,
        "e2e": {"setup_s": w["t_start"] - ctx.t0,
                "recommend_p95_ms": 1e3 * (p if p != float("inf") else ctx.seconds + drain)},
        "attempted": load["n"], "failed": sum(x is None for x in lat),
        "correct": ok, "checks": checks, "memory_peak_bytes": peak, "trace": w["trace"],
        "stats": {"batch_mean": w["served"] / max(w["batches"], 1), "served": w["served"],
                  "window_s": w["window_s"]},
    }
