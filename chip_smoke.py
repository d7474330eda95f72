#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``recsys_tpu_torch/csrc``;
3. initialises a full-width ``MultiTaskModel`` (the ``ModelConfig``
   defaults; 6,040 users, 3,883 items) from a seeded ``torch.Generator``,
   builds the ``RetrievalIndex`` on the card and writes a bundle;
4. serves the bundle (``RecommendationService(device="cuda",
   rerank_candidates=200)`` behind ``make_http_server``) and sends the
   main path's requests, checking status codes and payloads, and checks
   the served rankings against the same bundle served on the CPU through
   the plain PyTorch versions;
5. asserts that each kernel's launch counter rose during the requests;
6. holds each kernel against its plain version on the card, at the
   served shapes and at one large top-k shape, and times kernel, plain
   version, the one-call library yardstick and the bound (CUDA events
   over back-to-back calls), and kernel and plain version again in
   device time (``torch.profiler``);
7. times ``recommend`` and a 64-user ``recommend_batch`` through the
   service and traces them with ``torch.profiler``: device time per
   request, the device's busy share, and the kernels that take it;
8. prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero without the last line. Without a
CUDA device it exits 2 before doing anything.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

SEED = 0
N_USERS, N_ITEMS = 6040, 3883  # MovieLens-1M scale
RERANK = 200
BATCH_USERS = 64
# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and fp32
# (non-tensor-core) rate; the bound of a call is the larger of bytes /
# bandwidth and operations / rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TOPK_TOL = 1e-5  # fp32 scores in [-1, 1]: summation order only
DCN_TOL = 1e-5   # relative to max(1, max|ref|): summation order only
SERVE_TOL = 2e-3  # GPU vs CPU rerank score: one bf16 ulp of the DCN output


def log(msg: str) -> None:
    print(msg, flush=True)


def http(port: int, method: str, path: str, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            code, payload = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, payload = e.code, json.loads(e.read())
    return code, payload, (time.perf_counter() - t0) * 1e3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def check_recs(recs, k: int, what: str) -> None:
    import math

    check(len(recs) == k, f"{what}: {len(recs)} recommendations, want {k}")
    check([r["rank"] for r in recs] == list(range(1, k + 1)), f"{what}: ranks")
    scores = [r["score"] for r in recs]
    check(all(math.isfinite(s) for s in scores), f"{what}: non-finite score")
    check(scores == sorted(scores, reverse=True), f"{what}: not descending")


def same_ranking(got, want, tol: float, what: str) -> float:
    """Per-rank scores within ``tol``; ids may differ only among scores
    within ``tol`` of the row's boundary. -> max score difference."""
    import numpy as np

    gs = np.array([r["score"] for r in got])
    ws = np.array([r["score"] for r in want])
    err = float(np.abs(gs - ws).max())
    check(err <= tol, f"{what}: score differs by {err} > {tol}")
    inside = lambda recs, s: {r["item_id"] for r in recs if r["score"] > s[-1] + tol}
    check(inside(got, gs) <= {r["item_id"] for r in want}
          and inside(want, ws) <= {r["item_id"] for r in got},
          f"{what}: rankings differ beyond ties")
    return err


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, kernel: str = "") -> tuple:
    """Device time per call of ``fn`` from a ``torch.profiler`` window of
    ``iters`` calls (after one warm-up call): (all device work, the
    device work of kernels whose name holds ``kernel``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events)
    named = sum(e.self_device_time_total for e in events if kernel and kernel in e.key)
    return total / 1e3 / iters, named / 1e3 / iters


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def serve_main_path(bundle: str, counters, device: str = "cuda") -> dict:
    """Phase 4: the served requests, with every kernel counter set to 0
    just before and read just after."""
    import numpy as np
    from recsys_tpu_torch.serve.app import make_http_server
    from recsys_tpu_torch.serve.service import RecommendationService

    svc = RecommendationService(bundle, rerank_candidates=RERANK, device=device).load()
    server = make_http_server(svc, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    known, cold = 1, 999_999
    batch = [int(u) for u in np.arange(1, N_USERS + 1, N_USERS // BATCH_USERS)[:BATCH_USERS]]
    latency = {}
    try:
        for c in counters:
            c.reset()
        code, body, _ = http(port, "GET", "/health")
        check(code == 200 and body["model_loaded"], f"/health: {code} {body}")
        code, body, _ = http(port, "GET", "/model/info")
        check(code == 200 and body["n_users"] == N_USERS and body["n_items"] == N_ITEMS,
              f"/model/info: {code} {body}")
        code, body, latency["recommend_first_ms"] = http(
            port, "POST", "/recommend", {"user_id": known, "k": 10})
        check(code == 200 and body["user_id"] == known, f"/recommend: {code}")
        check_recs(body["recommendations"], 10, "/recommend known user")
        served_known = body["recommendations"]
        code, body, latency["recommend_ms"] = http(
            port, "POST", "/recommend", {"user_id": known, "k": 10})
        check(code == 200 and body["recommendations"] == served_known,
              "/recommend is not repeatable")
        code, body, _ = http(port, "POST", "/recommend", {"user_id": cold, "k": 10})
        check(code == 200 and body["recommendations"][0]["score"] == 1.0,
              "/recommend cold user: popularity fallback expected")
        check_recs(body["recommendations"], 10, "/recommend cold user")
        code, body, latency["recommend_batch64_ms"] = http(
            port, "POST", "/recommend/batch", {"user_ids": batch, "k": 10})
        check(code == 200 and body["count"] == BATCH_USERS, f"/recommend/batch: {code}")
        for res in body["results"]:
            check(res["status"] == "ok", "/recommend/batch: cold status for a known user")
            check_recs(res["recommendations"], 10, "/recommend/batch")
        served_batch = body["results"]
        code, body, _ = http(port, "POST", "/score",
                             {"user_id": known, "item_ids": [1, 2, 3]})
        check(code == 200 and len(body["scores"]) == 3, f"/score: {code}")
        code, body, _ = http(port, "POST", "/recommend", {"user_id": known, "k": 101})
        check(code == 422, f"/recommend k=101: {code}, want 422")
        launches = {c.name: c.read() for c in counters}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")

    # the same bundle served on the CPU runs the plain versions
    ref = RecommendationService(bundle, rerank_candidates=RERANK, device="cpu").load()
    err = same_ranking(served_known, ref.recommend(known, 10), SERVE_TOL, "known user")
    for res, want in zip(served_batch, ref.recommend_batch(batch, 10)):
        err = max(err, same_ranking(res["recommendations"], want["recommendations"],
                                    SERVE_TOL, f"batch user {res['user_id']}"))
    log(f"served rankings match the CPU plain path: max score diff {err:.3g} "
        f"(tol {SERVE_TOL})")
    return {"launches": launches, "latency": latency, "service": svc, "batch": batch}


class Counter:
    """A kernel wrapper's launch count: reset to 0, read back."""

    def __init__(self, name, holder, attr="launches"):
        self.name, self.holder, self.attr = name, holder, attr

    def reset(self):
        setattr(self.holder, self.attr, 0)

    def read(self) -> int:
        return int(getattr(self.holder, self.attr))


def check_topk(u, v, k: int, normalize: bool = False, bias=None) -> float:
    """Kernel against its plain version on the same inputs: scores to
    TOPK_TOL (relative to the largest score when above 1), and every
    returned id in range, distinct and carrying its score. -> max error."""
    import torch
    from recsys_tpu_torch.ops.topk_flash import (
        NEG_INF, flash_topk, flash_topk_reference, l2_normalize,
    )

    q_n, n = u.shape[0], v.shape[0]
    s, i = flash_topk(u, v, k, normalize=normalize, item_bias=bias)
    torch.cuda.synchronize()
    rs, _ = flash_topk_reference(u, v, k, normalize=normalize, item_bias=bias)
    what = f"topk Q={q_n} N={n} d={u.shape[1]} k={k}"
    check(s.shape == (q_n, k) and i.shape == (q_n, k), f"{what}: shape {tuple(s.shape)}")
    real = rs > NEG_INF / 2
    tol = TOPK_TOL * max(1.0, float(rs[real].abs().max()))
    err = float((s - rs).abs().max())
    check(err <= tol, f"{what}: max err {err} > {tol}")
    check(bool((real.sum(dim=1) == min(k, n)).all()), f"{what}: wrong fill")
    check(bool(((i >= 0) & (i < n)).all()), f"{what}: id out of range")
    filler = -1 - torch.arange(k, device=i.device)
    distinct = torch.where(real, i, filler).sort(dim=1).values.diff(dim=1) != 0
    check(bool(distinct.all()), f"{what}: repeated id")
    iu, iv = (l2_normalize(u), l2_normalize(v)) if normalize else (u, v)
    rescored = torch.einsum("qd,qkd->qk", iu, iv[i])
    if bias is not None:
        rescored = rescored + bias[i]
    id_err = float(((rescored - s).abs() * real).max())
    check(id_err <= tol, f"{what}: ids do not carry their scores ({id_err})")
    return err


def check_dcn(x0, w, b) -> float:
    """Kernel against its plain version: max error within DCN_TOL of
    max(1, max|ref|), finite output. -> max error."""
    import torch
    from recsys_tpu_torch.ops.dcn_cross import dcn_cross, dcn_cross_reference

    out = dcn_cross(x0, w, b)
    torch.cuda.synchronize()
    ref = dcn_cross_reference(x0, w, b)
    err = float((out - ref).abs().max())
    tol = DCN_TOL * max(1.0, float(ref.abs().max()))
    what = f"dcn n={x0.shape[0]} F={x0.shape[1]} L={w.shape[0]}"
    check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
          f"{what}: bad output")
    check(err <= tol, f"{what}: max err {err} > {tol}")
    return err


def check_edges() -> None:
    """Edge cases of both kernels on the card, before any timing: k > N,
    several query tiles, the item-bias augmentation (d = 129), every
    buffer size, a catalog ordered so that late items keep evicting,
    and ragged row counts and widths of the cross stack."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    check_topk(rnd(1, 8), rnd(5, 8), 10, normalize=True)
    check_topk(rnd(70, 24), rnd(1000, 24), 1, normalize=True)
    check_topk(rnd(70, 24), rnd(1000, 24), 64, normalize=True)
    check_topk(rnd(3, 128), rnd(20000, 128), 128, bias=rnd(20000))
    v = rnd(4099, 128)
    v = v[v.norm(dim=1).argsort()].contiguous()  # ascending norms
    check_topk(rnd(5, 128).abs(), v.abs(), 256)
    for n, f, n_layers in ((37, 256, 3), (1, 24, 1), (1000, 100, 2), (5, 1024, 3)):
        check_dcn(rnd(n, f), rnd(n_layers, f) * f ** -0.5, rnd(n_layers, f) * 0.1)
    log("kernel edge cases agree with the plain versions")


def measure_topk(u, v, k: int, iters: int) -> dict:
    import torch
    from recsys_tpu_torch.ops.topk_flash import flash_topk, flash_topk_reference

    q_n, d = u.shape
    n = v.shape[0]
    err = check_topk(u, v, k)
    b_ms, b_by = bound_ms(4 * (q_n * d + n * d) + 12 * q_n * k, 2 * q_n * n * d)
    kernel = lambda: flash_topk(u, v, k, normalize=False)
    plain = lambda: flash_topk_reference(u, v, k, normalize=False)
    dev_ms, dev_kernel_ms = device_ms(kernel, iters, kernel="topk_flash")
    return {
        "shape": {"Q": q_n, "N": n, "d": d, "k": k},
        "max_abs_err": err,
        "ms": time_ms(kernel, iters),
        "plain_ms": time_ms(plain, iters),
        "library_ms": time_ms(lambda: torch.topk(torch.matmul(u, v.T), k, dim=1), iters),
        "bound_ms": b_ms, "bound_by": b_by,
        # device time per call: the wrapper (kernel + final torch.topk),
        # the kernel alone, and the plain version
        "device_ms": dev_ms, "kernel_device_ms": dev_kernel_ms,
        "plain_device_ms": device_ms(plain, iters)[0],
    }


def measure_dcn(x0, w, b, iters: int) -> dict:
    from recsys_tpu_torch.ops.dcn_cross import dcn_cross, dcn_cross_reference

    n, f = x0.shape
    n_layers = w.shape[0]
    err = check_dcn(x0, w, b)
    b_ms, b_by = bound_ms(4 * (2 * n * f + 2 * n_layers * f), 5 * n * n_layers * f)
    kernel = lambda: dcn_cross(x0, w, b)
    plain = lambda: dcn_cross_reference(x0, w, b)
    return {
        "shape": {"n": n, "F": f, "L": n_layers},
        "max_abs_err": err,
        "ms": time_ms(kernel, iters),
        "plain_ms": time_ms(plain, iters),
        "library_ms": None,  # no single PyTorch call computes the stack
        "bound_ms": b_ms, "bound_by": b_by,
        "device_ms": device_ms(kernel, iters)[0],
        "plain_device_ms": device_ms(plain, iters)[0],
    }


def profile_requests(svc, batch) -> list:
    """Phase 7: per-request latency through the service (no HTTP),
    host clock with the profiler off (median and p90 of 50 calls), then a
    traced window of 20 calls: device time per call, the device's busy
    share of the traced wall time, and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = {"recommend_k10": lambda: svc.recommend(1, 10),
             "recommend_batch64_k10": lambda: svc.recommend_batch(batch, 10)}
    rows = []
    for name, fn in calls.items():
        for _ in range(5):
            fn()
        walls = []
        for _ in range(50):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        walls.sort()
        n_traced = 20
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()  # after the profiler's own start-up
            for _ in range(n_traced):
                fn()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / n_traced
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in device) / 1e3 / n_traced
        top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        rows.append({
            "profile": name, "n": len(walls),
            "wall_ms_p50": walls[len(walls) // 2], "wall_ms_p90": walls[int(len(walls) * 0.9)],
            "traced_wall_ms": traced_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / traced_ms,
            "device_launches": sum(e.count for e in device) // n_traced,
            "top_device_us": [[e.key[:60], e.self_device_time_total / n_traced]
                              for e in top],
        })
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import numpy as np
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig
    from recsys_tpu_torch.models import layers as L
    from recsys_tpu_torch.models.multitask import MultiTaskModel
    from recsys_tpu_torch.models.towers import TwoTower
    from recsys_tpu_torch.ops import _build, dcn_cross as dcn_mod, topk_flash as topk_mod
    from recsys_tpu_torch.retrieval import scorer
    from recsys_tpu_torch.retrieval.scorer import RetrievalIndex, l2_normalize
    from recsys_tpu_torch.train.checkpoint import save_inference_bundle

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    log(f"built {', '.join(p.name for p in _build.sources())} -> {lib.name} "
        f"in {time.perf_counter() - t0:.1f} s")
    check_edges()

    cfg = RecsysConfig(model=ModelConfig(dropout_rate=0.0))  # full width
    gen = torch.Generator().manual_seed(SEED)
    params = MultiTaskModel.init(gen, cfg.model, N_USERS, N_ITEMS, "cuda")
    user_raw = np.arange(1, N_USERS + 1)
    item_raw = np.arange(1, N_ITEMS + 1)
    index = RetrievalIndex.build(params["towers"], cfg.model, N_ITEMS, item_raw,
                                 device="cuda")
    counters = [Counter("topk_flash", topk_mod.flash_topk),
                Counter("dcn_cross", dcn_mod.dcn_cross),
                Counter("topk_scores", scorer.topk_scores, "calls")]
    with tempfile.TemporaryDirectory() as bundle:
        save_inference_bundle(bundle, params["towers"], cfg, user_raw, item_raw,
                              index=index, full_params=params)
        t0 = time.perf_counter()
        served = serve_main_path(bundle, counters)
        log(f"served the main path in {time.perf_counter() - t0:.1f} s: "
            f"launches {served['launches']}, latency {served['latency']}")
    launches = served["launches"]
    check(launches["topk_flash"] > 0, "the top-k kernel never launched on the main path")
    check(launches["dcn_cross"] > 0, "the DCN kernel never launched on the main path")
    check(launches["topk_scores"] == 0, "the dense k > 256 path ran on the main path")

    # ---- kernels against their plain versions, at the served shapes ----
    svc = served["service"]
    catalog = svc.index._catalog_ready()
    with torch.inference_mode():
        ids = torch.as_tensor([svc.user_id_map[u] for u in served["batch"]], device="cuda")
        users = l2_normalize(TwoTower.user_embed(svc.encoder_params, ids, cfg.model))
        topk_rows = [measure_topk(users[:q].contiguous(), catalog, k, iters=50)
                     for q in (1, BATCH_USERS) for k in (10, RERANK)]
        g = torch.Generator(device="cuda").manual_seed(SEED)
        big_u = l2_normalize(torch.randn((4096, 128), generator=g, device="cuda"))
        big_v = l2_normalize(torch.randn((1 << 20, 128), generator=g, device="cuda"))
        topk_rows.append(measure_topk(big_u, big_v, 10, iters=3))
        del big_u, big_v
        dcn_rows = []
        cross = svc.model_params["dcn"]["cross"]
        w = torch.stack([cross[f"layer_{i}"]["w"] for i in range(cfg.model.cross_layers)])
        b = torch.stack([cross[f"layer_{i}"]["b"] for i in range(cfg.model.cross_layers)])
        for q in (1, BATCH_USERS):  # x0 of the rerank of q users x 200 candidates
            _, cand = svc.index.search(users[:q], RERANK)
            flat_u = ids[:q].repeat_interleave(RERANK)
            flat_i = torch.as_tensor(cand.reshape(-1), device="cuda")
            u_emb, v_emb = TwoTower.apply(svc.model_params["towers"], cfg.model,
                                          flat_u, flat_i)
            x0 = L.round_bf16(torch.cat([u_emb, v_emb], dim=-1)).contiguous()
            dcn_rows.append(measure_dcn(x0, w, b, iters=50))
    for row in topk_rows + dcn_rows:
        log(f"kernel {json.dumps(row)}")
    for row in profile_requests(svc, served["batch"]):
        log(f"profile {json.dumps(row)}")

    main_topk = next(r for r in topk_rows
                     if r["shape"] == {"Q": BATCH_USERS, "N": N_ITEMS, "d": 128, "k": RERANK})
    main_dcn = dcn_rows[-1]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": "topk_flash", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/topk_flash.cu",
         "replaces": "recsys_tpu/ops/pallas/topk_flash.py:82",
         "launches": launches["topk_flash"], **{k: main_topk[k] for k in keys},
         "shape": main_topk["shape"], "shapes": topk_rows},
        {"name": "dcn_cross", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/dcn_cross.cu",
         "replaces": "recsys_tpu/ops/pallas/dcn_cross.py:43",
         "launches": launches["dcn_cross"], **{k: main_dcn[k] for k in keys},
         "shape": main_dcn["shape"], "shapes": dcn_rows},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
