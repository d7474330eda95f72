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
8. trains: a synthetic MovieLens-1M-sized bundle (6,040 users, 3,883
   items with Zipf-skewed popularity, 200,000 train and 25,000 val rows,
   from ``SEED``) through ``Trainer(..., device="cuda").train`` at the
   full-width ``ModelConfig`` defaults, batch 8,192, 2 epochs (the
   "auto" policy takes the flash CE kernels there), with the launch
   counters set to 0 just before and read just after; checks the losses,
   the artifacts and that every training kernel launched;
9. serves the trained bundle through phase 4's requests;
10. trains 3 steps of 8,192 rows from one full-width init (dropout 0) on
    the card and, through the plain versions, on the CPU, and compares
    the loss trajectories and the params;
11. holds the training kernels (flash CE forward and fused backward,
    DCN backward) against their plain versions at the training shapes
    and times them as in phase 6, then profiles a full train step with
    and without the flash kernels at batch 4,096 and 8,192 as phase 7
    profiles a request;
12. evaluates the phase 8 bundle with ``python -m recsys_tpu_torch.evaluate
    --filter_seen --rerank_candidates 200 --device cuda`` (the per-batch
    seen mask and the two-stage rerank through the DCN kernel);
13. large-catalog serving: a full-width bundle of 1,048,576 items (above
    the service's 1M approximate-search threshold) and 6,040 users from
    ``SEED``, served as in phase 4 through the group-max sieve (the
    blockmax kernel; the launch counters set to 0 just before and read
    just after) and then with ``int8_catalog=True``, each held against the
    same bundle served on the CPU; the recall@10 of the sieve against the
    exact fp32 top-k, and both routes' requests profiled as in phase 7;
14. holds the blockmax kernel against its plain version at the served
    shapes (Q in {1, 64}, N = 1,048,576, d = 128, groups of 512), at
    Q = 4,096, N = 8,388,608, and at ragged edge cases, timed as in phase
    6, with the whole ``blockmax_topk`` timed against ``flash_topk``;
15. ``evaluate(filter_seen=True)`` of the 1M-item model on a seeded
    synthetic log, where k + max_seen > 256 and the dense scores would pass
    1 GiB, so the exact blockwise scan runs on the card, held against the
    same evaluation through the dense per-batch mask;
16. prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
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
BF16_FLOPS = 989e12  # dense tensor-core rate
SFU_EXP_PER_CLOCK_PER_SM = 16  # exponentials on the special-function units
TOPK_TOL = 1e-5  # fp32 scores in [-1, 1]: summation order only
DCN_TOL = 1e-5   # relative to max(1, max|ref|) (backward: own max|ref|): summation order
SERVE_TOL = 2e-3  # GPU vs CPU rerank score: one bf16 ulp of the DCN output
# flash CE kernels against their plain versions, each output relative to
# its own max|ref|: fp32 sums in another order (bf16 products are exact
# in fp32), so 1e-5 for lse, the positive logit, dcol (summed from the
# fp32 p*g) and every output of fp32 operands
FLASH_TOL = 1e-5
# dU and dV of bf16 operands: both round p*g to bf16 before the products,
# and where the two logits differ in their last fp32 bit a p*g can round
# to the neighbouring bf16 value, moving one term of a sum by up to 2**-7
# of itself; no single term comes near the largest output. A dropped or
# wrong dU or dV is off by the order of the output itself.
FLASH_BF16_GRAD_TOL = 2.0 ** -8
N_TRAIN, N_VAL = 200_000, 25_000
TRAIN_BATCH = 8192
TRAIN_EPOCHS = 2
ZIPF_EXPONENT = 1.0  # item popularity ~ rank**-1
PARITY_STEPS = 3
# card (kernels) against CPU (plain versions) after 3 adagrad steps from
# one init: the loss to 1e-3 relative; each param to 2e-4 absolute, about
# 2% of the largest possible move of 3 steps (3 * lr / sqrt(0.1) = 9.5e-3):
# the sums run in other orders and single bf16 roundings of activations
# and gradients can land one ulp apart (2**-8 relative)
PARITY_LOSS_RTOL = 1e-3
PARITY_PARAM_ATOL = 2e-4
LARGE_N_ITEMS = 1 << 20  # above the service's approx_search_threshold of 1M
BIG_Q, BIG_N = 4096, 1 << 23
# blockmax kernel against its plain version, relative to max|ref|: fp32
# sums of exact bf16 (or fp32) products in another order
BLOCKMAX_TOL = 1e-5
# the seen-filtered evaluation of the 1M-item model: a log whose heaviest
# users have HEAVY_SEEN items, so k + max_seen passes 256, and batches of
# EVAL_BATCH users, so B * N passes the per-batch-mask limit (2**29) and
# Q * N * 4 bytes the dense-scores cap (1 GiB)
HEAVY_SEEN = 600
EVAL_BATCH = 1024
EVAL_ROWS = 2048


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
    device work of kernels whose name holds ``kernel``), both None when the
    profiler recorded no device work (at Q = 4,096, N = 8,388,608 it has
    recorded none for the blockmax kernel's 0.4 s launches)."""
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
    if total == 0:  # the profiler recorded nothing: not measured, not zero
        return None, None
    return total / 1e3 / iters, named / 1e3 / iters


def bound_ms(n_bytes: float, n_ops: float, flops: float = FP32_FLOPS,
             n_exp: float = 0.0, exp_per_s: float = 1.0):
    """The least time of a call: the larger of its bytes over the HBM rate
    and its operations (products at ``flops``, exponentials at
    ``exp_per_s``, whichever takes longer)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(n_ops / flops, n_exp / exp_per_s)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def serve_main_path(bundle: str, counters, n_items: int = N_ITEMS, ref=None,
                    **svc_kw) -> dict:
    """Phase 4: the served requests, with every kernel counter set to 0
    just before and read just after, held against the same bundle served
    on the CPU (``ref``, loaded here with ``svc_kw`` when not given)."""
    import numpy as np
    from recsys_tpu_torch.serve.app import make_http_server
    from recsys_tpu_torch.serve.service import RecommendationService

    svc = RecommendationService(bundle, rerank_candidates=RERANK, device="cuda",
                                **svc_kw).load()
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
        check(code == 200 and body["n_users"] == N_USERS and body["n_items"] == n_items,
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
    if ref is None:
        ref = RecommendationService(bundle, rerank_candidates=RERANK, device="cpu",
                                    **svc_kw).load()
    err = same_ranking(served_known, ref.recommend(known, 10), SERVE_TOL, "known user")
    for res, want in zip(served_batch, ref.recommend_batch(batch, 10)):
        err = max(err, same_ranking(res["recommendations"], want["recommendations"],
                                    SERVE_TOL, f"batch user {res['user_id']}"))
    log(f"served rankings match the CPU plain path: max score diff {err:.3g} "
        f"(tol {SERVE_TOL})")
    return {"launches": launches, "latency": latency, "service": svc, "batch": batch,
            "ref": ref, "max_score_diff": err}


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


# ---- training -----------------------------------------------------------

def synthetic_bundle(seed: int) -> dict:
    """A MovieLens-1M-sized bundle in the JAX package's keys: 6,040 users,
    3,883 items with Zipf-skewed popularity, 200,000 train and 25,000 val
    and test rows; ratings from 8-dim random user and item factors plus
    noise, so the heads have something to learn."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pop = np.arange(1, N_ITEMS + 1, dtype=np.float64) ** -ZIPF_EXPONENT
    pop = pop[rng.permutation(N_ITEMS)]
    pop /= pop.sum()
    n = N_TRAIN + 2 * N_VAL
    users = rng.integers(0, N_USERS, n).astype(np.int32)
    items = rng.choice(N_ITEMS, n, p=pop).astype(np.int32)
    fu = rng.standard_normal((N_USERS, 8))
    fi = rng.standard_normal((N_ITEMS, 8))
    score = (fu[users] * fi[items]).sum(axis=1) / np.sqrt(8.0)
    rating = np.clip(np.rint(3.5 + score + 0.5 * rng.standard_normal(n)), 1, 5)
    rating = rating.astype(np.float32)
    bundle = {"meta/n_users": np.int64(N_USERS), "meta/n_movies": np.int64(N_ITEMS),
              "meta/user_raw_ids": np.arange(1, N_USERS + 1, dtype=np.int64),
              "meta/movie_raw_ids": np.arange(1, N_ITEMS + 1, dtype=np.int64)}
    bounds = {"train": (0, N_TRAIN), "val": (N_TRAIN, N_TRAIN + N_VAL),
              "test": (N_TRAIN + N_VAL, n)}
    for split, (lo, hi) in bounds.items():
        bundle[f"{split}/user_id"] = users[lo:hi]
        bundle[f"{split}/movie_id"] = items[lo:hi]
        bundle[f"{split}/rating"] = rating[lo:hi]
        bundle[f"{split}/y_implicit"] = (rating[lo:hi] >= 4.0).astype(np.float32)
    return bundle


def train_main_path(bundle: dict, counters, out_dir: str) -> dict:
    """Phase 8: ``Trainer.train`` on the card at the full-width defaults,
    every kernel counter set to 0 just before and read just after."""
    import json as _json
    import math

    import torch
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig
    from recsys_tpu_torch.train.trainer import Trainer

    cfg = RecsysConfig(model=ModelConfig(),
                       train=TrainConfig(batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS))
    trainer = Trainer(cfg, out_dir, device="cuda")
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    report = trainer.train(bundle)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.name: c.read() for c in counters}
    with open(os.path.join(out_dir, "detailed_metrics.json")) as f:
        hist = _json.load(f)["epochs"]
    check(len(hist) == TRAIN_EPOCHS, f"train: {len(hist)} epochs logged")
    for e in hist:
        for k in ("train_loss", "val_loss", "train_retrieval_loss"):
            check(math.isfinite(e[k]), f"train: epoch {e['epoch']} {k} = {e[k]}")
    check(hist[-1]["train_loss"] < hist[0]["train_loss"],
          f"train: loss did not fall ({hist[0]['train_loss']} -> {hist[-1]['train_loss']})")
    for rel in ("metrics.json", "training_log.csv", "config.json", "serving/model.npz",
                "serving/encoder.npz", "serving/index.npz", "serving/vocabs.json",
                "serving/config.json"):
        check(os.path.exists(os.path.join(out_dir, rel)), f"train: {rel} missing")
    ckpts = [n for n in os.listdir(os.path.join(out_dir, "checkpoints"))
             if n.startswith("ckpt_")]
    check(len(ckpts) == TRAIN_EPOCHS, f"train: checkpoints {ckpts}")
    check(math.isfinite(report["recall@10"]) and 0.0 <= report["recall@10"] <= 1.0,
          f"train: recall@10 {report['recall@10']}")
    steps = N_TRAIN // TRAIN_BATCH
    last = hist[-1]
    return {"launches": launches, "wall_s": wall, "steps_per_epoch": steps,
            "epoch_losses": [e["train_loss"] for e in hist],
            "val_losses": [e["val_loss"] for e in hist],
            # host clock around each epoch, ending in a device sync;
            # epoch 0 carries the lazy CUDA / cuBLAS set-up
            "steps_per_s": [steps / e["epoch_time_s"] for e in hist],
            "examples_per_s": [e["examples_per_s"] for e in hist],
            "last_epoch_time_s": last["epoch_time_s"],
            "recall@10": report["recall@10"], "ctr_auc": report.get("ctr_auc"),
            "rating_rmse": report["rating_rmse"]}


def _batches(bundle: dict, n_steps: int, b: int, device: str, log_q) -> list:
    import torch

    out = []
    for i in range(n_steps):
        sl = slice(i * b, (i + 1) * b)
        batch = {c: torch.as_tensor(bundle[f"train/{c}"][sl]).to(device)
                 for c in ("user_id", "movie_id", "rating", "y_implicit")}
        batch["log_q"] = torch.as_tensor(log_q[bundle["train/movie_id"][sl]]).to(device)
        out.append(batch)
    return out


def _log_q(bundle: dict):
    import numpy as np

    pop = np.bincount(bundle["train/movie_id"], minlength=N_ITEMS).astype(np.float32)
    return np.log(np.maximum(pop, 0.5) / len(bundle["train/movie_id"])).astype(np.float32)


def train_parity(bundle: dict, tmp: str) -> dict:
    """Phase 10: 3 steps from one full-width init on the card (kernels)
    and on the CPU (plain versions), the same batches, dropout 0."""
    import numpy as np
    import torch
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig
    from recsys_tpu_torch.models.losses import balanced_class_weights
    from recsys_tpu_torch.models.multitask import MultiTaskModel
    from recsys_tpu_torch.train.checkpoint import params_from_numpy, params_to_numpy
    from recsys_tpu_torch.train.optimizer import leaves_with_paths
    from recsys_tpu_torch.train.trainer import Trainer

    cfg = RecsysConfig(model=ModelConfig(dropout_rate=0.0, use_flash_ce=True),
                       train=TrainConfig(batch_size=TRAIN_BATCH))
    init = params_to_numpy(MultiTaskModel.init(torch.Generator().manual_seed(SEED + 2),
                                               cfg.model, N_USERS, N_ITEMS, "cpu"))
    cw = balanced_class_weights(bundle["train/y_implicit"])
    log_q = _log_q(bundle)
    runs = {}
    for device in ("cuda", "cpu"):
        tr = Trainer(cfg, os.path.join(tmp, f"parity_{device}"), device=device)
        state = tr.state_from_params(params_from_numpy(init, device), SEED)
        step = tr._step_core(cw)
        t0 = time.perf_counter()
        loss = []
        for batch in _batches(bundle, PARITY_STEPS, TRAIN_BATCH, device, log_q):
            state, m = step(state, batch)
            loss.append(float(m["loss"]))
        runs[device] = {"loss": loss, "s": time.perf_counter() - t0,
                        "params": dict(leaves_with_paths(params_to_numpy(state.params)))}
    gpu, cpu = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gpu["loss"], cpu["loss"]))
    check(loss_err <= PARITY_LOSS_RTOL,
          f"parity: loss {gpu['loss']} vs CPU {cpu['loss']} ({loss_err} > {PARITY_LOSS_RTOL})")
    param_err, worst = 0.0, ""
    for path, want in cpu["params"].items():
        err = float(np.abs(gpu["params"][path] - want).max())
        if err > param_err:
            param_err, worst = err, "/".join(path)
    moved = max(float(np.abs(cpu["params"][p] - np.asarray(v)).max())
                for p, v in leaves_with_paths(init))
    check(param_err <= PARITY_PARAM_ATOL,
          f"parity: params differ by {param_err} at {worst} > {PARITY_PARAM_ATOL}")
    return {"loss_card": gpu["loss"], "loss_cpu": cpu["loss"], "loss_max_rel_err": loss_err,
            "param_max_abs_err": param_err, "param_worst": worst,
            "param_max_move": moved, "card_s": gpu["s"], "cpu_s": cpu["s"]}


def _errs(got, want) -> tuple:
    """-> (max |got - want|, the same over max |want|), over the pairs."""
    abs_err = [float((a - b).abs().max()) for a, b in zip(got, want)]
    rel_err = [e / max(float(b.abs().max()), 1e-30) for e, b in zip(abs_err, want)]
    return max(abs_err), rel_err


def check_flash(u, v, c, ids_q, ids_k, pos, g) -> dict:
    """Both flash CE kernels against their plain versions on the same
    inputs, each output relative to its own max|ref|: lse, positive logit
    and dcol within FLASH_TOL; dU and dV within FLASH_TOL for fp32
    operands and FLASH_BF16_GRAD_TOL for bf16 ones. -> max absolute and
    relative errors, and the reference lse."""
    import torch
    from recsys_tpu_torch.ops import flash_ce as F

    lse, pl = F.flash_ce_fwd(u, v, c, ids_q, ids_k, pos)
    torch.cuda.synchronize()
    rl, rp = F.flash_ce_fwd_reference(u, v, c, ids_q, ids_k, pos)
    what = f"flash CE Bq={u.shape[0]} Bk={v.shape[0]} D={u.shape[1]} {u.dtype}"
    fwd_abs, fwd_rel = _errs((lse, pl), (rl, rp))
    check(bool(torch.isfinite(lse).all()), f"{what}: non-finite lse")
    check(max(fwd_rel) <= FLASH_TOL, f"{what}: forward err {fwd_rel} > {FLASH_TOL}")
    got = F.flash_ce_bwd(u, v, c, ids_q, ids_k, pos, rl, g)
    torch.cuda.synchronize()
    want = F.flash_ce_bwd_reference(u, v, c, ids_q, ids_k, pos, rl, g)
    bwd_abs, bwd_rel = _errs(got, want)
    grad_tol = FLASH_BF16_GRAD_TOL if u.dtype == torch.bfloat16 else FLASH_TOL
    check(all(bool(torch.isfinite(t).all()) for t in got), f"{what}: non-finite grads")
    for name, err, tol in zip(("dU", "dV", "dcol"), bwd_rel, (grad_tol, grad_tol, FLASH_TOL)):
        check(err <= tol, f"{what}: {name} err {err} of max|ref| > {tol}")
    return {"fwd_abs": fwd_abs, "fwd_rel": max(fwd_rel), "bwd_abs": bwd_abs,
            "bwd_rel": dict(zip(("dU", "dV", "dcol"), bwd_rel)), "lse": rl}


def check_dcn_bwd(x0, w, b, g) -> tuple:
    """The DCN backward kernel against its plain version: dx0, dw and db
    each within DCN_TOL of its own max|ref| -> (max absolute error, max
    relative error)."""
    import torch
    from recsys_tpu_torch.ops import dcn_cross as D

    out, resid = D._forward(x0, w, b, keep_resid=True)
    got = D.dcn_cross_bwd(x0, w, resid, g)
    torch.cuda.synchronize()
    want = D.dcn_cross_bwd_reference(x0, w, resid, g)
    abs_err, rel_err = _errs(got, want)
    what = f"dcn bwd n={x0.shape[0]} F={x0.shape[1]} L={w.shape[0]}"
    check(all(bool(torch.isfinite(t).all()) for t in got), f"{what}: non-finite")
    check(max(rel_err) <= DCN_TOL, f"{what}: max err {rel_err} > {DCN_TOL}")
    return abs_err, max(rel_err)


def check_train_edges() -> None:
    """Edge cases of the training kernels on the card, before any timing:
    ragged Bq and Bk, Bk != Bq (rectangular, one candidate), every padded
    width D, both operand types, many accidental hits, backward blocks
    that sweep several candidate tiles (at small shapes and at 32,768
    rows); ragged rows, one layer and F = 1024 in the DCN backward."""
    import torch
    from recsys_tpu_torch.ops import flash_ce as F

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    ints = lambda hi, n: torch.randint(0, hi, (n,), generator=g, device="cuda",
                                       dtype=torch.int32)
    cap = F._FUSED_BWD_PARTIALS_CAP
    for bq, bk, d, dt in ((70, 70, 16, torch.float32), (100, 230, 128, torch.bfloat16),
                          (300, 300, 200, torch.float32), (65, 1, 8, torch.float32),
                          (129, 64, 64, torch.bfloat16), (33, 100, 256, torch.bfloat16)):
        pos = (torch.arange(bq, device="cuda", dtype=torch.int32) % bk).contiguous()
        args = ((rnd(bq, d) * d ** -0.5).to(dt), rnd(bk, d).to(dt), rnd(bk),
                ints(max(2, bk // 3), bq), ints(max(2, bk // 3), bk), pos, rnd(bq))
        check_flash(*args)
        # caps of one and two partials: each backward block sweeps several
        # candidate tiles (the last block fewer), as above ~24.5k rows at
        # the real cap
        for parts in (1, 2):
            F._FUSED_BWD_PARTIALS_CAP = parts * bq * d * 4
            try:
                check_flash(*args)
            finally:
                F._FUSED_BWD_PARTIALS_CAP = cap
    # the wide-span backward at the real cap: 32,768 rows, 2 tiles a block
    b = 32768
    check(F.bwd_tiles_per_block(b, b, 128) == 2, "B = 32,768: want 2 tiles a block")
    args = ((rnd(b, 128) * 128 ** -0.5).to(torch.bfloat16),
            (rnd(b, 128) * 128 ** -0.5).to(torch.bfloat16), rnd(b),
            ints(N_ITEMS, b), ints(N_ITEMS, b),
            torch.arange(b, device="cuda", dtype=torch.int32))
    grad = rnd(b)
    errs = check_flash(*args, grad)
    bwd_ms = time_ms(lambda: F.flash_ce_bwd(*args, errs["lse"], grad), iters=3, warmup=1)
    log(f"flash CE backward at B = {b}, 2 tiles a block: max rel err "
        f"{errs['bwd_rel']}, {bwd_ms:.3f} ms")
    del args, errs
    torch.cuda.empty_cache()
    for n, f, n_layers in ((37, 256, 3), (1, 24, 1), (1000, 100, 2), (5, 1024, 3)):
        check_dcn_bwd(rnd(n, f), rnd(n_layers, f) * f ** -0.5, rnd(n_layers, f) * 0.1,
                      rnd(n, f))
    log("training-kernel edge cases agree with the plain versions")


def measure_flash(bundle: dict, b: int, dtype, iters: int, sm_clock_mhz: float) -> tuple:
    """The flash CE kernels at Bq = Bk = b, D = 128, with the ids of the
    first b train rows (Zipf: many accidental hits): -> (forward row,
    backward row)."""
    import torch
    from recsys_tpu_torch.ops import flash_ce as F

    d = 128
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    u = (torch.randn((b, d), generator=g, device="cuda") * d ** -0.5).to(dtype)
    v = (torch.randn((b, d), generator=g, device="cuda") * d ** -0.5).to(dtype)
    c = torch.randn((b,), generator=g, device="cuda")
    ids = torch.as_tensor(bundle["train/movie_id"][:b], device="cuda").int()
    pos = torch.arange(b, device="cuda", dtype=torch.int32)
    gr = torch.rand((b,), generator=g, device="cuda") / b
    errs = check_flash(u, v, c, ids, ids, pos, gr)
    lse = errs["lse"]
    elt = u.element_size()
    flops = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    exp_rate = SFU_EXP_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0) \
        .multi_processor_count * sm_clock_mhz * 1e6
    shape = {"Bq": b, "Bk": b, "D": d, "dtype": str(dtype).replace("torch.", "")}
    rows = []
    for kind in ("fwd", "bwd"):
        if kind == "fwd":
            kernel = lambda: F.flash_ce_fwd(u, v, c, ids, ids, pos)
            plain = lambda: F.flash_ce_fwd_reference(u, v, c, ids, ids, pos)
            library = lambda: torch.logsumexp(torch.matmul(u, v.T) + c, dim=1)
            n_bytes = 2 * b * d * elt + 4 * b * 4 + 8 * b
            n_ops, name = 2.0 * b * b * d, "flash_ce_fwd_kernel"
            err, rel = errs["fwd_abs"], errs["fwd_rel"]
        else:
            kernel = lambda: F.flash_ce_bwd(u, v, c, ids, ids, pos, lse, gr)

            def plain():
                return F.flash_ce_bwd_reference(u, v, c, ids, ids, pos, lse, gr)

            def library():
                p = torch.softmax(torch.matmul(u, v.T) + c, dim=1) * gr[:, None]
                pd = p.to(u.dtype)
                return pd @ v, pd.T @ u, p.sum(dim=0)

            n_bytes = 2 * b * d * elt + 6 * b * 4 + (2 * b * d + b) * 4
            n_ops, name = 6.0 * b * b * d, "flash_ce_bwd_kernel"
            err, rel = errs["bwd_abs"], errs["bwd_rel"]
        b_ms, b_by = bound_ms(n_bytes, n_ops, flops, n_exp=float(b) * b, exp_per_s=exp_rate)
        dev_ms, dev_kernel_ms = device_ms(kernel, iters, kernel=name)
        rows.append({
            "shape": shape, "max_abs_err": err, "max_rel_err": rel,
            "ms": time_ms(kernel, iters),
            "plain_ms": time_ms(plain, iters), "library_ms": time_ms(library, iters),
            "bound_ms": b_ms, "bound_by": b_by, "device_ms": dev_ms,
            "kernel_device_ms": dev_kernel_ms, "plain_device_ms": device_ms(plain, iters)[0],
        })
    return rows[0], rows[1]


def measure_dcn_bwd(n: int, iters: int) -> dict:
    import torch
    from recsys_tpu_torch.ops import dcn_cross as D

    f, n_layers = 256, 3
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    x0 = torch.randn((n, f), generator=g, device="cuda")
    w = torch.randn((n_layers, f), generator=g, device="cuda") * f ** -0.5
    b = torch.randn((n_layers, f), generator=g, device="cuda") * 0.1
    gr = torch.randn((n, f), generator=g, device="cuda")
    err, rel = check_dcn_bwd(x0, w, b, gr)
    _, resid = D._forward(x0, w, b, keep_resid=True)
    kernel = lambda: D.dcn_cross_bwd(x0, w, resid, gr)
    plain = lambda: D.dcn_cross_bwd_reference(x0, w, resid, gr)
    n_bytes = 4 * ((2 + n_layers) * n * f + n_layers * f) + 4 * (n * f + 2 * n_layers * f)
    b_ms, b_by = bound_ms(n_bytes, 11.0 * n * n_layers * f)
    return {
        "shape": {"n": n, "F": f, "L": n_layers}, "max_abs_err": err, "max_rel_err": rel,
        "ms": time_ms(kernel, iters), "plain_ms": time_ms(plain, iters),
        "library_ms": None,  # no single PyTorch call computes this VJP
        "bound_ms": b_ms, "bound_by": b_by, "device_ms": device_ms(kernel, iters)[0],
        "plain_device_ms": device_ms(plain, iters)[0],
    }


def profile_call(name: str, fn, n_wall: int = 50, n_traced: int = 20,
                 warmup: int = 5) -> dict:
    """Host clock of ``n_wall`` calls of ``fn`` with the profiler off
    (median and p90, each call ending in a device sync), then a traced
    window of ``n_traced`` calls: device time per call, the device's busy
    share of the traced wall time, launches per call and the kernels that
    take the time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    walls = []
    for _ in range(n_wall):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()  # after the profiler's own start-up
        for _ in range(n_traced):
            fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / n_traced
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in device) / 1e3 / n_traced
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {
        "profile": name, "n": len(walls),
        "wall_ms_p50": walls[len(walls) // 2], "wall_ms_p90": walls[int(len(walls) * 0.9)],
        "traced_wall_ms": traced_ms, "device_ms": dev_ms,
        "device_busy_share": dev_ms / traced_ms,
        "device_launches": sum(e.count for e in device) // n_traced,
        "top_device_us": [[e.key[:60], e.self_device_time_total / n_traced] for e in top],
    }


def profile_requests(svc, batch) -> list:
    """Phase 7: ``recommend`` and a 64-user ``recommend_batch`` through
    the service (no HTTP), profiled by :func:`profile_call`."""
    return [profile_call("recommend_k10", lambda: svc.recommend(1, 10)),
            profile_call("recommend_batch64_k10", lambda: svc.recommend_batch(batch, 10))]


def profile_train_steps(bundle: dict) -> list:
    """One full train step (loss, autograd, adagrad) at batch 4,096 and
    8,192 (the main path's), with the flash kernels and with the dense
    path, profiled by :func:`profile_call`: the step's wall and device
    times that later set ``_FLASH_MIN_CANDIDATES`` on the card."""
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig
    from recsys_tpu_torch.models.losses import balanced_class_weights
    from recsys_tpu_torch.train.trainer import Trainer

    cw = balanced_class_weights(bundle["train/y_implicit"])
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for b in (4096, TRAIN_BATCH):
            batches = _batches(bundle, 2, b, "cuda", _log_q(bundle))
            for flash in (True, False):
                cfg = RecsysConfig(model=ModelConfig(use_flash_ce=flash),
                                   train=TrainConfig(batch_size=b))
                tr = Trainer(cfg, tmp, device="cuda")
                step = tr.make_train_step(cw)
                holder = [tr.init_state(N_USERS, N_ITEMS, SEED)]

                def one():
                    holder[0], _ = step(holder[0], batches[holder[0].step % 2])

                rows.append(profile_call(f"train_step_B{b}_{'flash' if flash else 'dense'}",
                                         one, n_wall=20, n_traced=5, warmup=2))
    return rows


# ---- large-catalog retrieval ----------------------------------------------

def large_catalog_bundle(path: str) -> tuple:
    """A full-width bundle of LARGE_N_ITEMS items and N_USERS users, random
    weights from ``SEED + 6``, written to ``path`` -> (config, params on
    the card)."""
    import numpy as np
    import torch
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig
    from recsys_tpu_torch.models.multitask import MultiTaskModel
    from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
    from recsys_tpu_torch.train.checkpoint import save_inference_bundle

    cfg = RecsysConfig(model=ModelConfig(dropout_rate=0.0))
    params = MultiTaskModel.init(torch.Generator().manual_seed(SEED + 6), cfg.model,
                                 N_USERS, LARGE_N_ITEMS, "cuda")
    item_raw = np.arange(1, LARGE_N_ITEMS + 1)
    index = RetrievalIndex.build(params["towers"], cfg.model, LARGE_N_ITEMS, item_raw,
                                 device="cuda")
    save_inference_bundle(path, params["towers"], cfg, np.arange(1, N_USERS + 1),
                          item_raw, index=index, full_params=params)
    return cfg, params


def _recall(got, want) -> float:
    """Mean share of each ``want`` row's ids found in the ``got`` row."""
    return float(sum(len(set(g) & set(w)) / len(w) for g, w in zip(got, want)) / len(want))


def serve_large_catalog(bundle: str, counters) -> dict:
    """Phase 13: the 1M-item bundle served as in phase 4 through the
    group-max sieve (the service's route above 1M items), then through the
    int8 catalog, each against one CPU service on the same bundle; the
    sieve's recall against the exact fp32 top-k; both routes profiled."""
    import numpy as np
    import torch
    from recsys_tpu_torch.models.towers import TwoTower
    from recsys_tpu_torch.ops.topk_flash import flash_topk
    from recsys_tpu_torch.serve.service import RecommendationService

    t0 = time.perf_counter()
    ref = RecommendationService(bundle, rerank_candidates=RERANK, device="cpu").load()
    out = {"cpu_load_s": time.perf_counter() - t0}
    for route, kw in (("approx", {}), ("int8", {"int8_catalog": True})):
        ref.int8_catalog = route == "int8"
        t0 = time.perf_counter()
        served = serve_main_path(bundle, counters, n_items=LARGE_N_ITEMS, ref=ref, **kw)
        svc = served["service"]
        check(svc._search_route() == route and ref._search_route() == route,
              f"1M items: route {svc._search_route()}, want {route}")
        row = {"launches": served["launches"], "latency": served["latency"],
               "max_score_diff": served["max_score_diff"],
               "serve_and_compare_s": time.perf_counter() - t0,
               "profile": profile_requests(svc, served["batch"])}
        out[route] = row
        log(f"1M items, {route} route: {json.dumps(row)}")
        if route == "approx":
            out["service"], out["batch"] = svc, served["batch"]
            with torch.inference_mode():
                ids = torch.as_tensor([svc.user_id_map[u] for u in served["batch"]],
                                      device="cuda")
                users = TwoTower.user_embed(svc.encoder_params, ids, svc.config.model)
                recall = {}
                for k in (10, RERANK):
                    _, approx_i = svc.index.search(users, k, approx=True)
                    _, exact_i = flash_topk(svc.index._query_ready(users),
                                            svc.index._catalog_ready(), k, normalize=False)
                    _, cpu_i = ref.index.search(users.cpu(), k, approx=True)
                    recall[f"recall@{k}_vs_exact_fp32"] = _recall(approx_i, exact_i.cpu().numpy())
                    recall[f"recall@{k}_vs_cpu"] = _recall(approx_i, cpu_i)
            out["recall"] = recall
            log(f"1M items, sieve recall over {len(served['batch'])} users: {json.dumps(recall)}")
        else:
            del svc, served
    return out


def check_blockmax(u, v, group: int) -> float:
    """The blockmax kernel against its plain version on the same inputs:
    shape, finite, every group max within BLOCKMAX_TOL of max|ref|. -> max
    absolute error."""
    import torch
    from recsys_tpu_torch.ops.topk_flash import (
        blockmax_group_max, blockmax_group_max_reference,
    )

    m = blockmax_group_max(u, v, group)
    torch.cuda.synchronize()
    r = blockmax_group_max_reference(u, v, group)
    what = f"blockmax Q={u.shape[0]} N={v.shape[0]} d={u.shape[1]} g={group} {u.dtype}"
    check(m.shape == r.shape == (u.shape[0], -(-v.shape[0] // group)), f"{what}: shape")
    check(bool(torch.isfinite(m).all()), f"{what}: non-finite")
    err = float((m - r).abs().max())
    tol = BLOCKMAX_TOL * float(r.abs().max())
    check(err <= tol, f"{what}: max err {err} > {tol}")
    return err


def check_blockmax_edges() -> None:
    """Edge cases of the blockmax kernel, before any timing: N not a
    multiple of g, N < g, Q not a multiple of the 64-row tile, fp32
    operands (``bf16=False``) at a ragged width, groups smaller than a
    64-item tile; then the whole ``blockmax_topk`` on the card against the
    CPU plain path, k > N included."""
    import torch
    from recsys_tpu_torch.ops.topk_flash import NEG_INF, blockmax_group_size, blockmax_topk

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    bf = torch.bfloat16
    check_blockmax(rnd(70, 128).to(bf), rnd(3001, 128).to(bf), blockmax_group_size(3001))
    check_blockmax(rnd(5, 128).to(bf), rnd(100, 128).to(bf), blockmax_group_size(100))
    check_blockmax(rnd(33, 129), rnd(5000, 129), 512)
    check_blockmax(rnd(3, 24), rnd(1000, 24), 40)
    for q_n, n, d, k, bf16 in ((70, 3001, 128, 10, True), (4, 50, 16, 80, True),
                               (9, 5000, 64, 200, False)):
        u, v = rnd(q_n, d), rnd(n, d)
        s, i = blockmax_topk(u, v, k, bf16=bf16)
        torch.cuda.synchronize()
        rs, ri = blockmax_topk(u.cpu(), v.cpu(), k, bf16=bf16)
        what = f"blockmax_topk Q={q_n} N={n} k={k} bf16={bf16}"
        s, i = s.cpu(), i.cpu()
        err = float((s - rs).abs().max())
        check(err <= TOPK_TOL, f"{what}: score err {err}")
        real = rs > NEG_INF / 2
        check(bool((real == (s > NEG_INF / 2)).all()) and int(real.sum(1).min()) == min(k, n),
              f"{what}: wrong fill")
        check(bool((i[~real] == 0).all()), f"{what}: padding ids")
        for row_s, row_i, want_i, row_real in zip(s, i, ri, real):
            boundary = float(row_s[row_real][-1])
            clear = row_real & (row_s > boundary + TOPK_TOL)
            check(set(row_i[clear].tolist()) <= set(want_i.tolist()),
                  f"{what}: ids differ beyond ties")
    log("blockmax edge cases agree with the plain versions")


def measure_blockmax(u, v, k: int, iters: int, library: bool) -> dict:
    """Pass 1 at one shape: kernel against plain version, timed with CUDA
    events and in device time, beside its bound and (``library``) one
    ``torch.matmul`` of the upcast operands plus ``amax`` over groups; then
    the whole ``blockmax_topk`` against ``flash_topk`` at k."""
    import torch
    from recsys_tpu_torch.ops.topk_flash import (
        blockmax_group_max, blockmax_group_max_reference, blockmax_group_size,
        blockmax_topk, flash_topk,
    )

    q_n, d = u.shape
    n = v.shape[0]
    grp = blockmax_group_size(n)
    n_groups = -(-n // grp)
    err = check_blockmax(u, v, grp)
    flops = BF16_FLOPS if u.dtype == torch.bfloat16 else FP32_FLOPS
    b_ms, b_by = bound_ms(u.element_size() * (q_n + n) * d + 4 * q_n * n_groups,
                          2.0 * q_n * n * d, flops)
    kernel = lambda: blockmax_group_max(u, v, grp)
    plain = lambda: blockmax_group_max_reference(u, v, grp)
    warm = 1 if iters < 5 else 2
    dev_ms, dev_kernel_ms = device_ms(kernel, iters, kernel="blockmax")
    row = {
        "shape": {"Q": q_n, "N": n, "d": d, "g": grp, "dtype": str(u.dtype).replace("torch.", "")},
        "max_abs_err": err,
        "ms": time_ms(kernel, iters, warm),
        "plain_ms": time_ms(plain, iters, warm),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by,
        "device_ms": dev_ms, "kernel_device_ms": dev_kernel_ms,
        "plain_device_ms": device_ms(plain, iters)[0],
    }
    if library:  # the served shapes only: at 8M items it is a 137 GB matrix
        uf, vf = u.float(), v.float()
        row["library_ms"] = time_ms(
            lambda: torch.matmul(uf, vf.T).view(q_n, n_groups, grp).amax(dim=2), iters, warm)
        del uf, vf
    u32, v32 = u.float(), v.float()
    row["topk_k"] = k
    row["blockmax_topk_ms"] = time_ms(lambda: blockmax_topk(u, v, k, normalize=False),
                                      iters, warm)
    row["flash_topk_ms"] = time_ms(lambda: flash_topk(u32, v32, k, normalize=False),
                                   iters, warm)
    del u32, v32
    torch.cuda.empty_cache()
    return row


def measure_blockmax_shapes(svc, batch) -> list:
    """Phase 14: the kernel at the served shapes (the served bf16 catalog
    and the users of the 64-user batch) and at Q = 4,096, N = 8,388,608."""
    import torch
    from recsys_tpu_torch.models.towers import TwoTower

    with torch.inference_mode():
        ids = torch.as_tensor([svc.user_id_map[u] for u in batch], device="cuda")
        users = svc.index._query_ready(
            TwoTower.user_embed(svc.encoder_params, ids, svc.config.model)).to(torch.bfloat16)
        catalog = svc.index._catalog_bf16()
        rows = [measure_blockmax(users[:q].contiguous(), catalog, RERANK, iters=20,
                                 library=True) for q in (1, BATCH_USERS)]
        g = torch.Generator(device="cuda").manual_seed(SEED + 9)
        big_u = torch.nn.functional.normalize(
            torch.randn((BIG_Q, 128), generator=g, device="cuda"), dim=1).to(torch.bfloat16)
        big_v = torch.nn.functional.normalize(
            torch.randn((BIG_N, 128), generator=g, device="cuda"), dim=1).to(torch.bfloat16)
        rows.append(measure_blockmax(big_u, big_v, 10, iters=2, library=False))
        del big_u, big_v
        torch.cuda.empty_cache()
    return rows


def synthetic_seen_log(seed: int) -> dict:
    """A seeded interaction log over the 1M-item catalog: each user has 1
    to 39 train items, 8 users HEAVY_SEEN; EVAL_ROWS val rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 40, N_USERS)
    counts[rng.choice(N_USERS, 8, replace=False)] = HEAVY_SEEN
    train_u = np.repeat(np.arange(N_USERS), counts).astype(np.int32)
    rating = rng.integers(1, 6, EVAL_ROWS).astype(np.float32)
    return {
        "meta/n_users": np.int64(N_USERS), "meta/n_movies": np.int64(LARGE_N_ITEMS),
        "train/user_id": train_u,
        "train/movie_id": rng.integers(0, LARGE_N_ITEMS, len(train_u)).astype(np.int32),
        "val/user_id": rng.integers(0, N_USERS, EVAL_ROWS).astype(np.int32),
        "val/movie_id": rng.integers(0, LARGE_N_ITEMS, EVAL_ROWS).astype(np.int32),
        "val/rating": rating, "val/y_implicit": (rating >= 4).astype(np.float32),
    }


def eval_large_catalog(cfg, params, counters) -> dict:
    """Phase 15: ``evaluate(filter_seen=True)`` of the 1M-item model, whose
    over-retrieval takes the exact blockwise scan on the card (counted),
    and one batch's seen-filtered ids held against the dense per-batch
    mask's."""
    import math

    import numpy as np
    import torch
    from recsys_tpu_torch.config import EvalConfig
    from recsys_tpu_torch.models.towers import TwoTower
    from recsys_tpu_torch.ops.topk_flash import KBUF_MAX
    from recsys_tpu_torch.retrieval import evaluator, scorer

    log_np = synthetic_seen_log(SEED + 8)
    eval_cfg = EvalConfig(topk=(10,), eval_batch_size=EVAL_BATCH, filter_seen=True)
    seen = evaluator.SeenIndex(log_np["train/user_id"], log_np["train/movie_id"],
                               N_USERS, LARGE_N_ITEMS)
    check(EVAL_BATCH * LARGE_N_ITEMS > evaluator._BATCH_MASK_LIMIT
          and 10 + seen.max_seen > KBUF_MAX
          and EVAL_BATCH * LARGE_N_ITEMS * 4 > scorer._DENSE_SCORES_CAP,
          "eval: the shapes do not reach the blockwise branch")
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    report = evaluator.evaluate(params, cfg.model, log_np, "val", eval_cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.name: c.read() for c in counters}
    check(launches["blockwise_topk"] == -(-EVAL_ROWS // EVAL_BATCH),
          f"eval: blockwise scan ran {launches['blockwise_topk']} times")
    check(launches["topk_scores"] == 0, "eval: the dense k > 256 path ran above the cap")
    check(all(math.isfinite(v) for v in report.values()), f"eval: {report}")
    check(0.0 < report["coverage"] <= 1.0, f"eval: coverage {report['coverage']}")
    # one batch through both branches: equal ids beyond exact ties
    with torch.inference_mode():
        towers = params["towers"]
        items = scorer.materialize_item_embeddings(towers, cfg.model, LARGE_N_ITEMS)
        u_ids = log_np["val/user_id"][:EVAL_BATCH]
        u_emb = TwoTower.user_embed(towers, torch.as_tensor(u_ids, device="cuda"), cfg.model)
        args = (u_emb, items, u_ids, seen, 10, EVAL_BATCH, LARGE_N_ITEMS, True, None)
        over = evaluator._filtered_topk(*args)
        limit = evaluator._BATCH_MASK_LIMIT
        evaluator._BATCH_MASK_LIMIT = EVAL_BATCH * LARGE_N_ITEMS
        try:
            masked = evaluator._filtered_topk(*args)
        finally:
            evaluator._BATCH_MASK_LIMIT = limit
        check(not seen.contains(u_ids[:, None], over).any(), "eval: a seen item survived")
        same = float((over == masked).mean())
        s_over = torch.einsum("bd,bkd->bk", torch.nn.functional.normalize(u_emb, dim=1),
                              torch.nn.functional.normalize(items, dim=1)[
                                  torch.as_tensor(over, device="cuda").long()])
        s_mask = torch.einsum("bd,bkd->bk", torch.nn.functional.normalize(u_emb, dim=1),
                              torch.nn.functional.normalize(items, dim=1)[
                                  torch.as_tensor(masked, device="cuda").long()])
        score_err = float((s_over - s_mask).abs().max())
    check(score_err <= TOPK_TOL, f"eval: the branches' top-10 differ ({score_err})")
    return {"report": report, "wall_s": wall, "launches": launches, "max_seen": seen.max_seen,
            "ids_equal_share": same, "branch_score_diff": score_err}


def evaluate_cli(repo: str, run_dir: str, bundle_np: dict) -> dict:
    """Phase 12: ``python -m recsys_tpu_torch.evaluate --filter_seen
    --rerank_candidates 200 --device cuda`` on the phase 8 bundle."""
    import math

    import numpy as np

    data = os.path.join(run_dir, "bundle.npz")
    np.savez(data, **bundle_np)
    out = os.path.join(run_dir, "eval_report.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "recsys_tpu_torch.evaluate", "--data", data,
         "--model_dir", os.path.join(run_dir, "serving"), "--filter_seen",
         "--rerank_candidates", str(RERANK), "--device", "cuda", "--output", out],
        cwd=repo, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"evaluate CLI: rc {proc.returncode}\n{proc.stderr[-4000:]}")
    with open(out) as f:
        report = json.load(f)
    for key in ("recall@10", "ndcg@10", "coverage", "two_stage_recall@10",
                "two_stage_ndcg@10", "rating_rmse"):
        check(isinstance(report.get(key), float) and math.isfinite(report[key]),
              f"evaluate CLI: {key} = {report.get(key)}")
    check(0.0 <= report["two_stage_recall@10"] <= 1.0, "evaluate CLI: two-stage recall")
    return {"wall_s": wall, "report": report}



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
    from recsys_tpu_torch.ops import flash_ce as flash_mod
    from recsys_tpu_torch.ops import topk as topk_ops
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

    # ---- training: the second main path -----------------------------
    check_train_edges()
    counters += [Counter("flash_ce_fwd", flash_mod.flash_ce_fwd),
                 Counter("flash_ce_bwd", flash_mod.flash_ce_bwd),
                 Counter("dcn_cross_bwd", dcn_mod.dcn_cross_bwd)]
    bundle_np = synthetic_bundle(SEED)
    with tempfile.TemporaryDirectory() as run_dir:
        t0 = time.perf_counter()
        trained = train_main_path(bundle_np, counters, run_dir)
        log(f"trained the main path in {time.perf_counter() - t0:.1f} s: "
            f"{json.dumps(trained)}")
        train_launches = trained["launches"]
        for name in ("flash_ce_fwd", "flash_ce_bwd", "dcn_cross_bwd", "dcn_cross",
                     "topk_flash"):
            check(train_launches[name] > 0, f"{name} never launched while training")
        check(train_launches["topk_scores"] == 0, "the dense k > 256 path ran in training")
        t0 = time.perf_counter()
        served_trained = serve_main_path(os.path.join(run_dir, "serving"), counters)
        log(f"served the trained bundle in {time.perf_counter() - t0:.1f} s: "
            f"launches {served_trained['launches']}")
        check(served_trained["launches"]["topk_flash"] > 0
              and served_trained["launches"]["dcn_cross"] > 0,
              "the trained bundle was not served through the kernels")
        parity = train_parity(bundle_np, run_dir)
        log(f"train parity, card kernels vs CPU plain versions: {json.dumps(parity)}")
        cli_eval = evaluate_cli(repo, run_dir, bundle_np)
        log(f"evaluate CLI on the trained bundle in {cli_eval['wall_s']:.1f} s: "
            f"{json.dumps(cli_eval['report'])}")

    sm_clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    flash_rows = {}
    for b, dt in ((4096, torch.bfloat16), (TRAIN_BATCH, torch.bfloat16),
                  (TRAIN_BATCH, torch.float32)):
        flash_rows[(b, dt)] = measure_flash(bundle_np, b, dt, iters=10, sm_clock_mhz=sm_clock)
    dcn_bwd_rows = [measure_dcn_bwd(n, iters=50) for n in (2048, TRAIN_BATCH)]
    for fwd, bwd in flash_rows.values():
        log(f"kernel flash_ce_fwd {json.dumps(fwd)}")
        log(f"kernel flash_ce_bwd {json.dumps(bwd)}")
    for row in dcn_bwd_rows:
        log(f"kernel dcn_cross_bwd {json.dumps(row)}")
    for row in profile_train_steps(bundle_np):
        log(f"profile {json.dumps(row)}")

    # ---- large-catalog retrieval: the third main path ---------------------
    t_large = time.perf_counter()
    counters += [Counter("blockmax", topk_mod.blockmax_group_max),
                 Counter("blockwise_topk", topk_ops.blockwise_topk, "calls")]
    with tempfile.TemporaryDirectory() as large_dir:
        t0 = time.perf_counter()
        large_cfg, large_params = large_catalog_bundle(large_dir)
        log(f"wrote the {LARGE_N_ITEMS:,}-item bundle in {time.perf_counter() - t0:.1f} s")
        large = serve_large_catalog(large_dir, counters)
    approx_launches = large["approx"]["launches"]
    check(approx_launches["blockmax"] > 0, "the blockmax kernel never launched on the 1M route")
    check(approx_launches["topk_flash"] == 0, "the flash top-k ran on the 1M approx route")
    check(approx_launches["dcn_cross"] > 0, "the DCN kernel never launched on the 1M route")
    int8_launches = large["int8"]["launches"]
    check(int8_launches["blockmax"] == 0 and int8_launches["topk_flash"] == 0,
          f"the int8 route ran a top-k kernel: {int8_launches}")
    check_blockmax_edges()
    t0 = time.perf_counter()
    blockmax_rows = measure_blockmax_shapes(large.pop("service"), large["batch"])
    for row in blockmax_rows:
        log(f"kernel blockmax {json.dumps(row)}")
    log(f"blockmax measured in {time.perf_counter() - t0:.1f} s")
    large_eval = eval_large_catalog(large_cfg, large_params, counters)
    log(f"1M-item evaluate(filter_seen=True): {json.dumps(large_eval)}")
    del large_params
    torch.cuda.empty_cache()
    log(f"large-catalog phases in {time.perf_counter() - t_large:.1f} s")

    main_topk = next(r for r in topk_rows
                     if r["shape"] == {"Q": BATCH_USERS, "N": N_ITEMS, "d": 128, "k": RERANK})
    main_dcn = dcn_rows[-1]
    main_fwd, main_bwd = flash_rows[(TRAIN_BATCH, torch.bfloat16)]
    main_dcn_bwd = dcn_bwd_rows[-1]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": "topk_flash", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/topk_flash.cu",
         "replaces": "recsys_tpu/ops/pallas/topk_flash.py:82",
         "launches": launches["topk_flash"], **{k: main_topk[k] for k in keys},
         "launches_train": train_launches["topk_flash"],
         "shape": main_topk["shape"], "shapes": topk_rows},
        {"name": "dcn_cross", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/dcn_cross.cu",
         "replaces": "recsys_tpu/ops/pallas/dcn_cross.py:43",
         "launches": launches["dcn_cross"], **{k: main_dcn[k] for k in keys},
         "launches_train": train_launches["dcn_cross"],
         "shape": main_dcn["shape"], "shapes": dcn_rows},
        {"name": "dcn_cross_bwd", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/dcn_cross.cu",
         "replaces": "recsys_tpu/ops/pallas/dcn_cross.py:57",
         "launches": train_launches["dcn_cross_bwd"], **{k: main_dcn_bwd[k] for k in keys},
         "shape": main_dcn_bwd["shape"], "shapes": dcn_bwd_rows},
        {"name": "flash_ce_fwd", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/flash_ce.cu",
         "replaces": "recsys_tpu/ops/pallas/flash_ce.py:114",
         "launches": train_launches["flash_ce_fwd"], **{k: main_fwd[k] for k in keys},
         "shape": main_fwd["shape"], "shapes": [r[0] for r in flash_rows.values()]},
        {"name": "flash_ce_bwd", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/flash_ce.cu",
         "replaces": "recsys_tpu/ops/pallas/flash_ce.py:250",
         "launches": train_launches["flash_ce_bwd"], **{k: main_bwd[k] for k in keys},
         "shape": main_bwd["shape"], "shapes": [r[1] for r in flash_rows.values()]},
        {"name": "blockmax", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/blockmax.cu",
         "replaces": "recsys_tpu/ops/pallas/topk_flash.py:274",
         "launches": approx_launches["blockmax"], **{k: blockmax_rows[1][k] for k in keys},
         "shape": blockmax_rows[1]["shape"], "shapes": blockmax_rows},
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
