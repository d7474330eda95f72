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
   "auto" policy takes the flash CE kernels there, on bf16 operands: the
   forward and rows 6 and 7), with the launch counters set to 0 just
   before and read just after; checks the losses, the artifacts and that
   every training kernel launched; then one epoch with fp32 retrieval
   operands (``mixed_precision=False, bf16_retrieval_logits=False``),
   whose forward is row 4's FMA kernel and whose backward the fused
   kernel (row 5's FMA kernel), with its steps/s;
9. serves the trained bundle through phase 4's requests;
10. trains 3 steps of 8,192 rows from one full-width init (dropout 0) on
    the card and, through the plain versions, on the CPU, and compares
    the loss trajectories and the params;
11. holds the training kernels (flash CE forward and fused backward,
    DCN backward) against their plain versions at the training shapes
    (before phase 8: row 5 of fp32 operands at its edges, D of 24 to 256,
    ragged Bq and Bk, one candidate, all-accidental rows, and 65,536^2,
    two calls bit-equal; rows 4 and 6 of fp32 operands at theirs, the
    same widths, ragged shapes off their 128-row blocks and 64- and
    128-candidate tiles, one candidate, row 0's positive in the last part,
    all-accidental rows, 8,192^2 in 8 parts and 65,536 x 4,096 in one,
    two calls bit-equal, the positive logit of 8 parts bit-equal to that
    of one) and times them as in phase 6, then profiles a full train step
    with and without the flash kernels at batch 4,096 and 8,192, and the
    fp32 steps at 8,192 (the fp32 epoch's) and 20,000 (where the TPU's
    partials pass its cap), both on rows 4 and 5, each with the device ms
    and launches of every flash kernel and the backward its wrappers took,
    as phase 7 profiles a request;
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
    Q = 4,096, N = 8,388,608, and at edge cases of the tensor-core path
    (bf16 at d in {64, 128, 129}, N not a multiple of g, Q in {1, 15, 17,
    65}) and of the fp32 one, checks that two calls give the same bits,
    times it as in phase 6, and the whole ``blockmax_topk`` against
    ``flash_topk``;
15. ``evaluate(filter_seen=True)`` of the 1M-item model on a seeded
    synthetic log, where k + max_seen > 256 and the dense scores would pass
    1 GiB, so the exact blockwise scan runs on the card, held against the
    same evaluation through the dense per-batch mask;
16. holds kernel rows 6 and 7 (the two-kernel flash backward, through
    ``flash_ce_bwd_twokernel``) against their plain versions at Bq = Bk =
    8,192, D = 128 in bf16 and fp32, at 4,096 x 20,480 bf16, at a ragged
    1,000 x 3,001, D = 129, fp32, and at the edges of row 6's tensor-core
    path (bf16 at D in {32, 64, 128, 129, 256}, ragged Bq and Bk), checks
    that two calls of row 6 give the same bits, and times them at 8,192
    bf16 and fp32 as in phase 6; holds the tensor-core kernels of rows 4 and 7
    against their plain versions at their edges (D in {24, 32, 64, 128,
    129, 256}, Bq and Bk not multiples of 16 or 64, one candidate, a
    positive column in the forward's last part, rows whose every other
    candidate is an accidental hit) and checks that two calls of each give
    the same bits; holds row 7 of fp32 operands against its plain version
    at its edges (before phase 8: D of 24 to 256, ragged, one candidate,
    all-accidental rows, 8,192^2 in 8 parts, the same call in 2 parts
    bit-equal to the sum of its parts' rows in one); at 20,000^2 in fp32
    checks that ``flash_ce_bwd`` takes the fused kernel (its wrapper
    launches, rows 6 and 7 do not), holds it and rows 6 + 7 (called
    directly) against the plain backward and times rows 6 and 7 beside
    their yardsticks;
17. above the partials cap (Bq = 131,072, Bk = 262,144, D = 128, bf16):
    the route is the two-kernel one; the forward, rows 6 and 7 and the
    fused kernel agree with their plain versions (chunked over query rows,
    ~1 GiB of logits at a time) and the two routes with each other; the
    forward and rows 6 and 7 are timed beside their device time and bound;
    then both routes are timed in turns, with their peak memory, in bf16
    and in fp32, at the
    ``ROUTE_SHAPES`` under and above the cap (the table behind
    ``flash_ce.bwd_route``);
18. trains the giant-table configuration through ``Trainer.train``: the
    full-width ``ModelConfig``, 4,000,000 users x 2,000,000 items (the
    tables of ``benchmarks/results/scale.json``'s ``"train"`` row),
    batch 131,072, a CBNS cache of 131,072 rows, adagrad with "auto"
    sparse table updates, one epoch of 8 steps on a seeded bundle (Zipf
    items, uniform users, 65,536 val rows), with the launch counters set
    to 0 just before and read just after: rows 6 and 7 once per step, the
    fused backward never, the sparse step every time, and the cache's
    FIFO holding the last batch's ids; the final evaluation and serving
    bundle as ``train`` writes them;
19. profiles whole steps of that configuration (device ms by kernel,
    launches, busy share, the sparse update's span);
20. runs 3 steps of a small-width model (embedding 32, tables of 5,000 x
    3,000, B = 2,048, cache 6,144, sparse adagrad; bf16 operands, so rows
    6 and 7) on the card and through the plain versions on the CPU, and
    compares them as phase 10 does;
21. times a step of the scale.json ``"train"`` row itself (dim 64, B =
    4,096) with adagrad and adam, sparse (lazy Adam) and dense;
22. the data-and-features path and export: writes ML-1M-shaped
    ``movies.dat`` and ``users.dat`` from ``SEED`` (3,883 movies, one
    latin-1 title, some titles without a year; 6,040 users), runs
    ``python -m recsys_tpu_torch.preprocess`` (1,000,209 synthesized
    ratings; its QA report checked), then the train CLI's ``main`` with
    ``--use_dense_features --use_side_features`` at the flagship widths
    (the DCN input F = 289, so the cross stack's backward runs its
    shared-memory kernel at F % 4 = 1), B = 8,192, 2 epochs, with the
    launch counters set to 0 just before and read just after; serves the
    bundle as in phase 4 (rerank 200 with the host-side features, held
    against the CPU), profiles those requests and times the host's
    ``transform_scaled``; runs the evaluate CLI's ``main`` (rerank 200,
    seen-filtered); exports top-200 through the export CLI's ``main`` and
    holds the artifact on the card and on the CPU against the service's
    exact route, serves ``backend="exported"`` with rerank (on the host,
    through ``_FastRerank``) against itself served on the CPU, its
    distance to the device rerank recorded, checks that a rebuilt
    ``index.npz`` is refused, and
    profiles the exported retrieve against the exact route at 1 and 64
    users; times rows 2 and 3 at F = 289 as in phase 6 and profiles the
    dense-feature train step;
23. explicit negatives and the streaming input path on phase 22's
    bundle at the flagship widths (``ModelConfig`` defaults, mixed
    precision), B = 8,192, one epoch each through the train CLI's
    ``main``: (a) ``--negative_sampling mixed`` (20 + 30 negatives a row),
    resident; (b) ``--negative_sampling mined --mined_from`` phase 22's
    serving bundle at ``explicit_negatives_weight`` 0.1, the mining timed
    apart; (c) mixed negatives streamed (``device_resident_data=false``)
    at 32 steps a transfer with a checkpoint every 16 steps, and at one
    step a transfer; each with the launch counters set to 0 just before
    and read just after (rows 2, 3, 4, 6 and 7 launch, row 3 once a step),
    finite losses, the serving bundle and the mid-epoch checkpoints
    checked; (d) 3 streaming steps with fed negatives on the card against
    the CPU, held as in phase 10; then profiles the explicit-negatives
    step, the same step without negatives and the streaming step (the
    host's Batcher gather and ``sample_batch`` timed apart);
24. the rest of serving on phase 22's trained bundle (F = 289, rerank
    200): (a) 16 client threads each send 20 single-user ``/recommend``
    requests (k of 5 and 10) to the threaded server with no batcher and
    then with ``microbatch`` 64, (b) and to the asyncio server, every
    answer held against the service's direct ``recommend`` (ids beyond
    ties, scores within ``SERVE_TOL``), the batchers' largest batch above
    1, the counters set to 0 just before each batched load and read just
    after (rows 1 and 2 launch), QPS, p50 and p90 recorded; (c)
    ``/admin/reload`` under the micro-batcher on a copy of the bundle (a
    negated catalog changes the answer, the restored one brings it back,
    the old batcher stops, ``torch.cuda.memory_allocated`` within 10%
    over the two reloads) and a degraded start that gains its service on
    reload; (d) ``backend="native"`` with and without features
    (``_FastRerank`` active, equal to its own exact host path to 1e-4 /
    1e-5; its top-10 overlap and score distance to the device backend
    recorded; the native library built into ``build/``; ``recommend``
    and the 64-user batch timed beside the device backend's, the batch's
    retrieval and rerank apart); (e)
    ``python -m recsys_tpu_torch.serve --workers 2 --microbatch 64
    --rerank_candidates 200 --device cuda``: healthy, 40 answers as
    in (a), the whole tree reaped on SIGTERM within 30 s; (f) the
    Batcher's native gather bit-equal to numpy at phase 23's shapes, both
    timed;
25. the mesh and the sharded catalog on a one-rank NCCL group that
    ``make_mesh`` starts (each collective checked there once): (a) phase
    13's 1,048,576-item bundle, made again from its seed, through
    ``RetrievalIndex.shard``, fp32 and int8, 1 and 64 users at k = 10 and
    200, fp32 against ``flash_topk`` over the whole catalog and the CPU's
    plain version (scores within ``TOPK_TOL``, ids beyond ties), int8
    against ``blockwise_topk_int8`` over the same int8 rows with no refine,
    and int8's recall@10 against fp32 recorded; (b) ``make_ring_topk`` at 64
    users, k = 200, against (a); (c) phase 22's trained bundle through
    ``RecommendationService(backend="sharded")`` (rerank 200, F = 289, on
    the host through ``_FastRerank``): ``recommend`` and a 64-user
    ``recommend_batch`` with an unknown user against the same backend
    served on the CPU (``SERVE_TOL``; the distance to ``backend="device"``
    recorded), the counters set to 0 just before and read just after (row 1
    launches, row 2 never), then ``python -m
    recsys_tpu_torch.serve --backend sharded`` (``/health``, ``/model/info``
    and one ``/recommend``), and after the NCCL group is gone, the same
    answers against the sharded backend on a one-rank gloo group on the CPU;
    (d) the sharded route's rerank candidates at 1M items against the exact
    flash route's (1 and 64 users, k = 200; the reranks, host fp32 against
    device bf16, recorded apart), the sharded ``recommend`` and 64-user call
    profiled as in phase 7, beside the exact flash route on the same
    catalog, and the fp32 and int8 shards' searches alone at 64 users,
    k = 200; the group is destroyed before the phase ends;
26. data-parallel training on a one-rank NCCL mesh that ``make_mesh``
    starts: ``Trainer(mesh_ctx=...).train`` one epoch on phase 8's bundle
    at the full-width defaults (B = 8,192, global negatives, the flash
    route), the counters set to 0 just before and read just after; (a) 3
    mesh steps against 3 one-card steps from one init (dropout on) held to
    phase 10's bounds, bit-equality recorded, then the same at phase 21's
    scale row (the sparse step), each step profiled (device ms, the NCCL
    kernels' device ms, launches added); (b) rows 4 to 7 with the
    positives at an offset (b = 2,048 rows against 8,192 gathered
    candidates, rank 3 of 4's positives, accidental hits in every segment)
    against their plain versions, bf16 (rows 4, 6, 7) and fp32 (rows 4, 5);
    the group is destroyed; (c) the train CLI under ``python -m
    torch.distributed.run --standalone --nproc_per_node 1`` on NCCL, one
    epoch, against the same CLI without the launcher (losses and the
    bundle's params at phase 10's bounds);
27. the row-sharded tables' lookups on a one-rank NCCL mesh that
    ``make_mesh`` starts (at one model rank the trainer keeps its tables
    whole, by the JAX package's rule, so the lookups are driven directly):
    (a) ``make_sharded_lookup_psum`` and ``make_sharded_lookup_a2a``
    (capacity factor 2) over phase 18's 4,000,001 x 128 fp32 user table at
    B = 131,072 Zipf ids, forward bit-equal to ``table[ids]``, the gradient
    of ``sum(rows**2)`` against the plain gather's, the a2a overflow 0 at
    factor 2 and ``B - a2a_capacity(B, 1, 0.5)`` at 0.5 (the fitting ids
    exact, the rest zero rows), each lookup's forward and forward +
    backward profiled beside the plain gather's (a profile that recorded
    no device work fails the run), ``gather_table`` of the table onto the
    host in chunks equal to it; (b)
    ``MultiTaskModel.loss(..., lookup=...)`` with each lookup at the main
    path's full width (B = 8,192, the defaults, bf16, the flash route)
    against the same loss without one: the loss and every gradient held to
    phase 10's loss bound, bit-equality recorded, the counters set to 0 just
    before and read just after (rows 2, 3, 4, 6 and 7 launch); the group is
    destroyed; (c) the train CLI under ``python -m torch.distributed.run
    --standalone --nproc_per_node 1`` with ``--model_parallel 1
    --embedding_sharding rows --lookup_strategy a2a``, one epoch, against
    the plain CLI (losses and params at phase 10's bounds);
28. the trainer's debugging modes and the row-sharded checkpoint: (a)
    ``Trainer.train`` one epoch of phase 8's bundle at the full-width
    defaults with ``train.profile`` and ``train.debug_nans`` on, the
    counters set to 0 just before and read just after (rows 2, 3, 4, 6 and
    7 launch, row 5 never), the trace under ``<out>/profile`` parsed, each
    of those rows' kernels in it (its events beside its launches), whether
    the TensorBoard sink was on; (b) 3 full-width steps (dropout on) with
    the NaN checks against 3 without, bit-equal, the step profiled with
    the checks off and on in turns; (c) a NaN in the first cross layer's ``w`` raises
    ``FloatingPointError`` naming row 2 with the state untouched, and
    ``Trainer.train`` with it planted writes no checkpoint; a NaN in one
    rating names an aten op; (d) phase 18's 4,000,001 x 128 fp32 user
    table (padded to 4,000,004 rows) and an adagrad slot written by the
    streaming checkpoint writer on a one-rank NCCL mesh, read back as 4 row
    ranges, each bit-equal, and ``np.load`` of the member equal to the
    table, with the seconds and peak RSS growth of each;
29. DLRM-DCNv2 (``python3 chip_smoke.py --dlrm-bags``, in a process of
    its own): the embedding bags' kernels (``ops/embedding_bag.py``)
    against their plain versions at four edge shapes (D of 12 to 512,
    runs of one row across many chunks, a ragged last chunk) and at the
    benchmark cell's shape (B = 65,536, 214 lookups an example over
    29,184,588 rows of 128): the forward bit-equal to its plain sum and
    twice bit-equal, the backward with its row-wise Adagrad twice
    bit-equal and within ``DLRM_UPDATE_TOL`` of the plain update, its
    count of rows updated equal to the plain version's, launches equal to
    calls, and both kernels' CUDA-event ms; then ``dryrun_dlrm`` at the
    cell's widths and the train CLI's ``--config`` on a tiny model, two
    epochs, on the card;
30. prints a ``{"kernels": [...]}`` line (each kernel's launches in phase
    27 (b) as ``launches_rows_lookup`` and in phase 28 (a) as
    ``launches_debug``), the nvidia-smi line, and last
    ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero without the last line. Without a
CUDA device it exits 2 before doing anything.

    python3 chip_smoke.py --ab PARENT_DIR

times kernel rows 1 to 8 of an unpacked checkout of another commit
(``git archive <commit> | tar -x -C PARENT_DIR``) and of this tree in
turns on one card (parent, this, this, parent; a process each, every tree
built from its own sources) at the shapes of the ``AB_*`` lists (rows 4,
6 and 7 in bf16 up to 131,072 x 262,144; rows 4 to 7 also in fp32 at
8,192^2, rows 4, 6 and 7 at 20,000^2; rows 2 and 3 at
F = 256 and 289, row 3 with its reduction's device ms apart), beside the
library yardsticks of rows 4 to 8, then each tree's served requests and
B = 8,192 train step as phases 7 and 11 profile them, and prints one
JSON line per run.
"""

from __future__ import annotations

import json
import os
import shutil
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
# the fp32 step past the TPU's partials cap: at 20,000 rows its candidate
# tile is 32 and its fused partials (5.96 GiB) pass the cap, so the TPU
# takes its two kernels there; the port takes the fused kernel (bwd_route)
FP32_PAST_CAP_BATCH = 20_000
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
# giant-table, large-batch training: the tables of the "train" row of
# benchmarks/results/scale.json (4M users x 2M items) at the full-width
# ModelConfig, B = 131,072 with one batch of CBNS cache (262,144
# candidates: the TPU's dU partials come to 8 GiB, past the 4.5 GiB cap,
# so the backward takes rows 6 and 7), sparse adagrad ("auto" picks it)
GIANT_USERS, GIANT_ITEMS = 4_000_000, 2_000_000
GIANT_BATCH = GIANT_CACHE = 131_072
GIANT_STEPS = 8
GIANT_VAL = 65_536
ABOVE_CAP = (131_072, 262_144, 128)
# the backward's two routes, bf16 and fp32, D = 128: (Bq, Bk) under the TPU's
# partials cap (4,096 x 20,480: a batch with a 4-batch CBNS cache;
# 131,072 x 147,456: exactly at it), then above it (20,000^2 passes it
# through the TPU's 32-wide tile, the others through their width)
ROUTE_SHAPES = [(4096, 20_480), (8192, 8192), (16_384, 16_384), (32_768, 32_768),
                (131_072, 147_456), (20_000, 20_000), (65_536, 327_680), ABOVE_CAP[:2]]
# the scale.json "train" row itself: dim 64, B = 4,096
SCALE_ROW_DIM, SCALE_ROW_BATCH = 64, 4096
# the data-and-features path: ML-1M-shaped raw files from SEED, preprocessed
# (1,000,209 synthesized ratings), trained with the engineered dense
# features and the side tables: the DCN input is 2 * 128 + 33 = 289
# features (285 without the side tables), so the cross stack's backward
# takes its shared-memory kernel (F > 256) at F % 4 = 1
DENSE_F = 2 * 128 + 33
DENSE_DCN_EDGES = [(TRAIN_BATCH, DENSE_F, 3), (TRAIN_BATCH + 1, DENSE_F - 4, 3),
                   (BATCH_USERS * RERANK, DENSE_F, 3)]
# the exported artifact against the exact route: fp32 products in
# another order (torch.matmul against the flash top-k kernel)
EXPORT_TOL = 1e-5
# explicit negatives and the streaming path: the train CLI's default 20 hard
# + 30 random negatives a row; streamed in 32-step chunks with a checkpoint
# every 16 steps (so chunks of 16), then one step a transfer with one every
# 40; the kernels every step of the path launches
NEG_HARD, NEG_RANDOM = 20, 30
STREAM_CHUNK, STREAM_CKPT_EVERY, STREAM_K1_CKPT_EVERY = 32, 16, 40
NEG_PATH_KERNELS = ("dcn_cross", "dcn_cross_bwd", "flash_ce_fwd", "flash_ce_bwd_du",
                    "flash_ce_bwd_dv")
# the row-sharded lookups' backward against the plain gather's, relative to
# max|ref|: both scatter-add the same per-occurrence rows with atomics, so
# only the order of the adds differs
LOOKUP_GRAD_TOL = 1e-6
# the rest of serving: 16 clients, each sending 20 single-user /recommend
# requests (k of 5 and 10) one after another
LOAD_CLIENTS, LOAD_REQUESTS = 16, 20


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
    recorded none for the blockmax kernel's 0.4 s launches) or, with
    ``kernel``, recorded its launches for only some of the calls (late in
    a long run it has kept 3 of 10) in two windows running."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a window that dropped records is taken once more
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        total = sum(e.self_device_time_total for e in events)
        named = [e for e in events if kernel and kernel in e.key]
        n_named = sum(e.count for e in named)
        if total and not (kernel and (n_named == 0 or n_named % iters)):
            return total / 1e3 / iters, sum(e.self_device_time_total for e in named) / 1e3 / iters
    # the profiler recorded nothing, or dropped launches: not measured, not zero
    return None, None


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
        code, body, _ = http(port, "POST", "/score", {
            "user_id": known, "item_ids": [int(i) for i in svc.index.item_raw_ids[:3]]})
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
    several query tiles and counts between them, the item-bias
    augmentation (d = 129), every buffer size, a catalog ordered so that
    late items keep evicting, catalogs of 1, 63 and 65 items, tied scores
    at the served shape, and ragged row counts and widths of the cross
    stack, the dense-feature widths (F = 285 and 289) with two calls
    bit-equal."""
    import torch
    from recsys_tpu_torch.ops.dcn_cross import dcn_cross

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    check_topk(rnd(1, 8), rnd(5, 8), 10, normalize=True)
    check_topk(rnd(70, 24), rnd(1000, 24), 1, normalize=True)
    check_topk(rnd(70, 24), rnd(1000, 24), 64, normalize=True)
    check_topk(rnd(3, 128), rnd(20000, 128), 128, bias=rnd(20000))
    v = rnd(4099, 128)
    v = v[v.norm(dim=1).argsort()].contiguous()  # ascending norms
    check_topk(rnd(5, 128).abs(), v.abs(), 256)
    # query counts between the query tiles, catalogs around one 64-item
    # tile, and tied scores at the served shape (duplicated catalog rows)
    for q_n in (2, 9, 17):
        check_topk(rnd(q_n, 128), rnd(N_ITEMS, 128), RERANK, normalize=True)
    for n in (1, 63, 65):
        check_topk(rnd(9, 128), rnd(n, 128), RERANK, normalize=True)
        check_topk(rnd(1, 128), rnd(n, 128), 10)
    v = rnd(N_ITEMS, 128)
    v[1::2] = v[0::2][: N_ITEMS // 2]
    for q_n in (1, BATCH_USERS):
        check_topk(rnd(q_n, 128), v, RERANK, normalize=True)
    for n, f, n_layers in ((37, 256, 3), (1, 24, 1), (1000, 100, 2), (5, 1024, 3)):
        check_dcn(rnd(n, f), rnd(n_layers, f) * f ** -0.5, rnd(n_layers, f) * 0.1)
    # the engineered dense features' widths (F % 4 = 1): a train batch, a
    # ragged one without side features, the rerank of 64 users x 200
    for n, f, n_layers in DENSE_DCN_EDGES:
        args = (rnd(n, f), rnd(n_layers, f) * f ** -0.5, rnd(n_layers, f) * 0.1)
        check_dcn(*args)
        check(bool(torch.equal(dcn_cross(*args), dcn_cross(*args))),
              f"dcn n={n} F={f} L={n_layers}: two calls differ")
    log("kernel edge cases agree with the plain versions")


def measure_topk(u, v, k: int, iters: int) -> dict:
    """Row 1 at one shape: the whole ``flash_topk`` (stage 1 + the select
    kernel) against its plain version and ``matmul`` + ``topk``, CUDA
    events and device time; the select kernel alone on stage 1's
    candidates; the bound (2*Q*N*d fp32 operations or the bytes)."""
    import torch
    from recsys_tpu_torch.ops import topk_flash as T

    q_n, d = u.shape
    n = v.shape[0]
    err = check_topk(u, v, k)
    n_ops = 2.0 * q_n * n * d
    b_ms, b_by = bound_ms(4 * (q_n * d + n * d) + 12 * q_n * k, n_ops)
    kernel = lambda: T.flash_topk(u, v, k, normalize=False)
    plain = lambda: T.flash_topk_reference(u, v, k, normalize=False)
    dev_ms, dev_kernel_ms = device_ms(kernel, iters, kernel="topk_flash")
    p = T.plan(q_n, n, k, torch.cuda.get_device_properties(0).multi_processor_count)
    cand = T.flash_topk_candidates_reference(u, v, p)  # the layout stage 1 writes
    library = lambda: torch.topk(torch.matmul(u, v.T), k, dim=1)
    # host-bound at the served shapes: kernel and library in turns, twice,
    # the faster of each pair kept
    turns = [(time_ms(kernel, iters), time_ms(library, iters)) for _ in range(2)]
    ms, library_ms = min(t[0] for t in turns), min(t[1] for t in turns)
    return {
        "shape": {"Q": q_n, "N": n, "d": d, "k": k},
        "plan": p._asdict(),
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": time_ms(plain, iters),
        "library_ms": library_ms,
        "bound_ms": b_ms, "bound_by": b_by,
        "tflops": n_ops / ms / 1e9, "bound_share": b_ms / ms,
        # device time per call: the whole call (both kernels), stage 1
        # alone, the select kernel alone, and the plain version
        "device_ms": dev_ms, "kernel_device_ms": dev_kernel_ms,
        "select_device_ms": device_ms(kernel, iters, kernel="topk_select")[1],
        "select_ms": time_ms(lambda: T.topk_select(*cand, k), iters),
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


def train_main_path(bundle: dict, counters, out_dir: str, epochs: int = TRAIN_EPOCHS,
                    **model_kw) -> dict:
    """Phase 8: ``Trainer.train`` on the card at the full-width defaults
    (``model_kw`` overrides ``ModelConfig`` fields), every kernel counter
    set to 0 just before and read just after."""
    import json as _json
    import math

    import torch
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig
    from recsys_tpu_torch.train.trainer import Trainer

    cfg = RecsysConfig(model=ModelConfig(**model_kw),
                       train=TrainConfig(batch_size=TRAIN_BATCH, epochs=epochs))
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
    check(len(hist) == epochs, f"train: {len(hist)} epochs logged")
    for e in hist:
        for k in ("train_loss", "val_loss", "train_retrieval_loss"):
            check(math.isfinite(e[k]), f"train: epoch {e['epoch']} {k} = {e[k]}")
    check(epochs == 1 or hist[-1]["train_loss"] < hist[0]["train_loss"],
          f"train: loss did not fall ({hist[0]['train_loss']} -> {hist[-1]['train_loss']})")
    for rel in ("metrics.json", "training_log.csv", "config.json", "serving/model.npz",
                "serving/encoder.npz", "serving/index.npz", "serving/vocabs.json",
                "serving/config.json"):
        check(os.path.exists(os.path.join(out_dir, rel)), f"train: {rel} missing")
    ckpts = [n for n in os.listdir(os.path.join(out_dir, "checkpoints"))
             if n.startswith("ckpt_")]
    check(len(ckpts) == epochs, f"train: checkpoints {ckpts}")
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

    pop = np.bincount(bundle["train/movie_id"],
                      minlength=int(bundle["meta/n_movies"])).astype(np.float32)
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


def check_flash(u, v, c, ids_q, ids_k, pos, g, bwd=None) -> dict:
    """The flash CE forward and a backward (``bwd``, default the fused
    ``flash_ce_bwd_fused``) against their plain versions on the same
    inputs, each output relative to its own max|ref|: lse, positive logit
    and dcol within FLASH_TOL; dU and dV within FLASH_TOL for fp32
    operands and FLASH_BF16_GRAD_TOL for bf16 ones. -> max absolute and
    relative errors, and the reference lse."""
    import torch
    from recsys_tpu_torch.ops import flash_ce as F

    bwd = bwd or F.flash_ce_bwd_fused

    lse, pl = F.flash_ce_fwd(u, v, c, ids_q, ids_k, pos)
    torch.cuda.synchronize()
    rl, rp = F.flash_ce_fwd_reference(u, v, c, ids_q, ids_k, pos)
    what = f"flash CE Bq={u.shape[0]} Bk={v.shape[0]} D={u.shape[1]} {u.dtype}"
    fwd_abs, fwd_rel = _errs((lse, pl), (rl, rp))
    check(bool(torch.isfinite(lse).all()), f"{what}: non-finite lse")
    check(max(fwd_rel) <= FLASH_TOL, f"{what}: forward err {fwd_rel} > {FLASH_TOL}")
    got = bwd(u, v, c, ids_q, ids_k, pos, rl, g)
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


def check_train_edges() -> list:
    """Edge cases of the training kernels on the card, before any timing:
    ragged Bq and Bk, Bk != Bq (rectangular, one candidate), every padded
    width D, both operand types, many accidental hits, backward blocks
    that sweep several candidate tiles (at small shapes and at 32,768
    rows); in the DCN backward both kernels (dw and db in registers, and in
    shared memory past 4 layers or 256 features), ragged rows, F from 1 to
    1,024, one to eight layers, two calls bit-equal. -> the DCN backward's
    edges."""
    import torch
    from recsys_tpu_torch.ops import flash_ce as F

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    ints = lambda hi, n: torch.randint(0, hi, (n,), generator=g, device="cuda",
                                       dtype=torch.int32)
    cap = F._FUSED_BWD_PARTIALS_CAP
    for bq, bk, d, dt in ((70, 70, 16, torch.float32), (100, 230, 128, torch.bfloat16),
                          (300, 300, 200, torch.float32), (65, 1, 8, torch.float32),
                          (129, 64, 64, torch.bfloat16), (33, 100, 256, torch.bfloat16),
                          # bf16 widths off the tensor-core depth, one candidate
                          (300, 300, 200, torch.bfloat16), (130, 260, 129, torch.bfloat16),
                          (65, 1, 8, torch.bfloat16)):
        pos = (torch.arange(bq, device="cuda", dtype=torch.int32) % bk).contiguous()
        args = ((rnd(bq, d) * d ** -0.5).to(dt), rnd(bk, d).to(dt), rnd(bk),
                ints(max(2, bk // 3), bq), ints(max(2, bk // 3), bk), pos, rnd(bq))
        check_flash(*args)
        # caps of one and two dU partials: each backward block sweeps
        # several candidate tiles (the last block fewer), as above ~33k
        # rows (bf16) at the real cap
        for parts in (1, 2):
            F._FUSED_BWD_PARTIALS_CAP = parts * bq * d * 4
            try:
                check_flash(*args)
            finally:
                F._FUSED_BWD_PARTIALS_CAP = cap
    # the backward at the real cap's edge: 32,768 rows, one 128-candidate
    # tile a block, 256 dU partials of 16 MiB
    b = 32768
    plan = F.bwd_plan(b, b, 128, True, torch.cuda.get_device_properties(0).multi_processor_count)
    check((plan.tile, plan.tiles_per_block, plan.n_spans) == (128, 1, 256),
          f"B = 32,768: plan {plan}")
    args = ((rnd(b, 128) * 128 ** -0.5).to(torch.bfloat16),
            (rnd(b, 128) * 128 ** -0.5).to(torch.bfloat16), rnd(b),
            ints(N_ITEMS, b), ints(N_ITEMS, b),
            torch.arange(b, device="cuda", dtype=torch.int32))
    grad = rnd(b)
    errs = check_flash(*args, grad)
    bwd_ms = time_ms(lambda: F.flash_ce_bwd_fused(*args, errs["lse"], grad), iters=3, warmup=1)
    log(f"flash CE backward at B = {b}, {plan}: max rel err "
        f"{errs['bwd_rel']}, {bwd_ms:.3f} ms")
    del args, errs
    torch.cuda.empty_cache()
    from recsys_tpu_torch.ops import dcn_cross as D

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    dcn_edges = []
    # the register kernel (L <= 4, F <= 256; 16-byte rows where F % 4 ==
    # 0, a lane per column otherwise) and the shared-memory one (past
    # either), ragged n, F from 1 to 1,024, one to eight layers
    for n, f, n_layers in ((37, 256, 3), (1, 24, 1), (1000, 100, 2), (5, 1024, 3),
                           (8193, 256, 3), (300, 1, 1), (777, 130, 4), (2049, 64, 3),
                           (100_000, 256, 3), (500, 256, 5), (1000, 512, 2), (64, 200, 8),
                           (33, 1024, 3), *DENSE_DCN_EDGES[:2]):
        args = (rnd(n, f), rnd(n_layers, f) * f ** -0.5, rnd(n_layers, f) * 0.1, rnd(n, f))
        plan = D.bwd_plan(n, f, n_layers, n_sm)
        check(plan.registers == (n_layers <= 4 and f <= 256), f"dcn bwd plan {plan}")
        err, rel = check_dcn_bwd(*args)
        _, resid = D._forward(*args[:3], keep_resid=True)
        first, again = (D.dcn_cross_bwd(args[0], args[1], resid, args[3]) for _ in range(2))
        check(all(bool(torch.equal(a, b)) for a, b in zip(first, again)),
              f"dcn bwd n={n} F={f} L={n_layers}: two calls differ")
        dcn_edges.append({"n": n, "F": f, "L": n_layers, "plan": plan._asdict(),
                          "max_abs_err": err, "max_rel_err": rel})
    log(f"dcn backward edges: {json.dumps(dcn_edges)}")
    log("training-kernel edge cases agree with the plain versions")
    return dcn_edges


def check_fp32_bwd_edges() -> list:
    """Row 5 of fp32 operands (``flash_ce_bwd_fused``: the FMA kernel on
    the shared ``bwd_plan``) against its plain version at its edges, before
    any timing: every padded width (D in {24, 32, 64, 128, 129, 256}:
    element-wise loads where D % 4 != 0, 64-candidate tiles past 128), Bq
    and Bk off the 64-row query and 128-candidate tiles, one candidate, row
    0's positive column in the last candidate tile, a third of the rows
    whose every candidate but the positive is an accidental hit (every
    other shape), and 65,536^2 at D = 128, where the plan's blocks sweep 4
    candidate tiles in 2 query parts: dU, dV and dcol each within FLASH_TOL
    of its own max|ref|, two calls bit-equal. -> errors and plans per
    shape."""
    import torch
    from recsys_tpu_torch.ops import flash_ce as F

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for i, (bq, bk, d) in enumerate(((50, 70, 32), (130, 4097, 24), (1000, 3001, 64),
                                     (777, 2050, 128), (1000, 3001, 129), (300, 1100, 256),
                                     (65, 1, 128), (65_536, 65_536, 128))):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 40 + i)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        n_ids = max(2, bk // 3)
        ints = lambda n: torch.randint(0, n_ids, (n,), generator=gen, device="cuda",
                                       dtype=torch.int32)
        u, v = rnd(bq, d) * d ** -0.5, rnd(bk, d) * d ** -0.5
        c, ids_q, ids_k, gr = rnd(bk), ints(bq), ints(bk), torch.rand((bq,), generator=gen,
                                                                      device="cuda") / bq
        pos = torch.arange(bq, device="cuda", dtype=torch.int32) % bk
        pos[0] = bk - 1
        if i % 2:
            ids_k.fill_(n_ids)
            ids_q[::3] = n_ids
        what = f"row 5 fp32 edge Bq={bq} Bk={bk} D={d}"
        plan = F.bwd_plan(bq, bk, d, False, n_sm)
        if bq == 65_536:
            check((plan.tile, plan.tiles_per_block, plan.n_spans, plan.parts) == (128, 4, 128, 2),
                  f"{what}: plan {plan}")
        lse, _ = F.flash_ce_fwd_reference(u, v, c, ids_q, ids_k, pos)
        args = (u, v, c, ids_q, ids_k, pos, lse, gr)
        got = [F.flash_ce_bwd_fused(*args) for _ in range(2)]
        torch.cuda.synchronize()
        abs_err, rel_err = _errs(got[0], F.flash_ce_bwd_reference(*args))
        check(all(bool(torch.isfinite(t).all()) for t in got[0]), f"{what}: non-finite")
        for name, err in zip(("dU", "dV", "dcol"), rel_err):
            check(err <= FLASH_TOL, f"{what}: {name} err {err} of max|ref| > {FLASH_TOL}")
        check(all(bool(torch.equal(a, b)) for a, b in zip(*got)), f"{what}: two calls differ")
        out.append({"Bq": bq, "Bk": bk, "D": d, "all_accidental_rows": bool(i % 2),
                    "plan": plan._asdict(), "max_abs_err": abs_err,
                    "rel": dict(zip(("dU", "dV", "dcol"), rel_err))})
        del got, args, u, v
        torch.cuda.empty_cache()
    return out


def check_fp32_du_fwd_edges() -> list:
    """Rows 6 and 4 of fp32 operands (``flash_ce_bwd_du`` and
    ``flash_ce_fwd``: the FMA kernels on the fp32 branches of ``du_plan``
    and ``fwd_plan``) against their plain versions at their edges, before
    any timing: every padded width (D in {24, 32, 64, 128, 129, 256}:
    element-wise loads where D % 4 != 0, 64-row blocks past 128), Bq and Bk
    off the 128-row blocks and the 64- and 128-candidate tiles, one
    candidate (one part), row 0's positive column in the last part, a third
    of the rows whose every candidate but the positive is an accidental hit
    (every other shape), 8,192^2 (8 parts) and 65,536 x 4,096 (one part of
    64 and 32 tiles): dU, lse and the positive logit within FLASH_TOL of
    their own max|ref|, two calls bit-equal, and the positive logit of a
    many-part forward bit-equal to that of the same forward in one part
    (one part holds it; the others add 0). -> errors and plans per shape."""
    import torch
    from recsys_tpu_torch.ops import flash_ce as F

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for i, (bq, bk, d) in enumerate(((50, 70, 32), (130, 4097, 24), (1000, 3001, 64),
                                     (777, 2050, 128), (1000, 3001, 129), (300, 1100, 256),
                                     (65, 1, 128), (8192, 8192, 128), (65_536, 4096, 128))):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 50 + i)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        n_ids = max(2, bk // 3)
        ints = lambda n: torch.randint(0, n_ids, (n,), generator=gen, device="cuda",
                                       dtype=torch.int32)
        u, v = rnd(bq, d) * d ** -0.5, rnd(bk, d) * d ** -0.5
        c, ids_q, ids_k, gr = rnd(bk), ints(bq), ints(bk), torch.rand((bq,), generator=gen,
                                                                      device="cuda") / bq
        pos = torch.arange(bq, device="cuda", dtype=torch.int32) % bk
        pos[0] = bk - 1
        if i % 2:
            ids_k.fill_(n_ids)
            ids_q[::3] = n_ids
        what = f"rows 4/6 fp32 edge Bq={bq} Bk={bk} D={d}"
        du_p, fwd_p = F.du_plan(bq, bk, d, False, n_sm), F.fwd_plan(bq, bk, False, n_sm, d)
        if (bq, bk) == (8192, 8192):
            check(du_p.parts == fwd_p.parts == 8, f"{what}: plans {du_p}, {fwd_p}")
        if bk == 1 or bq == 65_536:
            check(du_p.parts == fwd_p.parts == 1, f"{what}: plans {du_p}, {fwd_p}")
        fwd = [F.flash_ce_fwd(u, v, c, ids_q, ids_k, pos) for _ in range(2)]
        torch.cuda.synchronize()
        ref_lse, ref_pos = F.flash_ce_fwd_reference(u, v, c, ids_q, ids_k, pos)
        fwd_abs, fwd_rel = _errs(fwd[0], (ref_lse, ref_pos))
        check(all(bool(torch.isfinite(t).all()) for t in fwd[0]), f"{what}: non-finite forward")
        check(max(fwd_rel) <= FLASH_TOL, f"{what}: forward err {fwd_rel} > {FLASH_TOL}")
        check(all(bool(torch.equal(a, b)) for a, b in zip(*fwd)), f"{what}: two forwards differ")
        if fwd_p.parts > 1:  # the same forward in one part
            cap = F._FUSED_BWD_PARTIALS_CAP
            F._FUSED_BWD_PARTIALS_CAP = 12 * bq
            try:
                check(F.fwd_plan(bq, bk, False, n_sm, d).parts == 1, f"{what}: one-part plan")
                one_lse, one_pos = F.flash_ce_fwd(u, v, c, ids_q, ids_k, pos)
            finally:
                F._FUSED_BWD_PARTIALS_CAP = cap
            check(bool(torch.equal(one_pos, fwd[0][1])),
                  f"{what}: the positive logit moved between {fwd_p.parts} parts and one")
            check(_errs([one_lse], [ref_lse])[1][0] <= FLASH_TOL, f"{what}: one-part lse")
        args = (u, v, c, ids_q, ids_k, pos, ref_lse, gr)
        du = [F.flash_ce_bwd_du(*args) for _ in range(2)]
        torch.cuda.synchronize()
        du_abs, du_rel = _errs([du[0]], [F.flash_ce_bwd_du_reference(*args)])
        check(bool(torch.isfinite(du[0]).all()), f"{what}: non-finite dU")
        check(du_rel[0] <= FLASH_TOL, f"{what}: dU err {du_rel[0]} of max|ref| > {FLASH_TOL}")
        check(bool(torch.equal(du[0], du[1])), f"{what}: two row 6 calls differ")
        out.append({"Bq": bq, "Bk": bk, "D": d, "all_accidental_rows": bool(i % 2),
                    "du_plan": du_p._asdict(), "fwd_plan": fwd_p._asdict(),
                    "max_abs_err": max(fwd_abs, du_abs),
                    "rel": {"lse": fwd_rel[0], "pos_logit": fwd_rel[1], "dU": du_rel[0]}})
        del fwd, du, args, u, v
        torch.cuda.empty_cache()
    return out


def check_fp32_dv_edges() -> list:
    """Row 7 of fp32 operands (``flash_ce_bwd_dv``: the FMA kernel on the
    fp32 branch of ``dv_plan``) against its plain version at its edges,
    before any timing: every padded width (D in {24, 32, 64, 128, 129,
    256}: element-wise loads where D % 4 != 0, 64-candidate blocks past
    128), Bq and Bk off the 64-row query tiles and the 128-candidate
    blocks, one candidate, row 0's positive column in the last candidate
    block, a third of the rows whose every candidate but the positive is an
    accidental hit (every other shape), and 8,192^2 (8 parts): dV and dcol
    within FLASH_TOL of their own max|ref|, two calls bit-equal. At 8,192^2
    also the order of the parts: the same call in 2 parts (a lowered cap)
    is bit-equal to the sum of two one-part calls over the parts' query
    rows, since a part sweeps its tiles in the same order alone. -> errors
    and plans per shape."""
    import torch
    from recsys_tpu_torch.ops import flash_ce as F

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for i, (bq, bk, d) in enumerate(((50, 70, 32), (130, 4097, 24), (1000, 3001, 64),
                                     (777, 2050, 128), (1000, 3001, 129), (300, 1100, 256),
                                     (65, 1, 128), (8192, 8192, 128))):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 60 + i)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        n_ids = max(2, bk // 3)
        ints = lambda n: torch.randint(0, n_ids, (n,), generator=gen, device="cuda",
                                       dtype=torch.int32)
        u, v = rnd(bq, d) * d ** -0.5, rnd(bk, d) * d ** -0.5
        c, ids_q, ids_k, gr = rnd(bk), ints(bq), ints(bk), torch.rand((bq,), generator=gen,
                                                                      device="cuda") / bq
        pos = torch.arange(bq, device="cuda", dtype=torch.int32) % bk
        pos[0] = bk - 1
        if i % 2:
            ids_k.fill_(n_ids)
            ids_q[::3] = n_ids
        what = f"row 7 fp32 edge Bq={bq} Bk={bk} D={d}"
        plan = F.dv_plan(bq, bk, d, False, n_sm)
        if bq == 8192:
            check(plan.parts == 8, f"{what}: plan {plan}")
        lse, _ = F.flash_ce_fwd_reference(u, v, c, ids_q, ids_k, pos)
        args = (u, v, c, ids_q, ids_k, pos, lse, gr)
        got = [F.flash_ce_bwd_dv(*args) for _ in range(2)]
        torch.cuda.synchronize()
        abs_err, rel_err = _errs(got[0], F.flash_ce_bwd_dv_reference(*args))
        check(all(bool(torch.isfinite(t).all()) for t in got[0]), f"{what}: non-finite")
        for name, err in zip(("dV", "dcol"), rel_err):
            check(err <= FLASH_TOL, f"{what}: {name} err {err} of max|ref| > {FLASH_TOL}")
        check(all(bool(torch.equal(a, b)) for a, b in zip(*got)), f"{what}: two calls differ")
        row = {"Bq": bq, "Bk": bk, "D": d, "all_accidental_rows": bool(i % 2),
               "plan": plan._asdict(), "max_abs_err": abs_err,
               "rel": dict(zip(("dV", "dcol"), rel_err))}
        if bq == 8192:  # 2 parts against the two parts' rows, each in one part
            cap = F._FUSED_BWD_PARTIALS_CAP
            try:
                F._FUSED_BWD_PARTIALS_CAP = 2 * 4 * bk * (d + 1)
                two = F.dv_plan(bq, bk, d, False, n_sm)
                check(two.parts == 2, f"{what}: two-part plan {two}")
                whole = F.flash_ce_bwd_dv(*args)
                F._FUSED_BWD_PARTIALS_CAP = 4 * bk * (d + 1)
                cut = two.q_tiles_per_part * two.qtile
                halves = []
                for rows in (slice(0, cut), slice(cut, bq)):
                    sub = (u[rows], v, c, ids_q[rows], ids_k, pos[rows], lse[rows], gr[rows])
                    check(F.dv_plan(sub[0].shape[0], bk, d, False, n_sm).parts == 1,
                          f"{what}: one-part plan of {rows}")
                    halves.append(F.flash_ce_bwd_dv(*(t.contiguous() for t in sub)))
            finally:
                F._FUSED_BWD_PARTIALS_CAP = cap
            torch.cuda.synchronize()
            check(all(bool(torch.equal(w, a + b)) for w, a, b in zip(whole, *halves)),
                  f"{what}: 2 parts differ from the sum of their rows' one-part calls")
            row["parts_bit_equal"] = {"parts": two.parts, "rows_per_part": cut}
        out.append(row)
        del got, args, u, v
        torch.cuda.empty_cache()
    return out


def _dense_softmax_bwd(u, v, c, gr) -> tuple:
    """Row 5's one-call yardstick: the dense softmax backward over the
    whole [Bq, Bk] scores (dU, dV with p*g rounded to the operand type,
    dcol)."""
    import torch

    p = torch.softmax(torch.matmul(u, v.T) + c, dim=1) * gr[:, None]
    pd = p.to(u.dtype)
    return pd @ v, pd.T @ u, p.sum(dim=0)


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
            # the FMA kernel (fp32) or the tensor-core kernel and its combine
            n_ops, name = 2.0 * b * b * d, "flash_ce_fwd_"
            err, rel = errs["fwd_abs"], errs["fwd_rel"]
        else:
            kernel = lambda: F.flash_ce_bwd_fused(u, v, c, ids, ids, pos, lse, gr)

            def plain():
                return F.flash_ce_bwd_reference(u, v, c, ids, ids, pos, lse, gr)

            library = lambda: _dense_softmax_bwd(u, v, c, gr)
            n_bytes = 2 * b * d * elt + 6 * b * 4 + (2 * b * d + b) * 4
            n_ops = 6.0 * b * b * d
            name = "flash_ce_bwd_tc_kernel" if dtype == torch.bfloat16 else "flash_ce_bwd_kernel"
            err, rel = errs["bwd_abs"], errs["bwd_rel"]
            # deterministic: no atomics, partials summed in a fixed order
            first, again = kernel(), kernel()
            check(all(bool(torch.equal(a, b_)) for a, b_ in zip(first, again)),
                  f"flash CE backward {shape}: two calls differ")
            del first, again
        b_ms, b_by = bound_ms(n_bytes, n_ops, flops, n_exp=float(b) * b, exp_per_s=exp_rate)
        dev_ms, dev_kernel_ms = device_ms(kernel, iters, kernel=name)
        ms = time_ms(kernel, iters)
        rows.append({
            "shape": shape, "max_abs_err": err, "max_rel_err": rel,
            "ms": ms, "tflops": n_ops / ms / 1e9, "bound_share": b_ms / ms,
            "plain_ms": time_ms(plain, iters), "library_ms": time_ms(library, iters),
            "bound_ms": b_ms, "bound_by": b_by, "device_ms": dev_ms,
            "kernel_device_ms": dev_kernel_ms, "plain_device_ms": device_ms(plain, iters)[0],
        })
    return rows[0], rows[1]


def measure_dcn_bwd(n: int, iters: int, f: int = 256) -> dict:
    import torch
    from recsys_tpu_torch.ops import dcn_cross as D

    n_layers = 3
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
    ms = time_ms(kernel, iters)
    dev_ms, reduce_ms = device_ms(kernel, iters, kernel="dcn_cross_bwd_reduce")
    return {
        "shape": {"n": n, "F": f, "L": n_layers}, "max_abs_err": err, "max_rel_err": rel,
        "plan": D.bwd_plan(n, f, n_layers, torch.cuda.get_device_properties(0)
                           .multi_processor_count)._asdict(),
        "ms": ms, "plain_ms": time_ms(plain, iters),
        "library_ms": None,  # no single PyTorch call computes this VJP
        "bound_ms": b_ms, "bound_by": b_by, "device_ms": dev_ms,
        "reduce_device_ms": reduce_ms, "device_bound_share": b_ms / dev_ms if dev_ms else None,
        "plain_device_ms": device_ms(plain, iters)[0],
    }


_PROFILE_WINDOW = "profile_call.window"


class _DeviceKey:
    """The device events of one name inside a window, summed (the fields
    of ``key_averages()``'s entries that :func:`profile_call` reads)."""

    def __init__(self, key: str, is_user_annotation: bool):
        self.key, self.is_user_annotation = key, is_user_annotation
        self.count, self.self_device_time_total = 0, 0.0


def _window_device_events(prof) -> list:
    """The device events (kernels, copies, collective spans) of ``prof``
    launched inside its ``_PROFILE_WINDOW`` range, by name: a kernel or copy
    counts when the host op it is linked to by correlation id started inside
    the range, so the skew between the host's and the device's clocks keeps
    or drops no record at the range's ends (on the card it dropped one or two
    of 900); a collective span, which has no such link, counts when it starts
    inside the range."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    win = next(e for e in events if e.name() == _PROFILE_WINDOW
               and e.device_type() == DeviceType.CPU)
    lo, hi = win.start_ns(), win.start_ns() + win.duration_ns()
    inside = {e.correlation_id() for e in events
              if e.device_type() == DeviceType.CPU and lo <= e.start_ns() <= hi}
    keys = {}
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.name() == _PROFILE_WINDOW:
            continue
        span = e.is_user_annotation()
        if not (lo <= e.start_ns() <= hi if span else e.linked_correlation_id() in inside):
            continue
        k = keys.setdefault(e.name(), _DeviceKey(e.name(), span))
        k.count += 1
        k.self_device_time_total += e.duration_ns() / 1e3
    return list(keys.values())


def profile_call(name: str, fn, n_wall: int = 50, n_traced: int = 20,
                 warmup: int = 5, groups=None, lead_in_ms: float = 0.0) -> dict:
    """Host clock of ``n_wall`` calls of ``fn`` with the profiler off
    (median and p90, each call ending in a device sync), then a traced
    window of ``n_traced`` calls: device time per call, the device's busy
    share of the traced wall time, launches per call and the kernels that
    take the time; ``groups`` {label: kernel-name substring} adds the
    device ms and launches per call of each group, and the rest's ms.
    The GPU-side ranges the profiler records around each collective
    (``nccl:all_gather`` and the like: user annotations, spans that contain
    the collective's copies and its waits, not device work of their own)
    are left out of every sum and reported apart per call. ``lead_in_ms``
    > 0 runs calls in the traced session first, each waited for, until that
    many ms have passed, and counts only the device work that starts inside
    a ``record_function`` range around the ``n_traced`` calls: the profiler
    has lost the records of the first milliseconds of a session (phase 27's
    forwards, 0.1 ms a call, lost half or all of 20 calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

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
        end = time.perf_counter() + lead_in_ms / 1e3
        while time.perf_counter() < end:
            fn()
            torch.cuda.synchronize()
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # after the profiler's own start-up
        with record_function(_PROFILE_WINDOW):
            for _ in range(n_traced):
                fn()
            torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / n_traced
    if lead_in_ms:
        events = _window_device_events(prof)
    else:
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and e.key != _PROFILE_WINDOW]
    spans = [e for e in events if getattr(e, "is_user_annotation", False)]
    device = [e for e in events if not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.self_device_time_total for e in device) / 1e3 / n_traced
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    out = {
        "profile": name, "n": len(walls),
        "wall_ms_p50": walls[len(walls) // 2], "wall_ms_p90": walls[int(len(walls) * 0.9)],
        "traced_wall_ms": traced_ms, "device_ms": dev_ms,
        "device_busy_share": dev_ms / traced_ms,
        "device_launches": sum(e.count for e in device) // n_traced,
        # every kernel recorded a whole number of times a call (none dropped)
        "device_records_whole": all(e.count % n_traced == 0 for e in device),
        "top_device_us": [[e.key[:60], e.self_device_time_total / n_traced] for e in top],
    }
    if spans:
        out["collective_spans"] = {e.key: [e.count / n_traced,
                                           e.self_device_time_total / 1e3 / n_traced]
                                   for e in spans}
    if groups:
        by = {label: sum(e.self_device_time_total for e in device if sub in e.key)
              / 1e3 / n_traced for label, sub in groups.items()}
        by["rest"] = dev_ms - sum(by.values())
        out["group_device_ms"] = by
        out["group_launches"] = {label: sum(e.count for e in device if sub in e.key) / n_traced
                                 for label, sub in groups.items()}
    return out


def profile_requests(svc, batch) -> list:
    """Phase 7: ``recommend`` and a 64-user ``recommend_batch`` through
    the service (no HTTP), profiled by :func:`profile_call`."""
    return [profile_call("recommend_k10", lambda: svc.recommend(1, 10)),
            profile_call("recommend_batch64_k10", lambda: svc.recommend_batch(batch, 10))]


def profile_train_steps(bundle: dict) -> list:
    """One full train step (loss, autograd, adagrad) at batch 4,096 and
    8,192 (the main path's), with the flash kernels and with the dense
    path, profiled by :func:`profile_call`: the step's wall and device
    times that later set ``_FLASH_MIN_CANDIDATES`` on the card; then the
    fp32 steps (``mixed_precision=False``, ``bf16_retrieval_logits=False``)
    at B = 8,192 (the fp32 epoch's: rows 4 and 5 in fp32, the fused
    backward) and B = 20,000 (the TPU's 32-wide tile puts its partials past
    its cap, where it takes its two kernels; the port keeps the fused
    kernel), with the device ms and launches of each flash kernel; the
    wrappers' counters show which backward each fp32 step took."""
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig
    from recsys_tpu_torch.models.losses import balanced_class_weights
    from recsys_tpu_torch.ops import flash_ce as F
    from recsys_tpu_torch.train.trainer import Trainer

    cw = balanced_class_weights(bundle["train/y_implicit"])
    fp32 = dict(mixed_precision=False, bf16_retrieval_logits=False)
    groups = {"row4_fwd": "flash_ce_fwd_kernel", "row4_combine": "flash_ce_fwd_combine_kernel",
              "row5_fused": "flash_ce_bwd_kernel", "row6_du": "flash_ce_bwd_du_kernel",
              "row7_dv": "flash_ce_bwd_dv_kernel"}
    wrappers = ("flash_ce_bwd_fused", "flash_ce_bwd_du", "flash_ce_bwd_dv")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for b, flash, model_kw in ((4096, True, {}), (4096, False, {}), (TRAIN_BATCH, True, {}),
                                   (TRAIN_BATCH, False, {}), (TRAIN_BATCH, True, fp32),
                                   (FP32_PAST_CAP_BATCH, True, fp32)):
            batches = _batches(bundle, 2, b, "cuda", _log_q(bundle))
            cfg = RecsysConfig(model=ModelConfig(use_flash_ce=flash, **model_kw),
                               train=TrainConfig(batch_size=b))
            tr = Trainer(cfg, tmp, device="cuda")
            holder = [tr.init_state(N_USERS, N_ITEMS, SEED)]
            step = tr.make_train_step(cw)

            def one():
                holder[0], _ = step(holder[0], batches[holder[0].step % 2])

            name = f"train_step_B{b}_{'flash' if flash else 'dense'}{'_fp32' if model_kw else ''}"
            before = {w: getattr(F, w).launches for w in wrappers}
            row = profile_call(name, one, n_wall=20, n_traced=5, warmup=2,
                               groups=groups if model_kw else None)
            if model_kw:
                moved = {w: getattr(F, w).launches - before[w] for w in wrappers}
                row["wrapper_launches"] = moved
                fused = F.bwd_route(b, b, 128) == "fused"
                check((moved["flash_ce_bwd_fused"] > 0) == fused
                      and (moved["flash_ce_bwd_du"] == moved["flash_ce_bwd_dv"] > 0) != fused,
                      f"{name}: backward launches {moved}")
                check(row["group_launches"]["row4_fwd"] > 0, f"{name}: row 4 never launched")
            rows.append(row)
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
    multiple of g, N < g, Q not a multiple of the query tile, fp32
    operands (``bf16=False``) at a ragged width, groups smaller than a
    64-item tile; on the tensor-core path (bf16) both query tiles (16 rows
    at Q in {1, 15}, 64 at Q in {17, 65}) and d in {24, 64, 128, 129, 256}
    (padded to 32 .. 256, element-wise loads at 129); then the whole
    ``blockmax_topk`` on the card against the CPU plain path, k > N
    included."""
    import torch
    from recsys_tpu_torch.ops.topk_flash import NEG_INF, blockmax_group_size, blockmax_topk

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    bf = torch.bfloat16
    check_blockmax(rnd(70, 128).to(bf), rnd(3001, 128).to(bf), blockmax_group_size(3001))
    check_blockmax(rnd(5, 128).to(bf), rnd(100, 128).to(bf), blockmax_group_size(100))
    check_blockmax(rnd(33, 129), rnd(5000, 129), 512)
    check_blockmax(rnd(3, 24), rnd(1000, 24), 40)
    for q_n, n, d, grp in ((1, 3001, 64, 384), (15, 5000, 129, 512), (17, 100_007, 128, 512),
                           (65, 2049, 64, 128), (16, 1000, 128, 40), (64, 777, 256, 128),
                           (3, 1000, 24, 40), (1, 1_000_003, 128, 512)):
        check_blockmax(rnd(q_n, d).to(bf), rnd(n, d).to(bf), grp)
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
    check(bool(torch.equal(blockmax_group_max(u, v, grp), blockmax_group_max(u, v, grp))),
          f"blockmax Q={q_n} N={n}: two calls differ")
    flops = BF16_FLOPS if u.dtype == torch.bfloat16 else FP32_FLOPS
    n_ops = 2.0 * q_n * n * d
    b_ms, b_by = bound_ms(u.element_size() * (q_n + n) * d + 4 * q_n * n_groups, n_ops, flops)
    kernel = lambda: blockmax_group_max(u, v, grp)
    plain = lambda: blockmax_group_max_reference(u, v, grp)
    warm = 1 if iters < 5 else 2
    dev_ms, dev_kernel_ms = device_ms(kernel, iters, kernel="blockmax")
    ms = time_ms(kernel, iters, warm)
    row = {
        "shape": {"Q": q_n, "N": n, "d": d, "g": grp, "dtype": str(u.dtype).replace("torch.", "")},
        "max_abs_err": err,
        "ms": ms, "tflops": n_ops / ms / 1e9, "bound_share": b_ms / ms,
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


# ---- giant-table, large-batch training --------------------------------------

def check_twokernel(u, v, c, ids_q, ids_k, pos, g, bwd=None) -> dict:
    """Rows 6 and 7, through ``bwd`` (default ``flash_ce_bwd_twokernel``),
    against their plain versions on the same inputs (``lse`` from the
    plain forward), each output relative to its own max|ref|: dcol within
    FLASH_TOL, dU and dV within FLASH_TOL for fp32 operands and
    FLASH_BF16_GRAD_TOL for bf16 ones. -> errors and the inputs of the
    backward."""
    import torch
    from recsys_tpu_torch.ops import flash_ce as F

    lse, _ = F.flash_ce_fwd_reference(u, v, c, ids_q, ids_k, pos)
    args = (u, v, c, ids_q, ids_k, pos, lse, g)
    got = (bwd or F.flash_ce_bwd_twokernel)(*args)
    torch.cuda.synchronize()
    want = (F.flash_ce_bwd_du_reference(*args), *F.flash_ce_bwd_dv_reference(*args))
    abs_err = [float((a - b).abs().max()) for a, b in zip(got, want)]
    rel_err = _errs(got, want)[1]
    what = f"two-kernel backward Bq={u.shape[0]} Bk={v.shape[0]} D={u.shape[1]} {u.dtype}"
    grad_tol = FLASH_BF16_GRAD_TOL if u.dtype == torch.bfloat16 else FLASH_TOL
    check(all(bool(torch.isfinite(t).all()) for t in got), f"{what}: non-finite")
    for name, err, tol in zip(("dU", "dV", "dcol"), rel_err, (grad_tol, grad_tol, FLASH_TOL)):
        check(err <= tol, f"{what}: {name} err {err} of max|ref| > {tol}")
    return {"abs": dict(zip(("dU", "dV", "dcol"), abs_err)),
            "rel": dict(zip(("dU", "dV", "dcol"), rel_err)), "args": args}


def check_fwd_dv_edges() -> list:
    """Rows 4 and 7 of bf16 operands (the tensor-core kernels) against
    their plain versions at their edges: D in {24, 32, 64, 120, 128, 129,
    256} (padded widths; row 7's TMA tiles zero past D, two column slices
    of dV past 128, and at D = 129 its padded copy of u and v; element-wise
    loads of row 4 where D % 8 != 0), the ragged 1,000 x 3,001 at D of 32
    to 256, Bq and Bk not multiples of 16, 64 or 128, one candidate, row
    0's positive column in the forward's last candidate part, 8,192^2, and
    (every other shape) a third of the rows whose every candidate but the
    positive is an accidental hit: lse, the positive logit and dcol within
    FLASH_TOL of max|ref|, dV within FLASH_BF16_GRAD_TOL; two calls of each
    give the same bits and count two launches. -> errors and plans per
    shape."""
    import torch
    from recsys_tpu_torch.ops import flash_ce as F

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for i, (bq, bk, d) in enumerate(((50, 70, 32), (130, 4097, 24), (1000, 3001, 32),
                                     (1000, 3001, 64), (1000, 3001, 120), (1000, 3001, 128),
                                     (1000, 3001, 129), (1000, 3001, 256), (777, 2050, 128),
                                     (300, 1100, 256), (65, 1, 64), (8192, 8192, 128))):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 30 + i)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        n_ids = max(2, bk // 3)
        ints = lambda n: torch.randint(0, n_ids, (n,), generator=gen, device="cuda",
                                       dtype=torch.int32)
        u, v = (rnd(bq, d) * d ** -0.5).bfloat16(), (rnd(bk, d) * d ** -0.5).bfloat16()
        c, ids_q, ids_k, gr = rnd(bk), ints(bq), ints(bk), rnd(bq) / bq
        pos = torch.arange(bq, device="cuda", dtype=torch.int32) % bk
        pos[0] = bk - 1
        if i % 2:
            ids_k.fill_(n_ids)
            ids_q[::3] = n_ids
        what = f"rows 4/7 edge Bq={bq} Bk={bk} D={d} bf16"
        before = F.flash_ce_fwd.launches, F.flash_ce_bwd_dv.launches
        fwd = [F.flash_ce_fwd(u, v, c, ids_q, ids_k, pos) for _ in range(2)]
        torch.cuda.synchronize()
        ref_lse, ref_pos = F.flash_ce_fwd_reference(u, v, c, ids_q, ids_k, pos)
        fwd_abs, fwd_rel = _errs(fwd[0], (ref_lse, ref_pos))
        check(all(bool(torch.isfinite(t).all()) for t in fwd[0]), f"{what}: non-finite forward")
        check(max(fwd_rel) <= FLASH_TOL, f"{what}: forward err {fwd_rel} > {FLASH_TOL}")
        check(all(bool(torch.equal(a, b)) for a, b in zip(*fwd)), f"{what}: two forwards differ")
        args = (u, v, c, ids_q, ids_k, pos, ref_lse, gr)
        dv = [F.flash_ce_bwd_dv(*args) for _ in range(2)]
        torch.cuda.synchronize()
        dv_abs, dv_rel = _errs(dv[0], F.flash_ce_bwd_dv_reference(*args))
        check(all(bool(torch.isfinite(t).all()) for t in dv[0]), f"{what}: non-finite dV")
        check(dv_rel[0] <= FLASH_BF16_GRAD_TOL and dv_rel[1] <= FLASH_TOL,
              f"{what}: dV, dcol err {dv_rel}")
        check(all(bool(torch.equal(a, b)) for a, b in zip(*dv)), f"{what}: two row 7 calls differ")
        moved = (F.flash_ce_fwd.launches - before[0], F.flash_ce_bwd_dv.launches - before[1])
        check(moved == (2, 2), f"{what}: launches of rows 4 and 7 {moved}, want (2, 2)")
        out.append({"Bq": bq, "Bk": bk, "D": d, "all_accidental_rows": bool(i % 2),
                    "fwd_parts": F.fwd_plan(bq, bk, True, n_sm).parts,
                    "dv_parts": F.dv_plan(bq, bk, -(-d // 8) * 8, True, n_sm).parts,
                    "fwd_rel": dict(zip(("lse", "pos_logit"), fwd_rel)),
                    "dv_rel": dict(zip(("dV", "dcol"), dv_rel))})
        del fwd, dv, args, u, v
    return out


def _flash_args(bq: int, bk: int, d: int, dtype, seed: int, n_ids: int) -> tuple:
    """Seeded backward inputs: rows scaled by D**-0.5, ids from ``n_ids``
    (accidental hits), positives in the first Bq columns, ``g`` the
    gradient of a mean over Bq rows."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    u = (torch.randn((bq, d), generator=g, device="cuda") * d ** -0.5).to(dtype)
    v = (torch.randn((bk, d), generator=g, device="cuda") * d ** -0.5).to(dtype)
    c = torch.randn((bk,), generator=g, device="cuda")
    ids_k = torch.randint(0, n_ids, (bk,), generator=g, device="cuda", dtype=torch.int32)
    ids_q = ids_k[:bq].contiguous()
    pos = torch.arange(bq, device="cuda", dtype=torch.int32)
    gr = torch.rand((bq,), generator=g, device="cuda") / bq
    return u, v, c, ids_q, ids_k, pos, gr


def twokernel_rows(args, iters: int, exp_rate: float, plain: bool) -> tuple:
    """Rows 6 and 7 timed at one shape: CUDA events, device time (whole
    call / kernel alone), the bound (bytes, or products at the operand
    type's rate and one exp per logit, whichever takes longer) and, with
    ``plain``, the plain version and the library yardstick (the dense
    softmax backward's dU half, ``softmax @ v``, and its dV half,
    ``softmax.T @ u`` with the column sums). -> (dU row, dV row)."""
    import torch
    from recsys_tpu_torch.ops import flash_ce as F

    u, v, c, ids_q, ids_k, pos, lse, gr = args
    bq, d = u.shape
    bk = v.shape[0]
    elt = u.element_size()
    flops = BF16_FLOPS if u.dtype == torch.bfloat16 else FP32_FLOPS
    in_bytes = (bq + bk) * d * elt + 4 * (bk * 2 + bq * 4)
    shape = {"Bq": bq, "Bk": bk, "D": d, "dtype": str(u.dtype).replace("torch.", "")}

    def probs():  # as row 5's yardstick
        return torch.softmax(torch.matmul(u, v.T) + c, dim=1) * gr[:, None]

    rows = []
    for kind in ("du", "dv"):
        if kind == "du":
            kernel = lambda: F.flash_ce_bwd_du(*args)
            plain_fn = lambda: F.flash_ce_bwd_du_reference(*args)
            library = lambda: probs().to(u.dtype) @ v
            # both row 6 kernels: flash_ce_bwd_du_kernel (fp32) and _tc_kernel
            n_bytes, name = in_bytes + 4 * bq * d, "flash_ce_bwd_du_"
        else:
            kernel = lambda: F.flash_ce_bwd_dv(*args)
            plain_fn = lambda: F.flash_ce_bwd_dv_reference(*args)

            def library():
                p = probs()
                return p.to(u.dtype).T @ u, p.sum(dim=0)

            # both row 7 kernels: flash_ce_bwd_dv_kernel (fp32) and _wgmma_kernel
            n_bytes, name = in_bytes + 4 * (bk * d + bk), "flash_ce_bwd_dv_"
        n_ops = 4.0 * bq * bk * d
        b_ms, b_by = bound_ms(n_bytes, n_ops, flops, n_exp=float(bq) * bk, exp_per_s=exp_rate)
        warm = 2 if plain else 0
        dev_ms, dev_kernel_ms = device_ms(kernel, iters, kernel=name)
        ms = time_ms(kernel, iters, warm)
        row = {"shape": shape, "ms": ms, "tflops": n_ops / ms / 1e9, "bound_share": b_ms / ms,
               "bound_ms": b_ms, "bound_by": b_by, "device_ms": dev_ms,
               "kernel_device_ms": dev_kernel_ms, "plain_ms": None, "plain_device_ms": None,
               "library_ms": None}
        if plain:
            row.update(plain_ms=time_ms(plain_fn, iters), library_ms=time_ms(library, iters),
                       plain_device_ms=device_ms(plain_fn, iters)[0])
        rows.append(row)
    return rows[0], rows[1]


def check_fp32_route(exp_rate: float) -> dict:
    """fp32 operands at FP32_PAST_CAP_BATCH^2, D = 128, where the TPU's
    partials pass its cap and it takes its two kernels: ``flash_ce_bwd``
    takes the fused kernel (its wrapper launches once, rows 6 and 7 never)
    and agrees with the plain backward; rows 6 + 7, called directly
    (``flash_ce_bwd_twokernel``), agree with it too (:func:`check_twokernel`)
    and are timed beside their yardsticks and bounds
    (:func:`twokernel_rows`)."""
    import torch
    from recsys_tpu_torch.ops import flash_ce as F

    b, d = FP32_PAST_CAP_BATCH, 128
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    route = F.bwd_route(b, b, d, False)
    check(route == "fused" and F.fused_bwd_partials_bytes(b, b, d) > F._FUSED_BWD_PARTIALS_CAP,
          f"fp32 {b}^2: route {route}, want fused past the TPU's cap")
    args = _flash_args(b, b, d, torch.float32, SEED + 14, n_ids=max(2, b // 3))
    wrappers = ("flash_ce_bwd_fused", "flash_ce_bwd_du", "flash_ce_bwd_dv")
    before = {w: getattr(F, w).launches for w in wrappers}
    fused = check_twokernel(*args, bwd=F.flash_ce_bwd)
    moved = {w: getattr(F, w).launches - before[w] for w in wrappers}
    check(moved == {"flash_ce_bwd_fused": 1, "flash_ce_bwd_du": 0, "flash_ce_bwd_dv": 0},
          f"fp32 {b}^2: launches {moved}")
    res = check_twokernel(*args)
    du_row, dv_row = twokernel_rows(res["args"], 10, exp_rate, plain=True)
    du_row["max_abs_err"] = res["abs"]["dU"]
    dv_row["max_abs_err"] = max(res["abs"]["dV"], res["abs"]["dcol"])
    return {"route": route, "launches": moved, "fused_rel": fused["rel"],
            "fused_plan": F.bwd_plan(b, b, d, False, n_sm)._asdict(),
            "plan": F.du_plan(b, b, d, False, n_sm)._asdict(),
            "dv_plan": F.dv_plan(b, b, d, False, n_sm)._asdict(),
            "rel": res["rel"], "du": du_row, "dv": dv_row}


def time_routes(dtype) -> list:
    """Phase 17's route table: the fused backward and the two-kernel one
    (rows 6 + 7 with their parts' sums) of ``dtype`` operands, D = 128, at
    ROUTE_SHAPES, timed in turns (fused, two-kernel, two-kernel, fused: CUDA
    events), each with the device memory it allocates beyond its inputs
    (peak), beside the TPU's partials count and route and the route
    ``bwd_route`` takes."""
    import torch
    from recsys_tpu_torch.ops import flash_ce as F

    rows = []
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    bf16 = dtype == torch.bfloat16
    for bq, bk in ROUTE_SHAPES:
        t0 = time.perf_counter()
        u, v, c, ids_q, ids_k, pos, gr = _flash_args(bq, bk, 128, dtype, SEED + 22,
                                                     n_ids=max(2, bk // 3))
        lse, _ = F.flash_ce_fwd(u, v, c, ids_q, ids_k, pos)
        args = (u, v, c, ids_q, ids_k, pos, lse, gr)
        iters = 10 if bq * bk <= 1 << 30 else 2
        plan = F.bwd_plan(bq, bk, 128, bf16, n_sm)
        row = {"Bq": bq, "Bk": bk, "D": 128, "dtype": str(dtype).replace("torch.", ""),
               "tpu_route": ("fused" if F.fused_bwd_partials_bytes(bq, bk, 128)
                             <= F._FUSED_BWD_PARTIALS_CAP else "twokernel"),
               "route": F.bwd_route(bq, bk, 128, bf16),
               "tpu_partials_gb": F.fused_bwd_partials_bytes(bq, bk, 128) / 1e9,
               "fused_plan_partials_gb": plan.partials_bytes(bq, bk, 128) / 1e9,
               "fused_ms": [], "twokernel_ms": []}
        for name in ("fused", "twokernel", "twokernel", "fused"):
            fn = getattr(F, f"flash_ce_bwd_{name}")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            row[f"{name}_ms"].append(time_ms(lambda: fn(*args), iters, warmup=1))
            row[f"{name}_peak_extra_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        row["s"] = time.perf_counter() - t0
        rows.append(row)
        log(f"route {json.dumps(row)}")
        del u, v, args, lse
        torch.cuda.empty_cache()
    return rows


def twokernel_phases(sm_clock_mhz: float) -> dict:
    """Phases 16 and 17: rows 6 and 7 against their plain versions at the
    main path's shape and more, timed at Bq = Bk = 8,192 bf16, and rows 4
    and 7 at the edges of their tensor-core kernels
    (:func:`check_fwd_dv_edges`); then above the partials cap (131,072 x
    262,144, D = 128, bf16): the route is the two-kernel one; the forward,
    rows 6 and 7 and the fused kernel agree with their plain versions
    (which form ~1 GiB of logits at a time) and the two routes with each
    other; each kernel timed, its device time beside its bound; last the
    route table (:func:`time_routes`)."""
    import torch
    from recsys_tpu_torch.ops import flash_ce as F

    exp_rate = (SFU_EXP_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0)
                .multi_processor_count * sm_clock_mhz * 1e6)
    out = {"checks": []}
    bf, f32 = torch.bfloat16, torch.float32
    # the main path's shape, then edges: row 6 of bf16 operands runs on the
    # tensor cores (D padded to 32, 64, 128 or 256; two column slices past
    # 128; element-wise loads where D % 8 != 0; ragged query and candidate
    # tiles), fp32 on the FMA units
    for bq, bk, d, dt in ((8192, 8192, 128, bf), (8192, 8192, 128, f32),
                          (4096, 20480, 128, bf), (1000, 3001, 129, f32),
                          (1000, 3001, 64, bf), (777, 2050, 128, bf), (1000, 3001, 129, bf),
                          (300, 1100, 256, bf), (50, 70, 32, bf), (130, 4097, 24, bf)):
        res = check_twokernel(*_flash_args(bq, bk, d, dt, SEED + 12, n_ids=max(2, bk // 3)))
        out["checks"].append({"Bq": bq, "Bk": bk, "D": d, "dtype": str(dt), "abs": res["abs"],
                              "rel": res["rel"]})
        if (bq, bk, dt) == (8192, 8192, torch.bfloat16):
            # deterministic: no atomics, the parts summed in a fixed order
            first, again = F.flash_ce_bwd_du(*res["args"]), F.flash_ce_bwd_du(*res["args"])
            check(bool(torch.equal(first, again)), "row 6 at 8,192^2 bf16: two calls differ")
            del first, again
            out["main"] = twokernel_rows(res["args"], 10, exp_rate, plain=True)
            out["main"][0]["max_abs_err"] = res["abs"]["dU"]
            out["main"][1]["max_abs_err"] = max(res["abs"]["dV"], res["abs"]["dcol"])
        if (bq, bk, dt) == (8192, 8192, torch.float32):
            # the FMA kernels of rows 6 and 7 beside their fp32 yardsticks
            out["main_fp32"] = twokernel_rows(res["args"], 10, exp_rate, plain=True)
            out["main_fp32"][0]["max_abs_err"] = res["abs"]["dU"]
            out["main_fp32"][1]["max_abs_err"] = max(res["abs"]["dV"], res["abs"]["dcol"])
        del res
    log(f"rows 6 and 7 agree with their plain versions: {json.dumps(out['checks'])}")
    out["fwd_dv_edges"] = check_fwd_dv_edges()
    log(f"rows 4 and 7 (tensor cores) agree at their edges: {json.dumps(out['fwd_dv_edges'])}")
    out["fp32_route"] = check_fp32_route(exp_rate)
    log(f"fp32 {FP32_PAST_CAP_BATCH}^2 takes the fused kernel; rows 6 + 7 agree: "
        f"{json.dumps(out['fp32_route'])}")

    bq, bk, d = ABOVE_CAP
    route = F.bwd_route(bq, bk, d, True)
    check(route == "twokernel", f"{bq} x {bk}: route {route}, want twokernel")
    u, v, c, ids_q, ids_k, pos, gr = _flash_args(bq, bk, d, torch.bfloat16, SEED + 13,
                                                 n_ids=GIANT_ITEMS)
    what = f"above the cap, {bq} x {bk}"
    lse, pos_logit = F.flash_ce_fwd(u, v, c, ids_q, ids_k, pos)
    torch.cuda.synchronize()
    ref_lse, ref_pos = F.flash_ce_fwd_reference(u, v, c, ids_q, ids_k, pos)
    fwd_abs, fwd_rel = _errs((lse, pos_logit), (ref_lse, ref_pos))
    check(bool(torch.isfinite(lse).all()), f"{what}: non-finite lse")
    check(max(fwd_rel) <= FLASH_TOL, f"{what}: forward err {fwd_rel} > {FLASH_TOL}")
    del lse, pos_logit, ref_pos
    fwd = lambda: F.flash_ce_fwd(u, v, c, ids_q, ids_k, pos)
    n_ops = 2.0 * bq * bk * d
    b_ms, b_by = bound_ms((bq + bk) * d * 2 + 4 * (2 * bk + 4 * bq), n_ops, BF16_FLOPS,
                          n_exp=float(bq) * bk, exp_per_s=exp_rate)
    ms = time_ms(fwd, 2, 1)
    dev_ms, dev_kernel_ms = device_ms(fwd, 1, kernel="flash_ce_fwd_")
    out["above_fwd"] = {"shape": {"Bq": bq, "Bk": bk, "D": d, "dtype": "bfloat16"},
                        "max_abs_err": fwd_abs, "ms": ms, "tflops": n_ops / ms / 1e9,
                        "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                        "device_ms": dev_ms, "kernel_device_ms": dev_kernel_ms}
    args = (u, v, c, ids_q, ids_k, pos, ref_lse, gr)
    n_dv = F.flash_ce_bwd_dv.launches
    two = F.flash_ce_bwd_twokernel(*args)
    dv_again = F.flash_ce_bwd_dv(*args)
    check(F.flash_ce_bwd_dv.launches - n_dv == 2, f"{what}: row 7 launches "
          f"{F.flash_ce_bwd_dv.launches - n_dv}, want 2")
    check(all(bool(torch.equal(a, b)) for a, b in zip(two[1:], dv_again)),
          f"{what}: two row 7 calls differ")
    del dv_again
    fused = F.flash_ce_bwd_fused(*args)
    torch.cuda.synchronize()
    want = []
    plain_ms = {"du": time_ms(lambda: want.append(F.flash_ce_bwd_du_reference(*args)), 1, 0),
                "dv": time_ms(lambda: want.extend(F.flash_ce_bwd_dv_reference(*args)), 1, 0)}
    errs = {}
    tols = (FLASH_BF16_GRAD_TOL, FLASH_BF16_GRAD_TOL, FLASH_TOL)
    for label, got, ref in (("two-kernel vs plain", two, want),
                            ("fused vs plain", fused, want),
                            ("two-kernel vs fused", two, fused)):
        check(all(bool(torch.isfinite(t).all()) for t in got), f"{what}: {label}: non-finite")
        abs_err = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        rel_err = _errs(got, ref)[1]
        for name, err, tol in zip(("dU", "dV", "dcol"), rel_err, tols):
            check(err <= tol, f"{what}: {label}: {name} err {err} of max|ref| > {tol}")
        errs[label] = {"abs": dict(zip(("dU", "dV", "dcol"), abs_err)),
                       "rel": dict(zip(("dU", "dV", "dcol"), rel_err))}
    del two, fused, want
    torch.cuda.empty_cache()
    above = {"shape": {"Bq": bq, "Bk": bk, "D": d, "dtype": "bfloat16"}, "route": route,
             "fused_plan": F.bwd_plan(bq, bk, d, True, torch.cuda.get_device_properties(0)
                                      .multi_processor_count)._asdict(),
             "fwd_vs_plain": {"abs": fwd_abs, "rel": dict(zip(("lse", "pos_logit"), fwd_rel))},
             **errs}
    torch.cuda.empty_cache()
    out["above"] = twokernel_rows(args, 1, exp_rate, plain=False)
    two_abs = errs["two-kernel vs plain"]["abs"]
    for row, kind, err in zip(out["above"], ("du", "dv"),
                              (two_abs["dU"], max(two_abs["dV"], two_abs["dcol"]))):
        row.update(plain_ms=plain_ms[kind], max_abs_err=err)
    out["above_cap"] = above
    log(f"above the cap: {json.dumps(above)}")
    del args, u, v
    torch.cuda.empty_cache()
    out["routes"] = time_routes(torch.bfloat16)
    out["routes_fp32"] = time_routes(torch.float32)
    return out


def giant_bundle(seed: int) -> dict:
    """The giant-table bundle: GIANT_USERS users uniform, GIANT_ITEMS items
    with Zipf popularity, GIANT_STEPS batches of GIANT_BATCH train rows and
    GIANT_VAL val and test rows; ratings as in :func:`synthetic_bundle`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pop = np.arange(1, GIANT_ITEMS + 1, dtype=np.float64) ** -ZIPF_EXPONENT
    pop = pop[rng.permutation(GIANT_ITEMS)]
    pop /= pop.sum()
    n_train = GIANT_STEPS * GIANT_BATCH
    n = n_train + 2 * GIANT_VAL
    users = rng.integers(0, GIANT_USERS, n).astype(np.int32)
    items = rng.choice(GIANT_ITEMS, n, p=pop).astype(np.int32)
    fu = rng.standard_normal((GIANT_USERS, 8), dtype=np.float32)
    fi = rng.standard_normal((GIANT_ITEMS, 8), dtype=np.float32)
    score = (fu[users] * fi[items]).sum(axis=1) / np.sqrt(8.0)
    rating = np.clip(np.rint(3.5 + score + 0.5 * rng.standard_normal(n)), 1, 5)
    rating = rating.astype(np.float32)
    bundle = {"meta/n_users": np.int64(GIANT_USERS), "meta/n_movies": np.int64(GIANT_ITEMS),
              "meta/user_raw_ids": np.arange(1, GIANT_USERS + 1, dtype=np.int64),
              "meta/movie_raw_ids": np.arange(1, GIANT_ITEMS + 1, dtype=np.int64)}
    bounds = {"train": (0, n_train), "val": (n_train, n_train + GIANT_VAL),
              "test": (n_train + GIANT_VAL, n)}
    for split, (lo, hi) in bounds.items():
        bundle[f"{split}/user_id"] = users[lo:hi]
        bundle[f"{split}/movie_id"] = items[lo:hi]
        bundle[f"{split}/rating"] = rating[lo:hi]
        bundle[f"{split}/y_implicit"] = (rating[lo:hi] >= 4.0).astype(np.float32)
    return bundle


def giant_config():
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig

    return RecsysConfig(model=ModelConfig(),
                        train=TrainConfig(batch_size=GIANT_BATCH, epochs=1,
                                          negative_cache=GIANT_CACHE, optimizer="adagrad",
                                          sparse_table_updates="auto"))


def train_giant(bundle: dict, counters, out_dir: str) -> dict:
    """Phase 18: the giant-table configuration through ``Trainer.train``
    on the card, every kernel counter set to 0 just before and read just
    after: one epoch, the sparse step every time, rows 6 and 7 once per
    step each and the fused backward never, and the cache's FIFO holding
    the last batch's ids."""
    import json as _json
    import math

    import torch
    from recsys_tpu_torch.train import checkpoint as ckpt_lib
    from recsys_tpu_torch.train import trainer as trainer_mod

    cfg = giant_config()
    trainer = trainer_mod.Trainer(cfg, out_dir, device="cuda")
    last_ids = [None]
    cache_update = trainer._cache_update

    def spy(state, params, batch):  # the batch the FIFO advances by
        last_ids[0] = batch["movie_id"]
        return cache_update(state, params, batch)

    trainer._cache_update = spy
    walls = {"evaluate_s": 0.0, "inference_bundle_s": 0.0}

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                walls[key] += time.perf_counter() - t0
        return run

    evaluate, save_bundle = trainer_mod.evaluate, ckpt_lib.save_inference_bundle
    trainer_mod.evaluate = timed("evaluate_s", evaluate)
    ckpt_lib.save_inference_bundle = timed("inference_bundle_s", save_bundle)
    try:
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        report = trainer.train(bundle)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.name: c.read() for c in counters}
    finally:
        trainer_mod.evaluate, ckpt_lib.save_inference_bundle = evaluate, save_bundle
    with open(os.path.join(out_dir, "detailed_metrics.json")) as f:
        hist = _json.load(f)["epochs"]
    check(len(hist) == 1, f"giant: {len(hist)} epochs logged")
    for k in ("train_loss", "val_loss", "train_retrieval_loss"):
        check(math.isfinite(hist[0][k]), f"giant: {k} = {hist[0][k]}")
    check(trainer.step_counts == {"dense": 0, "sparse": GIANT_STEPS},
          f"giant: steps taken {trainer.step_counts}, want {GIANT_STEPS} sparse")
    for name in ("flash_ce_bwd_du", "flash_ce_bwd_dv"):
        check(launches[name] == GIANT_STEPS,
              f"giant: {name} launched {launches[name]} times in {GIANT_STEPS} steps")
    check(launches["flash_ce_bwd_fused"] == 0, "giant: the fused backward ran on bf16 operands")
    check(launches["flash_ce_fwd"] >= GIANT_STEPS, "giant: the flash forward did not run")
    extras = trainer.final_state.extras
    check(torch.equal(extras["ids"], last_ids[0].to(extras["ids"].dtype)),
          "giant: the cache does not hold the last batch's ids")
    check(bool((extras["corr"] > -1e8).all()), "giant: the cache kept an empty slot")
    for rel in ("serving/model.npz", "serving/encoder.npz", "serving/index.npz"):
        check(os.path.exists(os.path.join(out_dir, rel)), f"giant: {rel} missing")
    check(math.isfinite(report["recall@10"]), f"giant: recall@10 {report['recall@10']}")
    epoch_s = hist[0]["epoch_time_s"]
    return {"trainer": trainer, "launches": launches, "wall_s": wall,
            "epoch_time_s": epoch_s, "steps_per_s": GIANT_STEPS / epoch_s,
            "examples_per_s": hist[0]["examples_per_s"], "train_loss": hist[0]["train_loss"],
            "val_loss": hist[0]["val_loss"], "recall@10": report["recall@10"],
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, **walls}


def profile_giant_step(trainer, bundle: dict) -> dict:
    """Phase 19: whole steps of the giant-table configuration, continuing
    from the trained state, profiled by :func:`profile_call`: device ms by
    kernel (forward, row 6, row 7, the rest), launches and busy share; the
    sparse update's span on the stream from CUDA events around
    ``_sparse_apply`` (its kernels and the host gaps between them)."""
    import numpy as np
    import torch
    from recsys_tpu_torch.models.losses import balanced_class_weights

    cw = balanced_class_weights(bundle["train/y_implicit"])
    batches = _batches(bundle, 2, GIANT_BATCH, "cuda", _log_q(bundle))
    step = trainer.make_train_step(cw)
    holder = [trainer.final_state]
    spans = []
    sparse_apply = trainer._sparse_apply

    def timed_apply(*a):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        sparse_apply(*a)
        end.record()
        spans.append((start, end))

    trainer._sparse_apply = timed_apply

    def one():
        holder[0], _ = step(holder[0], batches[holder[0].step % 2])

    row = profile_call("train_step_giant", one, n_wall=3, n_traced=2, warmup=1,
                       groups={"flash_fwd": "flash_ce_fwd_",
                               "row6_du": "flash_ce_bwd_du_",
                               "row7_dv": "flash_ce_bwd_dv_"})
    torch.cuda.synchronize()
    row["sparse_update_span_ms"] = float(np.median([s.elapsed_time(e) for s, e in spans]))
    launches = row["group_launches"]
    check(launches["row6_du"] == launches["row7_dv"] == 1 and launches["flash_fwd"] == 1,
          f"giant step profile: launches per step {launches}")
    return row


def card_vs_cpu_scale(tmp: str) -> dict:
    """Phase 20: 3 steps of a small-width model (embedding 32, tables of
    5,000 x 3,000) at B = 2,048 with a 6,144-row cache and sparse adagrad
    (8,192 candidates: bf16 operands, so rows 6 and 7), on the card through
    the kernels and on the CPU through the plain versions, from one init,
    on the same batches."""
    import numpy as np
    import torch
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig
    from recsys_tpu_torch.models.losses import balanced_class_weights
    from recsys_tpu_torch.models.multitask import MultiTaskModel
    from recsys_tpu_torch.ops import flash_ce as F
    from recsys_tpu_torch.train.checkpoint import params_from_numpy, params_to_numpy
    from recsys_tpu_torch.train.optimizer import leaves_with_paths
    from recsys_tpu_torch.train.trainer import Trainer

    n_users, n_items, b, cache = 5000, 3000, 2048, 6144
    cfg = RecsysConfig(model=ModelConfig(embedding_dim=32, dropout_rate=0.0, use_flash_ce=True),
                       train=TrainConfig(batch_size=b, negative_cache=cache,
                                         sparse_table_updates=True))
    init = params_to_numpy(MultiTaskModel.init(torch.Generator().manual_seed(SEED + 14),
                                               cfg.model, n_users, n_items, "cpu"))
    rng = np.random.default_rng(SEED + 15)
    pop = np.arange(1, n_items + 1, dtype=np.float64) ** -ZIPF_EXPONENT
    pop /= pop.sum()
    rows = PARITY_STEPS * b
    rating = rng.integers(1, 6, rows).astype(np.float32)
    small = {"meta/n_movies": np.int64(n_items),
             "train/user_id": rng.integers(0, n_users, rows).astype(np.int32),
             "train/movie_id": rng.choice(n_items, rows, p=pop).astype(np.int32),
             "train/rating": rating, "train/y_implicit": (rating >= 4).astype(np.float32)}
    cw = balanced_class_weights(small["train/y_implicit"])
    check(F.bwd_route(b, b + cache, 32, True) == "twokernel", "card vs CPU: not on rows 6 and 7")
    runs = {}
    for device in ("cuda", "cpu"):
        F.flash_ce_bwd_du.launches = F.flash_ce_bwd_dv.launches = 0
        tr = Trainer(cfg, os.path.join(tmp, f"scale_parity_{device}"), device=device)
        state = tr.state_from_params(params_from_numpy(init, device), SEED)
        step = tr.make_train_step(cw)
        loss = []
        for batch in _batches(small, PARITY_STEPS, b, device, _log_q(small)):
            state, m = step(state, batch)
            loss.append(float(m["loss"]))
        runs[device] = {
            "loss": loss, "steps": dict(tr.step_counts),
            "launches": (F.flash_ce_bwd_du.launches, F.flash_ce_bwd_dv.launches),
            "params": dict(leaves_with_paths(params_to_numpy(state.params))),
            "cache_ids": state.extras["ids"].cpu().numpy()}
    gpu, cpu = runs["cuda"], runs["cpu"]
    check(gpu["launches"] == (PARITY_STEPS, PARITY_STEPS) and cpu["launches"] == (0, 0),
          f"card vs CPU: rows 6/7 launches {gpu['launches']} (card), {cpu['launches']} (CPU)")
    check(gpu["steps"]["sparse"] == cpu["steps"]["sparse"] == PARITY_STEPS,
          "card vs CPU: not the sparse step")
    check(np.array_equal(gpu["cache_ids"], cpu["cache_ids"]), "card vs CPU: cache ids differ")
    loss_err = max(abs(a - c) / abs(c) for a, c in zip(gpu["loss"], cpu["loss"]))
    check(loss_err <= PARITY_LOSS_RTOL,
          f"card vs CPU: loss {gpu['loss']} vs {cpu['loss']} ({loss_err})")
    param_err, worst = 0.0, ""
    for path, want in cpu["params"].items():
        err = float(np.abs(gpu["params"][path] - want).max())
        if err > param_err:
            param_err, worst = err, "/".join(path)
    check(param_err <= PARITY_PARAM_ATOL,
          f"card vs CPU: params differ by {param_err} at {worst} > {PARITY_PARAM_ATOL}")
    return {"loss_card": gpu["loss"], "loss_cpu": cpu["loss"], "loss_max_rel_err": loss_err,
            "param_max_abs_err": param_err, "param_worst": worst,
            "launches_card": gpu["launches"]}


def sparse_vs_dense_scale_row() -> list:
    """Phase 21: a step of the ``"train"`` row of
    ``benchmarks/results/scale.json`` (4,000,000 users x 2,000,000 items,
    dim 64, B = 4,096, mixed precision, dropout 0.2, uniform ids) with
    adagrad and adam (lazy on the sparse side), sparse and dense, profiled
    by :func:`profile_call`: step wall p50 and device ms."""
    import numpy as np
    import torch
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig
    from recsys_tpu_torch.models.multitask import MultiTaskModel
    from recsys_tpu_torch.train.trainer import Trainer

    model = ModelConfig(embedding_dim=SCALE_ROW_DIM, mixed_precision=True, dropout_rate=0.2)
    init = MultiTaskModel.init(torch.Generator().manual_seed(SEED + 16), model, GIANT_USERS,
                               GIANT_ITEMS, "cpu")
    rng = np.random.default_rng(SEED + 17)
    b = SCALE_ROW_BATCH
    batch = {"user_id": rng.integers(0, GIANT_USERS, b).astype(np.int32),
             "movie_id": rng.integers(0, GIANT_ITEMS, b).astype(np.int32),
             "rating": rng.uniform(1, 5, b).astype(np.float32),
             "y_implicit": (rng.random(b) > 0.4).astype(np.float32),
             "log_q": np.full(b, -np.log(GIANT_ITEMS), np.float32)}
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for opt_name in ("adagrad", "adam"):
            for sparse in (True, False):
                cfg = RecsysConfig(model=model, train=TrainConfig(
                    batch_size=b, optimizer=opt_name, sparse_table_updates=sparse))
                tr = Trainer(cfg, tmp, device="cuda")
                holder = [tr.state_from_params(init, SEED)]
                step = tr.make_train_step((1.3, 0.8))

                def one():
                    holder[0], _ = step(holder[0], batch)

                label = f"scale_train_{opt_name}_{'sparse' if sparse else 'dense'}"
                rows.append(profile_call(label, one, n_wall=10, n_traced=3, warmup=2))
                check(tr.step_counts["sparse" if sparse else "dense"] == 15,
                      f"{label}: steps {tr.step_counts}")
                del holder, step, tr
                torch.cuda.empty_cache()
    return rows


# ---- data and features: the fifth main path --------------------------------

def write_raw_movielens(d: str, seed: int) -> None:
    """ML-1M-shaped raw files from ``seed``: movies.dat (3,883 movies, ids 1
    to 3,883, one to three genres from ``GENRES``, a year in each title but
    every 61st, one latin-1 title) and users.dat (6,040 users: gender, age
    code, occupation, zip); ``::``-separated, latin-1."""
    import numpy as np
    from recsys_tpu_torch.data.movielens import GENRES

    rng = np.random.default_rng(seed)
    with open(os.path.join(d, "movies.dat"), "w", encoding="latin-1") as f:
        for m in range(1, N_ITEMS + 1):
            genres = "|".join(sorted(set(rng.choice(GENRES, rng.integers(1, 4)).tolist())))
            title = f"Movie {m} ({1919 + m % 82})" if m % 61 else f"Movie {m}"
            if m == 5:
                title = "Amélie (Le Fabuleux destin d'Amélie Poulain) (2001)"
            f.write(f"{m}::{title}::{genres}\n")
    ages = (1, 18, 25, 35, 45, 50, 56)
    with open(os.path.join(d, "users.dat"), "w", encoding="latin-1") as f:
        for u in range(1, N_USERS + 1):
            f.write(f"{u}::{'MF'[rng.integers(2)]}::{ages[rng.integers(7)]}::"
                    f"{rng.integers(21)}::{rng.integers(10_000, 100_000)}\n")


def _call_cli(main_fn, argv) -> tuple:
    """An entry point's ``main(argv)`` in this process, so the launch
    counters see its kernels, its standard output captured -> (rc, stdout)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    return rc, buf.getvalue()


def same_topk(got, want, tol: float, what: str) -> float:
    """Two (scores [Q, k], ids [Q, k]) results: scores within ``tol``, ids
    equal except among scores within ``tol`` of a row's k-th. -> max score
    difference."""
    import numpy as np

    (gs, gi), (ws, wi) = got, want
    check(gs.shape == ws.shape and gi.shape == wi.shape, f"{what}: shapes")
    err = float(np.abs(gs - ws).max())
    check(err <= tol, f"{what}: score differs by {err} > {tol}")
    for q in range(gs.shape[0]):
        edge = ws[q, -1] + tol
        check(set(gi[q][gs[q] > edge].tolist()) <= set(wi[q].tolist())
              and set(wi[q][ws[q] > edge].tolist()) <= set(gi[q].tolist()),
              f"{what}: row {q} differs beyond ties")
    return err


def profile_dense_train_step(bundle: dict, model_cfg, tmp: str) -> dict:
    """The trained configuration's train step at B = 8,192 with the dense
    column (the engineer fitted on the host, its fit and transform timed),
    profiled by :func:`profile_call`, the cross stack's kernels (rows 2 and
    3) and the flash kernels apart."""
    import torch
    from recsys_tpu_torch.config import RecsysConfig, TrainConfig
    from recsys_tpu_torch.data.features import make_engineer
    from recsys_tpu_torch.models.losses import balanced_class_weights
    from recsys_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    feats = make_engineer(bundle, model_cfg.dense_features).fit_transform_splits(bundle)
    fit_s = time.perf_counter() - t0
    batches = _batches(bundle, 2, TRAIN_BATCH, "cuda", _log_q(bundle))
    for i, batch in enumerate(batches):
        batch["dense"] = torch.as_tensor(
            feats["train"][i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]).to("cuda")
    tr = Trainer(RecsysConfig(model=model_cfg, train=TrainConfig(batch_size=TRAIN_BATCH)),
                 tmp, device="cuda")
    holder = [tr.init_state(int(bundle["meta/n_users"]), int(bundle["meta/n_movies"]), SEED)]
    step = tr.make_train_step(balanced_class_weights(bundle["train/y_implicit"]))

    def one():
        holder[0], _ = step(holder[0], batches[holder[0].step % 2])

    row = profile_call("train_step_B8192_dense_features_F289", one, n_wall=20, n_traced=5,
                       warmup=2, groups={"row2_dcn_fwd": "dcn_cross_fwd",
                                         "row3_dcn_bwd": "dcn_cross_bwd_smem",
                                         "row3_reduce": "dcn_cross_bwd_reduce",
                                         "row4_fwd": "flash_ce_fwd",
                                         "row6_du": "flash_ce_bwd_du",
                                         "row7_dv": "flash_ce_bwd_dv"})
    row["host_feature_fit_transform_s"] = fit_s
    return row


def dense_feature_path(repo: str, counters, tmp: str) -> dict:
    """Phase 22: raw files -> ``python -m recsys_tpu_torch.preprocess`` ->
    the train, evaluate and export entry points with the engineered dense
    features and the side tables at the flagship widths (F = 289 into the
    cross stack) -> the service's rerank with features and its exported
    backend, held against the CPU and the exact route; every kernel counter
    set to 0 just before training and serving and read just after."""
    import math
    import shutil

    import numpy as np
    import torch
    from recsys_tpu_torch import evaluate as eval_cli
    from recsys_tpu_torch import export as export_cli
    from recsys_tpu_torch.config import RecsysConfig
    from recsys_tpu_torch.data.preprocessing import load_bundle
    from recsys_tpu_torch.models import layers as L
    from recsys_tpu_torch.models.towers import TwoTower
    from recsys_tpu_torch.ops import dcn_cross as D
    from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
    from recsys_tpu_torch.serve.export import (
        DEFAULT_ARTIFACT, bundle_fingerprint, load_exported,
    )
    from recsys_tpu_torch.serve.service import RecommendationService
    from recsys_tpu_torch.train import __main__ as train_cli

    out = {}
    raw, data = os.path.join(tmp, "raw"), os.path.join(tmp, "bundle.npz")
    os.makedirs(raw)
    write_raw_movielens(raw, SEED)
    # preprocess: a process of its own, as a user runs it (numpy only)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "recsys_tpu_torch.preprocess",
                           "--data_dir", raw, "--output", data],
                          cwd=repo, capture_output=True, text=True, timeout=600)
    out["preprocess_s"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"preprocess CLI: rc {proc.returncode}\n{proc.stderr[-4000:]}")
    qa = json.loads(proc.stdout.strip().splitlines()[-1])
    bundle = load_bundle(data)
    rows = {s: len(bundle[f"{s}/user_id"]) for s in ("train", "val", "test")}
    check(all(qa[f"{s}_rows"] == n > 0 for s, n in rows.items()), f"preprocess QA {qa}")
    check(int(bundle["meta/n_users"]) == N_USERS, "preprocess: users")
    n_items = int(bundle["meta/n_movies"])
    out.update(qa=qa, n_ratings=sum(rows.values()), n_items=n_items)

    # train through the CLI's main, in this process so the counters see it
    run = os.path.join(tmp, "run")
    argv = ["--data", data, "--output_dir", run, "--use_dense_features",
            "--use_side_features", "--embedding_dim", "128", "--cross_layers", "3",
            "--batch_size", str(TRAIN_BATCH), "--epochs", str(TRAIN_EPOCHS),
            "--device", "cuda"]
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    rc, _ = _call_cli(train_cli.main, argv)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    train_launches = {c.name: c.read() for c in counters}
    check(rc == 0, f"train CLI: rc {rc}")
    serving = os.path.join(run, "serving")
    cfg = RecsysConfig.load(os.path.join(serving, "config.json"))
    m = cfg.model
    check(2 * m.embedding_dim + m.dense_features == DENSE_F and m.cross_layers == 3
          and m.mixed_precision, f"train CLI config: {m}")
    steps = rows["train"] // TRAIN_BATCH
    for name in ("dcn_cross", "flash_ce_fwd", "flash_ce_bwd_du", "flash_ce_bwd_dv",
                 "topk_flash"):
        check(train_launches[name] > 0, f"{name} never launched on the dense-feature path")
    check(train_launches["dcn_cross_bwd"] == TRAIN_EPOCHS * steps,
          f"the DCN backward launched {train_launches['dcn_cross_bwd']} times in "
          f"{TRAIN_EPOCHS * steps} steps")
    check(train_launches["flash_ce_bwd_fused"] == 0, "the fused backward ran on bf16 operands")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = D.bwd_plan(TRAIN_BATCH, DENSE_F, 3, n_sm)
    check(not plan.registers, f"F = {DENSE_F}: the backward's plan {plan}")
    with open(os.path.join(run, "detailed_metrics.json")) as f:
        hist = json.load(f)["epochs"]
    for e in hist:
        for k in ("train_loss", "val_loss", "train_rating_mse"):
            check(math.isfinite(e[k]), f"dense train: epoch {e['epoch']} {k} = {e[k]}")
    with open(os.path.join(run, "metrics.json")) as f:
        final = json.load(f)
    check(math.isfinite(final["rating_rmse"]) and 0 <= final["recall@10"] <= 1,
          f"dense train: final metrics {final}")
    check(os.path.exists(os.path.join(serving, "features.npz")), "no features.npz")
    out.update(train_launches=train_launches, steps_per_epoch=steps, bwd_plan=plan._asdict(),
               epoch_losses=[e["train_loss"] for e in hist],
               examples_per_s=[e["examples_per_s"] for e in hist],
               recall_at_10=final["recall@10"], rating_rmse=final["rating_rmse"],
               ctr_auc=final.get("ctr_auc"))

    # serve with rerank and features, held against the CPU plain path
    served = serve_main_path(serving, counters, n_items=n_items)
    svc, batch = served["service"], served["batch"]
    check(svc.feature_engineer is not None and svc._rerank_active(),
          "the dense-feature bundle did not rerank with its features")
    check(served["launches"]["topk_flash"] > 0 and served["launches"]["dcn_cross"] > 0,
          f"dense-feature serving: launches {served['launches']}")
    out["serve"] = {"launches": served["launches"], "latency": served["latency"],
                    "max_score_diff": served["max_score_diff"]}
    eng = svc.feature_engineer
    transform_ms = {}
    for q in (1, BATCH_USERS):
        ids = np.array([svc.user_id_map[u] for u in batch[:q]])
        _, cand = svc._retrieve(ids, RERANK)
        users, items = np.repeat(ids, RERANK), np.asarray(cand).reshape(-1)
        now = np.full(len(users), eng.t_ref)
        times = []
        for _ in range(21):
            t0 = time.perf_counter()
            eng.transform_scaled(users, items, now)
            times.append((time.perf_counter() - t0) * 1e3)
        transform_ms[f"q{q}"] = sorted(times)[len(times) // 2]
    out["host_transform_scaled_ms_p50"] = transform_ms
    out["profiles"] = [dict(r, profile=r["profile"] + "_dense_features")
                       for r in profile_requests(svc, batch)]

    # evaluate: rerank 200, seen-filtered, through the CLI's main
    report_path = os.path.join(tmp, "eval.json")
    t0 = time.perf_counter()
    rc, _ = _call_cli(eval_cli.main, ["--data", data, "--model_dir", serving,
                                      "--rerank_candidates", str(RERANK), "--filter_seen",
                                      "--device", "cuda", "--output", report_path])
    out["evaluate_s"] = time.perf_counter() - t0
    check(rc == 0, f"evaluate CLI: rc {rc}")
    with open(report_path) as f:
        report = json.load(f)
    for key in ("recall@10", "ndcg@10", "two_stage_recall@10", "rating_rmse", "ctr_auc"):
        check(isinstance(report.get(key), float) and math.isfinite(report[key]),
              f"dense evaluate CLI: {key} = {report.get(key)}")
    out["evaluate"] = {k: report[k] for k in ("recall@10", "ndcg@10", "two_stage_recall@10",
                                              "two_stage_ndcg@10", "rating_rmse", "ctr_auc")}

    # export top-200 on the card; the artifact on the card and on the CPU
    # against the service's exact route
    t0 = time.perf_counter()
    rc, text = _call_cli(export_cli.main, ["--model_dir", serving, "--k", str(RERANK),
                                           "--device", "cuda"])
    out["export_s"] = time.perf_counter() - t0
    check(rc == 0, f"export CLI: rc {rc}")
    meta = json.loads(text[text.index("{"):])
    check(meta["k"] == RERANK and meta["platforms"] == ["cpu", "cuda"]
          and meta["source_fingerprint"] == bundle_fingerprint(serving),
          f"export metadata {meta}")
    artifact = os.path.join(serving, DEFAULT_ARTIFACT)
    on_card, on_cpu = load_exported(artifact, "cuda"), load_exported(artifact, "cpu")
    exact = RecommendationService(serving, device="cuda").load()
    errs = {}
    for q in (1, BATCH_USERS):
        ids = np.array([exact.user_id_map[u] for u in batch[:q]])
        got = on_card(ids)
        check(got[0].shape == (q, RERANK) and np.isfinite(got[0]).all(), "artifact output")
        errs[f"q{q}_vs_exact"] = same_topk(got, exact._retrieve(ids, RERANK), EXPORT_TOL,
                                           f"artifact vs exact route, {q} users")
        errs[f"q{q}_cpu_vs_card"] = same_topk(on_cpu(ids), got, EXPORT_TOL,
                                              f"artifact on the CPU vs the card, {q} users")
    exported = RecommendationService(serving, backend="exported", rerank_candidates=RERANK,
                                     device="cuda").load()
    for c in counters:
        c.reset()
    got_one, got_batch = exported.recommend(1, 10), exported.recommend_batch(batch, 10)
    exported_launches = {c.name: c.read() for c in counters}
    # the exported backend reranks on the host (_FastRerank, fp32), as the
    # JAX package's does: held against itself served on the CPU, and its
    # distance to the device rerank (bf16 operands) recorded
    exported_cpu = RecommendationService(serving, backend="exported",
                                         rerank_candidates=RERANK, device="cpu").load()
    diff = same_ranking(got_one, exported_cpu.recommend(1, 10), SERVE_TOL,
                        "exported backend, known user, card vs CPU")
    vs_device = 0.0
    for a, b, c in zip(got_batch, exported_cpu.recommend_batch(batch, 10),
                       svc.recommend_batch(batch, 10)):
        diff = max(diff, same_ranking(a["recommendations"], b["recommendations"], SERVE_TOL,
                                      f"exported backend, user {a['user_id']}, card vs CPU"))
        vs_device = max(vs_device, max(abs(x["score"] - y["score"]) for x, y in zip(
            a["recommendations"], c["recommendations"])))
    check(exported._fast_rerank is not None, "the exported backend's _FastRerank failed")
    check(exported_launches["dcn_cross"] == 0 and exported_launches["topk_flash"] == 0,
          f"exported backend launches {exported_launches}")
    check("exported" in exported.get_model_info()["backend"], "exported backend info")
    stale = os.path.join(tmp, "stale")
    shutil.copytree(serving, stale)
    idx = RetrievalIndex.load(os.path.join(stale, "index.npz"), "cpu")
    RetrievalIndex(idx.item_embeddings_np[::-1].copy(), idx.item_raw_ids[::-1].copy(),
                   device="cpu").save(os.path.join(stale, "index.npz"))
    try:
        RecommendationService(stale, backend="exported", device="cuda").load()
        refused = ""
    except ValueError as e:
        refused = str(e)
    check("different bundle" in refused, "a rebuilt index.npz was served by a stale artifact")
    out["export"] = {"meta": meta, "max_score_diff": errs, "exported_rerank_diff": diff,
                     "exported_rerank_max_score_diff_vs_device": vs_device,
                     "launches": exported_launches}
    for q in (1, BATCH_USERS):
        ids = np.array([exact.user_id_map[u] for u in batch[:q]])
        out["profiles"].append(profile_call(f"exported_retrieve_q{q}_k{RERANK}",
                                            lambda: on_card(ids)))
        out["profiles"].append(profile_call(f"exact_route_retrieve_q{q}_k{RERANK}",
                                            lambda: exact._retrieve(ids, RERANK)))

    # rows 2 and 3 at F = 289: the rerank's x0 (64 users x 200 candidates)
    # and a train batch
    with torch.inference_mode():
        ids = torch.as_tensor([svc.user_id_map[u] for u in batch], device="cuda")
        _, cand = svc.index.search(svc._user_embedding(ids.cpu().numpy()), RERANK)
        flat_u = ids.repeat_interleave(RERANK)
        flat_i = torch.as_tensor(cand.reshape(-1), device="cuda")
        u_emb, v_emb = TwoTower.apply(svc.model_params["towers"], m, flat_u, flat_i)
        dense = torch.as_tensor(eng.transform_scaled(
            flat_u.cpu().numpy(), cand.reshape(-1),
            np.full(flat_u.shape[0], eng.t_ref)), device="cuda")
        x0 = L.round_bf16(torch.cat([u_emb, v_emb, dense], dim=-1)).contiguous()
        cross = svc.model_params["dcn"]["cross"]
        w = torch.stack([cross[f"layer_{i}"]["w"] for i in range(m.cross_layers)])
        b = torch.stack([cross[f"layer_{i}"]["b"] for i in range(m.cross_layers)])
        out["dcn_fwd"] = measure_dcn(x0, w, b, iters=50)
    out["dcn_bwd"] = measure_dcn_bwd(TRAIN_BATCH, iters=50, f=DENSE_F)
    out["profiles"].append(profile_dense_train_step(bundle, m, os.path.join(tmp, "step")))
    return out


# ---- explicit negatives and the streaming input path: the sixth main path ----

def _mid_epoch_ckpts(run: str) -> list:
    """The steps of ``run``'s checkpoints that a streaming epoch saved
    mid-epoch (their metrics.json says ``mid_epoch``)."""
    ckpt_dir = os.path.join(run, "checkpoints")
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("ckpt_"):
            with open(os.path.join(ckpt_dir, name, "metrics.json")) as f:
                if "mid_epoch" in json.load(f):
                    steps.append(int(name[5:]))
    return sorted(steps)


def negatives_cli_run(name: str, argv: list, counters, run: str, steps: int) -> dict:
    """One phase 23 training run through the train CLI's ``main`` (in this
    process, so the counters see it), every counter set to 0 just before
    and read just after: rows 2, 3, 4, 6 and 7 launched (row 3 once a
    step, the fused backward never), finite losses, the serving bundle."""
    import math

    import torch
    from recsys_tpu_torch.train import __main__ as train_cli

    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    rc, _ = _call_cli(train_cli.main, argv + ["--output_dir", run])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {c.name: c.read() for c in counters}
    check(rc == 0, f"{name}: train CLI rc {rc}")
    for kernel in NEG_PATH_KERNELS:
        check(launches[kernel] > 0, f"{name}: {kernel} never launched")
    check(launches["dcn_cross_bwd"] == steps,
          f"{name}: the DCN backward launched {launches['dcn_cross_bwd']} times in {steps} steps")
    check(launches["flash_ce_bwd_fused"] == 0, f"{name}: the fused backward ran on bf16")
    with open(os.path.join(run, "detailed_metrics.json")) as f:
        hist = json.load(f)["epochs"]
    check(len(hist) == 1, f"{name}: {len(hist)} epochs logged")
    for k in ("train_loss", "train_retrieval_loss", "val_loss", "val_retrieval_loss"):
        check(math.isfinite(hist[0][k]), f"{name}: {k} = {hist[0][k]}")
    for rel in ("metrics.json", "serving/model.npz", "serving/encoder.npz",
                "serving/index.npz", "serving/vocabs.json", "serving/config.json"):
        check(os.path.exists(os.path.join(run, rel)), f"{name}: {rel} missing")
    with open(os.path.join(run, "metrics.json")) as f:
        final = json.load(f)
    check(math.isfinite(final["recall@10"]) and 0 <= final["recall@10"] <= 1,
          f"{name}: recall@10 {final['recall@10']}")
    e = hist[0]
    return {"launches": launches, "train_s": train_s, "steps": steps,
            "train_loss": e["train_loss"], "train_retrieval_loss": e["train_retrieval_loss"],
            "val_loss": e["val_loss"], "epoch_time_s": e["epoch_time_s"],
            "steps_per_s": steps / e["epoch_time_s"], "examples_per_s": e["examples_per_s"],
            "recall@10": final["recall@10"]}


def stream_card_vs_cpu(bundle: dict, counters, tmp: str) -> dict:
    """3 streaming steps with fed mixed negatives (20 + 30 a row) from one
    full-width init, dropout 0, B = 8,192, through ``_stream_epoch`` (a
    2-step chunk, then a single step; ``_prefetch`` and the side-stream
    placer on the card, ``torch.as_tensor`` on the CPU), on the card
    (kernels) and on the CPU (plain versions), held to phase 10's
    tolerances: the copies never race the step."""
    import itertools

    import numpy as np
    import torch
    from recsys_tpu_torch.config import DataConfig, ModelConfig, RecsysConfig, TrainConfig
    from recsys_tpu_torch.data.negative_sampling import NegativeSampler
    from recsys_tpu_torch.data.pipeline import Batcher
    from recsys_tpu_torch.models.losses import balanced_class_weights
    from recsys_tpu_torch.models.multitask import MultiTaskModel
    from recsys_tpu_torch.train.checkpoint import params_from_numpy, params_to_numpy
    from recsys_tpu_torch.train.optimizer import leaves_with_paths
    from recsys_tpu_torch.train.trainer import Trainer, _Placer

    cfg = RecsysConfig(model=ModelConfig(dropout_rate=0.0, use_flash_ce=True),
                       data=DataConfig(negative_sampling="mixed", num_hard_negatives=NEG_HARD,
                                       num_random_negatives=NEG_RANDOM),
                       train=TrainConfig(batch_size=TRAIN_BATCH, log_every_steps=1))
    init = params_to_numpy(MultiTaskModel.init(torch.Generator().manual_seed(SEED + 3),
                                               cfg.model, N_USERS, N_ITEMS, "cpu"))
    cw = balanced_class_weights(bundle["train/y_implicit"])
    log_q = _log_q(bundle)
    sampler = NegativeSampler("mixed", NEG_HARD, NEG_RANDOM, seed=SEED).fit(
        bundle["train/user_id"], bundle["train/movie_id"], N_ITEMS)
    host = [{**b, "log_q": log_q[b["movie_id"]], "neg_ids": sampler.sample_batch(b["user_id"])}
            for b in itertools.islice(Batcher(bundle, "train", TRAIN_BATCH, seed=SEED).epoch(0),
                                      PARITY_STEPS)]
    runs = {}
    for device in ("cuda", "cpu"):
        tr = Trainer(cfg, os.path.join(tmp, f"stream_parity_{device}"), device=device)
        state = tr.state_from_params(params_from_numpy(init, device), SEED)
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        state, n_steps, logs = tr._stream_epoch(
            state, 0, iter(host), lambda b: b, _Placer(tr.device),
            tr.make_train_step(cw, True), tr.make_train_chunk(cw, True, 2), 2)
        if device == "cuda":
            torch.cuda.synchronize()
            launches = {c.name: c.read() for c in counters}
            check(all(launches[k] > 0 for k in NEG_PATH_KERNELS)
                  and launches["dcn_cross_bwd"] == PARITY_STEPS,
                  f"stream parity: card launches {launches}")
        check(n_steps == PARITY_STEPS and state.step == PARITY_STEPS,
              f"stream parity: {n_steps} steps on {device}")
        runs[device] = {"loss": logs["train_loss"], "s": time.perf_counter() - t0,
                        "params": dict(leaves_with_paths(params_to_numpy(state.params)))}
    gpu, cpu = runs["cuda"], runs["cpu"]
    loss_err = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    check(loss_err <= PARITY_LOSS_RTOL,
          f"stream parity: loss {gpu['loss']} vs CPU {cpu['loss']} ({loss_err})")
    param_err, worst = 0.0, ""
    for path, want in cpu["params"].items():
        err = float(np.abs(gpu["params"][path] - want).max())
        if err > param_err:
            param_err, worst = err, "/".join(path)
    check(param_err <= PARITY_PARAM_ATOL,
          f"stream parity: params differ by {param_err} at {worst} > {PARITY_PARAM_ATOL}")
    moved = max(float(np.abs(cpu["params"][p] - np.asarray(v)).max())
                for p, v in leaves_with_paths(init))
    return {"loss_card": gpu["loss"], "loss_cpu": cpu["loss"], "loss_rel_err": loss_err,
            "param_max_abs_err": param_err, "param_worst": worst, "param_max_move": moved,
            "card_s": gpu["s"], "cpu_s": cpu["s"], "card_launches": launches}


def profile_negatives_steps(bundle: dict, model_cfg, table) -> dict:
    """Phase 23's steps at B = 8,192 on the preprocessed bundle, profiled
    by :func:`profile_call`: the explicit-negatives step (mixed, 20 + 30 a
    row, the batch on the card as the resident path gathers it), the same
    step on the same batches without negatives, and the streaming step
    (the Batcher's gather, ``sample_batch``, the side-stream placer,
    ``_prefetch``, then the step); the device ms of rows 2, 3, 4, 6, 7 and
    of the table gather's backward (its sort apart) in each; and the
    host's gather and ``sample_batch`` ms per step (mixed and mined)."""
    import itertools

    import torch
    from recsys_tpu_torch.config import RecsysConfig, TrainConfig
    from recsys_tpu_torch.data.negative_sampling import NegativeSampler
    from recsys_tpu_torch.data.pipeline import Batcher
    from recsys_tpu_torch.models.losses import balanced_class_weights
    from recsys_tpu_torch.train.trainer import Trainer, _Placer, _prefetch

    n_users, n_items = int(bundle["meta/n_users"]), int(bundle["meta/n_movies"])
    cw = balanced_class_weights(bundle["train/y_implicit"])
    log_q = _log_q(bundle)
    samplers = {s: NegativeSampler(s, NEG_HARD, NEG_RANDOM, seed=SEED).fit(
        bundle["train/user_id"], bundle["train/movie_id"], n_items) for s in ("mixed", "mined")}
    samplers["mined"].set_mined(table)
    batcher = Batcher(bundle, "train", TRAIN_BATCH, seed=SEED)

    def augment(b):
        return {**b, "log_q": log_q[b["movie_id"]],
                "neg_ids": samplers["mixed"].sample_batch(b["user_id"])}

    gather, sample = [], {"mixed": [], "mined": []}
    it = (b for e in itertools.count() for b in batcher.epoch(e))
    for _ in range(21):
        t0 = time.perf_counter()
        b = next(it)
        gather.append((time.perf_counter() - t0) * 1e3)
        for s, sampler in samplers.items():
            t0 = time.perf_counter()
            sampler.sample_batch(b["user_id"])
            sample[s].append((time.perf_counter() - t0) * 1e3)
    out = {"host_ms_p50": {"batcher_gather": sorted(gather)[10],
                           **{f"sample_batch_{s}": sorted(v)[10] for s, v in sample.items()}}}
    groups = {"row2_dcn_fwd": "dcn_cross_fwd", "row3_dcn_bwd": "dcn_cross_bwd",
              "row4_fwd": "flash_ce_fwd", "row6_du": "flash_ce_bwd_du",
              "row7_dv": "flash_ce_bwd_dv", "gather_bwd": "indexing_backward",
              "gather_bwd_sort": "RadixSort"}
    host = [augment(b) for b in itertools.islice(batcher.epoch(1), 2)]
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, negs in (("train_step_B8192_explicit_negatives_mixed50", True),
                           ("train_step_B8192_same_batches_no_negatives", False)):
            cfg = RecsysConfig(model=model_cfg, train=TrainConfig(batch_size=TRAIN_BATCH))
            tr = Trainer(cfg, tmp, device="cuda")
            holder = [tr.init_state(n_users, n_items, SEED)]
            step = tr.make_train_step(cw, negs)
            batches = [{k: torch.as_tensor(v).to("cuda") for k, v in b.items()
                        if negs or k != "neg_ids"} for b in host]

            def one():
                holder[0], _ = step(holder[0], batches[holder[0].step % 2])

            rows[name] = profile_call(name, one, n_wall=20, n_traced=5, warmup=2, groups=groups)
            check(tr.step_counts["sparse"] == 0, f"{name}: took the sparse step")
        # the streaming step: host batch, negatives, placement two ahead, step
        tr = Trainer(cfg, tmp, device="cuda")
        holder = [tr.init_state(n_users, n_items, SEED)]
        step = tr.make_train_step(cw, True)
        placer = _Placer(tr.device)
        stream = _prefetch((augment(b) for e in itertools.count(2) for b in batcher.epoch(e)),
                           placer)

        def one_streamed():
            holder[0], _ = step(holder[0], placer.ready(next(stream)))

        name = "train_step_B8192_streaming_k1_mixed50"
        rows[name] = profile_call(name, one_streamed, n_wall=20, n_traced=5, warmup=2,
                                  groups=groups)
    neg = rows["train_step_B8192_explicit_negatives_mixed50"]["group_device_ms"]
    plain = rows["train_step_B8192_same_batches_no_negatives"]["group_device_ms"]
    gather_added = sum(neg[g] - plain[g] for g in ("gather_bwd", "gather_bwd_sort"))
    out["explicit_negatives_added_device_ms"] = {
        "total": (rows["train_step_B8192_explicit_negatives_mixed50"]["device_ms"]
                  - rows["train_step_B8192_same_batches_no_negatives"]["device_ms"]),
        "gather_bwd_and_sort": gather_added}
    out["explicit_negatives_added_device_ms"]["negatives_tower_and_softmax"] = (
        out["explicit_negatives_added_device_ms"]["total"] - gather_added)
    out["profiles"] = list(rows.values())
    return out


def negatives_streaming_path(counters, tmp: str, bundle_np: dict) -> dict:
    """Phase 23: explicit negatives and the streaming input path on phase
    22's preprocessed bundle (``tmp``) at the flagship widths, B = 8,192,
    through the train CLI's ``main``: (a) mixed negatives (20 + 30 a
    row), resident; (b) mined negatives from phase 22's serving bundle at
    weight 0.1 (the mining timed apart); (c) mixed negatives streamed,
    32-step chunks with a checkpoint every 16 steps, then one step a
    transfer; each checked by :func:`negatives_cli_run`. Then (d) the
    streaming steps on the card against the CPU and the steps' profiles."""
    import torch
    from recsys_tpu_torch.config import DataConfig, RecsysConfig
    from recsys_tpu_torch.data.negative_sampling import mine_hard_negatives
    from recsys_tpu_torch.data.preprocessing import load_bundle
    from recsys_tpu_torch.train.checkpoint import load_encoder_params

    data = os.path.join(tmp, "bundle.npz")
    mined_from = os.path.join(tmp, "run", "serving")
    bundle = load_bundle(data)
    steps = len(bundle["train/user_id"]) // TRAIN_BATCH
    common = ["--data", data, "--embedding_dim", "128", "--cross_layers", "3",
              "--batch_size", str(TRAIN_BATCH), "--epochs", "1", "--device", "cuda",
              "--num_hard_negatives", str(NEG_HARD), "--num_random_negatives", str(NEG_RANDOM)]
    out = {"steps_per_epoch": steps, "n_train_rows": len(bundle["train/user_id"])}
    run_a = os.path.join(tmp, "neg_mixed")
    out["mixed_resident"] = negatives_cli_run(
        "mixed, resident", common + ["--negative_sampling", "mixed"], counters, run_a, steps)
    model_cfg = RecsysConfig.load(os.path.join(run_a, "config.json")).model
    check(model_cfg.mixed_precision and model_cfg.embedding_dim == 128
          and 2 * model_cfg.embedding_dim + model_cfg.dense_features == 256,
          f"phase 23 model config {model_cfg}")

    d = DataConfig()
    encoder = load_encoder_params(mined_from)
    mine_s = []
    for _ in range(2):  # the first call carries the lazy set-up
        t0 = time.perf_counter()
        table = mine_hard_negatives(encoder, model_cfg, bundle, m=d.mined_pool_size,
                                    skip_top=d.mined_skip_top, device="cuda")
        torch.cuda.synchronize()
        mine_s.append(time.perf_counter() - t0)
    n_users, n_items = int(bundle["meta/n_users"]), int(bundle["meta/n_movies"])
    check(table.shape == (n_users, d.mined_pool_size) and table.min() >= 0
          and table.max() < n_items, f"mined table {table.shape}")
    tu, ti = bundle["train/user_id"], bundle["train/movie_id"]
    for u in range(0, n_users, 601):
        check(not set(table[u].tolist()) & set(ti[tu == u].tolist()), f"mined: user {u} seen")
    out["mining_s"] = mine_s
    out["mined"] = negatives_cli_run(
        "mined", common + ["--negative_sampling", "mined", "--mined_from", mined_from,
                           "--set", "model.explicit_negatives_weight=0.1"],
        counters, os.path.join(tmp, "neg_mined"), steps)

    stream = common + ["--negative_sampling", "mixed", "--set",
                       "train.device_resident_data=false", "--set", "train.keep_checkpoints=10"]
    for k, every in ((STREAM_CHUNK, STREAM_CKPT_EVERY), (1, STREAM_K1_CKPT_EVERY)):
        run = os.path.join(tmp, f"neg_stream_k{k}")
        row = negatives_cli_run(
            f"mixed, streamed, {k} steps a transfer",
            stream + ["--set", f"train.stream_chunk_steps={k}",
                      "--set", f"train.checkpoint_every_steps={every}"],
            counters, run, steps)
        row["mid_epoch_ckpts"] = _mid_epoch_ckpts(run)
        # the epoch's last save at step `steps` overwrites a mid-epoch one there
        want = [s for s in range(every, steps + 1, every) if s != steps]
        check(row["mid_epoch_ckpts"] == want,
              f"streamed k={k}: mid-epoch checkpoints {row['mid_epoch_ckpts']}, want {want}")
        out[f"streamed_k{k}"] = row
    out["stream_card_vs_cpu"] = stream_card_vs_cpu(bundle_np, counters, tmp)
    out.update(profile_negatives_steps(bundle, model_cfg, table))
    return out


# ---- the rest of serving: the seventh main path ----------------------------

def client_load(port: int, jobs: list) -> dict:
    """``len(jobs)`` client threads, each on its own keep-alive connection,
    send their ``(user_id, k)`` jobs to ``/recommend`` one after another,
    all starting together -> the answers {(thread, job): (status, body)},
    QPS over the whole load's wall time, and the latency p50 and p90."""
    import http.client

    answers, latency, errors = {}, [], []
    barrier = threading.Barrier(len(jobs))

    def client(t: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            barrier.wait(timeout=60)
            for j, (uid, k) in enumerate(jobs[t]):
                t0 = time.perf_counter()
                conn.request("POST", "/recommend", body=json.dumps({"user_id": uid, "k": k}),
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                data = r.read()
                latency.append((time.perf_counter() - t0) * 1e3)
                answers[(t, j)] = (r.status, json.loads(data))
        except Exception as e:  # reported below: the phase fails
            errors.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(t,)) for t in range(len(jobs))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not errors and not any(th.is_alive() for th in threads), f"client load: {errors}")
    latency.sort()
    n = len(latency)
    return {"answers": answers, "n": n, "wall_s": wall, "qps": n / wall,
            "p50_ms": latency[n // 2], "p90_ms": latency[int(n * 0.9)]}


def check_load(load: dict, jobs: list, refs: dict, what: str) -> float:
    """Every answer of ``load`` 200 and equal to the service's direct
    recommend (ids beyond ties, scores within SERVE_TOL) -> max score diff."""
    err = 0.0
    for (t, j), (status, body) in load["answers"].items():
        uid, k = jobs[t][j]
        check(status == 200 and body["count"] == k, f"{what}: {status} {body}")
        err = max(err, same_ranking(body["recommendations"], refs[(uid, k)], SERVE_TOL,
                                    f"{what}: user {uid}, k {k}"))
    check(len(load["answers"]) == sum(map(len, jobs)), f"{what}: answers missing")
    return err


def same_ranking_rel(got, want, rtol: float, atol: float, what: str) -> float:
    """:func:`same_ranking` with the tolerance ``atol + rtol * max|score|``."""
    scale = max(abs(r["score"]) for r in want)
    return same_ranking(got, want, atol + rtol * scale, what)


def _negate_index(d: str) -> bytes:
    """A retrain stand-in: the catalog's embeddings negated, the artifact's
    schema kept -> the original bytes of index.npz."""
    import numpy as np

    path = os.path.join(d, "index.npz")
    with open(path, "rb") as f:
        original = f.read()
    with np.load(path) as z:
        idx = {k: z[k] for k in z.files}
    idx["item_embeddings"] = -idx["item_embeddings"]
    np.savez(path, **idx)
    return original


def _threaded(service, **kw):
    from recsys_tpu_torch.serve.app import make_http_server

    server = make_http_server(service, host="127.0.0.1", port=0, **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def _stop_threaded(server, thread) -> None:
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")


def reload_with_batcher(serving: str, tmp: str, uid: int) -> dict:
    """Phase 24 (c): /admin/reload under the micro-batcher on a copy of
    the bundle: the negated catalog changes the answer, the restored one
    brings it back, the old batcher stops, the old service's tensors are
    freed; a degraded start gains its service on reload."""
    import gc
    import shutil

    import torch
    from recsys_tpu_torch.serve.batcher import MicroBatcher
    from recsys_tpu_torch.serve.service import RecommendationService

    copy = os.path.join(tmp, "reload_bundle")
    shutil.copytree(serving, copy)

    def factory():
        return RecommendationService(copy, rerank_candidates=RERANK, device="cuda").load()

    gc.collect()
    base = torch.cuda.memory_allocated()
    first = factory()
    batcher = MicroBatcher(first, max_batch=BATCH_USERS).start()
    server, thread = _threaded(first, batcher=batcher, service_factory=factory)
    port = server.server_address[1]
    out = {}
    try:
        code, before, _ = http(port, "POST", "/recommend", {"user_id": uid, "k": 10})
        check(code == 200, f"reload: /recommend {code}")
        gc.collect()
        mem_before = torch.cuda.memory_allocated()
        original = _negate_index(copy)
        code, rep, out["reload_ms"] = http(port, "POST", "/admin/reload", {})
        check(code == 200 and rep["reload_count"] == 1, f"reload: {code} {rep}")
        check(not batcher._running and batcher._thread is None, "the old batcher still runs")
        code, negated, _ = http(port, "POST", "/recommend", {"user_id": uid, "k": 10})
        ids = lambda body: [r["item_id"] for r in body["recommendations"]]  # noqa: E731
        check(code == 200 and ids(negated) != ids(before), "reload did not change the answer")
        with open(os.path.join(copy, "index.npz"), "wb") as f:
            f.write(original)
        second = server.api.batcher
        code, rep, _ = http(port, "POST", "/admin/reload", {})
        check(code == 200 and rep["reload_count"] == 2, f"second reload: {code} {rep}")
        check(not second._running, "the second batcher still runs")
        code, again, _ = http(port, "POST", "/recommend", {"user_id": uid, "k": 10})
        out["restored_max_score_diff"] = same_ranking(
            again["recommendations"], before["recommendations"], SERVE_TOL, "restored bundle")
        del first, second, batcher, rep
        gc.collect()
        mem_after = torch.cuda.memory_allocated()
        out.update(memory_allocated_before=mem_before, memory_allocated_after=mem_after,
                   service_bytes=mem_before - base)
        check(abs(mem_after - mem_before) <= 0.1 * mem_before,
              f"memory_allocated {mem_before} -> {mem_after} over two reloads")
        check(abs(mem_after - mem_before) < 0.5 * (mem_before - base),
              f"the old services' tensors were not freed: {mem_before} -> {mem_after}, "
              f"a service holds {mem_before - base}")
    finally:
        _stop_threaded(server, thread)
        server.api.batcher.stop()

    # a degraded start (no bundle at start-up) gains its service on reload
    late = os.path.join(tmp, "late_bundle")
    server, thread = _threaded(None, service_factory=lambda: RecommendationService(
        late, rerank_candidates=RERANK, device="cuda").load())
    port = server.server_address[1]
    try:
        code, _, _ = http(port, "POST", "/recommend", {"user_id": uid, "k": 10})
        check(code == 503, f"degraded start: /recommend {code}")
        code, _, _ = http(port, "POST", "/admin/reload", {})
        check(code == 500, f"degraded start, bundle still missing: reload {code}")
        shutil.copytree(serving, late)
        code, rep, _ = http(port, "POST", "/admin/reload", {})
        check(code == 200 and rep["model_info"]["ready"], f"degraded start: reload {code}")
        code, body, _ = http(port, "POST", "/recommend", {"user_id": uid, "k": 10})
        check(code == 200 and body["count"] == 10, f"degraded start after reload: {code}")
    finally:
        _stop_threaded(server, thread)
    return out


def serve_cli_workers(repo: str, serving: str, tmp: str, jobs: list, refs: dict) -> dict:
    """Phase 24 (e): ``python -m recsys_tpu_torch.serve --workers 2
    --microbatch 64`` on the card: both workers load after the fork (the
    parent touches no CUDA state), answer 40 requests from 8 clients as
    the service does, and SIGTERM to the parent reaps the whole tree."""
    import signal
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    err_path = os.path.join(tmp, "serve_cli.log")
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "recsys_tpu_torch.serve", "--model_dir", serving,
             "--workers", "2", "--microbatch", str(BATCH_USERS), "--rerank_candidates",
             str(RERANK), "--device", "cuda", "--host", "127.0.0.1", "--port", str(port)],
            cwd=repo, stdout=subprocess.DEVNULL, stderr=err_file, start_new_session=True)
    out = {}
    try:
        healthy = False
        while time.perf_counter() - t0 < 300 and proc.poll() is None and not healthy:
            try:
                code, body, _ = http(port, "GET", "/health")
                healthy = code == 200 and body["model_loaded"]
            except OSError:
                time.sleep(0.5)
        if not healthy:
            with open(err_path) as f:
                raise AssertionError(f"the two-worker CLI never became healthy "
                                     f"(rc {proc.poll()}): {f.read()[-3000:]}")
        out["healthy_after_s"] = time.perf_counter() - t0
        # each worker's first batch loads the kernels' library and warms the
        # card: 16 unchecked requests first, then 40 checked, from 8 clients
        client_load(port, [jobs[t][5:7] for t in range(8)])
        sub = [jobs[t][:5] for t in range(8)]
        load = client_load(port, sub)
        out["max_score_diff"] = check_load(load, sub, refs, "two-worker CLI")
        out.update(n=load["n"], qps=load["qps"], p50_ms=load["p50_ms"], p90_ms=load["p90_ms"])
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        out["reaped_s"] = time.perf_counter() - t1
        check(rc == 0, f"the two-worker CLI exited {rc} on SIGTERM")
        try:
            os.killpg(proc.pid, 0)
            alive = True
        except ProcessLookupError:
            alive = False
        check(not alive, "a serving worker outlived its parent")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
    return out


def native_gather_check(tmp: str) -> dict:
    """Phase 24 (f): the Batcher's native gather at phase 23's shapes
    (B = 8,192 rows of the train columns) bit-equal to numpy over an
    epoch; one gather timed on 1 to 8 threads, on the Batcher's choice
    (one a MiB) and through numpy, at B = 8,192 and 131,072."""
    import numpy as np
    from recsys_tpu_torch.data import pipeline
    from recsys_tpu_torch.data.preprocessing import load_bundle
    from recsys_tpu_torch.utils.native import gather_batch

    bundle = load_bundle(os.path.join(tmp, "bundle.npz"))
    b = pipeline.Batcher(bundle, "train", TRAIN_BATCH, seed=SEED)
    order = np.random.default_rng((b.seed, 0)).permutation(b.n)
    steps = 0
    for step, batch in enumerate(b.epoch(0)):
        idx = order[step * TRAIN_BATCH:(step + 1) * TRAIN_BATCH]
        for c in b.columns:
            check(batch[c].dtype == b.data[c].dtype
                  and np.array_equal(batch[c], b.data[c][idx]),
                  f"native gather: step {step}, column {c} differs from numpy")
        steps += 1
    out = {"steps_checked": steps, "columns": list(b.columns), "row_bytes": b.row_bytes,
           "cpu_count": os.cpu_count()}
    for rows in (TRAIN_BATCH, 16 * TRAIN_BATCH):
        idx = np.random.default_rng(rows).integers(0, b.n, rows)
        choice = max(1, min(os.cpu_count() or 1,
                            rows * b.row_bytes // pipeline.GATHER_BYTES_PER_THREAD))
        fns = {f"threads_{n}": (lambda n=n: gather_batch(b.data, idx, n_threads=n))
               for n in (1, 2, 4, 8)}
        fns["numpy"] = lambda: {c: b.data[c][idx] for c in b.columns}
        times = {"batcher_threads": choice}
        for name, fn in fns.items():
            ts = []
            for _ in range(21):
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            times[f"{name}_ms_p50"] = sorted(ts)[10]
        out[f"rows_{rows}"] = times
    return out


def serving_rest_path(repo: str, counters, tmp: str) -> dict:
    """Phase 24: the rest of serving on phase 22's trained bundle (F = 289,
    rerank 200): (a) 16 clients x 20 ``/recommend`` through the threaded
    server with no batcher and with ``microbatch`` 64, (b) through the
    asyncio server, every answer held against the service's direct
    recommend and the kernel counters set to 0 just before each batched
    load and read just after; (c) reload under the micro-batcher; (d) the
    native backend; (e) the serve CLI with two workers; (f) the Batcher's
    native gather."""
    import numpy as np
    import torch
    from recsys_tpu_torch.serve.aio import AioHttpServer
    from recsys_tpu_torch.serve.batcher import MicroBatcher
    from recsys_tpu_torch.serve.service import RecommendationService
    from recsys_tpu_torch.utils import native

    serving = os.path.join(tmp, "run", "serving")
    svc = RecommendationService(serving, rerank_candidates=RERANK, device="cuda").load()
    users = sorted(svc.user_id_map)
    jobs = [[(users[(t * LOAD_REQUESTS + j) * 37 % len(users)], 10 if j % 2 else 5)
             for j in range(LOAD_REQUESTS)] for t in range(LOAD_CLIENTS)]
    refs = {job: svc.recommend(*job) for row in jobs for job in row}
    warm = [row[:2] for row in jobs]
    out = {"n_clients": LOAD_CLIENTS, "requests_per_client": LOAD_REQUESTS}

    # (a) the threaded server, with no batcher, then with microbatch 64
    server, thread = _threaded(svc)
    try:
        client_load(server.server_address[1], warm)
        load = client_load(server.server_address[1], jobs)
    finally:
        _stop_threaded(server, thread)
    out["threaded"] = {k: load[k] for k in ("n", "qps", "p50_ms", "p90_ms", "wall_s")}
    out["threaded"]["max_score_diff"] = check_load(load, jobs, refs, "threaded, no batcher")
    with MicroBatcher(svc, max_batch=BATCH_USERS) as mb:
        server, thread = _threaded(svc, batcher=mb)
        try:
            client_load(server.server_address[1], warm)
            for c in counters:
                c.reset()
            before = mb.stats()
            load = client_load(server.server_address[1], jobs)
            torch.cuda.synchronize()
            launches = {c.name: c.read() for c in counters}
        finally:
            _stop_threaded(server, thread)
        st = mb.stats()
    out["threaded_microbatch"] = {k: load[k] for k in ("n", "qps", "p50_ms", "p90_ms", "wall_s")}
    out["threaded_microbatch"].update(
        max_score_diff=check_load(load, jobs, refs, "threaded, microbatch 64"),
        launches=launches, max_batch_seen=st["max_batch_seen"],
        batches=st["n_batches"] - before["n_batches"],
        mean_batch=(st["n_requests"] - before["n_requests"])
        / max(st["n_batches"] - before["n_batches"], 1))
    check(st["max_batch_seen"] > 1, f"the micro-batcher never batched: {st}")
    check(launches["topk_flash"] > 0 and launches["dcn_cross"] > 0,
          f"microbatched /recommend did not run rows 1 and 2: {launches}")

    # (b) the asyncio server: the loop coalescer
    aio = AioHttpServer(svc, "127.0.0.1", 0, max_batch=BATCH_USERS)
    aio_thread = threading.Thread(target=aio.serve_forever, daemon=True)
    aio_thread.start()
    for _ in range(400):
        if aio.bound_port:
            break
        time.sleep(0.025)
    check(aio.bound_port is not None, "the asyncio server did not bind")
    try:
        client_load(aio.bound_port, warm)
        for c in counters:
            c.reset()
        before = aio.coalescer.stats()
        load = client_load(aio.bound_port, jobs)
        torch.cuda.synchronize()
        launches = {c.name: c.read() for c in counters}
        st = aio.coalescer.stats()
    finally:
        aio.shutdown()
        aio_thread.join(timeout=30)
    check(not aio_thread.is_alive(), "the asyncio server did not stop")
    out["asyncio"] = {k: load[k] for k in ("n", "qps", "p50_ms", "p90_ms", "wall_s")}
    out["asyncio"].update(
        max_score_diff=check_load(load, jobs, refs, "asyncio"), launches=launches,
        max_batch_seen=st["max_batch_seen"], batches=st["n_batches"] - before["n_batches"],
        mean_batch=(st["n_requests"] - before["n_requests"])
        / max(st["n_batches"] - before["n_batches"], 1))
    check(st["max_batch_seen"] > 1, f"the asyncio coalescer never batched: {st}")
    check(launches["topk_flash"] > 0 and launches["dcn_cross"] > 0,
          f"coalesced /recommend did not run rows 1 and 2: {launches}")
    log(f"phase 24 (a, b) loads: {json.dumps({k: out[k] for k in ('threaded', 'threaded_microbatch', 'asyncio')})}")

    # (c) hot reload under the micro-batcher
    out["reload"] = reload_with_batcher(serving, tmp, users[0])

    # (d) the native backend, with features (phase 22's bundle) and without
    # (phase 23's mixed-negatives bundle, F = 256)
    check(native.native_available() and native.library_path().exists()
          and native.library_path().parent == native.BUILD_DIR,
          "the native library did not build from native/native.cpp into build/")
    batch = [int(u) for u in users[::len(users) // BATCH_USERS][:BATCH_USERS]]
    out["native"] = {"library": os.path.relpath(native.library_path(), repo)}
    for label, bundle in (("dense_features", serving),
                          ("no_features", os.path.join(tmp, "neg_mixed", "serving"))):
        nat = RecommendationService(bundle, backend="native", rerank_candidates=RERANK).load()
        check(nat._fast_rerank is not None, f"native {label}: _FastRerank failed its self-check")
        exact = RecommendationService(bundle, backend="native", rerank_candidates=RERANK).load()
        exact._fast_rerank = None  # its own exact per-pair host path
        dev = (svc if bundle == serving else
               RecommendationService(bundle, rerank_candidates=RERANK, device="cuda").load())
        got = nat.recommend_batch(batch, 10)
        err, overlap, dev_diff = 0.0, [], 0.0
        for a, b, c in zip(got, exact.recommend_batch(batch, 10), dev.recommend_batch(batch, 10)):
            err = max(err, same_ranking_rel(a["recommendations"], b["recommendations"], 1e-4,
                                            1e-5, f"native {label}: fast vs exact"))
            ids_a = [r["item_id"] for r in a["recommendations"]]
            overlap.append(len(set(ids_a) & {r["item_id"] for r in c["recommendations"]}) / 10)
            dev_diff = max(dev_diff, float(np.abs(
                np.array([r["score"] for r in a["recommendations"]])
                - np.array([r["score"] for r in c["recommendations"]])).max()))
        entry = {"fast_vs_exact_max_score_diff": err,
                 "top10_overlap_vs_device": float(np.mean(overlap)),
                 "max_score_diff_vs_device": dev_diff,
                 "features": nat.config.model.dense_features}
        t0 = time.perf_counter()
        RecommendationService(bundle, backend="native", rerank_candidates=RERANK).load()
        entry["load_s"] = time.perf_counter() - t0
        # the 64-user host call's parts: retrieval (tower, BLAS product,
        # argpartition) and the rerank (_FastRerank, the combined sort)
        ids = np.array([nat.user_id_map[u] for u in batch])
        scores, cand = nat._retrieve(ids, RERANK)
        for part, fn in (("retrieve", lambda: nat._retrieve(ids, RERANK)),
                         ("fast_rerank_logits", lambda: nat._fast_rerank.logits(
                             ids, cand, need_rating=bool(nat.rerank_rating_weight))),
                         ("rerank", lambda: nat._rerank(ids, scores, cand, 10))):
            ts = []
            for _ in range(21):
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            entry[f"batch64_{part}_ms_p50"] = sorted(ts)[10]
        entry["profiles"] = [dict(r, profile=f"native_{r['profile']}_{label}")
                             for r in profile_requests(nat, batch)]
        entry["profiles"] += [dict(r, profile=f"device_{r['profile']}_{label}")
                              for r in profile_requests(dev, batch)]
        out["native"][label] = entry
        del nat, exact, dev
    log(f"phase 24 (d) native: {json.dumps(out['native'])}")

    # (e) the serve CLI, two workers on the card
    out["cli_workers"] = serve_cli_workers(repo, serving, tmp, jobs, refs)
    # (f) the Batcher's native gather
    out["batcher_gather"] = native_gather_check(tmp)
    return out


# ---- the mesh and the sharded catalog: the eighth main path ----------------

def collectives_at_world_one(ctx) -> dict:
    """Phase 25: each collective of the port once on the one-rank NCCL
    group, against what it must give there (its input, or the top k of
    its candidates). -> the largest difference, 0 expected."""
    import torch
    from recsys_tpu_torch.parallel import collectives as coll

    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((8, 16), generator=g, device="cuda")
    got = {"allreduce_mean": coll.allreduce_mean(ctx, {"g": x})["g"],
           "allreduce_sum": coll.allreduce_sum(ctx, [x], axis=ctx.model_axis)[0],
           "gather_rows": coll.gather_rows(ctx, x),
           "exchange": coll.exchange(ctx, x),
           "ring_shift": coll.ring_shift(ctx, x)}
    s, i = coll.merge_topk(ctx, x, torch.arange(16, device="cuda").expand(8, 16), 5)
    ws, wi = torch.topk(x, 5)
    torch.cuda.synchronize()
    err = {name: float((v - x).abs().max()) for name, v in got.items()}
    err["merge_topk"] = float((s - ws).abs().max())
    check(all(e == 0.0 for e in err.values()) and torch.equal(i, wi),
          f"collectives at world size 1: {err}")
    return err


def serve_cli_sharded(repo: str, serving: str, tmp: str, uid: int, want) -> dict:
    """Phase 25 (c): ``python -m recsys_tpu_torch.serve --backend sharded
    --rerank_candidates 200`` on the card (its own one-rank NCCL group):
    healthy, ``/model/info`` names the sharded scorer, one ``/recommend``
    equal to the in-process sharded backend's answer; SIGTERM ends it."""
    import signal
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    err_path = os.path.join(tmp, "serve_sharded.log")
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "recsys_tpu_torch.serve", "--model_dir", serving,
             "--backend", "sharded", "--rerank_candidates", str(RERANK), "--host",
             "127.0.0.1", "--port", str(port)],
            cwd=repo, stdout=subprocess.DEVNULL, stderr=err_file, start_new_session=True)
    out = {}
    try:
        healthy = False
        while time.perf_counter() - t0 < 300 and proc.poll() is None and not healthy:
            try:
                code, body, _ = http(port, "GET", "/health")
                healthy = code == 200 and body["model_loaded"]
            except OSError:
                time.sleep(0.5)
        if not healthy:
            with open(err_path) as f:
                raise AssertionError(f"the sharded CLI never became healthy "
                                     f"(rc {proc.poll()}): {f.read()[-3000:]}")
        out["healthy_after_s"] = time.perf_counter() - t0
        code, info, _ = http(port, "GET", "/model/info")
        check(code == 200 and "sharded" in info["backend"], f"sharded CLI /model/info: {info}")
        code, body, out["recommend_ms"] = http(port, "POST", "/recommend",
                                               {"user_id": uid, "k": 10})
        check(code == 200, f"sharded CLI /recommend: {code}")
        check_recs(body["recommendations"], 10, "sharded CLI /recommend")
        out["max_score_diff"] = same_ranking(body["recommendations"], want, TOPK_TOL,
                                             "sharded CLI against the sharded backend")
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
    return out


def sharded_path(repo: str, counters, tmp: str) -> dict:
    """Phase 25: the mesh and the sharded catalog on a one-rank NCCL group
    from ``make_mesh``: (a) phase 13's 1,048,576-item bundle (made again
    from its seed) through ``RetrievalIndex.shard``, fp32 and int8, 1 and
    64 users at k = 10 and 200, fp32 against ``flash_topk`` over the whole
    catalog and the CPU's plain version, int8 against ``blockwise_topk_int8``
    over the same int8 rows (no refine), and int8's recall@10 against fp32;
    (b) ``make_ring_topk`` at 64 users, k = 200, against (a); (c) phase 22's
    trained bundle through ``backend="sharded"`` (rerank 200, F = 289, on
    the host through ``_FastRerank``, as the JAX package's sharded backend):
    ``recommend`` and a 64-user ``recommend_batch``, the counters set to 0
    just before and read just after (row 1 launches; row 2, the sieve and
    the blockwise scan never), held against the same backend served on the
    CPU (a one-rank gloo group made after the NCCL one is gone) within
    ``SERVE_TOL``, with their distance to ``backend="device"`` (bf16
    operands) recorded, then the serve CLI's ``--backend sharded``; (d) the
    sharded route's rerank candidates at 1M items against the exact flash
    route's (1 and 64 users, k = 200), the reranked answers' distance
    recorded, then the sharded ``recommend`` and 64-user call profiled
    beside the exact flash route on the same catalog, and the fp32 and
    int8 shards' searches alone (64 users, k = 200).
    The group is destroyed before the phase returns, whatever happened."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from recsys_tpu_torch.models.towers import TwoTower
    from recsys_tpu_torch.ops.topk import blockwise_topk_int8, make_ring_topk
    from recsys_tpu_torch.ops.topk_flash import flash_topk, flash_topk_reference, l2_normalize
    from recsys_tpu_torch.parallel import mesh as mesh_mod
    from recsys_tpu_torch.serve.service import RecommendationService

    def host(pair):
        return pair[0].cpu().numpy(), pair[1].cpu().numpy()

    out = {}
    t0 = time.perf_counter()
    ctx = mesh_mod.make_mesh(model_parallel=1, data_parallel=1, device="cuda")
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
              and ctx.device == torch.device("cuda", 0), f"mesh: {dist.get_backend()}")
        out["mesh"] = {"backend": dist.get_backend(), "world": dist.get_world_size(),
                       "shape": [ctx.n_data, ctx.n_model], "device": str(ctx.device),
                       "made_s": time.perf_counter() - t0}
        out["collectives_err"] = collectives_at_world_one(ctx)

        # (a) search, fp32 and int8 shards
        large = os.path.join(tmp, "large")
        t0 = time.perf_counter()
        _, params = large_catalog_bundle(large)
        del params
        torch.cuda.empty_cache()
        out["bundle_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        big = RecommendationService(large, backend="sharded", rerank_candidates=RERANK,
                                    device="cuda", mesh_ctx=ctx).load()
        out["sharded_load_s"] = time.perf_counter() - t0
        check(big._search_route() == "sharded" and big.mesh_ctx is ctx, "1M: not sharded")
        sh = big._sharded
        check(sh.n_items == LARGE_N_ITEMS and sh.rows == sh.n_valid == LARGE_N_ITEMS,
              f"one shard of {sh.rows} rows, {sh.n_valid} real")
        sh8 = big.index.shard(ctx, int8=True)
        batch = [int(u) for u in
                 np.arange(1, N_USERS + 1, N_USERS // BATCH_USERS)[:BATCH_USERS]]
        with torch.inference_mode():
            ids = torch.as_tensor([big.user_id_map[u] for u in batch], device="cuda")
            users = TwoTower.user_embed(big.encoder_params, ids, big.config.model)
            qn = l2_normalize(users)
            catalog = big.index._catalog_ready()
            cpu = host(flash_topk_reference(qn.cpu(), catalog.cpu(), RERANK, normalize=False))
            search = {}
            for q in (1, BATCH_USERS):
                for k in (10, RERANK):
                    what = f"sharded Q={q} k={k}"
                    got = sh.search(users[:q], k)
                    row = {"vs_flash": same_topk(got, host(flash_topk(qn[:q], catalog, k,
                                                                      normalize=False)),
                                                 TOPK_TOL, f"{what} against flash_topk"),
                           "vs_cpu": same_topk(got, (cpu[0][:q, :k], cpu[1][:q, :k]),
                                               TOPK_TOL, f"{what} against the CPU")}
                    got8 = sh8.search(users[:q], k)
                    row["int8_vs_blockwise"] = same_topk(
                        got8, host(blockwise_topk_int8(qn[:q], sh8.item_q, sh8.item_scale, k)),
                        TOPK_TOL, f"{what} int8 against blockwise_topk_int8")
                    row["int8_recall_vs_fp32"] = _recall(got8[1], got[1])
                    search[f"Q{q}_k{k}"] = row
            out["search"] = search
            out["int8_recall@10_vs_fp32"] = search[f"Q{BATCH_USERS}_k10"]["int8_recall_vs_fp32"]
            del catalog
            # the two shards' searches alone at the rerank's depth, 64 users
            search_profiles = [
                profile_call(f"sharded_{name}_search64_k{RERANK}_1M",
                             lambda index=index: index.search(users, RERANK), n_wall=20,
                             n_traced=5, warmup=2)
                for name, index in (("fp32", sh), ("int8", sh8))]
            # (b) the ring, at world size 1 one step
            ring = make_ring_topk(ctx, RERANK, normalize=False)(qn, sh.item_embeddings)
            out["ring_vs_sharded"] = same_topk(host(ring), sh.search(users, RERANK), TOPK_TOL,
                                               "ring against the sharded search")
        del sh8, cpu, ring
        torch.cuda.empty_cache()
        log(f"phase 25 (a, b): {json.dumps(out)}")

        # (c) the trained bundle through backend="sharded", then the CLI
        serving = os.path.join(tmp, "run", "serving")
        svc = RecommendationService(serving, backend="sharded", rerank_candidates=RERANK,
                                    device="cuda", mesh_ctx=ctx).load()
        dev = RecommendationService(serving, rerank_candidates=RERANK, device="cuda").load()
        known = sorted(svc.user_id_map)
        users22 = known[::len(known) // BATCH_USERS][:BATCH_USERS] + [999_999]
        for c in counters:
            c.reset()
        one = svc.recommend(known[0], 10)
        many = svc.recommend_batch(users22, 10)
        torch.cuda.synchronize()
        launches = {c.name: c.read() for c in counters}
        check(launches["topk_flash"] > 0, f"backend=sharded did not run row 1: {launches}")
        check(launches["dcn_cross"] == 0, f"backend=sharded reranked on the card: {launches}")
        check(launches["blockmax"] == launches["blockwise_topk"] == 0,
              f"backend=sharded took another top-k route: {launches}")
        check(svc._fast_rerank is not None, "the sharded backend's _FastRerank failed")
        check(many[-1]["status"] == "cold_start", "sharded batch: the unknown user")
        # its distance to the device rerank (bf16 operands): recorded, not limited
        vs_device = max(abs(x["score"] - y["score"]) for x, y in
                        zip(one, dev.recommend(known[0], 10)))
        for got, want in zip(many, dev.recommend_batch(users22, 10)):
            vs_device = max([vs_device] + [abs(x["score"] - y["score"]) for x, y in zip(
                got["recommendations"], want["recommendations"])])
        out["service"] = {"launches": launches, "max_score_diff_vs_device": vs_device,
                          "search": svc.get_model_info()["search"],
                          "fast_rerank": svc.get_model_info()["fast_rerank"]}
        out["cli"] = serve_cli_sharded(repo, serving, tmp, known[0], one)
        del svc, dev
        log(f"phase 25 (c): {json.dumps({k: out[k] for k in ('service', 'cli')})}")

        # (d) the sharded requests at 1M items beside the exact flash route
        exact = RecommendationService(large, rerank_candidates=RERANK, device="cuda",
                                      approx_search_threshold=0).load()
        check(exact._search_route() == "exact", "1M: the exact route was not taken")
        # the rerank's candidates are the same (exact search on both routes);
        # the reranks differ on purpose (the sharded one on the host in fp32,
        # the exact route's on the card on bf16 operands): their distance
        # is recorded, not limited
        dense_ids = np.asarray([big.user_id_map[u] for u in batch])
        err = 0.0
        for q in (1, BATCH_USERS):
            err = max(err, same_topk(
                big._retrieve(dense_ids[:q], RERANK), exact._retrieve(dense_ids[:q], RERANK),
                TOPK_TOL, f"sharded against exact candidates, 1M items, {q} users"))
        out["vs_exact_max_score_diff"] = err
        rerank_diff = max(abs(x["score"] - y["score"]) for x, y in
                          zip(big.recommend(1, 10), exact.recommend(1, 10)))
        for got, want in zip(big.recommend_batch(batch, 10), exact.recommend_batch(batch, 10)):
            rerank_diff = max([rerank_diff] + [abs(x["score"] - y["score"]) for x, y in zip(
                got["recommendations"], want["recommendations"])])
        out["vs_exact_rerank_max_score_diff"] = rerank_diff
        groups = {"row1_topk": "topk_flash_kernel", "row1_select": "topk_select_kernel",
                  "row2_dcn": "dcn_cross_fwd_kernel", "nccl": "nccl"}
        profiles = search_profiles
        for name, svc in (("sharded", big), ("exact_flash", exact)):
            profiles.append(profile_call(f"{name}_recommend_1M_k10",
                                         lambda svc=svc: svc.recommend(1, 10), groups=groups))
            profiles.append(profile_call(f"{name}_recommend_batch64_1M_k10",
                                         lambda svc=svc: svc.recommend_batch(batch, 10),
                                         groups=groups))
        out["profiles"] = profiles
        del big, exact
    finally:
        mesh_mod.shutdown()
    check(not dist.is_initialized(), "the process group outlived phase 25")
    torch.cuda.empty_cache()
    # (c) held against the sharded backend served on the CPU (plain versions)
    cpu_ctx = mesh_mod.make_mesh(device="cpu")
    try:
        cpu_svc = RecommendationService(serving, backend="sharded", rerank_candidates=RERANK,
                                        device="cpu", mesh_ctx=cpu_ctx).load()
        err = same_ranking(one, cpu_svc.recommend(known[0], 10), SERVE_TOL,
                           "sharded recommend, card vs CPU")
        for got, want in zip(many, cpu_svc.recommend_batch(users22, 10)):
            check(got["status"] == want["status"], f"sharded batch status {got['status']}")
            err = max(err, same_ranking(got["recommendations"], want["recommendations"],
                                        SERVE_TOL, f"sharded batch user {got['user_id']}, "
                                        "card vs CPU"))
        out["service"]["max_score_diff_vs_cpu"] = err
    finally:
        mesh_mod.shutdown()
    check(not dist.is_initialized(), "the CPU process group outlived phase 25")
    return out


# ---- data-parallel training: the ninth main path ---------------------------

def _tree_diff(a, b) -> tuple:
    """-> (max |a - b| over every leaf of two param trees on the card, its
    leaf, whether every leaf is bit-equal)."""
    import torch
    from recsys_tpu_torch.train.optimizer import leaves_with_paths

    worst, where, equal = 0.0, "", True
    b_leaves = dict(leaves_with_paths(b))
    for path, x in leaves_with_paths(a):
        y = b_leaves[path]
        equal = equal and bool(torch.equal(x, y))
        err = float((x.detach() - y.detach()).abs().max())
        if err > worst:
            worst, where = err, "/".join(path)
    return worst, where, equal


def mesh_vs_one_card(ctx, cfg, init, batches, cw, counters, tmp: str, label: str) -> dict:
    """Phase 26 (a): ``PARITY_STEPS`` steps of the one-card trainer and of the
    mesh trainer from one init (dropout on: data index 0 draws the one-card
    stream) on the same batches, held to phase 10's bounds (the loss 1e-3
    relative, every param 2e-4 absolute), bit-equality recorded; the
    counters set to 0 before each run and read after; then one step of each
    profiled (device ms; the NCCL kernels' device ms, none at world 1, where
    the collectives are device-to-device copies; the collectives' spans;
    launches)."""
    import torch
    from recsys_tpu_torch.train.checkpoint import params_from_numpy
    from recsys_tpu_torch.train.trainer import Trainer

    groups = {"nccl": "nccl", "memcpy_dtod": "Memcpy DtoD",
              "row2_dcn": "dcn_cross_fwd", "row3_dcn_bwd": "dcn_cross_bwd",
              "row4_fwd": "flash_ce_fwd", "row6_du": "flash_ce_bwd_du",
              "row7_dv": "flash_ce_bwd_dv"}
    runs = {}
    for name, mesh in (("one_card", None), ("mesh", ctx)):
        tr = Trainer(cfg, os.path.join(tmp, f"{label}_{name}"), device="cuda", mesh_ctx=mesh)
        state = tr.state_from_params(params_from_numpy(init, "cuda"), SEED)
        step = tr.make_train_step(cw)
        for c in counters:
            c.reset()
        loss = []
        for batch in batches:
            state, m = step(state, batch)
            loss.append(float(m["loss"]))
        torch.cuda.synchronize()
        launches = {c.name: c.read() for c in counters}
        holder = [state]

        def one(step=step, holder=holder):
            holder[0], _ = step(holder[0], batches[holder[0].step % len(batches)])

        runs[name] = {"loss": loss, "launches": launches, "state": state,
                      "step_counts": dict(tr.step_counts), "trainer": tr, "one": one}
    card, mesh_run = runs["one_card"], runs["mesh"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(mesh_run["loss"], card["loss"]))
    check(loss_err <= PARITY_LOSS_RTOL,
          f"{label}: mesh loss {mesh_run['loss']} vs one card {card['loss']}")
    param_err, worst, bit_equal = _tree_diff(mesh_run["state"].params, card["state"].params)
    check(param_err <= PARITY_PARAM_ATOL,
          f"{label}: mesh params differ by {param_err} at {worst} > {PARITY_PARAM_ATOL}")
    check(mesh_run["launches"] == card["launches"],
          f"{label}: kernel launches {mesh_run['launches']} vs one card {card['launches']}")
    check(mesh_run["step_counts"] == card["step_counts"],
          f"{label}: steps {mesh_run['step_counts']} vs {card['step_counts']}")
    out = {"loss_mesh": mesh_run["loss"], "loss_one_card": card["loss"],
           "loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
           "param_worst": worst, "bit_equal": bit_equal,
           "launches": mesh_run["launches"], "step_counts": mesh_run["step_counts"]}
    for name in ("one_card", "mesh"):
        del runs[name]["state"]
    profiles = {name: profile_call(f"dp_{label}_{name}", runs[name]["one"], n_wall=10,
                                   n_traced=5, warmup=2, groups=groups)
                for name in ("one_card", "mesh")}
    p_card, p_mesh = profiles["one_card"], profiles["mesh"]
    out["step"] = {
        "device_ms_one_card": p_card["device_ms"], "device_ms_mesh": p_mesh["device_ms"],
        "device_ms_added": p_mesh["device_ms"] - p_card["device_ms"],
        "nccl_kernel_device_ms": p_mesh["group_device_ms"]["nccl"],
        "nccl_kernel_launches": p_mesh["group_launches"]["nccl"],
        "collective_spans": p_mesh.get("collective_spans", {}),
        "memcpy_dtod_device_ms_added": (p_mesh["group_device_ms"]["memcpy_dtod"]
                                        - p_card["group_device_ms"]["memcpy_dtod"]),
        "launches_one_card": p_card["device_launches"], "launches_mesh": p_mesh["device_launches"],
        "launches_added": p_mesh["device_launches"] - p_card["device_launches"],
        "wall_ms_p50_one_card": p_card["wall_ms_p50"], "wall_ms_p50_mesh": p_mesh["wall_ms_p50"]}
    out["profiles"] = [p_card, p_mesh]
    del runs
    torch.cuda.empty_cache()
    return out


def _offset_flash_args(dtype, seed: int) -> tuple:
    """Rank 3 of 4's backward inputs: b = 2,048 local rows against the
    gathered n * b = 8,192 candidates, the positives at ``3 * b + i``; ids
    from 512 values, so accidental hits fall in every segment, the local
    rows' own segment included."""
    import torch

    b, n, d = 2048, 4, 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = (torch.randn((b, d), generator=g, device="cuda") * d ** -0.5).to(dtype)
    v = (torch.randn((n * b, d), generator=g, device="cuda") * d ** -0.5).to(dtype)
    c = torch.randn((n * b,), generator=g, device="cuda")
    ids_k = torch.randint(0, 512, (n * b,), generator=g, device="cuda", dtype=torch.int32)
    ids_q = ids_k[3 * b:4 * b].contiguous()
    pos = (3 * b + torch.arange(b, device="cuda")).to(torch.int32)
    gr = torch.rand((b,), generator=g, device="cuda") / b
    return u, v, c, ids_q, ids_k, pos, gr


def offset_positive_rows() -> dict:
    """Phase 26 (b): rows 4 to 7 with the positives at an offset, as under
    global negatives on rank 3 of 4: bf16 operands through the forward and
    rows 6 + 7, fp32 operands through the forward and the fused backward,
    each against its plain version at phases 10's and 11's tolerances."""
    import torch
    from recsys_tpu_torch.ops import flash_ce as F

    out = {}
    for dtype, bwd, label in ((torch.bfloat16, F.flash_ce_bwd_twokernel, "bf16_rows_4_6_7"),
                              (torch.float32, F.flash_ce_bwd_fused, "fp32_rows_4_5")):
        args = _offset_flash_args(dtype, SEED + 26)
        hits = int((args[3][:, None] == args[4][None, :]).sum()) - args[3].shape[0]
        res = check_flash(*args, bwd=bwd)
        res.pop("lse")
        out[label] = {**res, "accidental_hits": hits, "shape": {
            "Bq": args[0].shape[0], "Bk": args[1].shape[0], "pos0": int(args[5][0])}}
    return out


def dp_train_cli(repo: str, bundle_np: dict, tmp: str, extra=(), label: str = "dp") -> dict:
    """Phase 26 (c) (and 27 (c), ``extra`` the row flags): ``python -m
    torch.distributed.run --standalone --nproc_per_node 1 -m
    recsys_tpu_torch.train [extra]`` on NCCL, on phase 8's bundle, one epoch
    at B = 8,192: exits 0, rank 0 writes the run's files and the bundle, and
    its losses and params equal the same CLI's without the launcher and
    without ``extra`` (in this process: one card, no group) within phase
    10's bounds; bit-equality of the losses recorded."""
    import numpy as np
    from recsys_tpu_torch.train import __main__ as train_cli

    data = os.path.join(tmp, f"{label}_bundle.npz")
    np.savez(data, **bundle_np)
    argv = ["--data", data, "--epochs", "1", "--batch_size", str(TRAIN_BATCH),
            "--embedding_dim", "128", "--device", "cuda"]
    runs = {"launcher": os.path.join(tmp, f"{label}_cli_torchrun"),
            "plain": os.path.join(tmp, f"{label}_cli_plain")}
    log_path = os.path.join(tmp, f"{label}_cli.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log_file:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "recsys_tpu_torch.train", *argv, *extra,
             "--output_dir", runs["launcher"]],
            cwd=repo, stdout=log_file, stderr=subprocess.STDOUT, timeout=600)
    launcher_s = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    check(proc.returncode == 0, f"train CLI under torchrun: rc {proc.returncode}: {text[-3000:]}")
    check("data-parallel over 1 ranks" in text, "the CLI under torchrun did not train on a mesh")
    t0 = time.perf_counter()
    rc, _ = _call_cli(train_cli.main, argv + ["--output_dir", runs["plain"]])
    plain_s = time.perf_counter() - t0
    check(rc == 0, f"train CLI without a launcher: rc {rc}")
    hist, final, params = {}, {}, {}
    for name, run in runs.items():
        for rel in ("metrics.json", "detailed_metrics.json", "config.json",
                    "serving/model.npz", "serving/index.npz", "serving/vocabs.json"):
            check(os.path.exists(os.path.join(run, rel)), f"{name} CLI: {rel} missing")
        with open(os.path.join(run, "detailed_metrics.json")) as f:
            hist[name] = json.load(f)["epochs"][0]
        with open(os.path.join(run, "metrics.json")) as f:
            final[name] = json.load(f)
        with np.load(os.path.join(run, "serving", "model.npz")) as z:
            params[name] = {k: z[k] for k in z.files}
    loss_err = max(abs(hist["launcher"][k] - hist["plain"][k]) / abs(hist["plain"][k])
                   for k in ("train_loss", "val_loss"))
    check(loss_err <= PARITY_LOSS_RTOL, f"torchrun CLI losses {hist['launcher']} vs "
                                        f"{hist['plain']}")
    if extra:
        with open(os.path.join(runs["launcher"], "config.json")) as f:
            mesh = json.load(f)["mesh"]
        check(mesh["embedding_sharding"] == "rows" and mesh["lookup_strategy"] == "a2a",
              f"{label} CLI: the row flags did not reach the config: {mesh}")
    param_err = max(float(np.abs(params["launcher"][k] - v).max())
                    for k, v in params["plain"].items())
    check(param_err <= PARITY_PARAM_ATOL, f"torchrun CLI params differ by {param_err}")
    return {"launcher_s": launcher_s, "plain_s": plain_s, "loss_max_rel_err": loss_err,
            "param_max_abs_err": param_err, "extra": list(extra),
            "losses_bit_equal": all(hist["launcher"][k] == hist["plain"][k]
                                    for k in ("train_loss", "val_loss")),
            "train_loss": [hist["launcher"]["train_loss"], hist["plain"]["train_loss"]],
            "val_loss": [hist["launcher"]["val_loss"], hist["plain"]["val_loss"]],
            "recall@10": [final["launcher"]["recall@10"], final["plain"]["recall@10"]]}


def _zipf_ids(n_rows: int, b: int, seed: int):
    """``b`` ids of ``n_rows`` with Zipf popularity (rank**-1, ranks
    shuffled), as phase 18 draws its items."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pop = np.arange(1, n_rows + 1, dtype=np.float64) ** -ZIPF_EXPONENT
    pop = pop[rng.permutation(n_rows)]
    return rng.choice(n_rows, b, p=pop / pop.sum()).astype(np.int32)


def lookups_at_giant_shape(ctx) -> dict:
    """Phase 27 (a): the psum and a2a (factor 2) lookups of a one-rank
    ``model`` axis over phase 18's user table (4,000,001 x 128 fp32) at
    B = 131,072 Zipf ids: forward bit-equal to ``table[ids]``; the gradient
    of ``sum(rows**2)`` against the plain gather's, within ``LOOKUP_GRAD_TOL``
    of max|ref| (both scatter-add with atomics; bit-equality recorded); the
    a2a overflow 0 at factor 2 and ``B - a2a_capacity(B, 1, 0.5)`` at 0.5;
    forward and forward + backward profiled beside the plain gather's
    (device ms and launches: the bucketing's cost on the card; a profile
    that lost device records is taken up to twice more, then fails the run);
    ``gather_table`` of the table onto the host, equal to it."""
    import torch
    import numpy as np

    from recsys_tpu_torch.embed.table import (a2a_capacity, make_sharded_lookup_a2a,
                                              make_sharded_lookup_psum)
    from recsys_tpu_torch.parallel.sharding import gather_table

    b = GIANT_BATCH
    g = torch.Generator(device="cuda").manual_seed(SEED + 27)
    table = torch.randn((GIANT_USERS + 1, 128), generator=g, device="cuda") * 128 ** -0.5
    ids = torch.as_tensor(_zipf_ids(GIANT_USERS + 1, b, SEED + 27), device="cuda")
    a2a = make_sharded_lookup_a2a(ctx, a2a_capacity(b, ctx.n_model, 2.0))
    lookups = {"plain": lambda t, i: t[i.long()], "psum": make_sharded_lookup_psum(ctx),
               "a2a": lambda t, i: a2a(t, i)[0]}
    leaf = table.clone().requires_grad_(True)

    def grad_of(name):
        (grad,) = torch.autograd.grad(torch.sum(lookups[name](leaf, ids) ** 2), leaf)
        return grad

    ref_rows = table[ids.long()]
    ref_grad = grad_of("plain")
    scale = float(ref_grad.abs().max())
    out = {"shape": {"V": GIANT_USERS + 1, "D": 128, "B": b},
           "distinct_ids": int(torch.unique(ids).numel())}
    for name in ("psum", "a2a"):
        with torch.no_grad():
            rows = lookups[name](table, ids)
        check(torch.equal(rows, ref_rows), f"phase 27: the {name} lookup is not table[ids]")
        grad = grad_of(name)
        err = float((grad - ref_grad).abs().max())
        check(err <= LOOKUP_GRAD_TOL * scale,
              f"phase 27: the {name} lookup's gradient is off by {err} (max|ref| {scale})")
        out[name] = {"forward_bit_equal": True, "grad_max_abs_err": err,
                     "grad_bit_equal": bool(torch.equal(grad, ref_grad))}
        del grad
    _, overflow = a2a(table, ids)
    check(int(overflow) == 0, f"phase 27: a2a overflow {int(overflow)} at factor 2")
    half = a2a_capacity(b, ctx.n_model, 0.5)
    rows, overflow = make_sharded_lookup_a2a(ctx, half)(table, ids)
    check(int(overflow) == b - half, f"phase 27: a2a overflow {int(overflow)} at factor 0.5, "
                                     f"not {b - half}")
    fits = torch.arange(b, device="cuda") < half
    check(torch.equal(rows[fits], ref_rows[fits]) and not bool(rows[~fits].any()),
          "phase 27: at factor 0.5 the fitting ids are not exact or the rest not zero")
    out["a2a"]["overflow_factor_2"] = 0
    out["a2a"]["overflow_factor_0.5"] = int(overflow)
    del rows, ref_rows, ref_grad

    def traced(label, fn, n_traced):
        # 200 ms of calls lead each traced window in; a window in which the
        # profiler recorded no device work, or some kernel fewer times than
        # the calls, is taken again (logged) up to twice, then must be whole:
        # a lost trace fails the run
        def whole(p):
            return p["device_launches"] > 0 and p["device_ms"] > 0 and p["device_records_whole"]

        for _ in range(2):
            p = profile_call(label, fn, n_wall=10, n_traced=n_traced, warmup=2, lead_in_ms=200)
            if whole(p):
                return p
            log(f"phase 27: {label} lost device records; traced again: {p}")
        p = profile_call(label, fn, n_wall=10, n_traced=n_traced, warmup=2, lead_in_ms=200)
        check(whole(p), f"phase 27: the profile of {label} lost device records: {p}")
        return p

    profiles = []
    for name in ("plain", "psum", "a2a"):
        def fwd(name=name):
            with torch.no_grad():
                lookups[name](table, ids)

        profiles.append(traced(f"rows_lookup_{name}_fwd", fwd, 20))
        profiles.append(traced(f"rows_lookup_{name}_fwd_bwd", lambda name=name: grad_of(name),
                               5))
    for p in profiles:
        out[p["profile"]] = {k: p[k] for k in ("wall_ms_p50", "device_ms", "device_launches")}
    # the whole table onto the host in chunks over ``model`` (NCCL's gather),
    # as the trainer's checkpoints and bundle take it under row sharding
    t0 = time.perf_counter()
    whole = gather_table(ctx, table)
    out["gather_table_s"] = time.perf_counter() - t0
    check(whole is not None and np.array_equal(whole, table.cpu().numpy()),
          "phase 27: gather_table is not the table")
    del table, leaf, whole
    torch.cuda.empty_cache()
    return out, profiles


def loss_with_lookup(ctx, bundle_np: dict, counters) -> dict:
    """Phase 27 (b): ``MultiTaskModel.loss`` at the main path's full width
    (B = 8,192, the ``ModelConfig`` defaults, bf16, the flash route) with
    the psum and the a2a lookup against the same loss without one (the same
    dropout draws): the loss to ``PARITY_LOSS_RTOL`` relative, every
    gradient within ``PARITY_LOSS_RTOL`` of its leaf's max|ref|,
    bit-equality recorded; the counters set to 0 just before the lookup
    runs and read just after (rows 2, 3, 4, 6 and 7)."""
    import torch
    from recsys_tpu_torch.config import ModelConfig
    from recsys_tpu_torch.embed.table import (a2a_capacity, make_sharded_lookup_a2a,
                                              make_sharded_lookup_psum)
    from recsys_tpu_torch.models.losses import balanced_class_weights
    from recsys_tpu_torch.models.multitask import MultiTaskModel
    from recsys_tpu_torch.train.optimizer import leaves_with_paths

    model = ModelConfig()
    params = MultiTaskModel.init(torch.Generator().manual_seed(SEED + 27), model, N_USERS,
                                 N_ITEMS, "cuda")
    paths, leaves = zip(*leaves_with_paths(params))
    for leaf in leaves:
        leaf.requires_grad_(True)
    batch = _batches(bundle_np, 1, TRAIN_BATCH, "cuda", _log_q(bundle_np))[0]
    cw = balanced_class_weights(bundle_np["train/y_implicit"])
    psum = make_sharded_lookup_psum(ctx)
    lookups = {"psum": psum, "a2a": lambda t, i: make_sharded_lookup_a2a(
        ctx, a2a_capacity(i.shape[0], ctx.n_model, 2.0))(t, i)[0]}

    def run(lookup):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
        _, m = MultiTaskModel.loss(params, model, batch, generator=gen, train=True,
                                   class_weights=cw, lookup=lookup)
        grads = torch.autograd.grad(m["loss"], leaves, allow_unused=True)
        return float(m["loss"].detach()), [torch.zeros_like(p) if gr is None else gr
                                  for p, gr in zip(leaves, grads)]

    ref_loss, ref_grads = run(None)
    for c in counters:
        c.reset()
    got = {name: run(lookup) for name, lookup in lookups.items()}
    torch.cuda.synchronize()
    launches = {c.name: c.read() for c in counters}
    for name in ("dcn_cross", "dcn_cross_bwd", "flash_ce_fwd", "flash_ce_bwd_du",
                 "flash_ce_bwd_dv"):
        check(launches[name] > 0, f"phase 27: {name} never launched in the loss with a lookup")
    check(launches["flash_ce_bwd_fused"] == 0, "phase 27: the fused backward ran on bf16")
    out = {"launches": launches, "loss_no_lookup": ref_loss}
    for name, (loss, grads) in got.items():
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        check(loss_err <= PARITY_LOSS_RTOL, f"phase 27: loss with {name} {loss} vs {ref_loss}")
        worst, where, equal = 0.0, "", loss == ref_loss
        for path, gr, ref in zip(paths, grads, ref_grads):
            err = float((gr - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
            equal = equal and bool(torch.equal(gr, ref))
            if err > worst:
                worst, where = err, "/".join(path)
        check(worst <= PARITY_LOSS_RTOL,
              f"phase 27: the gradient with {name} is off by {worst} of max|ref| at {where}")
        out[name] = {"loss": loss, "loss_rel_err": loss_err, "grad_max_rel_err": worst,
                     "grad_worst_leaf": where, "bit_equal": equal}
    del params, leaves, ref_grads, got
    torch.cuda.empty_cache()
    return out


def rows_lookup_path(repo: str, counters, tmp: str, bundle_np: dict) -> dict:
    """Phase 27: the row-sharded tables' lookups on a one-rank NCCL mesh
    from ``make_mesh`` (at ``n_model == 1`` the trainer keeps its tables
    whole, by the JAX package's own rule, so the lookups are driven
    directly): (a) at the giant row's shape, (b) inside the full-width loss,
    the counters set to 0 just before and read just after; the group is
    destroyed; (c) the train CLI under ``torchrun`` with ``--model_parallel
    1 --embedding_sharding rows --lookup_strategy a2a`` against the plain
    CLI."""
    import torch.distributed as dist
    from recsys_tpu_torch.parallel import mesh as mesh_mod

    out = {}
    ctx = mesh_mod.make_mesh(model_parallel=1, data_parallel=1, device="cuda")
    try:
        check(dist.get_backend() == "nccl" and ctx.n_model == 1, "phase 27: not an NCCL mesh")
        out["giant"], profiles = lookups_at_giant_shape(ctx)
        log(f"phase 27 (a): {json.dumps(out['giant'])}")
        out["loss"] = loss_with_lookup(ctx, bundle_np, counters)
        log(f"phase 27 (b): {json.dumps(out['loss'])}")
    finally:
        mesh_mod.shutdown()
    check(not dist.is_initialized(), "the process group outlived phase 27")
    out["cli"] = dp_train_cli(repo, bundle_np, tmp, extra=(
        "--model_parallel", "1", "--embedding_sharding", "rows", "--lookup_strategy", "a2a"),
        label="rows")
    out["profiles"] = profiles
    return out


def data_parallel_path(repo: str, counters, tmp: str, bundle_np: dict) -> dict:
    """Phase 26: data-parallel training on a one-rank NCCL mesh from
    ``make_mesh``: ``Trainer(mesh_ctx=...).train`` one epoch on phase 8's
    bundle at the full-width defaults (B = 8,192, global negatives, the
    flash route), the counters set to 0 just before and read just after
    (rows 2, 3, 4, 6, 7 and, in rank 0's final evaluate, 1); (a) 3 mesh
    steps against 3 one-card steps from one init, then the same at phase
    21's scale row (4M x 2M tables, dim 64, B = 4,096, the sparse step),
    each step profiled; (b) rows 4 to 7 with the positives at an offset;
    the group is destroyed; (c) the train CLI under ``torchrun``."""
    import math

    import numpy as np
    import torch
    import torch.distributed as dist
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig
    from recsys_tpu_torch.models.losses import balanced_class_weights
    from recsys_tpu_torch.models.multitask import MultiTaskModel
    from recsys_tpu_torch.parallel import mesh as mesh_mod
    from recsys_tpu_torch.train.checkpoint import params_to_numpy
    from recsys_tpu_torch.train.trainer import Trainer

    out = {}
    ctx = mesh_mod.make_mesh(model_parallel=1, data_parallel=1, device="cuda")
    try:
        check(dist.get_backend() == "nccl" and ctx.n_data == 1, "phase 26: not an NCCL mesh")
        cfg = RecsysConfig(model=ModelConfig(), train=TrainConfig(batch_size=TRAIN_BATCH,
                                                                  epochs=1))
        run = os.path.join(tmp, "dp_train")
        trainer = Trainer(cfg, run, device="cuda", mesh_ctx=ctx)
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        report = trainer.train(bundle_np)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.name: c.read() for c in counters}
        steps = N_TRAIN // TRAIN_BATCH
        for name in NEG_PATH_KERNELS + ("topk_flash",):
            check(launches[name] > 0, f"phase 26: {name} never launched on the mesh")
        check(launches["dcn_cross_bwd"] == steps,
              f"phase 26: the DCN backward launched {launches['dcn_cross_bwd']} times")
        check(launches["flash_ce_bwd_fused"] == 0, "phase 26: the fused backward ran on bf16")
        check(trainer.step_counts == {"dense": steps, "sparse": 0},
              f"phase 26: steps {trainer.step_counts}")
        with open(os.path.join(run, "detailed_metrics.json")) as f:
            epoch = json.load(f)["epochs"][0]
        for k in ("train_loss", "val_loss"):
            check(math.isfinite(epoch[k]), f"phase 26: {k} = {epoch[k]}")
        check(os.path.exists(os.path.join(run, "serving", "index.npz")),
              "phase 26: rank 0 wrote no bundle")
        out["train"] = {"launches": launches, "wall_s": wall, "steps": steps,
                        "epoch_time_s": epoch["epoch_time_s"],
                        "examples_per_s": epoch["examples_per_s"],
                        "train_loss": epoch["train_loss"], "val_loss": epoch["val_loss"],
                        "recall@10": report["recall@10"]}
        del trainer
        torch.cuda.empty_cache()
        log(f"phase 26 train: {json.dumps(out['train'])}")

        # (a) the dense step at full width, then the sparse step at the scale row
        cw = balanced_class_weights(bundle_np["train/y_implicit"])
        init = params_to_numpy(MultiTaskModel.init(torch.Generator().manual_seed(SEED + 26),
                                                   cfg.model, N_USERS, N_ITEMS, "cpu"))
        batches = _batches(bundle_np, PARITY_STEPS, TRAIN_BATCH, "cuda", _log_q(bundle_np))
        out["dense"] = mesh_vs_one_card(ctx, cfg, init, batches, cw, counters, tmp, "dense")
        log(f"phase 26 (a) dense: {json.dumps({k: v for k, v in out['dense'].items() if k != 'profiles'})}")
        model = ModelConfig(embedding_dim=SCALE_ROW_DIM, mixed_precision=True, dropout_rate=0.2)
        sparse_cfg = RecsysConfig(model=model, train=TrainConfig(
            batch_size=SCALE_ROW_BATCH, sparse_table_updates=True))
        init = params_to_numpy(MultiTaskModel.init(torch.Generator().manual_seed(SEED + 16),
                                                   model, GIANT_USERS, GIANT_ITEMS, "cpu"))
        rng = np.random.default_rng(SEED + 17)
        b = SCALE_ROW_BATCH
        batches = [{k: torch.as_tensor(v, device="cuda") for k, v in {
            "user_id": rng.integers(0, GIANT_USERS, b).astype(np.int32),
            "movie_id": rng.integers(0, GIANT_ITEMS, b).astype(np.int32),
            "rating": rng.uniform(1, 5, b).astype(np.float32),
            "y_implicit": (rng.random(b) > 0.4).astype(np.float32),
            "log_q": np.full(b, -np.log(GIANT_ITEMS), np.float32)}.items()}
            for _ in range(PARITY_STEPS)]
        out["sparse"] = mesh_vs_one_card(ctx, sparse_cfg, init, batches, (1.3, 0.8), counters,
                                         tmp, "sparse")
        check(out["sparse"]["step_counts"]["sparse"] == PARITY_STEPS,
              f"phase 26: the scale row took {out['sparse']['step_counts']}")
        del init, batches
        torch.cuda.empty_cache()
        log(f"phase 26 (a) sparse: {json.dumps({k: v for k, v in out['sparse'].items() if k != 'profiles'})}")

        # (b) rows 4 to 7 with the positives at an offset
        out["offset_rows"] = offset_positive_rows()
        log(f"phase 26 (b): {json.dumps(out['offset_rows'])}")
    finally:
        mesh_mod.shutdown()
    check(not dist.is_initialized(), "the process group outlived phase 26")
    out["profiles"] = out["dense"].pop("profiles") + out["sparse"].pop("profiles")
    # (c) the train CLI under the launcher
    out["cli"] = dp_train_cli(repo, bundle_np, tmp)
    return out


# ---- phase 28: the debugging modes and the row-sharded checkpoint -----------

# kernel row -> the wrapper's counter and the names of its main CUDA kernel
# (a row 3 launch also runs its reduction, a row 4 launch at times its
# combine kernel: neither is counted here)
DEBUG_ROWS = {2: ("dcn_cross", ("dcn_cross_fwd_kernel",)),
              3: ("dcn_cross_bwd", ("dcn_cross_bwd_kernel", "dcn_cross_bwd_smem_kernel")),
              4: ("flash_ce_fwd", ("flash_ce_fwd_kernel", "flash_ce_fwd_tc_kernel")),
              5: ("flash_ce_bwd_fused", ("flash_ce_bwd_kernel", "flash_ce_bwd_tc_kernel")),
              6: ("flash_ce_bwd_du", ("flash_ce_bwd_du_kernel", "flash_ce_bwd_du_tc_kernel")),
              7: ("flash_ce_bwd_dv", ("flash_ce_bwd_dv_kernel", "flash_ce_bwd_dv_wgmma_kernel"))}
# phase 18's user table, padded to 4 row ranges
CKPT_TABLE_ROWS, CKPT_RANGES = GIANT_USERS + 4, 4


def _trace_kernel_counts(trace_path: str) -> dict:
    """Kernel events of a ``torch.profiler`` trace by kernel row (the
    ``DEBUG_ROWS`` names, as whole words of the event's name)."""
    import re

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    out = {}
    for row, (_, kernels) in DEBUG_ROWS.items():
        pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(kernels) + r")(?![A-Za-z0-9_])")
        out[row] = sum(1 for n in names if pat.search(n))
    out["all_kernels"] = len(names)
    return out


class _RssPeak:
    """The process's resident set sampled every 5 ms on a thread: ``growth``
    is the peak over the ``with`` block less the size at its start."""

    @staticmethod
    def rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        raise RuntimeError("no VmRSS in /proc/self/status")

    def __enter__(self):
        self.start = self.peak = self.rss()
        self._stop = threading.Event()

        def sample():
            while not self._stop.is_set():
                self.peak = max(self.peak, self.rss())
                time.sleep(0.005)

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss())
        self.growth = self.peak - self.start
        return False


def debug_epoch(bundle_np: dict, counters, tmp: str) -> dict:
    """Phase 28 (a): ``Trainer.train`` one epoch of phase 8's bundle at the
    full-width defaults with ``profile`` and ``debug_nans`` on, the
    counters set to 0 just before and read just after: rows 2, 3, 4, 6 and
    7 launch and row 5 does not; the trace under ``<out>/profile`` parses
    and names each of those rows' kernels; each row's trace events beside
    its launches (a shortfall is recorded, not hidden)."""
    import glob
    import math

    import torch
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig
    from recsys_tpu_torch.train.trainer import Trainer
    from recsys_tpu_torch.utils.debug import disable_nan_checks

    out_dir = os.path.join(tmp, "debug_epoch")
    cfg = RecsysConfig(model=ModelConfig(), train=TrainConfig(
        batch_size=TRAIN_BATCH, epochs=1, profile=True, debug_nans=True))
    trainer = Trainer(cfg, out_dir, device="cuda")
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    try:
        report = trainer.train(bundle_np)
        torch.cuda.synchronize()
    finally:
        disable_nan_checks()
    wall = time.perf_counter() - t0
    launches = {c.name: c.read() for c in counters}
    for row in (2, 3, 4, 6, 7):
        check(launches[DEBUG_ROWS[row][0]] > 0, f"phase 28: row {row} never launched")
    check(launches["flash_ce_bwd_fused"] == 0, "phase 28: row 5 ran on bf16 operands")
    check(math.isfinite(report["recall@10"]), f"phase 28: recall@10 {report['recall@10']}")
    traces = glob.glob(os.path.join(out_dir, "profile", "*.pt.trace.json"))
    check(len(traces) == 1, f"phase 28: traces {traces}")
    events = _trace_kernel_counts(traces[0])
    for row in (2, 3, 4, 6, 7):
        check(events[row] > 0, f"phase 28: the trace holds no kernel of row {row}")
    steps = N_TRAIN // TRAIN_BATCH
    return {"launches": launches, "wall_s": wall, "steps": steps,
            "trace_events": {DEBUG_ROWS[r][0]: events[r] for r in DEBUG_ROWS},
            "trace_kernel_events": events["all_kernels"],
            "trace_mb": os.path.getsize(traces[0]) / 1e6,
            "tensorboard_sink": os.path.isdir(os.path.join(out_dir, "tensorboard")),
            "recall@10": report["recall@10"]}


def debug_steps(bundle_np: dict, tmp: str) -> dict:
    """Phase 28 (b) and (c). (b): 3 full-width steps (dropout on) with the
    NaN checks on against 3 without from one init: params, slots and
    losses bit-equal; the step profiled with the checks off and on in
    turns (off, on, on, off: wall p50, device ms, launches). (c): a NaN in the first cross layer's ``w`` raises
    ``FloatingPointError`` naming row 2, the params and slots untouched,
    and ``Trainer.train`` with it planted writes no checkpoint; a NaN in
    one rating of the first batch raises naming an aten op."""
    import torch
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig
    from recsys_tpu_torch.models.losses import balanced_class_weights
    from recsys_tpu_torch.train.optimizer import leaves_with_paths
    from recsys_tpu_torch.train.trainer import Trainer
    from recsys_tpu_torch.utils.debug import disable_nan_checks, enable_nan_checks

    cw = balanced_class_weights(bundle_np["train/y_implicit"])
    batches = _batches(bundle_np, PARITY_STEPS, TRAIN_BATCH, "cuda", _log_q(bundle_np))
    cfg = RecsysConfig(model=ModelConfig(), train=TrainConfig(batch_size=TRAIN_BATCH))
    out = {}

    def bits(tree):
        return {p: t.detach().clone() for p, t in leaves_with_paths(tree)}

    def same(a, b):
        return all(torch.equal(a[p].view(torch.int32), b[p].view(torch.int32)) for p in a)

    runs = []
    for on in (False, True):
        (enable_nan_checks if on else disable_nan_checks)()
        try:
            tr = Trainer(cfg, os.path.join(tmp, f"debug_steps_{on}"), device="cuda")
            state = tr.init_state(N_USERS, N_ITEMS, SEED)
            step = tr.make_train_step(cw)
            losses = []
            for b in batches:
                state, m = step(state, b)
                losses.append(m["loss"])
            runs.append((bits(state.params), bits(state.opt_state), torch.stack(losses)))
        finally:
            disable_nan_checks()
    (p0, s0, l0), (p1, s1, l1) = runs
    equal = same(p0, p1) and same(s0, s1) and torch.equal(l0, l1)
    check(equal, "phase 28: debug_nans changed the steps' result")
    out["bit_equal"] = equal
    out["losses"] = [float(x) for x in l0]
    # the same step with the switch off and on, in turns (off, on, on, off)
    holder = [state]

    def one():
        holder[0], _ = step(holder[0], batches[holder[0].step % PARITY_STEPS])

    out["step_profiles"] = []
    for on in (False, True, True, False):
        (enable_nan_checks if on else disable_nan_checks)()
        try:
            out["step_profiles"].append(profile_call(
                f"train_step_B{TRAIN_BATCH}_debug_nans_{'on' if on else 'off'}", one,
                n_wall=20, n_traced=5, warmup=2, lead_in_ms=200.0))
        finally:
            disable_nan_checks()

    # (c) the planted NaNs
    enable_nan_checks()
    msgs = {}
    try:
        tr = Trainer(cfg, os.path.join(tmp, "debug_nan"), device="cuda")
        state = tr.init_state(N_USERS, N_ITEMS, SEED)
        step = tr.make_train_step(cw)
        with torch.no_grad():
            state.params["dcn"]["cross"]["layer_0"]["w"][3] = float("nan")
        before, slots = bits(state.params), bits(state.opt_state)
        try:
            step(state, batches[0])
        except FloatingPointError as e:
            msgs["cross_w"] = str(e)
        check("kernel row 2 dcn_cross" in msgs.get("cross_w", ""),
              f"phase 28: the planted w gave {msgs.get('cross_w')!r}")
        check(same(before, bits(state.params)) and same(slots, bits(state.opt_state)),
              "phase 28: the failed step changed the state")
        state = tr.init_state(N_USERS, N_ITEMS, SEED)
        batch = dict(batches[0])
        batch["rating"] = batch["rating"].clone()
        batch["rating"][5] = float("nan")
        try:
            step(state, batch)
        except FloatingPointError as e:
            msgs["rating"] = str(e)
        check(msgs.get("rating", "").startswith("invalid value (nan) encountered in aten."),
              f"phase 28: the planted rating gave {msgs.get('rating')!r}")
        # through Trainer.train: it raises at step 0 and saves nothing
        init_state = Trainer.init_state

        def planted(self, *args, **kwargs):
            st = init_state(self, *args, **kwargs)
            with torch.no_grad():
                st.params["dcn"]["cross"]["layer_0"]["w"][3] = float("nan")
            return st

        run = os.path.join(tmp, "debug_nan_train")
        Trainer.init_state = planted
        try:
            Trainer(RecsysConfig(model=ModelConfig(), train=TrainConfig(
                batch_size=TRAIN_BATCH, epochs=1, debug_nans=True)), run,
                device="cuda").train(bundle_np)
        except FloatingPointError as e:
            msgs["train"] = str(e)
        finally:
            Trainer.init_state = init_state
        check("kernel row 2 dcn_cross" in msgs.get("train", "")
              and msgs["train"].endswith("at step 0"),
              f"phase 28: Trainer.train with the planted w gave {msgs.get('train')!r}")
        check(os.listdir(os.path.join(run, "checkpoints")) == [],
              "phase 28: a checkpoint was written after the NaN")
    finally:
        disable_nan_checks()
    out["messages"] = msgs
    return out


def ckpt_at_giant_shape(tmp: str) -> dict:
    """Phase 28 (d): phase 18's user table (4,000,001 x 128 fp32, padded to
    ``CKPT_TABLE_ROWS``) and one adagrad slot of it, on the card, written
    through the streaming checkpoint writer (``RowShards`` on a one-rank
    NCCL mesh: the rows come to the host in ``GATHER_CHUNK_BYTES`` chunks),
    then read back as ``CKPT_RANGES`` row ranges, each bit-equal to its
    rows, and ``np.load`` of the whole member equal to the table; the
    seconds and the peak RSS growth of the write and of each read."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from recsys_tpu_torch.parallel import mesh as mesh_mod
    from recsys_tpu_torch.parallel.sharding import GATHER_CHUNK_BYTES
    from recsys_tpu_torch.train.checkpoint import CheckpointManager, RowShards

    g = torch.Generator(device="cuda").manual_seed(SEED + 28)
    table = torch.randn((CKPT_TABLE_ROWS, 128), generator=g, device="cuda")
    slot = torch.rand((CKPT_TABLE_ROWS, 128), generator=g, device="cuda")
    keys = ("params/towers/user_table", "opt_state/accum/towers/user_table")
    manager = CheckpointManager(os.path.join(tmp, "ckpt_giant"))
    ctx = mesh_mod.make_mesh(model_parallel=1, data_parallel=1, device="cuda")
    try:
        check(dist.get_backend() == "nccl", "phase 28: not an NCCL mesh")
        state = {"params": {"towers": {"user_table": RowShards(ctx, table)}},
                 "opt_state": {"accum": {"towers": {"user_table": RowShards(ctx, slot)}}},
                 "step": np.int64(1)}
        with _RssPeak() as w:
            manager.save(1, state)
    finally:
        mesh_mod.shutdown()
    check(not dist.is_initialized(), "the process group outlived phase 28")
    path = os.path.join(tmp, "ckpt_giant", "ckpt_1", "state.npz")
    want = {k: t.cpu().numpy().view(np.uint32) for k, t in zip(keys, (table, slot))}
    table_bytes = table.numel() * 4
    del table, slot
    torch.cuda.empty_cache()
    n = CKPT_TABLE_ROWS // CKPT_RANGES
    reads = []
    for i in range(CKPT_RANGES):
        lo, hi = i * n, (i + 1) * n
        with _RssPeak() as r:
            got = manager.restore(1, rows={k: (lo, hi) for k in keys})
        flat = {keys[0]: got["params"]["towers"]["user_table"],
                keys[1]: got["opt_state"]["accum"]["towers"]["user_table"]}
        for k in keys:
            check(np.array_equal(flat[k].view(np.uint32), want[k][lo:hi]),
                  f"phase 28: rows [{lo}, {hi}) of {k} are not the table's")
        del got, flat
        reads.append({"rows": [lo, hi], "s": r.seconds, "rss_growth_gb": r.growth / 1e9})
    with _RssPeak() as whole_read:
        with np.load(path) as z:
            whole = z[keys[0]]
    check(np.array_equal(whole.view(np.uint32), want[keys[0]]),
          "phase 28: np.load of the streamed member is not the table")
    del whole, want
    out = {"table": [CKPT_TABLE_ROWS, 128], "table_gb": table_bytes / 1e9,
           "chunk_mb": GATHER_CHUNK_BYTES / 1e6, "file_gb": os.path.getsize(path) / 1e9,
           "write_s": w.seconds, "write_rss_growth_gb": w.growth / 1e9, "reads": reads,
           "np_load_member_s": whole_read.seconds,
           "np_load_rss_growth_gb": whole_read.growth / 1e9}
    shutil.rmtree(os.path.join(tmp, "ckpt_giant"))
    return out


def debug_modes_path(counters, tmp: str, bundle_np: dict) -> dict:
    """Phase 28: (a) :func:`debug_epoch`, (b) and (c) :func:`debug_steps`,
    (d) :func:`ckpt_at_giant_shape`."""
    out = {"epoch": debug_epoch(bundle_np, counters, tmp)}
    log(f"phase 28 (a): {json.dumps(out['epoch'])}")
    out["steps"] = debug_steps(bundle_np, tmp)
    log(f"phase 28 (b, c): {json.dumps(out['steps'])}")
    out["ckpt"] = ckpt_at_giant_shape(tmp)
    log(f"phase 28 (d): {json.dumps(out['ckpt'])}")
    return out


# ---- DLRM-DCNv2's embedding bags (ops/embedding_bag.py) ---------------------
# the cell dlrm-train-mhot's shape: B = 65,536 examples, 26 bags of 1 to 100
# ids (214 an example) over 29,184,588 rows of 128 fp32 (five 40M-row
# tables cut to 5M), from the benchmark's configuration
DLRM_CONFIG = "bench_port/configs/mlperf-dlrm-dcnv2-1of8.json"
DLRM_BATCH = 65_536
# the bags' backward against its plain version after one row-wise Adagrad
# update, relative to the largest move of a row: the rows' gradients are
# summed in another order (sorted lookups against a column at a time), so
# their mean squares and the moves differ in the last bits; a dropped or
# doubled lookup moves a row by the order of its gradient
DLRM_UPDATE_TOL = 1e-4
# (D, table rows, bag sizes, examples) of the edge shapes: each row width
# the kernels template (D / 4 up to 32, 64 and 128 float4s), runs of one
# row across many 32-lookup chunks, a ragged last chunk
DLRM_EDGES = [(12, (3, 50), (1, 2), 1000), (16, (3, 50, 2000, 7), (1, 3, 7, 2), 4099),
              (256, (4, 9000), (5, 40), 333), (512, (2, 100), (3, 1), 77)]


def _dlrm_ids(layout, b: int, seed: int):
    """[b, S] int32 ids, uniform over each bag's table."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cols = [torch.randint(0, r, (b, h), generator=gen, device="cuda")
            for r, h in zip(layout.table_rows, layout.bag_sizes)]
    return torch.cat(cols, dim=1).to(torch.int32)


def check_bags(d: int, table_rows, bag_sizes, b: int, seed: int, timed: bool = False) -> dict:
    """The bags' kernels against their plain versions on the card: the
    forward bit for bit (the same adds in the same order), twice bit-equal;
    the backward with its row-wise update twice bit-equal, to
    DLRM_UPDATE_TOL of the plain update, and its count of rows updated
    equal to the plain version's."""
    import torch
    from recsys_tpu_torch.ops import embedding_bag as eb
    from recsys_tpu_torch.train.optimizer import sparse_rowwise_adagrad_combined

    layout = eb.make_layout(table_rows, bag_sizes, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = (torch.rand((layout.n_rows, d), generator=gen, device="cuda") - 0.5) * 0.02
    ids = _dlrm_ids(layout, b, seed + 1)
    what = f"bags D={d} rows={layout.n_rows} B={b}"
    launches0 = eb.bag_forward.launches
    out1 = eb.bag_forward(table, ids, layout)
    out2 = eb.bag_forward(table, ids, layout)
    check(torch.equal(out1, out2), f"{what}: two forward calls differ")
    check(torch.equal(out1, eb.bag_forward_reference(table, ids, layout)),
          f"{what}: the forward is not its plain version's sum")
    check(eb.bag_forward.launches - launches0 == 2, f"{what}: forward launches")
    grad = torch.randn(out1.shape, generator=gen, device="cuda") * 1e-3
    del out1, out2
    lr = 0.004
    accum = (torch.rand((layout.n_rows,), generator=gen, device="cuda") + 0.5) * 1e-6
    runs = []
    launches0 = eb.bag_backward_rowwise_adagrad.launches
    for _ in range(2):
        t, a = table.clone(), accum.clone()
        _, uniq = eb.bag_backward_rowwise_adagrad(t, a, ids, grad, layout, lr)
        runs.append((t, a, int(uniq)))
        if len(runs) == 2:
            check(torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1]),
                  f"{what}: two backward calls differ")
            del runs[1]
    check(eb.bag_backward_rowwise_adagrad.launches - launches0 == 2, f"{what}: backward launches")
    t1, a1, n_kernel = runs[0]
    del runs
    rows, combined = eb.combine_bag_rows_reference(ids, grad, layout)
    sparse_rowwise_adagrad_combined(table, accum, rows, combined,
                                    torch.ones(rows.shape, dtype=torch.bool, device="cuda"), lr)
    check(n_kernel == rows.shape[0], f"{what}: {n_kernel} rows updated, want {rows.shape[0]}")
    del rows, combined
    # row-wise Adagrad moves an element by lr * |g| / rms(g), lr and more;
    # compared a million rows at a time
    err = max(float(torch.max(torch.abs(t1[r:r + (1 << 20)] - table[r:r + (1 << 20)])))
              for r in range(0, layout.n_rows, 1 << 20))
    acc_err = float(torch.max(torch.abs(a1 - accum) / accum))
    check(err <= DLRM_UPDATE_TOL * lr, f"{what}: the update is off by {err}")
    check(acc_err <= DLRM_UPDATE_TOL, f"{what}: the accumulator is off by {acc_err} (relative)")
    out = {"d": d, "rows": layout.n_rows, "b": b, "lookups": b * ids.shape[1],
           "unique_rows": n_kernel, "update_err": err, "accum_rel_err": acc_err}
    del t1, a1
    if timed:
        t, a = table.clone(), accum.clone()
        out["fwd_ms"] = time_ms(lambda: eb.bag_forward(table, ids, layout), 10)
        out["bwd_ms"] = time_ms(lambda: eb.bag_backward_rowwise_adagrad(t, a, ids, grad, layout,
                                                                        1e-9), 10)
        out["fwd_plain_ms"] = time_ms(lambda: eb.bag_forward_reference(table, ids, layout), 2, 1)
    return out


def dlrm_bags_phase(repo: str, tmp: str) -> dict:
    """The bags' kernels at the edge shapes and at the cell's shape; then
    DLRM-DCNv2 through the trainer's step (``dryrun_dlrm``: the cell's
    widths, tables cut to 1,000 rows) and the train CLI (``--config``, a
    tiny model, 2 epochs) on the card."""
    import math

    import numpy as np
    import torch
    from recsys_tpu_torch.config import RecsysConfig
    from recsys_tpu_torch.train import __main__ as train_cli
    from recsys_tpu_torch.train.dryrun import dryrun_dlrm

    out = {"edges": [check_bags(d, r, h, b, 7 + i) for i, (d, r, h, b) in enumerate(DLRM_EDGES)]}
    cfg = RecsysConfig.load(os.path.join(repo, DLRM_CONFIG))
    m = cfg.model
    out["cell_shape"] = check_bags(m.embedding_dim, m.table_rows, m.bag_sizes, DLRM_BATCH, 11,
                                   timed=True)
    torch.cuda.empty_cache()
    out["dryrun"] = dryrun_dlrm(cfg, "cuda", batch=1024)
    rng = np.random.default_rng(3)
    rows, bags_ = (3, 50, 2000, 7), (1, 3, 7, 2)

    def split(n):
        sp = np.concatenate([rng.integers(0, r, (n, h)) for r, h in zip(rows, bags_)], axis=1)
        return {"dense": rng.random((n, 13), dtype=np.float32), "sparse": sp.astype(np.int32),
                "label": (rng.random(n) < 0.3).astype(np.float32)}

    data = os.path.join(tmp, "dlrm_bundle.npz")
    np.savez(data, **{f"{s}/{k}": v for s, n in (("train", 2048), ("val", 300))
                      for k, v in split(n).items()})
    tiny = os.path.join(tmp, "dlrm_tiny.json")
    cfg.replace(**{"model.table_rows": list(rows), "model.bag_sizes": list(bags_),
                   "model.table_init_rows": list(rows), "model.embedding_dim": 16,
                   "model.bottom_mlp_dims": [32, 16], "model.over_arch_dims": [32, 16],
                   "model.dcn_low_rank_dim": 8, "train.batch_size": 256,
                   "train.epochs": 2}).save(tiny)
    rc = train_cli.main(["--config", tiny, "--data", data, "--device", "cuda",
                         "--output_dir", os.path.join(tmp, "dlrm_run")])
    with open(os.path.join(tmp, "dlrm_run", "metrics.json")) as f:
        report = json.load(f)
    check(rc == 0 and math.isfinite(report["val_loss"]), f"dlrm CLI: rc {rc}, {report}")
    out["cli"] = report
    return out


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
                Counter("topk_select", topk_mod.topk_select),
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
    check(launches["topk_select"] == launches["topk_flash"],
          "the select kernel did not follow every top-k launch on the main path")
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
    dcn_bwd_edges = check_train_edges()
    fp32_edges = check_fp32_bwd_edges()
    log(f"row 5 fp32 agrees with its plain version at its edges: {json.dumps(fp32_edges)}")
    fp32_du_fwd_edges = check_fp32_du_fwd_edges()
    log(f"rows 4 and 6 fp32 agree with their plain versions at their edges: "
        f"{json.dumps(fp32_du_fwd_edges)}")
    fp32_dv_edges = check_fp32_dv_edges()
    log(f"row 7 fp32 agrees with its plain version at its edges: {json.dumps(fp32_dv_edges)}")
    counters += [Counter("flash_ce_fwd", flash_mod.flash_ce_fwd),
                 Counter("flash_ce_bwd_fused", flash_mod.flash_ce_bwd_fused),
                 Counter("flash_ce_bwd_du", flash_mod.flash_ce_bwd_du),
                 Counter("flash_ce_bwd_dv", flash_mod.flash_ce_bwd_dv),
                 Counter("dcn_cross_bwd", dcn_mod.dcn_cross_bwd)]
    bundle_np = synthetic_bundle(SEED)
    with tempfile.TemporaryDirectory() as run_dir:
        t0 = time.perf_counter()
        trained = train_main_path(bundle_np, counters, run_dir)
        log(f"trained the main path in {time.perf_counter() - t0:.1f} s: "
            f"{json.dumps(trained)}")
        train_launches = trained["launches"]
        # bf16 operands ("auto" from 8,192 candidates): rows 4, 6 and 7
        for name in ("flash_ce_fwd", "flash_ce_bwd_du", "flash_ce_bwd_dv", "dcn_cross_bwd",
                     "dcn_cross", "topk_flash"):
            check(train_launches[name] > 0, f"{name} never launched while training")
        check(train_launches["topk_scores"] == 0, "the dense k > 256 path ran in training")
        check(train_launches["flash_ce_bwd_fused"] == 0,
              "the fused backward ran on bf16 operands")
        t0 = time.perf_counter()
        served_trained = serve_main_path(os.path.join(run_dir, "serving"), counters)
        log(f"served the trained bundle in {time.perf_counter() - t0:.1f} s: "
            f"launches {served_trained['launches']}")
        check(served_trained["launches"]["topk_flash"] > 0
              and served_trained["launches"]["dcn_cross"] > 0,
              "the trained bundle was not served through the kernels")
        with tempfile.TemporaryDirectory() as fp32_dir:
            # fp32 retrieval operands (the train CLI's --no-bf16 with
            # bf16_retrieval_logits=false): the fused backward
            fp32_trained = train_main_path(bundle_np, counters, fp32_dir, epochs=1,
                                           mixed_precision=False, bf16_retrieval_logits=False)
        log(f"trained one epoch with fp32 retrieval operands: {json.dumps(fp32_trained)}")
        fp32_launches = fp32_trained["launches"]
        check(fp32_launches["flash_ce_bwd_fused"] > 0 and fp32_launches["flash_ce_fwd"] > 0,
              f"fp32 retrieval operands: flash launches {fp32_launches}")
        check(fp32_launches["flash_ce_bwd_du"] == fp32_launches["flash_ce_bwd_dv"] == 0,
              "fp32 retrieval operands took the two-kernel backward")
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
        log(f"kernel flash_ce_bwd_fused {json.dumps(bwd)}")
    for row in dcn_bwd_rows:
        log(f"kernel dcn_cross_bwd {json.dumps(row)}")
    train_profiles = profile_train_steps(bundle_np)
    for row in train_profiles:
        log(f"profile {json.dumps(row)}")
    fp32_steps = {r["profile"]: r for r in train_profiles if "group_launches" in r}

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

    # ---- giant-table, large-batch training: the fourth main path ----------
    t_giant = time.perf_counter()
    twokernel = twokernel_phases(sm_clock)
    for row in twokernel["main"] + twokernel["main_fp32"] + twokernel["above"]:
        log(f"kernel two-kernel backward {json.dumps(row)}")
    t0 = time.perf_counter()
    giant_np = giant_bundle(SEED + 11)
    log(f"made the {GIANT_USERS:,} x {GIANT_ITEMS:,} bundle in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as giant_dir:
        giant = train_giant(giant_np, counters, giant_dir)
        giant_trainer = giant.pop("trainer")
        log(f"trained the giant-table configuration: {json.dumps(giant)}")
        giant_profile = profile_giant_step(giant_trainer, giant_np)
        log(f"profile {json.dumps(giant_profile)}")
    # the kernels run once per step at the above-cap shape: their device
    # time in the step's trace (a lone 0.66 s launch may record none)
    for row, label in zip(twokernel["above"], ("row6_du", "row7_dv")):
        row["kernel_device_ms_in_step"] = giant_profile["group_device_ms"][label]
    giant_launches = giant["launches"]
    del giant_trainer, giant_np
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        log(f"card vs CPU, sparse step + cache on rows 6 and 7: "
            f"{json.dumps(card_vs_cpu_scale(tmp))}")
    for row in sparse_vs_dense_scale_row():
        log(f"profile {json.dumps(row)}")
    log(f"giant-table phases in {time.perf_counter() - t_giant:.1f} s")

    # ---- data and features, export: the fifth main path -------------------
    t_dense = time.perf_counter()
    with tempfile.TemporaryDirectory() as dense_dir:
        dense = dense_feature_path(repo, counters, dense_dir)
        log(f"data-and-features phase in {time.perf_counter() - t_dense:.1f} s")
        # ---- explicit negatives and streaming: the sixth main path ---------
        t_neg = time.perf_counter()
        negs = negatives_streaming_path(counters, dense_dir, bundle_np)
        log(f"negatives-and-streaming phase in {time.perf_counter() - t_neg:.1f} s")
        # ---- the rest of serving: the seventh main path -------------------
        t_rest = time.perf_counter()
        rest = serving_rest_path(repo, counters, dense_dir)
        log(f"rest-of-serving phase in {time.perf_counter() - t_rest:.1f} s")
        # ---- the mesh and the sharded catalog: the eighth main path -------
        t_sharded = time.perf_counter()
        sharded = sharded_path(repo, counters, dense_dir)
        log(f"sharded phase in {time.perf_counter() - t_sharded:.1f} s")
        # ---- data-parallel training: the ninth main path ------------------
        t_dp = time.perf_counter()
        dp = data_parallel_path(repo, counters, dense_dir, bundle_np)
        log(f"data-parallel phase in {time.perf_counter() - t_dp:.1f} s")
        # ---- row-sharded tables' lookups: the tenth main path -------------
        t_rows = time.perf_counter()
        rows_lookup = rows_lookup_path(repo, counters, dense_dir, bundle_np)
        log(f"row-sharded lookup phase in {time.perf_counter() - t_rows:.1f} s")
        # ---- the debugging modes and the checkpoint I/O: the eleventh -----
        t_debug = time.perf_counter()
        debug_modes = debug_modes_path(counters, dense_dir, bundle_np)
        log(f"debug-modes phase in {time.perf_counter() - t_debug:.1f} s")
    # ---- DLRM-DCNv2's embedding bags, trainer and CLI: the twelfth ---------
    # in a process of its own: at the cell's shape it holds three copies of
    # a 14.9 GB table
    t_dlrm = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--dlrm-bags"], cwd=repo,
                          capture_output=True, text=True, timeout=1200)
    check(proc.returncode == 0, f"--dlrm-bags: rc {proc.returncode}\n{proc.stderr[-4000:]}")
    log(f"dlrm bags phase in {time.perf_counter() - t_dlrm:.1f} s: "
        f"{proc.stdout.strip().splitlines()[-1]}")
    for row in negs.pop("profiles"):
        log(f"profile {json.dumps(row)}")
    log(f"explicit negatives and streaming: {json.dumps(negs)}")
    for label in ("dense_features", "no_features"):
        for row in rest["native"][label].pop("profiles"):
            log(f"profile {json.dumps(row)}")
    log(f"the rest of serving: {json.dumps(rest)}")
    for row in sharded.pop("profiles"):
        log(f"profile {json.dumps(row)}")
    log(f"the mesh and the sharded catalog: {json.dumps(sharded)}")
    for row in dp.pop("profiles"):
        log(f"profile {json.dumps(row)}")
    log(f"data-parallel training: {json.dumps(dp)}")
    for row in rows_lookup.pop("profiles"):
        log(f"profile {json.dumps(row)}")
    log(f"row-sharded lookups: {json.dumps(rows_lookup)}")
    dp_launches = dp["train"]["launches"]
    rest_launches = {name: {load: rest[load]["launches"][name]
                            for load in ("threaded_microbatch", "asyncio")}
                     for name in ("topk_flash", "dcn_cross")}
    neg_runs = ("mixed_resident", "mined", f"streamed_k{STREAM_CHUNK}", "streamed_k1")
    for row in dense.pop("profiles"):
        log(f"profile {json.dumps(row)}")
    log(f"kernel dcn_cross {json.dumps(dense['dcn_fwd'])}")
    log(f"kernel dcn_cross_bwd {json.dumps(dense['dcn_bwd'])}")
    log(f"data and features, export: {json.dumps(dense)}")
    dense_launches = dense["train_launches"]

    main_topk = next(r for r in topk_rows
                     if r["shape"] == {"Q": BATCH_USERS, "N": N_ITEMS, "d": 128, "k": RERANK})
    main_dcn = dcn_rows[-1]
    main_fwd = flash_rows[(TRAIN_BATCH, torch.bfloat16)][0]
    fp32_fwd, main_bwd = flash_rows[(TRAIN_BATCH, torch.float32)]  # the fused kernel's path
    main_bwd_plan = flash_mod.bwd_plan(TRAIN_BATCH, TRAIN_BATCH, 128, False,
                                       torch.cuda.get_device_properties(0)
                                       .multi_processor_count)._asdict()
    main_dcn_bwd = dcn_bwd_rows[-1]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    speed = ("tflops", "bound_share", "device_ms", "kernel_device_ms", "plain_device_ms")
    kernels = [
        {"name": "topk_flash", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/topk_flash.cu",
         "replaces": "recsys_tpu/ops/pallas/topk_flash.py:82",
         "launches": launches["topk_flash"], **{k: main_topk[k] for k in keys + speed},
         "select_launches": launches["topk_select"],
         "select_ms": main_topk["select_ms"], "select_device_ms": main_topk["select_device_ms"],
         "launches_train": train_launches["topk_flash"],
         "launches_dense_path": {"train": dense_launches["topk_flash"],
                                 "serve": dense["serve"]["launches"]["topk_flash"]},
         "launches_negatives_streaming": {r: negs[r]["launches"]["topk_flash"]
                                          for r in neg_runs},
         "launches_serving_rest": rest_launches["topk_flash"],
         "launches_sharded": sharded["service"]["launches"]["topk_flash"],
         "launches_data_parallel": dp_launches["topk_flash"],
         "shape": main_topk["shape"], "shapes": topk_rows},
        {"name": "dcn_cross", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/dcn_cross.cu",
         "replaces": "recsys_tpu/ops/pallas/dcn_cross.py:43",
         "launches": launches["dcn_cross"], **{k: main_dcn[k] for k in keys},
         "launches_train": train_launches["dcn_cross"],
         "launches_dense_path": {"train": dense_launches["dcn_cross"],
                                 "serve": dense["serve"]["launches"]["dcn_cross"]},
         "launches_negatives_streaming": {r: negs[r]["launches"]["dcn_cross"]
                                          for r in neg_runs},
         "launches_serving_rest": rest_launches["dcn_cross"],
         "launches_sharded": sharded["service"]["launches"]["dcn_cross"],
         "launches_data_parallel": dp_launches["dcn_cross"],
         "dense_features": dense["dcn_fwd"],
         "shape": main_dcn["shape"], "shapes": dcn_rows},
        {"name": "dcn_cross_bwd", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/dcn_cross.cu",
         "replaces": "recsys_tpu/ops/pallas/dcn_cross.py:57",
         "launches": train_launches["dcn_cross_bwd"], **{k: main_dcn_bwd[k] for k in keys},
         "kernel": "dcn_cross_bwd_kernel (dw and db in registers, all L + 2 row loads issued "
                   "together, 16-byte rows) + dcn_cross_bwd_reduce_kernel (the partials in "
                   "32 slices); dcn_cross_bwd_smem_kernel past 4 layers or 256 features",
         "new_kernel": True, "plan": main_dcn_bwd["plan"],
         **{k: main_dcn_bwd[k] for k in ("device_ms", "reduce_device_ms",
                                         "device_bound_share", "plain_device_ms")},
         "launches_fp32_epoch": fp32_launches["dcn_cross_bwd"],
         "launches_giant": giant_launches["dcn_cross_bwd"], "edges": dcn_bwd_edges,
         "launches_dense_path": dense_launches["dcn_cross_bwd"],
         "launches_negatives_streaming": {r: negs[r]["launches"]["dcn_cross_bwd"]
                                          for r in neg_runs},
         "dense_features": dense["dcn_bwd"],
         "launches_data_parallel": dp_launches["dcn_cross_bwd"],
         "shape": main_dcn_bwd["shape"], "shapes": dcn_bwd_rows},
        {"name": "flash_ce_fwd", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/flash_ce.cu",
         "replaces": "recsys_tpu/ops/pallas/flash_ce.py:114",
         "launches": train_launches["flash_ce_fwd"], **{k: main_fwd[k] for k in keys + speed},
         "kernel": "flash_ce_fwd_tc_kernel + flash_ce_fwd_combine_kernel (bf16, mma.sync); "
                   "flash_ce_fwd_kernel + the same combine kernel serve fp32 (FMA units, "
                   "128-bit register-tiled S, thread-private running (m, l), fwd_plan parts)",
         "fp32": {k: fp32_fwd[k] for k in keys + speed},
         "fp32_plan": flash_mod.fwd_plan(TRAIN_BATCH, TRAIN_BATCH, False, n_sm, 128)._asdict(),
         "fp32_edges": fp32_du_fwd_edges,
         "launches_fp32_epoch": fp32_launches["flash_ce_fwd"],
         "launches_giant": giant_launches["flash_ce_fwd"],
         "launches_dense_path": dense_launches["flash_ce_fwd"],
         "launches_negatives_streaming": {r: negs[r]["launches"]["flash_ce_fwd"]
                                          for r in neg_runs},
         "launches_data_parallel": dp_launches["flash_ce_fwd"],
         "offset_positives": dp["offset_rows"],
         "shape": main_fwd["shape"],
         "shapes": [r[0] for r in flash_rows.values()] + [twokernel["above_fwd"]]},
        {"name": "flash_ce_bwd_fused", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/flash_ce.cu",
         "replaces": "recsys_tpu/ops/pallas/flash_ce.py:250",
         "launches": fp32_launches["flash_ce_bwd_fused"],
         **{k: main_bwd[k] for k in keys + speed},
         "kernel": "flash_ce_bwd_kernel (fp32, FMA units, 128-bit register-tiled products "
                   "on bwd_plan; the bf16 route takes rows 6 + 7); flash_ce_bwd_tc_kernel "
                   "(bf16, mma.sync) is timed beside it",
         "plan": main_bwd_plan,
         "fp32_epoch_steps_per_s": fp32_trained["steps_per_s"][-1],
         "fp32_edges": fp32_edges,
         "launches_data_parallel": dp_launches["flash_ce_bwd_fused"],
         "offset_positives": dp["offset_rows"]["fp32_rows_4_5"],
         "shape": main_bwd["shape"], "shapes": [r[1] for r in flash_rows.values()]},
        {"name": "blockmax", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/blockmax.cu",
         "replaces": "recsys_tpu/ops/pallas/topk_flash.py:274",
         "launches": approx_launches["blockmax"],
         **{k: blockmax_rows[1][k] for k in keys + speed},
         "kernel": "blockmax_tc_kernel (bf16, mma.sync); blockmax_kernel serves fp32",
         "shape": blockmax_rows[1]["shape"], "shapes": blockmax_rows},
    ]
    for i, (name, line) in enumerate((("flash_ce_bwd_du", 188), ("flash_ce_bwd_dv", 218))):
        main_row = twokernel["main"][i]
        kernels.append({
            "name": name, "route": "cuda", "source": "recsys_tpu_torch/csrc/flash_ce.cu",
            "replaces": f"recsys_tpu/ops/pallas/flash_ce.py:{line}",
            "launches": giant_launches[name], **{k: main_row[k] for k in keys + speed},
            "launches_train": train_launches[name],
            "launches_dense_path": dense_launches[name],
            "launches_negatives_streaming": {r: negs[r]["launches"][name] for r in neg_runs},
            "launches_data_parallel": dp_launches[name],
            "offset_positives": dp["offset_rows"]["bf16_rows_4_6_7"],
            "fp32": {k: twokernel["main_fp32"][i][k] for k in keys + speed},
            "shape": main_row["shape"], "shapes": [main_row, twokernel["above"][i]]})
    fp32_route = twokernel["fp32_route"]
    kernels[-2].update(kernel="flash_ce_bwd_du_tc_kernel (bf16, mma.sync); "
                              "flash_ce_bwd_du_kernel serves fp32 (FMA units, 128-bit "
                              "register-tiled S and dU, du_plan parts)",
                       fp32_edges=fp32_du_fwd_edges,
                       fp32_plan=flash_mod.du_plan(TRAIN_BATCH, TRAIN_BATCH, 128, False,
                                                   n_sm)._asdict(),
                       fp32_route_shape=fp32_route["du"])
    kernels[-1].update(fp32_route_shape=fp32_route["dv"], fp32_new_kernel=True,
                       fp32_edges=fp32_dv_edges,
                       fp32_plan=flash_mod.dv_plan(TRAIN_BATCH, TRAIN_BATCH, 128, False,
                                                   n_sm)._asdict())
    # launches per step of each fp32 kernel on the two timed fp32 steps
    for entry, label in ((kernels[3], "row4_fwd"), (kernels[4], "row5_fused"),
                         (kernels[-2], "row6_du"), (kernels[-1], "row7_dv")):
        entry["fp32_launches_per_step"] = {name: r["group_launches"][label]
                                           for name, r in fp32_steps.items()}
    kernels[-1].update(kernel="flash_ce_bwd_dv_wgmma_kernel (bf16, wgmma fed by TMA, a "
                              "producer warpgroup and two consumers in ping-pong); "
                              "flash_ce_bwd_dv_kernel serves fp32 (FMA units, the fused "
                              "kernel's S/P/dV body, double-buffered query tiles, dv_plan "
                              "parts)")
    for entry in kernels:  # phase 27's loss with the lookups, phase 28's epoch
        entry["launches_rows_lookup"] = rows_lookup["loss"]["launches"][entry["name"]]
        entry["launches_debug"] = debug_modes["epoch"]["launches"][entry["name"]]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---- kernel rows against another tree's kernels, on one card ---------------

AB_TOPK_SHAPES = [(1, N_ITEMS, 10), (1, N_ITEMS, RERANK), (BATCH_USERS, N_ITEMS, 10),
                  (BATCH_USERS, N_ITEMS, RERANK), (4096, 1 << 20, 10)]
AB_FLASH_SHAPES = [(4096, "bfloat16"), (TRAIN_BATCH, "bfloat16"), (TRAIN_BATCH, "float32")]
# rows 6 (dU) and 7 (dV, dcol) and the forward (row 4): (Bq, Bk, dtype), D = 128
AB_TWOKERNEL_SHAPES = [(TRAIN_BATCH, TRAIN_BATCH, "bfloat16"), (32_768, 65_536, "bfloat16"),
                       (*ABOVE_CAP[:2], "bfloat16"), (TRAIN_BATCH, TRAIN_BATCH, "float32"),
                       (FP32_PAST_CAP_BATCH, FP32_PAST_CAP_BATCH, "float32")]
# rows 2 (the DCN forward) and 3 (its backward): (n, F), L = 3, at the
# flagship's F = 256 and at the dense-feature width
AB_DCN_FWD_ROWS = [(BATCH_USERS * RERANK, 256), (BATCH_USERS * RERANK, DENSE_F)]
AB_DCN_ROWS = [(2048, 256), (TRAIN_BATCH, 256), (TRAIN_BATCH, DENSE_F)]
# row 8: (Q, N), bf16, d = 128, groups of 512
AB_BLOCKMAX_SHAPES = [(1, LARGE_N_ITEMS), (BATCH_USERS, LARGE_N_ITEMS), (BIG_Q, BIG_N)]


def _timed(fn, iters: int, kernel: str, warmup: int = 2) -> dict:
    """CUDA-event ms, and device ms per call (whole call / the kernels
    whose name holds ``kernel``) in a fresh profiler window."""
    dev, dev_kernel = device_ms(fn, iters, kernel=kernel)
    return {"ms": time_ms(fn, iters, warmup), "device_ms": dev, "kernel_device_ms": dev_kernel}


def time_kernels(tree: str) -> dict:
    """Rows 1 to 8 of the port found under ``tree`` (its own
    ``recsys_tpu_torch``, built into its own ``build/``) at the shapes of
    the ``AB_*`` lists on seeded inputs: CUDA-event ms and device ms per
    call, through the same wrappers a caller uses; beside rows 4 to 8
    their library yardsticks where the dense scores fit (``matmul`` +
    ``logsumexp``, the dense softmax backward, ``softmax @ v``,
    ``softmax.T @ u`` with the column sums, ``matmul`` + ``amax``), which
    do not depend on the tree; row 3 with the device ms of its partials'
    reduction apart; then :func:`time_main_path` through the tree's
    service and trainer."""
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from recsys_tpu_torch.ops import _build, dcn_cross as D, flash_ce as F, topk_flash as T

    check(os.path.abspath(T.__file__).startswith(os.path.abspath(tree)), "wrong tree imported")
    _build.load_library()
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    unit = lambda *shape: torch.nn.functional.normalize(
        torch.randn(shape, generator=g, device="cuda"), dim=1)
    out = {"tree": tree, "topk": [], "flash_bwd": [], "flash_fwd": [], "flash_fwd_row4": [],
           "row6_du": [], "row7_dv": [], "row8_blockmax": [], "row2_dcn_fwd": [],
           "row3_dcn_bwd": []}
    for q_n, n, k in AB_TOPK_SHAPES:
        u, v = unit(q_n, 128), unit(n, 128)
        iters = 3 if q_n * n > 1 << 26 else 50
        fn = lambda: T.flash_topk(u, v, k, normalize=False)
        out["topk"].append({"Q": q_n, "N": n, "k": k, "ms": time_ms(fn, iters),
                            "device_ms": device_ms(fn, iters)[0]})
        del u, v
    for b, dt in AB_FLASH_SHAPES:
        d = 128
        u = (torch.randn((b, d), generator=g, device="cuda") * d ** -0.5).to(getattr(torch, dt))
        v = (torch.randn((b, d), generator=g, device="cuda") * d ** -0.5).to(getattr(torch, dt))
        c = torch.randn((b,), generator=g, device="cuda")
        ids = torch.randint(0, N_ITEMS, (b,), generator=g, device="cuda", dtype=torch.int32)
        pos = torch.arange(b, device="cuda", dtype=torch.int32)
        gr = torch.rand((b,), generator=g, device="cuda") / b
        lse, _ = F.flash_ce_fwd(u, v, c, ids, ids, pos)
        fn = lambda: F.flash_ce_bwd_fused(u, v, c, ids, ids, pos, lse, gr)
        out["flash_bwd"].append({"B": b, "dtype": dt, **_timed(fn, 10, "flash_ce_bwd_"),
                                 "library_ms": time_ms(
                                     lambda: _dense_softmax_bwd(u, v, c, gr), 10)})
        fwd = lambda: F.flash_ce_fwd(u, v, c, ids, ids, pos)
        out["flash_fwd"].append({"B": b, "dtype": dt, **_timed(fwd, 10, "flash_ce_fwd_"),
                                 "library_ms": time_ms(
                                     lambda: torch.logsumexp(torch.matmul(u, v.T) + c, dim=1),
                                     10)})
    for bq, bk, dt in AB_TWOKERNEL_SHAPES:
        u, v, c, ids_q, ids_k, pos, gr = _flash_args(bq, bk, 128, getattr(torch, dt), SEED + 21,
                                                     n_ids=max(2, bk // 3))
        lse, _ = F.flash_ce_fwd(u, v, c, ids_q, ids_k, pos)
        args = (u, v, c, ids_q, ids_k, pos, lse, gr)
        iters = 10 if bq * bk <= TRAIN_BATCH ** 2 else 3
        shape = {"Bq": bq, "Bk": bk, "D": 128, "dtype": dt}
        out["flash_fwd_row4"].append({**shape, **_timed(
            lambda: F.flash_ce_fwd(u, v, c, ids_q, ids_k, pos), iters, "flash_ce_fwd_")})
        row6 = {**shape, **_timed(lambda: F.flash_ce_bwd_du(*args), iters, "flash_ce_bwd_du_")}
        if bq * bk <= TRAIN_BATCH ** 2:
            row6["library_ms"] = time_ms(lambda: (torch.softmax(torch.matmul(u, v.T) + c, dim=1)
                                                  * gr[:, None]).to(u.dtype) @ v, iters)
        out["row6_du"].append(row6)
        row7 = {**shape, **_timed(lambda: F.flash_ce_bwd_dv(*args), iters, "flash_ce_bwd_dv_")}
        if bq * bk <= TRAIN_BATCH ** 2:
            out["flash_fwd_row4"][-1]["library_ms"] = time_ms(
                lambda: torch.logsumexp(torch.matmul(u, v.T) + c, dim=1), iters)

            def row7_library():
                p = torch.softmax(torch.matmul(u, v.T) + c, dim=1) * gr[:, None]
                return p.to(u.dtype).T @ u, p.sum(dim=0)

            row7["library_ms"] = time_ms(row7_library, iters)
        out["row7_dv"].append(row7)
        del u, v, args
        torch.cuda.empty_cache()
    n_layers = 3
    for n, f in AB_DCN_FWD_ROWS:
        x0 = torch.randn((n, f), generator=g, device="cuda")
        w = torch.randn((n_layers, f), generator=g, device="cuda") * f ** -0.5
        b = torch.randn((n_layers, f), generator=g, device="cuda") * 0.1
        timed = _timed(lambda: D.dcn_cross(x0, w, b), 50, "dcn_cross_fwd")
        out["row2_dcn_fwd"].append({"n": n, "F": f, "L": n_layers, **timed})
    for n, f in AB_DCN_ROWS:
        x0 = torch.randn((n, f), generator=g, device="cuda")
        w = torch.randn((n_layers, f), generator=g, device="cuda") * f ** -0.5
        b = torch.randn((n_layers, f), generator=g, device="cuda") * 0.1
        gr = torch.randn((n, f), generator=g, device="cuda")
        _, resid = D._forward(x0, w, b, keep_resid=True)
        timed = _timed(lambda: D.dcn_cross_bwd(x0, w, resid, gr), 50, "dcn_cross_bwd_reduce")
        timed["reduce_device_ms"] = timed.pop("kernel_device_ms")
        out["row3_dcn_bwd"].append({"n": n, "F": f, "L": n_layers, **timed})
    for q_n, n in AB_BLOCKMAX_SHAPES:
        u, v = unit(q_n, 128).to(torch.bfloat16), unit(n, 128).to(torch.bfloat16)
        grp = T.blockmax_group_size(n)
        big = q_n * n > 1 << 28
        iters = 2 if big else 20
        row = {"Q": q_n, "N": n, "d": 128, "g": grp,
               **_timed(lambda: T.blockmax_group_max(u, v, grp), iters, "blockmax",
                        warmup=1 if big else 2)}
        if not big:  # at 4,096 x 8M the scores would be a 137 GB matrix
            uf, vf = u.float(), v.float()
            row["library_ms"] = time_ms(
                lambda: torch.matmul(uf, vf.T).view(q_n, -1, grp).amax(dim=2), iters)
            del uf, vf
        out["row8_blockmax"].append(row)
        del u, v
        torch.cuda.empty_cache()
    out["e2e"] = time_main_path()
    return out


def time_main_path() -> list:
    """The served requests of phase 7 (a full-width random bundle from
    ``SEED``, rerank 200) and the B = 8,192 flash train step of phase 11,
    through the service and trainer of the package on ``sys.path``,
    profiled by :func:`profile_call`: wall p50 / p90, device ms, launches
    and busy share."""
    import numpy as np
    import torch
    from recsys_tpu_torch.config import ModelConfig, RecsysConfig, TrainConfig
    from recsys_tpu_torch.models.losses import balanced_class_weights
    from recsys_tpu_torch.models.multitask import MultiTaskModel
    from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
    from recsys_tpu_torch.serve.service import RecommendationService
    from recsys_tpu_torch.train.checkpoint import save_inference_bundle
    from recsys_tpu_torch.train.trainer import Trainer

    cfg = RecsysConfig(model=ModelConfig(dropout_rate=0.0))
    params = MultiTaskModel.init(torch.Generator().manual_seed(SEED), cfg.model, N_USERS,
                                 N_ITEMS, "cuda")
    raw_items = np.arange(1, N_ITEMS + 1)
    index = RetrievalIndex.build(params["towers"], cfg.model, N_ITEMS, raw_items,
                                 device="cuda")
    with tempfile.TemporaryDirectory() as d:
        save_inference_bundle(d, params["towers"], cfg, np.arange(1, N_USERS + 1), raw_items,
                              index=index, full_params=params)
        svc = RecommendationService(d, rerank_candidates=RERANK, device="cuda").load()
        batch = [int(u) for u in np.arange(1, N_USERS + 1, N_USERS // BATCH_USERS)]
        rows = profile_requests(svc, batch[:BATCH_USERS])
    bundle = synthetic_bundle(SEED)
    batches = _batches(bundle, 2, TRAIN_BATCH, "cuda", _log_q(bundle))
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(RecsysConfig(model=ModelConfig(use_flash_ce=True),
                                  train=TrainConfig(batch_size=TRAIN_BATCH)), d, device="cuda")
        holder = [tr.init_state(N_USERS, N_ITEMS, SEED)]
        step = tr.make_train_step(balanced_class_weights(bundle["train/y_implicit"]))

        def one():
            holder[0], _ = step(holder[0], batches[holder[0].step % 2])

        rows.append(profile_call(f"train_step_B{TRAIN_BATCH}_flash", one, n_wall=20,
                                 n_traced=5, warmup=2))
    keys = ("profile", "wall_ms_p50", "wall_ms_p90", "device_ms", "device_launches",
            "device_busy_share")
    return [{k: r[k] for k in keys} for r in rows]


def ab(parent: str) -> int:
    """Rows 1 to 8 of ``parent`` (an unpacked checkout of another commit)
    and of this tree, and their served requests and train step
    (:func:`time_main_path`), timed in turns on one card (parent, this,
    this, parent), each in a process of its own: prints one JSON line per
    run and the card's line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for tree in (parent, here, here, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-kernels", tree],
                              cwd=tree, capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"--time-kernels {tree}: rc {proc.returncode}\n"
                                    f"{proc.stderr[-4000:]}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--time-kernels":
        print(json.dumps(time_kernels(sys.argv[2])), flush=True)
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--dlrm-bags":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps(dlrm_bags_phase(os.path.dirname(os.path.abspath(__file__)), tmp)),
                  flush=True)
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        sys.exit(ab(os.path.abspath(sys.argv[2])))
    sys.exit(main())
