"""The port's single-card scale training path against the JAX package, on
the CPU: the two-kernel flash backward (kernel rows 6 and 7, plain
versions) and the route that picks it, the sparse table updates, the
sparse train step, the CBNS negative cache, and ``Trainer.train`` with
both.

Tolerances:
* rows 6 and 7 against JAX ``_flash_bwd_twokernel_raw`` in interpret
  mode: each output within 1e-5 of its own max|ref| (fp32 sums in another
  order; bf16 products are exact in fp32 and both round ``p*g`` to bf16 at
  the same point), plus one bf16 ulp (2**-8) on dU and dV of bf16
  operands, where a ``p*g`` one fp32 bit apart may round to the other
  bf16 neighbour;
* row 7's partial layout (parts of the query axis) summed: 1e-6 of
  max|ref| against the one-pass plain dV and dcol (the same sums, split at
  part boundaries), and the tolerance above against JAX;
* the plain versions chunked over query rows against one chunk: 1e-6 of
  max on the forward (the same sums per row), 1e-5 on dU, dV and dcol
  (dV and dcol summed over the chunks in another order);
* ``FlashSoftmaxCE`` on the two-kernel route against ``jax.grad``: rtol =
  atol = 1e-5 on the value and the gradients (plus one bf16 ulp on u and
  v of bf16 operands, which both packages round to bf16);
* sparse optimizer functions: combined rows to 1e-6 (duplicates summed in
  another order), updated rows to rtol = atol = 1e-6;
* sparse steps against JAX over 3 steps (fp32, dropout 0): losses to rtol
  = 1e-5, slots and the cache to atol = 1e-5, params to atol = 1e-5 under
  adagrad and 2e-4 (1% of the learning rate) under adam, whose normalised
  step m / sqrt(v) turns a gradient element that cancels to near zero,
  and so differs in relative terms when summed in another order, into a
  move of up to the learning rate;
* port sparse adagrad against port dense adagrad: losses to rtol = 1e-6,
  params to atol = 1e-6 (the same arithmetic but for the order in which
  duplicate rows and the clipping norm are summed);
* ``Trainer.train`` against the JAX ``Trainer`` (the same init and batch
  order): per-epoch train and val losses to rtol = 1e-4 over 2 epochs of
  50 steps.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.config import EvalConfig as JaxEvalConfig
from recsys_tpu.config import ModelConfig as JaxModelConfig
from recsys_tpu.config import RecsysConfig as JaxRecsysConfig
from recsys_tpu.config import TrainConfig as JaxTrainConfig
from recsys_tpu.ops.pallas import flash_ce as JF
from recsys_tpu.parallel.mesh import make_mesh
from recsys_tpu.train import optimizer as jopt
from recsys_tpu.train.trainer import Trainer as JaxTrainer
from recsys_tpu_torch.config import EvalConfig, ModelConfig, RecsysConfig, TrainConfig
from recsys_tpu_torch.ops import flash_ce as F
from recsys_tpu_torch.train import __main__ as cli
from recsys_tpu_torch.train import optimizer as topt
from recsys_tpu_torch.train.checkpoint import params_from_numpy, params_to_numpy
from recsys_tpu_torch.train.optimizer import leaves_with_paths
from recsys_tpu_torch.train.trainer import Trainer

BF16_ULP = 2.0 ** -8
N_USERS, N_ITEMS, B = 40, 30, 64
MODEL_KW = dict(embedding_dim=16, user_tower_dims=(32,), item_tower_dims=(32,),
                cross_layers=1, dnn_dims=(16,), dropout_rate=0.0, mixed_precision=False)


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, (err, tol)


def _flash_inputs(bq, bk, d, seed):
    """Inputs of one backward, many accidental hits, positives in the
    first Bq columns; ``lse`` is the forward's."""
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((bq, d)) * d ** -0.5).astype(np.float32)
    v = rng.standard_normal((bk, d)).astype(np.float32)
    c = rng.standard_normal(bk).astype(np.float32)
    ids_k = rng.integers(0, max(2, bk // 3), bk).astype(np.int32)
    ids_q = ids_k[:bq].copy()
    pos = np.arange(bq, dtype=np.int32)
    g = rng.standard_normal(bq).astype(np.float32)
    return u, v, c, ids_q, ids_k, pos, g


# ---- kernel rows 6 and 7 -------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bq,bk", [(64, 64), (64, 192)])
def test_twokernel_plain_versions_match_jax_interpret(dtype, bq, bk):
    u, v, c, ids_q, ids_k, pos, g = _flash_inputs(bq, bk, 32, seed=bq + bk)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tu, tv = torch.tensor(u).to(tdt), torch.tensor(v).to(tdt)
    small = (torch.tensor(c), torch.tensor(ids_q), torch.tensor(ids_k), torch.tensor(pos))
    lse, _ = F.flash_ce_fwd_reference(tu, tv, *small)
    want = JF._flash_bwd_twokernel_raw(
        jnp.asarray(u).astype(jdt), jnp.asarray(v).astype(jdt), jnp.asarray(c),
        jnp.asarray(ids_q), jnp.asarray(ids_k), jnp.asarray(pos), jnp.asarray(lse.numpy()),
        jnp.asarray(g), True)
    args = (tu, tv, *small, lse, torch.tensor(g))
    before = (F.flash_ce_bwd_du.launches, F.flash_ce_bwd_dv.launches)
    du = F.flash_ce_bwd_du(*args)
    dv, dcol = F.flash_ce_bwd_dv(*args)
    ulp = BF16_ULP if dtype == "bfloat16" else 0.0
    _rel_close(du, want[0], 1e-5 + ulp)
    _rel_close(dv, want[1], 1e-5 + ulp)
    _rel_close(dcol, want[2], 1e-5)
    # the wrappers take the plain versions for CPU tensors and count nothing
    assert torch.equal(du, F.flash_ce_bwd_du_reference(*args))
    assert (F.flash_ce_bwd_du.launches, F.flash_ce_bwd_dv.launches) == before
    # the two routes agree: dV and dcol sum the same terms, dU too
    fused = F.flash_ce_bwd_fused(*args)
    for a, b in zip(F.flash_ce_bwd_twokernel(*args), fused):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk_rows", [1, 7, 64])
def test_plain_versions_chunked_over_query_rows(chunk_rows, monkeypatch):
    """The plain versions form the logits a chunk of query rows at a time
    (~1 GiB, so they run at 131,072 x 262,144 on the card); any chunking
    gives the one-chunk result: lse, the positive logit and dU row by row,
    dV and dcol summed over the chunks, each within 1e-5 of its max."""
    bq, bk = 64, 192
    u, v, c, ids_q, ids_k, pos, g = (torch.tensor(x) for x in _flash_inputs(bq, bk, 32, 5))
    u, v = u.to(torch.bfloat16), v.to(torch.bfloat16)
    small = (c, ids_q, ids_k, pos)
    whole_fwd = F.flash_ce_fwd_reference(u, v, *small)
    args = (u, v, *small, whole_fwd[0], g)
    whole = (F.flash_ce_bwd_du_reference(*args), *F.flash_ce_bwd_dv_reference(*args),
             *F.flash_ce_bwd_reference(*args))
    monkeypatch.setattr(F, "_REF_CHUNK_BYTES", 4 * bk * chunk_rows)
    assert len(list(F._row_chunks(bq, bk))) == -(-bq // chunk_rows)
    for got, want in zip(F.flash_ce_fwd_reference(u, v, *small), whole_fwd):
        _rel_close(got, want, 1e-6)
    got = (F.flash_ce_bwd_du_reference(*args), *F.flash_ce_bwd_dv_reference(*args),
           *F.flash_ce_bwd_reference(*args))
    for a, b in zip(got, whole):
        _rel_close(a, b, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bq,bk", [(64, 64), (64, 192)])
def test_flash_softmax_ce_on_the_twokernel_route_matches_jax(dtype, bq, bk, monkeypatch):
    """Both caps lowered below these shapes' partials: JAX takes its
    two-kernel backward, the port its H100 route (picked by the operand
    type, which the cap does not move: rows 6 and 7 for bf16 operands, the
    fused kernel for fp32 ones); value and gradients w.r.t. u, v, colcorr
    agree."""
    monkeypatch.setattr(F, "_FUSED_BWD_PARTIALS_CAP", 1024)
    monkeypatch.setattr(JF, "_FUSED_BWD_PARTIALS_CAP", 1024)
    route = "twokernel" if dtype == "bfloat16" else "fused"
    u, v, c, ids_q, ids_k, pos, g = _flash_inputs(bq, bk, 16, seed=3 * bq + bk)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_fn(a, b, cc):
        ce = JF.flash_softmax_ce(a.astype(jdt), b.astype(jdt), cc, jnp.asarray(ids_q),
                                 jnp.asarray(ids_k), jnp.asarray(pos))
        return jnp.sum(ce * g)

    jval, jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1, 2))(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(c))
    tu, tv, tc = (torch.tensor(x, requires_grad=True) for x in (u, v, c))
    calls = []
    monkeypatch.setattr(F, "flash_ce_bwd_du", lambda *a: calls.append("twokernel") or
                        F.flash_ce_bwd_du_reference(*a))
    monkeypatch.setattr(F, "flash_ce_bwd_fused", lambda *a: calls.append("fused") or
                        F.flash_ce_bwd_reference(*a))
    ce = F.flash_softmax_ce(tu.to(tdt), tv.to(tdt), tc, torch.tensor(ids_q),
                            torch.tensor(ids_k), torch.tensor(pos))
    total = (ce * torch.tensor(g)).sum()
    total.backward()
    assert calls == [route]  # the backward went through the port's route
    np.testing.assert_allclose(total.item(), float(jval), rtol=1e-5, atol=1e-5)
    ulp = BF16_ULP if dtype == "bfloat16" else 0.0
    for got, want, extra in ((tu.grad, jgrads[0], ulp), (tv.grad, jgrads[1], ulp),
                             (tc.grad, jgrads[2], 0.0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=1e-5 + extra, atol=1e-5)


@pytest.mark.parametrize("bq,bk", [(8192, 8192), (20000, 20000), (24000, 24000),
                                   (139264, 139264), (131072, 147456), (131072, 262144),
                                   (65536, 327680)])
def test_bwd_route_counts_the_partials_as_the_tpu_does(bq, bk):
    """The port's count of the TPU's partials against JAX ``_tiles``: ``Bk
    // tk`` partials with the TPU's own tile, not ceil(Bk / 2,048) (at
    20,000 the TPU's tk is 32 and its partials are 5.96 GiB)."""
    d = 128
    tq, tk = JF._tiles(bq, bk)
    assert F._tiles(bq, bk) == (tq, tk)
    want = bq * d * (bk // tk) * 4
    assert F.fused_bwd_partials_bytes(bq, bk, d) == want


_DU_PLAN_CASES = [
    # the wgmma kernel, one block per SM: 128-row query blocks,
    # 128-candidate tiles
    (8192, 8192, 128, 2),          # 64 blocks: one wave of 2 parts of 32 tiles
    (131072, 262144, 128, 1),      # the giant step: 1,024 blocks, 7.76 waves, no partials
    (8192, 8192, 256, 1),          # DP = 256: two column slices, 128 blocks in one wave
    (20000, 20000, 128, 5),        # 157 blocks: 6 waves of 32 tiles
    (1000, 3001, 129, 8),          # ragged, two column slices: 16 blocks, 8 parts of 3 tiles
    (1000, 3001, 64, 12),          # 8 blocks: a part per 2 candidate tiles
    (64, 10, 32, 1),               # one candidate tile
    (300, 1100, 256, 9),           # DP = 256: 6 blocks, a part per candidate tile
    (65, 1, 128, 1),               # a single candidate
]


@pytest.mark.parametrize("bq,bk,d,parts", _DU_PLAN_CASES, ids=[
    f"{bq}-{bk}-{d}-{parts}" for bq, bk, d, parts in _DU_PLAN_CASES])
def test_du_plan_fills_the_card_under_the_cap(bq, bk, d, parts):
    """Row 6's tiling, checked on the CPU: every candidate tile in exactly
    one part, and the dU partials under the cap: 128-row query blocks (two
    column slices past D = 128) and 128-candidate tiles, one block per SM:
    one part where the blocks alone fill ``_FULL_WAVES`` waves, else the
    split whose last wave ends first, a block's set-up and write-out
    counted as ``_BLOCK_TILES`` of its tiles, so never later than one
    part."""
    n_sm = 132
    p = F.du_plan(bq, bk, d, n_sm)
    assert (p.tile, p.ktile, p.parts) == (F.WG_OWN, F.WG_TILE, parts)
    n_kt = -(-bk // p.ktile)
    assert p.parts * p.tiles_per_part >= n_kt > (p.parts - 1) * p.tiles_per_part
    assert p.partials_bytes(bq, d) <= F._FUSED_BWD_PARTIALS_CAP
    q_blocks = -(-bq // p.tile) * (2 if d > 128 else 1)

    def ends(n_parts: int, per_part: int) -> int:
        return -(-q_blocks * n_parts // n_sm) * (per_part + F._BLOCK_TILES)

    assert ends(p.parts, p.tiles_per_part) <= ends(1, n_kt)
    if q_blocks >= F._FULL_WAVES * n_sm:
        assert p.parts == 1


@pytest.mark.parametrize("room,parts,tiles_per_part", [(2, 2, 79), (1, 1, 157)])
def test_du_plan_keeps_the_partials_under_a_lowered_cap(room, parts, tiles_per_part,
                                                        monkeypatch):
    """With room for only two dU partials the plan takes two parts, each
    sweeping half the candidate tiles, where the card alone would take 5
    (20,000^2); with room for one, one part, which writes dU itself."""
    bq, bk, d = 20000, 20000, 128
    assert F.du_plan(bq, bk, d, 132).parts == 5
    monkeypatch.setattr(F, "_FUSED_BWD_PARTIALS_CAP", room * 4 * bq * d)
    p = F.du_plan(bq, bk, d, 132)
    assert (p.parts, p.tiles_per_part) == (parts, tiles_per_part)
    assert p.partials_bytes(bq, d) <= F._FUSED_BWD_PARTIALS_CAP
    assert (p.partials_bytes(bq, d) == 0) == (parts == 1)


_DV_PLAN_CASES = [
    # the wgmma kernel, one block per SM: 128-candidate blocks, 128-row
    # query tiles
    (8192, 8192, 128, 2),          # 64 blocks: one wave of 2 parts of 32 tiles
    (8192, 8192, 120, 2),          # D = 120, staged as 128: the same plan
    (8192, 8192, 256, 1),          # DP = 256: two column slices, 128 blocks in one wave
    (131072, 262144, 128, 1),      # the giant step: 2,048 blocks, 16 waves, no partials
    (20000, 20000, 128, 5),        # 157 blocks: 6 waves of 32 tiles
    (1000, 3001, 129, 2),          # ragged, two column slices: 48 blocks, 2 parts
    (1000, 3001, 64, 4),           # 24 blocks: a part per 2 query tiles
    (64, 10, 32, 1),               # one query tile
    (300, 1100, 256, 3),           # DP = 256: 18 blocks, a part per query tile
    (65, 1, 128, 1),               # a single candidate: one block, one query tile
]


@pytest.mark.parametrize("bq,bk,d,parts", _DV_PLAN_CASES, ids=[
    f"{bq}-{bk}-{d}-{parts}" for bq, bk, d, parts in _DV_PLAN_CASES])
def test_dv_plan_fills_the_card_under_the_cap(bq, bk, d, parts):
    """Row 7's tiling, checked on the CPU: every query tile in exactly one
    part, and the dV and dcol partials under the cap: 128-candidate blocks
    and 128-row query tiles, one block per SM: one part where the blocks
    alone fill ``_FULL_WAVES`` waves, else the split whose last wave ends
    first, a block's set-up and write-out counted as ``_BLOCK_TILES`` of
    its tiles, so never later than one part."""
    n_sm = 132
    p = F.dv_plan(bq, bk, d, n_sm)
    assert (p.tile, p.qtile, p.parts) == (F.WG_OWN, F.WG_TILE, parts)
    n_qt = -(-bq // p.qtile)
    assert p.parts * p.q_tiles_per_part >= n_qt > (p.parts - 1) * p.q_tiles_per_part
    assert p.partials_bytes(bk, d) <= F._FUSED_BWD_PARTIALS_CAP
    k_blocks = -(-bk // p.tile) * (2 if d > 128 else 1)

    def ends(n_parts: int, per_part: int) -> int:
        return -(-k_blocks * n_parts // n_sm) * (per_part + F._BLOCK_TILES)

    assert ends(p.parts, p.q_tiles_per_part) <= ends(1, n_qt)
    if k_blocks >= F._FULL_WAVES * n_sm:
        assert p.parts == 1


@pytest.mark.parametrize("room,parts,q_tiles_per_part", [(2, 2, 79), (1, 1, 157)])
def test_dv_plan_keeps_the_partials_under_a_lowered_cap(room, parts, q_tiles_per_part,
                                                        monkeypatch):
    """With room for only two parts of dV and dcol the plan takes two
    parts, each sweeping half the query tiles, where the card alone would
    take 5 (20,000^2); with room for one, one part, which writes dV and
    dcol itself."""
    bq, bk, d = 20000, 20000, 128
    assert F.dv_plan(bq, bk, d, 132).parts == 5
    monkeypatch.setattr(F, "_FUSED_BWD_PARTIALS_CAP", room * 4 * bk * (d + 1))
    p = F.dv_plan(bq, bk, d, 132)
    assert (p.parts, p.q_tiles_per_part) == (parts, q_tiles_per_part)
    assert p.partials_bytes(bk, d) <= F._FUSED_BWD_PARTIALS_CAP
    assert (p.partials_bytes(bk, d) == 0) == (parts == 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bq,bk,d,n_sm,all_accidental,parts", [
    (192, 64, 32, 132, False, 2),    # two parts of one query tile, the last of 64 rows
    (600, 1024, 32, 16, True, 2),    # two parts of 3 and 2 query tiles
    (257, 1, 16, 132, False, 3),     # one candidate, three parts, the last of 1 row
    (130, 300, 129, 132, True, 2),   # two parts, the last of 2 rows; D past 128
    (192, 300, 32, 132, False, 2),   # 3 blocks: two parts, the last of 64 rows
    (320, 1024, 32, 132, True, 3),   # 8 blocks: three parts, the last of 64 rows
    (130, 300, 129, 132, False, 2),  # D past 128, random accidental hits only
    (200, 190, 24, 132, False, 2),   # ragged: two parts, the last of 72 rows
    (1000, 700, 48, 4, True, 2),     # 6 blocks on 4 SMs: 2 parts of 4 query tiles
])
def test_dv_partials_sum_to_the_reference_and_jax(dtype, bq, bk, d, n_sm, all_accidental,
                                                  parts):
    """The plain version of row 7's partials under ``dv_plan`` ([parts, Bk,
    D] dV, [parts, Bk] dcol), summed over the parts, equals the one-pass
    plain dV and dcol (1e-6 of max|ref|) and JAX
    ``_flash_bwd_twokernel_raw`` in interpret mode, in both operand types;
    row 0's positive lies in the last column, and with ``all_accidental``
    every third row's every candidate but its positive is an accidental
    hit."""
    rng = np.random.default_rng(bq + bk + d)
    u = (rng.standard_normal((bq, d)) * d ** -0.5).astype(np.float32)
    v = rng.standard_normal((bk, d)).astype(np.float32)
    c = rng.standard_normal(bk).astype(np.float32)
    ids_k = rng.integers(0, max(2, bk // 3), bk).astype(np.int32)
    ids_q = rng.integers(0, max(2, bk // 3), bq).astype(np.int32)
    pos = np.arange(bq, dtype=np.int32) % bk
    pos[0] = bk - 1
    if all_accidental:
        ids_k[:] = bk
        ids_q[::3] = bk
    g = rng.standard_normal(bq).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tu, tv = torch.tensor(u).to(tdt), torch.tensor(v).to(tdt)
    small = (torch.tensor(c), torch.tensor(ids_q), torch.tensor(ids_k), torch.tensor(pos))
    lse, _ = F.flash_ce_fwd_reference(tu, tv, *small)
    args = (tu, tv, *small, lse, torch.tensor(g))
    p = F.dv_plan(bq, bk, d, n_sm)
    assert p.parts == parts
    dv_part, dcol_part = F.flash_ce_bwd_dv_partials_reference(*args, p)
    assert dv_part.shape == (p.parts, bk, d) and dcol_part.shape == (p.parts, bk)
    got = (dv_part.sum(dim=0), dcol_part.sum(dim=0))
    for a, b in zip(got, F.flash_ce_bwd_dv_reference(*args)):
        _rel_close(a, b, 1e-6)
    want = JF._flash_bwd_twokernel_raw(
        jnp.asarray(u).astype(jdt), jnp.asarray(v).astype(jdt), jnp.asarray(c),
        jnp.asarray(ids_q), jnp.asarray(ids_k), jnp.asarray(pos), jnp.asarray(lse.numpy()),
        jnp.asarray(g), True)
    _rel_close(got[0], want[1], 1e-5 + (BF16_ULP if dtype == "bfloat16" else 0.0))
    _rel_close(got[1], want[2], 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bq,bk,d,n_sm,all_accidental,parts,n_cols", [
    (192, 300, 32, 132, False, 3, 384),    # 2 blocks: 3 parts of one tile, the last of 44
    (600, 1024, 64, 16, True, 3, 1152),    # 5 blocks on 16 SMs: 3 parts of 3, 3 and 2 tiles
    (130, 300, 129, 132, True, 3, 384),    # D past 128: 3 parts, two column slices
    (257, 1000, 256, 132, False, 8, 1024),  # DP = 256: 8 parts, the last of 104 candidates
    (192, 300, 32, 132, True, 3, 384),     # 2 blocks, every third row accidental
    (320, 1024, 32, 4, True, 1, 1024),     # 3 blocks on 4 SMs: one part, no padding
    (130, 300, 129, 132, False, 3, 384),   # D past 128, random accidental hits only
    (200, 190, 24, 132, False, 2, 256),    # ragged: 2 parts, the last of 62 candidates
])
def test_du_partials_sum_to_the_reference_and_jax(dtype, bq, bk, d, n_sm, all_accidental,
                                                  parts, n_cols):
    """The plain version of row 6's partials under ``du_plan`` ([parts, Bq,
    D], over the candidates padded to the plan's whole tiles as the kernel
    reads them, ``n_cols`` of them), summed over the parts, equals the
    one-pass plain dU (1e-6 of max|ref|) and JAX
    ``_flash_bwd_twokernel_raw`` in interpret mode, in both operand types;
    row 0's positive lies in the last column, and with ``all_accidental``
    every third row's every candidate but its positive is an accidental
    hit."""
    rng = np.random.default_rng(bq + bk + d)
    u = (rng.standard_normal((bq, d)) * d ** -0.5).astype(np.float32)
    v = rng.standard_normal((bk, d)).astype(np.float32)
    c = rng.standard_normal(bk).astype(np.float32)
    ids_k = rng.integers(0, max(2, bk // 3), bk).astype(np.int32)
    ids_q = rng.integers(0, max(2, bk // 3), bq).astype(np.int32)
    pos = np.arange(bq, dtype=np.int32) % bk
    pos[0] = bk - 1
    if all_accidental:
        ids_k[:] = 0  # the id of the padded columns too
        ids_q[::3] = 0
    g = rng.standard_normal(bq).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tu, tv = torch.tensor(u).to(tdt), torch.tensor(v).to(tdt)
    small = (torch.tensor(c), torch.tensor(ids_q), torch.tensor(ids_k), torch.tensor(pos))
    lse, _ = F.flash_ce_fwd_reference(tu, tv, *small)
    args = (tu, tv, *small, lse, torch.tensor(g))
    p = F.du_plan(bq, bk, d, n_sm)
    assert (p.parts, p.parts * p.tiles_per_part * p.ktile) == (parts, n_cols)
    du_part = F.flash_ce_bwd_du_partials_reference(*args, p)
    assert du_part.shape == (p.parts, bq, d) and bool(torch.isfinite(du_part).all())
    got = torch.sum(du_part, dim=0)
    _rel_close(got, F.flash_ce_bwd_du_reference(*args), 1e-6)
    want = JF._flash_bwd_twokernel_raw(
        jnp.asarray(u).astype(jdt), jnp.asarray(v).astype(jdt), jnp.asarray(c),
        jnp.asarray(ids_q), jnp.asarray(ids_k), jnp.asarray(pos), jnp.asarray(lse.numpy()),
        jnp.asarray(g), True)
    _rel_close(got, want[0], 1e-5 + (BF16_ULP if dtype == "bfloat16" else 0.0))


@pytest.mark.parametrize("id_hit", [False, True])
def test_du_cols_give_no_probability_past_bk(id_hit):
    """Row 6's column inputs (the plain version of its cols kernel):
    (colcorr, the bits of ids_k) per candidate, (-inf, 0) past Bk. A padded
    column's logit is -inf, or -1e9 where the row's id is 0, and its p*g is
    exactly 0 with no NaN, also for a row past Bq (lse +inf, g 0) and a row
    whose lse is far below 0."""
    colcorr = torch.tensor([0.5, -2.0, 3.0])
    ids_k = torch.tensor([7, -1, 2**31 - 1], dtype=torch.int32)
    cols = F.du_cols_reference(colcorr, ids_k, 8)
    assert cols.shape == (8, 2) and cols.dtype == torch.float32
    assert torch.equal(cols[:3, 0], colcorr)
    assert torch.equal(cols[:3, 1].view(torch.int32), ids_k)
    assert bool(torch.isneginf(cols[3:, 0]).all())
    assert bool((cols[3:, 1].view(torch.int32) == 0).all())
    # u . v = 0 on the zero rows past Bk, never a row's positive (< Bk);
    # rows: lse 1, lse -200, past Bq
    id_q = torch.tensor([0 if id_hit else 5] * 3, dtype=torch.int32)
    s = F._masked_logits(torch.ones((3, 4)), torch.zeros((5, 4)), cols[3:, 0], id_q,
                         cols[3:, 1].view(torch.int32), torch.full((3,), 99, dtype=torch.int32))
    assert bool((s == (F.NEG_BIG if id_hit else float("-inf"))).all())
    lse = torch.tensor([1.0, -200.0, float("inf")])
    g = torch.tensor([1.0, 3.0, 0.0])
    pg = torch.exp(s - lse[:, None]) * g[:, None]
    assert torch.equal(pg, torch.zeros_like(pg))


# ---- sparse optimizer functions ------------------------------------------

def _dup_ids(rng, b, n):
    ids = rng.integers(0, n, b).astype(np.int32)
    ids[: b // 4] = ids[b // 4: b // 2]  # many duplicates
    return ids


@pytest.mark.parametrize("shape", [(24,), (24, 5)])
def test_combine_duplicate_rows_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    ids = _dup_ids(rng, shape[0], 10)
    grads = rng.standard_normal(shape).astype(np.float32)
    js, jc, jv = (np.asarray(x) for x in jopt.combine_duplicate_rows(jnp.asarray(ids),
                                                                      jnp.asarray(grads)))
    ts, tc, tv = (x.numpy() for x in topt.combine_duplicate_rows(torch.tensor(ids),
                                                                   torch.tensor(grads)))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ts[tv], js[jv])
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-6)
    assert (tc[~tv] == 0).all() and (ts[~tv] == 0).all()


def _sparse_case(seed, b=24, n=10, d=5):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    slots = [np.abs(rng.standard_normal((n, d))).astype(np.float32) for _ in range(2)]
    ids = _dup_ids(rng, b, n)
    grads = rng.standard_normal((b, d)).astype(np.float32)
    return table, slots, ids, grads


@pytest.mark.parametrize("scale", [None, 0.37])
def test_sparse_adagrad_matches_jax(scale):
    table, (accum, _), ids, grads = _sparse_case(1)
    lr = 0.05
    jt, ja = jopt.sparse_adagrad_rows(jnp.asarray(table), jnp.asarray(accum), jnp.asarray(ids),
                                      jnp.asarray(grads), lr, grad_scale=scale)
    tt, ta = torch.tensor(table), torch.tensor(accum)
    topt.sparse_adagrad_rows(tt, ta, torch.tensor(ids), torch.tensor(grads), lr,
                             grad_scale=None if scale is None else torch.tensor(scale))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
    untouched = np.setdiff1d(np.arange(table.shape[0]), ids)
    assert untouched.size and (tt.numpy()[untouched] == table[untouched]).all()


@pytest.mark.parametrize("scale", [None, 0.37])
def test_sparse_lazy_adam_matches_jax(scale):
    table, (mu, nu), ids, grads = _sparse_case(2)
    mu = mu - 0.5  # moments of both signs
    lr, step = 0.01, 6
    combined = jopt.combine_duplicate_rows(jnp.asarray(ids), jnp.asarray(grads))
    jt, jm, jn = jopt.sparse_lazy_adam_combined(
        jnp.asarray(table), jnp.asarray(mu), jnp.asarray(nu), *combined, lr,
        jnp.int32(step), grad_scale=scale)
    tt, tm, tn = torch.tensor(table), torch.tensor(mu), torch.tensor(nu)
    topt.sparse_lazy_adam_combined(
        tt, tm, tn, *topt.combine_duplicate_rows(torch.tensor(ids), torch.tensor(grads)),
        lr, step, grad_scale=None if scale is None else torch.tensor(scale))
    for got, want in ((tt, jt), (tm, jm), (tn, jn)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    untouched = np.setdiff1d(np.arange(table.shape[0]), ids)
    assert (tm.numpy()[untouched] == mu[untouched]).all()  # lazy: no decay


# ---- the sparse step and the cache -----------------------------------------

def _cfgs(optimizer="adagrad", cache=0, sparse=True, b=B, **train_kw):
    train_kw = dict(batch_size=b, learning_rate=0.02, clipnorm=1.0, optimizer=optimizer,
                    negative_cache=cache, sparse_table_updates=sparse, **train_kw)
    return (JaxRecsysConfig(model=JaxModelConfig(use_pallas_dcn=True, **MODEL_KW),
                            train=JaxTrainConfig(donate_state=False, **train_kw),
                            eval=JaxEvalConfig(topk=(5,))),
            RecsysConfig(model=ModelConfig(**MODEL_KW), train=TrainConfig(**train_kw),
                         eval=EvalConfig(topk=(5,))))


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    movie = rng.integers(0, N_ITEMS, b).astype(np.int32)
    rating = rng.uniform(1, 5, b).astype(np.float32)
    return {"user_id": rng.integers(0, N_USERS, b).astype(np.int32), "movie_id": movie,
            "rating": rating, "y_implicit": (rating >= 3.5).astype(np.float32),
            "log_q": np.full(b, -np.log(N_ITEMS), np.float32)}


def _both(tmp_path, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jtr = JaxTrainer(jcfg, str(tmp_path / "jax"), mesh_ctx=make_mesh(devices=jax.devices()[:1]))
    jstate = jtr.init_state(N_USERS, N_ITEMS, 0)
    jtr._state_for_shape = jstate
    tr = Trainer(tcfg, str(tmp_path / "port"), device="cpu")
    state = tr.state_from_params(params_from_numpy(jax.device_get(jstate.params), "cpu"), 0)
    return jtr, jstate, tr, state


def _assert_trees_close(got, want, atol, what):
    want = dict(leaves_with_paths(jax.device_get(want)))
    for path, g in leaves_with_paths(params_to_numpy(got)):
        np.testing.assert_allclose(g, np.asarray(want[path]), rtol=0, atol=atol,
                                   err_msg=f"{what}: {'/'.join(path)}")


@pytest.mark.parametrize("cache", [0, 2 * B])
@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
def test_sparse_step_matches_jax(optimizer, cache, tmp_path):
    """3 sparse steps from one init, with clipping, duplicate ids and (with
    a cache) a FIFO that fills: losses, params, slots and the cache."""
    jtr, jstate, tr, state = _both(tmp_path, optimizer=optimizer, cache=cache)
    cw = (1.3, 0.8)
    jstep = jax.jit(jtr._step_core_sparse(cw))
    step = tr._step_core(cw)
    jloss, tloss = [], []
    for s in range(3):
        batch = _batch(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, tm = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
        jloss.append(float(jm["loss"]))
        tloss.append(float(tm["loss"]))
    assert tr.step_counts == {"dense": 0, "sparse": 3}
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_trees_close(state.params, jstate.params, 1e-5 if optimizer == "adagrad" else 2e-4,
                        "params")
    _assert_trees_close(state.opt_state, jstate.opt_state, 1e-5, "slots")
    if cache:
        _assert_trees_close(state.extras, jstate.extras, 1e-5, "cache")
        np.testing.assert_array_equal(state.extras["ids"].numpy()[B:], _batch(2)["movie_id"])
    else:
        assert state.extras is None and jstate.extras is None


def test_sparse_adagrad_matches_dense_adagrad(tmp_path):
    """The port's sparse step against its own dense step over 3 steps
    (adagrad restricted to the touched rows is the dense update)."""
    _, tcfg = _cfgs(sparse=False)
    runs = {}
    for sparse in (False, True):
        cfg = dataclasses.replace(tcfg, train=dataclasses.replace(
            tcfg.train, sparse_table_updates=sparse))
        tr = Trainer(cfg, str(tmp_path / str(sparse)), device="cpu")
        state = tr.init_state(N_USERS, N_ITEMS, 0)
        step = tr.make_train_step((1.3, 0.8))
        losses = []
        for s in range(3):
            state, m = step(state, {k: torch.as_tensor(v) for k, v in _batch(s).items()})
            losses.append(float(m["loss"]))
        assert tr.step_counts["sparse" if sparse else "dense"] == 3
        runs[sparse] = losses, dict(leaves_with_paths(params_to_numpy(state.params)))
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=1e-6)
    for path, got in runs[True][1].items():
        np.testing.assert_allclose(got, runs[False][1][path], rtol=0, atol=1e-6,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("sparse", [False, True])
def test_cache_fifo_and_first_step_equivalence(sparse, tmp_path):
    """As ``tests/test_negative_cache.py``: the first step with an empty
    cache equals the cacheless step exactly; after 3 steps the FIFO holds
    batches 2 and 3 in order; a warm cache changes the loss."""
    runs = {}
    for cache in (0, 2 * B):
        _, tcfg = _cfgs(cache=cache, sparse=sparse)
        tr = Trainer(tcfg, str(tmp_path / str(cache)), device="cpu")
        state = tr.init_state(N_USERS, N_ITEMS, 0)
        step = tr.make_train_step((1.2, 0.9))
        losses = []
        for s in range(3):
            state, m = step(state, {k: torch.as_tensor(v) for k, v in _batch(s).items()})
            losses.append(float(m["loss"]))
        runs[cache] = losses, state
    assert runs[0][0][0] == runs[2 * B][0][0]  # empty slots are exact no-ops
    extras = runs[2 * B][1].extras
    np.testing.assert_array_equal(extras["ids"][:B].numpy(), _batch(1)["movie_id"])
    np.testing.assert_array_equal(extras["ids"][B:].numpy(), _batch(2)["movie_id"])
    assert bool((extras["corr"] > -1e8).all())  # no empty slot left
    assert np.isfinite(runs[2 * B][0][2])
    assert not np.isclose(runs[2 * B][0][2], runs[0][0][2], rtol=1e-6)


def test_cache_must_be_a_batch_multiple(tmp_path):
    _, tcfg = _cfgs(cache=100)
    tr = Trainer(tcfg, str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        tr.make_train_step((1.0, 1.0))


def test_auto_sparse_is_decided_from_the_state_tables(tmp_path):
    """"auto" decides once, when the step is built, from the tables of the
    trainer's state (sparse above ``SPARSE_AUTO_THRESHOLD`` elements): a
    step built before any state raises instead of guessing."""
    _, tcfg = _cfgs(sparse="auto")
    tr = Trainer(tcfg, str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="before the step"):
        tr.make_train_step((1.0, 1.0))
    state = tr.init_state(N_USERS, N_ITEMS, 0)
    runs = {}
    for threshold in (10, 10 ** 9):
        tr.SPARSE_AUTO_THRESHOLD = threshold
        step = tr.make_train_step((1.0, 1.0))
        state, _ = step(state, {k: torch.as_tensor(v) for k, v in _batch(0).items()})
        runs[threshold] = dict(tr.step_counts)
    assert runs == {10: {"dense": 0, "sparse": 1}, 10 ** 9: {"dense": 1, "sparse": 1}}


def _train_cfg(**train_kw):
    return RecsysConfig(
        model=ModelConfig(**MODEL_KW),
        train=TrainConfig(**dict(dict(batch_size=B, epochs=1, learning_rate=5e-3,
                                      negative_cache=2 * B, sparse_table_updates=True),
                                 **train_kw)),
        eval=EvalConfig(topk=(5,), eval_batch_size=256))


def test_cache_survives_checkpoint_resume(tiny_bundle, tmp_path):
    """The cache rides the checkpoint (``extras/emb``, ``extras/ids``,
    ``extras/corr``): a resumed run continues from the warm cache, as the
    uninterrupted run does."""
    out = str(tmp_path / "resume")
    tr1 = Trainer(_train_cfg(), out, device="cpu")
    tr1.train(tiny_bundle)
    step = tr1.final_state.step
    with np.load(os.path.join(out, "checkpoints", f"ckpt_{step}", "state.npz")) as z:
        assert {"extras/emb", "extras/ids", "extras/corr"} <= set(z.files)
        np.testing.assert_array_equal(z["extras/ids"], tr1.final_state.extras["ids"].numpy())
    tr2 = Trainer(_train_cfg(epochs=2, resume=True), out, device="cpu")
    tr2.train(tiny_bundle)
    tr3 = Trainer(_train_cfg(epochs=2), str(tmp_path / "straight"), device="cpu")
    tr3.train(tiny_bundle)
    assert tr2.final_state.step == tr3.final_state.step == 2 * step
    assert tr2.step_counts["sparse"] == step  # the resumed run took one epoch
    for k in ("emb", "ids", "corr"):
        torch.testing.assert_close(tr2.final_state.extras[k], tr3.final_state.extras[k],
                                   rtol=1e-5, atol=1e-5)
    # a checkpoint without a cache leaves the field out
    tr4 = Trainer(_train_cfg(negative_cache=0), str(tmp_path / "nocache"), device="cpu")
    tr4.train(tiny_bundle)
    with np.load(os.path.join(tmp_path, "nocache", "checkpoints", f"ckpt_{step}",
                              "state.npz")) as z:
        assert not any(k.startswith("extras") for k in z.files)


def test_trainer_train_with_sparse_updates_and_cache_matches_jax(tiny_bundle, tmp_path,
                                                                monkeypatch):
    """``Trainer.train`` end to end, B = 64, cache 128, sparse on, dropout
    0, from the JAX init and in the JAX trainer's batch order (its epoch
    permutation stands in for ``torch.randperm``): per-epoch train and val
    losses against the JAX ``Trainer``. On the CPU both take the dense
    retrieval loss, so this covers the sparse step and the cache."""
    kw = dict(batch_size=B, epochs=2, learning_rate=5e-3, negative_cache=2 * B,
              sparse_table_updates=True, seed=3)
    jcfg = JaxRecsysConfig(model=JaxModelConfig(use_pallas_dcn=True, **MODEL_KW),
                           train=JaxTrainConfig(**kw), eval=JaxEvalConfig(topk=(5,)))
    tcfg = RecsysConfig(model=ModelConfig(**MODEL_KW), train=TrainConfig(**kw),
                        eval=EvalConfig(topk=(5,)))
    n_users, n_items = int(tiny_bundle["meta/n_users"]), int(tiny_bundle["meta/n_movies"])
    jtr = JaxTrainer(jcfg, str(tmp_path / "jax"), mesh_ctx=make_mesh(devices=jax.devices()[:1]))
    init = jax.device_get(jtr.init_state(n_users, n_items, kw["seed"]).params)
    jtr.train(tiny_bundle)

    tr = Trainer(tcfg, str(tmp_path / "port"), device="cpu")
    monkeypatch.setattr(tr, "init_state", lambda nu, ni, seed: tr.state_from_params(
        params_from_numpy(init, "cpu"), seed))
    base = kw["seed"] ^ 0x5EED

    def jax_order(n, generator=None, device=None):
        epoch = generator.initial_seed() - base * 1_000_003
        key = jax.random.fold_in(jax.random.PRNGKey(base), epoch)
        return torch.as_tensor(np.array(jax.random.permutation(key, n)), device=device)

    monkeypatch.setattr(torch, "randperm", jax_order)
    tr.train(tiny_bundle)
    assert tr.step_counts["dense"] == 0 and tr.step_counts["sparse"] > 0
    hist = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "detailed_metrics.json") as f:
            hist[name] = json.load(f)["epochs"]
    assert len(hist["port"]) == len(hist["jax"]) == 2
    for key in ("train_loss", "train_retrieval_loss", "val_loss"):
        np.testing.assert_allclose([e[key] for e in hist["port"]],
                                   [e[key] for e in hist["jax"]], rtol=1e-4, err_msg=key)
    assert hist["port"][1]["train_loss"] < hist["port"][0]["train_loss"]


def test_cli_trains_with_the_cache_and_sparse_updates(tiny_bundle, tmp_path):
    """``--set train.negative_cache=...`` and ``--set
    train.sparse_table_updates=true`` reach the trainer; the checkpoint
    carries the cache."""
    data = str(tmp_path / "bundle.npz")
    np.savez(data, **tiny_bundle)
    out = str(tmp_path / "run")
    assert cli.main(["--data", data, "--output_dir", out, "--embedding_dim", "16",
                     "--cross_layers", "1", "--batch_size", "256", "--epochs", "1",
                     "--device", "cpu", "--set", "train.negative_cache=512",
                     "--set", "train.sparse_table_updates=true",
                     "--set", "model.user_tower_dims=[16]", "--set", "model.item_tower_dims=[16]",
                     "--set", "eval.topk=[5]"]) == 0
    with open(os.path.join(out, "config.json")) as f:
        saved = json.load(f)["train"]
    assert saved["negative_cache"] == 512 and saved["sparse_table_updates"] is True
    (ckpt,) = [n for n in os.listdir(os.path.join(out, "checkpoints")) if n.startswith("ckpt_")]
    with np.load(os.path.join(out, "checkpoints", ckpt, "state.npz")) as z:
        assert z["extras/ids"].shape == (512,) and (z["extras/ids"] >= 0).all()
