"""Parity of the port's training kernels' plain versions with the JAX
package, on the CPU: the flash in-batch softmax CE (forward and fused
backward, through its ``autograd.Function``) against JAX
``flash_softmax_ce`` in interpret mode, and the DCN cross-stack VJP
against ``jax.grad`` of ``dcn_cross_fused`` in interpret mode. The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``.

Tolerances:
* flash CE, fp32 operands: rtol = atol = 1e-5 on the value and on every
  gradient (the same fp32 arithmetic; only summation order differs);
* flash CE, bf16 operands: the products of bf16 values are exact in fp32
  and ``p * g`` rounds to bf16 at the same point in both, so the same
  1e-5 holds, plus one bf16 ulp (2**-8 relative) on the u and v
  gradients, which both packages round to bf16;
* DCN VJP: rtol = 1e-5 and atol = 1e-5 of the largest magnitude (dw sums
  ``t * x_l`` over rows in another order);
* the forward's partial layout (kernel row 4 on the tensor cores, in
  parts of the candidate axis), combined: 1e-6 of max|ref| against the
  one-pass plain forward (the same sums, split at part boundaries), and
  rtol = atol = 1e-5 against JAX ``_flash_fwd_raw`` in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.models.losses import in_batch_softmax as jax_in_batch_softmax
from recsys_tpu.ops.pallas.dcn_cross import dcn_cross_fused
from recsys_tpu.ops.pallas.flash_ce import flash_softmax_ce as jax_flash_ce
from recsys_tpu.ops.pallas.flash_ce import in_batch_softmax_flash as jax_ibs_flash
from recsys_tpu.ops.pallas import flash_ce as JF
from recsys_tpu_torch.ops import dcn_cross as D
from recsys_tpu_torch.ops import flash_ce as F

BF16_ULP = 2.0 ** -8


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _inputs(bq, bk, d, seed, n_ids=None):
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((bq, d)) * d ** -0.5).astype(np.float32)
    v = rng.standard_normal((bk, d)).astype(np.float32)
    c = rng.standard_normal(bk).astype(np.float32)
    n_ids = n_ids or max(2, bk // 3)  # many accidental hits
    ids_k = rng.integers(0, n_ids, bk).astype(np.int32)
    ids_q = ids_k[:bq].copy() if bq <= bk else rng.integers(0, n_ids, bq).astype(np.int32)
    g = rng.standard_normal(bq).astype(np.float32)
    return u, v, c, ids_q, ids_k, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bq,bk", [(64, 64), (32, 96)])
def test_flash_softmax_ce_matches_jax_interpret(dtype, bq, bk):
    """Value and the gradients w.r.t. u, v and colcorr, square and
    rectangular (Bk > Bq, positives in the first Bq columns)."""
    u, v, c, ids_q, ids_k, g = _inputs(bq, bk, 16, seed=bq + bk)
    pos = np.arange(bq, dtype=np.int32)
    jdt = getattr(jnp, dtype)

    def jax_fn(a, b, cc):
        ce = jax_flash_ce(a.astype(jdt), b.astype(jdt), cc, jnp.asarray(ids_q),
                          jnp.asarray(ids_k), jnp.asarray(pos))
        return jnp.sum(ce * g)

    jval, jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1, 2))(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(c))
    tu, tv, tc = (torch.tensor(x, requires_grad=True) for x in (u, v, c))
    tdt = getattr(torch, dtype)
    before = (F.flash_ce_fwd.launches, F.flash_ce_bwd_fused.launches)
    ce = F.flash_softmax_ce(tu.to(tdt), tv.to(tdt), tc, torch.tensor(ids_q),
                            torch.tensor(ids_k), torch.tensor(pos))
    total = (ce * torch.tensor(g)).sum()
    total.backward()
    _close(total.item(), jval)
    ulp = BF16_ULP if dtype == "bfloat16" else 0.0
    _close(tu.grad, jgrads[0], rtol=1e-5 + ulp)
    _close(tv.grad, jgrads[1], rtol=1e-5 + ulp)
    _close(tc.grad, jgrads[2])
    # on CPU tensors the wrappers run the plain versions and count nothing
    assert (F.flash_ce_fwd.launches, F.flash_ce_bwd_fused.launches) == before


@pytest.mark.parametrize("case", ["mask_logq_bias", "extra_candidates", "no_masking"])
def test_in_batch_softmax_flash_matches_jax(case):
    """The loss wrapper with a mask, logQ and item bias; with CBNS-style
    extra candidate columns (rectangular); without accidental-hit ids."""
    b, d = 48, 16
    rng = np.random.default_rng(7)
    u = (rng.standard_normal((b, d)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((b, d)) * 0.3).astype(np.float32)
    ids = rng.integers(0, 12, b).astype(np.int32)
    mask = (rng.random(b) > 0.2).astype(np.float32)
    log_q = -rng.random(b).astype(np.float32) * 5
    bias = rng.standard_normal(b).astype(np.float32)
    extra = None
    kw = {}
    if case == "mask_logq_bias":
        kw = dict(mask=mask, log_q=log_q, item_bias=bias)
    elif case == "extra_candidates":
        n_x = 40
        extra = (rng.standard_normal((n_x, d)).astype(np.float32) * 0.3,
                 rng.integers(0, 12, n_x).astype(np.int32),
                 rng.standard_normal(n_x).astype(np.float32))
        kw = dict(log_q=log_q)
    elif case == "no_masking":
        ids = np.arange(b, dtype=np.int32)

    def jax_loss(a, bb, bias_):
        kk = dict(kw)
        if "item_bias" in kk:
            kk["item_bias"] = bias_
        jx = tuple(map(jnp.asarray, extra)) if extra is not None else None
        return jax_ibs_flash(a, bb, jnp.asarray(ids), bf16=False, extra_candidates=jx,
                             **{k: (jnp.asarray(x) if k != "item_bias" else x)
                                for k, x in kk.items()})

    jval, jg = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(bias))
    tu, tv, tb = (torch.tensor(x, requires_grad=True) for x in (u, v, bias))
    tkw = {k: torch.tensor(x) for k, x in kw.items()}
    if "item_bias" in tkw:
        tkw["item_bias"] = tb
    tx = tuple(map(torch.tensor, extra)) if extra is not None else None
    loss = F.in_batch_softmax_flash(tu, tv, torch.tensor(ids), bf16=False,
                                    extra_candidates=tx, **tkw)
    loss.backward()
    _close(loss.item(), jval)
    _close(tu.grad, jg[0])
    _close(tv.grad, jg[1])
    if case == "mask_logq_bias":
        _close(tb.grad, jg[2])


@pytest.mark.parametrize("b", [37, 100])
def test_flash_ragged_batch_matches_jax_dense(b):
    """A batch no tile divides (JAX's ``_tiles`` asserts there): the plain
    version against the JAX dense ``in_batch_softmax``."""
    rng = np.random.default_rng(b)
    u = (rng.standard_normal((b, 16)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((b, 16)) * 0.3).astype(np.float32)
    ids = rng.integers(0, 10, b).astype(np.int32)
    log_q = -rng.random(b).astype(np.float32) * 3
    jval, jg = jax.value_and_grad(
        lambda a, c: jax_in_batch_softmax(a, c, item_ids=jnp.asarray(ids),
                                          log_q=jnp.asarray(log_q)),
        argnums=(0, 1))(jnp.asarray(u), jnp.asarray(v))
    tu, tv = (torch.tensor(x, requires_grad=True) for x in (u, v))
    loss = F.in_batch_softmax_flash(tu, tv, torch.tensor(ids), log_q=torch.tensor(log_q),
                                    bf16=False)
    loss.backward()
    _close(loss.item(), jval)
    _close(tu.grad, jg[0])
    _close(tv.grad, jg[1])


def test_flash_wrappers_check_inputs_and_the_partials_cap(monkeypatch):
    u, v, c, ids_q, ids_k, _ = (torch.tensor(x) for x in _inputs(8, 8, 4, seed=0))
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        F.flash_ce_fwd(u, v, c, ids_q.long(), ids_k, pos)
    with pytest.raises(ValueError, match="fp32 or both bf16"):
        F.flash_ce_fwd(u, v.to(torch.bfloat16), c, ids_q, ids_k, pos)
    with pytest.raises(ValueError, match="D <= 256"):
        F.flash_ce_fwd(torch.zeros(8, 300), torch.zeros(8, 300), c, ids_q, ids_k, pos)
    lse, _ = F.flash_ce_fwd(u, v, c, ids_q, ids_k, pos)
    with pytest.raises(ValueError, match="fp32"):
        F.flash_ce_bwd(u, v, c, ids_q, ids_k, pos, lse.double(), torch.ones(8))
    # the cap counts the TPU's [Bk // tk, Bq, D] fp32 partials (tk = 2,048 here)
    assert F.fused_bwd_partials_bytes(8192, 8192, 128) == 4 * 8192 * 128 * 4
    fused = F.flash_ce_bwd(u, v, c, ids_q, ids_k, pos, lse, torch.ones(8))
    # past the TPU's cap the operand type still picks the route: fp32
    # operands keep the fused backward; the two-kernel route gives the same
    monkeypatch.setattr(F, "_FUSED_BWD_PARTIALS_CAP", 8 * 4 * 4 - 1)
    for got, want in zip(F.flash_ce_bwd(u, v, c, ids_q, ids_k, pos, lse, torch.ones(8)),
                         fused):
        assert torch.equal(got, want)
    for got, want in zip(F.flash_ce_bwd_twokernel(u, v, c, ids_q, ids_k, pos, lse,
                                                  torch.ones(8)), fused):
        _close(got, want)


@pytest.mark.parametrize("b,tiles,parts,tpu_route", [
    (8192, 1, 4, "fused"),        # the main path: a block per 128-candidate tile, 4 query parts
    (20000, 1, 5, "twokernel"),   # the TPU's tk is 32 here: 5.96 GiB of its partials
    (24576, 1, 2, "fused"),       # 192 partials of 12 MiB
    (32768, 1, 1, "fused"),       # 256 partials of 16 MiB: still under the cap
    (65536, 4, 2, "fused"),       # beyond, the blocks sweep wider spans
    (131072, 16, 4, "fused"),
    (139264, 18, 4, "twokernel"),  # the TPU's 2,048-wide partials pass the cap
])
def test_flash_bwd_covers_the_tpu_batch_range(b, tiles, parts, tpu_route):
    """The fused backward's plan covers the TPU package's batch range,
    through its switch to the two-kernel backward, under the cap: each
    block sweeps as many 128-candidate tiles, and the query sweep is split
    into as many parts, as keep the kernel's own dU, dV and dcol partials
    under it, and further where the FMA kernel's one block per SM would
    leave its last wave thin (20,000 and 24,576). Every candidate tile lies
    in exactly one span, every part has query tiles. fp32 operands take the
    fused kernel at every batch, past the TPU's switch too (on the FMA
    units it beat rows 6 + 7 by 23-38% at eight shapes on an H100,
    20,000^2 8.855 against 12.16 ms). Meta tensors: nothing is
    allocated."""
    d = 128
    n_tiles, n_qt = -(-b // F.TKC), -(-b // F.TQ)
    p = F.bwd_plan(b, b, d, 132)
    assert (p.tile, p.tiles_per_block, p.parts) == (F.TKC, tiles, parts)
    assert p.n_spans == -(-n_tiles // tiles) and p.n_spans * p.parts >= min(132, n_tiles)
    assert p.n_spans * tiles >= n_tiles > (p.n_spans - 1) * tiles
    assert p.parts * p.q_tiles_per_part >= n_qt > (p.parts - 1) * p.q_tiles_per_part
    assert p.partials_bytes(b, b, d) <= F._FUSED_BWD_PARTIALS_CAP
    _, tk = JF._tiles(b, b)
    assert ("fused" if F.fused_bwd_partials_bytes(b, b, d) <= F._FUSED_BWD_PARTIALS_CAP
            else "twokernel") == tpu_route == ("fused" if b * d * (b // tk) * 4
                                               <= JF._FUSED_BWD_PARTIALS_CAP else "twokernel")
    meta = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    ids = meta(b, dtype=torch.int32)
    args = (meta(b, d), meta(b, d), meta(b), ids, ids, ids, meta(b), meta(b))
    # the route's wrapper refuses a meta tensor as an unsupported device
    with pytest.raises(ValueError, match="flash_ce_bwd_fused: unsupported device"):
        F.flash_ce_bwd(*args)


@pytest.mark.parametrize("bq,bk,d,dtype,n_sm,cap_parts", [
    (130, 260, 24, "float32", 4, None),     # 3 spans x 2 parts
    (130, 260, 24, "float32", 4, 3),        # a cap of three dU partials: one span of 3 tiles
    (300, 700, 64, "float32", 8, None),     # 6 spans x 2 parts, ragged last tiles
    (200, 300, 16, "float32", 4, 2),        # a cap of two dU partials: wide spans
    (150, 333, 129, "float32", 8, None),    # D > 128: 64-candidate tiles, 6 spans x 2 parts
    (100, 200, 256, "float32", 4, None),    # DP = 256: 4 spans x 2 parts
    (200, 300, 16, "float32", 4, None),     # 3 candidate tiles, query parts
    (130, 260, 24, "float32", 132, None),   # more SMs than blocks
    (70, 1, 8, "float32", 8, None),         # one candidate
])
def test_plain_backward_over_the_partial_layout_matches_reference(
        monkeypatch, bq, bk, d, dtype, n_sm, cap_parts):
    """The plain version of what the fused kernel writes under its plan
    ([n_spans, Bq, D] dU, [parts, Bk, D] dV and [parts, Bk] dcol
    partials), summed in the wrapper's fixed order, equals
    ``flash_ce_bwd_reference``: fp32 sums in another order only."""
    if cap_parts:  # room for cap_parts dU partials of [Bq, D]
        monkeypatch.setattr(F, "_FUSED_BWD_PARTIALS_CAP", 4 * cap_parts * bq * d)
    u, v, c, ids_q, ids_k, g = (torch.tensor(x) for x in _inputs(bq, bk, d, seed=bq + d))
    tdt = getattr(torch, dtype)
    u, v = u.to(tdt), v.to(tdt)
    pos = torch.arange(bq, dtype=torch.int32) % bk
    lse, _ = F.flash_ce_fwd_reference(u, v, c, ids_q, ids_k, pos)
    args = (u, v, c, ids_q, ids_k, pos, lse, g)
    p = F.bwd_plan(bq, bk, d, n_sm)
    if cap_parts:
        assert p.n_spans <= cap_parts and p.tiles_per_block > 1
    assert p.partials_bytes(bq, bk, d) <= F._FUSED_BWD_PARTIALS_CAP
    du_part, dv_part, dcol_part = F.flash_ce_bwd_partials_reference(*args, p)
    assert du_part.shape == (p.n_spans, bq, d)
    assert dv_part.shape == (p.parts, bk, d) and dcol_part.shape == (p.parts, bk)
    for got, want in zip(F.sum_partials(du_part, dv_part, dcol_part),
                         F.flash_ce_bwd_reference(*args)):
        scale = float(want.abs().max())
        _close(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("bq,bk,d,n_sm,all_accidental", [
    (64, 192, 16, 4, False),   # 2 spans x 1 part
    (37, 100, 24, 132, True),  # ragged: one tile each way (the TPU's tiles are the batch)
    (130, 260, 129, 8, True),  # D > 128: 64-candidate tiles, 5 spans x 3 parts
    (256, 520, 32, 8, False),  # 5 spans x 2 parts
])
def test_fp32_bwd_partials_match_jax_fused_interpret(bq, bk, d, n_sm, all_accidental):
    """The plain version of what the fp32 fused kernel writes under
    ``bwd_plan`` (spans of 128 or 64 candidates, parts of the query
    sweep), summed by ``sum_partials``, equals JAX ``_flash_bwd_fused_raw``
    in interpret mode to 1e-5 of each output's max|ref|; row 0's positive
    lies in the last candidate tile, and with ``all_accidental`` every
    third row's every other candidate is an accidental hit."""
    u, v, c, ids_q, ids_k, g = _inputs(bq, bk, d, seed=bq + d)
    ids_q, ids_k, pos = _edges(ids_q, ids_k, np.arange(bq, dtype=np.int32) % bk,
                               all_accidental)
    small = (torch.tensor(c), torch.tensor(ids_q), torch.tensor(ids_k), torch.tensor(pos))
    tu, tv = torch.tensor(u), torch.tensor(v)
    lse, _ = F.flash_ce_fwd_reference(tu, tv, *small)
    p = F.bwd_plan(bq, bk, d, n_sm)
    assert p.tile == (F.TK if d > 128 else F.TKC)
    got = F.sum_partials(*F.flash_ce_bwd_partials_reference(tu, tv, *small, lse,
                                                            torch.tensor(g), p))
    want = JF._flash_bwd_fused_raw(jnp.asarray(u), jnp.asarray(v), jnp.asarray(c),
                                   jnp.asarray(ids_q), jnp.asarray(ids_k), jnp.asarray(pos),
                                   jnp.asarray(lse.numpy()), jnp.asarray(g), True)
    for a, b in zip(got, want):
        _close(a, b, rtol=0, atol=1e-5 * float(np.abs(np.asarray(b)).max()))


@pytest.mark.parametrize("d,dtype,want", [
    (128, torch.float32, 1), (24, torch.float32, 1), (129, torch.float32, 0),
    (30, torch.float32, 0), (24, torch.bfloat16, 1), (20, torch.bfloat16, 0),
])
def test_vec_copies_16_bytes_where_rows_allow(d, dtype, want):
    """``_vec``: rows of 16-byte multiples (4 fp32 or 8 bf16 values)
    starting on 16 bytes are staged by ``cp.async`` 16 bytes at a time;
    any other width, or an operand off 16 bytes, element by element."""
    u, v = torch.zeros(8, d, dtype=dtype), torch.zeros(8, d, dtype=dtype)
    assert F._vec(u, v) == want
    assert F._vec(torch.zeros(8 * d + 1, dtype=dtype)[1:].view(8, d), v) == 0


@pytest.mark.parametrize("bq,bk", [(8192, 8192), (20000, 20000), (24000, 24000),
                                   (139264, 139264), (131072, 147456), (131072, 262144),
                                   (65536, 327680)])
def test_bwd_plan_keeps_the_tpu_route(bq, bk):
    """The tiling does not route: the TPU's route is its own partials
    against the cap, counted as it counts them; the port routes fp32
    operands to the fused kernel on both sides of that switch (H100
    numbers), and the port's fused partials fit under the cap at every
    shape, past the TPU's switch too."""
    d = 128
    _, tk = JF._tiles(bq, bk)
    tpu = "fused" if bq * d * (bk // tk) * 4 <= JF._FUSED_BWD_PARTIALS_CAP else "twokernel"
    assert ("fused" if F.fused_bwd_partials_bytes(bq, bk, d) <= F._FUSED_BWD_PARTIALS_CAP
            else "twokernel") == tpu
    plan = F.bwd_plan(bq, bk, d, 132)
    assert plan.partials_bytes(bq, bk, d) <= F._FUSED_BWD_PARTIALS_CAP


# the eight shapes of the H100 route tables (PERF.md), D = 128
_ROUTE_TABLE_SHAPES = [(4096, 20480), (8192, 8192), (16384, 16384), (32768, 32768),
                       (20000, 20000), (65536, 327680), (131072, 147456), (131072, 262144)]


@pytest.mark.parametrize("dtype,route", [("bfloat16", "twokernel"), ("float32", "fused")])
@pytest.mark.parametrize("bq,bk", _ROUTE_TABLE_SHAPES)
def test_flash_ce_bwd_routes_by_operand_type(bq, bk, dtype, route, monkeypatch):
    """``flash_ce_bwd`` sends bf16 operands to rows 6 and 7 and fp32
    operands to the fused kernel at every shape of the H100 route tables,
    on both sides of the TPU's cap (each route won there for its operand
    type). Meta tensors: nothing is allocated; only the callee is read."""
    calls = []
    for name in ("fused", "twokernel"):
        monkeypatch.setattr(F, f"flash_ce_bwd_{name}", lambda *a, name=name: calls.append(name))
    d, dt = 128, getattr(torch, dtype)
    meta = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    F.flash_ce_bwd(meta(bq, d, dtype=dt), meta(bk, d, dtype=dt), meta(bk),
                   meta(bq, dtype=torch.int32), meta(bk, dtype=torch.int32),
                   meta(bq, dtype=torch.int32), meta(bq), meta(bq))
    assert calls == [route]


@pytest.mark.parametrize("wrapper,dtype,use", [
    ("flash_ce_bwd_fused", "bfloat16", "flash_ce_bwd_twokernel"),
    ("flash_ce_bwd_du", "float32", "flash_ce_bwd_fused"),
    ("flash_ce_bwd_dv", "float32", "flash_ce_bwd_fused"),
])
def test_cuda_branch_refuses_an_operand_type_without_a_kernel(wrapper, dtype, use,
                                                               monkeypatch):
    """Each backward wrapper launches one CUDA kernel, for one operand
    type: a CUDA call of the other type raises, naming the wrapper to use,
    before the kernels' library is loaded; nothing falls back."""
    def no_library():
        raise AssertionError("the kernels' library was loaded")

    monkeypatch.setattr(F, "_on_cuda", lambda u, what: True)
    monkeypatch.setattr(F._build, "load_library", no_library)
    u, v, c, ids_q, ids_k, g = (torch.tensor(x) for x in _inputs(16, 24, 8, seed=1))
    pos = torch.arange(16, dtype=torch.int32)
    lse = torch.zeros(16)
    dt = getattr(torch, dtype)
    with pytest.raises(ValueError, match=f"{wrapper}: .*{use}"):
        getattr(F, wrapper)(u.to(dt), v.to(dt), c, ids_q, ids_k, pos, lse, g)


# ---- kernel row 4: the forward's plan and partial layout -----------------

_FWD_PLAN_CASES = [
    # bf16 operands (the wgmma kernel: 128-row query blocks, 128-candidate
    # tiles, two blocks an SM to D = 128, one past it)
    (8192, 8192, 128, 4, True),       # 64 blocks: one wave of 4 parts of 16 tiles
    (131072, 262144, 128, 1, True),   # the giant step: 1,024 blocks, 3.9 waves, no partials
    (1000, 3001, 128, 24, True),      # ragged: 8 blocks, a part per candidate tile
    (64, 10, 128, 1, True),           # one candidate tile
    (4096, 20480, 128, 8, True),      # 32 blocks: one wave of 8 parts of 20 tiles
    (20000, 20000, 128, 5, True),     # 157 blocks: 3 waves of 32 tiles
    (8192, 8192, 256, 2, True),       # one block an SM: one wave of 2 parts of 32 tiles
    (1000, 3001, 129, 12, True),      # ragged, one block an SM: a part per 2 tiles
    # fp32 operands (the FMA kernel, one block per SM): 128 x 128 tiles
    (8192, 8192, 128, 8, False),      # 64 blocks: 4 waves of 8 tiles
    (20000, 20000, 128, 5, False),    # 157 blocks: 6 waves of 32 tiles
    (131072, 262144, 128, 1, False),  # 1,024 blocks: 8 waves, no partials
    (1000, 3001, 129, 16, False),     # ragged, D past 128: 64 x 64 tiles
    (300, 1100, 256, 18, False),      # DP = 256: a part per candidate tile
    (65, 1, 128, 1, False),           # a single candidate
]


@pytest.mark.parametrize("bq,bk,d,parts,bf16", _FWD_PLAN_CASES, ids=[
    f"{'bf16' if bf16 else 'fp32'}-{bq}-{bk}-{d}-{parts}"
    for bq, bk, d, parts, bf16 in _FWD_PLAN_CASES])
def test_fwd_plan_fills_the_card_under_the_cap(bq, bk, d, parts, bf16):
    """The forward's tiling, checked on the CPU: every candidate tile in
    exactly one part and the partials under the cap. bf16 operands (the
    logits need all of D, so the wgmma forward has no column slices):
    128-row query blocks and 128-candidate tiles, two blocks an SM to D =
    128 and one past it: one part where the blocks alone fill
    ``_FULL_WAVES`` waves, else the split whose last wave ends first, a
    block's set-up and write-out counted as ``_BLOCK_TILES`` of its tiles,
    so never later than one part. fp32 operands: 128-row blocks and
    128-candidate tiles (64 and 64 past D = 128), the sweep split for the
    fewest waves of one block per SM from 2 to 8 blocks per SM, which
    leaves at least one block per SM wherever the tiles allow."""
    n_sm = 132
    p = F.fwd_plan(bq, bk, bf16, n_sm, d)
    want = (F.WG_OWN, F.WG_TILE) if bf16 else (F.F32_TQ, F.F32_FWD_TK) if d <= 128 else (64, 64)
    assert (p.tile, p.ktile, p.parts) == (*want, parts)
    n_kt = -(-bk // p.ktile)
    assert p.parts * p.tiles_per_part >= n_kt > (p.parts - 1) * p.tiles_per_part
    assert p.partials_bytes(bq) <= F._FUSED_BWD_PARTIALS_CAP
    q_blocks = -(-bq // p.tile)
    if bf16:
        slots = (2 if d <= 128 else 1) * n_sm

        def ends(n_parts: int, per_part: int) -> int:
            return -(-q_blocks * n_parts // slots) * (per_part + F._BLOCK_TILES)

        assert ends(p.parts, p.tiles_per_part) <= ends(1, n_kt)
        if q_blocks >= F._FULL_WAVES * slots:
            assert p.parts == 1
    else:
        assert q_blocks * p.parts >= min(n_sm, q_blocks * n_kt)


def test_fwd_plan_keeps_the_partials_under_a_lowered_cap(monkeypatch):
    """With room for only two parts' (m, l, positive logit) the plan takes
    two parts, each sweeping half the candidate tiles, where the card alone
    would take 8 (4,096 x 20,480)."""
    bq, bk = 4096, 20480
    assert F.fwd_plan(bq, bk, True, 132, 128).parts == 8
    monkeypatch.setattr(F, "_FUSED_BWD_PARTIALS_CAP", 2 * 12 * bq)
    p = F.fwd_plan(bq, bk, True, 132, 128)
    assert (p.parts, p.tiles_per_part) == (2, 80)
    assert p.partials_bytes(bq) <= F._FUSED_BWD_PARTIALS_CAP


def test_fp32_fwd_plan_keeps_the_partials_under_a_lowered_cap(monkeypatch):
    """fp32 operands: with room for only two parts' (m, l, positive logit)
    the plan takes two parts, each sweeping half the candidate tiles, where
    the card alone would take 8; a plan of fp32 operands needs D."""
    bq, bk = 8192, 8192
    monkeypatch.setattr(F, "_FUSED_BWD_PARTIALS_CAP", 2 * 12 * bq)
    p = F.fwd_plan(bq, bk, False, 132, 128)
    assert (p.tile, p.parts, p.tiles_per_part) == (F.F32_TQ, 2, 32)
    assert p.partials_bytes(bq) <= F._FUSED_BWD_PARTIALS_CAP
    with pytest.raises(ValueError, match="depend on d"):
        F.fwd_plan(bq, bk, False, 132)


def _edges(ids_q, ids_k, pos, all_accidental: bool) -> tuple:
    """Row 0's positive in the last column (the last part of the
    candidate axis); with ``all_accidental`` every third row's every
    candidate but its positive is an accidental hit."""
    ids_q, ids_k, pos = ids_q.copy(), ids_k.copy(), pos.copy()
    pos[0] = len(ids_k) - 1
    if all_accidental:
        hit = int(max(ids_q.max(), ids_k.max())) + 1
        ids_k[:] = hit
        ids_q[::3] = hit
    return ids_q, ids_k, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bq,bk,n_sm,all_accidental", [
    (64, 192, 132, False),    # two parts of one tile, the last of 64 candidates
    (1024, 320, 4, True),     # 8 blocks fill a wave of 4 SMs: one part of 3 tiles
    (70, 1, 132, False),      # one candidate: one part
    (130, 4097, 132, True),   # 33 parts, the last of one candidate
    (256, 1300, 8, True),     # 6 parts of 2 tiles and one, the last of 20 candidates
    (300, 2000, 8, False),    # 4 parts of 4 tiles, the last of 80 candidates
])
def test_fwd_partials_combine_to_the_reference_and_jax(dtype, bq, bk, n_sm, all_accidental):
    """The plain version of the forward kernel's partials under
    ``fwd_plan`` (m, l and the positive logit per part), folded by the
    plain combine, equals the one-pass plain forward and JAX
    ``_flash_fwd_raw`` in interpret mode; row 0's positive logit lies in
    the last part and nowhere else."""
    u, v, c, ids_q, ids_k, _ = _inputs(bq, bk, 16, seed=bq + bk)
    ids_q, ids_k, pos = _edges(ids_q, ids_k, np.arange(bq, dtype=np.int32) % bk,
                               all_accidental)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tu, tv = torch.tensor(u).to(tdt), torch.tensor(v).to(tdt)
    small = (torch.tensor(c), torch.tensor(ids_q), torch.tensor(ids_k), torch.tensor(pos))
    p = F.fwd_plan(bq, bk, True, n_sm, 16)
    m, l, pos_part = F.flash_ce_fwd_partials_reference(tu, tv, *small, p)
    assert m.shape == l.shape == pos_part.shape == (p.parts, bq)
    got = F.combine_fwd_partials(m, l, pos_part)
    want = F.flash_ce_fwd_reference(tu, tv, *small)
    assert pos_part[-1, 0] == want[1][0] and not pos_part[:-1, 0].any()
    for a, b in zip(got, want):
        _close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))
    jax_lse, jax_pos = JF._flash_fwd_raw(
        jnp.asarray(u).astype(jdt), jnp.asarray(v).astype(jdt), jnp.asarray(c),
        jnp.asarray(ids_q), jnp.asarray(ids_k), jnp.asarray(pos), True)
    _close(got[0], jax_lse)
    _close(got[1], jax_pos)


@pytest.mark.parametrize("bq,bk,d,n_sm,all_accidental", [
    (192, 600, 16, 132, False),   # 2 blocks: 5 parts of one 128-candidate tile
    (300, 2000, 32, 8, True),     # 3 blocks, 16 tiles: parts of several tiles
    (130, 300, 129, 132, True),   # D past 128: 64 x 64 tiles, 5 parts
    (200, 290, 24, 132, False),   # ragged: 3 parts, the last of 34 candidates
])
def test_fp32_fwd_partials_combine_to_the_reference_and_jax(bq, bk, d, n_sm, all_accidental):
    """The plain version of what row 4's fp32 kernel writes under
    ``fwd_plan`` (at least 3 parts here), folded by the plain combine,
    equals the one-pass plain forward (1e-6 of max|ref|) and JAX
    ``_flash_fwd_raw``'s lse and positive logit in interpret mode (rtol =
    atol = 1e-5); row 0's positive logit lies in the last part and nowhere
    else."""
    u, v, c, ids_q, ids_k, _ = _inputs(bq, bk, d, seed=bq + bk + d)
    ids_q, ids_k, pos = _edges(ids_q, ids_k, np.arange(bq, dtype=np.int32) % bk,
                               all_accidental)
    tu, tv = torch.tensor(u), torch.tensor(v)
    small = (torch.tensor(c), torch.tensor(ids_q), torch.tensor(ids_k), torch.tensor(pos))
    p = F.fwd_plan(bq, bk, False, n_sm, d)
    assert p.parts >= 3 and p.ktile == (F.F32_FWD_TK if d <= 128 else 64)
    m, l, pos_part = F.flash_ce_fwd_partials_reference(tu, tv, *small, p)
    assert m.shape == l.shape == pos_part.shape == (p.parts, bq)
    got = F.combine_fwd_partials(m, l, pos_part)
    want = F.flash_ce_fwd_reference(tu, tv, *small)
    assert pos_part[-1, 0] == want[1][0] and not pos_part[:-1, 0].any()
    for a, b in zip(got, want):
        _close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))
    jax_lse, jax_pos = JF._flash_fwd_raw(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(c), jnp.asarray(ids_q), jnp.asarray(ids_k),
        jnp.asarray(pos), True)
    _close(got[0], jax_lse)
    _close(got[1], jax_pos)


@pytest.mark.parametrize("n,f,n_layers", [(37, 24, 3), (64, 256, 3), (5, 40, 1)])
def test_dcn_cross_vjp_matches_jax_grad(n, f, n_layers):
    """The autograd Function (forward saving each layer's input, backward
    running the plain VJP on the CPU) against ``jax.grad`` of the JAX
    kernel in interpret mode, and against autograd through the plain
    forward."""
    rng = np.random.default_rng(n * f)
    x0 = rng.standard_normal((n, f)).astype(np.float32)
    w = (rng.standard_normal((n_layers, f)) * f ** -0.5).astype(np.float32)
    b = (rng.standard_normal((n_layers, f)) * 0.1).astype(np.float32)
    g = rng.standard_normal((n, f)).astype(np.float32)
    want = jax.grad(lambda a, bw, bb: jnp.sum(dcn_cross_fused(a, bw, bb) * g),
                    argnums=(0, 1, 2))(jnp.asarray(x0), jnp.asarray(w), jnp.asarray(b))
    before = (D.dcn_cross.launches, D.dcn_cross_bwd.launches)
    ts = [torch.tensor(a, requires_grad=True) for a in (x0, w, b)]
    (D.cross_stack(*ts) * torch.tensor(g)).sum().backward()
    ref = [torch.tensor(a, requires_grad=True) for a in (x0, w, b)]
    (D.dcn_cross_reference(*ref) * torch.tensor(g)).sum().backward()
    for t, r, jw in zip(ts, ref, want):
        scale = float(np.abs(np.asarray(jw)).max())
        _close(t.grad, jw, atol=1e-5 * max(1.0, scale))
        _close(t.grad, r.grad, atol=1e-5 * max(1.0, scale))
    assert (D.dcn_cross.launches, D.dcn_cross_bwd.launches) == before


@pytest.mark.parametrize("n,f,n_layers,registers,n_blocks", [
    (8192, 256, 3, True, 132),      # the flagship: dw and db in registers, a block an SM
    (12_800, 256, 4, True, 132),    # the register kernel's deepest stack
    (1, 24, 1, True, 1),            # one row: one block
    (2048, 256, 5, False, 256),     # past 4 layers: shared memory, a block per 8 rows
    (1000, 512, 2, False, 125),     # past 256 features: shared memory
    (50_000, 512, 2, False, 264),   # shared memory: 2 blocks an SM
    (5, 1024, 3, False, 1),         # L x F = 3,072 at the widest F
])
def test_dcn_bwd_plan_picks_the_kernel_and_sizes_the_grid(n, f, n_layers, registers,
                                                          n_blocks):
    """The DCN backward's plan on a 132-SM card: the register kernel (one
    block per SM) up to 4 layers of 256 features, the shared-memory kernel
    (two per SM) past either; as many blocks of 8 warps as the rows need, at
    most those; the block's fold of its warps' dw and db fits its shared
    memory."""
    p = D.bwd_plan(n, f, n_layers, 132)
    assert (p.registers, p.n_blocks) == (registers, n_blocks)
    per_sm = 1 if registers else 2
    assert p.n_blocks * D._BWD_WARPS >= min(n, per_sm * 132 * D._BWD_WARPS)
    assert D._BWD_WARPS * 2 * n_layers * f * 4 <= D.MAX_BWD_SHARED_BYTES


def test_cross_stack_without_grad_keeps_no_layer_inputs():
    x0 = torch.randn(5, 8)
    w, b = torch.randn(2, 8, requires_grad=True), torch.zeros(2, 8)
    with torch.no_grad():
        out = D.cross_stack(x0, w, b)
    assert out.grad_fn is None
    torch.testing.assert_close(out, D.dcn_cross_reference(x0, w.detach(), b))
    assert D.cross_stack(x0, w, b).grad_fn is not None
