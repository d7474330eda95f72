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
  ``t * x_l`` over rows in another order).
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
    before = (F.flash_ce_fwd.launches, F.flash_ce_bwd.launches)
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
    assert (F.flash_ce_fwd.launches, F.flash_ce_bwd.launches) == before


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
    # the cap counts the TPU's [ceil(Bk / 2048), Bq, D] fp32 partials
    assert F.fused_bwd_partials_bytes(8192, 8192, 128) == 4 * 8192 * 128 * 4
    monkeypatch.setattr(F, "_FUSED_BWD_PARTIALS_CAP", 8 * 4 * 4 - 1)
    with pytest.raises(NotImplementedError, match="rows 6 and 7"):
        F.flash_ce_bwd(u, v, c, ids_q, ids_k, pos, lse, torch.ones(8))


@pytest.mark.parametrize("b,tiles,raises", [
    (8192, 1, False),       # the main path: a block per 64-candidate tile
    (24576, 1, False),      # 384 partials of 12 MiB: exactly the cap
    (32768, 2, False),      # beyond 24.5k the blocks sweep wider spans
    (65536, 8, False),
    (131072, 29, False),
    (139264, 33, True),     # the TPU's partials pass the cap: rows 6 and 7
])
def test_flash_bwd_covers_the_tpu_batch_range(b, tiles, raises):
    """The fused backward runs wherever the TPU package's does: each
    block sweeps as many candidate tiles as keep the kernel's own
    [n_blocks, Bq, D] partials under the cap, and the backward raises
    only where the TPU's 2,048-wide partials pass it. Meta tensors:
    nothing is allocated."""
    d = 128
    assert F.bwd_tiles_per_block(b, b, d) == tiles
    n_tiles = -(-b // F.TK)
    n_blocks = -(-n_tiles // tiles)
    assert n_blocks * b * d * 4 <= F._FUSED_BWD_PARTIALS_CAP
    assert (F.fused_bwd_partials_bytes(b, b, d) > F._FUSED_BWD_PARTIALS_CAP) == raises
    meta = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    ids = meta(b, dtype=torch.int32)
    args = (meta(b, d), meta(b, d), meta(b), ids, ids, ids, meta(b), meta(b))
    # past the cap check a meta tensor is refused as an unsupported device
    with pytest.raises(NotImplementedError if raises else ValueError,
                       match="rows 6 and 7" if raises else "unsupported device"):
        F.flash_ce_bwd(*args)


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


def test_cross_stack_without_grad_keeps_no_layer_inputs():
    x0 = torch.randn(5, 8)
    w, b = torch.randn(2, 8, requires_grad=True), torch.zeros(2, 8)
    with torch.no_grad():
        out = D.cross_stack(x0, w, b)
    assert out.grad_fn is None
    torch.testing.assert_close(out, D.dcn_cross_reference(x0, w.detach(), b))
    assert D.cross_stack(x0, w, b).grad_fn is not None
