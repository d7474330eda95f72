"""Flash in-batch softmax cross-entropy: the CUDA kernels of
``csrc/flash_ce.cu`` (forward, fused backward and the two-kernel
backward) and their plain PyTorch versions (the port of
``recsys_tpu/ops/pallas/flash_ce.py``).

Per query row ``i`` of ``u [Bq, D]`` against candidates ``v [Bk, D]``::

    ce_i = logsumexp_j(s_ij) - s_{i,pos_i},  s_ij = u_i . v_j + colcorr_j,

with accidental hits (``ids_q[i] == ids_k[j]`` and ``j != pos_i``) set to
-1e9. ``colcorr = item_bias - log_q`` per candidate column. The kernels
never write the [Bq, Bk] logits; the plain versions (``*_reference``)
form them ~1 GiB of query rows at a time, and the wrappers run them only
for CPU tensors.

The backward (:func:`flash_ce_bwd`) is picked by the operand type, on
H100 measurements, not by the TPU package's partials cap: bf16 operands
take the two-kernel backward (a query-major dU kernel and a
candidate-major dV/dcol kernel on wgmma, each recomputing the logits),
fp32 operands the fused kernel on the FMA units (6 Bq Bk D products
against the two kernels' 8). A kernel row has a CUDA kernel only for the
operand types a route takes it in; a CUDA call of a wrapper in another
type raises.
What differs from the TPU kernels: the tiles need not divide the batch
(ragged rows and candidates are masked).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.utils.debug import kernel_nan_check
from recsys_tpu_torch.utils.trace import span

NEG_BIG = -1e9
# tile sizes of csrc/flash_ce.cu (TQ: the query tile that the fused
# backward's plan counts; the fused backward, of fp32 operands, takes
# candidate tiles of TKC, or of TK at D > 128; rows 4, 6 and 7 of bf16
# operands blocks of WG_OWN rows of their own axis (query rows for rows 4
# and 6, candidates for row 7) sweeping tiles of WG_TILE rows of the
# other; row 4 of fp32 operands query blocks of F32_TQ rows and candidate
# tiles of F32_FWD_TK, 64 and 64 at D > 128)
TQ = 64
TK = 64
TKC = 128
WG_OWN = 128
WG_TILE = 128
F32_TQ = 128
F32_FWD_TK = 128
MAX_DIM = 256
# Rows 6 and 7 of bf16 operands hold one block per SM, row 4 two where D <=
# 128 (csrc FwdWg: four consumer warps a sub-partition for its exps) and
# one past it: a grid of their blocks that fills this many waves keeps the
# sweep whole, and a block's own set-up and write-out (its own tile's load,
# the ring's first tiles, the output's store) count as this many of its
# swept tiles
_FULL_WAVES = 4
_BLOCK_TILES = 2
# The TPU package's fused backward keeps one dU partial per candidate
# tile of its own tiling (_tiles); above this many bytes of them
# ([Bk // tk, Bq, D] fp32) it switches to its two-kernel backward: at D =
# 128 the square batch reaches it above ~139k rows when 2,048 divides it,
# far earlier when only a small tile does (fused_bwd_partials_bytes counts
# them, for parity). The port's backward routes by operand type instead
# (flash_ce_bwd), and the port's own partials (bwd_plan, du_plan, dv_plan,
# fwd_plan) never exceed the cap. The value is the JAX package's,
# set from a TPU v5e measurement.
_FUSED_BWD_PARTIALS_CAP = int(4.5 * 1024**3)
# the TPU's preferred (query, candidate) tiles, copied to count its partials
_TQ_PREF = 1024
_TK_PREF = 2048


def _tile(b: int, pref: int = 512) -> int:
    """The TPU's tile of an axis of ``b``: the largest of ``pref``, 512,
    256, ..., 8 (at most ``pref``) that divides ``b``, else ``b``."""
    for t in (pref, 512, 256, 128, 64, 32, 16, 8):
        if t <= pref and b % t == 0:
            return t
    return b


def _tiles(bq: int, bk: int) -> Tuple[int, int]:
    """The TPU's (tq, tk) for a [Bq, Bk] problem, as ``flash_ce._tiles``."""
    tq, tk = _tile(bq, _TQ_PREF), _tile(bk, _TK_PREF)
    while tq * tk * 4 > 8 * 1024 * 1024 and tq > 512 and bq % (tq // 2) == 0:
        tq //= 2
    return tq, tk


# query rows of [rows, Bk] fp32 logits the plain versions form at a time
# (~1 GiB), so they run at the main path's 131,072 x 262,144 as well
_REF_CHUNK_BYTES = 1 << 30


def _row_chunks(bq: int, bk: int):
    step = max(1, _REF_CHUNK_BYTES // (4 * bk))
    for lo in range(0, bq, step):
        yield slice(lo, min(bq, lo + step))


def _masked_logits(u, v, colcorr, ids_q, ids_k, pos):
    """The [Bq, Bk] fp32 logits of the kernels' contract: fp32 products of
    the (bf16 or fp32) operands, + colcorr, accidental -1e9."""
    s = torch.matmul(u.float(), v.float().T) + colcorr[None, :]
    col = torch.arange(v.shape[0], device=v.device)
    accidental = (ids_q[:, None] == ids_k[None, :]) & (col[None, :] != pos[:, None])
    return torch.where(accidental, torch.full_like(s, NEG_BIG), s)


def flash_ce_fwd_reference(u, v, colcorr, ids_q, ids_k, pos
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel (``_dense_ref_fwd``):
    -> (lse [Bq], positive logit [Bq]), fp32, over chunks of query rows."""
    lse, pos_logit = [], []
    for r in _row_chunks(u.shape[0], v.shape[0]):
        s = _masked_logits(u[r], v, colcorr, ids_q[r], ids_k, pos[r])
        lse.append(torch.logsumexp(s, dim=-1))
        pos_logit.append(torch.gather(s, 1, pos[r].long()[:, None])[:, 0])
    return torch.cat(lse), torch.cat(pos_logit)


def _split_waves(n_tiles: int, blocks: int, max_parts: int, n_sm: int) -> Tuple[int, int]:
    """The swept axis's ``n_tiles`` tiles split into parts for the FMA
    forward of fp32 operands, which holds one block per SM: of the splits
    that give a grid of ``blocks`` blocks per part 2 to 8 blocks per SM (as
    many as the tiles and ``max_parts`` allow), the one whose last wave ends
    first (waves of ``n_sm`` blocks times tiles per part), and of those the
    fewest parts; no part is empty. -> (parts, tiles per part)."""
    top = max(1, min(n_tiles, max_parts))
    lo = min(top, -(-2 * n_sm // blocks))
    hi = min(top, max(lo, -(-8 * n_sm // blocks)))
    # for each p, the fewest parts of ceil(n_tiles / p) tiles: none empty
    splits = {-(-n_tiles // -(-n_tiles // p)) for p in range(lo, hi + 1)}
    parts = min(splits, key=lambda q: (-(-blocks * q // n_sm) * -(-n_tiles // q), q))
    return parts, -(-n_tiles // parts)


def _split_resident(n_tiles: int, blocks: int, max_parts: int, slots: int
                    ) -> Tuple[int, int]:
    """The swept axis's ``n_tiles`` tiles split into parts for a kernel of
    bf16 operands (rows 4, 6 and 7) whose blocks run ``slots`` at a time
    (SMs x the blocks an SM holds): one part where the ``blocks`` blocks
    alone fill ``_FULL_WAVES`` waves of ``slots``; else, of the splits up to
    8 blocks a slot (as many as the tiles and ``max_parts`` allow), the one
    whose last wave ends first, counted as waves x (tiles per part +
    ``_BLOCK_TILES``), and of those the fewest parts; no part is empty. ->
    (parts, tiles per part)."""
    top = max(1, min(n_tiles, max_parts, 8 * slots // blocks))
    if blocks >= _FULL_WAVES * slots or top == 1:
        return 1, n_tiles
    # for each p, the fewest parts of ceil(n_tiles / p) tiles: none empty
    splits = {-(-n_tiles // -(-n_tiles // p)) for p in range(1, top + 1)}
    parts = min(splits, key=lambda q: (-(-blocks * q // slots) * (-(-n_tiles // q) + _BLOCK_TILES),
                                       q))
    return parts, -(-n_tiles // parts)


class FwdPlan(NamedTuple):
    """How the forward cuts [Bq, Bk]: blocks of ``tile`` query rows, each
    sweeping ``tiles_per_part`` candidate tiles of ``ktile`` in one of
    ``parts`` parts of the candidate axis. Partials: (m, l, positive
    logit) ``[3, parts, Bq]`` fp32, combined in part order (none with one
    part: the kernel writes lse and the positive logit)."""
    tile: int
    ktile: int
    parts: int
    tiles_per_part: int

    def partials_bytes(self, bq: int) -> int:
        return 12 * self.parts * bq if self.parts > 1 else 0


def fwd_plan(bq: int, bk: int, bf16: bool, n_sm: int, d: Optional[int] = None) -> FwdPlan:
    """The forward's tiling on a card of ``n_sm`` SMs at width ``d``
    (required). bf16 operands (the wgmma kernel fed by TMA; the logits need
    all of D, so it takes no column slices): blocks of 128 query rows and
    128-candidate tiles, two blocks an SM where D <= 128 and one past it,
    the candidate sweep split by :func:`_split_resident` (4 parts at
    8,192^2, 8 at 4,096 x 20,480, 5 at 20,000^2, one at 131,072 x 262,144:
    no partials). fp32 operands (the FMA kernel, one block per SM): 128-row
    blocks and 128-candidate tiles (64 and 64 at D > 128), the sweep split
    by :func:`_split_waves` (8 parts at 8,192^2). Either way no more parts
    than keep the partials under ``_FUSED_BWD_PARTIALS_CAP``, and no part is
    empty."""
    if d is None:
        raise ValueError("fwd_plan: the tiles and the blocks an SM holds depend on d")
    max_parts = _FUSED_BWD_PARTIALS_CAP // (12 * bq)
    if bf16:
        per_sm = 2 if d <= 128 else 1
        return FwdPlan(WG_OWN, WG_TILE, *_split_resident(-(-bk // WG_TILE), -(-bq // WG_OWN),
                                                         max_parts, per_sm * n_sm))
    tile = F32_TQ if d <= 128 else 64
    ktile = F32_FWD_TK if d <= 128 else 64
    return FwdPlan(tile, ktile, *_split_waves(-(-bk // ktile), -(-bq // tile), max_parts, n_sm))


def flash_ce_fwd_partials_reference(u, v, colcorr, ids_q, ids_k, pos, p: FwdPlan
                                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of what the forward kernel writes under plan ``p``,
    over the whole [Bq, Bk] logits at once (small shapes): per part of the
    candidate axis the running max ``m`` (from -1e9, as the kernel starts
    it), the sum-exp ``l`` under it and the positive logit (0 where the
    positive column lies in another part) -> (m, l, positive logit), each
    [parts, Bq] fp32; :func:`combine_fwd_partials` of them is the forward."""
    s = _masked_logits(u, v, colcorr, ids_q, ids_k, pos)
    is_pos = torch.arange(v.shape[0], device=v.device)[None, :] == pos[:, None].long()
    span = p.ktile * p.tiles_per_part
    m, l, pos_logit = [], [], []
    for lo in range(0, p.parts * span, span):
        part = s[:, lo:lo + span]
        mp = torch.clamp(part.max(dim=1).values, min=NEG_BIG)
        m.append(mp)
        l.append(torch.exp(part - mp[:, None]).sum(dim=1))
        pos_logit.append(torch.where(is_pos[:, lo:lo + span], part, 0.0).sum(dim=1))
    return torch.stack(m), torch.stack(l), torch.stack(pos_logit)


def combine_fwd_partials(m, l, pos_logit) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward's combine kernel, over [parts, Bq]
    partials: lse = M + log(max(L, 1e-30)) with M = max_p m_p and L = sum_p
    l_p exp(m_p - M); the positive logit is the sum over the parts (one
    holds the positive column) -> (lse [Bq], positive logit [Bq])."""
    mx = m.max(dim=0).values
    total = (l * torch.exp(m - mx[None, :])).sum(dim=0)
    return mx + torch.log(torch.clamp(total, min=1e-30)), pos_logit.sum(dim=0)


def _bwd_reference(u, v, colcorr, ids_q, ids_k, pos, lse, g, want_du: bool,
                   want_dv: bool) -> Tuple[Optional[torch.Tensor], ...]:
    """The softmax part of the backward over chunks of query rows: dU
    chunk by chunk, dV and dcol summed over the chunks (one chunk, a
    single sum, up to ~1 GiB of logits). Both products take ``p*g``
    rounded to the operand type; dcol sums the fp32 ``p*g``.
    -> (dU [Bq, D] or None, dV [Bk, D] or None, dcol [Bk] or None)."""
    bk, d = v.shape
    vf = v.float()
    du = []
    dv = torch.zeros((bk, d), dtype=torch.float32, device=v.device) if want_dv else None
    dcol = torch.zeros((bk,), dtype=torch.float32, device=v.device) if want_dv else None
    for r in _row_chunks(u.shape[0], bk):
        s = _masked_logits(u[r], v, colcorr, ids_q[r], ids_k, pos[r])
        pg32 = torch.exp(s - lse[r, None]) * g[r, None]
        del s
        pg = pg32.to(u.dtype).float()
        if want_du:
            du.append(pg @ vf)
        if want_dv:
            dv += pg.T @ u[r].float()
            dcol += pg32.sum(dim=0)
    return (torch.cat(du) if want_du else None), dv, dcol


def flash_ce_bwd_reference(u, v, colcorr, ids_q, ids_k, pos, lse, g
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fused backward kernel (the softmax part, before
    the label terms): -> (dU [Bq, D], dV [Bk, D], dcol [Bk]), fp32. As in
    the kernel, dcol sums the fp32 ``p*g`` and both products take ``p*g``
    rounded to the operand type."""
    return _bwd_reference(u, v, colcorr, ids_q, ids_k, pos, lse, g, True, True)


def flash_ce_bwd_du_reference(u, v, colcorr, ids_q, ids_k, pos, lse, g) -> torch.Tensor:
    """Plain version of the dU kernel (row 6, ``_bwd_du_kernel``): -> dU
    [Bq, D] fp32, the products of ``p*g`` rounded to the operand type."""
    return _bwd_reference(u, v, colcorr, ids_q, ids_k, pos, lse, g, True, False)[0]


def flash_ce_bwd_dv_reference(u, v, colcorr, ids_q, ids_k, pos, lse, g
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dV/dcol kernel (row 7, ``_bwd_dv_kernel``): ->
    (dV [Bk, D], dcol [Bk]) fp32; dcol sums the fp32 ``p*g``."""
    return _bwd_reference(u, v, colcorr, ids_q, ids_k, pos, lse, g, False, True)[1:]


def _check(u, v, colcorr, ids_q, ids_k, pos, what: str) -> None:
    if u.dim() != 2 or v.dim() != 2 or v.shape[1] != u.shape[1]:
        raise ValueError(f"{what}: want u [Bq, D], v [Bk, D]; got {tuple(u.shape)}, "
                         f"{tuple(v.shape)}")
    bq, d = u.shape
    bk = v.shape[0]
    if bq == 0 or bk == 0 or not 1 <= d <= MAX_DIM:
        raise ValueError(f"{what}: want Bq, Bk >= 1 and 1 <= D <= {MAX_DIM}; got "
                         f"{bq}, {bk}, {d}")
    if u.dtype != v.dtype or u.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: u and v must both be fp32 or both bf16, got "
                         f"{u.dtype}, {v.dtype}")
    for name, t, n, dtype in (("colcorr", colcorr, bk, torch.float32),
                              ("ids_q", ids_q, bq, torch.int32),
                              ("ids_k", ids_k, bk, torch.int32),
                              ("pos", pos, bq, torch.int32)):
        if t.shape != (n,) or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype} [{n}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("u", u), ("v", v), ("colcorr", colcorr), ("ids_q", ids_q),
                    ("ids_k", ids_k), ("pos", pos)):
        if t.device != u.device:
            raise ValueError(f"{what}: {name} on {t.device}, u on {u.device}")


@functools.lru_cache(maxsize=None)
def _fwd_launcher():
    fn = _build.load_library().flash_ce_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = _build.load_library().flash_ce_bwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_du_launcher():
    fn = _build.load_library().flash_ce_bwd_du
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_dv_launcher():
    fn = _build.load_library().flash_ce_bwd_dv
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


def _on_cuda(u, what: str) -> bool:
    if u.device.type == "cpu":
        return False
    if u.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {u.device}")
    return True


@kernel_nan_check("kernel row 4 flash_ce_fwd (the in-batch softmax CE forward)")
def flash_ce_fwd(u: torch.Tensor, v: torch.Tensor, colcorr: torch.Tensor,
                 ids_q: torch.Tensor, ids_k: torch.Tensor, pos: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 4 (``_fwd_kernel``): -> (lse [Bq], positive logit [Bq]) fp32.
    ``u``, ``v`` fp32 or bf16, ``colcorr`` fp32 [Bk], ids and ``pos``
    int32. The block that owns a query block sweeps the candidate tiles of
    its part (:func:`fwd_plan`; bf16 operands on wgmma fed by TMA, fp32 on
    the FMA units); with more than one part a combine kernel, launched by
    the same host call, folds the parts' partials in part order. bf16 rows
    whose D is not a multiple of 8, or that do not start on 16 bytes, go to
    the kernel as padded copies (:func:`_tma_rows`). At D = 128 on an
    NVIDIA H100 80GB HBM3 (700 W) the bf16 kernel takes 0.064 device ms at
    8,192^2 and 28.4-28.6 at 131,072 x 262,144 (its mma.sync design, which
    it replaced: 0.124-0.125 and 56.6-56.9).

    CPU tensors take :func:`flash_ce_fwd_reference`; CUDA tensors launch
    the kernel or raise."""
    _check(u, v, colcorr, ids_q, ids_k, pos, "flash_ce_fwd")
    if not _on_cuda(u, "flash_ce_fwd"):
        return flash_ce_fwd_reference(u, v, colcorr, ids_q, ids_k, pos)
    bq, bk = u.shape[0], v.shape[0]
    u, v = u.contiguous(), v.contiguous()
    colcorr, ids_q, ids_k, pos = (t.contiguous() for t in (colcorr, ids_q, ids_k, pos))
    bf16 = u.dtype == torch.bfloat16
    cols = None
    if bf16:
        u, v = _tma_rows(u), _tma_rows(v)
        cols = torch.empty((-(-bk // WG_TILE) * WG_TILE, 2), dtype=torch.float32,
                           device=u.device)
    dk = u.shape[1]
    p = fwd_plan(bq, bk, bf16, _sm_count(u.device.index), dk)
    lse = torch.empty((bq,), dtype=torch.float32, device=u.device)
    pos_logit = torch.empty_like(lse)
    part = (torch.empty((3, p.parts, bq), dtype=torch.float32, device=u.device)
            if p.parts > 1 else None)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd_launcher()(u.data_ptr(), v.data_ptr(), colcorr.data_ptr(),
                              ids_q.data_ptr(), ids_k.data_ptr(), pos.data_ptr(),
                              bq, bk, dk, int(bf16), p.parts, p.tiles_per_part,
                              _vec(u, v), lse.data_ptr(), pos_logit.data_ptr(),
                              None if part is None else part.data_ptr(),
                              None if cols is None else cols.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_ce_fwd kernel launch failed: cudaError {err}")
    flash_ce_fwd.launches += 1
    return lse, pos_logit


flash_ce_fwd.launches = 0


def fused_bwd_partials_bytes(bq: int, bk: int, d: int) -> int:
    """Bytes of dU partials the TPU's fused backward keeps, ``[Bk // tk,
    Bq, D]`` fp32 with its own ``tk`` (``_tiles``): what
    ``_FUSED_BWD_PARTIALS_CAP`` bounds."""
    _, tk = _tiles(bq, bk)
    return bq * d * (bk // tk) * 4


class BwdPlan(NamedTuple):
    """How the fused backward cuts [Bq, Bk]: each of ``n_spans`` blocks
    along the candidates owns ``tiles_per_block`` candidate tiles of
    ``tile``, and the query sweep is split into ``parts`` of
    ``q_tiles_per_part`` 64-row tiles. Partials: dU ``[n_spans, Bq, D]``,
    dV ``[parts, Bk, D]``, dcol ``[parts, Bk]``, all fp32."""
    tile: int
    tiles_per_block: int
    parts: int
    q_tiles_per_part: int
    n_spans: int

    def partials_bytes(self, bq: int, bk: int, d: int) -> int:
        """Bytes of the partials (one part of dV and dcol is the output)."""
        dv = self.parts * bk * (d + 1) if self.parts > 1 else 0
        return 4 * (self.n_spans * bq * d + dv)


def bwd_plan(bq: int, bk: int, d: int, n_sm: int) -> BwdPlan:
    """The fused backward's tiling on a card of ``n_sm`` SMs (its kernel
    takes fp32 operands, on the FMA units): candidate tiles of ``TKC``
    (``TK`` at D > 128, where the kernel's 128 candidate rows would not fit
    its shared memory beside its query tile), one a block while the
    partials fit ``_FUSED_BWD_PARTIALS_CAP``, else the fewest that keep
    them under it; the query sweep split into enough parts that the grid
    holds about two blocks per SM (8,192^2 at D = 128: 64 spans x 4
    parts); no part is empty. The kernel holds one block per SM, so
    :func:`_fp32_waves` then looks for a split that ends sooner."""
    tile = TK if d > 128 else TKC
    n_qt = -(-bq // TQ)
    n_tiles = -(-bk // tile)
    tpb = -(-n_tiles // min(n_tiles, max(1, _FUSED_BWD_PARTIALS_CAP // (bq * d * 4))))
    def with_parts(n_spans: int, parts: int) -> BwdPlan:
        qpp = -(-n_qt // max(1, min(n_qt, parts)))
        return BwdPlan(tile, tpb, -(-n_qt // qpp), qpp, n_spans)

    while True:
        n_spans = -(-n_tiles // tpb)
        p = with_parts(n_spans, (2 * n_sm) // n_spans)
        if p.partials_bytes(bq, bk, d) <= _FUSED_BWD_PARTIALS_CAP:
            break
        if tpb >= n_tiles:  # one span: as many query parts as still fit
            while p.parts > 1 and p.partials_bytes(bq, bk, d) > _FUSED_BWD_PARTIALS_CAP:
                p = with_parts(n_spans, p.parts - 1)
            break
        tpb += 1
    return _fp32_waves(p, bq, bk, d, n_sm)


def _fp32_waves(p: BwdPlan, bq: int, bk: int, d: int, n_sm: int) -> BwdPlan:
    """The fp32 fused kernel's plan: ``p``, unless another split of the
    candidate tiles into spans (up to 4 times as many tiles a block) and of
    the query sweep into parts ends its last wave at least 10% sooner,
    counted as waves of one block per SM x candidate tiles a block x the
    kernel's query tiles (128 rows, 64 at D > 128) a part, with at most 8
    blocks per SM and the partials under ``_FUSED_BWD_PARTIALS_CAP``; the
    count leaves out the partials' sums and each block's staging, so a
    smaller gain keeps ``p``. Of the splits that qualify, the soonest, then
    the fewest parts and tiles a block. At D = 128: 20,000^2 goes from 157
    spans in 1 part (2 waves of 157 query tiles) to 5 parts (6 waves of
    32); 8,192^2 keeps 64 spans x 4 parts."""
    step = 2 if d <= 128 else 1  # the kernel's query tile in the plan's 64-row tiles
    n_qt = -(-bq // TQ)
    n_tiles = -(-bk // p.tile)

    def cost(q: BwdPlan) -> int:
        return -(-q.n_spans * q.parts // n_sm) * q.tiles_per_block * -(-q.q_tiles_per_part // step)

    best, best_cost = p, cost(p)
    for tpb in range(p.tiles_per_block, min(n_tiles, 4 * p.tiles_per_block) + 1):
        n_spans = -(-n_tiles // tpb)
        for parts in range(1, min(-(-n_qt // step), 8 * n_sm // n_spans) + 1):
            qpp = step * -(-n_qt // (step * parts))
            q = BwdPlan(p.tile, tpb, -(-n_qt // qpp), qpp, n_spans)
            if (10 * cost(q) <= 9 * cost(p)
                    and q.partials_bytes(bq, bk, d) <= _FUSED_BWD_PARTIALS_CAP
                    and (best is p or (cost(q), q.parts, tpb)
                         < (best_cost, best.parts, best.tiles_per_block))):
                best, best_cost = q, cost(q)
    return best


def sum_partials(du_part: torch.Tensor, dv_part: torch.Tensor, dcol_part: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused backward's partials summed over their first axis, in a
    fixed order (``torch.sum``; no atomics) -> (dU, dV, dcol)."""
    return tuple(t[0] if t.shape[0] == 1 else torch.sum(t, dim=0)
                 for t in (du_part, dv_part, dcol_part))


def flash_ce_bwd_partials_reference(u, v, colcorr, ids_q, ids_k, pos, lse, g, p: BwdPlan
                                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of what the fused kernel writes under plan ``p``,
    over the whole [Bq, Bk] logits at once (small shapes): -> (dU
    partials [n_spans, Bq, D], dV partials [parts, Bk, D], dcol partials
    [parts, Bk]), fp32; :func:`sum_partials` of them is the backward."""
    pg32 = torch.exp(_masked_logits(u, v, colcorr, ids_q, ids_k, pos) - lse[:, None]) * g[:, None]
    pg = pg32.to(u.dtype).float()
    return (_du_parts(pg, v.float(), p.tile * p.tiles_per_block, p.n_spans),
            *_dv_parts(pg32, pg, u.float(), p.q_tiles_per_part * TQ, p.parts))


def _du_parts(pg, vf, cols: int, parts: int) -> torch.Tensor:
    """dU of each of ``parts`` consecutive parts of ``cols`` candidates ->
    [parts, Bq, D] fp32."""
    return torch.stack([pg[:, lo:lo + cols] @ vf[lo:lo + cols]
                        for lo in range(0, parts * cols, cols)])


def _dv_parts(pg32, pg, uf, rows: int, parts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """dV and dcol of each of ``parts`` consecutive parts of ``rows`` query
    rows -> ([parts, Bk, D], [parts, Bk]) fp32."""
    q_parts = range(0, parts * rows, rows)
    return (torch.stack([pg[lo:lo + rows].T @ uf[lo:lo + rows] for lo in q_parts]),
            torch.stack([pg32[lo:lo + rows].sum(dim=0) for lo in q_parts]))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _bwd_args(u, v, colcorr, ids_q, ids_k, pos, lse, g, what: str) -> tuple:
    """Checked backward inputs, contiguous when they will reach a kernel."""
    _check(u, v, colcorr, ids_q, ids_k, pos, what)
    bq = u.shape[0]
    for name, t in (("lse", lse), ("g", g)):
        if t.shape != (bq,) or t.dtype != torch.float32 or t.device != u.device:
            raise ValueError(f"{what}: {name} must be fp32 [{bq}] on {u.device}")
    args = (u, v, colcorr, ids_q, ids_k, pos, lse, g)
    if not _on_cuda(u, what):
        return args
    return tuple(t.contiguous() for t in args)


def _ptrs(args) -> list:
    return [t.data_ptr() for t in args]


def _vec(u, v) -> int:
    """1 where u and v rows are whole 16-byte units from 16 bytes on (D a
    multiple of 8 bf16 or 4 fp32 values, both starting on 16 bytes), else 0:
    the fp32 kernels then copy rows element by element, not by 16-byte
    ``cp.async``; the bf16 kernels, fed by TMA, take only such rows
    (:func:`_tma_rows`)."""
    return int(u.shape[1] % (16 // u.element_size()) == 0
               and u.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)


def _tma_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` [n, D] bf16 as the TMA of rows 4, 6 and 7 reads it: itself where D
    is a multiple of 8 and it starts on 16 bytes, else a copy with zero
    columns up to the next multiple of 8, which add nothing to any
    product."""
    n, d = t.shape
    d8 = -(-d // 8) * 8
    if d8 == d and t.data_ptr() % 16 == 0:
        return t
    out = torch.zeros((n, d8), dtype=t.dtype, device=t.device)
    out[:, :d] = t
    return out


@kernel_nan_check("kernel row 5 flash_ce_bwd_fused (its fused backward)")
def flash_ce_bwd_fused(u: torch.Tensor, v: torch.Tensor, colcorr: torch.Tensor,
                       ids_q: torch.Tensor, ids_k: torch.Tensor, pos: torch.Tensor,
                       lse: torch.Tensor, g: torch.Tensor,
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused backward (row 5, ``_flash_bwd_fused_raw``) at any shape:
    -> (dU [Bq, D], dV [Bk, D], dcol [Bk]) fp32, the softmax part before
    the label terms; ``lse`` and ``g`` fp32 [Bq].

    CPU tensors, of either operand type, take
    :func:`flash_ce_bwd_reference`; CUDA tensors launch the FMA kernel
    (fp32 operands only: bf16 ones raise; one sweep on :func:`bwd_plan`),
    its partials summed here by :func:`sum_partials`, or raise."""
    args = _bwd_args(u, v, colcorr, ids_q, ids_k, pos, lse, g, "flash_ce_bwd_fused")
    if not _on_cuda(u, "flash_ce_bwd_fused"):
        return flash_ce_bwd_reference(*args)
    if u.dtype != torch.float32:
        raise ValueError("flash_ce_bwd_fused: on CUDA only fp32 operands have a fused kernel; "
                         "bf16 operands take flash_ce_bwd_twokernel")
    u, v = args[:2]
    bq, d = u.shape
    bk = v.shape[0]
    p = bwd_plan(bq, bk, d, _sm_count(u.device.index))
    f32 = dict(dtype=torch.float32, device=u.device)
    du_part = torch.empty((p.n_spans, bq, d), **f32)
    dv_part = torch.empty((p.parts, bk, d), **f32)
    dcol_part = torch.empty((p.parts, bk), **f32)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_launcher()(*_ptrs(args), bq, bk, d, p.tiles_per_block,
                              p.parts, p.q_tiles_per_part, _vec(u, v), dv_part.data_ptr(),
                              dcol_part.data_ptr(), du_part.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_ce_bwd_fused kernel launch failed: cudaError {err}")
    flash_ce_bwd_fused.launches += 1
    return sum_partials(du_part, dv_part, dcol_part)


flash_ce_bwd_fused.launches = 0


class DuPlan(NamedTuple):
    """How row 6 cuts [Bq, Bk]: blocks of ``tile`` query rows, each sweeping
    ``tiles_per_part`` candidate tiles of ``ktile`` in one of ``parts``
    parts of the candidate axis. Partials: dU ``[parts, Bq, D]`` fp32,
    summed in a fixed order (none with one part: the kernel writes dU)."""
    tile: int
    ktile: int
    parts: int
    tiles_per_part: int

    def partials_bytes(self, bq: int, d: int) -> int:
        return 4 * self.parts * bq * d if self.parts > 1 else 0


def du_plan(bq: int, bk: int, d: int, n_sm: int) -> DuPlan:
    """Row 6's tiling on a card of ``n_sm`` SMs (its wgmma kernel takes bf16
    operands and holds one block per SM): blocks of 128 query rows (two
    column slices past D = 128) and 128-candidate tiles, the candidate
    sweep split by :func:`_split_resident` into parts, no more than the
    candidate tiles and no more than keep the dU partials under
    ``_FUSED_BWD_PARTIALS_CAP``; no part is empty (2 parts at 8,192^2, 5 at
    20,000^2, one at 131,072 x 262,144: 1,024 blocks, 7.76 waves, 34.9
    kernel ms on an H100 against 38.0 in two parts)."""
    max_parts = _FUSED_BWD_PARTIALS_CAP // (4 * bq * d)
    blocks = -(-bq // WG_OWN) * (2 if d > 128 else 1)
    return DuPlan(WG_OWN, WG_TILE, *_split_resident(-(-bk // WG_TILE), blocks, max_parts, n_sm))


def du_cols_reference(colcorr: torch.Tensor, ids_k: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Plain version of row 6's column inputs (``flash_ce_du_cols_kernel``)
    over ``n_cols`` >= Bk columns, the candidate tiles' padded length: ->
    [n_cols, 2] fp32, (colcorr, the bits of ids_k) per candidate and (-inf,
    0) past Bk, where the kernel's V rows are zero; a logit there is -inf
    (or -1e9 where the id hits), so its p*g is 0."""
    bk = colcorr.shape[0]
    cols = torch.zeros((n_cols, 2), dtype=torch.float32, device=colcorr.device)
    cols[:bk, 0] = colcorr
    cols[bk:, 0] = float("-inf")
    cols[:bk, 1] = ids_k.to(torch.int32).view(torch.float32)
    return cols


def flash_ce_bwd_du_partials_reference(u, v, colcorr, ids_q, ids_k, pos, lse, g, p: DuPlan
                                       ) -> torch.Tensor:
    """Plain version of what row 6's kernel writes under plan ``p``, over
    the whole [Bq, Bk] logits at once (small shapes): -> dU partials
    [parts, Bq, D] fp32, one per part of the candidate axis (``p*g``
    rounded to the operand type, as the kernel); their sum over the first
    axis is dU. The candidates run to the plan's whole tiles, as the kernel
    reads them: zero rows of V past Bk, their columns from
    :func:`du_cols_reference`."""
    n = p.ktile * p.tiles_per_part * p.parts
    cols = du_cols_reference(colcorr, ids_k, n)
    vp = torch.zeros((n, v.shape[1]), dtype=v.dtype, device=v.device)
    vp[:v.shape[0]] = v
    s = _masked_logits(u, vp, cols[:, 0], ids_q, cols[:, 1].view(torch.int32), pos)
    pg32 = torch.exp(s - lse[:, None]) * g[:, None]
    return _du_parts(pg32.to(u.dtype).float(), vp.float(), p.ktile * p.tiles_per_part, p.parts)


@kernel_nan_check("kernel row 6 flash_ce_bwd_du (its backward's dU)")
def flash_ce_bwd_du(u: torch.Tensor, v: torch.Tensor, colcorr: torch.Tensor,
                    ids_q: torch.Tensor, ids_k: torch.Tensor, pos: torch.Tensor,
                    lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Row 6 (``_bwd_du_kernel``): -> dU [Bq, D] fp32, query-major: the
    block that owns a query block sweeps the candidate tiles of its part
    (:func:`du_plan`; on wgmma fed by TMA), the parts summed here in a
    fixed order. Rows whose D is not a multiple of 8, or that do not start
    on 16 bytes, go to the kernel as padded copies (:func:`_tma_rows`). At
    D = 128 on an NVIDIA H100 80GB HBM3 (700 W) the kernel takes 0.073 ms
    at 8,192^2 and 34.4-35.2 ms at 131,072 x 262,144 (its mma.sync design,
    which it replaced: 0.212-0.214 and 97.8-98.1).

    CPU tensors, of either operand type, take
    :func:`flash_ce_bwd_du_reference`; CUDA tensors launch the kernel (bf16
    operands only: fp32 ones raise) or raise."""
    args = _bwd_args(u, v, colcorr, ids_q, ids_k, pos, lse, g, "flash_ce_bwd_du")
    if not _on_cuda(u, "flash_ce_bwd_du"):
        return flash_ce_bwd_du_reference(*args)
    if u.dtype != torch.bfloat16:
        raise ValueError("flash_ce_bwd_du: on CUDA only bf16 operands have a dU kernel; "
                         "fp32 operands take flash_ce_bwd_fused")
    bq, d = u.shape
    bk = v.shape[0]
    args = (_tma_rows(args[0]), _tma_rows(args[1]), *args[2:])
    cols = torch.empty((-(-bk // WG_TILE) * WG_TILE, 2), dtype=torch.float32, device=u.device)
    u, v = args[:2]
    dk = u.shape[1]
    p = du_plan(bq, bk, dk, _sm_count(u.device.index))
    du_part = torch.empty((p.parts, bq, dk), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_du_launcher()(*_ptrs(args), bq, bk, dk, p.parts, p.tiles_per_part,
                                 _vec(u, v), du_part.data_ptr(), cols.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_ce_bwd_du kernel launch failed: cudaError {err}")
    flash_ce_bwd_du.launches += 1
    du = du_part[0] if p.parts == 1 else torch.sum(du_part, dim=0)
    return du if dk == d else du[:, :d].contiguous()


flash_ce_bwd_du.launches = 0


class DvPlan(NamedTuple):
    """How row 7 cuts [Bq, Bk]: blocks of ``tile`` candidates, each sweeping
    ``q_tiles_per_part`` query tiles of ``qtile`` in one of ``parts`` parts
    of the query axis. Partials: dV ``[parts, Bk, D]`` and dcol ``[parts,
    Bk]`` fp32, summed in a fixed order (none with one part: the kernel
    writes dV and dcol)."""
    tile: int
    qtile: int
    parts: int
    q_tiles_per_part: int

    def partials_bytes(self, bk: int, d: int) -> int:
        return 4 * self.parts * bk * (d + 1) if self.parts > 1 else 0


def dv_plan(bq: int, bk: int, d: int, n_sm: int) -> DvPlan:
    """Row 7's tiling on a card of ``n_sm`` SMs (its wgmma kernel takes bf16
    operands and holds one block per SM): blocks of 128 candidates (two
    column slices past D = 128) and 128-row query tiles, the query sweep
    split by :func:`_split_resident` into parts, no more than the query
    tiles and no more than keep the dV and dcol partials under
    ``_FUSED_BWD_PARTIALS_CAP``; no part is empty (2 parts at 8,192^2, one
    at 131,072 x 262,144)."""
    max_parts = _FUSED_BWD_PARTIALS_CAP // (4 * bk * (d + 1))
    blocks = -(-bk // WG_OWN) * (2 if d > 128 else 1)
    return DvPlan(WG_OWN, WG_TILE, *_split_resident(-(-bq // WG_TILE), blocks, max_parts, n_sm))


def flash_ce_bwd_dv_partials_reference(u, v, colcorr, ids_q, ids_k, pos, lse, g, p: DvPlan
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of what row 7's kernel writes under plan ``p``, over
    the whole [Bq, Bk] logits at once (small shapes): -> (dV partials
    [parts, Bk, D], dcol partials [parts, Bk]) fp32, one per part of the
    query axis; their sums over the first axis are dV and dcol."""
    pg32 = torch.exp(_masked_logits(u, v, colcorr, ids_q, ids_k, pos) - lse[:, None]) * g[:, None]
    return _dv_parts(pg32, pg32.to(u.dtype).float(), u.float(), p.qtile * p.q_tiles_per_part,
                     p.parts)


@kernel_nan_check("kernel row 7 flash_ce_bwd_dv (its backward's dV and dcol)")
def flash_ce_bwd_dv(u: torch.Tensor, v: torch.Tensor, colcorr: torch.Tensor,
                    ids_q: torch.Tensor, ids_k: torch.Tensor, pos: torch.Tensor,
                    lse: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 7 (``_bwd_dv_kernel``): -> (dV [Bk, D], dcol [Bk]) fp32,
    candidate-major: the block that owns a candidate block sweeps the query
    tiles of its part (:func:`dv_plan`; on wgmma fed by TMA), the parts
    summed here in a fixed order. Rows whose D is not a multiple of 8, or
    that do not start on 16 bytes, go to the kernel as padded copies
    (:func:`_tma_rows`).

    CPU tensors, of either operand type, take
    :func:`flash_ce_bwd_dv_reference`; CUDA tensors launch the kernel (bf16
    operands only: fp32 ones raise) or raise."""
    args = _bwd_args(u, v, colcorr, ids_q, ids_k, pos, lse, g, "flash_ce_bwd_dv")
    if not _on_cuda(u, "flash_ce_bwd_dv"):
        return flash_ce_bwd_dv_reference(*args)
    if u.dtype != torch.bfloat16:
        raise ValueError("flash_ce_bwd_dv: on CUDA only bf16 operands have a dV kernel; "
                         "fp32 operands take flash_ce_bwd_fused")
    bq, d = u.shape
    bk = v.shape[0]
    args = (_tma_rows(args[0]), _tma_rows(args[1]), *args[2:])
    rows = torch.empty((-(-bq // WG_TILE) * WG_TILE, 4), dtype=torch.float32, device=u.device)
    u, v = args[:2]
    dk = u.shape[1]
    p = dv_plan(bq, bk, dk, _sm_count(u.device.index))
    dv_part = torch.empty((p.parts, bk, dk), dtype=torch.float32, device=u.device)
    dcol_part = torch.empty((p.parts, bk), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_dv_launcher()(*_ptrs(args), bq, bk, dk, p.parts, p.q_tiles_per_part,
                                 _vec(u, v), dv_part.data_ptr(), dcol_part.data_ptr(),
                                 rows.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_ce_bwd_dv kernel launch failed: cudaError {err}")
    flash_ce_bwd_dv.launches += 1
    if p.parts == 1:
        dv, dcol = dv_part[0], dcol_part[0]
    else:
        dv, dcol = torch.sum(dv_part, dim=0), torch.sum(dcol_part, dim=0)
    return (dv if dk == d else dv[:, :d].contiguous()), dcol


flash_ce_bwd_dv.launches = 0


def flash_ce_bwd_twokernel(u, v, colcorr, ids_q, ids_k, pos, lse, g
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two-kernel backward (``_flash_bwd_twokernel_raw``) at any shape:
    -> (dU, dV, dcol) from :func:`flash_ce_bwd_du` and
    :func:`flash_ce_bwd_dv`, whose kernels split their swept axis into
    parts only where their own tiles leave the card thin (:func:`du_plan`,
    :func:`dv_plan`; none at 131,072 x 262,144)."""
    du = flash_ce_bwd_du(u, v, colcorr, ids_q, ids_k, pos, lse, g)
    return (du, *flash_ce_bwd_dv(u, v, colcorr, ids_q, ids_k, pos, lse, g))


def flash_ce_bwd(u: torch.Tensor, v: torch.Tensor, colcorr: torch.Tensor,
                 ids_q: torch.Tensor, ids_k: torch.Tensor, pos: torch.Tensor,
                 lse: torch.Tensor, g: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softmax part of the backward (before the label terms) -> (dU [Bq, D],
    dV [Bk, D], dcol [Bk]) fp32: :func:`flash_ce_bwd_twokernel` for bf16
    operands, :func:`flash_ce_bwd_fused` for fp32 operands."""
    _check(u, v, colcorr, ids_q, ids_k, pos, "flash_ce_bwd")
    # On an H100 each route won at all eight shapes timed for its operand
    # type, the bf16 one by 2.0x to 9.0x, the fp32 one by 23-38% (PERF.md).
    if u.dtype == torch.bfloat16:
        return flash_ce_bwd_twokernel(u, v, colcorr, ids_q, ids_k, pos, lse, g)
    return flash_ce_bwd_fused(u, v, colcorr, ids_q, ids_k, pos, lse, g)


class FlashSoftmaxCE(torch.autograd.Function):
    """Per-row CE [Bq] = lse_i - s_{i,pos_i}, differentiable w.r.t. u, v
    and colcorr (the JAX package's ``flash_softmax_ce`` custom_vjp)."""

    @staticmethod
    def forward(ctx, u, v, colcorr, ids_q, ids_k, pos):
        lse, pos_logit = flash_ce_fwd(u, v, colcorr, ids_q, ids_k, pos)
        ctx.save_for_backward(u, v, colcorr, ids_q, ids_k, pos, lse)
        return lse - pos_logit

    @staticmethod
    def backward(ctx, g):
        with span("loss.retrieval_bwd"):
            u, v, colcorr, ids_q, ids_k, pos, lse = ctx.saved_tensors
            g = g.float().contiguous()
            du, dv, dcol = flash_ce_bwd(u, v, colcorr, ids_q, ids_k, pos, lse, g)
            # positive-column (label) terms, as _flash_ce_bwd adds them
            # outside the kernels: d(-s_{i,pos_i}); pos columns are distinct
            idx = pos.long()
            du = du - g[:, None] * v.float()[idx]
            dv = dv.index_add(0, idx, -g[:, None] * u.float())
            dcol = dcol.index_add(0, idx, -g)
            return du.to(u.dtype), dv.to(v.dtype), dcol, None, None, None


def flash_softmax_ce(u, v, colcorr, ids_q, ids_k, pos) -> torch.Tensor:
    return FlashSoftmaxCE.apply(u, v, colcorr, ids_q, ids_k, pos)


def in_batch_softmax_flash(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    item_ids: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    log_q: Optional[torch.Tensor] = None,
    item_bias: Optional[torch.Tensor] = None,
    axis_name: Optional[str] = None,
    bf16="auto",
    extra_candidates=None,
    mesh_ctx=None,
) -> torch.Tensor:
    """Drop-in equivalent of ``losses.in_batch_softmax`` backed by the
    flash kernels. ``bf16="auto"`` casts u and v to bfloat16 from 8,192
    candidates (the JAX package's threshold, kept for parity: it changes
    the numerics); every reduction stays fp32 inside the kernels.
    ``extra_candidates`` ``(emb [N, D], ids [N], corr [N])`` appends
    negative columns after the in-batch block (the rectangular case).
    With ``axis_name`` (and the ``mesh_ctx`` that resolves it) the in-batch
    block is the global batch: the candidate rows and their column
    corrections of every rank are all-gathered (differentiably, so each
    rank's rows get the sum of every rank's cotangent), and local row i's
    positive is column ``axis_index * B_local + i``; the kernels read a
    per-row ``pos`` and are the same."""
    b = user_emb.shape[0]
    if axis_name is not None and mesh_ctx is None:
        raise ValueError(f"in_batch_softmax_flash over axis {axis_name!r} needs the "
                         "mesh_ctx that resolves it")
    n_data = 1 if axis_name is None else mesh_ctx.axis_size(axis_name)
    n_cand = b * n_data + (extra_candidates[0].shape[0] if extra_candidates is not None else 0)
    if bf16 is True or (bf16 == "auto" and n_cand >= 8192):
        user_emb = user_emb.to(torch.bfloat16)
        item_emb = item_emb.to(torch.bfloat16)
    dev = user_emb.device
    colcorr = torch.zeros((b,), dtype=torch.float32, device=dev)
    if item_bias is not None:
        colcorr = colcorr + item_bias
    if log_q is not None:
        colcorr = colcorr - log_q
    ids = item_ids.to(device=dev, dtype=torch.int32)
    if axis_name is None:
        cand, cand_ids, cand_corr = item_emb, ids, colcorr
        first = 0
    else:
        from recsys_tpu_torch.parallel import collectives

        cand = collectives.all_gather_rows(mesh_ctx, item_emb, axis_name)
        cand_ids = collectives.gather_rows(mesh_ctx, ids, axis_name)
        cand_corr = collectives.all_gather_rows(mesh_ctx, colcorr, axis_name)
        first = mesh_ctx.axis_index(axis_name) * b
    pos = torch.arange(first, first + b, dtype=torch.int32, device=dev)
    if extra_candidates is not None:
        x_emb, x_ids, x_corr = extra_candidates
        cand = torch.cat([cand, x_emb.detach().to(cand.dtype)])
        cand_ids = torch.cat([cand_ids, x_ids.to(dtype=torch.int32)])
        cand_corr = torch.cat([cand_corr, x_corr.float()])
    ce = flash_softmax_ce(user_emb, cand, cand_corr, ids, cand_ids, pos)
    if mask is not None:
        return torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(ce)
