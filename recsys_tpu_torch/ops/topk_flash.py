"""Top-k of ``u . v^T`` without the [Q, N] score matrix (the port of
``recsys_tpu/ops/pallas/topk_flash.py``), two CUDA kernels each beside
its plain PyTorch version:

* :func:`flash_topk` — exact top-k, ``csrc/topk_flash.cu``: stage 1
  scores catalog chunks and keeps each chunk's candidates, stage 2
  (:func:`topk_select`) selects the top k of them. Contract, kept from the TPU kernel: fp32 scoring, slots past N score
  ``NEG_INF`` (so ``k > N`` is allowed), and ``item_bias`` (raw-dot
  scoring only) folds into the dot as ``[u|1] . [v|b]``. Ties at the k
  boundary may resolve to other, equal-scoring, ids than the plain
  version's. What differs: the candidate buffer is k rounded up to a
  power of two, 32 to 256 slots (``KBUF_MAX``), so k <= 256; the TPU's
  lane-width buffer capped k at 128.
* :func:`blockmax_topk` — the group-max sieve: pass 1,
  :func:`blockmax_group_max` (``csrc/blockmax.cu``), keeps each query's
  max over every group of g consecutive items; pass 2 (plain PyTorch, as
  the TPU wrapper leaves it to XLA) gathers the top-k groups' items,
  rescores them and takes the top k. The top-k groups by group max hold
  every top-k item, so the sieve is exact on the scores it computes; it
  is near-exact against fp32 scoring because its operands are bf16.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.utils.debug import kernel_nan_check

NEG_INF = -1e30
KBUF_MAX = 256
# tile sizes of csrc/topk_flash.cu: queries per block (the wide tile,
# and the small one for small Q), items per scoring tile
TQ = 64
TQ_SMALL = 16
TB = 64
# the plain version scores at most this many fp32 [q, N] bytes at once
_REFERENCE_CHUNK_BYTES = 1 << 28


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def _prepare(u, v, normalize, item_bias):
    if item_bias is not None:
        if normalize:
            raise ValueError("item_bias requires normalize=False (raw-dot scoring)")
        u = torch.cat([u, torch.ones_like(u[:, :1])], dim=1)
        v = torch.cat([v, item_bias.to(v.dtype)[:, None]], dim=1)
    if normalize:
        u, v = l2_normalize(u), l2_normalize(v)
    return u, v


def flash_topk_reference(user_emb: torch.Tensor, item_emb: torch.Tensor, k: int,
                         normalize: bool = True,
                         item_bias: Optional[torch.Tensor] = None,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: dense ``torch.matmul`` + ``torch.topk``, chunked over
    queries so that at most 256 MiB of scores exist at once.
    -> (scores [Q, k] fp32, ids [Q, k] int64)."""
    u, v = _prepare(user_emb.float(), item_emb.float(), normalize, item_bias)
    q_n, n = u.shape[0], v.shape[0]
    kk = min(k, n)
    rows = max(1, _REFERENCE_CHUNK_BYTES // max(1, 4 * n))
    outs, ids = [], []
    for q in range(0, q_n, rows):
        s, i = torch.topk(torch.matmul(u[q:q + rows], v.T), kk, dim=1)
        outs.append(s)
        ids.append(i)
    top_s = torch.cat(outs) if outs else u.new_empty((0, kk))
    top_i = torch.cat(ids) if ids else torch.empty((0, kk), dtype=torch.long,
                                                   device=u.device)
    if kk < k:  # k > N: pad with NEG_INF scores and id 0
        top_s = torch.cat([top_s, top_s.new_full((q_n, k - kk), NEG_INF)], dim=1)
        top_i = torch.cat([top_i, top_i.new_zeros((q_n, k - kk))], dim=1)
    return top_s, top_i


def kbuf_for(k: int) -> int:
    """Candidate slots per query: k rounded up to a power of two, >= 32."""
    if not 1 <= k <= KBUF_MAX:
        raise ValueError(f"flash_topk supports 1 <= k <= {KBUF_MAX}, got {k}")
    return max(32, 1 << (k - 1).bit_length())


class TopkPlan(NamedTuple):
    """How ``csrc/topk_flash.cu`` cuts a call across blocks: query tile
    ``tq``, buffer ``kbuf``, ``n_chunks`` catalog chunks of ``chunk``
    items, and the ``slots`` each chunk keeps per query row (``chunk``
    when it fits the buffer: no selection in the block)."""
    tq: int
    kbuf: int
    chunk: int
    n_chunks: int
    slots: int


@functools.lru_cache(maxsize=4096)
def plan(q_n: int, n: int, k: int, n_sm: int) -> TopkPlan:
    """Enough blocks for about two per SM where the catalog's 64-item
    tiles allow (a served Q = 1 must not leave the card idle): the
    16-row query tile for small Q, or where 64-row tiles would give a
    thinner grid, and the catalog cut into as many chunks as fill the
    rest. At Q = 4,096 this is PR 1's plan: 64-row tiles, a few
    buffer-sized chunks."""
    kbuf = kbuf_for(k)
    n_tiles = _cdiv(n, TB)
    wide = q_n > TQ_SMALL and _cdiv(q_n, TQ) * n_tiles >= 2 * n_sm
    tq = TQ if wide else TQ_SMALL
    n_chunks = min(n_tiles, max(1, _cdiv(2 * n_sm, _cdiv(q_n, tq))))
    chunk = _cdiv(_cdiv(n, n_chunks), TB) * TB
    return TopkPlan(tq, kbuf, chunk, _cdiv(n, chunk), min(kbuf, chunk))


def flash_topk_candidates_reference(user_emb: torch.Tensor, item_emb: torch.Tensor,
                                    p: TopkPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of stage 1 on prepared fp32 operands: -> (scores
    [Q, n_chunks * slots] fp32, ids int32), each chunk's top ``slots``
    items (all of them, in order, when the chunk fits its slots), slots
    left over holding ``NEG_INF`` and id 0. The kernel's slot order within
    a chunk may differ; stage 2 does not depend on it."""
    q_n, n = user_emb.shape[0], item_emb.shape[0]
    cand_s = user_emb.new_full((q_n, p.n_chunks, p.slots), NEG_INF)
    cand_i = torch.zeros((q_n, p.n_chunks, p.slots), dtype=torch.int32,
                         device=user_emb.device)
    for c in range(p.n_chunks):
        lo, hi = c * p.chunk, min(n, (c + 1) * p.chunk)
        s = torch.matmul(user_emb, item_emb[lo:hi].T)
        ids = torch.arange(lo, hi, dtype=torch.int32, device=s.device).expand_as(s)
        if p.chunk > p.kbuf:
            s, pos = torch.topk(s, min(p.slots, hi - lo), dim=1)
            ids = torch.gather(ids, 1, pos)
        cand_s[:, c, :s.shape[1]] = s
        cand_i[:, c, :s.shape[1]] = ids
    return cand_s.view(q_n, -1), cand_i.view(q_n, -1)


def topk_select_reference(cand_s: torch.Tensor, cand_i: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of stage 2: the top k of each row's candidates ->
    (scores [Q, k] fp32 descending, ids [Q, k] int64), ``NEG_INF`` and id
    0 past the row's candidates."""
    q_n, m = cand_s.shape
    kk = min(k, m)
    top_s, pos = torch.topk(cand_s, kk, dim=1)
    top_i = torch.gather(cand_i, 1, pos).long()
    if kk < k:
        top_s = torch.cat([top_s, top_s.new_full((q_n, k - kk), NEG_INF)], dim=1)
        top_i = torch.cat([top_i, top_i.new_zeros((q_n, k - kk))], dim=1)
    return top_s, top_i


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load_library().topk_flash
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _select_launcher():
    fn = _build.load_library().topk_select
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def _stream(dev: torch.device) -> int:
    """The raw current stream of ``dev``, without building a Stream object
    (at served shapes the host's time per call is the call's time)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


# stage 1's candidates, per (device, stream): scratch that the next call
# on the same stream may reuse, as the caching allocator would reuse it
_scratch = {}


def _candidates_scratch(dev: torch.device, stream: int, n_bytes: int) -> torch.Tensor:
    buf = _scratch.get((dev.index, stream))
    if buf is None or buf.numel() < n_bytes:
        buf = torch.empty((n_bytes,), dtype=torch.uint8, device=dev)
        _scratch[(dev.index, stream)] = buf
    return buf


def topk_select(cand_s: torch.Tensor, cand_i: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 of :func:`flash_topk`: [Q, M] fp32 scores and int32 ids ->
    the top k of each row (scores [Q, k] fp32 descending, ids [Q, k]
    int64), 1 <= k <= 256; ties at the k boundary may resolve to other
    equal-scoring ids than the plain version's.

    CPU tensors take :func:`topk_select_reference`; CUDA tensors launch
    ``topk_select_kernel`` (one block per row) or raise."""
    kbuf_for(k)
    if cand_s.device.type == "cpu" and cand_i.device.type == "cpu":
        return topk_select_reference(cand_s, cand_i, k)
    dev = cand_s.device
    if dev.type != "cuda" or cand_i.device != dev:
        raise ValueError(f"topk_select: inputs must share one CUDA device, got {dev} "
                         f"and {cand_i.device}")
    if (cand_s.dim() != 2 or cand_s.shape != cand_i.shape or cand_s.dtype != torch.float32
            or cand_i.dtype != torch.int32 or cand_s.shape[1] == 0):
        raise ValueError(f"topk_select: want [Q, M] fp32 scores and int32 ids, M >= 1; got "
                         f"{cand_s.dtype} {tuple(cand_s.shape)}, {cand_i.dtype} "
                         f"{tuple(cand_i.shape)}")
    cand_s, cand_i = cand_s.contiguous(), cand_i.contiguous()
    q_n, m = cand_s.shape
    top_s = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    top_i = torch.empty((q_n, k), dtype=torch.int64, device=dev)
    if q_n:
        with torch.cuda.device(dev):
            err = _select_launcher()(cand_s.data_ptr(), cand_i.data_ptr(), q_n, m, k,
                                     top_s.data_ptr(), top_i.data_ptr(), _stream(dev))
        if err != 0:
            raise RuntimeError(f"topk_select kernel launch failed: cudaError {err}")
        topk_select.launches += 1
    return top_s, top_i


topk_select.launches = 0


@kernel_nan_check("kernel row 1 flash_topk (the exact top-k)")
def flash_topk(user_emb: torch.Tensor, item_emb: torch.Tensor, k: int,
               normalize: bool = True,
               item_bias: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``user_emb @ item_emb.T``: [Q, d] x [N, d] ->
    (scores [Q, k] fp32, ids [Q, k] int64), k <= 256.

    CPU tensors take :func:`flash_topk_reference`; CUDA tensors launch
    stage 1 (counted here, one launch per call) and the select kernel of
    :func:`topk_select` (counted there) over its [Q, n_chunks * slots]
    candidates, both from one host call, or raise."""
    kbuf_for(k)  # validates k on every device
    if user_emb.device.type == "cpu" and item_emb.device.type == "cpu":
        return flash_topk_reference(user_emb, item_emb, k, normalize, item_bias)
    dev = item_emb.device
    if dev.type != "cuda" or user_emb.device != dev or (
            item_bias is not None and item_bias.device != dev):
        raise ValueError(
            f"flash_topk: inputs must share one CUDA device, got "
            f"{user_emb.device} and {dev}")
    if user_emb.dim() != 2 or item_emb.dim() != 2 or user_emb.shape[1] != item_emb.shape[1]:
        raise ValueError(
            f"flash_topk: want [Q, d] and [N, d], got {tuple(user_emb.shape)} "
            f"and {tuple(item_emb.shape)}")
    if user_emb.dtype != torch.float32 or item_emb.dtype != torch.float32:
        raise ValueError("flash_topk: embeddings must be fp32")
    u, v = _prepare(user_emb, item_emb, normalize, item_bias)
    u = u if u.is_contiguous() else u.contiguous()
    v = v if v.is_contiguous() else v.contiguous()
    q_n, d = u.shape
    n = v.shape[0]
    if n == 0 or d == 0:
        raise ValueError("flash_topk: empty catalog or zero width")
    top_s = u.new_empty((q_n, k))
    top_i = u.new_empty((q_n, k), dtype=torch.int64)
    if not q_n:
        return top_s, top_i
    p = plan(q_n, n, k, _sm_count(dev.index))
    m = q_n * p.n_chunks * p.slots
    stream = _stream(dev)
    cand = _candidates_scratch(dev, stream, 8 * m).data_ptr()
    args = (u.data_ptr(), v.data_ptr(), q_n, n, d, p.tq, p.kbuf, p.chunk, p.n_chunks, k,
            cand, cand + 4 * m, top_s.data_ptr(), top_i.data_ptr(), stream)
    if dev.index == torch.cuda.current_device():
        err = _launcher()(*args)
    else:
        with torch.cuda.device(dev):
            err = _launcher()(*args)
    if err != 0:
        raise RuntimeError(f"flash_topk kernel launch failed: cudaError {err}")
    # one host call launched both kernels
    flash_topk.launches += 1
    topk_select.launches += 1
    return top_s, top_i


flash_topk.launches = 0


# ---- the group-max sieve ---------------------------------------------------

# query rows per block of csrc/blockmax.cu: the wide tile (above
# BLOCKMAX_TQ_SMALL queries) and the small one
BLOCKMAX_TQ = 64
BLOCKMAX_TQ_SMALL = 16
# pass 2 gathers [rows, kg * g, d] fp32 candidates; at most this many
# bytes of them exist at once
_GATHER_CHUNK_BYTES = 1 << 30


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def blockmax_group_size(n: int, group: int = 512) -> int:
    """The JAX package's group size: ``min(group, round_up(N, 128))``."""
    return min(group, _round_up(n, 128))


def blockmax_group_max_reference(user_emb: torch.Tensor, item_emb: torch.Tensor,
                                 group: int) -> torch.Tensor:
    """Plain version of pass 1: [Q, d] x [N, d] -> [Q, ceil(N / group)]
    fp32, each query's max over every group of ``group`` consecutive items
    (the last group holds the rest). Operands are upcast to fp32 (bf16
    products are exact there), and the queries are chunked so that at most
    256 MiB of scores exist at once."""
    u, v = user_emb.float(), item_emb.float()
    q_n, n = u.shape[0], v.shape[0]
    n_groups = _cdiv(n, group)
    pad = n_groups * group - n
    rows = max(1, _REFERENCE_CHUNK_BYTES // max(1, 4 * n))
    outs = []
    for q in range(0, q_n, rows):
        s = torch.matmul(u[q:q + rows], v.T)
        if pad:
            s = torch.cat([s, s.new_full((s.shape[0], pad), NEG_INF)], dim=1)
        outs.append(s.view(s.shape[0], n_groups, group).amax(dim=2))
    return torch.cat(outs) if outs else u.new_empty((0, n_groups))


@functools.lru_cache(maxsize=None)
def _blockmax_launcher():
    fn = _build.load_library().blockmax_group_max
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def blockmax_groups_per_block(group: int) -> int:
    """The most whole groups a block of the kernel takes: at least 512
    items of work."""
    return max(1, 512 // group)


class BlockmaxPlan(NamedTuple):
    """How ``csrc/blockmax.cu`` cuts a call: query tiles of ``tq`` rows
    (``n_qtiles``), the groups in ``n_chunks`` chunks of
    ``groups_per_block`` whole groups; block ``b`` takes query tile ``b %
    n_qtiles`` and chunk ``b // n_qtiles``."""
    tq: int
    groups_per_block: int
    n_qtiles: int
    n_chunks: int


@functools.lru_cache(maxsize=4096)
def blockmax_plan(q_n: int, n: int, group: int, n_sm: int) -> BlockmaxPlan:
    """The kernel's grid on a card of ``n_sm`` SMs. The query tile comes
    from Q: 16 rows at Q <= 16 (a 64-row tile would be mostly padding at a
    served Q = 1), else 64. Each block takes up to
    :func:`blockmax_groups_per_block` whole groups, fewer where that would
    leave fewer than about two blocks per SM."""
    tq = BLOCKMAX_TQ_SMALL if q_n <= BLOCKMAX_TQ_SMALL else BLOCKMAX_TQ
    n_qt, n_groups = _cdiv(q_n, tq), _cdiv(n, group)
    gpb = blockmax_groups_per_block(group)
    while gpb > 1 and n_qt * _cdiv(n_groups, gpb) < 2 * n_sm:
        gpb -= 1
    return BlockmaxPlan(tq, gpb, n_qt, _cdiv(n_groups, gpb))


@kernel_nan_check("kernel row 8 blockmax_group_max (the sieve's per-group max)")
def blockmax_group_max(user_emb: torch.Tensor, item_emb: torch.Tensor,
                       group: int) -> torch.Tensor:
    """Pass 1 of :func:`blockmax_topk`: [Q, d] x [N, d] (both bf16; on
    the CPU also both fp32) -> [Q, ceil(N / group)] fp32 group maxima of
    the fp32-accumulated dots.

    CPU tensors take :func:`blockmax_group_max_reference`; CUDA tensors
    launch the kernel on :func:`blockmax_plan` (bf16 operands on the
    tensor cores, d <= 256; one launch per call) or raise: fp32 operands
    have no kernel (``blockmax_topk(bf16=True)`` rounds them to bf16)."""
    if group < 1:
        raise ValueError(f"blockmax_group_max: group must be >= 1, got {group}")
    if user_emb.device.type == "cpu" and item_emb.device.type == "cpu":
        return blockmax_group_max_reference(user_emb, item_emb, group)
    dev = item_emb.device
    if dev.type != "cuda" or user_emb.device != dev:
        raise ValueError(f"blockmax_group_max: inputs must share one CUDA device, "
                         f"got {user_emb.device} and {dev}")
    if user_emb.dim() != 2 or item_emb.dim() != 2 or user_emb.shape[1] != item_emb.shape[1]:
        raise ValueError(f"blockmax_group_max: want [Q, d] and [N, d], got "
                         f"{tuple(user_emb.shape)} and {tuple(item_emb.shape)}")
    if user_emb.dtype != torch.bfloat16 or item_emb.dtype != torch.bfloat16:
        raise ValueError(f"blockmax_group_max: CUDA embeddings must both be bf16 (fp32 "
                         f"operands have no kernel; blockmax_topk(bf16=True) rounds them), "
                         f"got {user_emb.dtype} and {item_emb.dtype}")
    u, v = user_emb.contiguous(), item_emb.contiguous()
    q_n, d = u.shape
    n = v.shape[0]
    if n == 0 or d == 0:
        raise ValueError("blockmax_group_max: empty catalog or zero width")
    if d > 256:
        raise ValueError(f"blockmax_group_max: the kernel needs d <= 256, got {d}")
    n_groups = _cdiv(n, group)
    out = torch.empty((q_n, n_groups), dtype=torch.float32, device=dev)
    if q_n:
        p = blockmax_plan(q_n, n, group, _sm_count(dev.index))
        vec = int(d % 8 == 0 and u.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = _blockmax_launcher()(
                u.data_ptr(), v.data_ptr(), q_n, n, d, group, p.groups_per_block,
                p.tq, vec, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"blockmax_group_max kernel launch failed: cudaError {err}")
        blockmax_group_max.launches += 1
    return out


blockmax_group_max.launches = 0


def blockmax_topk(user_emb: torch.Tensor, item_emb: torch.Tensor, k: int,
                  group: int = 512, normalize: bool = True, bf16: bool = True,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k via the group-max sieve: [Q, d] x [N, d] -> (scores [Q, k]
    fp32, ids [Q, k] int64), the contract of :func:`flash_topk` (k > N
    pads with ``NEG_INF`` and id 0). ``bf16`` rounds both operands to
    bf16; every score is an fp32 sum of their exact products.

    Pass 1 is :func:`blockmax_group_max`; pass 2 takes the top
    min(k, n_groups) groups of each query, gathers their items (in query
    chunks of at most ~1 GiB), rescores them and takes the top k. Ids
    agree with an exact top-k of the same operands except where pass 1
    and the rescore order a near-tie differently (their sums run in other
    orders)."""
    if k < 1:
        raise ValueError(f"blockmax_topk: k must be >= 1, got {k}")
    if normalize:
        user_emb, item_emb = l2_normalize(user_emb.float()), l2_normalize(item_emb.float())
    dt = torch.bfloat16 if bf16 else torch.float32
    u, v = user_emb.to(dt), item_emb.to(dt)
    q_n, d = u.shape
    n = v.shape[0]
    g = blockmax_group_size(n, group)
    group_max = blockmax_group_max(u, v, g)
    kg = min(k, group_max.shape[1])
    top_groups = torch.topk(group_max, kg, dim=1).indices  # [Q, kg]
    idx = (top_groups[:, :, None] * g
           + torch.arange(g, device=u.device)).reshape(q_n, kg * g)
    valid = idx < n
    idx = idx.clamp(max=n - 1)
    kk = min(k, n)
    rows = max(1, _GATHER_CHUNK_BYTES // (kg * g * d * 4))
    outs, ids = [], []
    for q in range(0, q_n, rows):
        cand = v[idx[q:q + rows]].float()  # [rows, kg * g, d]
        s = torch.matmul(cand, u[q:q + rows, :, None].float())[..., 0]
        s = s.masked_fill(~valid[q:q + rows], NEG_INF)
        top_s, pos = torch.topk(s, kk, dim=1)
        outs.append(top_s)
        ids.append(torch.gather(idx[q:q + rows], 1, pos))
    top_s = torch.cat(outs) if outs else u.new_empty((0, kk), dtype=torch.float32)
    top_i = torch.cat(ids) if ids else idx.new_empty((0, kk))
    if kk < k:  # k > N: pad to the blockwise contract
        top_s = torch.cat([top_s, top_s.new_full((q_n, k - kk), NEG_INF)], dim=1)
        top_i = torch.cat([top_i, top_i.new_zeros((q_n, k - kk))], dim=1)
    return top_s, top_i
