"""Top-k of ``u . v^T`` without the [Q, N] score matrix (the port of
``recsys_tpu/ops/pallas/topk_flash.py``), two CUDA kernels each beside
its plain PyTorch version:

* :func:`flash_topk` — exact running top-k, ``csrc/topk_flash.cu``.
  Contract, kept from the TPU kernel: fp32 scoring, slots past N score
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
from typing import Optional, Tuple

import torch

from recsys_tpu_torch.ops import _build

NEG_INF = -1e30
KBUF_MAX = 256
# tile sizes of csrc/topk_flash.cu (queries per block, items per tile)
TQ = 64
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


def plan(q_n: int, n: int, k: int, n_sm: int) -> Tuple[int, int, int]:
    """-> (kbuf, chunk, n_chunks): how the catalog is cut across blocks.

    Enough chunks that the grid holds about two blocks per SM (a served
    Q = 1 must not leave the card idle), but each chunk at least one
    buffer's worth of items, so the final selection stays small."""
    kbuf = kbuf_for(k)
    n_q_tiles = _cdiv(q_n, TQ)
    max_chunks = max(1, _cdiv(n, max(TB, kbuf)))
    n_chunks = min(max_chunks, max(1, _cdiv(2 * n_sm, n_q_tiles)))
    chunk = _cdiv(_cdiv(n, n_chunks), TB) * TB
    return kbuf, chunk, _cdiv(n, chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load_library().topk_flash
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def flash_topk(user_emb: torch.Tensor, item_emb: torch.Tensor, k: int,
               normalize: bool = True,
               item_bias: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``user_emb @ item_emb.T``: [Q, d] x [N, d] ->
    (scores [Q, k] fp32, ids [Q, k] int64), k <= 256.

    CPU tensors take :func:`flash_topk_reference`; CUDA tensors launch the
    kernel (one launch per call) or raise."""
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
    u, v = u.contiguous(), v.contiguous()
    q_n, d = u.shape
    n = v.shape[0]
    if n == 0 or d == 0:
        raise ValueError("flash_topk: empty catalog or zero width")
    kbuf, chunk, n_chunks = plan(q_n, n, k, _sm_count(dev.index))
    cand_s = torch.empty((q_n, n_chunks * kbuf), dtype=torch.float32, device=dev)
    cand_i = torch.empty((q_n, n_chunks * kbuf), dtype=torch.int32, device=dev)
    if q_n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = _launcher()(u.data_ptr(), v.data_ptr(), q_n, n, d, kbuf, chunk,
                              n_chunks, cand_s.data_ptr(), cand_i.data_ptr(),
                              stream)
        if err != 0:
            raise RuntimeError(f"flash_topk kernel launch failed: cudaError {err}")
        flash_topk.launches += 1
    # final selection over the per-chunk buffers (a small [Q, n_chunks*kbuf]
    # top-k, as the TPU wrapper leaves its final sort to XLA)
    top_s, pos = torch.topk(cand_s, k, dim=1)
    return top_s, torch.gather(cand_i, 1, pos).long()


flash_topk.launches = 0


# ---- the group-max sieve ---------------------------------------------------

# query rows per block of csrc/blockmax.cu
BLOCKMAX_TQ = 64
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
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def blockmax_groups_per_block(group: int) -> int:
    """Whole groups per block of the kernel: at least 512 items of work."""
    return max(1, 512 // group)


def blockmax_group_max(user_emb: torch.Tensor, item_emb: torch.Tensor,
                       group: int) -> torch.Tensor:
    """Pass 1 of :func:`blockmax_topk`: [Q, d] x [N, d] (both bf16 or
    both fp32) -> [Q, ceil(N / group)] fp32 group maxima of the
    fp32-accumulated dots.

    CPU tensors take :func:`blockmax_group_max_reference`; CUDA tensors
    launch the kernel (one launch per call) or raise."""
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
    if user_emb.dtype != item_emb.dtype or user_emb.dtype not in (torch.bfloat16,
                                                                  torch.float32):
        raise ValueError(f"blockmax_group_max: embeddings must both be bf16 or both "
                         f"fp32, got {user_emb.dtype} and {item_emb.dtype}")
    u, v = user_emb.contiguous(), item_emb.contiguous()
    q_n, d = u.shape
    n = v.shape[0]
    if n == 0 or d == 0:
        raise ValueError("blockmax_group_max: empty catalog or zero width")
    n_groups = _cdiv(n, group)
    out = torch.empty((q_n, n_groups), dtype=torch.float32, device=dev)
    if q_n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = _blockmax_launcher()(
                u.data_ptr(), v.data_ptr(), q_n, n, d, group,
                blockmax_groups_per_block(group), int(u.dtype == torch.bfloat16),
                out.data_ptr(), stream)
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
