"""Exact running top-k of ``u . v^T``: the CUDA kernel
``csrc/topk_flash.cu`` and its plain PyTorch version (the port of
``recsys_tpu/ops/pallas/topk_flash.py::flash_topk``).

Contract, kept from the TPU kernel: fp32 scoring, the [Q, N] score matrix
is never formed on the kernel path, slots past N score ``NEG_INF`` (so
``k > N`` is allowed), and ``item_bias`` (raw-dot scoring only) folds
into the dot as ``[u|1] . [v|b]``. Ties at the k boundary may resolve to
other, equal-scoring, ids than the plain version's.

What differs: the candidate buffer is k rounded up to a power of two,
32 to 256 slots (``KBUF_MAX``), so k <= 256; the TPU's lane-width buffer
capped k at 128.
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
