"""HSTU, the sequential transducer of generative recommenders (Zhai et al.,
*Actions Speak Louder than Words*, ICML 2024, arXiv:2402.17152, section 3;
the public code's ``generative_recommenders/research/modeling/sequential/
hstu.py``). The JAX package has no such model.

A batch is jagged: ``items`` [events] int32 and ``timestamps`` [events]
int64 of every user's history end to end, with its
``ops/hstu_attention.py::JaggedLayout`` (no padding). With d =
``embedding_dim``, H = ``hstu_heads`` heads of 64 and N =
``hstu_max_len``:

* input: ``item_table[items] * sqrt(d) + pos_emb[position]``, dropout;
* ``hstu_blocks`` blocks, each
  ``X^ = LayerNorm(X)`` (no affine, eps 1e-6);
  ``U, V, Q, K = split(SiLU(X^ W_uvqk))`` (W_uvqk [d, 4 H 64], no bias);
  ``A = the jagged causal SiLU attention with the block's learned position
  and time bias`` (``ops/hstu_attention.py``: kernel rows 11 and 12);
  ``Y = X + dropout(U * LayerNorm(A)) W_o + b_o``;
* output: the last block's rows, L2-normalised;
* loss (:func:`loss`): the sampled softmax at every event with a next
  event: ``cos(output_i, item_{i+1}) / temperature`` against
  ``hstu_negatives`` item ids drawn uniformly for each event (a negative
  equal to the positive masked), the mean over those events
  (``models/losses.py::sampled_softmax``).

Under ``mixed_precision`` the linear layers take bf16 operands with fp32
sums (``layers.linear``) and the attention's products take bf16 operands;
the LayerNorms, SiLUs, the bias and the loss are fp32.

Params: ``{"item_table": [items + 1, d] (row 0 the padding row, zero),
"pos_emb": [N, d], "block_<l>": {"uvqk": {"w"}, "o": {"w", "b"}, "pos_w":
[2N - 1], "ts_w": [129]}}``, drawn on the device from the seed: the item
table and position embedding truncated normal (std 0.02 and sqrt(1 / d),
cut at two std), W_uvqk, pos_w and ts_w normal with std 0.02, W_o
Glorot-uniform, b_o zero.

Dropout masks and negatives (:func:`draw`) come from one generator on the
device, drawn before the forward, so a step's re-run (``debug_nans``)
and a plain reference given them see the same draws.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from recsys_tpu_torch.config import ModelConfig
from recsys_tpu_torch.models import layers as L
from recsys_tpu_torch.models import losses
from recsys_tpu_torch.ops import hstu_attention as ha
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device

LN_EPS = 1e-6
NORM_EPS = 1e-6


class _Rows(torch.autograd.Function):
    """``table[idx]`` whose backward adds each row's gradient into a zero
    table by ``index_add_`` (``unique``: ``index_copy_``): no host sync,
    where PyTorch's own gather and embedding backward sort the indices and
    read a count back from the card."""

    @staticmethod
    def forward(ctx, table, idx, unique):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.unique = table.shape[0], unique
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = g.new_zeros((ctx.rows, g.shape[1]))
        return (out.index_copy_(0, idx, g) if ctx.unique else out.index_add_(0, idx, g)), None, None


def rows(table: torch.Tensor, idx: torch.Tensor, unique: bool = False) -> torch.Tensor:
    """``table[idx]`` of a 2-D table and int64 indices, differentiable in
    the table (``unique``: no index twice)."""
    return _Rows.apply(table, idx, unique)


def init(seed: int, cfg: ModelConfig, device: DeviceLike = "cuda") -> Dict:
    """Params from ``seed``, drawn on ``device``."""
    device = resolve_device(device)
    d, n, w = cfg.embedding_dim, cfg.hstu_max_len, cfg.hstu_heads * ha.HEAD_DIM
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def trunc(shape, std):
        x = torch.empty(shape, device=device)
        return torch.nn.init.trunc_normal_(x, 0.0, std, -2 * std, 2 * std, generator=gen)

    table = trunc((cfg.hstu_items + 1, d), 0.02)
    table[0] = 0.0
    params = {"item_table": table, "pos_emb": trunc((n, d), (1.0 / d) ** 0.5)}
    lim = (6.0 / (w + d)) ** 0.5
    for i in range(cfg.hstu_blocks):
        params[f"block_{i}"] = {
            "uvqk": {"w": normal((d, 4 * w), 0.02)},
            "o": {"w": (torch.rand((w, d), generator=gen, device=device) * 2 - 1) * lim,
                  "b": torch.zeros((d,), device=device)},
            "pos_w": normal((2 * n - 1,), 0.02),
            "ts_w": normal((ha.NUM_BUCKETS + 1,), 0.02),
        }
    return params


# the trainer's step metrics: the loss, and the events and causal pairs a
# step (counted by the trainer from the layout)
STEP_METRICS = ("loss", "events", "attn_pairs")


def step_metrics(stats: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A step's metrics beyond the trainer's: none."""
    return {}


def supervised(layout: ha.JaggedLayout) -> torch.Tensor:
    """[events - B] int64: the events that have a next event in their
    sequence, in order (no host sync)."""
    b = layout.offsets.shape[0] - 1
    m = layout.events - b
    lens = (layout.offsets[1:] - layout.offsets[:-1]).to(torch.int64)
    cum = torch.cumsum(lens - 1, 0)
    k = torch.arange(m, device=lens.device)
    return k + torch.searchsorted(cum, k, right=True)


def draw(gen: Optional[torch.Generator], layout: ha.JaggedLayout, cfg: ModelConfig,
         train: bool = True) -> Dict[str, torch.Tensor]:
    """The step's random draws from ``gen`` (on the layout's device), in a
    fixed order: the input's and each block's dropout keep-masks (train
    only, with ``dropout_rate`` > 0), then the negatives [events - B,
    hstu_negatives], uniform over the ids 1..hstu_items."""
    dev = layout.offsets.device
    e, w = layout.events, cfg.hstu_heads * ha.HEAD_DIM
    out = {}
    keep = 1.0 - cfg.dropout_rate
    if train and cfg.dropout_rate > 0:
        out["input"] = torch.rand((e, cfg.embedding_dim), generator=gen, device=dev) < keep
        for i in range(cfg.hstu_blocks):
            out[f"block_{i}"] = torch.rand((e, w), generator=gen, device=dev) < keep
    m = e - (layout.offsets.shape[0] - 1)
    out["negatives"] = torch.randint(1, cfg.hstu_items + 1, (m, cfg.hstu_negatives),
                                     generator=gen, device=dev, dtype=torch.int64)
    return out


def _dropout(x: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    if mask is None:
        return x
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


def block(p: Dict, cfg: ModelConfig, x: torch.Tensor, timestamps: torch.Tensor,
          layout: ha.JaggedLayout, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """One HSTU block over the batch's rows x [events, d]."""
    bf16 = cfg.mixed_precision
    w = cfg.hstu_heads * ha.HEAD_DIM
    xn = F.layer_norm(x, (x.shape[1],), eps=LN_EPS)
    u, v, q, k = F.silu(L.linear(p["uvqk"], xn, bf16)).split(w, dim=1)
    a = ha.hstu_attention(v, q, k, p["pos_w"], p["ts_w"], timestamps, layout,
                          cfg.hstu_max_len, bf16)
    y = _dropout(u * F.layer_norm(a, (w,), eps=LN_EPS), mask, cfg.dropout_rate)
    return x + L.linear(p["o"], y, bf16)


def encode(params: Dict, cfg: ModelConfig, items: torch.Tensor, timestamps: torch.Tensor,
           layout: ha.JaggedLayout, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The L2-normalised outputs [events, d]; dropout where ``draws`` holds
    its masks."""
    d = cfg.embedding_dim
    x = (rows(params["item_table"], items.long()) * (d ** 0.5)
         + rows(params["pos_emb"], layout.positions))
    x = _dropout(x, draws.get("input"), cfg.dropout_rate)
    for i in range(cfg.hstu_blocks):
        x = block(params[f"block_{i}"], cfg, x, timestamps, layout, draws.get(f"block_{i}"))
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=NORM_EPS)


def loss(params: Dict, cfg: ModelConfig, items: torch.Tensor, timestamps: torch.Tensor,
         layout: ha.JaggedLayout, draws: Dict[str, torch.Tensor],
         stats: Optional[Dict] = None) -> torch.Tensor:
    """The mean sampled-softmax loss of the batch's supervised events
    (``stats``, the trainer's dict of a step's extra readings: none here)."""
    out = encode(params, cfg, items, timestamps, layout, draws)
    sup = supervised(layout)
    table = params["item_table"]
    table_n = table / torch.clamp(torch.linalg.vector_norm(table, dim=1, keepdim=True),
                                  min=NORM_EPS)
    return losses.sampled_softmax(rows(out, sup, unique=True), table_n, items[sup + 1].long(),
                                  draws["negatives"], cfg.softmax_temperature)
