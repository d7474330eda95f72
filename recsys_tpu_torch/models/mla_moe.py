"""DeepSeek-V2's blocks as a generative sequential recommender: multi-head
latent attention (MLA) and DeepSeekMoE (DeepSeek-V2, arXiv:2405.04434,
sections 2.1 and 2.2; the DeepSeek-V2-Lite ``config.json``), over jagged
histories with HSTU's input and loss (``models/hstu.py``). The JAX package
has no such model.

A batch is jagged: ``items`` [events] int32 of every user's history end to
end, with its ``ops/hstu_attention.py::JaggedLayout`` (no padding). With d
= ``embedding_dim``, H = ``mla_heads``, every norm an RMSNorm with a
learned scale (eps ``rms_eps``), and no dropout:

* input: ``h = item_table[items]`` (no position embedding: RoPE carries
  position);
* ``mla_layers`` layers, each ``h' = h + MLA(RMSNorm(h))``, ``h'' = h' +
  FFN(RMSNorm(h'))``;
* MLA of x (no query compression): ``q = x W_q`` (H heads of nope + rope),
  ``[c, k_r] = x W_kv_a`` (c ``mla_kv_rank`` wide, k_r one rope key shared
  by the heads), ``[k_n, v] = RMSNorm_kv(c) W_kv_b``; head h's key is
  ``[k_n,h, RoPE(k_r)]`` and query ``[q_n,h, RoPE(q_r,h)]``, its output
  ``softmax_causal(tau q_h k_h^T) v_h`` (``ops/mla_attention.py``: kernel
  rows 14 and 15), the heads' outputs times W_o. RoPE's position is the
  event's index in its history, rotate-half pairs (i, i + rope / 2), at
  YaRN's frequencies (:func:`yarn_inv_freq`) with the cos and sin scaled by
  mscale(factor, mscale) / mscale(factor, mscale_all_dim) and tau =
  (nope + rope)^-1/2 mscale(factor, mscale_all_dim)^2 (:func:`softmax_scale`);
* FFN: the first ``mla_dense_layers`` a dense SwiGLU of ``mla_dense_width``;
  the rest DeepSeekMoE (``ops/moe.py``): the shared experts, one SwiGLU of
  ``moe_shared * moe_width``, plus the held routed experts' gate-weighted
  SwiGLUs (the fp32 router's softmax over ``moe_experts``, its greedy top
  ``moe_top_k``, the weights not renormalised; this card's experts
  0..``moe_experts_held`` - 1, the other cards' part left out) and the
  sequence-level balance loss;
* output: a final RMSNorm, then L2 normalisation; the loss the sampled
  softmax of every event against its next item over ``hstu_negatives``
  uniform negatives (:func:`loss`: ``models/losses.py::sampled_softmax``, the
  same item table in and out).

Under ``mixed_precision`` the linear layers take bf16 operands with fp32
sums (``layers.linear``), as do the attention's and the routed experts'
products; the norms, SiLUs, softmax statistics, RoPE, the router and the
loss are fp32.

Params: ``{"item_table": [items + 1, d] (row 0 the padding row, zero),
"final_norm": {"scale"}, "layer_<l>": {"attn_norm": {"scale"}, "q": {"w" [d,
H (nope + rope)]}, "kv_a": {"w" [d, kv_rank + rope]}, "kv_norm": {"scale"},
"kv_b": {"w" [kv_rank, H (nope + v)]}, "o": {"w" [H v, d]}, "ffn_norm":
{"scale"}, then "mlp": {"gate", "up", "down"} (dense) or "router": {"w" [d,
X]}, "shared": {"gate", "up", "down"}, "experts": {"gate" [G, d, I], "up"
[G, d, I], "down" [G, I, d]}}}``, every weight normal with std 0.02, every
scale 1 (:func:`init`).

Negatives come from one generator on the device (:func:`draw`), drawn
before the forward, so a plain reference given them sees the same draws.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from recsys_tpu_torch.config import ModelConfig
from recsys_tpu_torch.models import hstu, losses
from recsys_tpu_torch.models import layers as L
from recsys_tpu_torch.ops import hstu_attention as ha
from recsys_tpu_torch.ops import mla_attention as ma
from recsys_tpu_torch.ops import moe
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device
from recsys_tpu_torch.utils.trace import span

NORM_EPS = 1e-6
INIT_STD = 0.02

# the negatives, and the supervised events, as HSTU's
supervised = hstu.supervised
rows = hstu.rows


# the trainer's step metrics: the loss with the balance loss, the balance
# loss, the events, the causal pairs, the pairs on held experts summed over
# the MoE layers and the busiest held expert's tokens
STEP_METRICS = ("loss", "balance_loss", "events", "attn_pairs", "moe_assignments",
                "moe_max_expert_tokens")


def step_metrics(stats: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A step's metrics beyond the trainer's (loss, events, causal pairs),
    from the ``stats`` its forward filled, on the device."""
    zero = torch.zeros((), device=device)
    return {"balance_loss": torch.as_tensor(stats.get("balance", zero)).detach(),
            "moe_assignments": torch.as_tensor(stats.get("assignments", zero)).float(),
            "moe_max_expert_tokens": torch.as_tensor(stats.get("max_expert_tokens", zero)).float()}


def yarn_mscale(scale: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def yarn_inv_freq(cfg: ModelConfig) -> torch.Tensor:
    """[rope / 2] fp64: YaRN's inverse frequencies, ``g_i r_i + f_i (1 -
    r_i)`` with f_i = theta^(-2i / rope), g_i = f_i / factor and the ramp r_i
    = clamp((i - lo) / (hi - lo), 0, 1) between lo = floor(corr(beta_fast))
    and hi = ceil(corr(beta_slow)), corr(b) = rope ln(original / (2 pi b)) /
    (2 ln theta), each clamped to [0, rope - 1]."""
    dim, base = cfg.mla_rope_dim, cfg.rope_theta

    def corr(rot):
        return dim * math.log(cfg.yarn_original_max / (rot * 2 * math.pi)) / (2 * math.log(base))

    lo = max(math.floor(corr(cfg.yarn_beta_fast)), 0)
    hi = min(math.ceil(corr(cfg.yarn_beta_slow)), dim - 1)
    if lo == hi:
        hi += 0.001
    i = torch.arange(0, dim, 2, dtype=torch.float64)
    extra = 1.0 / (base ** (i / dim))
    inter = 1.0 / (cfg.yarn_factor * base ** (i / dim))
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float64) - lo) / (hi - lo), 0, 1)
    return inter * ramp + extra * (1 - ramp)


def softmax_scale(cfg: ModelConfig) -> float:
    """tau = (nope + rope)^-1/2 mscale(factor, mscale_all_dim)^2."""
    m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
    return (cfg.mla_nope_dim + cfg.mla_rope_dim) ** -0.5 * m * m


@functools.lru_cache(maxsize=8)
def _rope_table(cfg: ModelConfig, device: torch.device):
    """(cos, sin) [max_len, rope] fp32 on ``device``: the angles t inv_freq
    twice over (rotate-half), times the YaRN mscale ratio, taken in fp64
    (fp32 angles at t ~ 4,000 would be off by ~1e-4)."""
    inv = yarn_inv_freq(cfg)
    t = torch.arange(cfg.hstu_max_len, dtype=torch.float64)
    freqs = torch.outer(t, inv)
    emb = torch.cat([freqs, freqs], dim=1)
    m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale) / yarn_mscale(cfg.yarn_factor,
                                                                    cfg.yarn_mscale_all_dim)
    return (emb.cos() * m).float().to(device), (emb.sin() * m).float().to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RoPE (rotate-half) of x [events, ..., rope] at ``positions`` [events]."""
    cos, sin = _rope_table(cfg, x.device)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    c, s = cos[positions].reshape(shape), sin[positions].reshape(shape)
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * c + rot * s


class _RmsNorm(torch.autograd.Function):
    """``x r scale`` with r = (mean(x^2) + eps)^-1/2 a row, fp32; it saves x
    and r alone (autograd's own would keep ``x r`` as well: 0.75 GB a norm
    at the cell's ~92k rows of 2,048)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        r = torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, r, scale)
        return x * r * scale

    @staticmethod
    def backward(ctx, g):
        x, r, scale = ctx.saved_tensors
        gs = g * scale
        gx = r * gs - x * (r ** 3) * torch.mean(gs * x, dim=-1, keepdim=True)
        return gx, torch.sum(g * x * r, dim=0), None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of the rows of a 2-D x with a learned scale."""
    return _RmsNorm.apply(x, scale, eps)


def is_moe(cfg: ModelConfig, layer: int) -> bool:
    return layer >= cfg.mla_dense_layers


def init(seed: int, cfg: ModelConfig, device: DeviceLike = "cuda") -> Dict:
    """Params from ``seed``, drawn on ``device``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device) * INIT_STD

    def ones(n):
        return {"scale": torch.ones((n,), device=device)}

    d, h = cfg.embedding_dim, cfg.mla_heads
    table = normal(cfg.hstu_items + 1, d)
    table[0] = 0.0
    params = {"item_table": table, "final_norm": ones(d)}
    for i in range(cfg.mla_layers):
        p = {"attn_norm": ones(d),
             "q": {"w": normal(d, h * (cfg.mla_nope_dim + cfg.mla_rope_dim))},
             "kv_a": {"w": normal(d, cfg.mla_kv_rank + cfg.mla_rope_dim)},
             "kv_norm": ones(cfg.mla_kv_rank),
             "kv_b": {"w": normal(cfg.mla_kv_rank, h * (cfg.mla_nope_dim + cfg.mla_v_dim))},
             "o": {"w": normal(h * cfg.mla_v_dim, d)},
             "ffn_norm": ones(d)}
        if is_moe(cfg, i):
            g, w, s = cfg.moe_experts_held, cfg.moe_width, cfg.moe_shared * cfg.moe_width
            p["router"] = {"w": normal(d, cfg.moe_experts)}
            if s:
                p["shared"] = {"gate": {"w": normal(d, s)}, "up": {"w": normal(d, s)},
                               "down": {"w": normal(s, d)}}
            p["experts"] = {"gate": normal(g, d, w), "up": normal(g, d, w),
                            "down": normal(g, w, d)}
        else:
            w = cfg.mla_dense_width
            p["mlp"] = {"gate": {"w": normal(d, w)}, "up": {"w": normal(d, w)},
                        "down": {"w": normal(w, d)}}
        params[f"layer_{i}"] = p
    return params


def draw(gen: Optional[torch.Generator], layout: ha.JaggedLayout, cfg: ModelConfig,
         train: bool = True) -> Dict[str, torch.Tensor]:
    """The step's negatives [events - B, hstu_negatives] from ``gen``,
    uniform over the ids 1..hstu_items (no dropout to draw)."""
    m = layout.events - (layout.offsets.shape[0] - 1)
    return {"negatives": torch.randint(1, cfg.hstu_items + 1, (m, cfg.hstu_negatives),
                                       generator=gen, device=layout.offsets.device,
                                       dtype=torch.int64)}


def _swiglu(x, w_gate, w_up, w_down, bf16: bool) -> torch.Tensor:
    w = w_gate.shape[1]
    gu = L.linear({"w": torch.cat([w_gate, w_up], dim=1)}, x, bf16)
    return L.linear({"w": w_down}, F.silu(gu[:, :w]) * gu[:, w:], bf16)


def swiglu(p: Dict, x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``(silu(x W_gate) * x W_up) W_down``, W_gate and W_up as one product,
    recomputed in the backward from x (activation checkpointing: the dense
    layer's [events, 2 x 10,944] fp32 products would hold ~8 GB a layer at
    the cell's shape)."""
    return checkpoint(_swiglu, x, p["gate"]["w"], p["up"]["w"], p["down"]["w"], bf16,
                      use_reentrant=False)


def attention(p: Dict, cfg: ModelConfig, x: torch.Tensor, layout: ha.JaggedLayout) -> torch.Tensor:
    """MLA over the normed rows x [events, d] -> [events, d]."""
    bf16 = cfg.mixed_precision
    e, h = x.shape[0], cfg.mla_heads
    nope, rp, kv = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_kv_rank
    qa = L.linear({"w": torch.cat([p["q"]["w"], p["kv_a"]["w"]], dim=1)}, x, bf16)
    q = qa[:, :h * (nope + rp)].reshape(e, h, nope + rp)
    # c copied out, so that its norm does not keep qa alive
    c = qa[:, h * (nope + rp):h * (nope + rp) + kv].contiguous()
    k_r = qa[:, h * (nope + rp) + kv:]
    kvb = L.linear(p["kv_b"], rms_norm(c, p["kv_norm"]["scale"], cfg.rms_eps), bf16)
    kvb = kvb.reshape(e, h, nope + cfg.mla_v_dim)
    with span("mla.attn"):
        q = torch.cat([q[:, :, :nope], rope(q[:, :, nope:], layout.positions, cfg)], dim=2)
        k = torch.cat([kvb[:, :, :nope],
                       rope(k_r, layout.positions, cfg)[:, None, :].expand(e, h, rp)], dim=2)
        o = ma.mla_attention(q.reshape(e, -1), k.reshape(e, -1),
                             kvb[:, :, nope:].reshape(e, -1), layout, h, softmax_scale(cfg),
                             bf16)
    return L.linear(p["o"], o, bf16)


def moe_ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor, layout: ha.JaggedLayout,
            stats: Dict, layer: int) -> torch.Tensor:
    """DeepSeekMoE over the normed rows x: the shared experts and this
    card's routed experts; the balance loss and the dispatch's counts added
    to ``stats``, the layer's expert choices [events, k] put in its
    "experts" under ``layer``."""
    bf16 = cfg.mixed_precision
    with span("moe.route"):
        routing = moe.route(x, p["router"]["w"], cfg.moe_top_k)
        disp = moe.dispatch(routing, cfg.moe_experts_held)
        bal = moe.balance_loss(routing, layout.seq, layout.offsets.shape[0] - 1,
                               cfg.moe_aux_alpha)
    y = swiglu(p["shared"], x, bf16) if "shared" in p else None
    stats["balance"] = stats.get("balance", 0.0) + bal
    stats.setdefault("experts", {})[layer] = routing.experts
    stats["assignments"] = stats.get("assignments", 0) + torch.sum(disp.counts)
    busiest = torch.max(disp.counts) if disp.counts.numel() else torch.zeros(
        (), dtype=torch.int64, device=x.device)
    stats["max_expert_tokens"] = torch.maximum(stats.get("max_expert_tokens", busiest), busiest)
    ex = p["experts"]
    routed = moe.routed(x, torch.cat([ex["gate"], ex["up"]], dim=2), ex["down"], routing, disp)
    return routed if y is None else y + routed


def encode(params: Dict, cfg: ModelConfig, items: torch.Tensor, layout: ha.JaggedLayout,
           stats: Dict) -> torch.Tensor:
    """The L2-normalised outputs [events, d]; ``stats`` gains the MoE
    layers' balance loss, counts and expert choices."""
    eps = cfg.rms_eps
    h = rows(params["item_table"], items.long())
    for i in range(cfg.mla_layers):
        p = params[f"layer_{i}"]
        h = h + attention(p, cfg, rms_norm(h, p["attn_norm"]["scale"], eps), layout)
        x = rms_norm(h, p["ffn_norm"]["scale"], eps)
        h = h + (moe_ffn(p, cfg, x, layout, stats, i) if is_moe(cfg, i)
                 else swiglu(p["mlp"], x, cfg.mixed_precision))
    h = rms_norm(h, params["final_norm"]["scale"], eps)
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=1, keepdim=True), min=NORM_EPS)


def loss(params: Dict, cfg: ModelConfig, items: torch.Tensor, timestamps: Optional[torch.Tensor],
         layout: ha.JaggedLayout, draws: Dict[str, torch.Tensor],
         stats: Optional[Dict] = None) -> torch.Tensor:
    """The mean sampled-softmax loss of the batch's supervised events (the
    balance loss and the MoE counts go to ``stats`` where given; the
    timestamps are not read)."""
    stats = {} if stats is None else stats
    out = encode(params, cfg, items, layout, stats)
    sup = supervised(layout)
    table = params["item_table"]
    table_n = table / torch.clamp(torch.linalg.vector_norm(table, dim=1, keepdim=True),
                                  min=NORM_EPS)
    return losses.sampled_softmax(rows(out, sup, unique=True), table_n, items[sup + 1].long(),
                                  draws["negatives"], cfg.softmax_temperature)
