"""Operations and bytes of DLRM-DCNv2 and of its timed operations, from the
configuration and the shapes a span records.

As in ``work/model.py`` and ``work/ops.py``: a multiply-add counts 2
operations, a backward twice its forward's products, nothing recomputed
counts; each input byte is counted read once and each output byte written
once, whatever an implementation reads again. The embedding bags' bytes
count each row the step touches once (the unique rows, from the program's
counter): counting each lookup would count the small tables' rows, which
stay in L2, again at every lookup.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple


def _mlp(dims: Sequence[int]) -> float:
    return float(sum(2 * a * b for a, b in zip(dims[:-1], dims[1:])))


def forward_example(model: Dict) -> float:
    """One example's forward: the bottom MLP, the low-rank cross layers
    (two products a layer), the over arch and its last layer to a logit."""
    f = (1 + len(model["table_rows"])) * model["embedding_dim"]
    cross = model["cross_layers"] * 2 * (2 * f * model["dcn_low_rank_dim"])
    return (_mlp([model["dlrm_dense_in"], *model["bottom_mlp_dims"]]) + cross
            + _mlp([f, *model["over_arch_dims"], 1]))


def train_example(model: Dict) -> float:
    """One example trained: its forward and backward (3 x the forward)."""
    return 3.0 * forward_example(model)


def embedding_bag_fwd(b: int, s: int, t: int, d: int,
                      unique_rows: float) -> Tuple[float, float, str]:
    """The bags of ``b`` examples, ``s`` lookups each in ``t`` bags of
    ``d``-wide fp32 rows: (s - t) d adds an example; reads the touched
    rows and the int32 ids, writes [b, t, d] fp32."""
    flops = float(b) * (s - t) * d
    n_bytes = 4.0 * unique_rows * d + 4.0 * b * s + 4.0 * b * t * d
    return flops, n_bytes, "fp32"


def sparse_update(b: int, s: int, t: int, d: int,
                  unique_rows: float) -> Tuple[float, float, str]:
    """The bags' gradient back to the touched rows and their row-wise
    Adagrad: a d-wide add a lookup, and a row's mean square, scale and
    update (4 d); reads the bags' gradient [b, t, d] and the ids, reads and
    writes each touched row and its fp32 accumulator."""
    flops = float(b) * s * d + 4.0 * unique_rows * d
    n_bytes = 4.0 * b * t * d + 4.0 * b * s + 2.0 * unique_rows * (4 * d + 4)
    return flops, n_bytes, "fp32"


def dcnv2_cross_fwd(n: int, f: int, r: int, layers: int,
                    dtype: str) -> Tuple[float, float, str]:
    """The low-rank cross layers' forward over [n, f] rows: two products
    of 2 n f r a layer, then the bias, product with x0 and residual (3 n f);
    reads x0 and the fp32 weights, writes the fp32 output."""
    flops = layers * (4.0 * n * f * r + 3.0 * n * f)
    n_bytes = 4.0 * (2 * n * f + layers * (2 * f * r + f))
    return flops, n_bytes, dtype
