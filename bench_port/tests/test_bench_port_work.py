"""The work counts against hand counts at small shapes."""

import pytest

from bench_port.work import model, ops, peaks


def test_topk_counts():
    # 2 queries x 3 items x d 4: 24 multiply-adds; reads 2x4 + 3x4 fp32,
    # writes 2 x 2 (fp32 score + int64 id)
    assert ops.topk(q=2, n=3, d=4, k=2) == (48.0, 4 * 20 + 2 * 2 * 12, "fp32")


def test_dcn_cross_fwd_counts():
    # 2 layers over 3 rows of 4: per row and layer a dot (8) and 3 x 4 more
    flops, n_bytes, prec = ops.dcn_cross_fwd(n=3, f=4, layers=2)
    assert flops == 2 * 3 * (8 + 12)
    assert n_bytes == 4 * (3 * 4 + 3 * 4 + 2 * 2 * 4)
    assert prec == "fp32"


def test_flash_ce_counts():
    f, b, p = ops.flash_ce_fwd(bq=2, bk=3, d=4, dtype="bf16")
    assert f == 2 * 2 * 3 * 4 and p == "bf16"
    # bf16 operands (2 + 3 rows of 4), corr and ids of the columns, ids
    # and positives of the rows, the fp32 loss
    assert b == 2 * 5 * 4 + 4 * (3 + 3 + 2 + 2) + 4 * 2
    f, b, p = ops.flash_ce_bwd(bq=2, bk=3, d=4, dtype="fp32")
    assert f == 2 * (2 * 2 * 3 * 4)
    # reads u, v (fp32), corr, ids x 2, positives, lse and g; writes du,
    # dv (fp32) and the column gradient
    assert b == 4 * 5 * 4 + 4 * (3 + 3 + 2 + 2) + 4 * 2 * 2 + 4 * 5 * 4 + 4 * 3


def test_model_flops():
    m = {"embedding_dim": 4, "user_tower_dims": [8], "item_tower_dims": [8],
         "cross_layers": 1, "dnn_dims": [2], "dense_features": 0}
    assert model.tower(m) == 2 * (4 * 8 + 8 * 4)
    # F = 8: cross 5 x 8, deep 8 -> 2, heads over 8 + 2 = 10 columns
    assert model.ranker(m) == 40 + 2 * 8 * 2 + 2 * 2 * 10
    assert model.serve_request(m, n_items=5, rerank=3) == (
        model.tower(m) + 2 * 5 * 4 + 3 * model.ranker(m))
    # 3 x forward of two towers and the ranker; logits over 6 candidates
    # forward and dU, dV over the 2 in-batch columns
    assert model.train_example(m, batch=2, n_candidates=6) == (
        3 * (2 * model.tower(m) + model.ranker(m)) + 2 * 6 * 4 * 2 + 2 * 2 * 4)


@pytest.mark.parametrize("flops,n_bytes,prec,kind", [
    (989e12, 1.0, "bf16", "flops"), (1.0, 3.35e12, "bf16", "bytes"),
    (67e12, 3.35e12 / 2, "fp32", "flops")])
def test_bound_names_its_side(flops, n_bytes, prec, kind):
    t, which = peaks.bound_s(flops, n_bytes, prec)
    assert which == kind and t == pytest.approx(1.0 if kind == "flops" else 1.0)
