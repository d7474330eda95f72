"""The port's row-sharded embedding lookups (``recsys_tpu_torch/embed``) on
gloo ranks, against the JAX package's ``recsys_tpu/embed/table.py`` on a
JAX mesh of the same shape.

One module-scoped world of 4 gloo ranks (``tests/torch_embed_worker.py``,
started by ``subprocess`` on a ``FileStore``, ``OMP_NUM_THREADS=1``, every
join bounded) holds a V = 64, D = 8 table row-sharded over a 1 x 4 and a
2 x 2 mesh and B = 16 ids split over ``data``, and runs the counterparts
of ``tests/test_embed.py``'s seven tests on each. The JAX side runs the
same lookups on ``jax.devices()[:4]`` in the same ``(data, model)``
shape, since the overflow counts depend on it. Tolerances: forward 1e-6
(exact copies of table rows), backward rtol 1e-5 against the replicated
gather's gradient (JAX's own), the overflow counts equal.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recsys_tpu.embed.table import a2a_capacity as jax_a2a_capacity
from recsys_tpu.embed.table import lookup_a2a_inside as jax_a2a_inside
from recsys_tpu.embed.table import lookup_psum_inside as jax_psum_inside
from recsys_tpu.embed.table import lookup_replicated as jax_lookup_replicated
from recsys_tpu.embed.table import make_sharded_lookup_a2a as jax_lookup_a2a
from recsys_tpu.embed.table import make_sharded_lookup_psum as jax_lookup_psum
from recsys_tpu.parallel.mesh import make_mesh as jax_make_mesh
from recsys_tpu.parallel.sharding import batch_sharding, rows_sharding
from recsys_tpu_torch.embed.table import a2a_capacity, lookup_replicated

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_embed_worker as worker  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = worker.WORLD
V, D, B = 64, 8, 16
JOIN_TIMEOUT_S = 120
MESHES = sorted(worker.MESHES)


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    return {"table": rng.normal(size=(V, D)).astype(np.float32),
            "ids_main": rng.integers(0, V, B).astype(np.int32),
            "ids_dup": np.array([3, 3, 3, 3, 17, 17, 50, 50] * 2, np.int32),
            # every id owned by shard 0 on both meshes (rows 0..15)
            "ids_skew": (np.arange(16) % 8).astype(np.int32),
            # below 0, past V, and every shard's edges
            "ids_oor": np.array([-3, 0, 15, 16, 63, 64, 69, 100, -1, 31, 32, 47, 48, 5, 70,
                                 127], np.int32)}


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """-> [(arrays, records)] by rank."""
    root = tmp_path_factory.mktemp("torch_embed")
    np.savez(root / "inputs.npz", **_inputs())
    out = root / "out"
    out.mkdir()
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests",
                                                            "torch_embed_worker.py"),
                               str(r), str(WORLD), str(root / "store"),
                               str(root / "inputs.npz"), str(out)],
                              cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert [p.returncode for p in procs] == [0] * WORLD, "\n".join(o[-3000:] for o in outs)
    ranks = []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        ranks.append((arrays, json.loads((out / f"rank{r}.json").read_text())))
    return ranks


def _jax_ctx(name):
    return jax_make_mesh(model_parallel=worker.MESHES[name], devices=jax.devices()[:WORLD])


def _global_rows(ranks, name, key):
    """The ranks' row slices in data order (model index 0's), checked equal
    on every model replica."""
    by_data = {}
    for arrays, rec in ranks:
        d, _ = rec[f"{name}/coords"]
        if d in by_data:
            np.testing.assert_array_equal(arrays[f"{name}/{key}"], by_data[d], err_msg=key)
        by_data[d] = arrays[f"{name}/{key}"]
    return np.concatenate([by_data[d] for d in sorted(by_data)])


def _global_grad(ranks, name, key):
    """The shards' gradients in model order (equal on every data replica)."""
    by_model = {}
    for arrays, rec in ranks:
        _, m = rec[f"{name}/coords"]
        if m in by_model:
            np.testing.assert_array_equal(arrays[f"{name}/{key}"], by_model[m], err_msg=key)
        by_model[m] = arrays[f"{name}/{key}"]
    return np.concatenate([by_model[m] for m in sorted(by_model)])


def _place(ctx, table, ids):
    return (jax.device_put(table, rows_sharding(ctx)),
            jax.device_put(ids, batch_sharding(ctx)))


def _ref_grad(table, ids):
    return np.asarray(jax.grad(lambda t: jnp.sum(jax_lookup_replicated(t, ids) ** 2))(
        jnp.asarray(table)))


@pytest.mark.parametrize("name", MESHES)
def test_psum_lookup_matches_replicated(world, name):
    inp = _inputs()
    got = _global_rows(world, name, "psum_fwd")
    np.testing.assert_allclose(got, inp["table"][inp["ids_main"]], rtol=1e-6)
    ctx = _jax_ctx(name)
    want = np.asarray(jax_lookup_psum(ctx)(*_place(ctx, inp["table"], inp["ids_main"])))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", MESHES)
def test_psum_lookup_backward(world, name):
    """The psum's backward is the identity: the shards' gradients equal
    the replicated gather's (an all-reduce there would give n_model x)."""
    inp = _inputs()
    got = _global_grad(world, name, "psum_grad")
    np.testing.assert_allclose(got, _ref_grad(inp["table"], inp["ids_main"]), rtol=1e-5)
    ctx = _jax_ctx(name)
    table, ids = _place(ctx, inp["table"], inp["ids_main"])
    f = jax_lookup_psum(ctx)
    want = np.asarray(jax.grad(lambda t: jnp.sum(f(t, ids) ** 2))(table))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("key", ["main", "dup"])
def test_a2a_lookup_matches_replicated(world, name, key):
    """Capacity 8 is ample for the main ids and for duplicates: no
    overflow, every row exact, as JAX's on the same mesh."""
    inp = _inputs()
    label = "a2a_fwd" if key == "main" else "a2a_dup"
    got = _global_rows(world, name, label)
    ids = inp[f"ids_{key}"]
    np.testing.assert_allclose(got, inp["table"][ids], rtol=1e-6)
    ctx = _jax_ctx(name)
    want, overflow = jax_lookup_a2a(ctx, capacity=worker.CAPACITY)(
        *_place(ctx, inp["table"], ids))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
    rec_key = f"{name}/a2a_overflow" if key == "main" else f"{name}/a2a_dup_overflow"
    for _, rec in world:
        assert rec[rec_key] == int(overflow) == 0


@pytest.mark.parametrize("name", MESHES)
def test_a2a_overflow_reported(world, name):
    """Every id owned by shard 0 at capacity 4: the overflow is counted,
    JAX's count on the same mesh shape."""
    inp = _inputs()
    ctx = _jax_ctx(name)
    _, overflow = jax_lookup_a2a(ctx, capacity=worker.SKEW_CAPACITY)(
        *_place(ctx, inp["table"], inp["ids_skew"]))
    for _, rec in world:
        assert rec[f"{name}/a2a_skew_overflow"] == int(overflow) > 0


@pytest.mark.parametrize("name", MESHES)
def test_a2a_overflow_never_clobbers_fitting_requests(world, name):
    """The first ``capacity`` ids of each bucket, in batch order, are
    served exactly; the rest get zero rows and are counted (4 of each data
    slice's ids fit; JAX's rows and count on the same mesh)."""
    inp = _inputs()
    got = _global_rows(world, name, "a2a_skew")
    ids, cap = inp["ids_skew"], worker.SKEW_CAPACITY
    n_data = WORLD // worker.MESHES[name]
    b_local = B // n_data
    for lo in range(0, B, b_local):
        np.testing.assert_allclose(got[lo:lo + cap], inp["table"][ids[lo:lo + cap]], rtol=1e-6)
        np.testing.assert_array_equal(got[lo + cap:lo + b_local], 0.0)
    ctx = _jax_ctx(name)
    want, overflow = jax_lookup_a2a(ctx, capacity=cap)(*_place(ctx, inp["table"], ids))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
    assert int(overflow) == n_data * (b_local - cap)
    for _, rec in world:
        assert rec[f"{name}/a2a_skew_overflow"] == int(overflow)


@pytest.mark.parametrize("name", MESHES)
def test_a2a_backward(world, name):
    """The gradient through the two exchanges (each its own transpose) and
    the rows' cotangent divided by n_model: the replicated gather's."""
    inp = _inputs()
    got = _global_grad(world, name, "a2a_grad")
    np.testing.assert_allclose(got, _ref_grad(inp["table"], inp["ids_main"]), rtol=1e-5)
    ctx = _jax_ctx(name)
    table, ids = _place(ctx, inp["table"], inp["ids_main"])
    f = jax_lookup_a2a(ctx, capacity=worker.CAPACITY)
    want = np.asarray(jax.grad(lambda t: jnp.sum(f(t, ids)[0] ** 2))(table))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("batch, n, factor", [(16, 2, 2.0), (4096, 4, 2.0), (4096, 3, 1.5),
                                              (100, 8, 0.02), (1, 1, 2.0), (131_072, 1, 0.5),
                                              (1000, 7, 1.0)])
def test_a2a_capacity_matches_jax(batch, n, factor):
    assert a2a_capacity(batch, n, factor) == jax_a2a_capacity(batch, n, factor)


@pytest.mark.parametrize("name", MESHES)
def test_xla_strategy_reads_through_psum(world, name):
    """The trainer's ``lookup_strategy="xla"`` on row-sharded tables is the
    psum body: the same bits forward, the replicated gather's gradient."""
    inp = _inputs()
    for _, rec in world:
        assert rec[f"{name}/xla_equals_psum"] is True
    np.testing.assert_allclose(_global_grad(world, name, "xla_grad"),
                               _ref_grad(inp["table"], inp["ids_main"]), rtol=1e-5)


@pytest.mark.parametrize("name", MESHES)
def test_gather_table_puts_the_whole_table_on_the_first_model_rank(world, name):
    """``parallel.sharding.gather_table`` of each rank's shard, in chunks of
    3 rows: the whole table, bit for bit, on the host of every model group's
    first rank (the counterpart of ``device_get`` on ``rows_sharding``);
    None on the group's other ranks."""
    table = _inputs()["table"]
    for arrays, rec in world:
        _, m = rec[f"{name}/coords"]
        assert rec[f"{name}/gather_table_none"] is (m != 0)
        if m == 0:
            np.testing.assert_array_equal(arrays[f"{name}/gather_table"], table)


def _jax_body(ctx, body, table, ids):
    from jax.sharding import PartitionSpec as P

    f = jax.shard_map(lambda t, i: body(t, i), mesh=ctx.mesh,
                      in_specs=(P(ctx.model_axis, None), P(ctx.data_axis)),
                      out_specs=P(ctx.data_axis, None), check_vma=False)
    return np.asarray(jax.jit(f)(*_place(ctx, table, ids)))


@pytest.mark.parametrize("name", MESHES)
def test_out_of_range_ids_follow_each_body(world, name):
    """Ids below 0 and past V: the psum body gives zero rows (no shard owns
    them), the a2a body clips the owner (a row of the first or last shard,
    or a zero row where the local row is below 0), the replicated gather
    clips to the last row; each equals its JAX body on the same mesh."""
    inp = _inputs()
    table, ids = inp["table"], inp["ids_oor"]
    ctx = _jax_ctx(name)
    n = worker.MESHES[name]
    want_psum = _jax_body(ctx, lambda t, i: jax_psum_inside(t, i, "model"), table, ids)
    want_a2a = _jax_body(ctx, lambda t, i: jax_a2a_inside(t, i, "model", n,
                                                          worker.OOR_CAPACITY)[0], table, ids)
    got_psum = _global_rows(world, name, "oor_psum")
    got_a2a = _global_rows(world, name, "oor_a2a")
    np.testing.assert_array_equal(got_psum, want_psum)
    np.testing.assert_array_equal(got_a2a, want_a2a)
    outside = (ids < 0) | (ids >= V)
    np.testing.assert_array_equal(got_psum[outside], 0.0)
    np.testing.assert_array_equal(got_psum[~outside], table[ids[~outside]])
    assert np.abs(got_a2a[ids >= V]).min() > 0  # the last shard's rows, not zeros
    import torch

    np.testing.assert_array_equal(
        lookup_replicated(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
        np.asarray(jax_lookup_replicated(jnp.asarray(table), jnp.asarray(ids))))
