"""Port parity for the "data" mesh axis and data-parallel training:
gcn_grabcut_torch's `make_mesh`, `shard_graph_batch` and
``Trainer(mesh=...)`` against the port's own single-device trainer and
against the JAX package's ``Trainer(mesh=make_mesh(n_data=4))`` on the
suite's forced host devices.

The port's ranks are logical ranks on the CPU (``devices=["cpu"] * n``):
the gradient sum runs the ring collectives' plain versions.  One graph
shape: the JAX trainer tests' prepared graphs (make_synthetic_dataset(12,
64, seed=7), n_segments=40), D=32, n_layers=2; ResGCNNet and the GCN and
GAT variants (GCNTrimapNet's hidden InputNorms synchronised over the
ranks), fp32, and bfloat16 against the single-device step.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gcn_grabcut_tpu.data.dataset import make_synthetic_dataset, prepare_dataset
from gcn_grabcut_tpu.graph_build import SuperpixelGraphConfig as JConfig
from gcn_grabcut_tpu.parallel import mesh as jmesh
from gcn_grabcut_tpu.train import checkpoints as jckpt
from gcn_grabcut_tpu.train import trainer as jtrainer
from gcn_grabcut_torch.core.graph import make_graph_batch
from gcn_grabcut_torch.models import convert
from gcn_grabcut_torch.models.layers import dense_aggregators
from gcn_grabcut_torch.models.resgcn import ResGCNNet
from gcn_grabcut_torch.parallel import data as pdata
from gcn_grabcut_torch.parallel import partition
from gcn_grabcut_torch.parallel.mesh import (Mesh, batch_sharding, make_mesh,
                                             replicate, replicated,
                                             shard_graph_batch)
from gcn_grabcut_torch.train import trainer as ttrainer

torch.set_num_threads(1)

MODEL_KW = dict(hidden_channels=32, n_layers=2)
FIT_CFG = dict(n_epochs=2, batch_size=4, bf16=False, verbose=False,
               save_every=100, seed=3)
# JAX's own bars for a data-parallel fit against the single-device one
# (tests/test_losses_trainer.py::test_mesh_fit_matches_single_device).
DP_LOSS_RTOL = 2e-4
DP_SCORE_RTOL, DP_SCORE_ATOL = 2e-3, 2e-4
JAX_FIT_TOL = 1e-3         # against JAX's fit (test_torch_train.py's bar)
GRAD_TOL = 1e-5            # one step's gradients, of each leaf's scale ...
# ... floored at this share of the largest.  ctx.attn.bias's exact
# gradient is 0 and both steps give float noise of ~1e-8 of the largest
# there; this floor keeps the other gradient tests' absolute allowance
# (1e-4 of a 1e-3 floor: 1e-7 of the largest).
GRAD_FLOOR = 1e-2
STATS_TOL = 1e-6           # InputNorm's running statistics after a step


def to_port(g):
    return make_graph_batch(**{f: np.asarray(getattr(g, f)) for f in (
        "x", "edge_src", "edge_dst", "edge_attr", "node_mask", "edge_mask",
        "node_area", "fg_ratio", "y")}, device="cpu")


@pytest.fixture(scope="module")
def jgraphs():
    samples = make_synthetic_dataset(n=12, size=64, seed=7)
    recs = prepare_dataset(samples, JConfig(n_segments=40),
                           keep_segments=False)
    return [r[0] for r in recs]


@pytest.fixture(scope="module")
def graphs(jgraphs):
    return [to_port(g) for g in jgraphs]


def cpu_mesh(n_data, n_graph=1):
    return make_mesh(n_data=n_data, n_graph=n_graph,
                     devices=["cpu"] * (n_data * n_graph))


def port_trainer(tmp, n_data=None, model_kw=MODEL_KW, variant="resgcn",
                 **cfg):
    mesh = cpu_mesh(n_data) if n_data else None
    return ttrainer.Trainer(
        variant, dict(model_kw), ttrainer.TrainConfig(**{**FIT_CFG, **cfg}),
        save_dir=tmp, device=None if mesh else "cpu", mesh=mesh)


# ------------------------------------------------------------- the mesh


def test_make_mesh_shapes_and_device_count_check():
    m = cpu_mesh(4, 2)
    assert isinstance(m, Mesh) and m.axis_names == ("data", "graph")
    assert m.shape == {"data": 4, "graph": 2}
    assert m.graph_mesh(3).size == 2 and m.data_mesh(1).size == 4
    assert m.graph_mesh(3) is m.graph_mesh(3)        # one set of signals
    # n_data defaults to every device over n_graph, as JAX's.
    assert make_mesh(n_graph=2, devices=["cpu"] * 6).shape["data"] == 3
    with pytest.raises(ValueError, match="device"):
        make_mesh(n_data=4, n_graph=2, devices=["cpu"] * 7)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_mesh(n_data=2, devices=["cpu", "meta"])


def test_default_mesh_is_the_cards():
    if torch.cuda.is_available():
        assert make_mesh(n_data=1).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(n_data=1)


def test_shard_graph_batch_splits_g_in_order(graphs):
    batch = ttrainer.Trainer("resgcn", dict(MODEL_KW), device="cpu")._bucket(
        graphs[:8])
    mesh = cpu_mesh(4)
    shards = shard_graph_batch(batch, mesh)
    assert len(shards) == 4
    for r, s in enumerate(shards):
        for f in dataclasses.fields(batch):
            want = getattr(batch, f.name)[2 * r:2 * r + 2]
            assert torch.equal(getattr(s, f.name), want), f.name
    w = torch.arange(8.0)
    assert [t.tolist() for t in batch_sharding(mesh).place(w)] == [
        [0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
    assert all(t is w for t in replicated(mesh).place(w))
    tree = replicate({"a": [w, (w,)]}, mesh)
    assert tree["a"][1][0].device == mesh.device
    with pytest.raises(ValueError, match="does not split over 4"):
        shard_graph_batch(batch.map(lambda a: a[:6]), mesh)


def test_batch_draws_are_slices_of_one_draw():
    gen = torch.Generator().manual_seed(5)
    want = [torch.rand((8, 3, 2), generator=gen),
            torch.rand((8, 1, 1), generator=gen)]
    draws = pdata.BatchDraws(torch.Generator().manual_seed(5), 4)
    for r in (2, 0, 3, 1):
        src = draws.rank(r)
        for shape, full in zip(((2, 3, 2), (2, 1, 1)), want):
            assert torch.equal(src.rand(shape, "cpu"), full[2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="draws"):
        d = pdata.BatchDraws(torch.Generator(), 2)
        d.rank(0).rand((1, 4), "cpu")
        d.rank(1).rand((1, 5), "cpu")


def test_lock_step_meets_in_rank_order_and_raises():
    """LockStep runs the ranks one at a time in rank order, hands every
    rank the sum at each meeting, and raises a rank's error without
    hanging the others."""
    order = []
    step = pdata.LockStep(3)

    def fn(r):
        order.append(r)
        a = step.total(r, torch.tensor([float(r + 1)]))
        order.append(r)
        b = step.total(r, a * (r + 1))
        return float(a), float(b)
    assert step.run(fn) == [(6.0, 36.0)] * 3
    assert order == [0, 1, 2] * 2

    def bad(r):
        step.total(r, torch.ones(1))
        if r == 1:
            raise ValueError("rank 1")
        return step.total(r, torch.ones(1))
    step = pdata.LockStep(3)
    with pytest.raises(ValueError, match="rank 1"):
        step.run(bad)


def test_lock_step_stress():
    """16 ranks (more than the cores) meeting 40 times with the switch
    interval cut short: every meeting's sum is every rank's, in rank
    order; the run ends within its timeout."""
    import sys
    import threading
    n, meetings = 16, 40
    step, seen, done = pdata.LockStep(n), [], []

    def fn(r):
        for i in range(meetings):
            seen.append(r)
            total = step.total(r, torch.tensor([float(r + i)]))
            assert float(total) == sum(q + i for q in range(n))
        return r
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runner = threading.Thread(target=lambda: done.append(step.run(fn)))
        runner.start()
        runner.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not runner.is_alive()
    assert done == [list(range(n))]
    assert seen == list(range(n)) * meetings


@pytest.mark.parametrize("n", [2, 3, 4])
def test_sum_gradients_is_the_ring_sum(n):
    """Each rank's leaves flattened to (rows, 128), summed in ring order
    by the plain reduce-scatter and gathered: the per-leaf sums."""
    r = np.random.RandomState(n)
    shapes = [(7, 3), (300,), (2, 2, 5)]
    per_rank = [[torch.from_numpy(r.randn(*s).astype(np.float32))
                 for s in shapes] for _ in range(n)]
    got = pdata.sum_gradients(per_rank, cpu_mesh(n).data_mesh(0))
    for i, s in enumerate(shapes):
        want = sum(gs[i] for gs in per_rank)
        assert got[i].shape == s
        torch.testing.assert_close(got[i], want, rtol=1e-6, atol=1e-6)
    bufs = [pdata.flat_rows(gs, n)[0] for gs in per_rank]
    assert bufs[0].shape[0] % n == 0 and bufs[0].shape[1] == pdata.GRAD_COLS


def test_two_d_mesh_graph_row_matches_dense_oracle():
    """A (2, 2) mesh's graph axis through mesh_aggregators equals the dense
    forward; the 2-D mesh itself takes the XLA halo and refuses the ring
    halo, as JAX's does."""
    r = np.random.RandomState(0)
    n, e = 96, 500
    src = r.randint(0, n, e)
    dst = np.clip(src + r.randint(-20, 20, e), 0, n - 1)
    keep = src != dst
    src, dst = (np.concatenate([src[keep], dst[keep]]),
                np.concatenate([dst[keep], src[keep]]))
    mask = np.ones(len(src), np.float32)
    g = make_graph_batch(r.randn(1, n, 19), src[None], dst[None],
                         r.rand(1, len(src), 5), np.ones((1, n)), mask[None],
                         device="cpu")
    model = ResGCNNet(hidden_channels=32, n_layers=2,
                      generator=torch.Generator().manual_seed(1))
    mesh = cpu_mesh(2, 2)
    with torch.no_grad():
        want = model(g, aggregators=dense_aggregators(g))
        for m in (mesh.graph_mesh(0), mesh.graph_mesh(1), mesh):
            aggs = partition.mesh_aggregators(m, src, dst, mask, n,
                                              method="allgather", halo="xla")
            torch.testing.assert_close(model(g, aggregators=aggs), want,
                                       rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="single-axis"):
        partition.mesh_aggregators(mesh, src, dst, mask, n,
                                   method="allgather", halo="pallas_ring")
    with pytest.raises(ValueError, match="single-axis"):
        partition.sharded_scatter_add(mesh, n, halo="pallas_ring")


# ------------------------------------------------------------- training


def leaf_errors(got: dict, want: dict) -> float:
    gmax = max(float(v.abs().max()) for v in want.values())
    return max(float((got[k] - v).abs().max())
               / max(float(v.abs().max()), GRAD_FLOOR * gmax)
               for k, v in want.items())


@pytest.mark.parametrize("n_data, weights", [
    (4, [1] * 8), (2, [1] * 8), (4, [1, 1, 1, 1, 1, 0, 0, 0])])
def test_one_step_matches_solo(graphs, tmp_path, n_data, weights):
    """One data-parallel step with dropout and prior dropout on: the loss,
    every gradient leaf, InputNorm's running statistics and the drawn
    masks are the single-device step's."""
    cfg = dict(batch_size=8, prior_dropout=0.3, weight_decay=3e-4)
    out = {}
    for name, n in (("solo", None), ("dp", n_data)):
        tr = port_trainer(tmp_path / name, n, **cfg)
        tr._init_state(1)
        batch = tr._bucket(graphs[:8])
        w = torch.tensor(weights, dtype=torch.float32)
        loss, grads = tr.loss_and_grads(batch, w)
        out[name] = dict(loss=float(loss), grads=grads,
                         mean=tr.model.in_norm.running_mean.clone(),
                         var=tr.model.in_norm.running_var.clone(),
                         next=torch.rand(3, generator=tr.generator))
    s, d = out["solo"], out["dp"]
    assert abs(d["loss"] - s["loss"]) <= GRAD_TOL * abs(s["loss"])
    assert leaf_errors(d["grads"], s["grads"]) <= GRAD_TOL
    torch.testing.assert_close(d["mean"], s["mean"], rtol=0, atol=STATS_TOL)
    torch.testing.assert_close(d["var"], s["var"], rtol=0, atol=STATS_TOL)
    # The generator drew exactly the single-device step's numbers.
    assert torch.equal(d["next"], s["next"])


def test_fit_matches_solo(graphs, tmp_path):
    """JAX's data-parallel fit test on the port, with dropout and prior
    dropout on: a 4-rank fit reproduces the single-device history."""
    hist = {n: port_trainer(tmp_path / str(n), n, prior_dropout=0.1).fit(
        graphs[:8], graphs[9:]) for n in (4, None)}
    np.testing.assert_allclose(hist[4]["train_loss"],
                               hist[None]["train_loss"], rtol=DP_LOSS_RTOL)
    np.testing.assert_allclose(hist[4]["val_score"], hist[None]["val_score"],
                               rtol=DP_SCORE_RTOL, atol=DP_SCORE_ATOL)
    np.testing.assert_allclose(hist[4]["val_loss"], hist[None]["val_loss"],
                               rtol=DP_LOSS_RTOL)


def test_fit_matches_jax_mesh_fit(jgraphs, graphs, tmp_path):
    """The port's 4-rank fit against JAX's Trainer on a 4-device mesh,
    both resuming one JAX-written epoch-0 checkpoint, dropout 0."""
    kw = dict(MODEL_KW, dropout=0.0)
    cfg = dict(FIT_CFG, n_epochs=3)
    init = jtrainer.Trainer("resgcn", dict(kw), jtrainer.TrainConfig(**cfg),
                            save_dir=tmp_path / "init")
    data = init._bucket(jgraphs[:8])
    init._init_state(jax.tree.map(lambda a: a[:4], data), 2)
    start = tmp_path / "start.msgpack"
    jckpt.save_checkpoint(start, init.state.params, init.state.batch_stats,
                          meta=dict(epoch=0, score=None, variant="resgcn",
                                    model_kwargs=kw))
    jh = jtrainer.Trainer(
        "resgcn", dict(kw), jtrainer.TrainConfig(**cfg),
        save_dir=tmp_path / "j", mesh=jmesh.make_mesh(n_data=4, n_graph=1)
    ).fit(jgraphs[:8], jgraphs[9:], resume_from=str(start))
    th = port_trainer(tmp_path / "t", 4, model_kw=kw, n_epochs=3).fit(
        graphs[:8], graphs[9:], resume_from=str(start))
    assert len(th["train_loss"]) == len(jh["train_loss"]) == 3
    np.testing.assert_allclose(th["train_loss"], jh["train_loss"],
                               rtol=JAX_FIT_TOL)
    np.testing.assert_allclose(th["val_loss"], jh["val_loss"],
                               rtol=JAX_FIT_TOL)
    np.testing.assert_allclose(th["val_score"], jh["val_score"],
                               atol=JAX_FIT_TOL)


def test_batch_rounds_to_the_data_axis(graphs, tmp_path):
    """JAX's rounding test: batch 6 over 4 ranks steps 4 graphs, the last
    batch wraps with zero weight, and training stays finite."""
    tr = port_trainer(tmp_path, 4, n_epochs=1, batch_size=6)
    assert tr._batch_size(9) == 4
    assert tr._batch_size(2) == 4
    hist = tr.fit(graphs[:9], graphs[9:])
    assert np.isfinite(hist["train_loss"]).all()
    assert np.isfinite(hist["val_score"]).all()


def test_checkpoint_is_a_solo_one(graphs, tmp_path):
    """A data-parallel checkpoint holds flax's bytes: JAX's loader reads
    the trained weights, and a single-device trainer holding the same
    state writes the same file."""
    tr = port_trainer(tmp_path / "dp", 4, n_epochs=1)
    tr.fit(graphs[:8], graphs[9:])
    path = tmp_path / "dp" / "final_model.msgpack"
    params, stats, meta = jckpt.load_checkpoint(path)
    want = convert.jax_variables_from_state_dict(tr.model.state_dict())
    got = jax.tree.leaves({"params": params, "batch_stats": stats})
    ref = jax.tree.leaves(want)
    assert len(got) == len(ref) and meta["epoch"] == 1
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    solo = port_trainer(tmp_path / "solo", None, n_epochs=1)
    solo._init_state(2)
    solo.load(str(path), weights_only=False)
    solo.save("final_model.msgpack", epoch=1)
    assert (tmp_path / "solo" / "final_model.msgpack").read_bytes() == \
        path.read_bytes()


def test_device_other_than_the_mesh_is_refused(tmp_path):
    with pytest.raises(ValueError, match="mesh's"):
        ttrainer.Trainer("resgcn", dict(MODEL_KW), save_dir=tmp_path,
                         device="meta", mesh=cpu_mesh(2))


# ---------------------------------------- the GCN and GAT variants, bf16

# GCNTrimapNet in bfloat16 against its single-device fit: JAX's own
# 4-device fit drifts 4.3e-4 / 1.1e-3 from its solo one on these graphs.
GCN_BF16_RTOL = 2.5e-3


@pytest.mark.parametrize("variant", ["gcn", "gat"])
@pytest.mark.parametrize("n_data, weights", [
    (4, [1] * 8), (2, [1, 1, 1, 1, 1, 0, 0, 0])])
def test_variant_one_step_matches_solo(graphs, tmp_path, variant, n_data,
                                       weights):
    """One data-parallel step of GCNTrimapNet (every hidden InputNorm
    normalised with the whole batch's statistics, the gradient through
    them reaching every rank) and of GATTrimapNet, dropout and prior
    dropout on: the loss, every gradient leaf, every InputNorm's running
    statistics and the generator's state are the single-device step's."""
    cfg = dict(batch_size=8, prior_dropout=0.3, weight_decay=3e-4)
    out = {}
    for name, n in (("solo", None), ("dp", n_data)):
        tr = port_trainer(tmp_path / name, n, variant=variant, **cfg)
        tr._init_state(1)
        batch = tr._bucket(graphs[:8])
        w = torch.tensor(weights, dtype=torch.float32)
        loss, grads = tr.loss_and_grads(batch, w)
        out[name] = dict(loss=float(loss), grads=grads,
                         stats={k: v.clone() for k, v in
                                tr.model.named_buffers()},
                         next=torch.rand(3, generator=tr.generator))
    s, d = out["solo"], out["dp"]
    # Two buffers a norm: in_norm, input_bn, bns.0-1 and head_bn (GCN).
    assert len(s["stats"]) == {"gcn": 10, "gat": 2}[variant]
    assert abs(d["loss"] - s["loss"]) <= GRAD_TOL * abs(s["loss"])
    assert leaf_errors(d["grads"], s["grads"]) <= GRAD_TOL
    for k, v in s["stats"].items():
        torch.testing.assert_close(d["stats"][k], v, rtol=0, atol=STATS_TOL)
    assert torch.equal(d["next"], s["next"])


@pytest.mark.parametrize("variant", ["gcn", "gat"])
def test_variant_fit_matches_solo(graphs, tmp_path, variant):
    """JAX's data-parallel fit test for the GCN and GAT variants, at its
    bars (train loss and validation score): a 4-rank fit with dropout and
    prior dropout on gives the single-device history.  GCNTrimapNet's
    validation loss is not held to the training bar: the biases ahead of
    its InputNorms have a gradient that is exactly 0 and in float is
    noise of either sign, which Adam turns into steps of the full learning
    rate; in training the norms cancel them, in evaluation the running
    statistics do not."""
    hist = {n: port_trainer(tmp_path / str(n), n, variant=variant,
                            prior_dropout=0.1).fit(graphs[:8], graphs[9:])
            for n in (4, None)}
    np.testing.assert_allclose(hist[4]["train_loss"],
                               hist[None]["train_loss"], rtol=DP_LOSS_RTOL)
    np.testing.assert_allclose(hist[4]["val_score"], hist[None]["val_score"],
                               rtol=DP_SCORE_RTOL, atol=DP_SCORE_ATOL)


@pytest.mark.parametrize("variant", ["gcn", "gat"])
def test_variant_fit_matches_jax_mesh_fit(jgraphs, graphs, tmp_path,
                                          variant):
    """The port's 4-rank fit of each variant against JAX's Trainer on a
    4-device mesh (where XLA synchronises GCNTrimapNet's batch norms),
    both resuming one JAX-written epoch-0 checkpoint, dropout 0."""
    kw = dict(MODEL_KW, dropout=0.0)
    cfg = dict(FIT_CFG, n_epochs=2)
    init = jtrainer.Trainer(variant, dict(kw), jtrainer.TrainConfig(**cfg),
                            save_dir=tmp_path / "init")
    data = init._bucket(jgraphs[:8])
    init._init_state(jax.tree.map(lambda a: a[:4], data), 2)
    start = tmp_path / "start.msgpack"
    jckpt.save_checkpoint(start, init.state.params, init.state.batch_stats,
                          meta=dict(epoch=0, score=None, variant=variant,
                                    model_kwargs=kw))
    jh = jtrainer.Trainer(
        variant, dict(kw), jtrainer.TrainConfig(**cfg),
        save_dir=tmp_path / "j", mesh=jmesh.make_mesh(n_data=4, n_graph=1)
    ).fit(jgraphs[:8], jgraphs[9:], resume_from=str(start))
    th = port_trainer(tmp_path / "t", 4, model_kw=kw, variant=variant,
                      n_epochs=2).fit(graphs[:8], graphs[9:],
                                      resume_from=str(start))
    assert len(th["train_loss"]) == len(jh["train_loss"]) == 2
    np.testing.assert_allclose(th["train_loss"], jh["train_loss"],
                               rtol=JAX_FIT_TOL)
    np.testing.assert_allclose(th["val_loss"], jh["val_loss"],
                               rtol=JAX_FIT_TOL)
    np.testing.assert_allclose(th["val_score"], jh["val_score"],
                               atol=JAX_FIT_TOL)


@pytest.mark.parametrize("variant, rtol", [("resgcn", DP_LOSS_RTOL),
                                           ("gcn", GCN_BF16_RTOL)])
def test_bf16_fit_matches_solo(graphs, tmp_path, variant, rtol):
    """bfloat16 compute, JAX's data-parallel fit test (batch 4 over 4
    ranks, dropout on): the weight and bias gradients are float32 sums and
    InputNorm's statistics do not depend on the order of their sum, so the
    4-rank history is the single-device one (JAX's ResGCNNet gap here is
    3.85e-5, within JAX's 2e-4 bar)."""
    hist = {n: port_trainer(tmp_path / str(n), n, variant=variant,
                            bf16=True).fit(graphs[:8], graphs[9:])
            for n in (4, None)}
    np.testing.assert_allclose(hist[4]["train_loss"],
                               hist[None]["train_loss"], rtol=rtol)
    np.testing.assert_allclose(hist[4]["val_score"], hist[None]["val_score"],
                               rtol=DP_SCORE_RTOL, atol=DP_SCORE_ATOL)
