"""Port parity for training the GCN and GAT variants: one fp32 step
against the JAX trainer's, `make_optimizer` against JAX's optax chain
(no layer-wise groups for these variants), and checkpoints written by
one package and read by the other.

One graph shape: make_synthetic_dataset images at 64 px with
n_segments=64, prepared by the JAX package, batch 8; models at D=16,
n_layers=2, dropout 0, fp32.  Weights come from numpy
(`init_model_numpy`) through models/convert.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from gcn_grabcut_tpu.data.dataset import make_synthetic_dataset, prepare_dataset
from gcn_grabcut_tpu.graph_build import SuperpixelGraphConfig as JConfig
from gcn_grabcut_tpu.train import checkpoints as jckpt
from gcn_grabcut_tpu.train import trainer as jtrainer
from gcn_grabcut_torch.core.graph import make_graph_batch
from gcn_grabcut_torch.models.convert import (jax_variables_from_state_dict,
                                              named_from_params_tree,
                                              state_dict_from_jax)
from gcn_grabcut_torch.models.factory import init_model_numpy
from gcn_grabcut_torch.train import checkpoints as tckpt
from gcn_grabcut_torch.train import trainer as ttrainer

torch.set_num_threads(1)

HW, N_SEGMENTS, BATCH = 64, 64, 8
MODEL_KW = dict(hidden_channels=16, n_layers=2, dropout=0.0)
LOSS_TOL = 1e-6            # one step's loss, relative
GRAD_TOL = 1e-4            # parameter gradients, of each leaf's scale
GRAD_FLOOR = 1e-3          # a leaf's scale is floored at this share of max
STATS_TOL = 1e-6           # InputNorm running statistics after the step
UPDATE_TOL = 1e-6          # parameters after optimiser steps, relative
LOGITS_TOL = 1e-5          # a checkpoint's forward in the other package


def to_port(g):
    return make_graph_batch(**{f: np.asarray(getattr(g, f)) for f in (
        "x", "edge_src", "edge_dst", "edge_attr", "node_mask", "edge_mask",
        "node_area", "fg_ratio", "y")}, device="cpu")


@pytest.fixture(scope="module")
def graphs():
    samples = make_synthetic_dataset(10, HW, seed=5)
    recs = prepare_dataset(samples, JConfig(n_segments=N_SEGMENTS),
                           keep_segments=False)
    return [r[0] for r in recs]


def pair(variant, cfg_kw, graphs, tmp, seed=0):
    """A JAX trainer and a port trainer holding the same numpy-seeded
    weights, with fresh optimisers, and their first batches."""
    jt = jtrainer.Trainer(variant, dict(MODEL_KW),
                          jtrainer.TrainConfig(**cfg_kw), save_dir=tmp / "j")
    jb = jax.tree.map(lambda a: a[:BATCH], jt._bucket(graphs))
    jt._init_state(jb, 2)
    pt = ttrainer.Trainer(variant, dict(MODEL_KW),
                          ttrainer.TrainConfig(**cfg_kw), save_dir=tmp / "t",
                          device="cpu")
    pb = pt._bucket([to_port(g) for g in graphs]).map(lambda a: a[:BATCH])
    pt._init_state(2)
    init_model_numpy(pt.model, seed)
    vs = jax_variables_from_state_dict(pt.model.state_dict())
    jt.state = jt.state.replace(params=vs["params"],
                                batch_stats=vs["batch_stats"])
    return jt, jb, pt, pb


@pytest.mark.parametrize("variant", ["gcn", "gat"])
def test_one_step_matches_jax(graphs, tmp_path, variant):
    cfg = dict(bf16=False, seed=0, batch_size=BATCH, weight_decay=3e-4)
    jt, jb, pt, pb = pair(variant, cfg, graphs, tmp_path, seed=1)
    w = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)   # a wrapped batch

    def loss(params):
        logits, upd = jt.model.apply(
            {"params": params, "batch_stats": jt.state.batch_stats}, jb,
            train=True, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        return jt.loss_fn(logits, jb.y, jb.node_mask, area=jb.node_area,
                          fg_ratio=jb.fg_ratio,
                          graph_weight=jnp.asarray(w)), upd["batch_stats"]
    (jl, jstats), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jt.state.params)
    tl, tgrads = pt.loss_and_grads(pb, torch.from_numpy(w))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * abs(float(jl))
    jn = named_from_params_tree(jax.device_get(jgrads))
    assert set(jn) == set(tgrads)
    gmax = max(float(v.abs().max()) for v in jn.values())
    for k, v in jn.items():
        scale = max(float(v.abs().max()), GRAD_FLOOR * gmax)
        err = float((tgrads[k] - v).abs().max())
        assert err <= GRAD_TOL * scale, (k, err, scale)
    # Every InputNorm's running statistics after the training forward.
    want = state_dict_from_jax({"params": jt.state.params,
                                "batch_stats": jax.device_get(jstats)})
    sd = pt.model.state_dict()
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                       atol=STATS_TOL, err_msg=k)


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_make_optimizer_gat_matches_jax_chain(tmp_path, optimizer):
    """Three steps of JAX's chain for "gat" (clip, Adam or SGD-nesterov,
    weight decay, the SGDR schedule; no group scale) on the same seeded
    gradients; then the state trees agree."""
    cfg = ttrainer.TrainConfig(bf16=False, optimizer=optimizer,
                               weight_decay=3e-4, t0=1,
                               lr=1e-3 if optimizer == "adamw" else 0.05)
    model = init_model_numpy(ttrainer.build_model("gat", **MODEL_KW), 2)
    opt, _ = ttrainer.make_optimizer(cfg, model, "gat", 2, 1)
    params = jax_variables_from_state_dict(model.state_dict())["params"]
    jcfg = jtrainer.TrainConfig(**{k: getattr(cfg, k) for k in (
        "bf16", "optimizer", "weight_decay", "t0", "lr")})
    tx, _ = jtrainer.make_optimizer(jcfg, params, "gat", 2, 1)
    state = tx.init(params)
    r = np.random.RandomState(3)
    for _ in range(3):
        grads = jax.tree.map(
            lambda a: (0.05 * r.standard_normal(a.shape)).astype(np.float32),
            params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        opt.step(named_from_params_tree(grads))
    want = named_from_params_tree(jax.device_get(params))
    for k, p in opt.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=UPDATE_TOL, atol=UPDATE_TOL * 1e-2,
                                   err_msg=k)
    jtree = serialization.to_state_dict(jax.device_get(state))
    ttree = opt.state_tree()
    assert (jax.tree_util.tree_structure(jtree)
            == jax.tree_util.tree_structure(ttree))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jtree),
                            jax.tree_util.tree_leaves(ttree)):
        a, b = np.asarray(a), np.asarray(b)
        scale = float(np.abs(a).max()) if a.size else 0.0
        np.testing.assert_allclose(b, a, rtol=0, atol=UPDATE_TOL * scale,
                                   err_msg=str(path))


def test_gat_checkpoints_read_both_ways(graphs, tmp_path):
    """A port-written GAT checkpoint loads in JAX's
    load_model_from_checkpoint with the same forward and optimiser state;
    a JAX-written one loads in the port's load_model_auto and resumes."""
    cfg = dict(bf16=False, seed=0, batch_size=BATCH, weight_decay=3e-4)
    jt, jb, pt, pb = pair("gat", cfg, graphs, tmp_path, seed=4)
    pt.train_step(pb, torch.ones(BATCH))
    pt.save("port.msgpack", epoch=1, score=0.5)
    path = tmp_path / "t" / "port.msgpack"

    jmodel, jvars, meta = jckpt.load_model_from_checkpoint(path)
    assert meta["variant"] == "gat" and meta["model_kwargs"] == MODEL_KW
    g = jax.tree.map(lambda a: a[:2], jb)
    jl = np.asarray(jmodel.apply(jvars, g, train=False))
    pt.model.eval()
    with torch.no_grad():
        tl = pt.model(pb.map(lambda a: a[:2])).numpy()
    np.testing.assert_allclose(tl, jl, atol=LOGITS_TOL)
    restored = jckpt.load_opt_state(path, jt.state.opt_state)
    assert int(restored[1].count) == 1

    # The other way: JAX takes a step and saves; the port reads it.
    jt.state, _ = jt._train_step(jt.state, jb, jnp.ones(BATCH),
                                 jax.random.PRNGKey(0), jnp.float32(1.0))
    jt.save("jax.msgpack", epoch=2, score=0.25)
    jpath = tmp_path / "j" / "jax.msgpack"
    model, meta = tckpt.load_model_auto(str(jpath), device="cpu")
    assert meta["variant"] == "gat" and meta["ensemble_size"] == 1
    jl = np.asarray(jt.model.apply(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats},
        g, train=False))
    with torch.no_grad():
        tl = model(pb.map(lambda a: a[:2])).numpy()
    np.testing.assert_allclose(tl, jl, atol=LOGITS_TOL)
    assert pt.load(str(jpath), weights_only=False)["epoch"] == 2
    assert pt.optimizer.count == 1

    # Two GAT checkpoints load as an ensemble.
    ens, meta = tckpt.load_model_auto(f"{path},{jpath}", device="cpu")
    assert meta["ensemble_size"] == 2 and ens.supports_banded_attention
