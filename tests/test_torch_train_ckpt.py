"""Checkpoints between the packages: a checkpoint the port's Trainer writes
is read by the JAX package's load_checkpoint, load_model_from_checkpoint
and load_opt_state leaf for leaf (and its bytes are flax's encoding of the
same tree); a checkpoint JAX's Trainer.save writes resumes in the port's
Trainer, whose next steps match JAX's resumed steps.  Plus the port's
msgpack encoder against flax's.  64 px synthetic graphs, n_segments=64,
ResGCNNet D=16, n_layers=2, fp32.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
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
from gcn_grabcut_torch.train import checkpoints as tckpt
from gcn_grabcut_torch.train import trainer as ttrainer

torch.set_num_threads(1)

HW, N_SEGMENTS, BATCH = 64, 64, 8
MODEL_KW = dict(hidden_channels=16, n_layers=2, dropout=0.0)
STEP_LOSS_TOL = 1e-5     # a resumed step's loss, relative
LOGITS_TOL = 1e-4        # the two packages' eval forwards of one checkpoint


def to_port(g):
    return make_graph_batch(**{f: np.asarray(getattr(g, f)) for f in (
        "x", "edge_src", "edge_dst", "edge_attr", "node_mask", "edge_mask",
        "node_area", "fg_ratio", "y")}, device="cpu")


@pytest.fixture(scope="module")
def graphs():
    samples = make_synthetic_dataset(10, HW, seed=6)
    recs = prepare_dataset(samples, JConfig(n_segments=N_SEGMENTS),
                           keep_segments=False)
    return [r[0] for r in recs]


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for k, v in enumerate(tree):
            yield from leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def assert_trees_equal(a, b) -> None:
    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=str(k))


def port_trainer(cfg_kw, graphs, tmp):
    """A port trainer after two steps on the first batch."""
    pt = ttrainer.Trainer("resgcn", dict(MODEL_KW),
                          ttrainer.TrainConfig(**cfg_kw), save_dir=tmp,
                          device="cpu")
    data = pt._bucket([to_port(g) for g in graphs])
    pt._init_state(2)
    batch = data.map(lambda a: a[:BATCH])
    for _ in range(2):
        pt.train_step(batch, torch.ones(BATCH))
    return pt, data


@pytest.mark.parametrize("optimizer, scheduler", [
    ("adamw", "cosine_warm"), ("adamw", "plateau"), ("sgd", "onecycle")])
def test_port_checkpoint_reads_in_jax(graphs, tmp_path, optimizer,
                                      scheduler):
    cfg = dict(bf16=False, seed=0, batch_size=BATCH, optimizer=optimizer,
               scheduler=scheduler, weight_decay=3e-4)
    pt, data = port_trainer(cfg, graphs, tmp_path)
    pt.save("port.msgpack", epoch=3, score=0.5)
    path = tmp_path / "port.msgpack"

    params, stats, meta = jckpt.load_checkpoint(path)
    want = jax_variables_from_state_dict(pt.model.state_dict())
    assert_trees_equal(params, want["params"])
    assert_trees_equal(stats, want["batch_stats"])
    assert meta["epoch"] == 3 and meta["score"] == 0.5
    assert meta["variant"] == "resgcn" and meta["model_kwargs"] == MODEL_KW
    assert meta["config"] == json.loads(json.dumps(
        ttrainer.dataclasses.asdict(pt.cfg)))

    # The bytes are flax's encoding of the same payload.
    payload = {"params": want["params"], "batch_stats": want["batch_stats"],
               "meta_json": np.frombuffer(json.dumps(meta).encode(),
                                          np.uint8).copy(),
               "opt_state": pt.optimizer.state_tree()}
    assert path.read_bytes() == serialization.msgpack_serialize(payload)

    # JAX rebuilds the model from the meta and computes the port's logits.
    jmodel, jvars, _ = jckpt.load_model_from_checkpoint(path)
    g = jax.tree.map(lambda a: a[:2], jtrainer.Trainer(
        "resgcn", dict(MODEL_KW), jtrainer.TrainConfig(**cfg),
        save_dir=tmp_path / "j")._bucket(graphs))
    jl = np.asarray(jmodel.apply(jvars, g, train=False))
    with torch.no_grad():
        pt.model.eval()
        tl = pt.model(data.map(lambda a: a[:2])).numpy()
    np.testing.assert_allclose(tl, jl, atol=LOGITS_TOL)

    # JAX's optimiser state restores onto its own chain, leaf for leaf.
    jt = jtrainer.Trainer("resgcn", dict(MODEL_KW),
                          jtrainer.TrainConfig(**cfg),
                          save_dir=tmp_path / "j")
    jt._init_state(g, 2)
    restored = jckpt.load_opt_state(path, jt.state.opt_state)
    assert_trees_equal(serialization.to_state_dict(restored),
                       pt.optimizer.state_tree())
    if optimizer == "adamw":
        assert int(restored[1].count) == 2
        mu = named_from_params_tree(jax.device_get(restored[1].mu))
        for k, v in pt.optimizer.mu.items():
            assert torch.equal(mu[k], v), k


def test_jax_checkpoint_resumes_in_port(graphs, tmp_path):
    """JAX trains one step and saves; both packages resume the file and
    take two more steps on the same batch: the losses match JAX's resumed
    steps, the second one through the resumed Adam moments and count."""
    cfg = dict(bf16=False, seed=0, batch_size=BATCH, weight_decay=3e-4,
               lr=5e-3)
    jt = jtrainer.Trainer("resgcn", dict(MODEL_KW),
                          jtrainer.TrainConfig(**cfg), save_dir=tmp_path)
    jdata = jt._bucket(graphs)
    jb = jax.tree.map(lambda a: a[:BATCH], jdata)
    w = jnp.ones(BATCH)
    jt._init_state(jb, 2)
    jt.state, _ = jt._train_step(jt.state, jb, w, jax.random.PRNGKey(0),
                                 jnp.float32(1.0))
    jt.save("jax.msgpack", epoch=1, score=0.25)

    jr = jtrainer.Trainer("resgcn", dict(MODEL_KW),
                          jtrainer.TrainConfig(**cfg), save_dir=tmp_path)
    jr._init_state(jb, 2)
    assert jr.load("jax.msgpack", weights_only=False)["epoch"] == 1
    pt = ttrainer.Trainer("resgcn", dict(MODEL_KW),
                          ttrainer.TrainConfig(**cfg), save_dir=tmp_path,
                          device="cpu")
    pb = pt._bucket([to_port(g) for g in graphs]).map(lambda a: a[:BATCH])
    pt._init_state(2)
    meta = pt.load(str(tmp_path / "jax.msgpack"), weights_only=False)
    assert meta["epoch"] == 1 and meta["score"] == 0.25
    assert pt.optimizer.count == 1
    for _ in range(2):
        jr.state, jl = jr._train_step(jr.state, jb, w, jax.random.PRNGKey(0),
                                      jnp.float32(1.0))
        tl = pt.train_step(pb, torch.ones(BATCH))
        assert abs(float(tl) - float(jl)) <= STEP_LOSS_TOL * abs(float(jl))
    assert pt.optimizer.count == int(jr.state.opt_state[1].count) == 3
    # As in JAX, the trainer's own step count restarts at a resume (it
    # dates the history's lr); the optimiser's count is the checkpoint's.
    assert pt.step == int(jr.state.step) == 2


def test_fit_resumes_from_a_port_checkpoint(graphs, tmp_path):
    """fit(resume_from=...) continues after the checkpoint's epoch, with
    its best score, in both packages."""
    cfg = dict(bf16=False, seed=0, batch_size=BATCH, n_epochs=3,
               verbose=False)
    pt, _ = port_trainer(cfg, graphs, tmp_path)
    pt.save("mid.msgpack", epoch=2, score=0.99)
    train, val = [to_port(g) for g in graphs[:8]], [to_port(g)
                                                     for g in graphs[8:]]
    again = ttrainer.Trainer("resgcn", dict(MODEL_KW),
                             ttrainer.TrainConfig(**cfg),
                             save_dir=tmp_path / "again", device="cpu")
    h = again.fit(train, val, resume_from=str(tmp_path / "mid.msgpack"))
    assert len(h["train_loss"]) == 1 and again._best_score >= 0.99
    jh = jtrainer.Trainer("resgcn", dict(MODEL_KW),
                          jtrainer.TrainConfig(**cfg),
                          save_dir=tmp_path / "jax").fit(
        graphs[:8], graphs[8:], resume_from=str(tmp_path / "mid.msgpack"))
    assert len(jh["train_loss"]) == 1
    np.testing.assert_allclose(h["train_loss"], jh["train_loss"], rtol=1e-4)


TREES = [
    {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": {}},
    {"k": {str(i): np.int32(i) for i in range(20)}, "s": "x" * 40},
    {"n": [0, 1, -1, -32, -33, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
           -129, -32769, -2 ** 31 - 1, 1.5, None, True, False, b"\x00" * 300]},
    {"big": np.zeros(70000, np.uint8), "e": np.zeros((0, 3), np.float64),
     "u": "é" * 200, "z": np.zeros((), np.int32), "t": [1, [2, [3]]]},
]


@pytest.mark.parametrize("i", range(len(TREES)))
def test_msgpack_encoder_matches_flax(i):
    blob = tckpt.msgpack_serialize(TREES[i])
    assert blob == serialization.msgpack_serialize(TREES[i])
    assert_trees_equal(tckpt.msgpack_restore(blob),
                       serialization.msgpack_restore(blob))


def test_save_checkpoint_is_atomic(tmp_path, monkeypatch):
    """A failed write leaves neither a partial file nor a temporary."""
    path = tmp_path / "c.msgpack"
    tckpt.save_checkpoint(path, {"w": np.ones(3, np.float32)}, {})
    before = path.read_bytes()

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(tckpt.os, "replace", boom)
    with pytest.raises(OSError):
        tckpt.save_checkpoint(path, {"w": np.zeros(3, np.float32)}, {})
    assert path.read_bytes() == before
    assert [p.name for p in tmp_path.iterdir()] == ["c.msgpack"]
    assert tckpt.load_opt_state(path) is None
