"""Port parity for training: gcn_grabcut_torch.train against the JAX
package's train/losses.py and train/trainer.py on the same seeded inputs
and converted weights -- every loss and its gradient, InputNorm's training
statistics, one optimisation step (AdamW and SGD-nesterov), the three
schedules, the epoch order, a short fit, a bfloat16 step and prior
dropout.  One graph shape: make_synthetic_dataset images at 64 px with
n_segments=64 (K = 64 nodes), ResGCNNet D=16, n_layers=2, fp32 unless a
test says otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_grabcut_tpu.data.dataset import make_synthetic_dataset, prepare_dataset
from gcn_grabcut_tpu.graph_build import SuperpixelGraphConfig as JConfig
from gcn_grabcut_tpu.models import layers as jlayers
from gcn_grabcut_tpu.train import checkpoints as jckpt
from gcn_grabcut_tpu.train import losses as jlosses
from gcn_grabcut_tpu.train import trainer as jtrainer
from gcn_grabcut_torch.core.graph import make_graph_batch
from gcn_grabcut_torch.models import layers as tlayers
from gcn_grabcut_torch.models.convert import (named_from_params_tree,
                                              state_dict_from_jax)
from gcn_grabcut_torch.train import losses as tlosses
from gcn_grabcut_torch.train import trainer as ttrainer

torch.set_num_threads(1)

HW, N_SEGMENTS, BATCH = 64, 64, 8
MODEL_KW = dict(hidden_channels=16, n_layers=2, dropout=0.0)
LOSS_TOL = 1e-6            # loss values, relative
LOSS_GRAD_TOL = 1e-5       # d loss / d logits, relative to the largest
STEP_LOSS_TOL = 1e-5       # one training step's loss, relative
GRAD_TOL = 1e-4            # parameter gradients, of each leaf's scale
GRAD_FLOOR = 1e-3          # a leaf's scale is floored at this share of max
STATS_TOL = 1e-6           # InputNorm batch and running statistics
SCHEDULE_TOL = 1e-7        # learning rate per step, relative
FIT_LOSS_TOL = 1e-3        # per-epoch train loss of a 5-epoch fit
BF16_LOSS_TOL = 2e-2       # a bfloat16 step's loss against JAX's


def to_port(g):
    return make_graph_batch(**{f: np.asarray(getattr(g, f)) for f in (
        "x", "edge_src", "edge_dst", "edge_attr", "node_mask", "edge_mask",
        "node_area", "fg_ratio", "y")}, device="cpu")


@pytest.fixture(scope="module")
def graphs():
    """24 prepared synthetic graphs, as the JAX package builds them."""
    samples = make_synthetic_dataset(24, HW, seed=3)
    recs = prepare_dataset(samples, JConfig(n_segments=N_SEGMENTS),
                           keep_segments=False)
    return [r[0] for r in recs]


# --------------------------------------------------------------- losses


def loss_inputs(seed=0, G=3, N=40, dtype=np.float32):
    r = np.random.RandomState(seed)
    logits = (r.randn(G, N, 3) * 2).astype(dtype)
    labels = r.randint(0, 3, (G, N))
    mask = (r.rand(G, N) < 0.85).astype(np.float32)
    area = (r.rand(G, N) * mask).astype(np.float32)
    fg = r.rand(G, N).astype(np.float32)
    gw = np.array([1.0, 0.0, 1.0], np.float32)[:G]
    return logits, labels, mask, area, fg, gw


LOSS_CASES = {
    "focal": lambda m, W, lg, y, nm, a, f, w: m.focal_loss(
        lg, y, nm, gamma=2.0, weight=W),
    "smooth_ce": lambda m, W, lg, y, nm, a, f, w: m.label_smoothing_ce(
        lg, y, nm, smoothing=0.1, weight=W),
    "trimap": lambda m, W, lg, y, nm, a, f, w: m.trimap_loss(
        lg, y, nm, area=a, fg_ratio=f, weight=W,
        graph_weight=w),
    "trimap_plain": lambda m, W, lg, y, nm, a, f, w: m.trimap_loss(
        lg, y, nm, gamma=0.0, area_weighted=False),
    "trimap_no_dice": lambda m, W, lg, y, nm, a, f, w: m.trimap_loss(
        lg, y, nm, area=a, dice_weight=0.0),
    "make_ce": lambda m, W, lg, y, nm, a, f, w: m.make_loss_fn(
        "ce", class_weights=[1.5, 0.8, 1.5])(lg, y, nm, graph_weight=w),
    "make_focal": lambda m, W, lg, y, nm, a, f, w: m.make_loss_fn("focal")(
        lg, y, nm, graph_weight=w),
    "make_smooth": lambda m, W, lg, y, nm, a, f, w: m.make_loss_fn(
        "smooth_ce")(lg, y, nm, graph_weight=w),
    "class_trimap": lambda m, W, lg, y, nm, a, f, w: m.TrimapLoss(
        weight=W)(lg, y, nm, area=a, fg_ratio=f,
                                graph_weight=w),
    "class_focal": lambda m, W, lg, y, nm, a, f, w: m.FocalLoss(gamma=1.5)(
        lg, y, nm),
    "class_smooth": lambda m, W, lg, y, nm, a, f, w: m.LabelSmoothingCE(0.2)(
        lg, y, nm),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_logit_gradient(case):
    logits, labels, mask, area, fg, gw = loss_inputs(seed=len(case))
    fn = LOSS_CASES[case]
    jargs = [jnp.asarray(a) for a in (labels, mask, area, fg, gw)]
    weights = np.array([1.5, 0.8, 1.5], np.float32)
    jval, jgrad = jax.value_and_grad(
        lambda lg: fn(jlosses, jnp.asarray(weights), lg, *jargs))(
            jnp.asarray(logits))
    lt = torch.tensor(logits, requires_grad=True)
    targs = [torch.as_tensor(a) for a in (labels, mask, area, fg, gw)]
    tval = fn(tlosses, torch.from_numpy(weights), lt, *targs)
    tval.backward()
    tval = tval.detach()
    assert abs(float(tval) - float(jval)) <= LOSS_TOL * abs(float(jval))
    jg = np.asarray(jgrad)
    assert np.abs(lt.grad.numpy() - jg).max() <= LOSS_GRAD_TOL * np.abs(
        jg).max()


# ------------------------------------------------------------ InputNorm


@pytest.mark.parametrize("valid", [None, 1])
def test_input_norm_train_statistics(valid):
    """Masked batch statistics and the running update; with one valid
    node the running statistics are used and kept."""
    r = np.random.RandomState(4)
    x = (r.randn(2, 30, 19) * 3 + 1).astype(np.float32)
    mask = (r.rand(2, 30) < 0.7).astype(np.float32)
    if valid is not None:
        mask[:] = 0
        mask[1, 5] = 1
    mean0 = r.randn(19).astype(np.float32)
    var0 = (r.rand(19) + 0.5).astype(np.float32)
    scale = (r.rand(19) + 0.5).astype(np.float32)
    bias = r.randn(19).astype(np.float32)
    mod = jlayers.InputNorm(19)
    y, upd = mod.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), jnp.asarray(mask), train=True,
        mutable=["batch_stats"])
    t = tlayers.InputNorm(19).train()
    with torch.no_grad():
        t.weight.copy_(torch.from_numpy(scale))
        t.bias.copy_(torch.from_numpy(bias))
        t.running_mean.copy_(torch.from_numpy(mean0))
        t.running_var.copy_(torch.from_numpy(var0))
    ty = t(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y),
                               atol=STATS_TOL * 10, rtol=STATS_TOL)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(t.running_mean.numpy(), stats["mean"],
                               atol=STATS_TOL)
    np.testing.assert_allclose(t.running_var.numpy(), stats["var"],
                               atol=STATS_TOL)
    if valid is not None:
        np.testing.assert_array_equal(t.running_mean.numpy(), mean0)


# ------------------------------------------------------ one train step


def make_pair(cfg_kw: dict, data_graphs, model_kw=MODEL_KW, tmp=None):
    """A JAX trainer with its state initialised from PRNGKey(seed) and the
    port's trainer holding the same weights, on the same bucketed data."""
    jt = jtrainer.Trainer("resgcn", dict(model_kw),
                          jtrainer.TrainConfig(**cfg_kw), save_dir=tmp)
    jdata = jt._bucket(data_graphs)
    spe = -(-jdata.n_graphs // BATCH)
    jt._init_state(jax.tree.map(lambda a: a[:BATCH], jdata), spe)
    pt = ttrainer.Trainer("resgcn", dict(model_kw),
                          ttrainer.TrainConfig(**cfg_kw), save_dir=tmp,
                          device="cpu")
    pdata = pt._bucket([to_port(g) for g in data_graphs])
    pt._init_state(spe)
    pt.model.load_state_dict(state_dict_from_jax(
        {"params": jax.device_get(jt.state.params),
         "batch_stats": jax.device_get(jt.state.batch_stats)}))
    return jt, jdata, pt, pdata


def jax_step(jt, batch, w, lr_scale=1.0):
    """(loss, grads tree, new batch_stats, new state) of one JAX step."""
    @jax.jit
    def step(st, batch, w):
        def loss(params):
            logits, upd = jt.model.apply(
                {"params": params, "batch_stats": st.batch_stats}, batch,
                train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            return jt.loss_fn(logits, batch.y, batch.node_mask,
                              area=batch.node_area, fg_ratio=batch.fg_ratio,
                              graph_weight=w), upd["batch_stats"]
        (l, stats), grads = jax.value_and_grad(loss, has_aux=True)(st.params)
        return l, grads, stats, st.apply_gradients(grads,
                                                   jnp.float32(lr_scale))
    l, grads, stats, new = step(jt.state, batch, w)
    return float(l), jax.device_get(grads), jax.device_get(stats), new


def first_batch(jt, jdata, pt, pdata, weights=None):
    w = np.ones(BATCH, np.float32) if weights is None else weights
    jb = jax.tree.map(lambda a: a[:BATCH], jdata)
    pb = pdata.map(lambda a: a[:BATCH])
    return jb, jnp.asarray(w), pb, torch.from_numpy(w)


def check_grads(jgrads: dict, tgrads: dict) -> None:
    jn = named_from_params_tree(jgrads)
    gmax = max(float(v.abs().max()) for v in jn.values())
    for k, v in jn.items():
        scale = max(float(v.abs().max()), GRAD_FLOOR * gmax)
        err = float((tgrads[k] - v).abs().max())
        assert err <= GRAD_TOL * scale, (k, err, scale)


def check_update(jnew, before: dict, after: dict, jgrads: dict,
                 bound: float) -> None:
    """Updates agree within 1e-4 of the leaf's largest update (the
    gradients' own tolerance) where |g| > 1e-6 max|g|; elsewhere Adam's
    first step is about lr * sign(g) in either package, so both are
    bounded by the parameter's lr * group scale."""
    jp = named_from_params_tree(jax.device_get(jnew.params))
    jg = named_from_params_tree(jgrads)
    gmax = max(float(v.abs().max()) for v in jg.values())
    for k in jp:
        uj, ut = jp[k] - before[k], after[k] - before[k]
        sel = jg[k].abs() > 1e-6 * gmax
        # An update is read back as a difference of float32 parameters,
        # so it carries up to an ulp of the parameter from each side.
        ulp = np.spacing(np.abs(before[k][sel].numpy()))
        diff = np.abs(ut[sel].numpy() - uj[sel].numpy())
        scale = float(uj.abs().max())
        assert np.all(diff <= GRAD_TOL * scale + 2 * ulp), (k, diff.max())
        for u in (ut[~sel], uj[~sel]):
            assert u.numel() == 0 or float(u.abs().max()) <= bound * 1.0001


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_one_step(graphs, tmp_path, optimizer):
    cfg = dict(bf16=False, seed=0, batch_size=BATCH, weight_decay=3e-4,
               optimizer=optimizer, lr=1e-3 if optimizer == "adamw" else 0.05)
    jt, jdata, pt, pdata = make_pair(cfg, graphs[:10], tmp=tmp_path)
    w = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)  # a wrapped batch
    jb, jw, pb, pw = first_batch(jt, jdata, pt, pdata, w)
    jl, jgrads, jstats, jnew = jax_step(jt, jb, jw)
    before = {k: v.detach().clone()
              for k, v in pt.optimizer.params.items()}
    tl, tgrads = pt.loss_and_grads(pb, pw)
    assert abs(float(tl) - jl) <= STEP_LOSS_TOL * abs(jl)
    check_grads(jgrads, tgrads)
    np.testing.assert_allclose(pt.model.in_norm.running_mean.numpy(),
                               jstats["in_norm"]["mean"], atol=STATS_TOL)
    np.testing.assert_allclose(pt.model.in_norm.running_var.numpy(),
                               jstats["in_norm"]["var"], atol=STATS_TOL)
    pt.optimizer.step(tgrads, 1.0)
    after = {k: v.detach() for k, v in pt.optimizer.params.items()}
    check_update(jnew, before, after, jgrads, bound=cfg["lr"])
    assert pt.optimizer.count == int(jnew.step) == 1


def test_bf16_step_loss(graphs, tmp_path):
    cfg = dict(bf16=True, seed=0, batch_size=BATCH, weight_decay=3e-4)
    jt, jdata, pt, pdata = make_pair(cfg, graphs[:8], tmp=tmp_path)
    assert pt.model.input_proj.compute_dtype == torch.bfloat16
    jb, jw, pb, pw = first_batch(jt, jdata, pt, pdata)
    jl = jax_step(jt, jb, jw)[0]
    tl, tgrads = pt.loss_and_grads(pb, pw)
    assert abs(float(tl) - jl) <= BF16_LOSS_TOL * abs(jl)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in tgrads.values())


# ------------------------------------------------------------ schedules


@pytest.mark.parametrize("scheduler, spe", [
    ("cosine_warm", 1), ("cosine_warm", 3), ("onecycle", 3),
    ("onecycle", 7), ("plateau", 3), ("none", 3)])
def test_schedules_200_steps(scheduler, spe):
    cfg = dict(n_epochs=40, lr=1e-3, scheduler=scheduler, t0=5, t_mult=2)
    params = {"w": jnp.zeros(3)}
    _, jsched = jtrainer.make_optimizer(jtrainer.TrainConfig(**cfg), params,
                                        "gcn", 2, spe)
    model = ttrainer.build_model("resgcn", hidden_channels=8, n_layers=2)
    _, tsched = ttrainer.make_optimizer(ttrainer.TrainConfig(**cfg), model,
                                        "resgcn", 2, spe)
    want = np.array([float(jsched(jnp.int32(t))) for t in range(200)])
    got = np.array([float(tsched(t)) for t in range(200)])
    assert np.all(np.abs(got - want) <= SCHEDULE_TOL * np.abs(want))


def test_optimizer_state_tree_matches_optax(graphs, tmp_path):
    """The port's optimiser state has the key structure of optax's
    to_state_dict tree of JAX's chain, for every optimiser and schedule."""
    from flax import serialization
    jt, _, pt, _ = make_pair(dict(bf16=False), graphs[:2], tmp=tmp_path)
    params = jt.state.params

    def keys(t):
        return {k: keys(v) for k, v in t.items()} \
            if isinstance(t, dict) else None
    for optimizer in ("adamw", "sgd"):
        for scheduler in ("cosine_warm", "onecycle", "plateau", "none"):
            cfg = dict(bf16=False, optimizer=optimizer, scheduler=scheduler)
            tx, _ = jtrainer.make_optimizer(jtrainer.TrainConfig(**cfg),
                                            params, "resgcn", 2, 3)
            want = serialization.to_state_dict(tx.init(params))
            opt, _ = ttrainer.make_optimizer(ttrainer.TrainConfig(**cfg),
                                             pt.model, "resgcn", 2, 3)
            assert keys(opt.state_tree()) == keys(want), cfg


# ---------------------------------------------------------- epoch order


def test_epoch_permutation_matches(graphs, tmp_path):
    cfg = dict(bf16=False, seed=5, batch_size=BATCH)
    jt, jdata, pt, pdata = make_pair(cfg, graphs[:19], tmp=tmp_path)
    # Mark each graph so a batch reveals which graphs it gathered.
    marks = np.arange(19, dtype=np.float32)
    jdata = jdata.replace(fg_ratio=jnp.asarray(
        np.broadcast_to(marks[:, None], jdata.fg_ratio.shape)))
    pdata = dataclasses.replace(pdata, fg_ratio=torch.from_numpy(
        np.ascontiguousarray(np.broadcast_to(marks[:, None],
                                             tuple(pdata.fg_ratio.shape)))))
    jr, tr = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(3):
        jb = list(jt._batches(jdata, jr, shuffle=True))
        tb = list(pt._batches(pdata, tr, shuffle=True))
        assert len(jb) == len(tb) == 3
        for (jbatch, jw), (tbatch, tw) in zip(jb, tb):
            np.testing.assert_array_equal(tbatch.fg_ratio[:, 0].numpy(),
                                          np.asarray(jbatch.fg_ratio[:, 0]))
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


# ------------------------------------------------------------------ fit


def test_five_epoch_fit_matches(graphs, tmp_path):
    """Both packages resume one JAX-written checkpoint of epoch 0 (the
    same weights, no optimiser state) and fit 5 epochs, dropout 0."""
    train, val = graphs[:18], graphs[18:]
    cfg = dict(n_epochs=5, bf16=False, seed=1, batch_size=BATCH, t0=2,
               weight_decay=3e-4, verbose=False)
    jt, jdata, _, _ = make_pair(cfg, train, tmp=tmp_path / "init")
    start = tmp_path / "start.msgpack"
    jckpt.save_checkpoint(start, jt.state.params, jt.state.batch_stats,
                          meta=dict(epoch=0, score=None, variant="resgcn",
                                    model_kwargs=MODEL_KW))
    jh = jtrainer.Trainer("resgcn", dict(MODEL_KW),
                          jtrainer.TrainConfig(**cfg),
                          save_dir=tmp_path / "j").fit(
        train, val, resume_from=str(start))
    th = ttrainer.Trainer("resgcn", dict(MODEL_KW),
                          ttrainer.TrainConfig(**cfg),
                          save_dir=tmp_path / "t", device="cpu").fit(
        [to_port(g) for g in train], [to_port(g) for g in val],
        resume_from=str(start))
    assert len(th["train_loss"]) == len(jh["train_loss"]) == 5
    np.testing.assert_allclose(th["train_loss"], jh["train_loss"],
                               rtol=FIT_LOSS_TOL)
    np.testing.assert_allclose(th["lr"], jh["lr"], rtol=SCHEDULE_TOL)
    assert int(np.argmax(th["val_score"])) == int(np.argmax(jh["val_score"]))
    for name in ("best_model.msgpack", "final_model.msgpack",
                 "history.json", "epoch_0005.msgpack"):
        assert (tmp_path / "t" / name).is_file()


# ------------------------------------------------------- prior dropout


def test_prior_dropout_zeroes_whole_graph_priors(graphs, tmp_path):
    cfg = dict(bf16=False, seed=2, batch_size=BATCH, prior_dropout=0.5)
    _, _, pt, pdata = make_pair(cfg, graphs[:BATCH], tmp=tmp_path)
    seen = []
    forward = pt.model.forward

    def record(g, *args, **kwargs):
        seen.append(g.x.detach().clone())
        return forward(g, *args, **kwargs)
    pt.model.forward = record
    w = torch.ones(BATCH)
    for _ in range(3):
        pt.loss_and_grads(pdata, w)
    x0 = pdata.x
    dropped = kept = 0
    for x in seen:
        torch.testing.assert_close(x[..., :-3], x0[..., :-3], rtol=0, atol=0)
        for gi in range(BATCH):
            prior, orig = x[gi, :, -3:], x0[gi, :, -3:]
            if torch.equal(prior, orig):
                kept += 1
            else:
                assert not prior.any(), "a graph's prior is partly zeroed"
                dropped += 1
    assert dropped > 0 and kept > 0
    # The draws are seeded: a second trainer drops the same graphs.
    _, _, again, _ = make_pair(cfg, graphs[:BATCH], tmp=tmp_path)
    replay = []
    fwd2 = again.model.forward
    again.model.forward = lambda g, *a, **k: (replay.append(g.x.clone()),
                                              fwd2(g, *a, **k))[1]
    again.loss_and_grads(pdata, w)
    assert torch.equal(replay[0], seen[0])
