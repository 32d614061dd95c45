"""Port parity for the top-level API: every public name of gcn_grabcut_tpu
is exported by gcn_grabcut_torch; Label and the constants carry JAX's
values; single_graph gives JAX's arrays on a seeded graph; stack_variables
and is_ensemble give the ensemble load_model_auto gives.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import gcn_grabcut_tpu as jgt
import gcn_grabcut_torch as gt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MEMBERS = [str(ROOT / f"examples/ensemble_r5/bgc_s4{i}.msgpack")
           for i in (2, 3)]
N_NODES, N_EDGES = 30, 80
CONSTANTS = ("N_NODE_FEATS", "N_EDGE_FEATS", "N_PRIOR_FEATS",
             "N_IMAGE_FEATS", "TRIMAP_BG", "TRIMAP_FG", "TRIMAP_PROB_BG",
             "TRIMAP_PROB_FG", "CLASS_BG", "CLASS_UNK", "CLASS_FG")
FIELDS = ("x", "edge_src", "edge_dst", "edge_attr", "node_mask",
          "edge_mask", "node_area", "fg_ratio", "y")


def public(module) -> set:
    return {n for n in dir(module) if not n.startswith("_")}


def test_every_jax_public_name_is_exported():
    assert sorted(public(jgt) - public(gt)) == []
    assert set(gt.__all__) <= public(gt)


def test_label_and_constants_carry_jax_values():
    assert [(m.name, int(m)) for m in gt.Label] == \
        [(m.name, int(m)) for m in jgt.Label]
    for name in CONSTANTS:
        assert getattr(gt, name) == getattr(jgt, name), name


def seeded_graph(r):
    return dict(x=r.randn(N_NODES, gt.N_NODE_FEATS),
                edge_src=r.randint(0, N_NODES, N_EDGES),
                edge_dst=r.randint(0, N_NODES, N_EDGES),
                edge_attr=r.rand(N_EDGES, gt.N_EDGE_FEATS))


@pytest.mark.parametrize("budget", [
    dict(),
    dict(max_nodes=40, max_edges=100),
    dict(n_nodes=25, max_nodes=32, max_edges=90, targets=True),
], ids=["unpadded", "padded", "targets"])
def test_single_graph_matches_jax(budget):
    r = np.random.RandomState(7)
    kw = seeded_graph(r)
    budget = dict(budget)
    if budget.pop("targets", False):
        kw.update(node_area=r.rand(N_NODES), fg_ratio=r.rand(N_NODES),
                  y=r.randint(0, 3, N_NODES))
    kw.update(budget)
    want = jgt.single_graph(**kw)
    got = gt.single_graph(**kw, device="cpu")
    for f in FIELDS:
        t = getattr(got, f)
        j = np.asarray(getattr(want, f))
        if t is None:      # the port leaves unset targets None, JAX zeros
            assert f in ("fg_ratio", "y") and not j.any()
            continue
        assert t.device.type == "cpu" and t.shape == j.shape, f
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f)


def test_single_graph_takes_tensors_and_checks_budgets():
    kw = {k: torch.as_tensor(v)
          for k, v in seeded_graph(np.random.RandomState(8)).items()}
    g = gt.single_graph(**kw, max_nodes=N_NODES + 2)
    assert g.x.shape == (1, N_NODES + 2, gt.N_NODE_FEATS)
    assert g.edge_src.dtype == torch.int64
    with pytest.raises(ValueError, match="exceed the budgets"):
        gt.single_graph(**kw, max_edges=N_EDGES - 1)


def test_stack_variables_gives_load_model_auto_s_ensemble():
    members = [gt.load_model_from_checkpoint(p, device="cpu")[0]
               for p in MEMBERS]
    stacked = gt.stack_variables(members)
    loaded, meta = gt.load_model_auto(",".join(MEMBERS), device="cpu")
    assert meta["ensemble_size"] == 2
    assert gt.is_ensemble(stacked) and gt.is_ensemble(loaded)
    assert not gt.is_ensemble(members[0])
    assert type(stacked) is type(loaded)
    want = loaded.state_dict()
    got = stacked.eval().state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    g = gt.single_graph(**seeded_graph(np.random.RandomState(9)),
                        device="cpu")
    torch.testing.assert_close(gt.apply_model(stacked, g),
                               gt.apply_model(loaded, g), rtol=0, atol=0)
