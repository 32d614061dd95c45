"""Port parity: the graph-sharded aggregation (parallel/) against the JAX
package.

The JAX side runs as its own tests run it, with the Pallas ring kernels in
interpret mode on the suite's 8 virtual CPU devices; the port runs its plain
versions on the CPU over a mesh of logical ranks (``make_graph_mesh(n,
device="cpu")``).  Inputs are seeded numpy arrays handed to both; the
weights are the port's seeded initialisation, perturbed, as the JAX
variable tree both sides load.  JAX forwards and gradients run under
`jax.jit`, which keeps this file to about a minute of one core.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from gcn_grabcut_tpu import build_model
from gcn_grabcut_tpu.core.graph import single_graph
from gcn_grabcut_tpu.parallel import partition as jpart
from gcn_grabcut_tpu.parallel import ring_pallas as jring
from gcn_grabcut_torch.core.graph import make_graph_batch
from gcn_grabcut_torch.models import convert
from gcn_grabcut_torch.models.resgcn import ResGCNNet
from gcn_grabcut_torch.parallel import partition, ring
from gcn_grabcut_torch.parallel.mesh import (SIGNAL_BLOCKS, GraphMesh,
                                               make_graph_mesh)

torch.set_num_threads(1)

BLOCK, D = 16, 128       # the JAX ring tests' per-device block


def jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("graph",))


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at each value (8 significant bits)."""
    mag = np.maximum(np.abs(a), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def rounded(a: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """`a` as it is held in `dtype`, back in float32."""
    return torch.from_numpy(a).to(dtype).float().numpy()


def scatter_inputs(seed, n=128, e=700, d=128):
    r = np.random.RandomState(seed)
    src = r.randint(0, n, e).astype(np.int32)
    dst = r.randint(0, n, e).astype(np.int32)
    w = r.rand(e).astype(np.float32)
    x = r.randn(n, d).astype(np.float32)
    return r, src, dst, w, x


# -- 1. host-side edge partitioning ---------------------------------------

@pytest.mark.parametrize("fn", ["partition_edges_by_dst",
                                "partition_edges_2d"])
def test_edge_partitions_equal_jax(fn):
    r = np.random.RandomState(3)
    n = 100
    src = r.randint(0, n, 400).astype(np.int32)
    dst = r.randint(0, n, 400).astype(np.int32)
    mask = (r.rand(400) > 0.2) * r.rand(400).astype(np.float32)
    got = getattr(partition, fn)(src, dst, mask, n, 4)
    want = getattr(jpart, fn)(src, dst, mask, n, 4)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- 2-3. the ring collectives --------------------------------------------

@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_all_gather_equals_jax(ndev, dtype):
    x = rounded(np.random.RandomState(ndev).randn(ndev * BLOCK, D)
                .astype(np.float32), getattr(torch, dtype))
    want = np.asarray(jax.jit(shard_map(
        lambda xb: jring.ring_all_gather(xb, "graph"), mesh=jax_mesh(ndev),
        in_specs=P("graph", None), out_specs=P("graph", None),
        check_rep=False))(jnp.asarray(x, dtype))).astype(np.float32)

    mesh = make_graph_mesh(ndev, device="cpu")
    blocks = list(torch.from_numpy(x).to(getattr(torch, dtype))
                  .split(BLOCK))
    outs = ring.ring_all_gather(blocks, mesh)
    assert len(outs) == ndev
    got = torch.cat(outs).float().numpy()     # rank r's copy at row r n B
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.tile(x, (ndev, 1)))


@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_reduce_scatter_equals_jax(ndev, dtype):
    g = rounded(np.random.RandomState(10 + ndev).randn(
        ndev, ndev * BLOCK, D).astype(np.float32), getattr(torch, dtype))
    want = np.asarray(jax.jit(shard_map(
        lambda gs: jring.ring_reduce_scatter(gs[0], "graph"),
        mesh=jax_mesh(ndev), in_specs=P("graph", None, None),
        out_specs=P("graph", None), check_rep=False))(
            jnp.asarray(g, dtype))).astype(np.float32)

    mesh = make_graph_mesh(ndev, device="cpu")
    gs = list(torch.from_numpy(g).to(getattr(torch, dtype)))
    got = torch.cat(ring.ring_reduce_scatter(gs, mesh)).float().numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want) <= bf16_ulp(want)).all()
    # Either way, rank b holds block b of the sum over ranks.
    total = np.concatenate([g[:, b * BLOCK:(b + 1) * BLOCK].sum(0)
                            for b in range(ndev)])
    np.testing.assert_allclose(got, total, rtol=0,
                               atol=0.1 if dtype == "bfloat16" else 1e-5)


def test_ring_reduce_scatter_raises_on_rows_not_a_multiple_of_n():
    mesh = make_graph_mesh(4, device="cpu")
    gs = [torch.zeros(4 * BLOCK + 2, D) for _ in range(4)]
    with pytest.raises(ValueError, match="do not split"):
        ring.ring_reduce_scatter(gs, mesh)


def test_collectives_are_each_others_gradient():
    """d/d blocks of sum_r <all_gather_r, c_r> is the reduce-scatter of
    c, and d/d g of sum_r <reduce_scatter_r, c_r> the all-gather of c."""
    n = 4
    r = np.random.RandomState(5)
    mesh = make_graph_mesh(n, device="cpu")
    blocks = [torch.from_numpy(r.randn(BLOCK, 8).astype(np.float32))
              .requires_grad_() for _ in range(n)]
    c = [torch.from_numpy(r.randn(n * BLOCK, 8).astype(np.float32))
         for _ in range(n)]
    sum(((o * ci).sum() for o, ci in
         zip(ring.ring_all_gather(blocks, mesh), c))).backward()
    want = ring.ring_reduce_scatter_plain(c)
    for b, w in zip(blocks, want):
        torch.testing.assert_close(b.grad, w)

    gs = [ci.clone().requires_grad_() for ci in c]
    cb = [b.detach() for b in blocks]
    sum(((o * ci).sum() for o, ci in
         zip(ring.ring_reduce_scatter(gs, mesh), cb))).backward()
    for g in gs:
        torch.testing.assert_close(g.grad, torch.cat(cb))


def test_unused_outputs_get_zero_gradient():
    mesh = make_graph_mesh(2, device="cpu")
    blocks = [torch.ones(BLOCK, 8, requires_grad=True) for _ in range(2)]
    ring.ring_all_gather(blocks, mesh)[1].sum().backward()
    for b in blocks:
        torch.testing.assert_close(b.grad, torch.ones(BLOCK, 8))


def test_one_rank_mesh_is_the_identity():
    mesh = make_graph_mesh(1, device="cpu")
    x = torch.randn(BLOCK, 8)
    assert ring.ring_all_gather([x], mesh)[0] is x
    assert ring.ring_reduce_scatter([x], mesh)[0] is x


def test_collectives_reject_what_they_do_not_take():
    mesh = make_graph_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="for a mesh of 2 ranks"):
        ring.ring_all_gather([torch.zeros(4, 8)], mesh)
    with pytest.raises(ValueError, match="one shape and dtype"):
        ring.ring_all_gather([torch.zeros(4, 8), torch.zeros(5, 8)], mesh)
    with pytest.raises(ValueError, match="one shape and dtype"):
        ring.ring_all_gather([torch.zeros(4, 8),
                              torch.zeros(4, 8, dtype=torch.bfloat16)], mesh)
    # The kernels' wrappers take only CUDA tensors.
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ring.ring_all_gather_cuda([torch.zeros(4, 8)] * 2, mesh)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ring.ring_reduce_scatter_cuda([torch.zeros(8, 8)] * 2, mesh)


# -- 4-5. the edge-partitioned aggregation --------------------------------

@pytest.mark.parametrize("halo", ["xla", "pallas_ring"])
def test_sharded_scatter_add_matches_jax(halo):
    _, src, dst, w, x = scatter_inputs(0)
    n, n_sh = x.shape[0], 8
    ps, pd, pw = jpart.partition_edges_by_dst(src, dst, w, n, n_sh)
    want = np.asarray(jax.jit(jpart.sharded_scatter_add(
        jax_mesh(n_sh), n, halo=halo))(*map(jnp.asarray, (x, ps, pd, pw))))

    agg = partition.sharded_scatter_add(make_graph_mesh(n_sh, device="cpu"),
                                        n, halo=halo)
    got = agg(torch.from_numpy(x), *(torch.from_numpy(a).long()
                                     for a in (ps, pd)), torch.from_numpy(pw))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    oracle = np.zeros_like(x)
    np.add.at(oracle, dst, x[src] * w[:, None])
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-4, rtol=1e-5)


def test_pallas_halo_gradient_matches_jax():
    r, src, dst, w, x = scatter_inputs(1, e=600)
    tgt = r.randn(*x.shape).astype(np.float32)
    n, n_sh = x.shape[0], 8
    ps, pd, pw = jpart.partition_edges_by_dst(src, dst, w, n, n_sh)
    jagg = jpart.sharded_scatter_add(jax_mesh(n_sh), n, halo="pallas_ring")
    want = np.asarray(jax.jit(jax.grad(lambda xx: jnp.sum(
        (jagg(xx, *map(jnp.asarray, (ps, pd, pw))) - tgt) ** 2)))(
            jnp.asarray(x)))

    agg = partition.sharded_scatter_add(make_graph_mesh(n_sh, device="cpu"),
                                        n, halo="pallas_ring")
    xt = torch.from_numpy(x).requires_grad_()
    out = agg(xt, torch.from_numpy(ps).long(), torch.from_numpy(pd).long(),
              torch.from_numpy(pw))
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-4, rtol=1e-5)


def test_ring_scatter_add_matches_oracle():
    _, src, dst, w, x = scatter_inputs(2, n=64, e=400, d=8)
    s2, d2, w2 = partition.partition_edges_2d(src, dst, w, 64, 4)
    agg = partition.ring_scatter_add(make_graph_mesh(4, device="cpu"), 64)
    got = agg(torch.from_numpy(x), torch.from_numpy(s2),
              torch.from_numpy(d2), torch.from_numpy(w2))
    oracle = np.zeros_like(x)
    np.add.at(oracle, dst, x[src] * w[:, None])
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-5, rtol=1e-5)


def test_sharded_gcn_layer_matches_dense_formula():
    r, src, dst, w, x = scatter_inputs(4, n=64, e=300, d=8)
    weight = r.randn(8, 8).astype(np.float32)
    deg = np.bincount(dst, minlength=64).astype(np.float32) + 1.0
    dis = (1.0 / np.sqrt(deg)).astype(np.float32)
    ps, pd, pm = partition.partition_edges_by_dst(
        src, dst, np.ones_like(w), 64, 4)
    gcn = partition.sharded_gcn_layer(make_graph_mesh(4, device="cpu"), 64)
    got = gcn(torch.from_numpy(x), torch.from_numpy(weight),
              torch.from_numpy(ps).long(), torch.from_numpy(pd).long(),
              torch.from_numpy(pm), torch.from_numpy(dis)).numpy()
    xw = x @ weight
    want = np.zeros_like(xw)
    np.add.at(want, dst, (xw * dis[:, None])[src])
    want = want * dis[:, None] + xw * (dis ** 2)[:, None]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_aggregation_rejects_unknown_options():
    mesh = make_graph_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="unknown halo"):
        partition.sharded_scatter_add(mesh, 8, halo="nccl")
    with pytest.raises(ValueError, match="unknown method"):
        partition.mesh_aggregators(mesh, np.zeros(1), np.zeros(1),
                                   np.ones(1), 8, method="tree")
    agg = partition.sharded_scatter_add(mesh, 8)
    with pytest.raises(ValueError, match="multiple of the 2 ranks"):
        agg(torch.zeros(7, 4), torch.zeros(2).long(), torch.zeros(2).long(),
            torch.zeros(2))


# -- 6-7. the model through mesh_aggregators ------------------------------

def model_graph(n=96, e=500, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(n, 19).astype(np.float32)
    src_l = r.randint(0, n, e)
    dst_l = np.clip(src_l + r.randint(-20, 20, e), 0, n - 1)
    keep = src_l != dst_l
    src = np.concatenate([src_l[keep], dst_l[keep]])
    dst = np.concatenate([dst_l[keep], src_l[keep]])
    attr = r.rand(len(src), 5).astype(np.float32)
    return single_graph(x, src, dst, attr)


def jax_variables(n_layers, hidden=32, seed=0):
    """The JAX model and a seeded variable tree (the port's initialisation,
    converted, then perturbed so no parameter sits at its trivial value)."""
    m = build_model("resgcn", hidden_channels=hidden, n_layers=n_layers)
    port = ResGCNNet(hidden_channels=hidden, n_layers=n_layers,
                     generator=torch.Generator().manual_seed(seed))
    vs = convert.jax_variables_from_state_dict(port.state_dict())
    r = np.random.RandomState(seed + 1)
    vs = jax.tree_util.tree_map(
        lambda a: a + (0.1 * r.randn(*np.shape(a))).astype(np.float32), vs)
    vs["batch_stats"]["in_norm"]["var"] = (
        np.abs(vs["batch_stats"]["in_norm"]["var"]) + 0.5)
    return m, vs


def edges(g):
    return (np.asarray(g.edge_src[0]), np.asarray(g.edge_dst[0]),
            np.asarray(g.edge_mask[0]), g.max_nodes)


def to_port(g):
    return make_graph_batch(*(np.array(a) for a in (
        g.x, g.edge_src, g.edge_dst, g.edge_attr, g.node_mask, g.edge_mask,
        g.node_area)))


@pytest.fixture(scope="module")
def forward_case():
    g = model_graph()
    m, vs = jax_variables(n_layers=2)
    return g, m, vs, {}


@pytest.mark.parametrize("method,halo", [
    ("ring", "xla"), ("ring", "pallas_ring"), ("allgather", "xla"),
    ("allgather", "pallas_ring")])
def test_mesh_aggregators_forward_matches_jax(forward_case, method, halo):
    g, m, vs, cache = forward_case
    # The JAX ring method takes no halo: one reference serves both.
    key = (method, halo if method == "allgather" else None)
    if key not in cache:
        mesh = jax_mesh(4)
        jaggs = jpart.mesh_aggregators(mesh, *edges(g), method=method,
                                       halo=halo)
        with mesh:
            cache[key] = np.asarray(jax.jit(lambda v: m.apply(
                v, g, train=False, aggregators=jaggs))(vs))
    aggs = partition.mesh_aggregators(make_graph_mesh(4, device="cpu"),
                                      *edges(g), method=method, halo=halo)
    with torch.no_grad():
        got = convert.resgcn_from_jax(vs)(to_port(g), aggregators=aggs)
    np.testing.assert_allclose(got.numpy(), cache[key], atol=2e-4,
                               rtol=2e-4)


def test_pallas_halo_parameter_gradients_match_jax():
    g = model_graph(seed=1)
    m, vs = jax_variables(n_layers=1, seed=1)
    c = np.random.RandomState(2).randn(1, g.max_nodes, 3).astype(np.float32)
    mesh = jax_mesh(4)
    jaggs = jpart.mesh_aggregators(mesh, *edges(g), method="allgather",
                                   halo="pallas_ring")
    stats = vs["batch_stats"]

    def loss(params):
        return jnp.sum(m.apply({"params": params, "batch_stats": stats}, g,
                               train=False, aggregators=jaggs) * c)
    with mesh:
        jgrad = jax.jit(jax.grad(loss))(vs["params"])
    want = convert.state_dict_from_jax({"params": jgrad,
                                        "batch_stats": stats})

    model = convert.resgcn_from_jax(vs)
    aggs = partition.mesh_aggregators(make_graph_mesh(4, device="cpu"),
                                      *edges(g), method="allgather",
                                      halo="pallas_ring")
    (model(to_port(g), aggregators=aggs) * torch.from_numpy(c)).sum(
        ).backward()
    grads = dict(model.named_parameters())
    assert len(grads) == len(want) - 2     # InputNorm's running statistics
    # ctx.attn.bias shifts every score of a softmax alike, so its exact
    # gradient is 0 and both sides hold rounding noise: a parameter's scale
    # is floored at 1e-3 of the largest gradient of the model.
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    for name, p in grads.items():
        scale = max(float(want[name].abs().max()), floor)
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-4 * scale, rtol=0, err_msg=name)


# -- 8. the mesh ------------------------------------------------------------

def test_make_graph_mesh_needs_cuda_unless_cpu_is_asked():
    mesh = make_graph_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.device == torch.device("cpu")
    assert mesh.signals.shape[:2] == (4, 2)
    if torch.cuda.is_available():
        assert make_graph_mesh(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_graph_mesh(4)
    with pytest.raises(ValueError):
        make_graph_mesh(0, device="cpu")


@pytest.mark.parametrize("n", [1, 2, 8, 16])
def test_mesh_keeps_two_signal_rows(n):
    """Both one-shot kernels signal on (rank, phase, block) words: entry
    and exit, whatever the ring size."""
    mesh = make_graph_mesh(n, device="cpu")
    assert mesh.signals.shape == (n, 2, SIGNAL_BLOCKS)
    assert mesh.signals.dtype == torch.int64 and not mesh.signals.any()


def test_mesh_over_two_devices_is_not_implemented():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GraphMesh(devices=(torch.device("cpu"), torch.device("cuda", 0)))


def test_epochs_rise_with_every_call():
    mesh = make_graph_mesh(2, device="cpu")
    assert [mesh.next_epoch() for _ in range(3)] == [1, 2, 3]
