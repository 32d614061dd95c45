"""Weights between the JAX package's flax variables and the port's modules.

The JAX ResGCNNet keeps its weights as ``{"params": ..., "batch_stats":
...}`` nested dicts (the tree ``train/checkpoints.py`` serialises).  Here
that tree, as nested dicts of numpy arrays, becomes a ResGCNNet
``state_dict`` and back:

* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in), ``bias`` as is;
* LayerNorm ``scale`` -> ``weight``;
* InputNorm ``batch_stats`` mean / var -> the ``running_mean`` /
  ``running_var`` buffers.

The port's own seeded initialisation is ``ResGCNNet(generator=...)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .resgcn import ResGCNNet


def _layout(n_layers: int) -> tuple[dict, dict]:
    """(flax Dense path -> torch prefix, flax LayerNorm path -> prefix)."""
    dense = {(name,): name for name in
             ("input_proj", "prior_fc1", "prior_fc2", "fuse_fc", "head")}
    dense.update({
        ("edge_ctx", "Dense_0"): "edge_ctx.fc0",
        ("edge_ctx", "Dense_1"): "edge_ctx.fc1",
        ("edge_ctx", "Dense_2"): "edge_ctx.gate",
        ("ctx", "attn"): "ctx.attn",
        ("ctx", "compress"): "ctx.compress",
        ("ctx", "expand"): "ctx.expand",
        ("sage", "lin_l"): "sage.lin_l",
        ("sage", "lin_r"): "sage.lin_r",
    })
    dense.update({(f"gcn_{i}", "Dense_0"): f"convs.{i}.lin"
                  for i in range(n_layers)})
    norms = {(name,): name for name in ("input_ln", "sage_norm", "fuse_ln")}
    norms[("edge_ctx", "LayerNorm_0")] = "edge_ctx.norm"
    norms.update({(f"norm_{i}",): f"norms.{i}" for i in range(n_layers)})
    return dense, norms


def _n_layers(params: dict) -> int:
    return sum(1 for k in params if k.startswith("gcn_"))


def _get(tree: dict, path: tuple) -> dict:
    for p in path:
        tree = tree[p]
    return tree


def _n_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    return 1


def state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """flax {"params", "batch_stats"} tree -> ResGCNNet state_dict.  Raises
    if any leaf of the tree is left unmapped."""
    params, stats = variables["params"], variables["batch_stats"]
    n_layers = _n_layers(params)
    dense, norms = _layout(n_layers)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {}
    for path, prefix in dense.items():
        node = _get(params, path)
        sd[f"{prefix}.weight"] = t(node["kernel"]).T.contiguous()
        if "bias" in node:
            sd[f"{prefix}.bias"] = t(node["bias"])
    for path, prefix in norms.items():
        node = _get(params, path)
        sd[f"{prefix}.weight"] = t(node["scale"])
        sd[f"{prefix}.bias"] = t(node["bias"])
    for i in range(n_layers):
        sd[f"convs.{i}.bias"] = t(params[f"gcn_{i}"]["bias"])
    sd["jk_logits"] = t(params["jk_logits"])
    sd["in_norm.weight"] = t(params["in_norm"]["scale"])
    sd["in_norm.bias"] = t(params["in_norm"]["bias"])
    sd["in_norm.running_mean"] = t(stats["in_norm"]["mean"])
    sd["in_norm.running_var"] = t(stats["in_norm"]["var"])
    if len(sd) != _n_leaves(variables):
        raise ValueError(f"mapped {len(sd)} tensors from a tree of "
                         f"{_n_leaves(variables)} leaves")
    return sd


def jax_variables_from_state_dict(state_dict: dict) -> dict:
    """The inverse of `state_dict_from_jax`: nested dicts of numpy arrays."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    n_layers = sum(1 for k in sd if k.startswith("convs.")
                   and k.endswith(".bias"))
    dense, norms = _layout(n_layers)
    params: dict = {}

    def put(path, leaf, value):
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value

    for path, prefix in dense.items():
        put(path, "kernel", sd[f"{prefix}.weight"].T.copy())
        if f"{prefix}.bias" in sd:
            put(path, "bias", sd[f"{prefix}.bias"])
    for path, prefix in norms.items():
        put(path, "scale", sd[f"{prefix}.weight"])
        put(path, "bias", sd[f"{prefix}.bias"])
    for i in range(n_layers):
        put((f"gcn_{i}",), "bias", sd[f"convs.{i}.bias"])
    params["jk_logits"] = sd["jk_logits"]
    put(("in_norm",), "scale", sd["in_norm.weight"])
    put(("in_norm",), "bias", sd["in_norm.bias"])
    stats = {"in_norm": {"mean": sd["in_norm.running_mean"],
                         "var": sd["in_norm.running_var"]}}
    return {"params": params, "batch_stats": stats}


def resgcn_from_jax(variables: dict, device=None) -> ResGCNNet:
    """A ResGCNNet in eval mode holding the JAX variables' weights; sizes
    are read from the tree."""
    params = variables["params"]
    in_ch, hidden = np.shape(params["input_proj"]["kernel"])
    model = ResGCNNet(
        in_channels=in_ch,
        edge_channels=np.shape(params["edge_ctx"]["Dense_0"]["kernel"])[0],
        hidden_channels=hidden, n_layers=_n_layers(params),
        n_classes=np.shape(params["head"]["kernel"])[1])
    model.load_state_dict(state_dict_from_jax(variables))
    if device is not None:
        model.to(device)
    return model.eval()
