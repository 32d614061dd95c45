"""Weights between the JAX package's flax variables and the port's modules.

The JAX ResGCNNet keeps its weights as ``{"params": ..., "batch_stats":
...}`` nested dicts (the tree ``train/checkpoints.py`` serialises).  Here
that tree, as nested dicts of numpy arrays, becomes a ResGCNNet
``state_dict`` and back:

* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in), ``bias`` as is;
* LayerNorm ``scale`` -> ``weight``;
* InputNorm ``batch_stats`` mean / var -> the ``running_mean`` /
  ``running_var`` buffers.

`param_table` lists the correspondence parameter by parameter; the
trainer writes Adam's moments and the LR groups through it.

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


def param_table(n_layers: int) -> list[tuple[str, tuple, bool]]:
    """(port parameter name, flax parameter path, transposed?) for every
    parameter of a ResGCNNet with `n_layers` blocks."""
    dense, norms = _layout(n_layers)
    table = []
    for path, prefix in dense.items():
        table.append((f"{prefix}.weight", path + ("kernel",), True))
        if not prefix.startswith(("convs.", "sage.lin_r")):
            table.append((f"{prefix}.bias", path + ("bias",), False))
    for path, prefix in norms.items():
        table.append((f"{prefix}.weight", path + ("scale",), False))
        table.append((f"{prefix}.bias", path + ("bias",), False))
    table += [(f"convs.{i}.bias", (f"gcn_{i}", "bias"), False)
              for i in range(n_layers)]
    table += [("jk_logits", ("jk_logits",), False),
              ("in_norm.weight", ("in_norm", "scale"), False),
              ("in_norm.bias", ("in_norm", "bias"), False)]
    return table


def flax_path(name: str, n_layers: int) -> tuple:
    """The flax parameter path of a port parameter name."""
    for n, path, _ in param_table(n_layers):
        if n == name:
            return path
    raise KeyError(f"{name!r} is not a ResGCNNet parameter")


def params_tree(named: dict, n_layers: int) -> dict:
    """{port parameter name: tensor or array} -> the flax params tree of
    float32 numpy arrays (Dense kernels transposed back to (in, out)).
    Any tree shaped like the parameters maps so: Adam's moments too."""
    tree: dict = {}
    for name, path, transposed in param_table(n_layers):
        a = named[name]
        a = np.array(a.detach().cpu() if torch.is_tensor(a) else a,
                     dtype=np.float32)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = a.T.copy() if transposed else a
    return tree


def named_from_params_tree(tree: dict) -> dict[str, torch.Tensor]:
    """The inverse of `params_tree`: float32 CPU tensors by port name.
    Raises if any leaf of the tree is left unmapped."""
    n_layers = _n_layers(tree)
    out = {}
    for name, path, transposed in param_table(n_layers):
        t = torch.from_numpy(np.array(_get(tree, path), dtype=np.float32))
        out[name] = t.T.contiguous() if transposed else t
    if len(out) != _n_leaves(tree):
        raise ValueError(f"mapped {len(out)} tensors from a tree of "
                         f"{_n_leaves(tree)} leaves")
    return out


def state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """flax {"params", "batch_stats"} tree -> ResGCNNet state_dict.  Raises
    if any leaf of the tree is left unmapped."""
    sd = named_from_params_tree(variables["params"])
    stats = variables["batch_stats"]
    sd["in_norm.running_mean"] = torch.from_numpy(
        np.array(stats["in_norm"]["mean"], dtype=np.float32))
    sd["in_norm.running_var"] = torch.from_numpy(
        np.array(stats["in_norm"]["var"], dtype=np.float32))
    if len(sd) != _n_leaves(variables):
        raise ValueError(f"mapped {len(sd)} tensors from a tree of "
                         f"{_n_leaves(variables)} leaves")
    return sd


def jax_variables_from_state_dict(state_dict: dict) -> dict:
    """The inverse of `state_dict_from_jax`: nested dicts of numpy arrays."""
    n_layers = sum(1 for k in state_dict if k.startswith("convs.")
                   and k.endswith(".bias"))
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    stats = {"in_norm": {"mean": sd["in_norm.running_mean"],
                         "var": sd["in_norm.running_var"]}}
    return {"params": params_tree(sd, n_layers), "batch_stats": stats}


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
