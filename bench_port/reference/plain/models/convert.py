"""Weights between the JAX package's flax variables and the port's modules.

The JAX models keep their weights as ``{"params": ..., "batch_stats":
...}`` nested dicts (the tree ``train/checkpoints.py`` serialises).  Here
that tree, as nested dicts of numpy arrays, becomes a ``state_dict`` of
a ResGCNNet:

* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in), ``bias`` as is;
* LayerNorm and InputNorm ``scale`` -> ``weight``;
* InputNorm ``batch_stats`` mean / var -> the ``running_mean`` /
  ``running_var`` buffers.

`param_table` lists the correspondence parameter by parameter.
"""

from __future__ import annotations

import numpy as np
import torch



def _resgcn_layout(n_layers: int):
    """(Dense path -> port prefix, norm path -> prefix, other parameter
    path -> name, InputNorm modules with batch statistics, the Dense
    prefixes without a bias)."""
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
    norms = {(name,): name for name in ("input_ln", "sage_norm", "fuse_ln",
                                        "in_norm")}
    norms[("edge_ctx", "LayerNorm_0")] = "edge_ctx.norm"
    norms.update({(f"norm_{i}",): f"norms.{i}" for i in range(n_layers)})
    plain = {(f"gcn_{i}", "bias"): f"convs.{i}.bias" for i in range(n_layers)}
    plain[("jk_logits",)] = "jk_logits"
    no_bias = {f"convs.{i}.lin" for i in range(n_layers)} | {"sage.lin_r"}
    return dense, norms, plain, ("in_norm",), no_bias


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
    parameter of a ResGCNNet with `n_layers` layers."""
    dense, norms, plain, _, no_bias = _resgcn_layout(n_layers)
    table = []
    for path, prefix in dense.items():
        table.append((f"{prefix}.weight", path + ("kernel",), True))
        if prefix not in no_bias:
            table.append((f"{prefix}.bias", path + ("bias",), False))
    for path, prefix in norms.items():
        table.append((f"{prefix}.weight", path + ("scale",), False))
        table.append((f"{prefix}.bias", path + ("bias",), False))
    table += [(name, path, False) for path, name in plain.items()]
    return table


def named_from_params_tree(tree: dict) -> dict[str, torch.Tensor]:
    """A flax params tree as float32 CPU tensors by port name.  Raises if
    any leaf of the tree is left unmapped."""
    out = {}
    for name, path, transposed in param_table(_n_layers(tree)):
        t = torch.from_numpy(np.array(_get(tree, path), dtype=np.float32))
        out[name] = t.T.contiguous() if transposed else t
    if len(out) != _n_leaves(tree):
        raise ValueError(f"mapped {len(out)} tensors from a tree of "
                         f"{_n_leaves(tree)} leaves")
    return out


def _stats_names(n_layers: int) -> list[tuple[str, str]]:
    """(flax batch_stats module, port module prefix) of every InputNorm."""
    _, norms, _, stats, _ = _resgcn_layout(n_layers)
    return [(m, norms[(m,)]) for m in stats]


def state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """flax {"params", "batch_stats"} tree -> the port model's state_dict.
    Raises if any leaf of the tree is left unmapped."""
    params = variables["params"]
    sd = named_from_params_tree(params)
    stats = variables["batch_stats"]
    for mod, prefix in _stats_names(_n_layers(params)):
        for key, buf in (("mean", "running_mean"), ("var", "running_var")):
            sd[f"{prefix}.{buf}"] = torch.from_numpy(
                np.array(stats[mod][key], dtype=np.float32))
    if len(sd) != _n_leaves(variables):
        raise ValueError(f"mapped {len(sd)} tensors from a tree of "
                         f"{_n_leaves(variables)} leaves")
    return sd
