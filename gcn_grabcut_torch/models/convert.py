"""Weights between the JAX package's flax variables and the port's modules.

The JAX models keep their weights as ``{"params": ..., "batch_stats":
...}`` nested dicts (the tree ``train/checkpoints.py`` serialises).  Here
that tree, as nested dicts of numpy arrays, becomes a ``state_dict`` of
the port's ResGCNNet, GCNTrimapNet or GATTrimapNet, and back:

* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in), ``bias`` as is;
* LayerNorm and InputNorm ``scale`` -> ``weight``;
* InputNorm ``batch_stats`` mean / var -> the ``running_mean`` /
  ``running_var`` buffers;
* GATv2's ``att`` (H, F) and ``bias`` as they are.

The variant is read from the tree's names (``gat_0`` for GAT,
``input_bn`` for GCN, else ResGCNNet).  `param_table` lists the
correspondence parameter by parameter; the trainer writes Adam's moments
and the LR groups through it.
"""

from __future__ import annotations

import numpy as np
import torch

from .gat import GATTrimapNet
from .gcn import GCNTrimapNet
from .resgcn import ResGCNNet


def _resgcn_layout(n_layers: int):
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


def _gcn_layout(n_layers: int):
    dense = {(name,): name for name in
             ("input_proj", "head_fc1", "head_fc2", "head_fc3")}
    norms = {(name,): name for name in ("in_norm", "input_bn", "head_bn")}
    plain = {}
    for i in range(n_layers):
        dense[(f"gcn_{i}", "Dense_0")] = f"convs.{i}.lin"
        dense[(f"edge_{i}", "Dense_0")] = f"edges.{i}.fc0"
        dense[(f"edge_{i}", "Dense_1")] = f"edges.{i}.fc1"
        norms[(f"bn_{i}",)] = f"bns.{i}"
        plain[(f"gcn_{i}", "bias")] = f"convs.{i}.bias"
    stats = ("in_norm", "input_bn", "head_bn") + tuple(
        f"bn_{i}" for i in range(n_layers))
    no_bias = {f"convs.{i}.lin" for i in range(n_layers)}
    return dense, norms, plain, stats, no_bias


def _gat_layout(n_layers: int):
    dense = {(name,): name for name in
             ("input_proj", "skip_proj", "head_fc1", "head_fc2")}
    dense.update({("ctx", n): f"ctx.{n}"
                  for n in ("attn", "compress", "expand")})
    norms = {(name,): name for name in ("in_norm", "input_ln")}
    plain = {}
    for i in range(n_layers):
        for lin in ("lin_l", "lin_r", "lin_edge"):
            dense[(f"gat_{i}", lin)] = f"convs.{i}.{lin}"
        dense[(f"edge_{i}", "Dense_0")] = f"edges.{i}.fc0"
        dense[(f"edge_{i}", "Dense_1")] = f"edges.{i}.fc1"
        norms[(f"ln_{i}",)] = f"norms.{i}"
        plain[(f"gat_{i}", "att")] = f"convs.{i}.att"
        plain[(f"gat_{i}", "bias")] = f"convs.{i}.bias"
    no_bias = {"skip_proj"} | {f"convs.{i}.lin_edge" for i in range(n_layers)}
    return dense, norms, plain, ("in_norm",), no_bias


# Per variant: (Dense path -> port prefix, norm path -> prefix, other
# parameter path -> name, InputNorm modules with batch statistics, the
# Dense prefixes without a bias).
_LAYOUTS = {"resgcn": _resgcn_layout, "gcn": _gcn_layout,
            "gat": _gat_layout}


def variant_of_tree(params: dict) -> str:
    """The variant of a flax params tree, from its top-level names."""
    if "gat_0" in params:
        return "gat"
    if "input_bn" in params:
        return "gcn"
    return "resgcn"


def variant_of_state_dict(state_dict: dict) -> str:
    if "convs.0.att" in state_dict:
        return "gat"
    if "input_bn.weight" in state_dict:
        return "gcn"
    return "resgcn"


def _n_layers(params: dict) -> int:
    return sum(1 for k in params if k.startswith(("gcn_", "gat_")))


def _get(tree: dict, path: tuple) -> dict:
    for p in path:
        tree = tree[p]
    return tree


def _n_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    return 1


def param_table(n_layers: int, variant: str = "resgcn"
                ) -> list[tuple[str, tuple, bool]]:
    """(port parameter name, flax parameter path, transposed?) for every
    parameter of a model of `variant` with `n_layers` layers."""
    if variant not in _LAYOUTS:
        raise ValueError(f"Unknown variant '{variant}'. Choose: "
                         "resgcn|gcn|gat")
    dense, norms, plain, _, no_bias = _LAYOUTS[variant](n_layers)
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


def flax_path(name: str, n_layers: int, variant: str = "resgcn") -> tuple:
    """The flax parameter path of a port parameter name."""
    for n, path, _ in param_table(n_layers, variant):
        if n == name:
            return path
    raise KeyError(f"{name!r} is not a {variant} parameter")


def params_tree(named: dict, n_layers: int, variant: str = "resgcn"
                ) -> dict:
    """{port parameter name: tensor or array} -> the flax params tree of
    float32 numpy arrays (Dense kernels transposed back to (in, out)).
    Any tree shaped like the parameters maps so: Adam's moments too."""
    tree: dict = {}
    for name, path, transposed in param_table(n_layers, variant):
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
    out = {}
    for name, path, transposed in param_table(_n_layers(tree),
                                              variant_of_tree(tree)):
        t = torch.from_numpy(np.array(_get(tree, path), dtype=np.float32))
        out[name] = t.T.contiguous() if transposed else t
    if len(out) != _n_leaves(tree):
        raise ValueError(f"mapped {len(out)} tensors from a tree of "
                         f"{_n_leaves(tree)} leaves")
    return out


def _stats_names(variant: str, n_layers: int) -> list[tuple[str, str]]:
    """(flax batch_stats module, port module prefix) of every InputNorm."""
    _, norms, _, stats, _ = _LAYOUTS[variant](n_layers)
    return [(m, norms[(m,)]) for m in stats]


def state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """flax {"params", "batch_stats"} tree -> the port model's state_dict.
    Raises if any leaf of the tree is left unmapped."""
    params = variables["params"]
    sd = named_from_params_tree(params)
    stats = variables["batch_stats"]
    for mod, prefix in _stats_names(variant_of_tree(params),
                                    _n_layers(params)):
        for key, buf in (("mean", "running_mean"), ("var", "running_var")):
            sd[f"{prefix}.{buf}"] = torch.from_numpy(
                np.array(stats[mod][key], dtype=np.float32))
    if len(sd) != _n_leaves(variables):
        raise ValueError(f"mapped {len(sd)} tensors from a tree of "
                         f"{_n_leaves(variables)} leaves")
    return sd


def jax_variables_from_state_dict(state_dict: dict) -> dict:
    """The inverse of `state_dict_from_jax`: nested dicts of numpy arrays."""
    variant = variant_of_state_dict(state_dict)
    n_layers = sum(1 for k in state_dict if k.startswith("convs.")
                   and k.endswith(".bias") and k.count(".") == 2)
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    stats = {mod: {"mean": sd[f"{prefix}.running_mean"],
                   "var": sd[f"{prefix}.running_var"]}
             for mod, prefix in _stats_names(variant, n_layers)}
    return {"params": params_tree(sd, n_layers, variant),
            "batch_stats": stats}


def model_from_jax(variables: dict, device=None):
    """The port model (ResGCNNet, GCNTrimapNet or GATTrimapNet, in eval
    mode) holding the JAX variables' weights; the variant and sizes are
    read from the tree."""
    params = variables["params"]
    variant = variant_of_tree(params)
    in_ch, hidden = np.shape(params["input_proj"]["kernel"])
    edge_mlp = "edge_ctx" if variant == "resgcn" else "edge_0"
    head = {"resgcn": "head", "gcn": "head_fc3", "gat": "head_fc2"}[variant]
    kw = dict(in_channels=in_ch,
              edge_channels=np.shape(params[edge_mlp]["Dense_0"]["kernel"])[0],
              hidden_channels=hidden, n_layers=_n_layers(params),
              n_classes=np.shape(params[head]["kernel"])[1])
    if variant == "gat":
        kw["n_heads"] = np.shape(params["gat_0"]["att"])[0]
    cls = {"resgcn": ResGCNNet, "gcn": GCNTrimapNet,
           "gat": GATTrimapNet}[variant]
    model = cls(**kw)
    model.load_state_dict(state_dict_from_jax(variables))
    if device is not None:
        model.to(device)
    return model.eval()


def resgcn_from_jax(variables: dict, device=None) -> ResGCNNet:
    """A ResGCNNet in eval mode holding the JAX variables' weights."""
    if variant_of_tree(variables["params"]) != "resgcn":
        raise ValueError("the variables do not hold a ResGCNNet")
    return model_from_jax(variables, device)
