"""A GATTrimapNet checkpoint read into the plain reference.

The checkpoint is the JAX package's flax tree (``train/checkpoints.py``
decodes it without flax or msgpack); this module names its leaves as the
program's ``state_dict`` does, for ``gat.GATTrimapNet``:

* Dense ``kernel`` (in, out) -> ``weight`` (out, in), ``bias`` as is;
* LayerNorm and InputNorm ``scale`` -> ``weight``;
* GATv2's ``att`` (H, F) and ``bias`` as they are;
* InputNorm's ``batch_stats`` mean / var -> ``running_mean`` /
  ``running_var``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..train.checkpoints import load_checkpoint
from .gat import GATTrimapNet


def name_map(n_layers: int) -> list[tuple[str, tuple, bool]]:
    """(program parameter name, flax path, transposed?) of every
    parameter of a GATTrimapNet with `n_layers` layers."""
    dense = {("input_proj",): "input_proj", ("skip_proj",): "skip_proj",
             ("head_fc1",): "head_fc1", ("head_fc2",): "head_fc2"}
    dense.update({("ctx", n): f"ctx.{n}"
                  for n in ("attn", "compress", "expand")})
    norms = {("in_norm",): "in_norm", ("input_ln",): "input_ln"}
    plain = {}
    for i in range(n_layers):
        for lin in ("lin_l", "lin_r", "lin_edge"):
            dense[(f"gat_{i}", lin)] = f"convs.{i}.{lin}"
        dense[(f"edge_{i}", "Dense_0")] = f"edges.{i}.fc0"
        dense[(f"edge_{i}", "Dense_1")] = f"edges.{i}.fc1"
        norms[(f"ln_{i}",)] = f"norms.{i}"
        for leaf in ("att", "bias"):
            plain[(f"gat_{i}", leaf)] = f"convs.{i}.{leaf}"
    no_bias = {"skip_proj"} | {f"convs.{i}.lin_edge" for i in range(n_layers)}
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


def _leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaves(v) for v in tree.values())
    return 1


def params_from_tree(params: dict, batch_stats: dict) -> dict:
    """The flax trees as float32 CPU tensors by program name.  Raises if
    a leaf is left unmapped."""
    n_layers = sum(1 for k in params if k.startswith("gat_"))
    out = {}
    for name, path, transposed in name_map(n_layers):
        leaf = params
        for key in path:
            leaf = leaf[key]
        t = torch.from_numpy(np.array(leaf, dtype=np.float32))
        out[name] = t.T.contiguous() if transposed else t
    for key, buf in (("mean", "running_mean"), ("var", "running_var")):
        out[f"in_norm.{buf}"] = torch.from_numpy(
            np.array(batch_stats["in_norm"][key], dtype=np.float32))
    if len(out) != _leaves(params) + _leaves(batch_stats):
        raise ValueError(f"mapped {len(out)} tensors from trees of "
                         f"{_leaves(params) + _leaves(batch_stats)} leaves")
    return out


def load(path, device) -> tuple[GATTrimapNet, dict]:
    """(the reference's GATTrimapNet on `device`, the checkpoint's meta)."""
    params, batch_stats, meta = load_checkpoint(path)
    if meta.get("variant") != "gat":
        raise ValueError(f"{path} holds a {meta.get('variant')!r} model, "
                         "not 'gat'")
    return GATTrimapNet(params_from_tree(params, batch_stats)).to(
        device), meta
