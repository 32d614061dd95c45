"""The plain reference of one image through the whole path with a
GATTrimapNet: `pipeline.py`'s build, projection, trimap, GrabCut and
clean-up, with the forward swapped for the plain GAT of
``plain/models/gat.py`` over the graph's edge list.

The banded attention's bfloat16 rounding (the program's and the
reference's round in other orders) moves posteriors by up to ~5e-3 (on
an H100, at the trained checkpoint's logit scale of ~15; seeded weights'
by ~3e-4): enough to flip trimap pixels at a decision, which GrabCut then
spreads, so no limit on the thresholded outputs of two separate forwards
has room between sound runs and the control.  So the stages after the
forward start from the program's posteriors: the posteriors are compared
with the reference's own (`probs` of the result), and the trimap,
GrabCut and clean-up with what the reference computes from the
program's posteriors on its own build, as one compares logits and not
sampled tokens.  `own_numbers` also holds the program's trimap against
the trimap of the reference's own posteriors, away from the trimap's
decisions, so a forward fault that moves decisions fails more than one
number.

Above 2048 nodes the program runs its attention banded at the default
precision, so the reference rounds the attention to bfloat16 there
(``gat.py``'s docstring); up to 2048 it runs the edge list in float32,
and so does the reference.  `lower=True` is the control: the attention's
rounding points float8 e4m3 round trips and the Linears, LayerNorms and
InputNorm in bfloat16, the build and GrabCut lowered as in
`pipeline.py`.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import pipeline as ref
from .plain.graph_build import SuperpixelGraphConfig
from .plain.grabcut import GrabCutConfig, grabcut_batch_device
from .plain.models import gat_weights
from .plain.ops import image as im
from .plain.ops.connected import _clean_mask

#: a pixel is far from the trimap's decisions when its filtered posteriors
#: lie farther than this from each (`own_numbers`): twice the largest
#: posterior gap of sound runs on an H100 (4.7e-3, bfloat16 rounding at a
#: logit scale of ~15)
FAR = 1e-2


def load_model(paths: list, device):
    """The configuration's one GAT checkpoint, read by the plain copy's
    decoder (the precision is chosen per call, by `segment`)."""
    if len(paths) != 1:
        raise ValueError("the GAT reference runs one checkpoint")
    model, _ = gat_weights.load(paths[0], device)
    return model


def _probs(model, out: dict, lower: bool) -> torch.Tensor:
    """(N, 3) softmax posteriors of the one graph in `out`."""
    banded = out["x"].shape[1] > ref.LARGE_NODE_THRESHOLD
    if lower:
        attention, compute = torch.float8_e4m3fn, torch.bfloat16
    else:
        attention, compute = (torch.bfloat16 if banded else None), None
    logits = model(*(out[k][0] for k in (
        "x", "edge_src", "edge_dst", "edge_attr", "node_mask", "edge_mask")),
        attention_dtype=attention, compute_dtype=compute)
    return torch.softmax(logits, dim=-1)


def _trimap(probs, out, gray, settings: dict):
    """(trimap, decision margin) of (1, N, 3) posteriors on the build
    `out`; the margin is each pixel's distance, in filtered posterior,
    from the nearest of the trimap's decisions (p_fg = θ, p_bg = θ,
    p_fg = p_bg)."""
    thr, radius = settings["threshold"], settings["filter_radius"]
    px = ref._project_probs(probs, out["segments"], gray.shape[1:])
    trimap = ref._trimap(px, out["segments"], gray, out["prior"],
                         out["node_mask"], thr, radius)
    p_bg = im.guided_filter(gray, px[..., 0], radius, 1e-3).clamp(0, 1)
    p_fg = im.guided_filter(gray, px[..., 1], radius, 1e-3).clamp(0, 1)
    margin = torch.minimum(torch.minimum((p_fg - thr).abs(),
                                         (p_bg - thr).abs()),
                           (p_fg - p_bg).abs())
    return trimap, margin


@torch.no_grad()
def segment(image: np.ndarray, model, settings: dict, device, lower: bool,
            probs: np.ndarray) -> dict:
    """`pipeline.segment` for a GAT model, at one scale; `probs`, the
    program's (N, 3) posteriors, feed the trimap and what follows (the
    module docstring).  `own_trimap` and `own_margin` are the trimap of
    the reference's own posteriors and its decision margin, for
    `own_numbers`."""
    if len(settings.get("ms_scales") or (1.0,)) > 1:
        raise ValueError("the GAT reference runs one scale")
    cfg = SuperpixelGraphConfig(n_segments=settings["n_segments"],
                                bg_connectivity=settings["bg_connectivity"])
    rgbs = torch.as_tensor(image[None], device=device).float()
    H, W = image.shape[:2]
    out = ref._build(rgbs, cfg, lower)
    own = _probs(model, out, lower)[None]
    gray = im.rgb_to_gray(rgbs) / 255.0
    trimap, _ = _trimap(torch.as_tensor(probs, device=device)[None], out,
                        gray, settings)
    own_trimap, margin = _trimap(own, out, gray, settings)
    with (ref._float32_pixel_sums() if lower
          else contextlib.nullcontext()):
        cut = grabcut_batch_device(rgbs, trimap, GrabCutConfig())
    mask = _clean_mask(cut, float(settings["min_area_ratio"] * H * W),
                       False, None)
    return {"segments": _first(out["segments"]), "x": _first(out["x"]),
            "node_mask": _first(out["node_mask"]) > 0, "probs": _first(own),
            "trimap": _first(trimap), "grabcut": _first(cut),
            "mask": _first(mask), "own_trimap": _first(own_trimap),
            "own_margin": _first(margin)}


def _first(t: torch.Tensor) -> np.ndarray:
    return t[0].cpu().numpy()


def own_numbers(prog: dict, ref_out: dict) -> dict:
    """The program against the reference's own posteriors, through the
    trimap (`segment`'s `own_*`):

        far_trimap_diff  share of the pixels farther than `FAR` from every
                         trimap decision, in the reference's filtered
                         posteriors, whose trimap label differs

    A forward fault that moves decisions shows here as well as in
    `probs_err`; rounding, which moves posteriors by less than `FAR`,
    reaches no such pixel."""
    keep = ref_out["own_margin"] > FAR
    flips = np.asarray(prog["trimap"]) != ref_out["own_trimap"]
    return {"far_trimap_diff": float(flips[keep].mean()) if keep.any()
            else 0.0}
