"""The numbers the correctness check compares, program against reference.

Per image, each number is 0 where the two agree exactly:

    labels_diff    share of pixels whose superpixel label differs
    features_err   largest gap of a valid node's input (16 image features
                   and the 3-d prior), over the reference's largest
                   magnitude of that input, floored at 1
    probs_err      largest gap of a valid node's class posterior
    trimap_diff    share of pixels whose trimap label differs
    grabcut_diff   share of pixels whose GrabCut mask (before the
                   clean-up) differs
    mask_diff      share of pixels whose returned mask differs
    cut_mask_diff  the larger of grabcut_diff and mask_diff: one number
                   for the GrabCut and clean-up layers, for a cell where
                   the clean-up can hide the control's change to the cut

A run's number is the largest over the images it checks.  Imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np

def _share(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return 1.0
    return float(np.mean(a != b))


def image_numbers(prog: dict, ref: dict) -> dict:
    """The numbers of one image; `prog` holds what the program produced
    (any subset of segments, x, probs, trimap, grabcut, mask)."""
    out = {}
    if "segments" in prog:
        out["labels_diff"] = _share(prog["segments"], ref["segments"])
    valid = ref["node_mask"]
    if "x" in prog:
        x, rx = np.asarray(prog["x"], np.float64), ref["x"].astype(
            np.float64)
        scale = np.maximum(np.abs(rx[valid]).max(axis=0), 1.0)
        out["features_err"] = float((np.abs(x - rx)[valid] / scale).max())
    if "probs" in prog:
        out["probs_err"] = float(np.abs(
            np.asarray(prog["probs"], np.float64)
            - ref["probs"].astype(np.float64))[valid].max())
    for key, name in (("trimap", "trimap_diff"), ("grabcut", "grabcut_diff"),
                      ("mask", "mask_diff")):
        if key in prog:
            out[name] = _share(prog[key], ref[key])
    if "grabcut_diff" in out and "mask_diff" in out:
        out["cut_mask_diff"] = max(out["grabcut_diff"], out["mask_diff"])
    return out


def worst(per_image: list) -> dict:
    """Each number's largest value over the images."""
    out: dict = {}
    for numbers in per_image:
        for k, v in numbers.items():
            out[k] = max(out.get(k, v), v)
    return out
