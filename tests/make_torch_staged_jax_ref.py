#!/usr/bin/env python3
"""Build tests/data/torch_staged_jax_ref.npz: the JAX package's outputs on
the staged paths chip_smoke.py's seventh phase runs, on
`chip_smoke.staged_image(seed)` (512x512) for seed in STAGED_SEEDS, with the
bgc_s4{2,3,4} ensemble, n_segments=500 and the geodesic prior, θ 0.65
and guided-filter radius 4:

  edge_off   segment(img, edge_aware=False)             backend "device"
  refine     segment(img, refine_iters=STAGED_REFINE)   backend "device"
  native     segment(img)                               backend "native"
  bbox       segment_bbox(img, STAGED_BBOX)             backend "device"
  <cs>_bbox, <cs>_refine   GrabCut(img, color_space=cs).run_with_bbox,
                           then .refine(STAGED_REFINE)  backend "device"

    JAX_PLATFORMS=cpu python tests/make_torch_staged_jax_ref.py

"device" is pinned where the card's "auto" runs the device solver.  Masks
are stored with np.packbits over each image's pixels, trimaps as their two
bit planes, the same way.
"""

import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (DENSE_CHECKPOINTS, DENSE_SEGMENTS,  # noqa: E402
                        STAGED_BBOX, STAGED_COLOUR_SPACES, STAGED_REF,
                        STAGED_REFINE, STAGED_SEEDS, STAGED_SETTINGS,
                        staged_image)
from gcn_grabcut_tpu import (GCNGrabCutPipeline, GrabCut,  # noqa: E402
                             GrabCutConfig, SuperpixelGraphConfig)
from gcn_grabcut_tpu.train.checkpoints import load_model_auto  # noqa: E402

OUT = ROOT / STAGED_REF


def pack_mask(m: np.ndarray) -> np.ndarray:
    return np.packbits(m.reshape(-1) > 0)


def pack_trimap(t: np.ndarray) -> np.ndarray:
    t = t.reshape(-1)
    return np.stack([np.packbits(t & 1), np.packbits(t >> 1)])


def main() -> None:
    model, variables, _ = load_model_auto(
        ",".join(str(ROOT / p) for p in DENSE_CHECKPOINTS))
    cfg = SuperpixelGraphConfig(n_segments=DENSE_SEGMENTS,
                                bg_connectivity=True)
    device = GCNGrabCutPipeline(model, variables, cfg,
                                GrabCutConfig(backend="device"))
    native = GCNGrabCutPipeline(model, variables, cfg,
                                GrabCutConfig(backend="native"))
    out: dict = {}

    def put(key, value):
        out.setdefault(key, []).append(value)

    for seed in STAGED_SEEDS:
        img = staged_image(seed)
        for name, res in (
                ("edge_off", device.segment(img, edge_aware=False,
                                            **STAGED_SETTINGS)),
                ("refine", device.segment(img, refine_iters=STAGED_REFINE,
                                          **STAGED_SETTINGS)),
                ("native", native.segment(img, **STAGED_SETTINGS)),
                ("bbox", device.segment_bbox(img, STAGED_BBOX))):
            put(f"{name}_mask", pack_mask(res.binary_mask))
            put(f"{name}_trimap", pack_trimap(res.trimap))
            print(f"seed {seed} {name}: FG {res.binary_mask.mean():.4f}",
                  flush=True)
        for cs in STAGED_COLOUR_SPACES:
            gc = GrabCut(img, GrabCutConfig(color_space=cs, backend="device"))
            put(f"{cs}_bbox_mask", pack_mask(gc.run_with_bbox(STAGED_BBOX)))
            put(f"{cs}_refine_mask", pack_mask(gc.refine(STAGED_REFINE)))
            print(f"seed {seed} {cs}: FG {gc.history[0].fg_ratio:.4f} -> "
                  f"{gc.history[1].fg_ratio:.4f}", flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, seeds=np.array(STAGED_SEEDS),
                        **{k: np.stack(v) for k, v in out.items()})
    print(f"wrote {OUT.relative_to(ROOT)} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
