#!/usr/bin/env python3
"""Build tests/data/torch_variants_jax_ref.npz: the JAX package's outputs
for the GCN and GAT variants that chip_smoke.py's ninth phase holds the
card against.

For each variant (chip_smoke.VARIANTS) at full width (build_model's
defaults), with weights drawn by the port's `init_model_numpy` from
VARIANT_SEED and converted to flax's tree, and for each case of
chip_smoke.VARIANT_CASES (the large path at 320² / 2600 superpixels and
the dense path at 512² / 500, on chip_smoke.textured_image):

  {case}_segments          build_graph's label map (uint16)
  {variant}_{case}_logits  the forward on that graph (the large path
                           through JAX's apply_large at its default
                           precision, the dense path through apply_model)
  {variant}_{case}_mask    segment_batch([image]) at its default settings
                           with the device min-cut (the card's "auto"),
                           np.packbits over the pixels

    JAX_PLATFORMS=cpu python tests/make_torch_variants_jax_ref.py

It also prints how far the port's CPU forward is from JAX's on each
graph (information only).
"""

import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (VARIANT_CASES, VARIANT_REF,  # noqa: E402
                        VARIANT_SEED, VARIANTS, textured_image)
import gcn_grabcut_tpu as jgt  # noqa: E402
from gcn_grabcut_tpu.models.factory import apply_model  # noqa: E402
from gcn_grabcut_tpu.pipeline import _apply_large_any  # noqa: E402
import gcn_grabcut_torch as gt  # noqa: E402
from gcn_grabcut_torch.models.convert import (  # noqa: E402
    jax_variables_from_state_dict)

OUT = ROOT / VARIANT_REF


def seeded_models(variant: str):
    """(port model, JAX module, JAX variables) holding the same weights."""
    model = gt.init_model_numpy(gt.build_model(variant), VARIANT_SEED)
    variables = jax_variables_from_state_dict(model.state_dict())
    return model, jgt.build_model(variant), variables


def main() -> None:
    out: dict = {}
    for case, (hw, n_segments, seed) in VARIANT_CASES.items():
        img = textured_image(hw, seed)
        cfg = dict(n_segments=n_segments)
        jg = jgt.build_graph(img, jgt.SuperpixelGraphConfig(**cfg))
        tg = gt.build_graph(img, gt.SuperpixelGraphConfig(**cfg),
                            device="cpu")
        out[f"{case}_segments"] = np.asarray(jg.segments, np.uint16)
        large = jg.n_nodes > jgt.GCNGrabCutPipeline.LARGE_NODE_THRESHOLD
        for variant in VARIANTS:
            model, jmodel, variables = seeded_models(variant)
            fwd = _apply_large_any if large else apply_model
            logits = np.asarray(fwd(jmodel, variables, jg.graph))[0]
            pipe = jgt.GCNGrabCutPipeline(
                jmodel, variables, jgt.SuperpixelGraphConfig(**cfg),
                jgt.GrabCutConfig(backend="device"))
            res = pipe.segment_batch([img])[0]
            out[f"{variant}_{case}_logits"] = logits.astype(np.float32)
            out[f"{variant}_{case}_mask"] = np.packbits(
                res.binary_mask.reshape(-1) > 0)
            with torch.no_grad():
                tl = (gt.apply_large(model, tg.graph, device="cpu") if large
                      else model(tg.graph))[0].numpy()
            nm = np.asarray(jg.graph.node_mask[0]) > 0
            same = np.array_equal(tg.segments, np.asarray(jg.segments))
            print(f"{variant} {case} ({hw}^2, K={jg.n_nodes}): max |logits| "
                  f"{np.abs(logits[nm]).max():.3f}, port CPU vs JAX "
                  f"{np.abs(tl - logits)[nm].max():.3e} (same SLIC: {same}),"
                  f" FG {res.binary_mask.mean():.4f}", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
