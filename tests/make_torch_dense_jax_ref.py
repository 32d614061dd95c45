#!/usr/bin/env python3
"""Build tests/data/torch_dense_jax_ref.npz: the JAX package's outputs on
the eight 512x512 images chip_smoke.py's dense phase segments
(`chip_smoke.make_image(512, seed)`, seeds 0-7), at the recommended
settings -- the bgc_s4{2,3,4} ensemble, n_segments=500 with the geodesic
prior, θ 0.65, guided-filter radius 4, ms_scales (1.0, 0.75).

    JAX_PLATFORMS=cpu python tests/make_torch_dense_jax_ref.py

Per image it stores the SLIC labels (uint16), the full-scale (K, 3)
posteriors, the trimap and the mask.  chip_smoke.py holds the port on the
card against it.
"""

import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (DENSE_CHECKPOINTS, DENSE_HW, DENSE_IMAGES,  # noqa: E402
                        DENSE_SETTINGS, make_image)
from gcn_grabcut_tpu import GCNGrabCutPipeline, SuperpixelGraphConfig  # noqa: E402
from gcn_grabcut_tpu.core.graph import make_graph_batch  # noqa: E402
from gcn_grabcut_tpu.graph_build import build_graph_batch_arrays  # noqa: E402
from gcn_grabcut_tpu.models.factory import apply_model  # noqa: E402
from gcn_grabcut_tpu.train.checkpoints import load_model_auto  # noqa: E402

OUT = ROOT / "tests" / "data" / "torch_dense_jax_ref.npz"
KEYS = ("x", "edge_src", "edge_dst", "edge_attr", "node_mask", "edge_mask",
        "node_area")


def main() -> None:
    model, variables, _ = load_model_auto(
        ",".join(str(ROOT / p) for p in DENSE_CHECKPOINTS))
    cfg = SuperpixelGraphConfig(n_segments=500, bg_connectivity=True)
    images = [make_image(DENSE_HW, s) for s in range(DENSE_IMAGES)]
    res = GCNGrabCutPipeline(model, variables, cfg).segment_batch(
        images, **DENSE_SETTINGS)
    out = build_graph_batch_arrays(
        jnp.asarray(np.stack(images), jnp.float32), cfg)
    probs = jax.nn.softmax(apply_model(
        model, variables, make_graph_batch(*(out[k] for k in KEYS))), -1)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        OUT,
        segments=np.stack([r.segments for r in res]).astype(np.uint16),
        probs=np.asarray(probs, np.float32),
        trimap=np.stack([r.trimap for r in res]).astype(np.uint8),
        mask=np.stack([r.binary_mask for r in res]).astype(np.uint8))
    fg = [float(r.binary_mask.mean()) for r in res]
    print(f"wrote {OUT.relative_to(ROOT)} ({OUT.stat().st_size} bytes); "
          f"FG fractions {['%.3f' % f for f in fg]}")


if __name__ == "__main__":
    main()
