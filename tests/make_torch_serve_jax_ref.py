#!/usr/bin/env python3
"""Build tests/data/torch_serve_jax_ref.npz: the masks the JAX package's
server answers for the request images of chip_smoke.py's serving phase
(`chip_smoke.serve_image(h, w, seed)` for each of SERVE_IMAGES, and the
first again at SERVE_ALT_THRESHOLD), served by JAX's own `Batcher`
through `build_server` with the bgc_s4{2,3,4} ensemble and
chip_smoke.SERVE_FLAGS (512 px canvas, 500 superpixels with the geodesic
prior, θ 0.65, radius 4).

    JAX_PLATFORMS=cpu python tests/make_torch_serve_jax_ref.py

It stores each image's (h, w, seed) and sha1 and each mask bit-packed at
the request's geometry (`mask_<i>`, and `mask_alt` for the threshold
request).  chip_smoke.py holds the port's served masks against it.
"""

import hashlib
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (DENSE_CHECKPOINTS, SERVE_ALT_THRESHOLD,  # noqa: E402
                        SERVE_FLAGS, SERVE_IMAGES, SERVE_REF, serve_image)
from gcn_grabcut_tpu.cli.serve import build_server, parse_args  # noqa: E402

OUT = ROOT / SERVE_REF


def main() -> None:
    spec = ",".join(str(ROOT / p) for p in DENSE_CHECKPOINTS)
    server, batcher = build_server(parse_args(
        ["--checkpoint", spec, "--port", "0", "--no-warmup", "--cpu",
         "--batch-wait-ms", "1000"] + SERVE_FLAGS))
    try:
        images = [serve_image(h, w, s) for h, w, s in SERVE_IMAGES]
        reqs = [batcher.submit(img, {}) for img in images]
        reqs.append(batcher.submit(images[0],
                                   {"threshold": SERVE_ALT_THRESHOLD}))
        for r in reqs:
            if not r.event.wait(timeout=3600) or r.error is not None:
                raise RuntimeError(f"the JAX server failed: {r.error}")
    finally:
        server.server_close()
    masks = {f"mask_{i}": np.packbits(r.result[0].ravel() > 0)
             for i, r in enumerate(reqs[:-1])}
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        OUT, images=np.asarray(SERVE_IMAGES, np.int32),
        sha1=np.asarray([hashlib.sha1(im.tobytes()).hexdigest()
                         for im in images]),
        alt_threshold=np.float32(SERVE_ALT_THRESHOLD),
        mask_alt=np.packbits(reqs[-1].result[0].ravel() > 0), **masks)
    fg = [float(r.result[0].mean()) for r in reqs]
    print(f"wrote {OUT.relative_to(ROOT)} ({OUT.stat().st_size} bytes); "
          f"FG fractions {['%.3f' % f for f in fg]}")


if __name__ == "__main__":
    main()
