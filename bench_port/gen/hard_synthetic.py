"""The hard-synthetic image generator, a frozen copy.

`hard_synthetic` draws the pixels of
``gcn_grabcut_torch.data.dataset.make_hard_synthetic_dataset(n, size,
seed)`` image by image from one ``np.random.RandomState(seed)`` stream:
textured, illumination-graded backgrounds, one object with its own
texture and moderate colour contrast, border-touching distractor blobs.  The benchmark's traffic
comes only from here, so later changes to the program's generator do not
move it.
"""

from __future__ import annotations

import numpy as np


def hard_synthetic(size: int, seed: int):
    """Endless (image, mask) pairs of `size` x `size`: the i-th pair is the
    i-th sample ``make_hard_synthetic_dataset(n, size, seed)`` returns for
    any n large enough (its degenerate draws skipped alike)."""
    import cv2
    rng = np.random.RandomState(seed)
    while True:
        # Multi-scale noise background + illumination gradient.
        base = rng.randint(30, 110, 3)
        img = np.zeros((size, size, 3), np.float32)
        for scale in (8, 32, 96):
            lowres = rng.randn(size // scale + 2, size // scale + 2, 3) * 18
            img += cv2.resize(lowres, (size, size),
                              interpolation=cv2.INTER_CUBIC)
        img += base[None, None, :]
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        ang = rng.rand() * 2 * np.pi
        grad = (np.cos(ang) * xx + np.sin(ang) * yy) * rng.uniform(-50, 50)
        img += grad[..., None]

        mask = np.zeros((size, size), np.uint8)
        cx = rng.randint(size // 3, 2 * size // 3)
        cy = rng.randint(size // 3, 2 * size // 3)
        color = base + rng.choice([-1, 1], 3) * rng.randint(50, 110, 3)
        color = np.clip(color, 0, 255)

        shape = rng.choice(["ellipse", "blob", "rect"])
        if shape == "ellipse":
            a = rng.randint(size // 7, size // 3)
            b = rng.randint(size // 8, size // 4)
            th = rng.randint(0, 180)
            cv2.ellipse(mask, (cx, cy), (a, b), th, 0, 360, 1, -1)
        elif shape == "rect":
            w, h = rng.randint(size // 6, size // 3, 2)
            cv2.rectangle(mask, (cx - w // 2, cy - h // 2),
                          (cx + w // 2, cy + h // 2), 1, -1)
            M = cv2.getRotationMatrix2D((cx, cy), rng.uniform(-40, 40), 1.0)
            mask = warp_affine_nearest(mask, M, (size, size))
        else:  # smooth random blob: union of overlapping circles
            for _ in range(rng.randint(3, 7)):
                r_ = rng.randint(size // 10, size // 5)
                dx, dy = rng.randint(-size // 8, size // 8, 2)
                cv2.circle(mask, (cx + dx, cy + dy), r_, 1, -1)

        # Object fill: base colour + its own texture.
        obj_tex = rng.randn(size, size, 3) * rng.uniform(5, 20)
        obj = color[None, None, :] + obj_tex
        img = np.where(mask[..., None] > 0, obj, img)

        # Distractor blobs (same colour family as the object, at borders).
        for _ in range(rng.randint(0, 3)):
            bx = rng.choice([rng.randint(0, size // 6),
                             rng.randint(5 * size // 6, size)])
            by = rng.randint(0, size)
            r_ = rng.randint(size // 16, size // 8)
            dcol = np.clip(color + rng.randint(-25, 25, 3), 0, 255)
            cv2.circle(img, (int(bx), int(by)), r_,
                       tuple(float(c) for c in dcol), -1)

        img = np.clip(img + rng.randn(size, size, 3) * 6, 0, 255)
        img = img.astype(np.uint8)
        if mask.sum() < 200 or (1 - mask).sum() < 200:
            continue
        yield img, mask


def images(n: int, size: int, seed: int) -> list:
    """The first `n` images of `hard_synthetic(size, seed)`."""
    stream = hard_synthetic(size, seed)
    return [next(stream)[0] for _ in range(n)]


def _warp_source(M, dsize: tuple, linear: bool):
    """(sx, sy): the float32 source coordinates of every destination pixel
    of ``cv2.warpAffine(src, M, dsize)`` in the arithmetic of OpenCV 5.0
    with 16-lane float vectors.  With the inverse map m in float64 and f =
    float32(m), the source x of the 16-pixel vectors is fma(f00, x, r),
    with the row term r = f01 * y + f02 in float32 arithmetic; for the
    last W % 16 pixels of a row it is fma(f00, x, float32(m01 * y + m02))
    (the row term in float64) when interpolating nearest, and
    (fma(f00, x, f01 * y) + f02) in float32 when linear; likewise y.  A
    float32 product is exact in float64, so one rounding there is a
    fma's."""
    W, H = dsize
    M = np.asarray(M, np.float64)
    det = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a11, a12 = M[1, 1] * det, -M[0, 1] * det
    a21, a22 = -M[1, 0] * det, M[0, 0] * det
    inv = np.array([[a11, a12, -a11 * M[0, 2] - a12 * M[1, 2]],
                    [a21, a22, -a21 * M[0, 2] - a22 * M[1, 2]]])
    f = inv.astype(np.float32)
    xs = np.arange(W, dtype=np.float64)[None, :]
    ys = np.arange(H)
    in_vectors = xs < W - W % 16

    def fma_x(r, row):
        return (np.float64(f[r, 0]) * xs
                + row.astype(np.float64)[:, None]).astype(np.float32)

    def source(r):
        vec = fma_x(r, f[r, 1] * ys.astype(np.float32) + f[r, 2])
        if linear:
            tail = fma_x(r, (np.float64(f[r, 1]) * ys).astype(np.float32)
                         ) + f[r, 2]
        else:
            tail = fma_x(r, (inv[r, 1] * ys + inv[r, 2]).astype(np.float32))
        return np.where(in_vectors, vec, tail)
    return source(0), source(1)


def warp_affine_nearest(src: np.ndarray, M, dsize: tuple) -> np.ndarray:
    """``cv2.warpAffine(src, M, dsize, flags=cv2.INTER_NEAREST)`` of a
    single-channel image, with its zero border, in numpy, in the arithmetic of OpenCV 5.0
    (`_warp_source`; coordinates round half to even).  OpenCV versions
    part here (4.x maps pixels in 10-bit fixed point, 5.0 in float32, and
    boundary pixels of a rotated rectangle move), so the generators and
    `augment_sample` warp this way and give the same pixels whichever
    OpenCV is installed."""
    if src.ndim != 2:
        raise ValueError(f"a single-channel image is needed, got "
                         f"{src.shape}")
    sx, sy = (np.rint(a).astype(np.int64)
              for a in _warp_source(M, dsize, linear=False))
    h, w = src.shape
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = np.zeros(sx.shape, src.dtype)
    out[inside] = src[sy[inside], sx[inside]]
    return out
