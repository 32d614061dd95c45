"""Full-covariance GMM colour models for GrabCut.

Counterpart of ``gcn_grabcut_tpu/ops/gmm.py``: weighted k-means seeding,
moment re-estimation with OpenCV-style covariance regularisation, component
assignment and the mixture log-likelihood, as masked dense reductions.

k-means++ draws its seeds with the JAX package's own Gumbel noise
(``ops/threefry.py`` reproduces its ``jax.random`` bits), so both packages
start GrabCut from the same components.

Every step takes an optional leading batch dimension (the JAX package
``vmap``s them), and an image's bits do not depend on the batch it is in:
sums over pixels run in float64 and round once (exact for RGB pixels and
0 / 1 weights), and sums over colour channels and components are written
out as float32 adds of a fixed order.

GrabCut reaches these steps through two wrappers: `class_components` (the
seeded k-means of both classes) and `ColourModels` (the fits, the
component assignment and the terminal energy of each iteration).  A CPU
tensor takes the plain functions below; a CUDA tensor launches the passes
of ``csrc/gmm_passes.cu``, the same bits in ~27 launches a lock-step solve
(`counts` records them while a profiler records).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..core.graph import TRIMAP_BG, TRIMAP_FG, TRIMAP_PROB_FG
from ..utils import Recorder
from .threefry import kmeans_pp_noise

COV_REG = 0.01
DET_EPS = 1e-6
LOG_FLOOR = -80.0


def _channel_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last (small) dimension as sequential float32 adds, so
    the order is the same at every batch size and on every device."""
    out = a[..., 0]
    for c in range(1, a.shape[-1]):
        out = out + a[..., c]
    return out


def _pixel_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the pixel axis (-2) in float64, rounded once to float32.
    The addends here are products of pixel values and 0 / 1 weights:
    integers for RGB, whose float64 sums are exact in any order, so the
    bits do not depend on the batch, the device or the library's
    summation order."""
    return a.double().sum(dim=-2).float()


def _pixel_matmul(onehot: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., N, k)^T (..., N, C) -> (..., k, C) in float64, rounded once
    to float32 (exact for RGB, as `_pixel_sum`)."""
    return (onehot.double().transpose(-1, -2) @ x.double()).float()


def _sq_dist(flat: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, k, C) -> (B, N, k) squared distances."""
    return _channel_sum((flat[:, :, None, :] - centers[:, None, :, :]) ** 2)


def _rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[b, idx[b]] for (B, N, C) `a` and (B,) `idx` -> (B, C)."""
    return torch.gather(a, 1, idx[:, None, None].expand(-1, 1, a.shape[-1])
                        )[:, 0]


#: device -> ((pixel count, draws), {seed: noise}): the noise of one
#: shape a device, the most recent.
_noise: dict = {}


def device_noise(seed: int, n: int, draws: int,
                 device: torch.device) -> torch.Tensor:
    """`kmeans_pp_noise(seed, n, draws)` on `device`, uploaded once and
    kept there while the device's images keep their shape: a device keeps
    the noise of one (pixel count, draws), the most recent, for at most
    the two seeds of `KMEANS_SEEDS`, so a new shape lets the old one's
    planes go."""
    device = torch.device(device)
    shape, planes = _noise.get(device, (None, None))
    if shape != (n, draws):
        planes = {}
        _noise[device] = ((n, draws), planes)
    if seed not in planes:
        if len(planes) >= len(KMEANS_SEEDS):
            planes.pop(next(iter(planes)))
        planes[seed] = torch.tensor(kmeans_pp_noise(seed, n, draws),
                                    device=device)
    return planes[seed]


def kmeans(pixels: torch.Tensor, weight: torch.Tensor, k: int,
           n_iter: int = 10, seed: int = 0, return_centres: bool = False):
    """Weighted Lloyd k-means over (..., H, W, 3) pixels -> (..., H, W)
    labels (and, with `return_centres`, the final (..., k, 3) centres);
    leading dimensions are a batch of images, each clustered on its own.

    k-means++ initialisation: the first centre is the max-weight pixel,
    each next one a Gumbel-max draw proportional to weight x squared
    distance to the nearest chosen centre, with the JAX package's noise
    under ``PRNGKey(seed)`` (the same draws for every image of a batch, as
    under the JAX package's ``vmap``)."""
    *lead, H, W, C = pixels.shape
    flat = pixels.reshape(-1, H * W, C).float()
    w = weight.reshape(-1, H * W).float()
    dev = flat.device
    centers = torch.zeros((flat.shape[0], k, C), device=dev)
    centers[:, 0] = _rows(flat, torch.argmax(w, dim=1))
    arange_k = torch.arange(k, device=dev)
    noise = torch.tensor(kmeans_pp_noise(seed, H * W, k - 1), device=dev)
    for i in range(k - 1):
        inactive = torch.where(arange_k <= i, 0.0, float("inf"))
        d2 = (_sq_dist(flat, centers) + inactive).amin(dim=-1)
        logits = torch.log((w * d2).clamp_min(1e-30))
        centers[:, i + 1] = _rows(flat, torch.argmax(logits + noise[i], dim=1))

    for _ in range(n_iter):
        lab = torch.argmin(_sq_dist(flat, centers), dim=-1)
        onehot = torch.nn.functional.one_hot(lab, k).float() * w[..., None]
        tot = _pixel_matmul(onehot, flat)
        cnt = _pixel_sum(onehot)[..., None]
        new = tot / cnt.clamp_min(1e-6)
        centers = torch.where(cnt > 0, new, centers)
    labels = torch.argmin(_sq_dist(flat, centers), dim=-1).reshape(*lead, H, W)
    if return_centres:
        return labels, centers.reshape(*lead, k, C)
    return labels


def _inv3(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form inverse and determinant of batched 3x3 matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj / det.clamp_min(DET_EPS)[..., None, None], det


def fit_gmm(pixels: torch.Tensor, sel: torch.Tensor, comp: torch.Tensor,
            k: int) -> dict:
    """k-component full-covariance GMM from the selected pixels' component
    assignment: weights (k,), means (k, 3), inv_cov (k, 3, 3), log_norm
    (k,) = log w_c - 0.5 log det, counts (k,).  `pixels` (..., H, W, 3)
    with `sel`, `comp` (..., H, W): leading dimensions are a batch of
    images, and every entry gains them."""
    *lead, H, W, C = pixels.shape
    flat = pixels.reshape(-1, H * W, C).float()
    m = sel.reshape(-1, H * W).float()
    onehot = torch.nn.functional.one_hot(comp.reshape(-1, H * W), k).float() \
        * m[..., None]
    cnt = _pixel_sum(onehot)                                  # (B, k)
    total = _pixel_sum(m[..., None])[..., 0].clamp_min(1.0)   # (B,)
    means = _pixel_matmul(onehot, flat) / cnt.clamp_min(1.0)[..., None]
    xx = (flat[..., :, None] * flat[..., None, :]).reshape(-1, H * W, C * C)
    xxT = _pixel_matmul(onehot, xx).reshape(-1, k, C, C)
    cov = xxT / cnt.clamp_min(1.0)[..., None, None] \
        - means[..., :, None] * means[..., None, :]
    eye = torch.eye(C, device=flat.device)
    for _ in range(2):
        _, det = _inv3(cov)
        cov = cov + eye * COV_REG * (det < DET_EPS).float()[..., None, None]
    inv_cov, det = _inv3(cov)
    weights = cnt / total[:, None]
    log_norm = torch.where(
        cnt > 0,
        torch.log(weights.clamp_min(1e-30))
        - 0.5 * torch.log(det.clamp_min(DET_EPS)),
        torch.full_like(cnt, LOG_FLOOR))
    out = dict(weights=weights, means=means, inv_cov=inv_cov,
               log_norm=log_norm, counts=cnt)
    return {n: a.reshape(*lead, *a.shape[1:]) for n, a in out.items()}


def component_scores(pixels: torch.Tensor, gmm: dict) -> torch.Tensor:
    """(..., H, W, k) weighted log component densities (up to a
    constant), each image of a batch under its own GMM.  The quadratic
    form d^T A d is written out in float32 adds of a fixed order."""
    d = pixels[..., None, :] - gmm["means"][..., None, None, :, :]
    A = gmm["inv_cov"][..., None, None, :, :, :]     # (..., 1, 1, k, 3, 3)
    C = d.shape[-1]
    maha = None
    for j in range(C):
        t = d[..., 0] * A[..., 0, j]
        for i in range(1, C):
            t = t + d[..., i] * A[..., i, j]
        maha = t * d[..., j] if maha is None else maha + t * d[..., j]
    return gmm["log_norm"][..., None, None, :] - 0.5 * maha


def assign_components(pixels: torch.Tensor, gmm: dict) -> torch.Tensor:
    """(..., H, W) best component per pixel (cv2 assignGMMsComponents)."""
    return torch.argmax(component_scores(pixels, gmm), dim=-1)


def gmm_log_prob(pixels: torch.Tensor, gmm: dict) -> torch.Tensor:
    """(..., H, W) log of the weighted mixture density (up to a
    constant)."""
    scores = component_scores(pixels, gmm)
    peak = scores.amax(dim=-1)
    lse = peak + torch.log(_channel_sum(torch.exp(scores - peak[..., None])))
    return lse.clamp_min(LOG_FLOOR)


# --------------------------------------------------------------------------
# The wrappers GrabCut calls, and the passes of csrc/gmm_passes.cu.

def class_masks(mask: torch.Tensor):
    """Foreground (FG or PR_FG) and background weights, float 0 / 1, of a
    trimap or a foreground flag."""
    fg = (mask == TRIMAP_FG) | (mask == TRIMAP_PROB_FG)
    return fg.float(), (~fg).float()


#: The pass kinds, numbered as csrc/gmm_passes.cu numbers them.
PASS_KINDS = ("seed", "draw", "lloyd", "labels", "fit", "assign",
              "terminal")
SEED, DRAW, LLOYD, LABELS, FIT, ASSIGN, TERMINAL = range(len(PASS_KINDS))


def model_fields(k: int) -> list:
    """The fields of an image's model, in the order csrc/gmm_passes.cu's
    gmm_model_field numbers them, as (name, shape) at k components a
    class: the centres of both classes, then per class c (0 foreground, 1
    background) its pixel count, the rounded sums and the fitted GMM."""
    return [("centres", (2, k, 3))] + [
        (f"{name}{c}", shape) for c in range(2) for name, shape in (
            ("total", ()), ("counts", (k,)), ("sum_x", (k, 3)),
            ("sum_xx", (k, 3, 3)), ("weights", (k,)), ("means", (k, 3)),
            ("inv_cov", (k, 3, 3)), ("det", (k,)), ("log_norm", (k,)))]


class PassCounts(Recorder):
    """The colour-model passes launched on the card, each as (kind name,
    images it served), recorded as `utils.Recorder` says: after `reset()`
    and while a torch profiler records.  The plain count of every launch
    is `CardPasses.kernel_launches`."""

    def _clear(self) -> None:
        self.passes: list = []

    def _record(self, kind: int, images: int) -> None:
        if self.active:
            self.passes.append((PASS_KINDS[kind], images))

    def totals(self) -> dict:
        """Passes recorded, the images they served, and passes by kind."""
        by_kind = {}
        for name, _ in self.passes:
            by_kind[name] = by_kind.get(name, 0) + 1
        return dict(passes=len(self.passes),
                    images=sum(n for _, n in self.passes), by_kind=by_kind)


#: The passes recorded since ``counts.reset()``, and those launched while a
#: profiler records.
counts = PassCounts()


@functools.cache
def _library():
    """The committed kernel's library, built and loaded once, with its
    entry points typed."""
    from ..kernels import load
    lib = load("gmm_passes")
    lib.gmm_pass.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_void_p] * 13
                             + [ctypes.c_float, ctypes.c_longlong,
                                ctypes.c_longlong, ctypes.c_void_p])
    lib.gmm_model_size.argtypes = [ctypes.c_int]
    lib.gmm_model_field.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
    lib.gmm_grid.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)]
    for fn in (lib.gmm_pass, lib.gmm_model_size, lib.gmm_model_field,
               lib.gmm_grid):
        fn.restype = ctypes.c_int
    return lib


def _entry():
    """The kernel's launch entry point."""
    return _library().gmm_pass


@functools.cache
def _layout(k: int) -> tuple[dict, int]:
    """An image's model at k components a class, as the kernel lays it
    out: (name -> (offset, shape) for `model_fields`, size in floats).
    A field whose size is not its shape's raises."""
    lib = _library()
    fields = {}
    for f, (name, shape) in enumerate(model_fields(k)):
        off, size = ctypes.c_int(), ctypes.c_int()
        if lib.gmm_model_field(k, f, ctypes.byref(off), ctypes.byref(size)):
            raise RuntimeError(f"gmm_passes has no model field {f} ({name})")
        if size.value != math.prod(shape):
            raise RuntimeError(f"gmm_passes' model field {name} holds "
                               f"{size.value} floats, not {shape}")
        fields[name] = (off.value, shape)
    return fields, lib.gmm_model_size(k)


def _grid(kind: int, B: int, HW: int, k: int, sms: int) -> tuple[int, int]:
    """A pass's blocks an image and the float64 partials its batch needs,
    as the kernel sizes them (gmm_grid: the grid follows B H W)."""
    partials = ctypes.c_longlong()
    chunks = _library().gmm_grid(kind, B, HW, k, sms,
                                 ctypes.byref(partials))
    if chunks < 1:
        raise ValueError(f"gmm_passes takes no {PASS_KINDS[kind]} pass of "
                         f"B={B}, {HW} pixels, k={k}")
    return chunks, partials.value


def _on_card(t: torch.Tensor) -> bool:
    """Whether `t` takes the passes (a CUDA tensor) or the plain path."""
    return t.device.type == "cuda"


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


class CardPasses:
    """One batch's colour-model state on the card and its passes: the
    (B, H, W, 3) float32 pixels, k components a class, every image's model
    (`_layout`), the blocks' partials and the arrival counts, each sized as
    the kernel says.  `launch` runs one pass on the current stream, with no
    host sync."""

    #: Launches of the colour-model kernel since the count was last set to
    #: 0.
    kernel_launches = 0

    def __init__(self, pix: torch.Tensor, k: int):
        if pix.dim() != 4 or pix.shape[-1] != 3 or not _on_card(pix):
            raise ValueError(f"CardPasses takes (B, H, W, 3) pixels on a "
                             f"CUDA device, got {tuple(pix.shape)} on "
                             f"{pix.device}")
        if k < 1:
            raise ValueError(f"k = {k} components (>= 1)")
        B, H, W, _ = pix.shape
        if B * H * W == 0 or H * W >= 2 ** 31 or B > 65535:
            raise ValueError(f"CardPasses takes 0 < H W < 2^31 pixels and "
                             f"0 < B <= 65535, got {tuple(pix.shape)}")
        dev = pix.device
        self.pix = pix.float().contiguous()
        self.B, self.H, self.W, self.k = B, H, W, k
        self.fields, size = _layout(k)
        self.model = torch.zeros((B, size), device=dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grids = [_grid(kind, B, H * W, k, sms)
                 for kind in range(len(PASS_KINDS))]
        self.chunks = [c for c, _ in grids]
        self.partial = torch.empty(max(1, max(n for _, n in grids)),
                                   dtype=torch.float64, device=dev)
        self.arrivals = torch.zeros(B, dtype=torch.int32, device=dev)

    def _cls(self, cls: torch.Tensor) -> torch.Tensor:
        """A (B, H, W) trimap or foreground flag as one byte a pixel."""
        if cls.shape != self.pix.shape[:3]:
            raise ValueError(f"class plane {tuple(cls.shape)} does not match "
                             f"the pixels {tuple(self.pix.shape[:3])}")
        if cls.dtype == torch.bool:
            cls = cls.view(torch.uint8)
        return cls.to(device=self.pix.device, dtype=torch.uint8).contiguous()

    def launch(self, kind: int, cls: torch.Tensor, step: int = 0,
               draws: int = 0, comp_in=None, comp_out=None, noise=(None, None),
               e_carry=None, e_prev=None, e_t=None, excess=None,
               lam: float = 0.0) -> None:
        """One pass of `kind` (`PASS_KINDS`) with `cls` from `_cls`; every
        plane it is given is a contiguous (B, H, W) tensor on the pixels'
        device (int64 labels, float32 energies), the noise (draws, H W)
        float32.  A plane that is not, or a refused launch, raises."""
        dev = self.pix.device
        plane = self.pix.shape[:3]
        draw = (draws, self.H * self.W)
        for t, dtype, shape in ((cls, torch.uint8, plane),
                                (comp_in, torch.int64, plane),
                                (comp_out, torch.int64, plane),
                                (noise[0], torch.float32, draw),
                                (noise[1], torch.float32, draw),
                                (e_carry, torch.float32, plane),
                                (e_prev, torch.float32, plane),
                                (e_t, torch.float32, plane),
                                (excess, torch.float32, plane)):
            if t is not None and (t.dtype != dtype or t.shape != shape
                                  or t.device != dev
                                  or not t.is_contiguous()):
                raise ValueError(f"gmm_passes {PASS_KINDS[kind]}: a plane of "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}, "
                                 f"not a contiguous {dtype} {tuple(shape)} "
                                 f"on {dev}")
        with torch.cuda.device(dev):
            err = _entry()(kind, self.B, self.H * self.W, self.k,
                           self.chunks[kind], step, draws,
                           self.pix.data_ptr(), cls.data_ptr(),
                           _ptr(comp_in), _ptr(comp_out), _ptr(noise[0]),
                           _ptr(noise[1]), self.model.data_ptr(),
                           self.partial.data_ptr(), self.arrivals.data_ptr(),
                           _ptr(e_carry), _ptr(e_prev), _ptr(e_t),
                           _ptr(excess), lam, self.model.numel(),
                           self.partial.numel(),
                           torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"gmm_passes {PASS_KINDS[kind]} launch failed: "
                               f"CUDA error {err}")
        CardPasses.kernel_launches += 1
        counts._record(kind, self.B)

    def view(self, name: str) -> torch.Tensor:
        """(B, ...) view of the model's `name` (`model_fields`)."""
        off, shape = self.fields[name]
        return self.model[:, off:off + math.prod(shape)].reshape(self.B,
                                                                 *shape)

    def gmm(self, c: int) -> dict:
        """Class c's fitted GMM (0 foreground, 1 background) as `fit_gmm`
        gives it: weights, means, inv_cov, log_norm, counts."""
        return {name: self.view(f"{name}{c}") for name in
                ("weights", "means", "inv_cov", "log_norm", "counts")}


#: The k-means++ seeds of the foreground and the background (initGMMs).
KMEANS_SEEDS = (0, 1)


#: kmeans' Lloyd steps.
KMEANS_STEPS = 10


def class_components(pixels: torch.Tensor, fg_sel: torch.Tensor, k: int
                     ) -> torch.Tensor:
    """initGMMs: seeded k-means of each class of (..., H, W, 3) pixels, the
    foreground (`fg_sel`, (..., H, W) bool) under seed 0 and the
    background under seed 1 (`KMEANS_SEEDS`); every pixel takes its own
    class's nearest centre -> (..., H, W) int64 labels.  On the card:
    SEED, k - 1 DRAWs, `KMEANS_STEPS` LLOYDs and LABELS."""
    *lead, H, W, C = pixels.shape
    if not _on_card(pixels):
        fg = kmeans(pixels, fg_sel.float(), k, KMEANS_STEPS, KMEANS_SEEDS[0])
        bg = kmeans(pixels, (~fg_sel).float(), k, KMEANS_STEPS,
                    KMEANS_SEEDS[1])
        return torch.where(fg_sel, fg, bg)
    run = CardPasses(pixels.reshape(-1, H, W, C), k)
    cls = run._cls(fg_sel.reshape(-1, H, W))
    noise = tuple(device_noise(s, H * W, k - 1, pixels.device)
                  for s in KMEANS_SEEDS)
    run.launch(SEED, cls)
    for i in range(k - 1):
        run.launch(DRAW, cls, step=i, draws=k - 1, noise=noise)
    for _ in range(KMEANS_STEPS):
        run.launch(LLOYD, cls)
    labels = torch.empty((run.B, H, W), dtype=torch.int64,
                         device=pixels.device)
    run.launch(LABELS, cls, comp_out=labels)
    return labels.reshape(*lead, H, W)


class ColourModels:
    """Both classes' k-component GMMs of a batch of same-size images, as
    GrabCut's iteration needs them (cv2 order): `fit` from given
    components, `refit` (assign every pixel its best component under its
    class's carried GMM, then fit again) and `terminal` (the capacities
    from the log-likelihood ratio).  `pixels` (B, H, W, 3); every mask is
    a (B, H, W) uint8 trimap.  A CPU tensor takes the plain functions
    (`fit_gmm`, `assign_components`, `gmm_log_prob`); a CUDA tensor a FIT,
    ASSIGN or TERMINAL pass of csrc/gmm_passes.cu, bit for bit theirs."""

    def __init__(self, pixels: torch.Tensor, k: int):
        self.pix = pixels.float()
        self.k = k
        self.card = CardPasses(self.pix, k) if _on_card(pixels) else None
        self.fg = self.bg = None

    def fit(self, mask: torch.Tensor, comp: torch.Tensor) -> None:
        """Both GMMs from the (B, H, W) components `comp`."""
        if self.card is not None:
            self.card.launch(FIT, self.card._cls(mask),
                             comp_in=comp.long().contiguous())
            return
        fg_sel, bg_sel = class_masks(mask)
        self.fg = fit_gmm(self.pix, fg_sel, comp, self.k)
        self.bg = fit_gmm(self.pix, bg_sel, comp, self.k)

    def refit(self, mask: torch.Tensor, want_comp: bool = True):
        """Assign each pixel its best component under its class's GMM,
        then fit both GMMs on those; returns the (B, H, W) int64
        components, or None on the card where `want_comp` is False (the
        pass then writes none)."""
        if self.card is not None:
            comp = (torch.empty(mask.shape, dtype=torch.int64,
                                device=self.pix.device) if want_comp
                    else None)
            self.card.launch(ASSIGN, self.card._cls(mask), comp_out=comp)
            return comp
        fg_sel, bg_sel = class_masks(mask)
        comp = torch.where(fg_sel > 0, assign_components(self.pix, self.fg),
                           assign_components(self.pix, self.bg))
        self.fg = fit_gmm(self.pix, fg_sel, comp, self.k)
        self.bg = fit_gmm(self.pix, bg_sel, comp, self.k)
        return comp

    def terminal(self, mask: torch.Tensor, lam: float,
                 e_carry: torch.Tensor | None = None,
                 e_prev: torch.Tensor | None = None):
        """E_t, the terminal energy: the log-likelihood ratio of the two
        GMMs clamped to +-lam, lam at FG and -lam at BG; and, given the
        carried excess and the previous E_t, the flow-recycled excess
        e_carry + (E_t - e_prev) (else None).  Returns (E_t, excess)."""
        if self.card is not None:
            dev = self.pix.device
            e_t = torch.empty(mask.shape, device=dev)
            excess = None
            if e_carry is not None:
                excess = torch.empty(mask.shape, device=dev)
                e_carry = e_carry.float().contiguous()
                e_prev = e_prev.float().contiguous()
            self.card.launch(TERMINAL, self.card._cls(mask), e_carry=e_carry,
                             e_prev=e_prev, e_t=e_t, excess=excess, lam=lam)
            return e_t, excess
        unknown = (gmm_log_prob(self.pix, self.fg)
                   - gmm_log_prob(self.pix, self.bg)).clamp(-lam, lam)
        e_t = torch.where(mask == TRIMAP_FG, lam,
                          torch.where(mask == TRIMAP_BG, -lam, unknown))
        excess = None if e_carry is None else e_carry + (e_t - e_prev)
        return e_t, excess

    def gmm(self, c: int) -> dict:
        """Class c's current GMM (0 foreground, 1 background), with
        `fit_gmm`'s entries."""
        if self.card is not None:
            return self.card.gmm(c)
        return self.fg if c == 0 else self.bg
