"""GrabCut's colour models through ops/gmm.py's two wrappers,
`class_components` and `ColourModels`.  On the CPU: the wrappers' plain
path against the plain steps, the pass counter and the recording policy
it shares with the min-cut's, the noise kept on a device (one shape a
device), and the wrapper's buffers sized as the kernel says.  Marked
`cuda` (skipped without a card): each pass of csrc/gmm_passes.cu against
the plain steps on the card, bit for bit, at the main path's shapes
(8 x 512^2, 1 x 1536^2) and an odd one, in RGB and Lab, k = 5 and 3; the
lock-step solve against the image-by-image one; the kernel's grid and
model layout; the noise uploaded once per shape; the counter.  The file
imports no JAX, so on the card it runs alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_gmm_kernel.py
"""

import contextlib
import gc as garbage
import json
import math
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gcn_grabcut_torch import grabcut as gc
from gcn_grabcut_torch import kernels, utils
from gcn_grabcut_torch.ops import gmm, maxflow
from gcn_grabcut_torch.ops.threefry import kmeans_pp_noise

torch.set_num_threads(1)

LAM = 450.0


def scene(B: int, H: int, W: int, seed: int, color_space: str = "rgb"):
    """B images of seeded integer RGB noise, each with a reddish disc, and
    trimaps around the disc (FG inside, PR_FG round it, then PR_BG or BG,
    the top rows BG), the pixels in `color_space`."""
    r = np.random.RandomState(seed)
    imgs = r.randint(0, 256, (B, H, W, 3)).astype(np.float32)
    yy, xx = np.mgrid[:H, :W]
    tri = np.zeros((B, H, W), np.uint8)
    for b in range(B):
        cy, cx = r.randint(H // 4, 3 * H // 4), r.randint(W // 4, 3 * W // 4)
        d = np.hypot(yy - cy, xx - cx)
        disc = d < H / 4
        imgs[b][disc] = np.round(imgs[b][disc] * 0.3
                                 + np.float32([200, 60, 40]) * 0.7)
        tri[b][d < H / 2.5] = 3
        tri[b][d < H / 6] = 1
        tri[b][d >= H / 2.5] = 2 if b % 2 else 0
        tri[b][:2] = 0
    pix = gc.preprocess_device(torch.from_numpy(imgs), color_space)
    return pix, torch.from_numpy(tri)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit (float32 compared as int32, so -0 != +0 and a NaN
    matches a NaN of the same bits)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
    return torch.equal(a, b)


# ---------------------------------------------------------------- the CPU

CPU_SHAPE = (2, 20, 24)


def test_class_components_on_the_cpu_is_the_plain_kmeans():
    pix, tri = scene(*CPU_SHAPE, seed=3)
    fg = (tri == 1) | (tri == 3)
    labels = gmm.class_components(pix, fg, 5)
    lf, cf = gmm.kmeans(pix, fg.float(), 5, seed=0, return_centres=True)
    lb = gmm.kmeans(pix, (~fg).float(), 5, seed=1)
    assert torch.equal(labels, torch.where(fg, lf, lb))
    assert labels.dtype == torch.int64
    assert cf.shape == (2, 5, 3)
    assert torch.equal(gmm.kmeans(pix, fg.float(), 5, seed=0), lf)
    one = gmm.class_components(pix[1], fg[1], 5)
    assert torch.equal(one, labels[1])


def test_colour_models_on_the_cpu_are_the_plain_steps():
    pix, tri = scene(*CPU_SHAPE, seed=4, color_space="lab")
    fg_w, bg_w = gmm.class_masks(tri)
    comp = gmm.class_components(pix, fg_w > 0, 5)
    models = gmm.ColourModels(pix, 5)
    models.fit(tri, comp)
    fg = gmm.fit_gmm(pix, fg_w, comp, 5)
    bg = gmm.fit_gmm(pix, bg_w, comp, 5)
    for name in fg:
        assert torch.equal(models.gmm(0)[name], fg[name]), name
        assert torch.equal(models.gmm(1)[name], bg[name]), name
    want = torch.where(fg_w > 0, gmm.assign_components(pix, fg),
                       gmm.assign_components(pix, bg))
    assert torch.equal(models.refit(tri, want_comp=False), want)
    fg = gmm.fit_gmm(pix, fg_w, want, 5)
    bg = gmm.fit_gmm(pix, bg_w, want, 5)
    assert torch.equal(models.gmm(0)["log_norm"], fg["log_norm"])
    r = np.random.RandomState(0)
    carry, prev = (torch.from_numpy(r.randn(*CPU_SHAPE).astype(np.float32))
                   for _ in range(2))
    e_t, excess = models.terminal(tri, LAM, carry, prev)
    unknown = (gmm.gmm_log_prob(pix, fg) - gmm.gmm_log_prob(pix, bg)
               ).clamp(-LAM, LAM)
    want_t = torch.where(tri == 1, LAM, torch.where(tri == 0, -LAM, unknown))
    assert same_bits(e_t, want_t)
    assert same_bits(excess, carry + (want_t - prev))
    alone, none = models.terminal(tri, LAM)
    assert same_bits(alone, want_t) and none is None


def test_pass_counts_record_after_reset_or_under_a_profiler():
    counts = gmm.PassCounts()
    counts._record(gmm.SEED, 8)
    assert counts.passes == [] and not counts.active
    with profile(activities=[ProfilerActivity.CPU]):
        assert counts.active
        counts._record(gmm.DRAW, 8)
        counts._record(gmm.TERMINAL, 8)
    counts._record(gmm.FIT, 8)
    assert counts.passes == [("draw", 8), ("terminal", 8)]
    counts.reset()
    counts._record(gmm.LLOYD, 1)
    counts._record(gmm.LLOYD, 1)
    assert counts.totals() == dict(passes=2, images=2,
                                   by_kind={"lloyd": 2})
    counts.clear()
    assert counts.passes == [] and counts.recording
    assert gmm.counts.passes == []   # nothing on the CPU launched a pass


@pytest.mark.parametrize("counter", [maxflow.SolverCounts, gmm.PassCounts])
def test_counters_share_one_recording_policy(counter):
    """Both program counters keep what they count after reset() and while a
    profiler records, and nothing otherwise (utils.Recorder)."""
    counts = counter()
    assert isinstance(counts, utils.Recorder)
    assert not counts.active and not counts.recording
    with profile(activities=[ProfilerActivity.CPU]):
        assert counts.active
    assert not counts.active
    counts.reset()
    assert counts.active and counts.recording
    counts.clear()
    assert counts.recording


def test_profile_trace_clears_and_writes_both_counters(tmp_path):
    gmm.counts.passes.append(("seed", 3))      # left from an earlier window
    maxflow.counts._calls.append([np.array([2]), 1, 4, None])
    with utils.profile_trace(tmp_path):
        gmm.counts._record(gmm.FIT, 8)
        gmm.counts._record(gmm.ASSIGN, 8)
    stem = str(next(tmp_path.glob("*.pt.trace.json")))[:-len(".pt.trace.json")]
    assert json.loads(open(f"{stem}.gmm.json").read()) == dict(
        passes=2, images=16, by_kind={"fit": 1, "assign": 1})
    assert json.loads(open(f"{stem}.mincut.json").read())["solves"] == 0
    gmm.counts.clear()


def test_device_noise_is_the_jax_noise_uploaded_once():
    gmm._noise.clear()
    a = gmm.device_noise(0, 480, 4, torch.device("cpu"))
    assert torch.equal(a, torch.from_numpy(np.array(kmeans_pp_noise(0, 480, 4))))
    assert gmm.device_noise(0, 480, 4, "cpu") is a
    assert gmm.device_noise(1, 480, 4, "cpu") is not a
    gmm._noise.clear()


@pytest.mark.parametrize("second", [(500, 4), (480, 2)],
                         ids=["pixels", "draws"])
def test_a_new_shape_lets_the_old_noise_go(second):
    """A device keeps the noise of one shape: a second shape drops the
    first one's planes, so a server that sees many sizes holds one."""
    gmm._noise.clear()
    cpu = torch.device("cpu")
    old = [weakref.ref(gmm.device_noise(s, 480, 4, cpu)) for s in (0, 1)]
    new = gmm.device_noise(0, *second, cpu)
    garbage.collect()
    assert all(r() is None for r in old)
    assert list(gmm._noise) == [cpu]
    assert gmm._noise[cpu][0] == second
    assert list(gmm._noise[cpu][1].values()) == [new]
    gmm._noise.clear()


def test_device_noise_keeps_two_seeds_a_shape():
    gmm._noise.clear()
    first = weakref.ref(gmm.device_noise(0, 64, 2, "cpu"))
    gmm.device_noise(1, 64, 2, "cpu")
    gmm.device_noise(7, 64, 2, "cpu")
    garbage.collect()
    assert first() is None
    assert sorted(gmm._noise[torch.device("cpu")][1]) == [1, 7]
    gmm._noise.clear()


class FakeLibrary:
    """The kernel library's sizing entry points, stood in on the CPU with
    a layout of its own: field f at 100 f, `size` floats."""

    def __init__(self, size=None):
        self.size = size

    def gmm_model_field(self, k, f, offset, size):
        if f >= len(gmm.model_fields(k)):
            return -1
        offset._obj.value = 100 * f
        size._obj.value = (self.size if self.size is not None
                           else math.prod(gmm.model_fields(k)[f][1]))
        return 0

    def gmm_model_size(self, k):
        return 100 * len(gmm.model_fields(k))

    def gmm_grid(self, kind, B, HW, k, sms, partials):
        partials._obj.value = B * (kind + 1) * 7
        return kind + 1


def test_model_views_follow_the_kernels_layout(monkeypatch):
    """The wrapper takes every offset and size from the kernel library
    (here a stand-in) and checks each field's size against its shape."""
    monkeypatch.setattr(gmm, "_library", lambda: FakeLibrary())
    gmm._layout.cache_clear()
    try:
        fields, size = gmm._layout(5)
        assert size == 1900
        assert fields["centres"] == (0, (2, 5, 3))
        assert fields["inv_cov1"] == (1600, (5, 3, 3))
        assert gmm._grid(gmm.FIT, 3, 4096, 5, 132) == (5, 105)
        monkeypatch.setattr(gmm, "_library", lambda: FakeLibrary(size=4))
        gmm._layout.cache_clear()
        with pytest.raises(RuntimeError, match="holds 4 floats"):
            gmm._layout(5)
    finally:
        gmm._layout.cache_clear()


def test_card_passes_size_their_buffers_as_the_kernel_says(monkeypatch):
    """CardPasses allocates the model and the partials the kernel's
    gmm_model_size and gmm_grid ask for, and hands their lengths to every
    launch (a stand-in card: CPU tensors, a stand-in library)."""
    monkeypatch.setattr(gmm, "_on_card", lambda t: True)
    monkeypatch.setattr(gmm, "_library", lambda: FakeLibrary())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count":
                                                   1}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    gmm._layout.cache_clear()
    seen = []
    monkeypatch.setattr(gmm, "_entry", lambda: lambda *a: seen.append(a)
                        or 0)
    try:
        pix, tri = scene(*CPU_SHAPE, seed=7)
        run = gmm.CardPasses(pix, 5)
        assert run.model.shape == (2, 1900)
        assert run.chunks == [1, 2, 3, 4, 5, 6, 7]
        assert run.partial.numel() == 2 * 7 * 7
        run.launch(gmm.TERMINAL, run._cls(tri))
        assert seen[0][4] == 7 and seen[0][-3:-1] == (3800, 98)
    finally:
        gmm._layout.cache_clear()


def test_card_passes_take_card_tensors_only():
    pix, _ = scene(*CPU_SHAPE, seed=5)
    with pytest.raises(ValueError, match="CUDA"):
        gmm.CardPasses(pix, 5)
    assert "gmm_passes" in kernels.sources()


def test_card_passes_refuse_a_wrong_plane_before_launching(monkeypatch):
    """The wrapper checks every plane's dtype, shape and layout before the
    kernel is reached (here a stand-in card: CPU tensors, no kernel)."""
    monkeypatch.setattr(gmm, "_on_card", lambda t: True)
    monkeypatch.setattr(gmm, "_library", lambda: FakeLibrary())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count":
                                                   1}))

    def no_kernel():
        raise AssertionError("the kernel was reached")

    monkeypatch.setattr(gmm, "_entry", no_kernel)
    gmm._layout.cache_clear()
    pix, tri = scene(*CPU_SHAPE, seed=6)
    run = gmm.CardPasses(pix, 5)
    gmm._layout.cache_clear()
    cls = run._cls(tri)
    good = torch.zeros(CPU_SHAPE, dtype=torch.int64)
    for kw in (dict(comp_in=good.int()), dict(comp_in=good[:1]),
               dict(comp_out=good.transpose(1, 2).contiguous().transpose(
                   1, 2)),
               dict(e_t=torch.zeros(CPU_SHAPE, dtype=torch.float64)),
               dict(noise=(torch.zeros(4, 480), torch.zeros(3, 480)),
                    draws=4)):
        with pytest.raises(ValueError, match="not a contiguous"):
            run.launch(gmm.FIT, cls, **kw)
    with pytest.raises(ValueError, match="does not match"):
        run._cls(tri[:, :5])


# --------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def plain(monkeypatch):
    """Route CUDA tensors through the plain steps (the oracle) until undone."""
    monkeypatch.setattr(gmm, "_on_card", lambda t: False)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 512 * 512), (1, 1536 * 1536),
                                   (3, 37 * 53), (1, 10), (64, 4096)],
                         ids=lambda s: f"B{s[0]}-HW{s[1]}")
def test_pass_grid_follows_the_batch_pixels(cuda, shape):
    """gmm_grid: about 2 blocks a SM over the batch for the summing passes,
    8 for the others, at least one an image and at most one a 128 pixels;
    the partials a block writes by kind."""
    B, HW = shape
    sms, k = 132, 5
    per_block = {gmm.SEED: 4, gmm.DRAW: 4, gmm.LLOYD: 2 * k * 4,
                 gmm.FIT: 2 * k * 10, gmm.ASSIGN: 2 * k * 10}
    for kind in range(len(gmm.PASS_KINDS)):
        chunks, partials = gmm._grid(kind, B, HW, k, sms)
        assert 1 <= chunks <= max(1, -(-HW // 128))
        per_sm = 2 if kind in (gmm.LLOYD, gmm.FIT, gmm.ASSIGN) else 8
        if -(-HW // 128) >= -(-per_sm * sms // B):
            # big enough to fill the card: about per_sm blocks a SM
            assert per_sm * sms <= B * chunks < per_sm * sms + B
        assert partials == B * chunks * per_block.get(kind, 0)
    assert gmm._grid(gmm.FIT, 8, 512 * 512, k, sms)[0] == 33
    assert gmm._grid(gmm.TERMINAL, 1, 1536 * 1536, k, sms)[0] == 1056


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 12])
def test_model_layout_tiles_the_model(cuda, k):
    """The kernel's fields tile an image's model with no gap or overlap."""
    fields, size = gmm._layout(k)
    spans = sorted((off, off + math.prod(shape))
                   for off, shape in fields.values())
    assert spans[0][0] == 0 and spans[-1][1] == size
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.cuda
def test_a_pass_refuses_buffers_too_small(cuda):
    pix, tri = scene(2, 40, 40, seed=12)
    run = gmm.CardPasses(pix.to(cuda), 5)
    cls = run._cls(tri.to(cuda))
    run.launch(gmm.FIT, cls, comp_in=torch.zeros((2, 40, 40),
                                                 dtype=torch.int64,
                                                 device=cuda))
    for name in ("model", "partial"):
        whole = getattr(run, name)
        setattr(run, name, whole[:1] if name == "model" else whole[:-1])
        with pytest.raises(RuntimeError, match="launch failed"):
            run.launch(gmm.FIT, cls, comp_in=torch.zeros(
                (2, 40, 40), dtype=torch.int64, device=cuda))
        setattr(run, name, whole)


def card_kmeans(pix, fg, k):
    """The k-means passes as `class_components` launches them, read
    between them: the k-means++ centres and their labels, then the centres
    after the Lloyd steps."""
    B, H, W, _ = pix.shape
    run = gmm.CardPasses(pix, k)
    cls = run._cls(fg)
    noise = tuple(gmm.device_noise(s, H * W, k - 1, pix.device)
                  for s in gmm.KMEANS_SEEDS)
    run.launch(gmm.SEED, cls)
    for i in range(k - 1):
        run.launch(gmm.DRAW, cls, step=i, draws=k - 1, noise=noise)
    seeds = run.view("centres").clone()
    seed_labels = torch.empty((B, H, W), dtype=torch.int64, device=pix.device)
    run.launch(gmm.LABELS, cls, comp_out=seed_labels)
    for _ in range(gmm.KMEANS_STEPS):
        run.launch(gmm.LLOYD, cls)
    return seeds, seed_labels, run.view("centres").clone()


def plain_kmeans(pix, fg, k, n_iter):
    """The plain k-means of both classes: labels and (B, 2, k, 3)
    centres."""
    lf, cf = gmm.kmeans(pix, fg.float(), k, n_iter, gmm.KMEANS_SEEDS[0],
                        return_centres=True)
    lb, cb = gmm.kmeans(pix, (~fg).float(), k, n_iter, gmm.KMEANS_SEEDS[1],
                        return_centres=True)
    return torch.where(fg, lf, lb), torch.stack([cf, cb], dim=1)


SHAPES = {"b8-512": (8, 512, 512), "b1-1536": (1, 1536, 1536),
          "b3-37x53": (3, 37, 53)}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 3])
@pytest.mark.parametrize("color_space", ["rgb", "lab"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_passes_match_the_plain_steps_on_the_card(cuda, monkeypatch, shape,
                                                  color_space, k):
    """SEED, DRAW, LLOYD and LABELS (the k-means: labels and centres), FIT
    (the float64 sums rounded once, the fitted GMMs), two rounds of ASSIGN
    (components, GMMs) and TERMINAL (E_t, the excess), each against the
    plain steps on the card, bit for bit."""
    B, H, W = SHAPES[shape]
    pix, tri = scene(B, H, W, seed=B * H + k, color_space=color_space)
    pix, tri = pix.to(cuda), tri.to(cuda)
    fg = (tri == 1) | (tri == 3)
    labels = gmm.class_components(pix, fg, k)
    seeds, seed_labels, centres = card_kmeans(pix, fg, k)
    card = gmm.ColourModels(pix, k)
    card.fit(tri, labels)
    sums = {f"{n}{c}": card.card.view(f"{n}{c}").clone() for n in
            ("counts", "sum_x", "sum_xx") for c in range(2)}
    fits = [{n: a.clone() for n, a in card.gmm(c).items()} for c in (0, 1)]
    r = np.random.RandomState(k)
    carry, prev = (torch.from_numpy(r.randn(B, H, W).astype(np.float32)
                                    * 100).to(cuda) for _ in range(2))
    rounds = []
    for last in (False, True):
        comp = card.refit(tri, want_comp=last)
        rounds.append((comp, [{n: a.clone() for n, a in card.gmm(c).items()}
                              for c in (0, 1)],
                       card.terminal(tri, LAM, carry, prev)))
    assert rounds[0][0] is None

    plain(monkeypatch)
    want = plain_kmeans(pix, fg, k, gmm.KMEANS_STEPS)
    assert same_bits(labels, gmm.class_components(pix, fg, k)), "labels"
    assert same_bits(labels, want[0]), "labels"
    assert same_bits(centres, want[1]), "centres"
    want_seeds = plain_kmeans(pix, fg, k, 0)
    assert same_bits(seeds, want_seeds[1]), "k-means++ centres"
    assert same_bits(seed_labels, want_seeds[0]), "seed labels"
    ref = gmm.ColourModels(pix, k)
    ref.fit(tri, want[0])
    flat = pix.reshape(B, H * W, 3)
    xx = (flat[..., :, None] * flat[..., None, :]).reshape(B, H * W, 9)
    for c, sel in enumerate(gmm.class_masks(tri)):
        onehot = torch.nn.functional.one_hot(want[0].reshape(B, -1), k
                                             ).float() * sel.reshape(B, -1, 1)
        assert same_bits(sums[f"counts{c}"], gmm._pixel_sum(onehot))
        assert same_bits(sums[f"sum_x{c}"], gmm._pixel_matmul(onehot, flat))
        assert same_bits(sums[f"sum_xx{c}"], gmm._pixel_matmul(
            onehot, xx).reshape(B, k, 3, 3))
        for name, a in ref.gmm(c).items():
            assert same_bits(fits[c][name], a), ("fit", c, name)
    for comp, gmms, (e_t, excess) in rounds:
        want_comp = ref.refit(tri)
        if comp is not None:
            assert same_bits(comp, want_comp), "components"
        for c in (0, 1):
            for name, a in ref.gmm(c).items():
                assert same_bits(gmms[c][name], a), ("refit", c, name)
        want_t, want_x = ref.terminal(tri, LAM, carry, prev)
        assert same_bits(e_t, want_t), "E_t"
        assert same_bits(excess, want_x), "excess"


@pytest.mark.cuda
def test_lock_step_grabcut_on_the_card_matches_the_loop(cuda, monkeypatch):
    """grabcut_batch_device (the passes, in lock step) against
    grabcut_batch_loop (the passes, image by image) and against the
    lock step on the plain steps; one image's trimap one-sided."""
    pix, tri = scene(6, 96, 80, seed=21)
    tri[2] = np.uint8(3)
    pix, tri = pix.to(cuda), tri.to(cuda)
    batch = gc.grabcut_batch_device(pix, tri)
    loop = gc.grabcut_batch_loop(pix, tri)
    plain(monkeypatch)
    eager = gc.grabcut_batch_device(pix, tri)
    assert torch.equal(batch, loop)
    assert torch.equal(batch, eager)


@pytest.mark.cuda
def test_card_tensors_never_take_the_plain_steps(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor took the plain steps")

    for name in ("kmeans", "fit_gmm", "assign_components", "gmm_log_prob",
                 "component_scores", "_pixel_matmul", "_pixel_sum"):
        monkeypatch.setattr(gmm, name, refuse)
    pix, tri = scene(2, 64, 48, seed=8)
    img = pix[0].to(torch.uint8).numpy()
    masks = gc.grabcut_batch_device(pix.to(cuda), tri.to(cuda))
    assert masks.shape == (2, 64, 48)
    for backend in ("device", "native"):
        cut = gc.GrabCut(img, gc.GrabCutConfig(backend=backend), device=cuda)
        cut.run_with_trimap(tri[0].numpy())
        cut.refine(1)


@pytest.mark.cuda
def test_noise_is_uploaded_once_per_shape(cuda):
    """A shape's noise is uploaded once; a second shape frees the first
    one's planes, so the card holds one shape's noise."""
    pix, tri = scene(2, 256, 240, seed=9)
    pix, fg = pix.to(cuda), ((tri == 1) | (tri == 3)).to(cuda)
    gmm._noise.clear()
    gmm.class_components(pix, fg, 5)
    torch.cuda.synchronize()
    planes = list(gmm._noise[pix.device][1].values())
    assert len(planes) == 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gmm.class_components(pix, fg, 5)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert not any("Memcpy HtoD" in n for n in names), sorted(set(names))
    assert list(gmm._noise[pix.device][1].values()) == planes
    held = torch.cuda.memory_allocated(cuda)
    old = [weakref.ref(p) for p in planes]
    del planes
    gmm.class_components(pix[:, :40], fg[:, :40], 5)
    torch.cuda.synchronize()
    assert all(r() is None for r in old)
    # the first shape's 2 x 4 x 256 x 240 floats (~1.97 MB) went back; the
    # second's 2 x 4 x 40 x 240 (~0.31 MB) stay
    assert torch.cuda.memory_allocated(cuda) < held - 1_500_000
    gmm._noise.clear()


@pytest.mark.cuda
def test_passes_are_counted_and_recorded_under_a_profiler(cuda):
    pix, tri = scene(3, 40, 40, seed=10)
    pix, tri = pix.to(cuda), tri.to(cuda)
    fg = (tri == 1) | (tri == 3)
    gmm.counts.clear()
    start = gmm.CardPasses.kernel_launches
    comp = gmm.class_components(pix, fg, 5)
    assert gmm.CardPasses.kernel_launches - start == 16
    assert gmm.counts.passes == []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        gmm.class_components(pix, fg, 5)
        gc._grabcut_solve_batch(pix, tri, comp, 50.0, 5, 5)
    totals = gmm.counts.totals()
    gmm.counts.clear()
    assert totals == dict(passes=27, images=81, by_kind=dict(
        seed=1, draw=4, lloyd=10, labels=1, fit=1, assign=5, terminal=5))
    assert gmm.CardPasses.kernel_launches - start == 16 + 27
