"""The min-cut kernel's plain version and wrapper on the CPU: the plain
version (``ops.maxflow.grid_mincut_plain``, which every CPU solve takes and
which the kernel in csrc/grid_mincut.cu must match bit for bit on the card)
against the JAX package's ``grid_mincut_stateful``, image by image, on the
cases whose semantics the kernel copies (4- and 8-connectivity, a lock-step
batch whose images converge at different rounds, a carried flow,
``max_outer`` and ``relabel_iters`` binding); the counts it tallies; the
kernel wrapper's input checks; and the counts of a kernel solve, read from
its tallies only when a count is read; and that nothing is recorded until
a caller asks (`counts.reset()`).  tests/test_torch_cuda.py holds the
kernel to the plain version on the same cases on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_grabcut_tpu.ops import maxflow as jmf
from gcn_grabcut_torch.ops import maxflow as tmf
from test_torch_cuda import MINCUT_CASES, mincut_case

torch.set_num_threads(1)

E_TOL = 1e-5    # e' against JAX (the same float32 operations, XLA's fusion)

# Each case's tallies before the kernel: per image outer rounds, relabel
# steps and host syncs of the solve.
COUNTS_BEFORE = {
    "conn8": ([4], 70, 40),
    "conn4": ([4, 16], 930, 482),
    "lock-step": ([0, 4, 9], 484, 252),
    "carried": ([0, 6, 5], 98, 56),
    "max-outer": ([0, 2, 2], 184, 94),
    "relabel-iters": ([0, 3, 0], 20, 14),
    "unroll1-odd": ([6, 18], 1160, 1179),
    "border-37x67": ([0, 4, 14], 1018, 524),
    "border-conn4": ([3, 32], 2898, 1482),
    "thin-3-rows": ([2, 6], 476, 245),
    "unroll6": ([4, 7], 438, 81),
    "signed-zeros": ([0, 1], 416, 209),
}


@pytest.mark.parametrize("name", list(MINCUT_CASES))
def test_plain_version_matches_jax_image_by_image(name):
    """Each image of the plain version's (lock-step) solve against JAX's
    solve of that image alone: fg bit for bit, e' and both residual planes
    within E_TOL."""
    ex, r_fwd, r_bwd, conn, kw = mincut_case(name)
    fg, e, rf, rb = tmf.grid_mincut_plain(ex, r_fwd, r_bwd, conn, **kw)
    for b in range(ex.shape[0]):
        jfg, je, jrf, jrb = jmf.grid_mincut_stateful(
            jnp.asarray(ex[b].numpy()),
            tuple(jnp.asarray(r[b].numpy()) for r in r_fwd),
            tuple(jnp.asarray(r[b].numpy()) for r in r_bwd),
            connectivity=conn, **kw)
        np.testing.assert_array_equal(fg[b].numpy(), np.asarray(jfg))
        np.testing.assert_allclose(e[b].numpy(), np.asarray(je), atol=E_TOL)
        for got, want in zip(rf + rb, jrf + jrb):
            np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                       atol=E_TOL)


@pytest.mark.parametrize("name", list(MINCUT_CASES))
def test_counts_tally_as_before(name):
    """The plain version tallies the rounds, sweeps, relabel steps and
    syncs it tallied before the kernel was added."""
    ex, r_fwd, r_bwd, conn, kw = mincut_case(name)
    rounds, steps, syncs = COUNTS_BEFORE[name]
    tmf.counts.reset()
    tmf.grid_mincut_batch(ex, r_fwd, r_bwd, conn, **kw)
    n_sweeps = tmf._n_sweeps(kw["sweeps_per_round"], kw["unroll"])
    assert [r.tolist() for r in tmf.counts.rounds] == [rounds]
    assert [s.tolist() for s in tmf.counts.sweeps] == [
        [r * n_sweeps for r in rounds]]
    assert tmf.counts.relabel_steps == steps
    assert tmf.counts.syncs == syncs


def test_cpu_tensors_take_the_plain_version():
    """grid_mincut_batch on CPU tensors is the plain version, launches no
    kernel and leaves the caller's tensors unchanged."""
    ex, r_fwd, r_bwd, conn, kw = mincut_case("lock-step")
    keep = [t.clone() for t in (ex, *r_fwd)]
    before = tmf.grid_mincut_cuda.kernel_launches
    got = tmf.grid_mincut_batch(ex, r_fwd, r_bwd, conn, **kw)
    want = tmf.grid_mincut_plain(ex, r_fwd, r_bwd, conn, **kw)
    assert tmf.grid_mincut_cuda.kernel_launches == before
    for a, b in zip((got[0], got[1], *got[2], *got[3]),
                    (want[0], want[1], *want[2], *want[3])):
        assert torch.equal(a, b)
    for a, b in zip((ex, *r_fwd), keep):
        assert torch.equal(a, b)


def test_kernel_wrapper_checks_its_inputs():
    """grid_mincut_cuda raises on a dtype, shape, batch or contiguity it
    does not take before it looks at the device, and on CPU tensors."""
    ex, r_fwd, _, conn, _ = mincut_case("lock-step")
    rf = tuple(r.contiguous() for r in r_fwd)
    before = tmf.grid_mincut_cuda.kernel_launches
    with pytest.raises(TypeError, match="float32"):
        tmf.grid_mincut_cuda(ex.double(), rf, rf, conn)
    with pytest.raises(TypeError, match="float32"):
        tmf.grid_mincut_cuda(ex, (rf[0].half(),) + rf[1:], rf, conn)
    with pytest.raises(ValueError, match="does not match"):
        tmf.grid_mincut_cuda(ex, (rf[0][:, :, :-1].contiguous(),) + rf[1:],
                             rf, conn)
    with pytest.raises(ValueError, match="does not match"):     # B
        tmf.grid_mincut_cuda(ex, rf, (rf[0][:2].contiguous(),) + rf[1:],
                             conn)
    with pytest.raises(ValueError, match="does not match"):
        tmf.grid_mincut_cuda(ex[0], tuple(r[0] for r in rf),
                             tuple(r[0] for r in rf), conn)
    with pytest.raises(ValueError, match="contiguous"):
        tmf.grid_mincut_cuda(ex.transpose(1, 2).contiguous().transpose(1, 2),
                             rf, rf, conn)
    with pytest.raises(ValueError, match="residual planes"):
        tmf.grid_mincut_cuda(ex, rf[:2], rf, conn)
    with pytest.raises(ValueError, match="connectivity"):
        tmf.grid_mincut_cuda(ex, rf, rf, 6)
    with pytest.raises(ValueError, match="B > 0"):
        tmf.grid_mincut_cuda(ex[:0], tuple(r[:0] for r in rf),
                             tuple(r[:0] for r in rf), conn)
    with pytest.raises(ValueError, match="one CUDA device"):
        tmf.grid_mincut_cuda(ex, rf, rf, conn)
    assert tmf.grid_mincut_cuda.kernel_launches == before


class FakeEvent:
    """Stands in for a CUDA event: passed or not, and counts its waits."""

    def __init__(self, passed):
        self.passed, self.waits = passed, 0

    def query(self):
        return self.passed

    def synchronize(self):
        self.waits += 1
        self.passed = True


def test_kernel_solve_counts_are_read_when_read():
    """A kernel solve's tallies (relabel steps, barriers, image-steps,
    height copies, sweep tiles swept, relax tiles relaxed, then a
    GRID_MINCUT_STATS build's quiet tiles swept, relax tiles skipped and
    microseconds of sweeps and relabels, then each image's rounds, then
    each image's relax stamp) stay in its host ctrl buffer
    until its event has passed and a count is read; plain and kernel
    solves keep their order, and the grid stays beside the tallies."""
    tmf.counts.reset()
    ex, r_fwd, r_bwd, conn, kw = mincut_case("conn8")
    tmf.grid_mincut_batch(ex, r_fwd, r_bwd, conn, **kw)
    ctrl = torch.tensor([36, 400, 72, 1, 5, 6, 11, 4, 80, 20, 3, 0, 7, 9,
                         2, 9], dtype=torch.int32)
    done = FakeEvent(False)
    grid = dict(blocks=528, blocks_per_sm=4, registers=64)
    tmf.counts._record_kernel(ctrl, done, 8, grid)
    assert tmf.counts._calls[1][0] is None
    assert [r.tolist() for r in tmf.counts.rounds] == [[4], [3, 0, 7]]
    assert done.waits == 1
    assert [s.tolist() for s in tmf.counts.sweeps] == [[32], [24, 0, 56]]
    assert tmf.counts.relabel_steps == 70 + 36
    assert tmf.counts.syncs == 40
    (tally,) = tmf.counts.kernel_tallies
    assert tally["barriers"] == 400 and tally["relabel_image_steps"] == 72
    assert tally["image_copies"] == 1 and tally["swept_tiles"] == 5
    assert tally["relax_tiles"] == 6 and tally["quiet_tiles"] == 11
    assert tally["relax_skipped"] == 4
    assert tally["sweep_us"] == 80 and tally["relabel_us"] == 20
    assert tally["blocks"] == 528 and tally["registers"] == 64
    assert tally["rounds"].tolist() == [3, 0, 7]
    assert tmf.kernel_tally(ctrl)["barriers"] == 400


def test_kernel_tallies_are_read_as_their_solves_end():
    """Each kernel solve reads, without waiting, the tallies of earlier
    solves whose event has passed, so `counts` holds only the solves still
    running: over many solves, at most those that had not ended."""
    tmf.counts.reset()
    grid = dict(blocks=1, blocks_per_sm=1, registers=1)
    events = []
    for i in range(50):
        if events:
            events[-1].passed = True        # the previous solve has ended
        events.append(FakeEvent(False))
        ctrl = torch.tensor([i, 2 * i, i, 0, 0, 0, 0, 0, 0, 0, 1, 0],
                            dtype=torch.int32)
        tmf.counts._record_kernel(ctrl, events[-1], 4, grid)
        assert len(tmf.counts._pending) == 1
    assert sum(e.waits for e in events) == 0
    assert tmf.counts.relabel_steps == sum(range(50))
    assert sum(e.waits for e in events) == 1
    assert not tmf.counts._pending
    assert [t["barriers"] for t in tmf.counts.kernel_tallies] == [
        2 * i for i in range(50)]


def test_counts_record_nothing_until_reset(monkeypatch):
    """A process that never calls `counts.reset()` keeps no entry however
    many solves it makes (a long-lived server); after a reset the counts
    read as before."""
    fresh = tmf.SolverCounts()
    monkeypatch.setattr(tmf, "counts", fresh)
    ex, r_fwd, r_bwd, conn, kw = mincut_case("relabel-iters")
    for _ in range(50):
        tmf.grid_mincut_batch(ex, r_fwd, r_bwd, conn, **kw)
    assert not fresh.recording
    assert fresh._calls == [] and fresh._pending == []
    assert fresh.rounds == [] and fresh.relabel_steps == 0
    fresh.reset()
    tmf.grid_mincut_batch(ex, r_fwd, r_bwd, conn, **kw)
    rounds, steps, syncs = COUNTS_BEFORE["relabel-iters"]
    assert [r.tolist() for r in fresh.rounds] == [rounds]
    assert fresh.relabel_steps == steps and fresh.syncs == syncs


def test_kernel_solves_copy_tallies_only_when_recording(monkeypatch):
    """A kernel solve (mocked: planes on the meta device, the launch a
    stand-in) takes no pinned copy and no event while `counts` is not
    recording, and one of each once it is."""
    fresh = tmf.SolverCounts()
    monkeypatch.setattr(tmf, "counts", fresh)
    pinned, events = [], []
    real_empty = torch.empty

    def empty(*args, pin_memory=False, **kwargs):
        if pin_memory:
            pinned.append(args)
        return real_empty(*args, **kwargs)

    def event():
        events.append(FakeEvent(True))
        events[-1].record = lambda stream: None
        return events[-1]

    def launch(e, rf, rb, *args):
        ctrl = torch.zeros(tmf.CTRL_HEAD + 2 * e.shape[0], dtype=torch.int32)
        return (torch.zeros(e.shape, dtype=torch.bool, device=e.device),
                ctrl, dict(blocks=1))

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(tmf, "grid_mincut_cuda", launch)
    ex, r_fwd, r_bwd, conn, kw = mincut_case("lock-step")
    meta = (ex.to("meta"), tuple(r.to("meta") for r in r_fwd),
            tuple(r.to("meta") for r in r_bwd))
    for _ in range(50):
        tmf.grid_mincut_batch(*meta, conn, **kw)
    assert pinned == [] and events == []
    assert fresh._calls == [] and fresh._pending == []
    fresh.reset()
    tmf.grid_mincut_batch(*meta, conn, **kw)
    assert len(pinned) == 1 and len(events) == 1
    assert [r.tolist() for r in fresh.rounds] == [[0, 0, 0]]
