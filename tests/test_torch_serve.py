"""Port parity for serving: gcn_grabcut_torch.cli.serve against the JAX
package's cli.serve on the CPU, both at --size 96 --n-segments 40
--no-warmup, over HTTP with the same PNGs (one square, two not).  The
checkpoints are numpy-seeded ResGCNNets (D=24, 2 layers) written by the
port's save_checkpoint, which the JAX package reads; served alone and as
a two-path ensemble.

Plus the port's own checks: the JSON body, /healthz, 400, 404, a failed
batch answering 500 to every waiter, groups run at their own size (JAX
pads them to --batch; the port does not, and an image's mask does not
depend on its batch), close(), and build_server without --cpu raising
where there is no CUDA.
"""

import base64
import json
import threading
import types

import numpy as np
import pytest
import torch

from chip_smoke import http, png_bytes, serve_image, served_mask
from gcn_grabcut_tpu.cli import serve as jserve
from gcn_grabcut_torch.cli import serve as tserve
from gcn_grabcut_torch.models.convert import jax_variables_from_state_dict
from gcn_grabcut_torch.models.factory import build_model, init_model_numpy
from gcn_grabcut_torch.train.checkpoints import save_checkpoint

torch.set_num_threads(1)

SIZE = 96
SERVE_FLAGS = ["--port", "0", "--size", str(SIZE), "--n-segments", "40",
               "--batch", "2", "--batch-wait-ms", "200", "--no-warmup",
               "--cpu"]
SHAPES = ((96, 96), (72, 96), (96, 64))   # (h, w) of the request images
MIN_AGREE = 0.999     # share of equal pixels, port mask against JAX's
TIMEOUT_S = 600   # seconds a join or a close may take


@pytest.fixture(autouse=True)
def jax_cache(tmp_path, monkeypatch):
    """The JAX server's compilation cache goes to the test's own folder."""
    monkeypatch.setenv("GCNGC_CACHE_DIR", str(tmp_path / "jax_cache"))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Two numpy-seeded ResGCNNet checkpoints (D=24, 2 layers), seeds whose
    masks on the request images are neither empty nor full."""
    root = tmp_path_factory.mktemp("ck")
    paths = []
    for seed in (7, 1):
        model = init_model_numpy(build_model(hidden_channels=24,
                                             n_layers=2), seed)
        v = jax_variables_from_state_dict(model.state_dict())
        path = root / f"resgcn_s{seed}.msgpack"
        save_checkpoint(path, v["params"], v["batch_stats"], meta=dict(
            variant="resgcn", model_kwargs=dict(hidden_channels=24,
                                                n_layers=2)))
        paths.append(str(path))
    return paths


def request(port: int, path: str, body=None, ctype="image/png"):
    """(status, JSON payload) of one GET (body None) or POST."""
    return http(port, path, body, ctype)[:2]


def post_all(port: int, bodies: list) -> list:
    """POST every body at once, one client thread each."""
    out = [None] * len(bodies)

    def post(i):
        out[i] = request(port, "/segment", bodies[i])

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    return out


class Serving:
    """A server on a serve_forever thread; shut down and closed on exit."""

    def __init__(self, module, argv):
        self.server, self.batcher = module.build_server(
            module.parse_args(argv))
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        if hasattr(self.batcher, "close"):
            self.batcher.close(TIMEOUT_S)


@pytest.mark.parametrize("members", [1, 2], ids=["single", "ensemble"])
def test_served_masks_match_jax(checkpoints, members):
    images = [serve_image(h, w, 20 + i) for i, (h, w) in enumerate(SHAPES)]
    bodies = [png_bytes(im) for im in images]
    argv = ["--checkpoint", ",".join(checkpoints[:members])] + SERVE_FLAGS
    answers = {}
    for name, module in (("jax", jserve), ("port", tserve)):
        with Serving(module, argv) as s:
            answers[name] = post_all(s.port, bodies)
            assert s.batcher.served == len(bodies)
    exact = 0
    for img, (jc, jp), (tc, tp) in zip(images, answers["jax"],
                                       answers["port"]):
        assert jc == tc == 200
        jm, tm = served_mask(jp), served_mask(tp)
        assert tm.shape == jm.shape == img.shape[:2]
        assert set(np.unique(tm)) <= {0, 255}
        assert 0 < tp["fg_ratio"] < 1
        assert float((tm == jm).mean()) >= MIN_AGREE
        assert tp["fg_ratio"] == pytest.approx(float(tm.mean()) / 255)
        exact += bool((tm == jm).all())
    print(f"{exact} of {len(images)} served masks equal JAX's exactly")


def test_masks_do_not_depend_on_the_batch(checkpoints):
    """Each image's mask in a batch of three equals its mask alone, so an
    unpadded group serves what a padded one would."""
    server, batcher = tserve.build_server(tserve.parse_args(
        ["--checkpoint", checkpoints[0]] + SERVE_FLAGS))
    try:
        canvases = [tserve._letterbox(serve_image(h, w, 30 + i), SIZE)[0]
                    for i, (h, w) in enumerate(SHAPES)]
        together = batcher.pipe.segment_batch(canvases, want_segments=False)
        for canvas, res in zip(canvases, together):
            alone = batcher.pipe.segment_batch([canvas],
                                               want_segments=False)[0]
            np.testing.assert_array_equal(alone.binary_mask,
                                          res.binary_mask)
    finally:
        server.server_close()
        batcher.close(TIMEOUT_S)


def test_json_body_healthz_and_errors(checkpoints):
    img = serve_image(*SHAPES[1], 40)
    js = json.dumps({"image_b64": base64.b64encode(png_bytes(img)).decode()})
    with Serving(tserve, ["--checkpoint", checkpoints[0]]
                 + SERVE_FLAGS) as s:
        code, raw = request(s.port, "/segment", png_bytes(img))
        assert code == 200
        code, viajson = request(s.port, "/segment", js.encode(),
                                "application/json")
        assert code == 200
        np.testing.assert_array_equal(served_mask(viajson), served_mask(raw))
        assert served_mask(raw).shape == img.shape[:2]
        code, health = request(s.port, "/healthz")
        assert code == 200 and health == {"ok": True, "pending": 0,
                                          "served": 2}
        assert request(s.port, "/segment", b"not an image")[0] == 400
        assert request(s.port, "/nowhere")[0] == 404
        assert request(s.port, "/nowhere", png_bytes(img))[0] == 404
        assert s.batcher.served == 2


class StubPipeline:
    """Records each segment_batch call's length and options; masks are the
    canvas's first channel above 127, or it raises when `fail` is set."""

    def __init__(self, fail: bool = False):
        self.calls = []
        self.fail = fail

    def segment_batch(self, images, **kw):
        self.calls.append((len(images), kw["threshold_fg"]))
        if self.fail:
            raise RuntimeError("the batch failed")
        return [types.SimpleNamespace(
            binary_mask=(im[..., 0] > 127).astype(np.uint8))
            for im in images]


def stub_batcher(pipe, wait_ms=200.0):
    return tserve.Batcher(pipe, SIZE, 8, wait_ms, dict(
        threshold=0.65, filter_radius=4, keep_largest=False))


def test_failed_batch_answers_500_to_every_waiter():
    batcher = stub_batcher(StubPipeline(fail=True))
    server = tserve.ThreadingHTTPServer(("127.0.0.1", 0),
                                        tserve.make_handler(batcher))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        out = post_all(server.server_address[1],
                       [png_bytes(serve_image(64, 80, s)) for s in range(3)])
        assert [c for c, _ in out] == [500] * 3
        assert all("the batch failed" in p["error"] for _, p in out)
        assert batcher.served == 0
    finally:
        server.shutdown()
        server.server_close()
        batcher.close(TIMEOUT_S)


def test_groups_run_at_their_own_size():
    """Three coalesced requests in two option groups: two calls, of two
    images and one, not padded to --batch; close() ends the thread after
    the queued requests."""
    pipe = StubPipeline()
    batcher = stub_batcher(pipe, wait_ms=500.0)
    imgs = [serve_image(50 + 10 * s, 60, s) for s in range(3)]
    reqs = [batcher.submit(imgs[0], {}), batcher.submit(imgs[1], {}),
            batcher.submit(imgs[2], {"threshold": 0.6})]
    batcher.close(TIMEOUT_S)
    assert not batcher._thread.is_alive()
    assert all(r.event.is_set() and r.error is None for r in reqs)
    assert sorted(pipe.calls) == [(1, 0.6), (2, 0.65)]
    for img, r in zip(imgs, reqs):
        mask, _ = r.result
        canvas, geom = tserve._letterbox(img, SIZE)
        np.testing.assert_array_equal(
            mask, tserve._unbox((canvas[..., 0] > 127).astype(np.uint8),
                                geom))
    assert batcher.served == 3


@pytest.mark.parametrize("shape", [(96, 96), (72, 96), (96, 64), (7, 300)])
def test_letterbox_and_unbox_match_jax(shape):
    img = serve_image(*shape, 50)
    canvas, geom = tserve._letterbox(img, SIZE)
    jcanvas, jgeom = jserve._letterbox(img, SIZE)
    assert geom == jgeom
    np.testing.assert_array_equal(canvas, jcanvas)
    mask = (canvas[..., 1] > 100).astype(np.uint8)
    np.testing.assert_array_equal(tserve._unbox(mask, geom),
                                  jserve._unbox(mask, geom))


def test_parse_args_match_jax():
    argv = ["--checkpoint", "a.msgpack"]
    assert vars(tserve.parse_args(argv)) == vars(jserve.parse_args(argv))


def test_build_server_needs_cuda_without_cpu(checkpoints, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--checkpoint", checkpoints[0], "--port", "0", "--no-warmup"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.build_server(tserve.parse_args(argv))
