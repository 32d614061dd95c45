"""Serving CLI: a dependency-free HTTP segmentation server.

Counterpart of ``gcn_grabcut_tpu/cli/serve.py``: the same flags, protocol
and letterboxing.  Runs on the card unless --cpu; without CUDA and
without --cpu, `build_server` raises.

* **One canvas.** Every request is letterboxed to a fixed (size, size)
  canvas (cv2 INTER_AREA), so concurrent requests can share a batch; each
  mask is mapped back to its request's geometry (INTER_NEAREST).
* **Micro-batching.** Concurrent requests are coalesced (up to --batch,
  waiting at most --batch-wait-ms) into one `segment_batch` call per
  group of equal query options, on the batcher's own thread.
* **Warm start.** One `segment_batch` at startup (--no-warmup skips)
  creates the CUDA context and the library handles, and builds the
  kernels the configuration reaches (at 10 000 superpixels the banded
  SpMM).

The one departure from the JAX package: a group runs at its own size.
JAX pads every group to --batch by repeating its last image, so that one
compiled program serves every call; the port compiles nothing per shape,
and each padded image would add its pixels to every sweep of the group's
lock-step GrabCut.  An image's mask does not depend on the other images
in its batch (bit for bit), so clients see the same masks.

Protocol (JSON out; stdlib only on both sides):

  POST /segment     body: image file bytes (PNG/JPEG) or JSON
                    {"image_b64": ...}; optional query args threshold,
                    filter_radius, keep_largest.
                    -> {"mask_png_b64": ..., "fg_ratio": ..., "timing_ms": ...}
  GET  /healthz     -> {"ok": true, "pending": n, "served": n}

400 for an undecodable image, 404 for an unknown path, 500 with the error
when the batch failed, 504 when no result came within 600 s.

Usage:
  python -m gcn_grabcut_torch.cli.serve --checkpoint ckpt/best_model.msgpack \\
      --port 8021 --size 512 --batch 8
"""

from __future__ import annotations

import argparse
import base64
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

#: Seconds a request waits for its batch before answering 504.
REQUEST_TIMEOUT_S = 600


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="HTTP segmentation server (micro-batched)")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint path, or comma-separated paths to serve "
                        "the inference ensemble")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8021)
    p.add_argument("--size", type=int, default=512,
                   help="fixed canvas size every request is letterboxed to")
    p.add_argument("--n-segments", type=int, default=500)
    p.add_argument("--bg-connectivity", action="store_true",
                   help="geodesic boundary-connectivity bg prior cue "
                        "(match the checkpoint's training setting)")
    p.add_argument("--batch", type=int, default=8,
                   help="max requests coalesced into one segment_batch")
    p.add_argument("--batch-wait-ms", type=float, default=25.0,
                   help="how long the batcher waits for co-travellers")
    p.add_argument("--threshold", type=float, default=0.65)
    p.add_argument("--filter-radius", type=int, default=4)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def _letterbox(img: np.ndarray, size: int) -> tuple[np.ndarray, tuple]:
    """Resize the long edge to `size` and pad to (size, size).  Returns the
    canvas and (h, w, scaled_h, scaled_w) needed to undo it."""
    import cv2
    h, w = img.shape[:2]
    s = size / max(h, w)
    sh, sw = max(int(round(h * s)), 1), max(int(round(w * s)), 1)
    resized = cv2.resize(img, (sw, sh), interpolation=cv2.INTER_AREA)
    canvas = np.zeros((size, size, 3), np.uint8)
    canvas[:sh, :sw] = resized
    return canvas, (h, w, sh, sw)


def _unbox(mask: np.ndarray, geom: tuple) -> np.ndarray:
    import cv2
    h, w, sh, sw = geom
    return cv2.resize(mask[:sh, :sw], (w, h),
                      interpolation=cv2.INTER_NEAREST)


class _Request:
    __slots__ = ("image", "geom", "opts", "event", "result", "error")

    def __init__(self, image, geom, opts):
        self.image = image
        self.geom = geom
        self.opts = opts
        self.event = threading.Event()
        self.result = None
        self.error = None


class Batcher:
    """Coalesces concurrent requests into batches on one worker thread,
    the only thread that drives the pipeline.

    Requests with identical post-processing options share one
    `segment_batch` call; mixed options run as one call per option group.
    `close()` stops the thread once the queued requests are done.
    """

    def __init__(self, pipeline, size: int, max_batch: int, wait_ms: float,
                 defaults: dict):
        self.pipe = pipeline
        self.size = size
        self.max_batch = max_batch
        self.wait_s = wait_ms / 1000.0
        self.defaults = defaults
        self.q: "queue.Queue[_Request | None]" = queue.Queue()
        self.served = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray, opts: dict) -> _Request:
        canvas, geom = _letterbox(image, self.size)
        req = _Request(canvas, geom, opts)
        self.q.put(req)
        return req

    def close(self, timeout: float | None = None) -> None:
        self.q.put(None)
        self._thread.join(timeout)

    def _drain(self) -> list:
        """The next batch; a trailing None is the stop mark."""
        batch = [self.q.get()]
        deadline = time.monotonic() + self.wait_s
        while batch[-1] is not None and len(batch) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                batch.append(self.q.get(timeout=left))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while True:
            batch = self._drain()
            stop = batch[-1] is None
            by_opts: dict[tuple, list] = {}
            for r in batch[:-1] if stop else batch:
                by_opts.setdefault(tuple(sorted(r.opts.items())), []).append(r)
            for group in by_opts.values():
                self._run(group)
            if stop:
                return

    def _run(self, group: list) -> None:
        opts = dict(self.defaults)
        opts.update(group[0].opts)
        try:
            t0 = time.perf_counter()
            results = self.pipe.segment_batch(
                [r.image for r in group], threshold_fg=opts["threshold"],
                threshold_bg=opts["threshold"],
                keep_largest=opts["keep_largest"],
                filter_radius=opts["filter_radius"],
                want_segments=False)   # serving returns masks only
            dt = time.perf_counter() - t0
            for r, res in zip(group, results):
                r.result = (_unbox(res.binary_mask, r.geom), dt)
                self.served += 1
        except Exception as exc:   # surface the failure to every waiter
            for r in group:
                r.error = repr(exc)
        finally:
            for r in group:
                r.event.set()


def make_handler(batcher: Batcher):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # quiet access log
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path != "/healthz":
                return self._json(404, {"error": "unknown path"})
            self._json(200, {"ok": True, "pending": batcher.q.qsize(),
                             "served": batcher.served})

        def do_POST(self):
            import cv2
            parsed = urlparse(self.path)
            if parsed.path != "/segment":
                return self._json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "")
                if "json" in ctype:
                    raw = base64.b64decode(json.loads(raw)["image_b64"])
                buf = np.frombuffer(raw, np.uint8)
                bgr = cv2.imdecode(buf, cv2.IMREAD_COLOR)
                if bgr is None:
                    return self._json(400, {"error": "undecodable image"})
                rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)

                qs = parse_qs(parsed.query)
                opts = {}
                if "threshold" in qs:
                    opts["threshold"] = float(qs["threshold"][0])
                if "filter_radius" in qs:
                    opts["filter_radius"] = int(qs["filter_radius"][0])
                if "keep_largest" in qs:
                    opts["keep_largest"] = qs["keep_largest"][0] in (
                        "1", "true", "True")

                req = batcher.submit(rgb, opts)
                if not req.event.wait(timeout=REQUEST_TIMEOUT_S):
                    return self._json(504, {"error": "batch timeout"})
                if req.error is not None:
                    return self._json(500, {"error": req.error})
                mask, dt = req.result
                ok, png = cv2.imencode(".png", mask * 255)
                self._json(200, {
                    "mask_png_b64": base64.b64encode(png.tobytes()).decode(),
                    "fg_ratio": float(mask.mean()),
                    "timing_ms": round(dt * 1000.0, 1),
                })
            except Exception as exc:
                self._json(500, {"error": repr(exc)})

    return Handler


def _warm_image(size: int) -> np.ndarray:
    """The JAX package's first warm-up image: flat grey with a bright
    square.  Its GrabCut is ill-conditioned; the result is thrown away."""
    img = np.zeros((size, size, 3), np.uint8) + np.uint8(30)
    img[size // 4: size // 2, size // 4: size // 2] = 200
    return img


def build_server(args) -> tuple:
    """(server, batcher) -- split from main() so tests can drive it."""
    from ..core.device import resolve_device
    from ..graph_build import SuperpixelGraphConfig
    from ..pipeline import GCNGrabCutPipeline
    from ..train.checkpoints import load_model_auto

    device = resolve_device("cpu" if args.cpu else None)
    model, meta = load_model_auto(args.checkpoint, device=device)
    if meta.get("ensemble_size", 1) > 1:
        print(f"[Serve] ensemble of {meta['ensemble_size']} checkpoints")
    pipe = GCNGrabCutPipeline(
        model, SuperpixelGraphConfig(n_segments=args.n_segments,
                                     bg_connectivity=args.bg_connectivity),
        device=device)

    if not args.no_warmup:
        t0 = time.perf_counter()
        pipe.segment_batch([_warm_image(args.size)],
                           threshold_fg=args.threshold,
                           threshold_bg=args.threshold,
                           filter_radius=args.filter_radius)
        print(f"[Serve] warm-up done in {time.perf_counter() - t0:.1f}s")

    defaults = {"threshold": args.threshold,
                "filter_radius": args.filter_radius,
                "keep_largest": False}
    batcher = Batcher(pipe, args.size, args.batch, args.batch_wait_ms,
                      defaults)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(batcher))
    return server, batcher


def main(argv=None):
    args = parse_args(argv)
    server, batcher = build_server(args)
    print(f"[Serve] listening on http://{args.host}:"
          f"{server.server_address[1]}  (canvas {args.size}px, micro-batch "
          f"{args.batch}, wait {args.batch_wait_ms}ms, "
          f"{batcher.pipe.device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
