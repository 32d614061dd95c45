"""Spans and captures around the program's layer calls.

`Hooks.installed()` replaces, for the length of a `with` block, the names
through which the program calls its layers, with wrappers that open a
`torch.profiler.record_function` span named after the layer and count
what goes through:

    layer.build     gcn_grabcut_torch.pipeline.build_graph_batch_arrays
    layer.forward   GCNGrabCutPipeline._predict_probs_batch (the instance)
    layer.trimap    gcn_grabcut_torch.pipeline._trimap_stage_device
    layer.grabcut   gcn_grabcut_torch.pipeline.grabcut_batch_device
    layer.mincut    gcn_grabcut_torch.grabcut.grid_mincut_batch
    layer.cleanup   gcn_grabcut_torch.pipeline._post_stage_device
    layer.finalize  GCNGrabCutPipeline._finalize_batch (the instance)

The wrappers call the program unchanged.  While `counting` is set
(the traced window) they count images per layer, the valid nodes and
edges each forward saw (summed on the device, read after the window),
and the bytes each min-cut call's tensors hold.  `keep_batches` names
the batch indices whose node input and pre-clean-up masks are kept for
the correctness check.
"""

from __future__ import annotations

import collections
import contextlib

import torch
from torch.profiler import record_function

from .count.bytes import call_bytes


def _shapes(tensors) -> list:
    return [(tuple(t.shape), t.element_size()) for t in tensors]


class Hooks:
    def __init__(self, pipe, image_hw: int, spans: bool,
                 keep_batches: frozenset = frozenset()):
        self.pipe = pipe
        self.image_hw = image_hw
        self.spans = spans
        self.keep_batches = keep_batches
        self.counting = False                 # set over the traced window
        self.images = collections.Counter()   # span -> images entering
        self.mincut_bytes = 0
        self._nodes = self._edges = None      # device sums while counting
        self.kept_x: dict = {}                # batch -> (B, K, 19) tensor
        self.kept_cut: dict = {}              # batch -> (B, H, W) tensor
        self._builds = self._cuts = 0

    def _span(self, name):
        return record_function(name) if self.spans else \
            contextlib.nullcontext()

    # -- wrappers ---------------------------------------------------------
    def _build(self, fn):
        def build(rgbs, *a, **k):
            with self._span("layer.build"):
                out = fn(rgbs, *a, **k)
            if out["segments"].shape[-1] == self.image_hw:
                if self.counting:
                    self.images["layer.build"] += out["segments"].shape[0]
                if self._builds in self.keep_batches:
                    self.kept_x[self._builds] = out["x"].clone()
                self._builds += 1
            return out
        return build

    def _forward(self, fn):
        def forward(graph):
            with self._span("layer.forward"):
                probs = fn(graph)
            if self.counting:
                nodes = graph.node_mask.sum(dtype=torch.float64)
                edges = graph.edge_mask.sum(dtype=torch.float64)
                self._nodes = nodes if self._nodes is None \
                    else self._nodes + nodes
                self._edges = edges if self._edges is None \
                    else self._edges + edges
            return probs
        return forward

    def _plain(self, name, fn, count: bool = True):
        def call(*a, **k):
            with self._span(name):
                out = fn(*a, **k)
            if count and self.counting:
                self.images[name] += a[0].shape[0]
            return out
        return call

    def _grabcut(self, fn):
        def grabcut(rgbs, trimaps, *a, **k):
            with self._span("layer.grabcut"):
                masks = fn(rgbs, trimaps, *a, **k)
            if self.counting:
                self.images["layer.grabcut"] += rgbs.shape[0]
            if self._cuts in self.keep_batches:
                self.kept_cut[self._cuts] = masks.clone()
            self._cuts += 1
            return masks
        return grabcut

    def _mincut(self, fn):
        def mincut(excess, r_fwd, r_bwd, *a, **k):
            with self._span("layer.mincut"):
                out = fn(excess, r_fwd, r_bwd, *a, **k)
            if self.counting:
                fg, e, rf, rb = out
                self.mincut_bytes += call_bytes(
                    _shapes([excess, *r_fwd, *r_bwd]),
                    _shapes([fg, e, *rf, *rb]))
            return out
        return mincut

    # -- installation -----------------------------------------------------
    @contextlib.contextmanager
    def installed(self):
        from gcn_grabcut_torch import grabcut as G
        from gcn_grabcut_torch import pipeline as P
        saved = [(P, "build_graph_batch_arrays"),
                 (P, "_trimap_stage_device"), (P, "grabcut_batch_device"),
                 (P, "_post_stage_device"), (G, "grid_mincut_batch")]
        saved = [(m, n, getattr(m, n)) for m, n in saved]
        P.build_graph_batch_arrays = self._build(P.build_graph_batch_arrays)
        P._trimap_stage_device = self._plain("layer.trimap",
                                             P._trimap_stage_device, False)
        P.grabcut_batch_device = self._grabcut(P.grabcut_batch_device)
        P._post_stage_device = self._plain("layer.cleanup",
                                           P._post_stage_device)
        G.grid_mincut_batch = self._mincut(G.grid_mincut_batch)
        pipe = self.pipe
        pipe._predict_probs_batch = self._forward(pipe._predict_probs_batch)
        pipe._finalize_batch = self._plain("layer.finalize",
                                           pipe._finalize_batch, False)
        try:
            yield self
        finally:
            for m, n, f in saved:
                setattr(m, n, f)
            for n in ("_predict_probs_batch", "_finalize_batch"):
                pipe.__dict__.pop(n, None)

    def graph_sizes(self) -> tuple[int, int]:
        """(valid nodes, valid edges) the counted forwards saw (a host
        read, after the window)."""
        if self._nodes is None:
            return 0, 0
        return int(self._nodes.item()), int(self._edges.item())
