"""The "graph" mesh axis: an ordered ring of ranks, each with its device.

Counterpart of the one-axis ``Mesh(devices, ("graph",))`` of
``gcn_grabcut_tpu/parallel/mesh.py``: a large graph's nodes are block-
partitioned over the ranks, and the ring collectives of ``parallel/ring.py``
move node blocks between neighbours.

A `GraphMesh` also owns the collectives' signal words: one 64-bit word per
(rank, phase, thread block), written with the epoch of the call that wrote
it.  Both kernels are one shot and read a rank's two rows as their two
handshakes, each written by the rank itself: row 0 on entry, row 1 once
its copies (the all-gather) or reads (the reduce-scatter) are done.  So a
mesh has two rows for every n.  The epoch rises with every collective
call on the mesh, so no call resets the words and a word left by an
earlier call never satisfies a later wait.  The words are the mesh's, so
calls on one mesh must be ordered on one CUDA stream.

Every rank of a mesh lives on one device here: a ring of n logical ranks
on one card runs the same kernel code and signalling that peer pointers
over NVLink would use.  Meshes over several cards, the "data" axis and
multi-process launch come later (ROADMAP, queue 1, "Distribution: what
is left").
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.device import resolve_device

#: Signal words per (rank, phase): the most thread blocks a rank may run.
SIGNAL_BLOCKS = 1024


@dataclasses.dataclass(eq=False)
class GraphMesh:
    """An ordered ring of ranks; rank r's right neighbour is (r + 1) % n."""
    devices: tuple[torch.device, ...]
    signals: torch.Tensor = dataclasses.field(init=False, repr=False)
    epoch: int = dataclasses.field(default=0, init=False)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one rank")
        if len(set(self.devices)) > 1:
            raise NotImplementedError(
                "a mesh over several devices needs peer pointers between "
                "cards (ROADMAP, queue 1, 'Distribution: what is left'); "
                "every rank lives on one device for now")
        # (rank, phase, block).  Zero is below every epoch a call uses.
        self.signals = torch.zeros((self.size, 2, SIGNAL_BLOCKS),
                                   dtype=torch.int64, device=self.device)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def next_epoch(self) -> int:
        """The tag of the next collective call on this mesh."""
        self.epoch += 1
        return self.epoch


def make_graph_mesh(n_graph: int, device=None) -> GraphMesh:
    """A ring of `n_graph` ranks on one device (default: the current card;
    ``device="cpu"`` runs the collectives' plain versions)."""
    if n_graph < 1:
        raise ValueError(f"n_graph must be >= 1, got {n_graph}")
    dev = resolve_device(device)
    return GraphMesh(devices=(dev,) * n_graph)
