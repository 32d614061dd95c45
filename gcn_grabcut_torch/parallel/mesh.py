"""Device meshes: the "graph" axis, the ("data", "graph") mesh and
multi-process launch.

Counterpart of ``gcn_grabcut_tpu/parallel/mesh.py``:

* axis "graph": a large graph's nodes are block-partitioned over an
  ordered ring of ranks (a `GraphMesh`), and the ring collectives of
  ``parallel/ring.py`` move node blocks between neighbours;
* axis "data": the graphs of a training batch are split over the ranks,
  which hold the same parameters, and their gradients are summed over the
  axis (``parallel/data.py``, the trainer's ``mesh=``);
* `init_distributed` joins a ``torch.distributed`` process group, and a
  `Mesh` made under one spans the processes: each process holds its own
  rows of the data axis.

A `GraphMesh` also owns the collectives' signal words: one 64-bit word per
(rank, phase, thread block), written with the epoch of the call that wrote
it.  Both kernels are one shot and read a rank's two rows as their two
handshakes, each written by the rank itself: row 0 on entry, row 1 once
its copies (the all-gather) or reads (the reduce-scatter) are done.  So a
mesh has two rows for every n.  The epoch rises with every collective
call on the mesh, so no call resets the words and a word left by an
earlier call never satisfies a later wait.  The words are the mesh's, so
calls on one mesh must be ordered on one CUDA stream.

Every rank a process holds lives on one device: a ring of n logical ranks
on one card runs the same kernel code and signalling that peer pointers
over NVLink would use.  Ranks on several cards of one process need those
peer pointers, which are not built yet (ROADMAP, queue 1, item 4).
Processes on cards sum over NCCL, which has not run yet; over gloo on
the CPU they are tested.
"""

from __future__ import annotations

import dataclasses
import os
from typing import ClassVar, Optional

import torch

from ..core.device import resolve_device

#: Signal words per (rank, phase): the most thread blocks a rank may run.
SIGNAL_BLOCKS = 1024
_SEVERAL_CARDS = ("a mesh over several devices in one process needs peer "
                  "pointers between cards (ROADMAP, queue 1, item 4, "
                  "'meshes over several cards'); every rank of a process "
                  "lives on one device for now")


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
            raise NotImplementedError(_SEVERAL_CARDS)
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


# ------------------------------------------------------------ processes


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() else None


def process_count() -> int:
    """Processes in the job: the process group's size, else 1."""
    dist = _dist()
    return dist.get_world_size() if dist and dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist and dist.is_initialized() else 0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> bool:
    """Join a ``torch.distributed`` process group when the job runs more
    than one process; True when this call created the group (its owner
    then leaves it with ``destroy_process_group`` before the process
    exits).  Safe to call unconditionally: with no arguments and no
    cluster environment it is a no-op, and once the group exists it
    returns quietly.

    `coordinator_address` ("host:port" or a ``tcp://`` URL) is the group's
    init method, with `num_processes` the world size and `process_id` this
    process's rank.  With no address the group comes from torchrun's
    environment (``WORLD_SIZE`` > 1 with ``MASTER_ADDR``, ``RANK``,
    ``LOCAL_RANK``); `num_processes` alone also reads it.  The backend is
    NCCL for a card and gloo for ``device="cpu"``; `device` defaults to
    the card, and under torchrun a process takes card ``LOCAL_RANK``."""
    dist = _dist()
    if dist is None:
        raise RuntimeError("this torch has no torch.distributed")
    if dist.is_initialized():
        return False
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        kw = dict(init_method=url, world_size=int(num_processes),
                  rank=int(process_id))
    elif num_processes is not None or _in_cluster_env():
        kw = dict(init_method="env://",
                  world_size=int(num_processes
                                 or os.environ["WORLD_SIZE"]),
                  rank=int(os.environ["RANK"] if process_id is None
                           else process_id))
    else:
        return False
    if device is None and "LOCAL_RANK" in os.environ \
            and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dev = resolve_device(device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)
    return True


def _in_cluster_env() -> bool:
    """torchrun's environment for more than one process."""
    return (int(os.environ.get("WORLD_SIZE", "1")) > 1
            and "MASTER_ADDR" in os.environ)


# ----------------------------------------------------------- the 2-D mesh


@dataclasses.dataclass(eq=False)
class Mesh:
    """A ("data", "graph") mesh: `devices[i][j]` is the device of this
    process's data row i (global row `data_offset + i`) and graph column
    j, out of `n_data` rows in the job.  One process holds all of them;
    under a process group of P processes each holds n_data / P rows."""
    devices: tuple[tuple[torch.device, ...], ...]
    n_data: int
    data_offset: int = 0
    axis_names: ClassVar[tuple[str, str]] = ("data", "graph")
    _rings: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)

    def __post_init__(self):
        if len({d for row in self.devices for d in row}) > 1:
            raise NotImplementedError(_SEVERAL_CARDS)

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "graph": len(self.devices[0])}

    @property
    def local_data(self) -> int:
        """The data rows this process holds."""
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0][0]

    def graph_mesh(self, i: int = 0) -> GraphMesh:
        """The "graph" ring of this process's data row i."""
        return self._ring(("graph", i),
                          lambda: tuple(self.devices[i]))

    def data_mesh(self, j: int = 0) -> GraphMesh:
        """The "data" ring of graph column j over this process's rows."""
        return self._ring(("data", j),
                          lambda: tuple(row[j] for row in self.devices))

    def _ring(self, key, devices) -> GraphMesh:
        if key not in self._rings:
            self._rings[key] = GraphMesh(devices=devices())
        return self._rings[key]


def make_mesh(n_data: Optional[int] = None, n_graph: int = 1,
              devices=None) -> Mesh:
    """A (data, graph) mesh over `devices`: by default the visible cards
    (this process's card under a process group).  A device may repeat:
    ``devices=[dev] * n`` gives n logical ranks on one device.  Under a
    process group of P processes the job holds P x len(devices) ranks and
    each process n_data / P data rows.  `n_data` defaults to every rank
    over `n_graph`."""
    if devices is None:
        # resolve_device raises without a card.
        if process_count() > 1 or torch.cuda.device_count() < 1:
            devices = [resolve_device(None)]
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    procs = process_count()
    n = procs * len(devices)
    if n_graph < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"n_data={n_data} and n_graph={n_graph} must be "
                         ">= 1")
    if n_data is None:
        n_data = n // n_graph
    if n_data < 1 or n_data * n_graph > n:
        raise ValueError(f"a {n_data} x {n_graph} mesh needs more than the "
                         f"{n} device(s) visible")
    if n_data % procs:
        raise ValueError(f"n_data={n_data} does not split over {procs} "
                         "processes")
    rows = n_data // procs
    grid = tuple(tuple(devices[i * n_graph:(i + 1) * n_graph])
                 for i in range(rows))
    return Mesh(devices=grid, n_data=n_data,
                data_offset=process_index() * rows)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor's leading axis goes on a mesh: split in order over
    "data" (``spec=("data",)``), or whole on every rank (``spec=()``)."""
    mesh: Mesh
    spec: tuple = ()

    def place(self, t: torch.Tensor) -> list[torch.Tensor]:
        """This process's pieces of `t`, one per data row it holds."""
        m = self.mesh
        t = t.to(m.device)
        if not self.spec:
            return [t] * m.local_data
        if t.shape[0] % m.n_data:
            raise ValueError(f"a leading axis of {t.shape[0]} does not "
                             f"split over {m.n_data} data ranks")
        k = t.shape[0] // m.n_data
        return [t[(m.data_offset + i) * k:(m.data_offset + i + 1) * k]
                for i in range(m.local_data)]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading (graph-batch) axis over the data axis."""
    return Sharding(mesh, ("data",))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_graph_batch(batch, mesh: Mesh) -> list:
    """This process's GraphBatches of `batch`, its G axis split in order
    over the data axis: data rank r holds graphs [r G/n, (r + 1) G/n).
    Raises ValueError when G is not a multiple of n."""
    sh = batch_sharding(mesh)
    return [batch.map(lambda a, i=i: sh.place(a)[i])
            for i in range(mesh.local_data)]


def replicate(tree, mesh: Mesh):
    """The tensors of `tree` (a tensor, or dicts, lists and tuples of
    them) on the mesh's device.  A process's ranks share one device, so
    they share these tensors: nothing is copied per rank (a model's
    parameters stay the one set every rank reads)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree
