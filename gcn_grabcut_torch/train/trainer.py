"""Training engine: one optimisation step over a dense graph batch, the
JAX package's optax chain written out, SGDR / one-cycle / plateau
schedules, model selection and early stopping on validation IoU.

Counterpart of ``gcn_grabcut_tpu/train/trainer.py``.  The step is eager
PyTorch on the trainer's device (the card unless ``device="cpu"``):

* the optimiser (`ChainOptimizer`) applies optax's chain in its order --
  clip by global norm, Adam (or decay then SGD-nesterov), decoupled
  weight decay, the layer-wise group scale, the learning-rate schedule,
  the plateau ``lr_scale`` -- with optax's formulas in float32, and saves
  its state as optax's ``to_state_dict`` tree, so the JAX package resumes
  from a port checkpoint and the port from a JAX one;
* the schedules are evaluated on the host at the optimiser's own update
  count, rounding as JAX's float32 graph does on the CPU (its cosine is
  the C library's ``cosf``);
* graphs are bucketed to one (N, E) budget and the last partial batch
  wraps with zero graph weights, so every step has one shape;
* the batch order is ``np.random.RandomState(seed)``'s, JAX's; dropout and
  prior dropout draw from a ``torch.Generator`` seeded ``seed + 1`` (JAX
  draws from ``jax.random``: the mechanism is the same, the bits are not);
* ``bf16=True`` runs the model in its bfloat16 compute dtype
  (``models/layers.py``), with float32 parameters, statistics and loss;
* ``mesh=`` trains data-parallel over the mesh's "data" axis, computing
  the single-device step's function: each global batch is split in order
  over the data ranks; the sums the objective takes over the whole batch
  are summed over the ranks first (they depend on the data only); each
  rank draws its slice of the whole batch's dropout masks and runs its
  forward on a replica of the model whose parameters are its own leaves
  over the model's storage; the forwards run in lock step and meet at
  every InputNorm, which normalises with the whole batch's statistics
  (a synchronised batch norm, as XLA's psums make it in the JAX
  package); one backward of the ranks' losses, each its share of the
  whole batch's loss, gives each rank's leaves its gradient, cross-rank
  terms included; the ranks' gradients are summed over the data axis (K3
  then K2 on the card, ``parallel/data.py``), and one optimiser step
  follows.
"""

from __future__ import annotations

import copy
import ctypes
import ctypes.util
import dataclasses
import functools
import json
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.graph import (CLASS_BG, CLASS_FG, CLASS_UNK, N_PRIOR_FEATS,
                          GraphBatch, pad_graph, stack_graphs)
from ..models.convert import (jax_variables_from_state_dict,
                              named_from_params_tree, params_tree,
                              state_dict_from_jax)
from ..models.factory import build_model, init_model
from ..models.layers import InputNorm, uniform
from ..models.resgcn import resgcn_group_scales, resgcn_lr_label
from ..parallel.data import (BatchDraws, LockStep, sum_gradients,
                             sum_over_data)
from ..parallel.mesh import (batch_sharding, process_count, process_index,
                             shard_graph_batch)
from . import checkpoints as ckpt_io
from .losses import batch_totals, make_loss_fn


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's TrainConfig: the same fields and defaults."""
    n_epochs: int = 60
    lr: float = 1e-3
    weight_decay: float = 1e-4
    optimizer: str = "adamw"            # adamw | sgd
    scheduler: str = "cosine_warm"      # cosine_warm | onecycle | plateau | none
    loss_fn: str = "trimap"             # trimap | focal | smooth_ce | ce
    focal_gamma: float = 2.0
    dice_weight: float = 0.5
    label_smoothing: float = 0.1
    class_weights: tuple = (1.5, 0.8, 1.5)
    batch_size: int = 8
    bf16: bool = True                   # bfloat16 compute dtype
    grad_clip: float = 1.0
    early_stop_patience: int = 15
    t0: int = 10
    t_mult: int = 2
    val_every: int = 1
    save_every: int = 5
    verbose: bool = True
    seed: int = 0
    log_dir: Optional[str] = None     # TensorBoard scalars when set
    # Per-graph probability of zeroing the 3 prior input channels during
    # training (0 = off).
    prior_dropout: float = 0.0


def _f32(x) -> np.float32:
    return np.float32(x)


@functools.cache
def _cosf():
    """The C library's float32 ``cosf``, the function XLA's CPU backend
    calls for a float32 cosine (it differs from the correctly rounded
    value by an ulp at some arguments)."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.restype = ctypes.c_float
    libm.cosf.argtypes = [ctypes.c_float]
    return libm.cosf


def _cos32(x) -> np.float32:
    return np.float32(_cosf()(float(np.float32(x))))


def sgdr_schedule(base_lr: float, t0: int, t_mult: int,
                  steps_per_epoch: int) -> Callable[[int], float]:
    """Cosine annealing with warm restarts, stepped per epoch (JAX
    ``trainer.py:110-131``), as float32."""
    boundaries, period, start = [], t0, 0
    while start < 1_000_000:
        boundaries.append((start, period))
        start += period
        period = min(period * max(t_mult, 1), 2_000_000)
    half = _f32(0.5 * base_lr)

    def schedule(step: int) -> float:
        epoch = int(step) // max(steps_per_epoch, 1)
        for s, p in boundaries:
            if s <= epoch < s + p:
                frac = min(max(_f32(epoch - s) / _f32(p), _f32(0)), _f32(1))
                return float(half * (_f32(1) + _cos32(_f32(np.pi) * frac)))
        return float(_f32(base_lr))
    return schedule


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.1, div_factor: float = 25.0,
                             final_div_factor: float = 1e4
                             ) -> Callable[[int], float]:
    """optax's ``cosine_onecycle_schedule`` (its piecewise cosine
    interpolation and its div factors), as float32."""
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    # The boundary values and half-spans are float64 numpy in optax,
    # rounded to float32 where they meet the float32 step.
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])
    half_spans = [_f32(0.5 * (values[i + 1] - values[i])) for i in range(2)]
    values = [_f32(v) for v in values]

    def schedule(step: int) -> float:
        count = int(step)
        out = _f32(0)
        for i in range(2):
            size = bounds[i + 1] - bounds[i]
            with np.errstate(divide="ignore", invalid="ignore"):
                pct = _f32(count - bounds[i]) / _f32(size)
            interp = values[i + 1] - half_spans[i] * (
                _f32(1) + _cos32(_f32(np.pi) * pct))
            inside = bounds[i] <= count < bounds[i + 1]
            out = out + (interp if inside else _f32(0) * interp)
        if count >= bounds[-1]:
            out = out + values[-1]
        return float(out)
    return schedule


class ChainOptimizer:
    """optax's chain of the JAX ``make_optimizer`` over a module's
    parameters, in float32:

        clip_by_global_norm(grad_clip)
        scale_by_adam() + add_decayed_weights(wd)      (adamw)
          or add_decayed_weights(wd) + trace(0.9, nesterov)   (sgd)
        scale by the parameter's layer-wise group      (ResGCNNet only)
        scale by -schedule(count)
        then, as TrainState.apply_gradients, by the plateau lr_scale.

    `state_tree()` / `load_state_tree()` read and write optax's
    ``to_state_dict`` tree of that chain."""

    B1, B2, EPS, MOMENTUM = 0.9, 0.999, 1e-8, 0.9

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig,
                 schedule, n_layers: int, variant: str = "resgcn"):
        self.cfg = cfg
        self.n_layers = n_layers
        self.variant = variant
        self.params = dict(model.named_parameters())
        self.scales = None
        if variant == "resgcn":
            scales = resgcn_group_scales(n_layers)
            self.scales = {n: scales[resgcn_lr_label(n, n_layers)]
                           for n in self.params}
        self.schedule = schedule
        self.count = 0
        zeros = {n: torch.zeros_like(p) for n, p in self.params.items()}
        if cfg.optimizer == "sgd":
            self.trace = zeros
        else:
            self.mu = zeros
            self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

    def lr(self) -> float:
        """The learning rate of the next update."""
        s = self.schedule
        return float(s(self.count)) if callable(s) else float(s)

    @torch.no_grad()
    def step(self, grads: dict, lr_scale: float = 1.0) -> None:
        """One update; every constant is a float32 value (JAX's weak-typed
        Python scalars become float32), passed to torch as a Python float
        so that torch applies it in float32."""
        cfg = self.cfg

        def f32(x) -> float:
            return float(np.float32(x))

        g_norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        keep = g_norm < cfg.grad_clip        # selected on the device
        grads = {n: torch.where(keep, g, (g / g_norm) * f32(cfg.grad_clip))
                 for n, g in grads.items()}
        wd, lr, m = f32(cfg.weight_decay), f32(-self.lr()), f32(self.MOMENTUM)
        if cfg.optimizer != "sgd":
            count = np.float32(self.count + 1)
            bc1 = f32(np.float32(1) - np.float32(self.B1) ** count)
            bc2 = f32(np.float32(1) - np.float32(self.B2) ** count)
            b1, b2 = f32(self.B1), f32(self.B2)
            c1, c2 = f32(1 - self.B1), f32(1 - self.B2)
        for n, p in self.params.items():
            g = grads[n]
            if cfg.optimizer == "sgd":
                u = g + wd * p
                self.trace[n] = u + m * self.trace[n]
                u = u + m * self.trace[n]
            else:
                self.mu[n] = c1 * g + b1 * self.mu[n]
                self.nu[n] = c2 * (g * g) + b2 * self.nu[n]
                u = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2)
                                          + f32(self.EPS))
                u = u + wd * p
            if self.scales is not None:
                u = u * f32(self.scales[n])
            u = u * lr
            u = u * f32(lr_scale)
            p.add_(u)
        self.count += 1

    # -- optax's to_state_dict tree ------------------------------------

    def _sched_key(self) -> str:
        """The schedule's index in the chain: after the group scale, which
        only ResGCNNet's chain has."""
        return "4" if self.scales is not None else "3"

    def state_tree(self) -> dict:
        count = np.asarray(self.count, np.int32)
        sched = {"count": count} if callable(self.schedule) else {}

        def tree(named):
            return params_tree(named, self.n_layers, self.variant)
        if self.cfg.optimizer == "sgd":
            out = {"0": {}, "1": {}, "2": {"trace": tree(self.trace)}}
        else:
            out = {"0": {}, "1": {"count": count, "mu": tree(self.mu),
                                  "nu": tree(self.nu)}, "2": {}}
        if self.scales is not None:
            out["3"] = {}
        out[self._sched_key()] = sched
        return out

    def load_state_tree(self, tree: dict) -> None:
        dev = next(iter(self.params.values())).device

        def named(sub):
            return {n: t.to(dev) for n, t in
                    named_from_params_tree(sub).items()}
        if self.cfg.optimizer == "sgd":
            self.trace = named(tree["2"]["trace"])
            self.count = int(tree[self._sched_key()].get("count", 0))
        else:
            self.mu = named(tree["1"]["mu"])
            self.nu = named(tree["1"]["nu"])
            self.count = int(tree["1"]["count"])


def make_optimizer(cfg: TrainConfig, model: torch.nn.Module, variant: str,
                   n_layers: int, steps_per_epoch: int):
    """(ChainOptimizer, schedule fn): JAX ``make_optimizer``.  Only
    ResGCNNet's chain scales its updates by layer-wise groups."""
    if variant not in ("resgcn", "gcn", "gat"):
        raise ValueError(f"Unknown variant '{variant}'. Choose: "
                         "resgcn|gcn|gat")
    if cfg.scheduler == "cosine_warm":
        schedule = sgdr_schedule(cfg.lr, cfg.t0, cfg.t_mult, steps_per_epoch)
    elif cfg.scheduler == "onecycle":
        schedule = cosine_onecycle_schedule(
            transition_steps=max(cfg.n_epochs * steps_per_epoch, 1),
            peak_value=cfg.lr, pct_start=0.1)
    else:  # plateau (host-controlled lr_scale) or none
        schedule = cfg.lr
    schedule_fn = schedule if callable(schedule) else (lambda step: schedule)
    return ChainOptimizer(model, cfg, schedule, n_layers, variant), \
        schedule_fn


def per_class_counts(preds: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor, n_classes: int = 3) -> torch.Tensor:
    """(n_classes, 3) [tp, fp, fn] counts over valid nodes, to be summed
    across batches into one global per-class IoU."""
    valid = mask > 0
    counts = []
    for c in range(n_classes):
        p = (preds == c) & valid
        g = (labels == c) & valid
        counts.append(torch.stack([(p & g).sum(), (p & ~g).sum(),
                                   (~p & g).sum()]))
    return torch.stack(counts).float()


def per_class_iou(preds: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, n_classes: int = 3) -> torch.Tensor:
    """(n_classes,) IoU over valid nodes."""
    c = per_class_counts(preds, labels, mask, n_classes)
    return c[:, 0] / (c[:, 0] + c[:, 1] + c[:, 2] + 1e-8)


class Trainer:
    """Training engine over prepared GraphBatches.

    model_variant : "resgcn" | "gcn" | "gat"
    model_kwargs  : forwarded to build_model
    config        : TrainConfig
    save_dir      : checkpoint directory
    device        : where the model and batches live; default the card
                    (the mesh's device when a mesh is given)
    mesh          : optional ``parallel.mesh.Mesh`` with a "data" axis --
                    data-parallel training: each batch's graph axis is
                    split over "data", the ranks share the parameters,
                    and the batch size is rounded to a multiple of the
                    axis size.  Under a process group one process writes
                    the checkpoints and history while the others wait.
    """

    def __init__(self, model_variant: str = "resgcn",
                 model_kwargs: Optional[dict] = None,
                 config: Optional[TrainConfig] = None,
                 save_dir: str | Path = "checkpoints", device=None,
                 mesh=None):
        self.cfg = config or TrainConfig()
        self.mesh = mesh
        self._n_data = int(mesh.shape["data"]) if mesh is not None else 1
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.variant = model_variant
        self.model_kwargs = dict(model_kwargs or {})
        if self.cfg.bf16:
            self.model_kwargs.setdefault("dtype", torch.bfloat16)
        self.model = build_model(model_variant, **self.model_kwargs).to(
            self.device)
        self.n_layers = self.model_kwargs.get("n_layers", 6)
        self._replicas: list[tuple] = []    # (model, parameters, buffers)
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)

        self.loss_fn = make_loss_fn(
            self.cfg.loss_fn, gamma=self.cfg.focal_gamma,
            dice_weight=self.cfg.dice_weight,
            label_smoothing=self.cfg.label_smoothing,
            class_weights=list(self.cfg.class_weights))

        self.history = {
            "train_loss": [], "val_loss": [], "val_acc": [],
            "val_iou_bg": [], "val_iou_unk": [], "val_iou_fg": [],
            "val_score": [], "lr": [],
        }
        self._best_score = -float("inf")
        self._patience = 0
        self._lr_scale = 1.0           # plateau scheduler state
        self._plateau_wait = 0
        self._plateau_best = float("inf")
        self._schedule = None
        self.optimizer: Optional[ChainOptimizer] = None
        self.generator: Optional[torch.Generator] = None
        # Steps since _init_state (JAX's TrainState.step): a resume
        # restores the optimiser's count but not this, as in JAX, and the
        # history's lr is the schedule at this step.
        self.step = 0

        self._tb = None
        if self.cfg.log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(self.cfg.log_dir)
            except ImportError:
                print("[Trainer] tensorboard unavailable; skipping TB "
                      "logging.")

    # ------------------------------------------------------------------

    def _bucket(self, graphs: Sequence[GraphBatch]) -> GraphBatch:
        """Pad all graphs to a common (N, E) budget and stack them on the
        trainer's device."""
        n_max = max(g.max_nodes for g in graphs)
        e_max = max(g.max_edges for g in graphs)
        return stack_graphs([pad_graph(g.to(self.device), n_max, e_max)
                             for g in graphs])

    def _init_state(self, steps_per_epoch: int) -> None:
        """Seeded weights (the JAX package's initialisers, seed
        cfg.seed), a fresh optimiser, and the dropout generator."""
        init_model(self.model, self.cfg.seed)
        self.optimizer, self._schedule = make_optimizer(
            self.cfg, self.model, self.variant, self.n_layers,
            steps_per_epoch)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed + 1)
        self.step = 0

    def train_step(self, batch, graph_weight, lr_scale: float = 1.0
                   ) -> torch.Tensor:
        """One optimisation step; returns the batch loss (a 0-d tensor).
        With a mesh, `batch` and `graph_weight` may be a global batch or
        `_batches`' per-rank lists."""
        loss, grads = self.loss_and_grads(batch, graph_weight)
        self.optimizer.step(grads, lr_scale)
        self.step += 1
        return loss

    def _prior_dropout(self, batch: GraphBatch, generator) -> GraphBatch:
        """Zero each graph's prior channels with probability
        cfg.prior_dropout."""
        p_drop = float(self.cfg.prior_dropout)
        if p_drop <= 0:
            return batch
        keep = (uniform((batch.n_graphs, 1, 1), generator, batch.device)
                < 1.0 - p_drop).to(batch.x.dtype)
        return dataclasses.replace(batch, x=torch.cat(
            [batch.x[..., :-N_PRIOR_FEATS],
             batch.x[..., -N_PRIOR_FEATS:] * keep], dim=-1))

    def loss_and_grads(self, batch, graph_weight
                       ) -> tuple[torch.Tensor, dict]:
        """The training forward (batch statistics updated, dropout and
        prior dropout drawn) and the loss's gradient for every parameter.
        With a mesh: the whole batch's loss and the gradients summed over
        the data axis."""
        if self.mesh is not None:
            return self._loss_and_grads_sharded(
                *self._shard(batch, graph_weight))
        batch = self._prior_dropout(batch, self.generator)
        self.model.train()
        logits = self.model(batch, generator=self.generator)
        loss = self.loss_fn(logits, batch.y, batch.node_mask,
                            area=batch.node_area, fg_ratio=batch.fg_ratio,
                            graph_weight=graph_weight)
        params = self.optimizer.params
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def _shard(self, batch, graph_weight) -> tuple[list, list]:
        """This process's per-rank (batches, weights) of a global batch;
        lists pass through."""
        if isinstance(batch, GraphBatch):
            return (shard_graph_batch(batch, self.mesh),
                    batch_sharding(self.mesh).place(graph_weight))
        return list(batch), list(graph_weight)

    def _rank_replicas(self, n: int) -> list[torch.nn.Module]:
        """n training-mode copies of the model for the local ranks: each
        parameter a leaf of its own over the model's storage (so a rank's
        gradient is its leaf's, and the optimiser's in-place update
        reaches every copy), each buffer a copy of the model's."""
        while len(self._replicas) < n:
            rep = copy.deepcopy(self.model).train()
            self._replicas.append((rep, list(rep.parameters()),
                                   list(rep.buffers())))
        params, buffers = (list(self.model.parameters()),
                           list(self.model.buffers()))
        with torch.no_grad():
            for _, rps, rbs in self._replicas[:n]:
                for rp, mp in zip(rps, params):
                    rp.data = mp.data
                for rb, mb in zip(rbs, buffers):
                    rb.copy_(mb)
        return [rep for rep, _, _ in self._replicas[:n]]

    def _loss_and_grads_sharded(self, shards: list, weights: list
                                ) -> tuple[torch.Tensor, dict]:
        """The data-parallel step of `loss_and_grads` over this process's
        ranks: (a) the objective's batch-wide sums, (b) each rank's slice
        of the whole batch's draws, (c) the ranks' forwards in lock step,
        every InputNorm's statistics summed over the data axis, and one
        backward of their losses, (d) the gradients summed over the data
        axis, (f) the running statistics, updated alike in every replica,
        back into the model.  The optimiser's step (e) follows in
        `train_step`."""
        # (a) and (b): every draw is a slice of the whole batch's.
        draws = BatchDraws(self.generator, self._n_data)
        gens = [draws.rank(self.mesh.data_offset + i)
                for i in range(len(shards))]
        shards = [self._prior_dropout(b, g) for b, g in zip(shards, gens)]
        totals = sum_over_data(batch_totals(b.node_mask, b.node_area, w)
                               for b, w in zip(shards, weights))
        # (c)
        reps = self._rank_replicas(len(shards))
        step = LockStep(len(shards))
        for r, rep in enumerate(reps):
            for m in rep.modules():
                if isinstance(m, InputNorm):
                    m.total = functools.partial(step.total, r)

        def forward(r):
            b = shards[r]
            return self.loss_fn(reps[r](b, generator=gens[r]), b.y,
                                b.node_mask, area=b.node_area,
                                fg_ratio=b.fg_ratio, graph_weight=weights[r],
                                totals=totals)
        try:
            losses = step.run(forward)
        finally:
            for rep in reps:
                for m in rep.modules():
                    if isinstance(m, InputNorm):
                        m.total = None
        leaves = [list(rep.parameters()) for rep in reps]
        flat = torch.autograd.grad(sum(losses), sum(leaves, []))
        n_p = len(leaves[0])
        per_rank = [flat[i * n_p:(i + 1) * n_p] for i in range(len(reps))]
        # (d) and (f).
        grads = sum_gradients(per_rank, self.mesh.data_mesh(0))
        with torch.no_grad():
            for mb, rb in zip(self.model.buffers(), reps[0].buffers()):
                mb.copy_(rb)
        return (sum_over_data(loss.detach() for loss in losses),
                dict(zip(self.optimizer.params, grads)))

    @torch.no_grad()
    def eval_step(self, batch, graph_weight):
        """(loss, accuracy, (3, 3) tp/fp/fn counts, weighted node count);
        with a mesh, over the whole batch (counts summed over ranks)."""
        if self.mesh is None:
            loss, correct, counts, nodes = self._eval_parts(batch,
                                                            graph_weight)
        else:
            shards, weights = self._shard(batch, graph_weight)
            totals = sum_over_data(batch_totals(b.node_mask, b.node_area, w)
                                   for b, w in zip(shards, weights))
            parts = []
            for b, w in zip(shards, weights):
                loss, correct, counts, nodes = self._eval_parts(b, w, totals)
                parts.append(torch.cat([loss[None], correct[None],
                                        nodes[None], counts.reshape(-1)]))
            tot = sum_over_data(parts)
            loss, correct, nodes, counts = (tot[0], tot[1], tot[2],
                                            tot[3:].view(3, 3))
        return loss, correct / nodes.clamp_min(1.0), counts, nodes

    def _eval_parts(self, batch: GraphBatch, graph_weight: torch.Tensor,
                    totals=None):
        self.model.eval()
        logits = self.model(batch)
        loss = self.loss_fn(logits, batch.y, batch.node_mask,
                            area=batch.node_area, fg_ratio=batch.fg_ratio,
                            graph_weight=graph_weight, totals=totals)
        preds = logits.argmax(dim=-1)
        mask = batch.node_mask * graph_weight[:, None]
        correct = ((preds == batch.y) * mask).sum()
        counts = per_class_counts(preds, batch.y, mask)
        return loss, correct, counts, mask.sum()

    def _batch_size(self, n: int) -> int:
        """Static per-step graph count: capped by the dataset, rounded to a
        multiple of the mesh's data axis so every shard is non-empty."""
        bs = min(max(1, self.cfg.batch_size), max(n, 1))
        if self._n_data > 1:
            bs = max(self._n_data, (bs // self._n_data) * self._n_data)
        return bs

    def _batches(self, data: GraphBatch, rng: np.random.RandomState,
                 shuffle: bool):
        """Yield (batch, graph_weight) with a static batch size; the last
        batch wraps with zero-weight duplicates.  With a mesh, each is
        this process's list of per-rank pieces."""
        n = data.n_graphs
        bs = self._batch_size(n)
        order = rng.permutation(n) if shuffle else np.arange(n)
        for i in range(0, n, bs):
            idx = order[i:i + bs]
            w = np.ones(bs, np.float32)
            if len(idx) < bs:
                w[len(idx):] = 0.0
                idx = np.concatenate([idx, np.resize(order, bs - len(idx))])
            sel = torch.as_tensor(idx, device=self.device)
            batch = data.map(lambda a: a.index_select(0, sel))
            w = torch.as_tensor(w, device=self.device)
            if self.mesh is not None:
                yield self._shard(batch, w)
            else:
                yield batch, w

    # ------------------------------------------------------------------

    def fit(self, train_graphs: Sequence[GraphBatch],
            val_graphs: Optional[Sequence[GraphBatch]] = None,
            resume_from: Optional[str] = None) -> dict:
        """Train; `resume_from` restores a checkpoint (model + optimiser,
        the port's or the JAX package's) and continues from its epoch."""
        cfg = self.cfg
        if not train_graphs:
            raise RuntimeError(
                "no training graphs were prepared — check the image and "
                "mask directories, and the preparation warnings above")
        if val_graphs is not None and len(val_graphs) == 0:
            raise RuntimeError(
                "no validation graphs were prepared; model selection would "
                "have nothing to rank")

        train_data = self._bucket(list(train_graphs))
        val_data = self._bucket(list(val_graphs)) if val_graphs else None
        if val_data is not None:
            n_max = max(train_data.max_nodes, val_data.max_nodes)
            e_max = max(train_data.max_edges, val_data.max_edges)
            train_data = pad_graph(train_data, n_max, e_max)
            val_data = pad_graph(val_data, n_max, e_max)

        n = train_data.n_graphs
        bs = self._batch_size(n)
        steps_per_epoch = (n + bs - 1) // bs
        self._init_state(steps_per_epoch)

        start_epoch = 1
        if resume_from is not None:
            meta = self.load(resume_from, weights_only=False)
            start_epoch = int(meta.get("epoch", 0)) + 1
            if meta.get("score") is not None:
                self._best_score = float(meta["score"])
            print(f"[Trainer] Resumed from {resume_from} "
                  f"(epoch {start_epoch - 1}, score {meta.get('score')})")

        rng_np = np.random.RandomState(cfg.seed)
        for epoch in range(start_epoch, cfg.n_epochs + 1):
            t0 = time.time()
            total, nb = 0.0, 0
            for batch, w in self._batches(train_data, rng_np, shuffle=True):
                loss = self.train_step(batch, w, self._lr_scale)
                total += float(loss)
                nb += 1
            train_loss = total / max(nb, 1)
            self.history["train_loss"].append(train_loss)
            self.history["lr"].append(self._current_lr())

            if val_data is not None and epoch % cfg.val_every == 0:
                vm = self._eval_epoch(val_data)
                for k in ("loss", "acc", "iou_bg", "iou_unk", "iou_fg",
                          "score"):
                    self.history[f"val_{k}"].append(vm[k])
                self._plateau_update(vm["loss"])

                if self._tb:
                    self._tb.add_scalar("val/loss", vm["loss"], epoch)
                    self._tb.add_scalar("val/acc", vm["acc"], epoch)
                    self._tb.add_scalar("val/iou_fg", vm["iou_fg"], epoch)
                    self._tb.add_scalar("val/score", vm["score"], epoch)

                if vm["score"] > self._best_score:
                    self._best_score = vm["score"]
                    self._patience = 0
                    self.save("best_model.msgpack", epoch=epoch,
                              score=vm["score"])
                else:
                    self._patience += 1

                if cfg.verbose and epoch % 5 == 0:
                    print(f"Epoch {epoch:3d}/{cfg.n_epochs} | "
                          f"train_loss={train_loss:.4f} | "
                          f"val_loss={vm['loss']:.4f} | "
                          f"val_acc={vm['acc']:.4f} | "
                          f"IoU_fg={vm['iou_fg']:.4f} | "
                          f"score={vm['score']:.4f} | "
                          f"lr={self._current_lr():.2e} | "
                          f"{time.time() - t0:.1f}s")

                if self._patience >= cfg.early_stop_patience:
                    print(f"[Trainer] Early stopping at epoch {epoch} "
                          f"(no improvement for {cfg.early_stop_patience} "
                          "epochs).")
                    break
            elif cfg.verbose and epoch % 5 == 0:
                print(f"Epoch {epoch:3d}/{cfg.n_epochs} | "
                      f"train_loss={train_loss:.4f} | "
                      f"lr={self._current_lr():.2e}")

            if self._tb:
                self._tb.add_scalar("train/loss", train_loss, epoch)
                self._tb.add_scalar("train/lr", self._current_lr(), epoch)

            if epoch % cfg.save_every == 0:
                self.save(f"epoch_{epoch:04d}.msgpack", epoch=epoch)

        self.save("final_model.msgpack", epoch=cfg.n_epochs)
        self._save_history()
        if self._tb:
            self._tb.close()
        return self.history

    def _eval_epoch(self, val_data: GraphBatch) -> dict:
        rng_np = np.random.RandomState(0)
        total_l, total_correct, total_nodes = 0.0, 0.0, 0.0
        count_acc = np.zeros((3, 3))
        nb = 0
        for batch, w in self._batches(val_data, rng_np, shuffle=False):
            l, acc, counts, nn = self.eval_step(batch, w)
            total_l += float(l)
            total_correct += float(acc) * float(nn)
            total_nodes += float(nn)
            count_acc += counts.cpu().numpy()
            nb += 1
        # One global per-class IoU over the whole validation set (the
        # wrapped duplicates carry zero graph weight).
        ious = count_acc[:, 0] / (count_acc.sum(axis=1) + 1e-8)
        return {
            "loss": total_l / max(nb, 1),
            "acc": total_correct / max(total_nodes, 1),
            "iou_bg": float(ious[CLASS_BG]),
            "iou_unk": float(ious[CLASS_UNK]),
            "iou_fg": float(ious[CLASS_FG]),
            # Selection on the two decided classes, not val loss.
            "score": float(0.5 * (ious[CLASS_FG] + ious[CLASS_BG])),
        }

    # ------------------------------------------------------------------

    def _plateau_update(self, val_loss: float):
        if self.cfg.scheduler != "plateau":
            return
        if val_loss < self._plateau_best - 1e-6:
            self._plateau_best = val_loss
            self._plateau_wait = 0
        else:
            self._plateau_wait += 1
            if self._plateau_wait > 5:
                self._lr_scale *= 0.5
                self._plateau_wait = 0

    def _current_lr(self) -> float:
        base = self.cfg.lr
        if self.optimizer is not None and self._schedule is not None:
            base = float(self._schedule(self.step))
        return float(base * self._lr_scale)

    def _write(self, write) -> None:
        """write() in one process of the job; the others wait for it."""
        if process_index() == 0:
            write()
        if process_count() > 1:
            import torch.distributed as dist
            dist.barrier()

    def save(self, filename: str, epoch: int = 0,
             score: Optional[float] = None):
        """Checkpoint with the full training state (model, optimiser,
        config) in the JAX package's format and meta fields (one process
        of a job writes it)."""
        variables = jax_variables_from_state_dict(self.model.state_dict())
        self._write(lambda: ckpt_io.save_checkpoint(
            self.save_dir / filename,
            params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=self.optimizer.state_tree(),
            meta=dict(epoch=epoch, score=score, variant=self.variant,
                      model_kwargs={k: v for k, v in
                                    self.model_kwargs.items()
                                    if k != "dtype"},
                      config=dataclasses.asdict(self.cfg))))

    def load(self, filename: str, weights_only: bool = True) -> dict:
        """Restore a checkpoint; with weights_only=False the optimiser
        state resumes too."""
        path = Path(filename)
        if not path.is_absolute() and not path.exists():
            path = self.save_dir / filename
        params, batch_stats, meta = ckpt_io.load_checkpoint(path)
        if self.optimizer is None:
            raise RuntimeError("call fit() or _init_state() before load()")
        self.model.load_state_dict(state_dict_from_jax(
            {"params": params, "batch_stats": batch_stats}))
        if not weights_only:
            opt = ckpt_io.load_opt_state(path, self.optimizer.state_tree())
            if opt is not None:
                self.optimizer.load_state_tree(opt)
        return meta

    def _save_history(self):
        path = self.save_dir / "history.json"

        def write():
            with open(path, "w") as f:
                json.dump(self.history, f, indent=2)
            print(f"[Trainer] History saved → {path}")
        self._write(write)
