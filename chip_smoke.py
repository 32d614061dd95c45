#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (gcn_grabcut_torch) on one GPU.

    python3 chip_smoke.py              # every phase; needs one card
    python3 chip_smoke.py --eval-all   # the evaluation phase on all 60

Phases, each of which exits non-zero on failure:
  1. versions and the card's name and power limit;
  2. build every CUDA kernel in gcn_grabcut_torch/csrc/ (one nvcc per
     source, all in parallel);
  3. each kernel against its plain PyTorch version on the card at the main
     path's shapes, with its time, the plain version's time, a one-call
     PyTorch yardstick and the bound the card's peak rates allow;
     K1 at the banded SpMM's shapes, also timed with the L2 flushed before
     every call, with the share of its bound it reaches; K2 and K3 (the
     one-shot direct-write all-gather and direct-read reduce-scatter) at
     the sharded path's shapes (n = 4 ranks of one (rows/4, 128) block)
     and at n = 2 and 8 over the same rows, in float32 and bfloat16, each
     one's allocations held to its outputs, then >= 100 calls for each n
     with fresh seeded data and seeded timing skew between ranks, every
     output exact;
     Then the fixed-order sums: (a) the segment-sum kernel
     (csrc/segment_sum.cu) against its plain version on the card and on
     a CPU copy, bit for bit (a NaN matching a NaN), sums and maxima, on
     the main path's graph, with the values the call sites give it,
     recorded at the kernel's wrapper in one main-path segment_batch and
     one edge-list GAT layer (the fallback sums, EdgeContext's E x 65, the
     degree and band sums, the clean-up's 1536^2 x 1 with the background
     in the last segment; the GAT scores' maxima, exp sums and messages),
     the clean-up at 1536^2 x 3 (keep_largest with the posterior) and one
     sharded rank's masked messages; random values in the same segments
     (the worst case: no identity rows), region_statistics' 1536^2 x 15
     planes, a case with empty leading, inner and trailing segments
     (C = 6 fp32 and bf16, C = 1) and an adversarial long segment of
     +-0, subnormals, +-inf and NaN in all four dtypes; the launches of
     the recorded paths by shape; (b) its time, L2-warm and cold, alone
     and with its sort and offsets, beside its bytes bound, its chain
     floor (a sum's longest chain of non-identity rows x 4 cycles at the
     SM clock nvidia-smi reports), the plain version and two one-call
     yardsticks the port never calls (index_add_ or index_reduce_(amax),
     torch.segment_reduce with lengths); (c) no host sync in a call,
     forward or backward (torch.cuda.set_sync_debug_mode("error")); and
     the audit of every row gather whose gradient the card computes, each
     backward twice, bit for bit;
  4. the main path: GCNGrabCutPipeline.segment_batch on a 1536x1536
     synthetic image with 10 000 SLIC segments and a seeded ResGCNNet at
     D=128, n_layers=6 -- a warm run, then a timed run with the kernel
     launch counts set to 0 just before and read just after (K1, the
     segment sum, the min-cut, one launch per GrabCut iteration, the
     connectivity kernel and the mask components kernel); the
     card's forward is then held against the plain forward on the CPU;
  5. the graph-sharded path on the same graph and model: the forward
     through mesh_aggregators over 4 ranks with the ring halo (K2) and the
     gradient of sum(logits * c) for every parameter (K3), twice, with
     the counts set to 0 just before the second and read just after;
     held against apply_large(precision="highest"), and the same two
     steps with the plain halo: each halo's two steps bit-identical, the
     ring halo's logits and gradients bit for bit the plain halo's, and
     within 1e-4 of its scale (the worst leaves printed); the segment
     sum's launches in the forward;
  6. the dense path, the configuration the repo recommends: the 3-member
     bgc ensemble read from examples/ensemble_r5/ by the port's own
     checkpoint reader, GCNGrabCutPipeline.segment_batch at 512x512 with
     500 superpixels (K = 484), the geodesic prior, θ 0.65, guided-filter
     radius 4 and ms_scales (1.0, 0.75), on 8 make_image(512) images --
     warm runs, a timed B=1 run of each image with stage times, a timed
     B=8 run (images/s) and a B=8 run with stage times, with the K1
     count set to 0 just before and read just after (it must stay 0); the card's ensemble posteriors held against
     the CPU's on the same graphs, and the outputs against the JAX
     package's (tests/data/torch_dense_jax_ref.npz): SLIC agreement,
     posteriors where the labels agree, mask IoU;
  7. the staged paths at the same configuration, on make_image(512) seeds
     1 and 3 with seeded pixel noise: segment(edge_aware=False), segment(refine_iters=2),
     segment() with the native C++ min-cut (built here with g++),
     segment_bbox, and the GrabCut class from a box then refine(2) in HSV
     and Lab, each held against the JAX package's outputs
     (tests/data/torch_staged_jax_ref.npz) by mask IoU, segment_bbox's
     trimap exactly; the native solver's time beside the device solver's
     on the same trimap; segment_stream over four images in chunks of
     three against segment_batch on the same chunks, beside two
     segment_batch runs against each other; predict_probs on the main
     path's 1536x1536 graph (7 K1 launches) against segment_batch's
     posteriors, and two apply_large runs on that graph bit for bit, with
     the segment-sum launches of one large forward; K1
     launched 0 times on the 512 px items.  Before them,
     keep-largest's fixed-order sums (20 repeats on one 512x512 mask, bit
     for bit), and a flat-colour image through the dense path on the card
     and on the CPU (the std-Lab feature's cancellation, reported);
  8. training and the CLIs at the flagship recipe's width (ResGCNNet
     D=128 n=6, 512 px, 500 superpixels, the geodesic prior, batch 8):
     (a) one fp32 training step from the bgc_s42 weights on 8 prepared
     hard-synthetic graphs, the card against the port's CPU step (loss,
     every gradient leaf, the running statistics); (b) cli.train on 24
     hard-synthetic images for 2 epochs in bf16 with AdamW and SGDR --
     its files, a finite history, ms per step, graphs/s and peak memory,
     and the final checkpoint reloading to the same weights and
     posteriors; (c) cli.evaluate with the bgc ensemble on 16 of the 60
     hard-synthetic evaluation images at batch 8, held against the JAX
     package's run (tests/data/torch_eval_jax_ref.npz): the generated
     images' and masks' sha1s, mask IoU per image, the report's mean
     IoU; (d) cli.inference --batch 4 --fixed-size on 4 of those images
     as PNGs, held against segment_batch at its settings.
  9. the GCN and GAT variants at full width (D=128, n_layers=6; GAT with
     8 heads of 16), numpy-seeded weights: segment_batch at 1536x1536 /
     10 000 per variant with its stage split (GCN: 6 K1 launches per
     forward, counts set to 0 just before and read just after; GAT: 0),
     the GAT plan's fallback overflow (0) on that graph, the banded
     forward against the edge-list forward, and one attention layer timed
     banded ("default", "highest") and as the edge list; both variants
     against the JAX package (tests/data/torch_variants_jax_ref.npz) at
     320x320 / 2600 (the large path: logits) and 512x512 / 500 (the
     dense path: posteriors), mask IoU per image; one fp32 training step
     card vs CPU and cli.train --model gcn|gat at the flagship recipe per
     variant; the trained GAT checkpoint through load_model_auto and
     segment_batch at 1536x1536.
 10. serving (gcn_grabcut_torch.cli.serve through build_server, each
     server on a serve_forever thread, shut down before the next): (a)
     the recommended ensemble on a 512 px canvas (bgc x3, 500
     superpixels, the geodesic prior, θ 0.65, radius 4, --batch 8),
     16 requests from 8 client threads on five non-square serve_image
     images (PNG, one JSON body, one at threshold 0.6), each mask held
     against segment_batch at B=1 on its canvas and against the JAX
     package's served mask (tests/data/torch_serve_jax_ref.npz), IoU
     >= 0.999; /healthz, 400 and 404; at least one coalesced call
     (group sizes recorded around the pipeline's segment_batch);
     requests/s, p50 / p95 latency, group sizes and each batch's
     timing_ms; (b) examples/flagship_resgcn_d128.msgpack at
     1536x1536 / 10 000 superpixels, --batch 1: one request plain and
     one under utils.profile_trace, each launching K1 exactly 7 times
     (counts set to 0 just before and read just after) and held against
     segment_batch; the trace holds the card's kernels and K1's; (c) a
     FrameworkConfig JSON round trip and save_research_report on (a)'s
     results.
 11. data-parallel training over 4 logical ranks on the card
     (make_mesh(n_data=4, devices=[card] * 4)) on phase 8's 8 prepared
     graphs, ResGCNNet D=128 n=6, fp32, dropout 0.15 and prior dropout
     0.1: (a) one step from the bgc_s42 weights against the solo
     Trainer's step (loss, every gradient leaf, InputNorm's running
     statistics), with the K3 and K2 counts set to 0 just before and read
     just after (1 and 1: the gradient sum); (b) Trainer.fit for 2 epochs
     at batch 8, data-parallel against solo, histories and ms per step;
     (c) a (2, 2) mesh's graph_mesh(0) through mesh_aggregators(allgather,
     xla) on the main path's graph against apply_large("highest"), and
     the ring halo refused on the 2-D mesh.
 12. data-parallel GCNTrimapNet (every hidden InputNorm normalised with
     the whole batch's statistics) and GATTrimapNet at D=128 n=6 with
     init_model_numpy(8) weights, on phase 11's mesh, graphs, dropout
     and fp32, after checking that the models' Linear gives a rank's 2
     graphs the rows the 8-graph batch gets: (a) one step against the solo step (loss, every gradient
     leaf, every norm's running statistics), K3 and K2 counted as in
     phase 11 (1 and 1), ms per step beside solo; (b) the 2-epoch fit
     against solo; (c) ResGCNNet in bfloat16, the 4-rank fit against
     solo within JAX's 2e-4.
 13. multilevel GrabCut on the main path's image and trimap: the
     solve of segment_batch's GrabCut stage with ml_levels 0, 1 and 2
     (masks against ml_levels=0, the last cut's energy against the exact
     cut of the same problem, wall times), and grid_mincut_multilevel
     (levels 1, 2) against grid_mincut on the first iteration's energy
     (agreement, cut cost, time).
 14. core/scatter.py on the card against the CPU on seeded inputs with
     empty segments, masked rows and weights: maxima exact, the rest
     within 1e-6.
 15. the lock-step batched GrabCut (what segment_batch runs up to its
     pixel budget) against the plain image-by-image version on phase 6's
     8 images and the trimaps the bgc ensemble gave them: masks bit for
     bit at every B (else at B=8 each image's differing pixels and the
     largest difference of its first GMM fit, and a failure); the GrabCut
     stage's wall s of both at B = 1, 2, 4, 8 (the loop's, the sum of its
     images' solves, each timed once); per image outer rounds and push
     sweeps of both, relabel relaxation steps and solver host syncs per
     image for the loop and per batch for the lock step (0 syncs: every
     solve is one kernel launch); the lock step's peak memory at B=8.
     Phases 6 and 10 run the lock step through segment_batch.
 16. the min-cut kernel (csrc/grid_mincut.cu: the whole push-relabel
     solve in one cooperative launch) against its plain version
     (grid_mincut_plain, the eager solver) on the card, bit for bit on fg,
     e', every residual plane, each image's rounds and the relabel steps,
     one launch and no host sync per solve (torch.cuda.set_sync_debug_mode
     "error"), on the solves recorded at the wrapper: the main path's
     first GrabCut iteration at 1536^2, the dense phase's 8 images in lock
     step (first and second, flow-recycled, iterations), the first of
     those with max_outer 2, and grid_mincut_multilevel (levels=1) on the
     main path's first-iteration energy (coarse and banded solves); each
     with the kernel's device time, the plain version's wall time, its
     rounds, relabel steps, relaxed image-steps (each image stops where
     its own relabel stops) and grid-wide barriers, its sweep tiles
     (swept, and skipped where the neighbourhood was quiet) and relax
     tiles relaxed, its tiles, halos, shared memory and blocks a SM, the
     bytes bound at 3.35 TB/s (what the solve must move whatever the
     design, counted on the data by a watched run of the plain version,
     mincut_work: a push sweep reads e and h, 8 bytes a pixel, and moves
     16 + 16 D only where the pixel's window can push or lift; a relax
     block of `unroll` steps 9 where a height can move), the kernel's own
     traffic (tiles with their halos, mincut_design) and the barrier floor
     (its barriers times an empty barrier's time, on the same grid).
 17. the batched, sync-free graph build and clean-up: the connectivity
     kernel (csrc/slic_connectivity.cu: SLIC's orphan absorption and
     enforce_connectivity in one launch) and the mask components kernel
     (csrc/mask_components.cu: the clean-up's connected components in
     one launch) against their plain versions on the card, bit for bit,
     on the inputs recorded at their call sites in the dense cell's
     segment_batch (B=8 at 512^2 and its 0.75-scale rebuild) and the
     large cell's (1536^2), and on cap cases (a spiral with max_sweeps 1,
     2, 3 and 5, a serpentine with max_iters 1, 2, 3 and 5), each with
     its ms, the plain version's wall ms, its component blocks, absorption
     rounds or sweeps held to the plain version's, the connectivity
     kernel's tiles run and skipped, its bytes bound, and its grid-wide
     barriers and barrier floor (its barriers times an empty barrier's
     time on its own grid); one launch of each a build or clean-up (two of
     the connectivity kernel a dense batch: its two scales); the batched
     build (both scales), projection, trimap stage and clean-up at B=8
     against each image alone, bit for bit; no host sync in the build,
     the projection, the trimap stage or the clean-up
     (torch.cuda.set_sync_debug_mode("error")); the dense B=8
     graph_build and images/s and serving's requests/s beside the
     per-image build's figures.
 18. GrabCut's colour models (csrc/gmm_passes.cu: the k-means, the fits,
     the scores and the terminal energy as passes over the pixels) at the
     main path's shapes, 8 x 512^2 and 1 x 1536^2 (RGB, k = 5): a solve's
     k-means and five iterations against the plain steps on the card, bit
     for bit; a whole solve's colour models timed both ways (the passes
     counted: 27 launches); each pass kind's ms beside its bytes bound and
     the plain steps' ms, and the float64 cuBLAS GEMM of one fit's x x^T
     sums (the yardstick).  The main path's timed run (phase 6) counts the
     passes GrabCut launched there: 27, one lock-step solve.
The fp32 training steps on the card (phases 8 and 9) and the data-parallel
and solo steps of phase 11 each run twice and fail unless the two are
bit-identical.
Phase 9 also holds augment_sample's arrays, drawn here, to the sha1s of
the JAX package's run with OpenCV 5.0 (tests/data/torch_eval_jax_ref.npz):
augment_sample warps in numpy, so they must be equal whichever OpenCV the
card's machine has.
Phase 1 also reports whether cv2, PIL, networkx, matplotlib and yaml
import (information only; visualise draws with cv2 without matplotlib).
Kernel times are device times: the launches run back to back behind a
device sleep, so the host's launch cost is not counted.
The last lines are the kernels' JSON record (K1, K2, K3, the segment sum,
the min-cut, whose record adds its barrier floor, the connectivity kernel,
the mask components kernel and the colour-model passes), the card's name and
power limit, and {"ok": true, "device": {...}}.  Needs CUDA; imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import inspect
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM published peaks (dense): HBM3 bytes/s, bf16 tensor-core and
# fp32 (non-tensor) FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Cycles of one dependent float32 add (FADD's latency on Hopper): the chain
# floor of a fixed-order sum is its longest chain of adds times this.
ADD_CYCLES = 4

IMAGE_HW = 1536
N_SEGMENTS = 10_000
HIDDEN, N_LAYERS = 128, 6
# Random weights from this seed give a trimap with all four labels and
# ~95% probable pixels on make_image(1536), so GrabCut has real work
# (seed 0 labels every pixel foreground-side).
MODEL_SEED = 4
SPMM_TOL = 1e-4        # kernel vs plain: same products, fp32 sums reordered
L2_FLUSH_BYTES = 64 << 20   # written between calls for a cold-L2 time
FORWARD_TOL = 2e-2     # card (bf16 kernel) vs CPU plain forward, logits
RING_SIZES = (2, 4, 8)
PATH_RANKS = 4
STRESS_CALLS = 100
STRESS_MAX_DELAY_NS = 20_000
# K3's yardstick sums over ranks in another order: fp32 within 1e-5 of the
# sum's scale, bf16 within 2 ulp at that scale.
YARDSTICK_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}
# Sharded forward vs apply_large(precision="highest"): the same fp32 sums,
# reordered, and edge weights rounded differently.
SHARDED_FWD_TOL = 1e-3
# Sharded backward, ring halo vs plain halo: a further gate beside bit
# equality (both halos sum in K3's order, every sum in a fixed order).
SHARDED_GRAD_TOL = 1e-4

# The dense path: the configuration the repo recommends
# (examples/ensemble_r5/README.md), on DENSE_IMAGES make_image(DENSE_HW)
# images; tests/data/torch_dense_jax_ref.npz holds the JAX package's
# outputs on them (tests/make_torch_dense_jax_ref.py).
DENSE_CHECKPOINTS = tuple(f"examples/ensemble_r5/bgc_s4{i}.msgpack"
                          for i in (2, 3, 4))
DENSE_HW, DENSE_IMAGES, DENSE_SEGMENTS = 512, 8, 500
DENSE_SETTINGS = dict(threshold_fg=0.65, threshold_bg=0.65, filter_radius=4,
                      ms_scales=(1.0, 0.75))
DENSE_REF = "tests/data/torch_dense_jax_ref.npz"
DENSE_CPU_TOL = 1e-4   # card vs CPU ensemble posteriors: fp32, no TF32
# Card vs JAX posteriors where SLIC agrees fully.  The std-Lab features of
# near-uniform regions come from E[x^2] - E[x]^2 in fp32, which cancels,
# and the card sums them in another order: 1.5e-3 measured on the CPU.
DENSE_JAX_TOL = 1e-2
DENSE_MIN_IOU = 0.99   # mean mask IoU against JAX (k-means seeds differ)

# The staged paths, at the dense path's configuration (ms_scales aside:
# the staged branch ignores it) on staged_image(seed) for these seeds;
# tests/data/torch_staged_jax_ref.npz holds the JAX package's outputs
# (tests/make_torch_staged_jax_ref.py).
STAGED_SEEDS = (1, 3)
# make_image's 8x8 blocks are flat: a GMM component holding a few dozen
# pixels of one block has a covariance E[xx^T] - mm^T that is float32
# noise, and a box-initialised GrabCut in HSV then parts between the two
# packages (seed 3: mask IoU 0.958 on the CPU).  Seeded pixel noise of
# this amplitude keeps every component well-conditioned.
STAGED_NOISE = 12
STAGED_SETTINGS = dict(threshold_fg=0.65, threshold_bg=0.65, filter_radius=4)
STAGED_BBOX = (96, 112, 288, 288)      # (x, y, w, h) around the disc
STAGED_REFINE = 2
STAGED_COLOUR_SPACES = ("hsv", "lab")
STAGED_REF = "tests/data/torch_staged_jax_ref.npz"
STREAM_SEEDS, STREAM_BATCH = (1, 3, 4, 6), 3
# predict_probs(RegionGraph) vs segment_batch's posteriors on the main
# path's image: two builds of one graph, whose float sums the card may
# order differently.
PREDICT_TOL = 1e-3
KEEP_LARGEST_REPEATS = 20

# The evaluation CLI on the hard-synthetic set (`cli.evaluate
# --hard-synthetic EVAL_N --hard-size DENSE_HW --batch EVAL_BATCH
# --bg-connectivity`, synthetic seed EVAL_SEED) with the bgc ensemble;
# tests/data/torch_eval_jax_ref.npz holds the JAX package's images' and
# masks' sha1s, masks and report on all EVAL_N
# (tests/make_torch_eval_jax_ref.py).  The card runs the first
# EVAL_LIMIT.
EVAL_N, EVAL_SEED, EVAL_BATCH, EVAL_LIMIT = 60, 777, 8, 16
EVAL_REF = "tests/data/torch_eval_jax_ref.npz"
EVAL_MIN_IOU = 0.99        # mean per-image mask IoU against JAX's masks
EVAL_REPORT_TOL = 0.005    # the report's mean_iou against JAX's
INFER_IMAGES, INFER_MIN_IOU = 4, 0.999
# Training at the flagship recipe's width (examples/ensemble_r5/README.md):
# ResGCNNet D=128, n_layers=6, 512 px images with 500 superpixels and the
# geodesic prior, batch 8.  One fp32 step (TF32 off, dropout 0) from
# TRAIN_START's weights on the card against the port's CPU step.
TRAIN_START = "examples/ensemble_r5/bgc_s42.msgpack"
TRAIN_GRAPHS, TRAIN_CLI_SAMPLES = 8, 24
TRAIN_LOSS_TOL = 1e-5      # the step's loss, relative
TRAIN_GRAD_TOL = 1e-4      # each gradient leaf, of its scale ...
TRAIN_GRAD_FLOOR = 1e-3    # ... floored at this share of the largest
TRAIN_STATS_TOL = 1e-6     # InputNorm's running statistics after the step

# The GCN and GAT variants at full width (build_model's defaults: D=128,
# n_layers=6, GAT with 8 heads of 16), weights drawn with numpy from
# VARIANT_SEED (init_model_numpy).  VARIANT_CASES: (side, n_segments,
# image seed) of textured_image for the large path and the dense path;
# tests/data/torch_variants_jax_ref.npz holds the JAX package's logits
# and masks on them (tests/make_torch_variants_jax_ref.py).
VARIANTS = ("gcn", "gat")
VARIANT_SEED = 8
VARIANT_CASES = {"large": (320, 2600, 1), "dense": (DENSE_HW, 500, 3)}
VARIANT_REF = "tests/data/torch_variants_jax_ref.npz"
VARIANT_LOGIT_TOL = 2e-2   # large path vs JAX, x max(1, |logits|)
VARIANT_PROB_TOL = 1e-4    # dense path posteriors vs JAX (fp32)
VARIANT_MIN_IOU = 0.99     # mask IoU vs JAX, per image
# The banded GAT attention against the edge-list form on the card:
# "highest" within rtol = atol = 2e-4 (the JAX package's bar), "default"
# (bf16 windows) within 0.05 of the largest output.
BANDED_HIGHEST_TOL = 2e-4
BANDED_DEFAULT_REL = 0.05

# Serving (cli.serve) at the recommended configuration: the bgc ensemble
# on a 512 px canvas with 500 superpixels, θ 0.65, radius 4 (no
# ms_scales: the server passes none), on serve_image(h, w, seed) for each
# (h, w, seed) of SERVE_IMAGES, and SERVE_IMAGES[0] again at threshold
# SERVE_ALT_THRESHOLD; tests/data/torch_serve_jax_ref.npz holds the JAX
# package's served masks (tests/make_torch_serve_jax_ref.py).
SERVE_FLAGS = ["--size", str(DENSE_HW), "--n-segments", str(DENSE_SEGMENTS),
               "--bg-connectivity", "--batch", "8", "--threshold", "0.65",
               "--filter-radius", "4"]
SERVE_IMAGES = ((384, 512, 0), (600, 450, 1), (480, 640, 2), (512, 384, 3),
                (700, 500, 4))
SERVE_ALT_THRESHOLD = 0.6
SERVE_REF = "tests/data/torch_serve_jax_ref.npz"
SERVE_CLIENTS, SERVE_REQUESTS = 8, 16
SERVE_WAIT_MS = 200      # long enough for concurrent clients to coalesce
SERVE_MIN_IOU = 0.999    # per mask, against segment_batch and against JAX
# The large server: one ResGCNNet at 1536^2 / 10 000 superpixels.
SERVE_LARGE_CHECKPOINT = "examples/flagship_resgcn_d128.msgpack"

# Data-parallel training at the flagship width on the training phase's
# TRAIN_GRAPHS prepared graphs: DP_RANKS logical ranks on the card
# (make_mesh(n_data=DP_RANKS, devices=[card] * DP_RANKS)), fp32, ResGCNNet
# dropout and prior dropout on, so each rank's slice of the masks matters.
DP_RANKS = 4
DP_DROPOUT, DP_PRIOR_DROPOUT = 0.15, 0.1
DP_LOSS_TOL = 1e-5         # the step's loss against the solo step's
DP_GRAD_TOL = 1e-5         # each gradient leaf, of its scale ...
# ... floored at this share of the largest: ctx.attn.bias's exact
# gradient is 0 and either step leaves float noise there.
DP_GRAD_FLOOR = 1e-2
DP_FIT_EPOCHS = 2
# JAX's bars for a data-parallel history against the single-device one.
DP_FIT_LOSS_RTOL = 2e-4
DP_SCORE_RTOL, DP_SCORE_ATOL = 2e-3, 2e-4
MESH_2D = (2, 2)           # (n_data, n_graph) of the 2-D mesh's check
# Phase 12: the variants over the same mesh; GCNTrimapNet's hidden
# InputNorms are synchronised over the ranks.
DP_VARIANTS = ("gcn", "gat")
# Phase 13: the banded coarse-to-fine min-cut's levels.
ML_LEVELS = (1, 2)
# Phase 14: core/scatter.py at the large graph's scale.
SCATTER_ROWS, SCATTER_SEGMENTS, SCATTER_COLS = 200_000, N_SEGMENTS, 16
SCATTER_TOL = 1e-6
# Phase 15: the lock-step GrabCut at these batch sizes (of the dense
# phase's DENSE_IMAGES images).
LOCK_STEP_BATCHES = (1, 2, 4, 8)
# Phase 16: the min-cut kernel's max_outer-bound case, and the empty
# grid-wide barriers timed for its barrier floor.
CUT_BOUND_OUTER = 2
CUT_BARRIERS = 2000
# Phase 17: the cap cases of the connectivity kernel (max_sweeps: 1, 3 and
# 5 stop its super-blocks of 16 steps inside one) and the mask components
# kernel (max_iters), and the figures of the per-image build that the
# batched one replaced (PERF.md section 5, run G: H100 80GB HBM3, 700.00 W).
CONNECT_CAP, COMPONENTS_CAP = 2, 2
CONNECT_CAPS = (1, CONNECT_CAP, 3, 5)
COMPONENTS_CAPS = (1, COMPONENTS_CAP, 3, 5)
BUILD_BEFORE = {"graph_build_s": 0.4324, "dense_images_s": 5.98,
                "serving_requests_s": 7.8180}


def optional_packages() -> str:
    """Which optional packages import here, with their versions."""
    parts = []
    for name in ("cv2", "PIL", "networkx", "matplotlib", "yaml"):
        try:
            mod = importlib.import_module(name)
        except Exception as e:   # ImportError, or a broken native library
            parts.append(f"{name} no ({type(e).__name__}: {e})")
        else:
            parts.append(f"{name} {getattr(mod, '__version__', '?')}")
    return "optional packages: " + ", ".join(parts)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Device milliseconds per fn() call: `reps` calls run back to back
    between two CUDA events, queued behind a device sleep long enough for
    the host to queue them all, so the host's launch cost is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    slept, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    slept.record()
    torch.cuda._sleep(300_000_000)       # ~0.15 s at the H100's clocks
    start.record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    end.record()
    end.synchronize()
    if host_ms > slept.elapsed_time(start):
        print(f"  (timing: queueing {reps} calls took {host_ms:.1f} ms, "
              f"longer than the sleep; the time includes host gaps)",
              flush=True)
    return start.elapsed_time(end) / reps


def time_cold_ms(fn, reps: int = 30) -> float:
    """Device milliseconds per fn() call with a cold L2: each call follows a
    write of L2_FLUSH_BYTES, whose own time, measured alone, is
    subtracted."""
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    both = time_ms(lambda: (scratch.zero_(), fn()), reps)
    return both - time_ms(scratch.zero_, reps)


def make_image(hw: int, seed: int = 0) -> np.ndarray:
    """Blocky noise with a brighter disc (tools/bench_large.py's recipe)."""
    r = np.random.RandomState(seed)
    img = np.kron(r.rand(hw // 8, hw // 8, 3), np.ones((8, 8, 1)))
    yy, xx = np.mgrid[0:hw, 0:hw]
    cy, cx = hw // 2, int(hw * 0.47)
    blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < (hw // 4) ** 2
    img[blob] = img[blob] * 0.25 + r.rand(3) * 0.75
    return (img * 255).astype(np.uint8)


def textured_image(hw: int, seed: int) -> np.ndarray:
    """make_image(hw, seed) with seeded uniform noise of +-STAGED_NOISE on
    every channel."""
    noise = np.random.RandomState(1000 + seed).randint(
        -STAGED_NOISE, STAGED_NOISE + 1, (hw, hw, 3))
    return np.clip(make_image(hw, seed) + noise, 0, 255).astype(np.uint8)


def staged_image(seed: int) -> np.ndarray:
    return textured_image(DENSE_HW, seed)


def serve_image(h: int, w: int, seed: int) -> np.ndarray:
    """An h x w request image: the centre crop of the max(h, w) px
    hard-synthetic image of this seed (textured background, one object;
    the port's generator draws the JAX package's pixels)."""
    from gcn_grabcut_torch.data.dataset import make_hard_synthetic_dataset
    side = max(h, w)
    img = make_hard_synthetic_dataset(1, side, seed)[0]["image"]
    y0, x0 = (side - h) // 2, (side - w) // 2
    return np.ascontiguousarray(img[y0:y0 + h, x0:x0 + w])


def slic_like_edges(side: int, n_nonlocal: int, seed: int):
    """Directed edges of a side x side 4-connected grid in scan order plus
    random non-local pairs, both directions: the structure SLIC labels
    give the large path."""
    r = np.random.RandomState(seed)
    idx = np.arange(side * side).reshape(side, side)
    pairs = [np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
             np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)]
    n = side * side
    nl = np.stack([np.repeat(np.arange(n), n_nonlocal),
                   r.randint(0, n, n * n_nonlocal)], 1)
    pairs.append(nl[nl[:, 0] != nl[:, 1]])
    p = np.concatenate(pairs)
    return np.concatenate([p[:, 0], p[:, 1]]), np.concatenate([p[:, 1],
                                                               p[:, 0]])


def check_banded_spmm(dev) -> dict:
    """K1 against its plain version at the main path's shapes, bf16 (the
    path's dtype) and fp32.  Returns the bf16 record for the JSON line."""
    from gcn_grabcut_torch.models.large import build_gcn_plans_device
    from gcn_grabcut_torch.ops.spmm import (banded_spmm_cuda,
                                            banded_spmm_plain)
    side = int(round(N_SEGMENTS ** 0.5))
    n = side * side
    src, dst = slic_like_edges(side, 4, seed=0)
    src = torch.as_tensor(src, device=dev)
    dst = torch.as_tensor(dst, device=dev)
    mask = torch.ones(src.shape, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x32 = torch.randn((n, HIDDEN), generator=gen, device=dev)
    record = None
    for dtype in (torch.bfloat16, torch.float32):
        plan, _ = build_gcn_plans_device(src, dst, mask, n, dtype=dtype)
        band = plan.band
        K, n_pad, R = band.shape
        x = x32.to(dtype).contiguous()
        out = banded_spmm_cuda(x, band)
        torch.cuda.synchronize()
        ref = banded_spmm_plain(x, band)
        err = float((out - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        ok = err <= SPMM_TOL * scale
        ms = time_ms(lambda: banded_spmm_cuda(x, band))
        cold_ms = time_cold_ms(lambda: banded_spmm_cuda(x, band))
        plain_ms = time_ms(lambda: banded_spmm_plain(x, band))

        # Yardstick only: one torch.bmm of the band as (nb, R, K*R)
        # against the overlapping (nb, K*R, D) slabs of the padded x.
        nb, off0 = n_pad // R, K // 2
        band_b = band.reshape(K, nb, R, R).permute(1, 2, 0, 3).reshape(
            nb, R, K * R).contiguous()
        xpad = torch.nn.functional.pad(
            x, (0, 0, off0 * R, (K - 1 - off0) * R + n_pad - n))
        slabs = xpad.as_strided((nb, K * R, HIDDEN), (R * HIDDEN, HIDDEN, 1))
        lib_err = float((torch.bmm(band_b, slabs).float().reshape(
            n_pad, HIDDEN) - ref).abs().max())
        library_ms = time_ms(lambda: torch.bmm(band_b, slabs))

        elt = band.element_size()
        n_bytes = band.numel() * elt + n * HIDDEN * elt + n_pad * HIDDEN * 4
        n_ops = 2 * n_pad * K * R * HIDDEN
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
        rec = {"name": "banded_spmm", "route": "cuda",
               "source": "gcn_grabcut_torch/csrc/banded_spmm.cu",
               "replaces": "gcn_grabcut_tpu/ops/spmm.py:236",
               "launches": 0, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": library_ms}
        print(f"K1 banded_spmm {str(dtype)[6:]} n_pad={n_pad} R={R} K={K} "
              f"D={HIDDEN}: max_abs_err={err:.3e} (tol {SPMM_TOL * scale:.1e})"
              f" kernel {ms:.4f} ms (L2-warm; {cold_ms:.4f} ms cold), plain "
              f"{plain_ms:.4f} ms, bmm yardstick {library_ms:.4f} ms (err "
              f"{lib_err:.2e}), bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}: {n_bytes / 1e6:.2f} MB, "
              f"{n_ops / 1e9:.3f} GFLOP); bound share "
              f"{rec['bound_ms'] / ms:.3f} warm, {rec['bound_ms'] / cold_ms:.3f}"
              f" cold", flush=True)
        if not ok:
            fail(f"banded_spmm {dtype} disagrees with its plain version")
        if dtype == torch.bfloat16:
            record = rec
    return record


def ring_bound(n: int, chunk: int, elt: int, reduce: bool
               ) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time for K2 (reduce=False)
    or K3 on n ranks of (chunk, HIDDEN) blocks.  K2 reads n blocks and
    writes n^2; K3 reads n^2 and writes n, and adds (n - 1) n chunk HIDDEN
    values, counted at the fp32 rate (bf16 is added in fp32)."""
    e = chunk * HIDDEN * elt
    t_bytes = (n + n * n) * e / PEAK_BYTES_S * 1e3
    n_ops = (n - 1) * n * chunk * HIDDEN if reduce else 0
    t_ops = n_ops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def allocated_beyond_outputs(call) -> tuple[int, list]:
    """(bytes, outputs): how far the peak of the bytes requested from the
    caching allocator over call() rose above the outputs it returned, and
    those outputs.  Requested bytes, not the allocator's blocks, which it
    rounds up and may leave unsplit (a 5.12 MB output can hold a 20 MB
    segment's last 480 KB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    outs = call()
    torch.cuda.synchronize()
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"]
    return peak - base - sum(o.untyped_storage().nbytes() for o in outs), outs


def check_ring_collectives(dev, n_nodes: int) -> dict:
    """K2 and K3 against their plain versions at the sharded path's shapes
    (PATH_RANKS ranks, chunk = n_nodes / PATH_RANKS rounded up, D = HIDDEN)
    and at the other RING_SIZES over the same nodes, in float32 and
    bfloat16.  Both must agree exactly.  Returns the float32 (the path's
    dtype) records at PATH_RANKS, keyed "K2" and "K3"."""
    from gcn_grabcut_torch.parallel import ring
    from gcn_grabcut_torch.parallel.mesh import make_graph_mesh
    gen = torch.Generator(device=dev).manual_seed(1)
    records = {}
    for n in RING_SIZES:
        chunk = -(-n_nodes // n)
        rows = n * chunk
        mesh = make_graph_mesh(n)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((rows, HIDDEN), generator=gen, device=dev
                            ).to(dtype)
            blocks = list(x.split(chunk))
            g = torch.randn((n, rows, HIDDEN), generator=gen, device=dev
                            ).to(dtype)
            gs = list(g)
            elt = x.element_size()
            tag = f"n={n} chunk={chunk} D={HIDDEN} {str(dtype)[6:]}"

            # Neither kernel allocates more than its outputs (no receive
            # slots, no scratch).
            extra, out = allocated_beyond_outputs(
                lambda: ring.ring_all_gather_cuda(blocks, mesh))
            if extra > 0:
                fail(f"ring_all_gather allocated {extra} bytes beyond its "
                     f"outputs ({tag})")
            err2 = max(float((o.float() - w.float()).abs().max())
                       for o, w in zip(out, ring.ring_all_gather_plain(blocks)))
            cat = torch.cat(blocks)
            rec2 = {"name": "ring_all_gather", "route": "cuda",
                    "source": "gcn_grabcut_torch/csrc/ring_collectives.cu",
                    "replaces": "gcn_grabcut_tpu/parallel/ring_pallas.py:109",
                    "launches": 0, "max_abs_err": err2,
                    "ms": time_ms(lambda: ring.ring_all_gather_cuda(
                        blocks, mesh)),
                    "plain_ms": time_ms(
                        lambda: ring.ring_all_gather_plain(blocks)),
                    "library_ms": time_ms(
                        lambda: cat.expand(n, rows, HIDDEN).contiguous())}
            rec2["bound_ms"], rec2["bound_by"] = ring_bound(n, chunk, elt,
                                                            False)

            extra, out = allocated_beyond_outputs(
                lambda: ring.ring_reduce_scatter_cuda(gs, mesh))
            if extra > 0:
                fail(f"ring_reduce_scatter allocated {extra} bytes beyond "
                     f"its outputs ({tag})")
            want = ring.ring_reduce_scatter_plain(gs)
            err3 = max(float((o.float() - w.float()).abs().max())
                       for o, w in zip(out, want))
            rec3 = {"name": "ring_reduce_scatter", "route": "cuda",
                    "source": "gcn_grabcut_torch/csrc/ring_collectives.cu",
                    "replaces": "gcn_grabcut_tpu/parallel/ring_pallas.py:194",
                    "launches": 0, "max_abs_err": err3,
                    "ms": time_ms(lambda: ring.ring_reduce_scatter_cuda(
                        gs, mesh)),
                    "plain_ms": time_ms(
                        lambda: ring.ring_reduce_scatter_plain(gs)),
                    "library_ms": time_ms(
                        lambda: g.view(n, n, chunk, HIDDEN).sum(0))}
            rec3["bound_ms"], rec3["bound_by"] = ring_bound(n, chunk, elt,
                                                            True)
            # The yardstick sums in another order: each sum of n terms is
            # within (n - 1) u sum|g| of the exact one (u the unit
            # roundoff), so the two are within 2 n u sum|g|.
            yard = g.view(n, n, chunk, HIDDEN).sum(0).float()
            yard_err = float((yard - torch.stack(want).float()).abs().max())
            u = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8
            yard_tol = 2 * n * u * float(
                g.float().abs().view(n, n, chunk, HIDDEN).sum(0).max())

            mb = chunk * HIDDEN * elt * (n + n * n) / 1e6
            for key, rec, design, yardstick in (
                    ("K2", rec2, "one-shot direct write",
                     "expand().contiguous()"),
                    ("K3", rec3, "one-shot direct read",
                     f"view().sum(0) (err {yard_err:.2e}, tol "
                     f"{yard_tol:.2e})")):
                print(f"{key} {rec['name']} ({design}) {tag}: max_abs_err="
                      f"{rec['max_abs_err']:.1e} kernel {rec['ms']:.4f} ms, "
                      f"plain {rec['plain_ms']:.4f} ms, yardstick "
                      f"{yardstick} {rec['library_ms']:.4f} ms, bound "
                      f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
                      f"{mb:.2f} MB)", flush=True)
            if err2 != 0.0 or err3 != 0.0:
                fail(f"ring kernels disagree with their plain versions "
                     f"({tag}: K2 {err2}, K3 {err3})")
            if yard_err > yard_tol:
                fail(f"K3's yardstick disagrees with the ring sum ({tag})")
            if n == PATH_RANKS and dtype == torch.float32:
                records = {"K2": rec2, "K3": rec3}
    return records


def stress_ring_collectives(dev, n_nodes: int) -> None:
    """STRESS_CALLS calls each of K2 and K3 for every ring size, queued
    back to back with fresh seeded data, alternating float32 and bfloat16,
    each with a seeded (rank, phase) delay table (half the entries 0, the
    rest up to STRESS_MAX_DELAY_NS) or none.  Every output must equal its
    plain version bit for bit."""
    from gcn_grabcut_torch.parallel import ring
    from gcn_grabcut_torch.parallel.mesh import make_graph_mesh
    r = np.random.RandomState(2)
    gen = torch.Generator(device=dev).manual_seed(3)
    for n in RING_SIZES:
        chunk = -(-n_nodes // n)
        rows = n * chunk
        mesh = make_graph_mesh(n)
        checks = []
        t = time.perf_counter()
        for i in range(STRESS_CALLS):
            dtype = (torch.float32, torch.bfloat16)[i % 2]
            delays = [None if i % 5 == 0 else
                      r.randint(0, STRESS_MAX_DELAY_NS, (n, n))
                      * (r.rand(n, n) < 0.5) for _ in range(2)]
            x = torch.randn((rows, HIDDEN), generator=gen, device=dev
                            ).to(dtype)
            outs = ring.ring_all_gather_cuda(list(x.split(chunk)), mesh,
                                             delay_ns=delays[0])
            checks += [(o == x).all() for o in outs]
            gs = list(torch.randn((n, rows, HIDDEN), generator=gen,
                                  device=dev).to(dtype))
            outs = ring.ring_reduce_scatter_cuda(gs, mesh, delay_ns=delays[1])
            checks += [(o == w).all() for o, w in
                       zip(outs, ring.ring_reduce_scatter_plain(gs))]
        bad = int((~torch.stack(checks)).sum())
        print(f"stress n={n} chunk={chunk}: {STRESS_CALLS} calls each of K2 "
              f"and K3 with seeded skew, {len(checks)} rank outputs, "
              f"{bad} inexact ({time.perf_counter() - t:.2f} s)", flush=True)
        if bad:
            fail(f"{bad} ring outputs differ from their plain versions under "
                 f"skew (n={n})")


@dataclasses.dataclass
class SegCase:
    """One shape of the fixed-order sums: `index` (P,) into `n` segments,
    `values` (P, ...), the op the call site runs and whether it is timed
    (a dtype or layout copy of a timed case is only held to the plain
    version)."""
    index: torch.Tensor
    values: torch.Tensor
    n: int
    is_sorted: bool
    label: str
    op: str = "sum"
    timed: bool = True


@contextlib.contextmanager
def recording_segment_sums():
    """Records every launch of the segment-sum kernel while it is open:
    [(values, Segments, op)], the call site's own tensors."""
    from gcn_grabcut_torch.ops import region
    calls, launch = [], region.segment_reduce_cuda

    def recording(values, segs, op):
        calls.append((values, segs, op))
        return launch(values, segs, op)
    region.segment_reduce_cuda = recording
    try:
        yield calls
    finally:
        region.segment_reduce_cuda = launch


def launch_shapes(calls) -> dict:
    """{(rows, columns, segments, dtype, sorted, op): launches}."""
    shapes: dict = {}
    for values, segs, op in calls:
        cols = values.numel() // max(values.shape[0], 1)
        key = (values.shape[0], cols, segs.n, str(values.dtype)[6:],
               segs.order is None, op)
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def print_launch_shapes(where: str, calls) -> None:
    for (rows, cols, n, dt, srt, op), k in sorted(
            launch_shapes(calls).items(), key=lambda kv: -kv[0][0]):
        print(f"segment_sum launches on {where}: {k} x {op} {rows} x {cols} "
              f"{dt} {'sorted' if srt else 'unsorted'} into {n}", flush=True)


def cleanup_mask(hw: int) -> np.ndarray:
    """A 1536^2-scale foreground mask like the main path's (FG ~0.2): four
    discs, a frame-like strip and seeded speckle, so the clean-up has one
    large background component and many small ones."""
    yy, xx = np.mgrid[0:hw, 0:hw]
    mask = np.zeros((hw, hw), np.uint8)
    f = hw / DENSE_HW
    for cy, cx, r in ((200, 220, 100), (420, 100, 45), (90, 430, 35),
                      (400, 400, 55)):
        mask[(yy - cy * f) ** 2 + (xx - cx * f) ** 2 < (r * f) ** 2] = 1
    mask[:, :6] = 1
    mask[np.random.RandomState(15).rand(hw, hw) < 0.002] = 1
    return mask


def adversarial_case(dev, dtype) -> tuple:
    """(index, values, n): 200 000 rows, sorted, in 64 segments of which
    segment 3 holds 120 000 and segment 40 holds 30 000: rows mostly +-0,
    with subnormals, +-inf and NaN among them."""
    r = np.random.RandomState(16)
    lengths = r.randint(0, 800, 64)
    lengths[3], lengths[40] = 120_000, 30_000
    lengths[-1] = 200_000 - lengths[:-1].sum()
    idx = np.repeat(np.arange(64), lengths)
    rows = len(idx)
    vals = np.where(r.rand(rows, 6) < 0.5, 0.0, -0.0)
    live = r.rand(rows) < 0.01
    vals[live] = r.randn(int(live.sum()), 6) * 3
    tiny = {torch.float32: 1e-45, torch.float64: 5e-324,
            torch.bfloat16: 9.2e-41, torch.float16: 6e-8}[dtype]
    sub = r.rand(rows) < 0.002
    vals[sub, r.randint(0, 6, int(sub.sum()))] = tiny * r.choice(
        [-1, 1], int(sub.sum()))
    for v in (np.inf, -np.inf, np.nan):
        vals[r.randint(0, rows, 3), r.randint(0, 6, 3)] = v
    return (torch.as_tensor(idx, device=dev),
            torch.as_tensor(vals, device=dev).to(dtype), 64)


def segment_cases(dev) -> tuple[dict, dict]:
    """The fixed-order sums' shapes on the card, from the main path's
    1536^2 / 10 000-superpixel graph: name -> SegCase; and the graph's
    arrays.  Each call site's real values come from a main-path
    segment_batch (its fallback sums, EdgeContext, the degree and band
    sums, the clean-up, the region planes), one GAT attention layer (its
    scores' maxima, exp sums and messages) and one sharded rank's masked
    messages, recorded at the kernel's wrapper; random values in the same
    segments are the worst case (no row is an identity row), and an
    adversarial long segment (+-0, subnormals, +-inf, NaN) is held in
    every dtype.  Prints the launches of the recorded paths by shape."""
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.models.large import build_gcn_plans_device
    from gcn_grabcut_torch.models.layers import sort_edges_by_dst
    from gcn_grabcut_torch.ops import image as im
    from gcn_grabcut_torch.ops.connected import connected_components
    from gcn_grabcut_torch.ops.region import region_planes
    from gcn_grabcut_torch.parallel.mesh import make_graph_mesh
    from gcn_grabcut_torch.parallel.partition import (partition_edges_by_dst,
                                                      shard_segments)

    cfg = gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    rgb = torch.as_tensor(make_image(IMAGE_HW), device=dev).float()
    arrays = gt.build_graph_batch_arrays(rgb[None], cfg, device=dev)
    segments = arrays["segments"][0]
    k = int(arrays["x"].shape[1])
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = {}

    def real(values, segs, op, label) -> SegCase:
        return SegCase(segs.index, values.detach(), segs.n,
                       segs.order is None, label + " (real values)", op)

    def first(calls, rows=None, cols=None, op="sum"):
        for values, segs, o in calls:
            c = values.numel() // max(values.shape[0], 1)
            if (o == op and (rows is None or values.shape[0] == rows)
                    and (cols is None or c == cols)):
                return values, segs, o
        raise RuntimeError(f"no recorded {op} of {rows} x {cols}")

    # The main path's calls, recorded in one segment_batch.
    model = gt.ResGCNNet(hidden_channels=HIDDEN, n_layers=N_LAYERS,
                         generator=torch.Generator().manual_seed(MODEL_SEED))
    pipe = gt.GCNGrabCutPipeline(model, cfg, device=dev)
    with recording_segment_sums() as main_calls:
        pipe.segment_batch([make_image(IMAGE_HW)])
    print_launch_shapes("the main path (segment_batch, 1536^2 / 10k)",
                        main_calls)
    e = int(arrays["edge_dst"].shape[1])

    # The edge-list GAT layer's messages (models/layers.py), E x 128 by
    # destination, edges sorted: node 0 holds the padded edges.
    _, e_dst, _, _ = sort_edges_by_dst(arrays["edge_src"], arrays["edge_dst"],
                                       arrays["edge_attr"],
                                       arrays["edge_mask"])
    dst = e_dst.reshape(-1)
    _, _, layer, args, _ = gat_layer_case(dev)
    with recording_segment_sums() as gat_calls, torch.no_grad():
        layer(*args, pre_sorted=True)
    print_launch_shapes("one edge-list GAT layer", gat_calls)
    cases["gat_messages_real"] = real(*first(gat_calls, cols=HIDDEN),
                                      f"GAT messages E={e} x {HIDDEN} "
                                      f"sorted into {k}")
    msgs = torch.randn((dst.numel(), HIDDEN), generator=gen, device=dev)
    cases["gat_messages"] = SegCase(dst, msgs, k, True,
                                    f"GAT messages E={dst.numel()} x "
                                    f"{HIDDEN} sorted into {k}")
    cases["gat_messages_bf16"] = SegCase(dst, msgs.bfloat16(), k, True,
                                         "the same in bfloat16", timed=False)
    cases["gat_scores_real"] = real(*first(gat_calls, cols=8, op="max"),
                                    f"GAT per-head scores E={e} x 8 sorted "
                                    f"into {k}, maxima")
    cases["gat_exp_real"] = real(*first(gat_calls, cols=8),
                                 f"GAT per-head exp E={e} x 8 sorted into "
                                 f"{k}")

    # The banded SpMM's fallback sum (ops/spmm.py), unsorted: each band row,
    # then the fallback edges; the padded edges make node 0's segment long.
    plan, _ = build_gcn_plans_device(arrays["edge_src"][0],
                                     arrays["edge_dst"][0],
                                     arrays["edge_mask"][0], k)
    fb = plan.fallback_segments()
    fb_rows = fb.index.numel()
    cases["spmm_fallback_real"] = real(*first(main_calls, rows=fb_rows,
                                              cols=HIDDEN),
                                       f"SpMM fallback {fb_rows} x {HIDDEN} "
                                       f"unsorted into {fb.n}")
    cases["spmm_fallback"] = SegCase(
        fb.index, torch.randn((fb_rows, HIDDEN), generator=gen, device=dev),
        fb.n, False, f"SpMM fallback {fb_rows} x {HIDDEN} unsorted into "
        f"{fb.n}")

    # The main path's narrow sums: EdgeContext (E x 65), the degree sum
    # (E, 1-D), the band sum (E, 1-D, out-of-window edges at index 0).
    ctx_cols = max(HIDDEN // 2, 8) + 1
    cases["edge_context_real"] = real(*first(main_calls, rows=e,
                                             cols=ctx_cols),
                                      f"EdgeContext E={e} x {ctx_cols} "
                                      f"unsorted into {k}")
    one_d = [c for c in main_calls if c[0].dim() == 1 and c[0].shape[0] == e]
    cases["degree_real"] = real(*min(one_d, key=lambda c: c[1].n),
                                f"degree sum E={e} (1-D) unsorted into {k}")
    band = max(one_d, key=lambda c: c[1].n)
    cases["band_real"] = real(*band, f"band sum E={e} (1-D) unsorted into "
                              f"{band[1].n}")

    # region_statistics' planes (ops/region.py), unsorted pixels.
    rgb1 = rgb[None]
    planes = region_planes(arrays["segments"], im.rgb_to_lab(rgb1),
                           im.rgb_to_hsv(rgb1),
                           im.gradient_magnitude(im.rgb_to_gray(rgb1)))
    cases["region_stats"] = SegCase(segments.reshape(-1),
                                    planes.reshape(-1, planes.shape[-1]), k,
                                    False, f"region planes {IMAGE_HW}^2 x "
                                    f"{planes.shape[-1]} unsorted into {k}")

    # The clean-up's component sums (ops/connected.py _clean_mask): the
    # background clamped into the last segment; the main path's (its mask,
    # one plane) and, with keep_largest and the posterior, three planes.
    hw = IMAGE_HW * IMAGE_HW
    cases["cleanup_main_real"] = real(*first(main_calls, rows=hw, cols=1),
                                      f"clean-up {IMAGE_HW}^2 x 1 unsorted "
                                      f"into {hw}")
    mask = torch.as_tensor(cleanup_mask(IMAGE_HW), device=dev)
    labels = connected_components(mask[None] > 0).long().reshape(-1)
    clamped = labels.clamp_max(hw - 1)
    valid = (labels < hw).float()
    border = torch.zeros((IMAGE_HW, IMAGE_HW), device=dev)
    border[[0, -1], :] = 1.0
    border[:, [0, -1]] = 1.0
    post = torch.rand((hw,), generator=gen, device=dev)
    cases["cleanup_real"] = SegCase(
        clamped, torch.stack([valid, border.reshape(-1) * valid,
                              post * valid], 1), hw, False,
        f"clean-up {IMAGE_HW}^2 x 3 unsorted into {hw} (FG "
        f"{float(valid.mean()):.3f}, background in segment {hw - 1}; real "
        f"values)")

    # One rank's sum of the sharded aggregation (parallel/partition.py):
    # its messages masked as the call site masks them (padded slots 0).
    keep = arrays["edge_mask"][0] > 0
    src_np = arrays["edge_src"][0][keep].cpu().numpy()
    dst_np = arrays["edge_dst"][0][keep].cpu().numpy()
    n_pad = -(-k // PATH_RANKS) * PATH_RANKS
    _, pd, pw = partition_edges_by_dst(src_np, dst_np,
                                       np.ones(len(src_np), np.float32),
                                       n_pad, PATH_RANKS)
    pd = torch.as_tensor(pd, device=dev).long()
    pw = torch.as_tensor(pw, device=dev)
    segs = shard_segments(make_graph_mesh(PATH_RANKS, device=dev), n_pad, pd)
    shard = pd.numel() // PATH_RANKS
    for i in (0, PATH_RANKS - 1):
        msgs = torch.randn((shard, HIDDEN), generator=gen, device=dev)
        label = (f"sharded rank {i} of {PATH_RANKS}: {shard} x {HIDDEN} "
                 f"into {segs[i].n}")
        cases[f"sharded_rank{i}_real"] = SegCase(
            segs[i].index, msgs * pw[i * shard:(i + 1) * shard, None],
            segs[i].n, False, label + " (real values)", timed=i == 0)
        cases[f"sharded_rank{i}"] = SegCase(segs[i].index, msgs, segs[i].n,
                                            False, label, timed=i == 0)

    # Empty leading, inner and trailing segments, C = 6 and 1.
    r = np.random.RandomState(13)
    idx = r.randint(16, 3500, 50_000)
    idx = torch.as_tensor(idx[idx % 11 != 3], device=dev)
    vals = torch.randn((idx.numel(), 6), generator=gen, device=dev)
    cases["empty_trailing"] = SegCase(idx, vals, 4096, False,
                                      f"{idx.numel()} x 6 into 4096, "
                                      f"segments 0-15, every 11th and "
                                      f"3500-4095 empty")
    cases["empty_trailing_bf16"] = SegCase(idx, vals.bfloat16(), 4096, False,
                                           "the same in bfloat16",
                                           timed=False)
    cases["empty_trailing_1d"] = SegCase(idx, vals[:, 0].contiguous(), 4096,
                                         False, "the same, one column, 1-D",
                                         timed=False)

    # The adversarial long segments, in every dtype.
    for dtype in (torch.float32, torch.float64, torch.bfloat16,
                  torch.float16):
        a_idx, a_vals, a_n = adversarial_case(dev, dtype)
        name = "adversarial" + ("" if dtype == torch.float32
                                else "_" + str(dtype)[6:])
        cases[name] = SegCase(a_idx, a_vals, a_n, True,
                              f"adversarial {a_idx.numel()} x 6 sorted into "
                              f"{a_n}: 120 000 and 30 000-row segments of "
                              f"+-0, subnormals, +-inf, NaN",
                              timed=dtype == torch.float32)
    del main_calls, gat_calls
    return cases, arrays


def segment_bytes(values: torch.Tensor, n: int) -> int:
    """The bytes the sum must move: values, index and offsets read, the
    output written."""
    p = values.shape[0]
    c = values.numel() // max(p, 1)
    return (values.numel() + n * c) * values.element_size() + 8 * (p + n + 1)


def longest_chain(case: SegCase) -> int:
    """The most rows of one segment that are not the op's identity (not all
    +-0 for a sum, not all -inf for a maximum): for a sum, the longest
    chain of dependent adds any order-keeping sum must make (a maximum's
    rows join in any grouping, so they make no such chain)."""
    flat = case.values.reshape(case.values.shape[0], -1)
    ident = 0.0 if case.op == "sum" else float("-inf")
    live = (flat != ident).any(dim=1)
    counts = torch.bincount(case.index[live], minlength=case.n)
    return int(counts.max()) if counts.numel() else 0


def sm_clock_mhz() -> float:
    """The card's highest SM clock (MHz), as nvidia-smi reports it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, a NaN matching any NaN (its payload is the hardware's:
    the card and the CPU make different ones); +0 and -0 differ."""
    na, nb = a.isnan(), b.isnan()
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(ints), b.masked_fill(nb, 0).view(ints))


def check_segment_sum(dev) -> tuple[dict, dict]:
    """The fixed-order sums phase: (a) the kernel against its plain version
    on the card and on a CPU copy, bit for bit, at every case's shape, sums
    and maxima; (b) its time (L2-warm and cold, alone and with its sort and
    offsets) beside its bytes bound, its chain floor, the plain version and
    two one-call yardsticks the port never calls; (c) no host sync in a
    call, forward or backward.  Returns the JSON record (the region
    statistics' shape) and the graph's arrays."""
    from gcn_grabcut_torch.ops.region import (Segments, kernel_plan,
                                              long_segments, segment_max,
                                              segment_reduce_cuda,
                                              segment_reduce_plain,
                                              segment_sum)
    cases, arrays = segment_cases(dev)
    clock = sm_clock_mhz()
    record, ok = None, True
    for name, case in cases.items():
        idx, vals, n, srt = case.index, case.values, case.n, case.is_sorted
        segs = Segments(idx, n, srt)
        segs_cpu = Segments(idx.cpu(), n, srt)
        same, errs = {}, {}
        for op in ("sum", "max"):
            got = segment_reduce_cuda(vals, segs, op)
            torch.cuda.synchronize()
            plain = segment_reduce_plain(vals, segs, op)
            cpu = segment_reduce_plain(vals.cpu(), segs_cpu, op)
            same[op] = (same_bits(got, plain), same_bits(got.cpu(), cpu))
            errs[op] = float((got.cpu() - cpu).float().nan_to_num(
                0.0, 0.0, 0.0).abs().max())
            ok &= all(same[op])
        op = case.op
        lengths = segs.offsets.diff()
        cols = vals.numel() // max(vals.shape[0], 1)
        tile = kernel_plan(vals.shape[0], cols, n, vals.element_size(),
                           vals.data_ptr() % 16 == 0).tile
        n_long = int(long_segments(segs.offsets, tile).sum())
        chain = longest_chain(case)
        line = (f"segment_sum {name} ({case.label}; {str(vals.dtype)[6:]}): "
                f"kernel = plain on the card / on the CPU: sum "
                f"{same['sum'][0]} / {same['sum'][1]}, max {same['max'][0]}"
                f" / {same['max'][1]}; longest segment "
                f"{int(lengths.max())} rows, {n_long} of at least {tile} "
                f"(long); longest chain of non-identity rows ({op}) {chain}")
        if not case.timed:
            print(line, flush=True)
            continue
        ms = time_ms(lambda: segment_reduce_cuda(vals, segs, op))
        cold_ms = time_cold_ms(lambda: segment_reduce_cuda(vals, segs, op))
        call = segment_sum if op == "sum" else segment_max
        call_ms = time_ms(lambda: call(idx, vals, n, srt))
        plain_ms = time_ms(lambda: segment_reduce_plain(vals, segs, op))
        acc = torch.zeros((n,) + vals.shape[1:], device=dev, dtype=vals.dtype)
        if op == "sum":
            library_ms = time_ms(lambda: acc.index_add_(0, idx, vals))
        else:
            library_ms = time_ms(lambda: acc.index_reduce_(
                0, idx, vals, "amax", include_self=False))
        ordered = vals if segs.order is None else vals[segs.order]
        reduce_ms = time_ms(lambda: torch.segment_reduce(
            ordered, op, lengths=lengths, axis=0))
        n_bytes = segment_bytes(vals, n)
        bound = n_bytes / PEAK_BYTES_S * 1e3
        floor = chain * ADD_CYCLES / (clock * 1e3) if op == "sum" else 0.0
        library = "index_add_" if op == "sum" else "index_reduce_(amax)"
        print(f"{line}; kernel {ms:.4f} ms (L2-warm; {cold_ms:.4f} cold), "
              f"with its sort and offsets {call_ms:.4f}, plain {plain_ms:.4f}"
              f", yardsticks {library} {library_ms:.4f} and "
              f"segment_reduce(lengths) {reduce_ms:.4f};"
              f" bound {bound:.4f} ms (bytes: {n_bytes / 1e6:.2f} MB), chain "
              f"floor {floor:.4f} ms ({chain if op == 'sum' else 0} adds x "
              f"{ADD_CYCLES} cycles at {clock:.0f} MHz), share of the larger "
              f"{max(bound, floor) / ms:.3f} warm, "
              f"{max(bound, floor) / cold_ms:.3f} cold", flush=True)
        if name == "region_stats":
            record = {"name": "segment_sum", "route": "cuda",
                      "source": "gcn_grabcut_torch/csrc/segment_sum.cu",
                      "replaces": "gcn_grabcut_tpu/ops/region.py:35 (XLA "
                                  "segment_sum; no Pallas kernel)",
                      "launches": 0, "max_abs_err": errs["sum"], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": "bytes", "library_ms": library_ms,
                      "chain_floor_ms": floor, "cold_ms": cold_ms,
                      "segment_reduce_ms": reduce_ms, "call_ms": call_ms}
    if not ok:
        fail("the segment-sum kernel differs from its plain version")

    # (c) no host sync: the whole call (sort, offsets, launch), a maximum,
    # and a backward.
    case = cases["gat_messages"]
    idx, n = case.index, case.n
    vals = case.values.clone().requires_grad_(True)
    rcase = cases["region_stats"]
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        segment_sum(rcase.index, rcase.values, rcase.n)
        segment_max(idx, vals.detach(), n, is_sorted=True)
        (segment_sum(idx, vals, n, is_sorted=True) * 2.0).sum().backward()
        segment_max(idx, vals, n, is_sorted=True).sum().backward()
    except RuntimeError as e:
        fail(f"segment_sum synced the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("segment_sum host syncs per call: 0 (torch.cuda.set_sync_debug_mode"
          "('error') around a sorted and an unsorted sum, a maximum and two "
          "backwards)", flush=True)
    return record, arrays


def gather_repeats(table: torch.Tensor, idx: torch.Tensor, seed: int
                   ) -> tuple[bool, int]:
    """(whether two backwards of table[idx] give the same bits, the largest
    number of rows gathering one table row)."""
    gen = torch.Generator(device=table.device).manual_seed(seed)
    g_out = torch.randn((idx.numel(),) + table.shape[1:], generator=gen,
                        device=table.device).to(table.dtype)
    grads = []
    for _ in range(2):
        t = table.detach().clone().requires_grad_(True)
        t[idx].backward(g_out)
        grads.append(t.grad)
    dup = int(torch.bincount(idx.reshape(-1)).max())
    return torch.equal(grads[0], grads[1]), dup


def audit_gathers(dev, arrays: dict) -> None:
    """Each row gather x[idx] whose gradient the card computes, at its
    chip_smoke shape on the main path's graph: its backward twice, bit for
    bit (an index_put_ with accumulate; it fails if any differs)."""
    from gcn_grabcut_torch.models.large import build_gcn_plans_device
    from gcn_grabcut_torch.models.layers import sort_edges_by_dst
    from gcn_grabcut_torch.ops.sddmm import gat_plan_device
    from gcn_grabcut_torch.parallel.partition import (partition_edges_2d,
                                                      partition_edges_by_dst)

    gen = torch.Generator(device=dev).manual_seed(21)
    k = int(arrays["x"].shape[1])
    e_src, e_dst, e_attr, e_mask = sort_edges_by_dst(
        arrays["edge_src"], arrays["edge_dst"], arrays["edge_attr"],
        arrays["edge_mask"])
    src, dst = e_src.reshape(-1).long(), e_dst.reshape(-1).long()
    keep = arrays["edge_mask"][0] > 0
    s_np = arrays["edge_src"][0][keep].cpu().numpy()
    d_np = arrays["edge_dst"][0][keep].cpu().numpy()
    w_np = np.ones(len(s_np), np.float32)
    n_pad = -(-k // PATH_RANKS) * PATH_RANKS
    ps, _, _ = partition_edges_by_dst(s_np, d_np, w_np, n_pad, PATH_RANKS)
    s2d, _, _ = partition_edges_2d(s_np, d_np, w_np, n_pad, PATH_RANKS)
    gcn_plan, _ = build_gcn_plans_device(
        arrays["edge_src"][0], arrays["edge_dst"][0],
        arrays["edge_mask"][0], k)
    gat_plan = gat_plan_device(arrays["edge_src"][0], arrays["edge_dst"][0],
                               arrays["edge_attr"][0], arrays["edge_mask"][0],
                               k)
    r = np.random.RandomState(14)
    scatter_idx = torch.as_tensor(r.randint(0, SCATTER_SEGMENTS,
                                            SCATTER_ROWS), device=dev)

    def table(rows, *cols, dtype=torch.float32):
        return torch.randn((rows, *cols), generator=gen, device=dev
                           ).to(dtype)

    shard = len(ps) // PATH_RANKS
    sites = {
        "parallel/partition.py sharded_scatter_add x_full[s]":
            (table(n_pad, HIDDEN),
             torch.as_tensor(ps[:shard], device=dev).long()),
        "parallel/partition.py ring_scatter_add xs[j][src]":
            (table(n_pad // PATH_RANKS, HIDDEN),
             torch.as_tensor(s2d[0, 0], device=dev).long()),
        "models/layers.py GATv2Conv xl_f[src] (fp32)":
            (table(k, 8, 16), src),
        "models/layers.py GATv2Conv xl_f[src] (bf16)":
            (table(k, 8, 16, dtype=torch.bfloat16), src),
        "models/layers.py GATv2Conv xr[dst]": (table(k, 8, 16), dst),
        "models/layers.py GATv2Conv tot[dst]": (table(k, 8), dst),
        "ops/spmm.py banded_spmm xf[plan.fb_src]":
            (table(gcn_plan.n_nodes, HIDDEN), gcn_plan.fb_src),
        "ops/sddmm.py banded_gat_attention xl_flat[plan.fb_src]":
            (table(gat_plan.n_nodes, HIDDEN), gat_plan.fb_src),
        "core/scatter.py peak[index], tot[index]":
            (table(SCATTER_SEGMENTS), scatter_idx),
    }
    varying = []
    for i, (site, (tab, idx)) in enumerate(sites.items()):
        same, dup = gather_repeats(tab, idx, i)
        print(f"gather audit: {site}: table {tuple(tab.shape)} "
              f"{str(tab.dtype)[6:]}, {idx.numel()} rows, up to {dup} per "
              f"table row; two backwards bit-identical {same}", flush=True)
        if not same:
            varying.append(site)
    if varying:
        fail(f"gather backwards vary between runs: {varying}")


def graph_on_card(imgs: list, cfg, dev):
    """The port's graph batch of same-size images, built on the card."""
    import gcn_grabcut_torch as gt
    rgbs = torch.as_tensor(np.stack(imgs), device=dev).float()
    out = gt.build_graph_batch_arrays(rgbs, cfg, device=dev)
    return gt.make_graph_batch(
        x=out["x"], edge_src=out["edge_src"], edge_dst=out["edge_dst"],
        edge_attr=out["edge_attr"], node_mask=out["node_mask"],
        edge_mask=out["edge_mask"], node_area=out["node_area"])


def run_main_path(dev, record: dict, seg_record: dict,
                  cut_record: dict, build_records: dict,
                  gmm_record: dict) -> None:
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.graph_build import num_nodes_for
    from gcn_grabcut_torch.models.large import apply_large
    from gcn_grabcut_torch.ops import gmm
    from gcn_grabcut_torch.ops.connected import connected_components_cuda
    from gcn_grabcut_torch.ops.maxflow import grid_mincut_cuda
    from gcn_grabcut_torch.ops.slic import repair_connectivity_cuda
    from gcn_grabcut_torch.ops.region import segment_sum
    from gcn_grabcut_torch.ops.spmm import banded_spmm

    cfg = gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    k = num_nodes_for(IMAGE_HW, IMAGE_HW, cfg)
    if k <= gt.GCNGrabCutPipeline.LARGE_NODE_THRESHOLD:
        fail(f"K={k} does not take the large-graph path")
    model = gt.ResGCNNet(hidden_channels=HIDDEN, n_layers=N_LAYERS,
                         generator=torch.Generator().manual_seed(MODEL_SEED))
    pipe = gt.GCNGrabCutPipeline(model, cfg)
    img = make_image(IMAGE_HW)

    t = time.perf_counter()
    pipe.segment_batch([img])
    print(f"main path warm run: {time.perf_counter() - t:.3f} s", flush=True)

    banded_spmm.kernel_launches = 0
    segment_sum.kernel_launches = 0
    grid_mincut_cuda.kernel_launches = 0
    repair_connectivity_cuda.kernel_launches = 0
    connected_components_cuda.kernel_launches = 0
    gmm.CardPasses.kernel_launches = 0
    t = time.perf_counter()
    res = pipe.segment_batch([img])[0]
    wall = time.perf_counter() - t
    gmm_launches = gmm.CardPasses.kernel_launches
    launches = banded_spmm.kernel_launches
    seg_launches = segment_sum.kernel_launches
    cut_launches = grid_mincut_cuda.kernel_launches
    repair_launches = repair_connectivity_cuda.kernel_launches
    cc_launches = connected_components_cuda.kernel_launches
    record["launches"] = launches
    seg_record["launches"] = seg_launches
    cut_record["launches"] = cut_launches
    build_records["slic_connectivity"]["launches"] = repair_launches
    build_records["mask_components"]["launches"] = cc_launches
    gmm_record["launches"] = gmm_launches
    stages = " ".join(f"{s}={v:.3f}s" for s, v in res.timing.items())
    fg = float(res.binary_mask.mean())
    tri = np.bincount(res.trimap.ravel(), minlength=4) / res.trimap.size
    print(f"main path timed run (B=1, {IMAGE_HW}^2, K={k}, ResGCNNet "
          f"D={HIDDEN} n={N_LAYERS}): {wall:.3f} s; {stages}; "
          f"banded_spmm launches={launches}, segment_sum launches="
          f"{seg_launches}, grid_mincut launches={cut_launches}, "
          f"slic_connectivity launches={repair_launches}, mask_components "
          f"launches={cc_launches}, gmm_passes launches={gmm_launches}; "
          f"trimap "
          f"BG/FG/PR_BG/PR_FG="
          f"{'/'.join(f'{v:.3f}' for v in tri)}; FG fraction={fg:.4f}",
          flush=True)
    if launches != N_LAYERS + 1:
        fail(f"banded_spmm launched {launches} times, expected "
             f"{N_LAYERS + 1} per forward")
    if seg_launches == 0:
        fail("the main path launched no segment-sum kernel")
    n_iter = gt.grabcut.GrabCutConfig().n_iter
    if cut_launches != n_iter:
        fail(f"the main path launched the min-cut kernel {cut_launches} "
             f"times, expected {n_iter} (one per GrabCut iteration)")
    gc_cfg = gt.grabcut.GrabCutConfig()
    solve_passes = gmm_solve_passes(gc_cfg.n_components, gc_cfg.n_iter)
    if gmm_launches != sum(solve_passes.values()):
        fail(f"the main path launched the colour-model passes "
             f"{gmm_launches} times, expected {sum(solve_passes.values())} "
             f"(one lock-step solve)")
    if (repair_launches, cc_launches) != (1, 1):
        fail(f"the main path launched the connectivity kernel "
             f"{repair_launches} times and the components kernel "
             f"{cc_launches} times, expected 1 each (one build, one "
             f"clean-up)")
    if res.probs.shape != (k, 3) or not np.isfinite(res.probs).all():
        fail("posteriors are not finite (K, 3)")
    if not 0.0 < fg < 1.0:
        fail(f"degenerate mask (FG fraction {fg})")

    # The card's forward (bf16 kernel) against the plain forward on the
    # CPU, same graph and weights.
    g = graph_on_card([img], cfg, dev)
    logits = apply_large(pipe.model, g).float().cpu()
    g_cpu = gt.make_graph_batch(
        **{f: getattr(g, f).cpu() for f in ("x", "edge_src", "edge_dst",
                                            "edge_attr", "node_mask",
                                            "edge_mask", "node_area")},
        device="cpu")
    ref = apply_large(pipe.model.to("cpu"), g_cpu, device="cpu")
    valid = g_cpu.node_mask[0] > 0
    err = float((logits[0][valid] - ref[0][valid]).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    print(f"forward card vs CPU plain: max |dlogits|={err:.3e} "
          f"(tol {FORWARD_TOL * scale:.1e})", flush=True)
    if err > FORWARD_TOL * scale:
        fail("the card's forward disagrees with the plain CPU forward")
    return img, res.trimap


def run_sharded_path(dev, records: dict, n_nodes: int) -> None:
    """The graph-sharded forward and its gradient on the main path's graph
    and model: mesh_aggregators over PATH_RANKS ranks with the ring halo."""
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.models.large import apply_large
    from gcn_grabcut_torch.ops.region import segment_sum
    from gcn_grabcut_torch.ops.spmm import banded_spmm
    from gcn_grabcut_torch.parallel import ring

    cfg = gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    g = graph_on_card([make_image(IMAGE_HW)], cfg, dev)
    if g.max_nodes != n_nodes:
        fail(f"the graph has {g.max_nodes} nodes, the kernel phase used "
             f"{n_nodes}")
    model = gt.ResGCNNet(hidden_channels=HIDDEN, n_layers=N_LAYERS,
                         generator=torch.Generator().manual_seed(MODEL_SEED)
                         ).to(dev).eval()
    edges = [a[0].cpu().numpy() for a in (g.edge_src, g.edge_dst,
                                          g.edge_mask)]
    mesh = gt.make_graph_mesh(PATH_RANKS)
    t = time.perf_counter()
    aggs = gt.mesh_aggregators(mesh, *edges, g.max_nodes,
                               method="allgather", halo="pallas_ring")
    setup_s = time.perf_counter() - t
    c = torch.from_numpy(np.random.RandomState(7).randn(
        1, g.max_nodes, 3).astype(np.float32)).to(dev)

    def step(aggs) -> tuple:
        """Forward, then the gradient of sum(logits * c): (logits, grads,
        forward s, backward s, (K2, K3, segment sum) launch counts after
        the forward)."""
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model(g, aggregators=aggs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fwd_counts = (ring.ring_all_gather.kernel_launches,
                      ring.ring_reduce_scatter.kernel_launches,
                      segment_sum.kernel_launches)
        (logits * c).sum().backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (logits.detach(), {k: p.grad.detach().clone()
                                  for k, p in model.named_parameters()},
                t1 - t0, t2 - t1, fwd_counts)

    def same_bits(a: tuple, b: tuple) -> bool:
        """Two steps' logits and every gradient leaf bit for bit."""
        return torch.equal(a[0], b[0]) and all(
            torch.equal(a[1][k], b[1][k]) for k in a[1])

    first = step(aggs)                                  # warm, and run 1
    banded_spmm.kernel_launches = 0
    ring.ring_all_gather.kernel_launches = 0
    ring.ring_reduce_scatter.kernel_launches = 0
    segment_sum.kernel_launches = 0
    second = step(aggs)
    logits, grads, fwd_s, bwd_s, (k2_fwd, k3_fwd, seg_fwd) = second
    k2 = ring.ring_all_gather.kernel_launches
    k3 = ring.ring_reduce_scatter.kernel_launches
    k1 = banded_spmm.kernel_launches
    records["K2"]["launches"], records["K3"]["launches"] = k2, k3

    xla_aggs = gt.mesh_aggregators(mesh, *edges, g.max_nodes,
                                   method="allgather", halo="xla")
    xla_first = step(xla_aggs)                          # warm, and run 1
    xla_second = step(xla_aggs)
    _, xla_grads, xla_fwd_s, xla_bwd_s, _ = xla_second
    repeat = {"ring": same_bits(first, second),
              "plain": same_bits(xla_first, xla_second)}
    across = same_bits(second, xla_second)
    ref = apply_large(model, g, precision="highest")
    torch.cuda.synchronize()
    t = time.perf_counter()
    apply_large(model, g, precision="highest")
    torch.cuda.synchronize()
    k1_fwd_s = time.perf_counter() - t

    valid = g.node_mask[0] > 0
    err = float((logits[0][valid] - ref[0][valid]).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    # ctx.attn.bias shifts every score of a softmax alike: its exact
    # gradient is 0, so a parameter's scale is floored at 1e-3 of the
    # model's largest gradient.
    grad_err, worst = leaf_errors({k: v.cpu() for k, v in grads.items()},
                                  {k: v.cpu() for k, v in xla_grads.items()},
                                  floor=1e-3)
    print(f"sharded path ({PATH_RANKS} ranks of {g.max_nodes // PATH_RANKS}"
          f" nodes, ResGCNNet D={HIDDEN} n={N_LAYERS}, fp32): forward "
          f"{fwd_s * 1e3:.2f} ms, backward {bwd_s * 1e3:.2f} ms (plain halo:"
          f" forward {xla_fwd_s * 1e3:.2f} ms, backward "
          f"{xla_bwd_s * 1e3:.2f} ms; apply_large highest forward "
          f"{k1_fwd_s * 1e3:.2f} ms; edge partition {setup_s:.3f} s); "
          f"ring_all_gather launches={k2} ({k2_fwd} in the forward), "
          f"ring_reduce_scatter launches={k3} ({k3_fwd} in the forward), "
          f"segment_sum launches in the forward={seg_fwd}; "
          f"max |dlogits| vs apply_large highest={err:.3e} (tol "
          f"{SHARDED_FWD_TOL * scale:.1e}); worst gradient error vs plain "
          f"halo={grad_err:.3e} of max|grad| (tol {SHARDED_GRAD_TOL:.0e}; "
          f"worst leaves {worst}); two runs bit-identical: ring halo "
          f"{repeat['ring']}, plain halo {repeat['plain']}; ring halo = "
          f"plain halo bit for bit (logits, every gradient leaf) {across}",
          flush=True)
    if k2_fwd != N_LAYERS + 1 or k2 != k2_fwd:
        fail(f"ring_all_gather launched {k2_fwd} times in the forward and "
             f"{k2 - k2_fwd} in the backward, expected {N_LAYERS + 1} and 0")
    if k3_fwd != 0 or k3 != N_LAYERS + 1:
        fail(f"ring_reduce_scatter launched {k3} times, {k3_fwd} in the "
             f"forward; expected {N_LAYERS + 1}, all in the backward")
    if k1 != 0:
        fail(f"banded_spmm launched {k1} times on the sharded path")
    if logits.shape != (1, g.max_nodes, 3) or not bool(
            torch.isfinite(logits).all()):
        fail("sharded logits are not finite (1, N, 3)")
    if err > SHARDED_FWD_TOL * scale:
        fail("the sharded forward disagrees with apply_large")
    if not grad_err <= SHARDED_GRAD_TOL:
        fail("the ring-halo gradient disagrees with the plain-halo one")
    if not all(repeat.values()):
        fail(f"two sharded steps differ in their bits: {repeat}")
    if not across:
        fail("the ring-halo logits or gradients differ in their bits from "
             "the plain halo's")
    if seg_fwd == 0:
        fail("the sharded forward launched no segment-sum kernel")


def load_ensemble():
    """(model, meta) of the recommended bgc ensemble, from the checkout's
    checkpoints, on the card."""
    from pathlib import Path

    import gcn_grabcut_torch as gt
    root = Path(__file__).resolve().parent
    return gt.load_model_auto(
        ",".join(str(root / p) for p in DENSE_CHECKPOINTS))


def run_dense_path(dev, card: str) -> None:
    """The recommended configuration: the 3-member bgc ensemble read from
    the checkout's checkpoints, 500 superpixels with the geodesic prior,
    multi-scale trimaps, on DENSE_IMAGES make_image(DENSE_HW) images.
    Held against the port's CPU forward and the JAX package's outputs."""
    import copy
    from pathlib import Path

    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.ops.spmm import banded_spmm

    root = Path(__file__).resolve().parent
    ref = np.load(root / DENSE_REF)
    model, meta = load_ensemble()
    if meta["ensemble_size"] != len(DENSE_CHECKPOINTS):
        fail(f"loaded an ensemble of {meta['ensemble_size']}")
    cfg = gt.SuperpixelGraphConfig(n_segments=DENSE_SEGMENTS,
                                   bg_connectivity=True)
    pipe = gt.GCNGrabCutPipeline(model, cfg)
    images = [make_image(DENSE_HW, s) for s in range(DENSE_IMAGES)]

    t = time.perf_counter()
    pipe.segment_batch(images[:1], **DENSE_SETTINGS)
    pipe.segment_batch(images, **DENSE_SETTINGS)
    print(f"dense path warm runs (B=1, B={DENSE_IMAGES}): "
          f"{time.perf_counter() - t:.3f} s", flush=True)

    banded_spmm.kernel_launches = 0
    walls1 = []
    for b, img in enumerate(images):
        t = time.perf_counter()
        one = pipe.segment_batch([img], **DENSE_SETTINGS)[0]
        walls1.append(time.perf_counter() - t)
        print(f"  dense B=1 image {b}: {walls1[-1]:.4f} s ({split(one.timing)};"
              f" FG {one.binary_mask.mean():.4f})", flush=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = pipe.segment_batch(images, **DENSE_SETTINGS)
    torch.cuda.synchronize()
    wall8 = time.perf_counter() - t
    split8 = pipe.segment_batch(images, **DENSE_SETTINGS)[0].timing
    k1 = banded_spmm.kernel_launches
    k = res[0].probs.shape[0]
    print(f"dense path timed runs ({DENSE_HW}^2, K={k}, bgc ensemble of "
          f"{meta['ensemble_size']} x ResGCNNet D={HIDDEN} n={N_LAYERS}, "
          f"ms_scales={DENSE_SETTINGS['ms_scales']}; {card}): B=1 median "
          f"{float(np.median(walls1)):.4f} s over {len(walls1)} images; "
          f"B={DENSE_IMAGES} {wall8:.4f} s = {DENSE_IMAGES / wall8:.2f} "
          f"images/s (device split: {split(split8)}); banded_spmm "
          f"launches={k1}", flush=True)
    if k1 != 0:
        fail(f"the dense path launched banded_spmm {k1} times")
    if k > gt.GCNGrabCutPipeline.LARGE_NODE_THRESHOLD:
        fail(f"K={k} took the large-graph path")
    for r in res:
        if r.probs.shape != (k, 3) or not np.isfinite(r.probs).all():
            fail("dense posteriors are not finite (K, 3)")

    # The card's ensemble forward against the CPU's on the same graphs.
    g = graph_on_card(images, cfg, dev)
    probs = pipe._predict_probs_batch(g).cpu()
    g_cpu = gt.make_graph_batch(
        **{f: getattr(g, f).cpu() for f in ("x", "edge_src", "edge_dst",
                                            "edge_attr", "node_mask",
                                            "edge_mask", "node_area")},
        device="cpu")
    ref_cpu = gt.predict_probs(copy.deepcopy(model).cpu(), g_cpu)
    valid = g_cpu.node_mask > 0
    err = float((probs - ref_cpu)[valid].abs().max())
    print(f"dense ensemble posteriors card vs CPU: max |dp|={err:.3e} "
          f"(tol {DENSE_CPU_TOL:.0e})", flush=True)
    if err > DENSE_CPU_TOL:
        fail("the card's ensemble forward disagrees with the CPU's")

    # Against the JAX package (the committed fixture).
    ious, worst_dp = [], 0.0
    for b, r in enumerate(res):
        seg_agree = float((r.segments == ref["segments"][b]).mean())
        a, m = r.binary_mask > 0, ref["mask"][b] > 0
        ious.append(iou(a, m))
        tri_agree = float((r.trimap == ref["trimap"][b]).mean())
        dp = "n/a (labels differ)"
        if seg_agree == 1.0:
            d = float(np.abs(r.probs - ref["probs"][b]).max())
            worst_dp = max(worst_dp, d)
            dp = f"{d:.2e}"
        print(f"  image {b}: SLIC agreement {seg_agree:.6f}, max |dp| "
              f"{dp}, trimap agreement {tri_agree:.6f}, mask IoU vs JAX "
              f"{ious[-1]:.6f} (FG {a.mean():.4f} / {m.mean():.4f})",
              flush=True)
    mean_iou = float(np.mean(ious))
    print(f"dense path vs JAX: mean mask IoU {mean_iou:.6f} (min "
          f"{DENSE_MIN_IOU}), worst posterior difference {worst_dp:.2e} "
          f"(tol {DENSE_JAX_TOL:.0e})", flush=True)
    if mean_iou < DENSE_MIN_IOU:
        fail(f"mean mask IoU against JAX {mean_iou:.4f} < {DENSE_MIN_IOU}")
    if worst_dp > DENSE_JAX_TOL:
        fail("posteriors disagree with JAX where the labels agree")
    return images, [r.trimap for r in res]


def solver_tally(mf, b: int) -> dict:
    """The device solver's counts since the last reset, for a batch of
    `b`: per image (summed over the calls, each of the whole batch) outer
    rounds and push sweeps; relabel relaxation steps and host syncs in
    all.  An image that was not solved counts 0."""
    c = mf.counts
    return dict(rounds=np.sum([np.zeros(b, int), *c.rounds], axis=0).tolist(),
                sweeps=np.sum([np.zeros(b, int), *c.sweeps], axis=0).tolist(),
                relabel_steps=c.relabel_steps, syncs=c.syncs)


def run_lock_step(dev, card: str, images: list, trimaps: list) -> None:
    """Phase 15: the lock-step batched GrabCut (grabcut_batch_device, the
    whole batch as (B, H, W) tensors) against the plain image-by-image
    version (grabcut_batch_loop) on the dense phase's images and the
    trimaps the bgc ensemble gave them: masks bit for bit at every B, the
    GrabCut stage's wall s of each at B = 1, 2, 4, 8, the solver's counts
    and the lock step's peak memory at B=8."""
    from gcn_grabcut_torch import grabcut as gc
    from gcn_grabcut_torch.core.graph import TRIMAP_FG, TRIMAP_PROB_FG
    from gcn_grabcut_torch.ops import gmm as gmm_ops
    from gcn_grabcut_torch.ops import maxflow as mf

    rgb = torch.as_tensor(np.stack(images), device=dev).float()
    tri = torch.as_tensor(np.stack(trimaps), device=dev)
    n = max(LOCK_STEP_BATCHES)
    # The loop solves each image alone, so its wall at B is the sum of its
    # first B images' walls: each image is timed once.
    loop, image_walls, per_image = [], [], []
    for i in range(n):
        mf.counts.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loop.append(gc.grabcut_batch_loop(rgb[i:i + 1], tri[i:i + 1]))
        torch.cuda.synchronize()
        image_walls.append(time.perf_counter() - t)
        per_image.append(solver_tally(mf, 1))
    loop = torch.cat(loop)
    walls, lock_tallies, out, peaks = {}, {}, {}, {}
    for b in LOCK_STEP_BATCHES:
        torch.cuda.synchronize()
        mf.counts.reset()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out[b] = gc.grabcut_batch_device(rgb[:b], tri[:b])
        torch.cuda.synchronize()
        walls["lock", b] = time.perf_counter() - t
        walls["loop", b] = sum(image_walls[:b])
        peaks[b] = torch.cuda.max_memory_allocated() - base
        lock_tallies[b] = solver_tally(mf, b)
        print(f"  lock-step GrabCut B={b}: lock step {walls['lock', b]:.4f} s,"
              f" image by image {walls['loop', b]:.4f} s ({card})",
              flush=True)
    lock = out[n]
    differ = [int((lock[i] != loop[i]).sum()) for i in range(n)]
    # Every smaller batch: the loop's masks of its images.
    other = [b for b, lk in out.items() if not torch.equal(lk, loop[:b])]
    lt = lock_tallies[n]
    print(f"lock-step GrabCut counts at B={n}: per image outer rounds "
          f"{lt['rounds']}, push sweeps {lt['sweeps']}; per batch relabel "
          f"steps {lt['relabel_steps']}, solver host syncs {lt['syncs']}",
          flush=True)
    print("image by image, per image: outer rounds "
          f"{[t['rounds'][0] for t in per_image]}, push sweeps "
          f"{[t['sweeps'][0] for t in per_image]}, relabel steps "
          f"{[t['relabel_steps'] for t in per_image]}, solver host syncs "
          f"{[t['syncs'] for t in per_image]} (sums "
          f"{sum(t['relabel_steps'] for t in per_image)} / "
          f"{sum(t['syncs'] for t in per_image)})", flush=True)
    print(f"lock-step GrabCut ({n} x {DENSE_HW}^2, bgc trimaps; {card}): "
          f"wall s lock step / image by image " + ", ".join(
              f"B={b} {walls['lock', b]:.4f} / {walls['loop', b]:.4f}"
              for b in LOCK_STEP_BATCHES)
          + f"; peak memory at B={n} {peaks[n] / 2**20:.1f} MiB; masks differ "
          f"from the loop's on {differ} pixels (B={n}), smaller batches "
          f"differ at B={other}; FG "
          f"{[round(float(m.float().mean()), 4) for m in lock]}", flush=True)
    if any(differ):
        # Where the bits part: the k-means seeding and the first GMM fits.
        k = gc.GrabCutConfig().n_components
        t, _ = gc._repair(tri[:n].to(torch.uint8))
        fg = (t == TRIMAP_FG) | (t == TRIMAP_PROB_FG)
        comp = gc._initial_components(rgb[:n], fg, k)
        fits = gmm_ops.fit_gmm(rgb[:n], fg.float(), comp, k)
        for i in range(n):
            comp1 = gc._initial_components(rgb[i], fg[i], k)
            fit1 = gmm_ops.fit_gmm(rgb[i], fg[i].float(), comp[i], k)
            d = max(float((fits[name][i] - a).abs().max())
                    for name, a in fit1.items())
            print(f"  image {i}: {differ[i]} pixels differ; k-means labels "
                  f"differ on {int((comp1 != comp[i]).sum())}; largest |d| "
                  f"of the first fit's GMM parameters {d:.3e}", flush=True)
        fail("the lock-step GrabCut's masks differ from the loop's")
    if other:
        fail(f"the lock step's masks at B={other} differ from the loop's")
    if not all(np.isfinite(list(walls.values()))) or lock.shape != loop.shape:
        fail("the lock-step phase gave no masks or times")


def recorded_solves(fn, *args) -> list:
    """Runs fn(*args) recording every min-cut solve it makes (the calls of
    grid_mincut_batch by grabcut.py and inside ops/maxflow.py):
    [(excess, r_fwd, r_bwd, options)]."""
    from gcn_grabcut_torch import grabcut as gc
    from gcn_grabcut_torch.ops import maxflow as mf
    solve, calls = mf.grid_mincut_batch, []
    signature = inspect.signature(solve)

    def recording(*args, **kwargs):
        kw = signature.bind(*args, **kwargs).arguments
        calls.append((kw.pop("excess"), tuple(kw.pop("r_fwd")),
                      tuple(kw.pop("r_bwd")), kw))
        return solve(*args, **kwargs)

    gc.grid_mincut_batch = mf.grid_mincut_batch = recording
    try:
        fn(*args)
    finally:
        gc.grid_mincut_batch = mf.grid_mincut_batch = solve
    return calls


def mincut_work(excess, r_fwd, r_bwd, conn: int, opts: dict) -> dict:
    """What a solve of these planes must touch whatever the design,
    counted on the data by a run of its plain version (grid_mincut_plain,
    its push sweeps and relax blocks watched): `swept`, the pixels of the
    live images over the push sweeps; `active`, those of them whose window
    (ops.maxflow.sweep_halo pixels each way, the reach of a sweep) held a
    pixel that can push or lift (e > 0 and h < INF) as the sweep began, or
    that hold a -0, which the sweep turns into +0 -- every other pixel
    leaves the sweep with the bits it had; `relaxed`, the pixels over the
    relax blocks whose heights can move: each pixel of a relabel's first
    block, then those within the block's steps (along the lattice's arcs)
    of a height that the block before lowered."""
    import torch.nn.functional as F
    from gcn_grabcut_torch.ops import maxflow as mf
    reach_r = mf.sweep_halo(conn)
    zero = torch.zeros((), dtype=torch.int64, device=excess.device)
    work = dict(swept=zero.clone(), active=zero.clone(),
                relaxed=zero.clone())
    lowered = [None]
    sweep, relax, relabel = mf.push_sweep, mf.relax_steps, mf.global_relabel

    def within(mask, steps):
        m = mask.float()
        if conn == 8:
            return F.max_pool2d(m, 2 * steps + 1, stride=1, padding=steps) > 0
        for _ in range(steps):
            p = F.pad(m, (1, 1, 1, 1))
            m = torch.maximum(m, torch.maximum(
                torch.maximum(p[..., 1:-1, :-2], p[..., 1:-1, 2:]),
                torch.maximum(p[..., :-2, 1:-1], p[..., 2:, 1:-1])))
        return m > 0

    def counting_sweep(e, hp, rf, rbp, fp, offsets, inf):
        h = mf._view(hp, 0, 0)
        m = (e > 0) & (h < inf)
        near = F.max_pool2d(m.float(), 2 * reach_r + 1, stride=1,
                            padding=reach_r) > 0
        for x in (e, *rf, *(mf._view(r, 0, 0) for r in rbp)):
            near |= (x == 0) & torch.signbit(x)
        work["swept"] += e.numel()
        work["active"] += near.sum()
        sweep(e, hp, rf, rbp, fp, offsets, inf)

    def counting_relabel(*args):
        lowered[0] = None
        return relabel(*args)

    def counting_relax(bufs, cur, arcs, steps):
        before = mf._view(bufs[cur], 0, 0).clone()
        out = relax(bufs, cur, arcs, steps)
        if lowered[0] is None:
            work["relaxed"] += before.numel()
        else:
            work["relaxed"] += within(lowered[0], steps).sum()
        lowered[0] = mf._view(bufs[out], 0, 0) < before
        return out

    mf.push_sweep, mf.relax_steps = counting_sweep, counting_relax
    mf.global_relabel = counting_relabel
    try:
        mf.grid_mincut_plain(excess, r_fwd, r_bwd, conn, **opts)
    finally:
        mf.push_sweep, mf.relax_steps, mf.global_relabel = (
            sweep, relax, relabel)
    return {k: int(v) for k, v in work.items()}


def mincut_bytes(work: dict, tally: dict, shape: tuple, n_dirs: int,
                 max_outer: int) -> int:
    """Bytes a solve must move whatever the design, each value it needs
    read once and each it changes written once, from the data's counts
    (`work`, mincut_work) and the rounds (per pixel: a relabel's set-up
    reads e and the residuals and writes the heights and one byte of arcs,
    9 + 8 D; a round test reads e and the heights, 8; the final fg, 5; a
    push sweep reads e and the height of every live pixel, 8, which decide
    whether its window can push or lift, and where it can reads and writes
    e, the height and both residual planes of each direction, 16 + 16 D in
    all; a relax block of `unroll` steps reads the heights and arcs and
    writes the heights of each pixel whose heights can move, 9).  A relax
    block is charged, not each of its steps: the solve tests only a
    block's last step, so the steps inside a block need never reach
    memory, and a bound per step would not bound a kernel that keeps them
    on chip.  No count comes from the kernel, so a design that skips less
    does not loosen its bound."""
    B, H, W = shape
    rounds = np.asarray(tally["rounds"], np.int64)
    tests = int(np.minimum(rounds + 1, max_outer).sum())
    per_pixel = (int((2 + rounds).sum()) * (9 + 8 * n_dirs) + tests * 8
                 + B * 5)
    return int(per_pixel * H * W + 8 * work["swept"]
               + (8 + 16 * n_dirs) * work["active"] + 9 * work["relaxed"])


def mincut_design(tally: dict, shape: tuple, n_dirs: int, n_sweeps: int,
                  max_outer: int, unroll: int) -> dict:
    """Bytes the kernel (csrc/grid_mincut.cu) moves, from its launch's
    grid and tallies: `sweep`, a push sweep's per pixel of the tiles it
    sweeps (a tile reads e and both residual planes of each direction over
    its window -- the tile and `halo` pixels round it -- and the heights
    one pixel further, and writes them for the tile alone; skipped tiles
    move nothing); `relax_tile`, a relax tile's per sub-block (its heights
    and arc bits over a window k pixels wider each way for k steps,
    heights written for the tile), the mean over a block's ceil(unroll /
    relax_halo) sub-blocks; a stopped image's heights copied once; the
    set-ups, round tests and fg as mincut_bytes charges them; `bytes`,
    the solve's."""
    B, H, W = shape
    th, tw, r = tally["tile_h"], tally["tile_w"], tally["halo"]
    state = 4 + 8 * n_dirs
    sweep = ((state * (th + 2 * r) * (tw + 2 * r)
              + 4 * (th + 2 * r + 2) * (tw + 2 * r + 2)) / (th * tw)
             + state + 4)
    rh, rw, rk = tally["relax_tile_h"], tally["relax_tile_w"], tally[
        "relax_halo"]
    tile, subs, left = 0.0, 0, unroll
    while left:
        k = min(rk, left)
        tile += 5 * (rh + 2 * k) * (rw + 2 * k) + 4 * rh * rw
        subs += 1
        left -= k
    tile /= subs
    rounds = np.asarray(tally["rounds"], np.int64)
    tests = int(np.minimum(rounds + 1, max_outer).sum())
    tiles = sweep_tiles(tally, shape, n_sweeps)
    swept = tally["swept_tiles"] / tiles if tiles else 0.0
    per_pixel = (int((2 + rounds).sum()) * (9 + 8 * n_dirs) + tests * 8
                 + int(rounds.sum()) * n_sweeps * swept * sweep + B * 5)
    total = (per_pixel * H * W + tally["relax_tiles"] * tile
             + tally["image_copies"] * 8 * H * W)
    return dict(sweep=sweep, relax_tile=tile, bytes=int(total))


def sweep_tiles(tally: dict, shape: tuple, n_sweeps: int) -> int:
    """Tiles the kernel's push sweeps covered, swept or skipped: each live
    image's tiles in each of its sweeps."""
    _, H, W = shape
    per = -(-H // tally["tile_h"]) * -(-W // tally["tile_w"])
    return int(np.sum(tally["rounds"])) * n_sweeps * per


def barrier_us(shape: tuple, connectivity: int = 8) -> float:
    """Device microseconds of one empty grid-wide barrier on the grid the
    min-cut kernel launches for this (B, H, W)."""
    from gcn_grabcut_torch.ops import maxflow as mf
    _, H, W = shape
    dev = torch.device("cuda")
    return loop_barrier_us(
        lambda n: mf.barrier_loop_cuda(connectivity, H, W, n, dev))


def mincut_case(name: str, excess, r_fwd, r_bwd, kw: dict, card: str
                ) -> dict:
    """One solve by the kernel (grid_mincut_batch on the card) and by its
    plain version (grid_mincut_plain on the card): every output and count
    bit for bit, the kernel's time (device, 3 calls) and the plain
    version's (wall, synchronised), the bytes bound, the design's traffic,
    the barrier floor and the launch's tiles.  Fails on any differing bit
    or count."""
    from gcn_grabcut_torch.ops import maxflow as mf
    conn = kw.get("connectivity", 8)
    opts = {k: v for k, v in kw.items() if k != "connectivity"}
    mf.counts.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = mf.grid_mincut_plain(excess, r_fwd, r_bwd, conn, **opts)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    plain_rounds, plain_steps = mf.counts.rounds[0], mf.counts.relabel_steps
    mf.counts.reset()
    before = mf.grid_mincut_cuda.kernel_launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = mf.grid_mincut_batch(excess, r_fwd, r_bwd, conn, **opts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = mf.grid_mincut_cuda.kernel_launches - before
    syncs = mf.counts.syncs
    rounds, steps = mf.counts.rounds[0], mf.counts.relabel_steps
    pairs = list(zip(
        ["fg", "e"] + [f"r_fwd[{d}]" for d in range(len(r_fwd))]
        + [f"r_bwd[{d}]" for d in range(len(r_bwd))],
        (got[0], got[1], *got[2], *got[3]),
        (want[0], want[1], *want[2], *want[3])))
    differ = [k for k, a, b in pairs if not same_bits(a, b)]
    max_err = max(float((a.float() - b.float()).abs().max())
                  for _, a, b in pairs)
    if not np.array_equal(rounds, plain_rounds):
        differ.append("rounds")
    if steps != plain_steps:
        differ.append("relabel steps")
    # The launch's barriers, image-steps and grid, as `counts` keeps them.
    (tally,) = mf.counts.kernel_tallies
    unroll = opts.get("unroll", 4)
    n_sweeps = mf._n_sweeps(opts.get("sweeps_per_round", 48), unroll)

    def kernel_call():
        mf.grid_mincut_batch(excess, r_fwd, r_bwd, conn, **opts)

    ms = time_ms(kernel_call, reps=3, warmup=1)
    shape = tuple(excess.shape)
    max_outer = opts.get("max_outer", 400)
    work = mincut_work(excess, r_fwd, r_bwd, conn, opts)
    bound_ms = (mincut_bytes(work, tally, shape, conn // 2, max_outer)
                / PEAK_BYTES_S * 1e3)
    design = mincut_design(tally, shape, conn // 2, n_sweeps, max_outer,
                           unroll)
    design_ms = design["bytes"] / PEAK_BYTES_S * 1e3
    floor_ms = tally["barriers"] * barrier_us(shape, conn) / 1e3
    tiles = sweep_tiles(tally, shape, n_sweeps)
    print(f"  min-cut {name} ({'x'.join(map(str, shape))}, {conn}-conn"
          f"{', ' + str(opts) if opts else ''}): kernel {ms:.4f} ms, plain "
          f"{plain_s * 1e3:.4f} ms (wall); launches {launches}, host syncs "
          f"{syncs}; rounds {rounds.tolist()}, relabel steps {steps} "
          f"(image-steps relaxed {tally['relabel_image_steps']}, height "
          f"copies {tally['image_copies']}), barriers {tally['barriers']}, "
          f"sweep tiles {tiles}: {tally['swept_tiles']} swept, "
          f"{tiles - tally['swept_tiles']} skipped; relax tiles "
          f"{tally['relax_tiles']} relaxed; the data's work: pixels swept "
          f"{work['swept']}, {work['active']} of them in an active window "
          f"({work['active'] / max(work['swept'], 1):.4f}), pixels relaxed "
          f"{work['relaxed']}; bytes bound {bound_ms:.4f} ms (the design's "
          f"traffic {design_ms:.4f} ms: a sweep {design['sweep']:.2f} B a "
          f"pixel of its tiles, a relax tile {design['relax_tile']:.0f} B a "
          f"sub-block), barrier floor {floor_ms:.4f} ms; sweep tile "
          f"{tally['tile_h']}x{tally['tile_w']} halo {tally['halo']}, relax "
          f"tile {tally['relax_tile_h']}x{tally['relax_tile_w']} halo <= "
          f"{tally['relax_halo']}, {tally['smem_bytes']} B of dynamic "
          f"shared memory a block; grid {tally['blocks']} blocks of 256 "
          f"({tally['blocks_per_sm']} a SM, {tally['registers']} "
          f"registers); bits {'differ: ' + ', '.join(differ) if differ else 'equal'}"
          f" ({card})", flush=True)
    if differ or launches != 1 or syncs:
        fail(f"the min-cut kernel disagrees with its plain version on "
             f"{name}: {differ or 'launches / syncs'}")
    return dict(ms=ms, plain_ms=plain_s * 1e3, bound_ms=bound_ms,
                design_ms=design_ms, floor_ms=floor_ms, max_abs_err=max_err,
                barriers=tally["barriers"])


def run_mincut_kernel(dev, card: str, cut_record: dict, main_image: tuple,
                      dense: tuple) -> None:
    """Phase 16: the min-cut kernel (csrc/grid_mincut.cu) against its plain
    version on the card, bit for bit, on the solves of the main path's
    GrabCut (its first iteration at 1536^2, recorded at the wrapper), the
    dense phase's 8 images in lock step (their first and second,
    flow-recycled, iterations), the first of those bound by max_outer, and
    grid_mincut_multilevel (levels=1) on the main path's first-iteration
    energy (its coarse and banded solves)."""
    from gcn_grabcut_torch import grabcut as gc

    img, trimap = main_image
    large = recorded_solves(
        gc.grabcut_batch_device,
        torch.as_tensor(img[None], device=dev).float(),
        torch.as_tensor(trimap[None], device=dev))
    images, trimaps = dense
    batch = recorded_solves(
        gc.grabcut_batch_device,
        torch.as_tensor(np.stack(images), device=dev).float(),
        torch.as_tensor(np.stack(trimaps), device=dev))
    excess, r_fwd, _, _ = large[0]
    ml = recorded_solves(lambda: gc.grid_mincut_multilevel(
        excess[0], tuple(r[0] for r in r_fwd), levels=1))
    cases = [("large cell, iteration 1", *large[0]),
             ("dense B=8 lock step, iteration 1", *batch[0]),
             ("dense B=8 lock step, iteration 2", *batch[1]),
             (f"dense B=8 iteration 1, max_outer={CUT_BOUND_OUTER}",
              *batch[0][:3], dict(batch[0][3], max_outer=CUT_BOUND_OUTER))]
    cases += [(f"multilevel levels=1, solve {i + 1}", *c)
              for i, c in enumerate(ml)]
    results = {name: mincut_case(name, *args, card=card)
               for name, *args in cases}
    main = results[cases[0][0]]
    cut_record.update({
        "name": "grid_mincut", "route": "cuda",
        "source": "gcn_grabcut_torch/csrc/grid_mincut.cu",
        "replaces": "gcn_grabcut_tpu/ops/maxflow.py:67 (_build_solver's "
                    "lax.while_loops; XLA, not Pallas)",
        "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "bytes",
        "design_traffic_ms": main["design_ms"],
        "barrier_floor_ms": main["floor_ms"], "barriers": main["barriers"],
        "library_ms": None})


def unpack_mask(packed: np.ndarray, hw: int) -> np.ndarray:
    return np.unpackbits(packed, count=hw * hw).reshape(hw, hw)


def unpack_trimap(planes: np.ndarray, hw: int) -> np.ndarray:
    return unpack_mask(planes[0], hw) | (unpack_mask(planes[1], hw) << 1)


def iou(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a > 0, b > 0
    return float((a & b).sum() / (a | b).sum()) if (a | b).any() else 1.0


def split(timing: dict) -> str:
    return " ".join(f"{s}={v:.4f}s" for s, v in timing.items())


def run_staged_paths(card: str) -> None:
    """Items 1-5: the staged options, segment_bbox and the GrabCut class
    at the recommended configuration, held against the JAX fixture; the
    native solver against the device solver on the same trimaps."""
    from pathlib import Path

    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch import native
    from gcn_grabcut_torch.ops.spmm import banded_spmm

    root = Path(__file__).resolve().parent
    ref = np.load(root / STAGED_REF)
    if tuple(ref["seeds"]) != STAGED_SEEDS:
        fail(f"{STAGED_REF} holds seeds {ref['seeds']}, not {STAGED_SEEDS}")
    model, _ = load_ensemble()
    cfg = gt.SuperpixelGraphConfig(n_segments=DENSE_SEGMENTS,
                                   bg_connectivity=True)
    pipe = gt.GCNGrabCutPipeline(model, cfg)
    native_pipe = gt.GCNGrabCutPipeline(
        model, cfg, gt.GrabCutConfig(backend="native"))
    t = time.perf_counter()
    native.load()
    print(f"native min-cut build and load: {time.perf_counter() - t:.2f} s",
          flush=True)
    images = [staged_image(s) for s in STAGED_SEEDS]
    pipe.segment(images[0], edge_aware=False, **STAGED_SETTINGS)    # warm

    banded_spmm.kernel_launches = 0
    ious: dict = {}
    for i, (seed, img) in enumerate(zip(STAGED_SEEDS, images)):
        runs = {
            "edge_off": (lambda: pipe.segment(img, edge_aware=False,
                                              **STAGED_SETTINGS), "device"),
            "refine": (lambda: pipe.segment(img, refine_iters=STAGED_REFINE,
                                            **STAGED_SETTINGS), "device"),
            "native": (lambda: native_pipe.segment(img, **STAGED_SETTINGS),
                       "native"),
            "bbox": (lambda: pipe.segment_bbox(img, STAGED_BBOX), "device")}
        for name, (run, backend) in runs.items():
            t = time.perf_counter()
            res = run()
            wall = time.perf_counter() - t
            want = unpack_mask(ref[f"{name}_mask"][i], DENSE_HW)
            want_tri = unpack_trimap(ref[f"{name}_trimap"][i], DENSE_HW)
            ious.setdefault(name, []).append(iou(res.binary_mask, want))
            tri_agree = float((res.trimap == want_tri).mean())
            print(f"  staged {name} seed {seed} ({backend}): {wall:.4f} s "
                  f"({split(res.timing)}); FG {res.binary_mask.mean():.4f} "
                  f"(JAX {want.mean():.4f}); mask IoU vs JAX "
                  f"{ious[name][-1]:.6f}; trimap agreement {tri_agree:.6f}",
                  flush=True)
            if name == "bbox" and tri_agree != 1.0:
                fail(f"segment_bbox's trimap differs from JAX's (seed "
                     f"{seed})")
            if name == "native":
                compare_solvers(img, res.trimap, card)
        for cs in STAGED_COLOUR_SPACES:
            gc = gt.GrabCut(img, gt.GrabCutConfig(color_space=cs))
            t = time.perf_counter()
            first = gc.run_with_bbox(STAGED_BBOX)
            t_box = time.perf_counter() - t
            refined = gc.refine(STAGED_REFINE)
            t_refine = time.perf_counter() - t - t_box
            for step, mask, secs in (("bbox", first, t_box),
                                     ("refine", refined, t_refine)):
                key = f"{cs}_{step}"
                want = unpack_mask(ref[f"{key}_mask"][i], DENSE_HW)
                ious.setdefault(key, []).append(iou(mask, want))
                print(f"  GrabCut {cs} {step} seed {seed} "
                      f"({gc._backend}): {secs:.4f} s; FG {mask.mean():.4f} "
                      f"(JAX {want.mean():.4f}); mask IoU vs JAX "
                      f"{ious[key][-1]:.6f}", flush=True)
            if [h.tag for h in gc.history] != ["bbox_init", "refinement"]:
                fail(f"GrabCut history {[h.tag for h in gc.history]}")
    k1 = banded_spmm.kernel_launches
    worst = min((float(np.mean(v)), k) for k, v in ious.items())
    print(f"staged paths vs JAX ({DENSE_HW}^2, K=484, bgc ensemble; "
          f"{card}): mean mask IoU per item "
          f"{', '.join(f'{k} {np.mean(v):.6f}' for k, v in ious.items())}; "
          f"banded_spmm launches={k1}", flush=True)
    if worst[0] < DENSE_MIN_IOU:
        fail(f"staged item {worst[1]}: mean mask IoU against JAX "
             f"{worst[0]:.4f} < {DENSE_MIN_IOU}")
    if k1 != 0:
        fail(f"the 512 px staged paths launched banded_spmm {k1} times")


def compare_solvers(img: np.ndarray, trimap: np.ndarray, card: str) -> None:
    """The GrabCut class from one trimap with the native solver and with
    the device solver: whole-solve times, and the native min-cuts' own
    host time."""
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch import native

    cut_s = []
    solve = native.grid_mincut_native

    def timed_cut(*args, **kwargs):
        t = time.perf_counter()
        out = solve(*args, **kwargs)
        cut_s.append(time.perf_counter() - t)
        return out

    native.grid_mincut_native = timed_cut
    try:
        times = {}
        masks = {}
        for backend in ("native", "device"):
            gc = gt.GrabCut(img, gt.GrabCutConfig(backend=backend))
            torch.cuda.synchronize()
            t = time.perf_counter()
            masks[backend] = gc.run_with_trimap(trimap)
            times[backend] = time.perf_counter() - t
    finally:
        native.grid_mincut_native = solve
    n = len(cut_s)
    print(f"  GrabCut solver, same trimap ({card}): native "
          f"{times['native']:.4f} s per solve ({n} host cuts, "
          f"{1e3 * sum(cut_s) / max(n, 1):.2f} ms each), device "
          f"{times['device']:.4f} s per solve; mask IoU native vs device "
          f"{iou(masks['native'], masks['device']):.6f}", flush=True)


def run_stream(card: str) -> None:
    """Item 6: segment_stream against segment_batch on the same chunks,
    beside segment_batch against itself."""
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.ops.spmm import banded_spmm

    model, _ = load_ensemble()
    pipe = gt.GCNGrabCutPipeline(model, gt.SuperpixelGraphConfig(
        n_segments=DENSE_SEGMENTS, bg_connectivity=True))
    images = [make_image(DENSE_HW, s) for s in STREAM_SEEDS]
    chunks = [images[i:i + STREAM_BATCH]
              for i in range(0, len(images), STREAM_BATCH)]

    def agreement(a, b) -> tuple[float, float]:
        """(least mask pixel agreement, least trimap agreement) over a
        run's images."""
        return (min(float((x.binary_mask == y.binary_mask).mean())
                    for x, y in zip(a, b)),
                min(float((x.trimap == y.trimap).mean())
                    for x, y in zip(a, b)))

    first = pipe.segment_batch(chunks[0], **DENSE_SETTINGS)
    again = pipe.segment_batch(chunks[0], **DENSE_SETTINGS)
    self_agree = agreement(first, again)
    banded_spmm.kernel_launches = 0
    t = time.perf_counter()
    stream = list(pipe.segment_stream(images, batch_size=STREAM_BATCH,
                                      **DENSE_SETTINGS))
    wall = time.perf_counter() - t
    k1 = banded_spmm.kernel_launches
    t = time.perf_counter()
    batch = [r for c in chunks
             for r in pipe.segment_batch(c, **DENSE_SETTINGS)]
    batch_wall = time.perf_counter() - t
    stream_agree = agreement(stream, batch)
    print(f"segment_stream ({len(images)} images in chunks of "
          f"{STREAM_BATCH}; {card}): {wall:.4f} s, segment_batch on the same "
          f"chunks {batch_wall:.4f} s; stream vs batch: least mask agreement "
          f"{stream_agree[0]:.6f}, trimap {stream_agree[1]:.6f}; batch vs "
          f"batch on chunk 0: mask {self_agree[0]:.6f}, trimap "
          f"{self_agree[1]:.6f}; banded_spmm launches={k1}", flush=True)
    if k1 != 0:
        fail(f"segment_stream at {DENSE_HW} px launched banded_spmm {k1} "
             "times")
    if len(stream) != len(images):
        fail(f"segment_stream yielded {len(stream)} of {len(images)} results")
    if stream_agree[0] < self_agree[0] or stream_agree[1] < self_agree[1]:
        fail("segment_stream agrees with segment_batch less than "
             "segment_batch with itself")


def run_predict_probs(card: str) -> None:
    """Item 7: predict_probs(build_graph(...)) on the main path's image and
    model: (K, 3) numpy through the banded SpMM, against segment_batch's
    posteriors on that image."""
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.ops.spmm import banded_spmm

    cfg = gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    model = gt.ResGCNNet(hidden_channels=HIDDEN, n_layers=N_LAYERS,
                         generator=torch.Generator().manual_seed(MODEL_SEED))
    pipe = gt.GCNGrabCutPipeline(model, cfg)
    img = make_image(IMAGE_HW)
    t = time.perf_counter()
    graph = gt.build_graph(img, cfg)
    build_s = time.perf_counter() - t
    pipe.predict_probs(graph)                                   # warm
    banded_spmm.kernel_launches = 0
    t = time.perf_counter()
    probs = pipe.predict_probs(graph)
    wall = time.perf_counter() - t
    k1 = banded_spmm.kernel_launches
    res = pipe.segment_batch([img])[0]
    seg_agree = float((res.segments == graph.segments).mean())
    differ = res.segments != graph.segments
    same = np.ones(graph.n_nodes, bool)
    same[res.segments[differ]] = False
    same[graph.segments[differ]] = False
    valid = (graph.node_mask > 0) & same
    dp = float(np.abs(probs - res.probs)[valid].max())
    print(f"predict_probs(RegionGraph) ({IMAGE_HW}^2, K={graph.n_nodes}, "
          f"ResGCNNet D={HIDDEN} n={N_LAYERS}; {card}): build_graph "
          f"{build_s:.4f} s, predict_probs {wall:.4f} s, banded_spmm "
          f"launches={k1}; vs segment_batch: SLIC agreement {seg_agree:.6f}, "
          f"max |dp| {dp:.3e} on {int(valid.sum())} nodes (tol "
          f"{PREDICT_TOL:.0e}), exactly equal: "
          f"{bool(np.array_equal(probs, res.probs))}", flush=True)
    if not isinstance(probs, np.ndarray) or probs.shape != (graph.n_nodes, 3):
        fail("predict_probs did not return (K, 3) numpy")
    if k1 != N_LAYERS + 1:
        fail(f"predict_probs launched banded_spmm {k1} times, expected "
             f"{N_LAYERS + 1}")
    if seg_agree < 0.999 or dp > PREDICT_TOL:
        fail("predict_probs disagrees with segment_batch's posteriors")

    # The SpMM plans and degree add in a fixed order: two forwards of one
    # graph give the same bits.
    from gcn_grabcut_torch.models.large import apply_large
    from gcn_grabcut_torch.ops.region import segment_sum
    runs = []
    for _ in range(2):
        segment_sum.kernel_launches = 0
        runs.append(apply_large(pipe.model, graph.graph))
    launches = segment_sum.kernel_launches
    same = bool(torch.equal(runs[0], runs[1]))
    print(f"apply_large twice on one {IMAGE_HW}^2 graph (K={graph.n_nodes}): "
          f"bit-identical logits {same}; segment_sum launches per large "
          f"forward {launches}; predict_probs vs segment_batch max |dp| "
          f"{dp:.3e}", flush=True)
    if not same:
        fail("two apply_large runs on the same graph differ")
    if launches == 0:
        fail("apply_large launched no segment-sum kernel")


def leaf_errors(got: dict, want: dict, floor: float = TRAIN_GRAD_FLOOR
                ) -> tuple[float, str]:
    """(max over gradient leaves of |got - want| / the leaf's scale, the
    scale floored at `floor` of the largest gradient; the three worst
    leaves with their errors and scales' shares of the largest, as
    text)."""
    gmax = max(float(v.abs().max()) for v in want.values())
    errs = []
    for k, v in want.items():
        scale = max(float(v.abs().max()), floor * gmax)
        errs.append((float((got[k].cpu() - v).abs().max()) / scale, k,
                     float(v.abs().max()) / gmax))
    errs.sort(reverse=True)
    return errs[0][0], "; ".join(
        f"{name} {err:.1e}, |grad| {share:.1e} of the largest"
        for err, name, share in errs[:3])


def run_train_step(dev, card: str, variant: str = "resgcn",
                   graphs: list | None = None) -> list:
    """Phase (a): one fp32 training step at the flagship width on
    TRAIN_GRAPHS prepared hard-synthetic graphs (prepared here unless
    given), on the card against the port's CPU step: ResGCNNet from the
    bgc_s42 weights, the GCN and GAT variants from VARIANT_SEED's numpy
    weights.  Returns the graphs (on the card)."""
    import tempfile
    from pathlib import Path

    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.train.trainer import TrainConfig, Trainer

    root = Path(__file__).resolve().parent
    cfg = gt.SuperpixelGraphConfig(n_segments=DENSE_SEGMENTS,
                                   bg_connectivity=True)
    t = time.perf_counter()
    if graphs is None:
        samples = gt.make_hard_synthetic_dataset(TRAIN_GRAPHS, DENSE_HW,
                                                 seed=EVAL_SEED + 1)
        graphs = [r[0] for r in gt.prepare_dataset(samples, cfg)]
    prep_s = time.perf_counter() - t
    kw = dict(hidden_channels=HIDDEN, n_layers=N_LAYERS, dropout=0.0)
    tcfg = TrainConfig(bf16=False, prior_dropout=0.0, weight_decay=3e-4,
                       batch_size=TRAIN_GRAPHS, verbose=False)
    start = TRAIN_START if variant == "resgcn" else \
        f"init_model_numpy({VARIANT_SEED})"

    def load_start(tr):
        if variant == "resgcn":
            tr.load(str(root / TRAIN_START))
        else:
            gt.init_model_numpy(tr.model, VARIANT_SEED)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            tr = Trainer(variant, kw, tcfg, save_dir=tmp, device=device)
            batch = tr._bucket(graphs)
            tr._init_state(1)
            load_start(tr)
            w = torch.ones(batch.n_graphs, device=device)
            if name == "card":              # run 1 (warm), then timed run 2
                first = tr.loss_and_grads(batch, w)
                first = (float(first[0]),
                         {k: g.cpu() for k, g in first[1].items()})
                load_start(tr)
                torch.cuda.synchronize()
            t = time.perf_counter()
            loss, grads = tr.loss_and_grads(batch, w)
            tr.optimizer.step(grads)
            if name == "card":
                torch.cuda.synchronize()
            out[name] = dict(
                loss=float(loss), s=time.perf_counter() - t,
                grads={k: g.cpu() for k, g in grads.items()},
                mean=tr.model.in_norm.running_mean.cpu(),
                var=tr.model.in_norm.running_var.cpu(),
                params={k: p.detach().cpu()
                        for k, p in tr.optimizer.params.items()})
    c, h = out["card"], out["cpu"]
    repeat = first[0] == c["loss"] and all(
        torch.equal(first[1][k], c["grads"][k]) for k in c["grads"])
    loss_err = abs(c["loss"] - h["loss"]) / abs(h["loss"])
    grad_err, worst = leaf_errors(c["grads"], h["grads"])
    stats_err = max(float((c["mean"] - h["mean"]).abs().max()),
                    float((c["var"] - h["var"]).abs().max()))
    upd_err = max(float((c["params"][k] - h["params"][k]).abs().max())
                  for k in h["params"])
    print(f"training step, card vs CPU ({TRAIN_GRAPHS} x {DENSE_HW}^2 "
          f"hard-synthetic graphs, K={graphs[0].max_nodes}, {variant} "
          f"D={HIDDEN} n={N_LAYERS} fp32 from {start}; {card}): "
          f"prepare {prep_s:.3f} s, step {1e3 * c['s']:.2f} ms on the card "
          f"({h['s']:.2f} s on the CPU); loss {c['loss']:.6f} rel err "
          f"{loss_err:.2e} (tol {TRAIN_LOSS_TOL:.0e}); gradient err "
          f"{grad_err:.2e} of each leaf's scale (tol {TRAIN_GRAD_TOL:.0e}; "
          f"worst {worst}); "
          f"running stats |d| {stats_err:.2e} (tol {TRAIN_STATS_TOL:.0e}); "
          f"params after the AdamW step |d| {upd_err:.2e}; two card steps "
          f"bit-identical (loss, every gradient leaf) {repeat}", flush=True)
    if not (loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
            and stats_err <= TRAIN_STATS_TOL):
        fail("the card's training step disagrees with the CPU's")
    if not repeat:
        fail(f"two {variant} training steps on the card differ in their "
             f"bits")
    return graphs


def run_train_cli(graphs: list, card: str, variant: str = "resgcn",
                  save_dir=None) -> None:
    """Phase (b): cli.train --model `variant` at the flagship recipe (bf16,
    AdamW with weight decay 3e-4 and SGDR) on TRAIN_CLI_SAMPLES
    hard-synthetic 512 px images for 2 epochs; its checkpoint reloads to
    the same bits.  The files stay in `save_dir` when one is given."""
    import json
    import tempfile
    from pathlib import Path

    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.cli import train as train_cli
    from gcn_grabcut_torch.train import trainer as trainer_mod

    seen, step_s = {}, []
    fit, step = trainer_mod.Trainer.fit, trainer_mod.Trainer.train_step

    def recording_fit(self, *args, **kwargs):
        seen["trainer"] = self
        return fit(self, *args, **kwargs)

    def timed_step(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(self, *args, **kwargs)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return loss

    trainer_mod.Trainer.fit = recording_fit
    trainer_mod.Trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = str(save_dir or tmp)
        try:
            t = time.perf_counter()
            history = train_cli.main([
                "--hard-synthetic", str(TRAIN_CLI_SAMPLES), "--hard-size",
                str(DENSE_HW), "--n-segments", str(DENSE_SEGMENTS),
                "--bg-connectivity", "--epochs", "2", "--batch",
                str(TRAIN_GRAPHS), "--model", variant, "--save-dir", tmp])
            wall = time.perf_counter() - t
        finally:
            trainer_mod.Trainer.fit = fit
            trainer_mod.Trainer.train_step = step
        peak = torch.cuda.max_memory_allocated()
        files = sorted(p.name for p in Path(tmp).iterdir())
        saved = json.loads((Path(tmp) / "history.json").read_text())
        trainer = seen["trainer"]
        final = Path(tmp) / "final_model.msgpack"
        loaded, meta = gt.load_model_from_checkpoint(final,
                                                     dtype=torch.bfloat16)
    sd, ld = trainer.model.state_dict(), loaded.state_dict()
    same_weights = all(torch.equal(sd[k], ld[k]) for k in sd)
    batch = gt.stack_graphs(graphs)
    trainer.model.eval()
    with torch.no_grad():
        a = torch.softmax(trainer.model(batch).float(), dim=-1)
        b = torch.softmax(loaded(batch).float(), dim=-1)
    same_probs = bool(torch.equal(a, b))
    med = float(np.median(step_s[1:]))
    finite = all(np.isfinite(v).all() for v in saved.values() if v)
    print(f"cli.train --model {variant} ({TRAIN_CLI_SAMPLES} "
          f"hard-synthetic {DENSE_HW}^2, "
          f"K=484, bg-connectivity, 2 epochs, batch {TRAIN_GRAPHS}, bf16, "
          f"AdamW wd 3e-4 + SGDR; {card}): {wall:.2f} s in all, "
          f"{len(step_s)} steps, median {1e3 * med:.2f} ms per step after "
          f"the first ({TRAIN_GRAPHS / med:.1f} graphs/s), peak "
          f"torch.cuda.max_memory_allocated {peak / 2**20:.1f} MiB; files "
          f"{files}; train loss {[round(x, 5) for x in history['train_loss']]}"
          f", val score {[round(x, 5) for x in history['val_score']]}; "
          f"final checkpoint reloads: weights identical {same_weights}, "
          f"eval posteriors identical {same_probs} (meta epoch "
          f"{meta['epoch']})", flush=True)
    for name in ("best_model.msgpack", "final_model.msgpack", "history.json"):
        if name not in files:
            fail(f"cli.train wrote no {name}")
    if not finite:
        fail("the training history holds a non-finite value")
    if not (same_weights and same_probs):
        fail("load_model_from_checkpoint(final) does not reproduce the "
             "trained model")


def sha1(a: np.ndarray) -> str:
    import hashlib
    return hashlib.sha1(np.ascontiguousarray(a)).hexdigest()


def other_generator_outputs(dataset) -> list:
    """(name, array) of the arrays the other generators and augment_sample
    give from fixed seeds, with `dataset` the JAX package's or the port's
    data module: make_synthetic_dataset (cv2 circles, rectangles,
    ellipses), make_photo_synthetic_dataset (Gaussian and box blurs,
    dilation, morphology, cubic resizes), augment_sample with every op,
    and augment_sample's cv2 calls one at a time (warpAffine linear and
    nearest with a reflected border, the HSV conversions, linear and
    nearest resizes)."""
    out = []
    for s in dataset.make_synthetic_dataset(n=6, size=128, seed=42):
        out += [(s["name"] + "/image", s["image"]),
                (s["name"] + "/mask", s["gt_mask"])]
    for s in dataset.make_photo_synthetic_dataset(n=4, size=DENSE_HW,
                                                  seed=99):
        out += [(s["name"] + "/image", s["image"]),
                (s["name"] + "/mask", s["gt_mask"])]
    base = dataset.make_hard_synthetic_dataset(n=1, size=DENSE_HW, seed=5)[0]
    for seed in range(4):
        img, mask = dataset.augment_sample(
            base["image"], base["gt_mask"], np.random.RandomState(seed),
            prob_flip=1.0, prob_rotate=1.0, prob_color=1.0, prob_crop=1.0)
        out += [(f"augment_{seed}/image", img), (f"augment_{seed}/mask", mask)]
    # augment_sample's cv2 calls one by one, as it makes them.
    import cv2
    img, mask = base["image"], base["gt_mask"]
    hw = DENSE_HW
    rot = cv2.getRotationMatrix2D((hw / 2.0, hw / 2.0), 11.3, 1.0)
    crop = (slice(37, 37 + 421), slice(52, 52 + 421))
    out += [
        ("warpAffine/linear/reflect", cv2.warpAffine(
            img, rot, (hw, hw), flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_REFLECT)),
        ("warpAffine/nearest/reflect", cv2.warpAffine(
            mask, rot, (hw, hw), flags=cv2.INTER_NEAREST,
            borderMode=cv2.BORDER_REFLECT)),
        ("cvtColor/RGB2HSV", cv2.cvtColor(img, cv2.COLOR_RGB2HSV)),
        ("cvtColor/HSV2RGB", cv2.cvtColor(img, cv2.COLOR_HSV2RGB)),
        ("resize/linear", cv2.resize(img[crop], (hw, hw),
                                     interpolation=cv2.INTER_LINEAR)),
        ("resize/nearest", cv2.resize(mask[crop], (hw, hw),
                                      interpolation=cv2.INTER_NEAREST))]
    return out


def run_eval_cli(card: str, limit: int = EVAL_LIMIT) -> list:
    """Phase (c): cli.evaluate with the bgc ensemble on the first `limit`
    of the EVAL_N hard-synthetic 512 px images, held against the JAX
    package's run (tests/data/torch_eval_jax_ref.npz).  Returns the
    (image, mask) pairs it segmented."""
    import json
    from pathlib import Path

    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.cli import evaluate as eval_cli
    from gcn_grabcut_torch.data import dataset as ds

    root = Path(__file__).resolve().parent
    ref = np.load(root / EVAL_REF)
    jax_report = json.loads(str(ref["report"]))
    made, masks = [], []
    make, stream = (ds.make_hard_synthetic_dataset,
                    gt.GCNGrabCutPipeline.segment_stream)

    def recording_make(*args, **kwargs):
        made.extend(make(*args, **kwargs))
        return list(made)

    def recording_stream(self, *args, **kwargs):
        for res in stream(self, *args, **kwargs):
            masks.append(res.binary_mask)
            yield res

    ds.make_hard_synthetic_dataset = recording_make
    gt.GCNGrabCutPipeline.segment_stream = recording_stream
    try:
        report = eval_cli.main([
            "--checkpoint", ",".join(str(root / p) for p in DENSE_CHECKPOINTS),
            "--hard-synthetic", str(EVAL_N), "--hard-size", str(DENSE_HW),
            "--batch", str(EVAL_BATCH), "--bg-connectivity", "--limit",
            str(limit)])
    finally:
        ds.make_hard_synthetic_dataset = make
        gt.GCNGrabCutPipeline.segment_stream = stream
    img_same = [sha1(s["image"]) == h for s, h in zip(made, ref["image_sha1"])]
    mask_same = [sha1(s["gt_mask"]) == h
                 for s, h in zip(made, ref["mask_sha1"])]
    ious = [iou(m, np.unpackbits(ref["mask"][i], count=DENSE_HW * DENSE_HW
                                 ).reshape(DENSE_HW, DENSE_HW))
            for i, m in enumerate(masks)]
    jax_mean = float(np.mean(ref["iou"][:limit]))
    print(f"cli.evaluate (bgc ensemble, {limit} of {EVAL_N} "
          f"hard-synthetic {DENSE_HW}^2, seed {EVAL_SEED}, batch "
          f"{EVAL_BATCH}, bg-connectivity, ms_scales 1.0,0.75; {card}): "
          f"{report['mean_seconds_per_image']:.4f} s per image; images "
          f"generated {len(made)}, sha1 equal to JAX's: images "
          f"{sum(img_same)}/{len(img_same)}, masks "
          f"{sum(mask_same)}/{len(mask_same)}; mask IoU vs JAX per image "
          f"{[round(x, 6) for x in ious]} (mean {np.mean(ious):.6f}, least "
          f"{min(ious):.6f}, {sum(x == 1.0 for x in ious)} equal; min "
          f"{EVAL_MIN_IOU}); report mean_iou {report['mean_iou']:.6f} vs "
          f"JAX's {jax_mean:.6f} on the same {limit} (tol "
          f"{EVAL_REPORT_TOL}); JAX's report on all {EVAL_N}: mean_iou "
          f"{jax_report['mean_iou']:.6f}", flush=True)
    # Whether this machine's OpenCV draws the other generators' pixels and
    # its raw cv2 calls as the JAX package's run did (information), and
    # augment_sample's arrays, which the port warps in numpy (gated).
    others = other_generator_outputs(ds)
    differ = [name for (name, a), h in zip(others, ref["other_sha1"])
              if sha1(a) != h]
    augment = [name for name, _ in others if name.startswith("augment_")]
    print(f"other generators and augment_sample vs the JAX run's sha1s: "
          f"{len(others) - len(differ)}/{len(others)} equal; differ: "
          f"{differ}; augment_sample arrays equal "
          f"{len([n for n in augment if n not in differ])}/{len(augment)}",
          flush=True)
    if any(name in differ for name in augment):
        fail("augment_sample's arrays differ from the JAX run's with "
             "OpenCV 5.0")
    if len(made) != EVAL_N or not (all(img_same) and all(mask_same)):
        bad = [i for i, (a, b) in enumerate(zip(img_same, mask_same))
               if not (a and b)]
        fail(f"generated images or masks differ from JAX's: {bad}")
    if report["n"] != limit or len(masks) != limit:
        fail(f"evaluated {report['n']} images, recorded {len(masks)}")
    if np.mean(ious) < EVAL_MIN_IOU:
        fail(f"mean mask IoU against JAX {np.mean(ious):.4f}")
    if abs(report["mean_iou"] - jax_mean) > EVAL_REPORT_TOL:
        fail("the report's mean_iou disagrees with JAX's")
    return [(s["image"], m) for s, m in zip(made, masks)]


def run_inference_cli(evaluated: list, card: str) -> None:
    """Phase (d): cli.inference --batch 4 --fixed-size with the ensemble on
    INFER_IMAGES of phase (c)'s images, written as PNGs.  The inference
    CLI runs one scale (neither package's has a multi-scale option), so
    its masks are held against segment_batch at its settings on the same
    images; phase (c)'s multi-scale masks are reported beside."""
    import tempfile
    from pathlib import Path

    import cv2

    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.cli import inference as infer_cli

    root = Path(__file__).resolve().parent
    ckpt = ",".join(str(root / p) for p in DENSE_CHECKPOINTS)
    images = [img for img, _ in evaluated[:INFER_IMAGES]]
    with tempfile.TemporaryDirectory() as tmp:
        src, out = Path(tmp) / "in", Path(tmp) / "out"
        src.mkdir()
        for i, img in enumerate(images):
            cv2.imwrite(str(src / f"img{i}.png"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        t = time.perf_counter()
        infer_cli.main(["--checkpoint", ckpt, "--input", str(src),
                        "--output-dir", str(out), "--batch",
                        str(INFER_IMAGES), "--fixed-size", "--max-size",
                        str(DENSE_HW), "--bg-connectivity", "--save", "mask",
                        "overlay", "rgba", "trimap"])
        wall = time.perf_counter() - t
        files = sorted(p.name for p in out.iterdir())
        written = [cv2.imread(str(out / f"img{i}_mask.png"), 0) > 0
                   for i in range(len(images))]
    model, _ = load_ensemble()
    pipe = gt.GCNGrabCutPipeline(model, gt.SuperpixelGraphConfig(
        n_segments=DENSE_SEGMENTS, bg_connectivity=True))
    direct = pipe.segment_batch(images, threshold_fg=0.65, threshold_bg=0.65,
                                filter_radius=4, want_segments=False)
    ious = [iou(w, d.binary_mask) for w, d in zip(written, direct)]
    vs_eval = [iou(w, m) for w, (_, m) in zip(written, evaluated)]
    print(f"cli.inference (--batch {INFER_IMAGES} --fixed-size, bgc "
          f"ensemble, {len(images)} PNGs of {DENSE_HW}^2; {card}): "
          f"{wall:.3f} s, {len(files)} files; mask IoU vs segment_batch "
          f"{[round(x, 6) for x in ious]} (min {INFER_MIN_IOU}); vs phase "
          f"(c)'s multi-scale masks {[round(x, 6) for x in vs_eval]}",
          flush=True)
    if len(files) != 4 * len(images):
        fail(f"cli.inference wrote {files}")
    if min(ious) < INFER_MIN_IOU:
        fail("cli.inference's masks disagree with segment_batch's")


def variant_model(variant: str):
    """build_model(variant) at its defaults (D=128, n_layers=6; GAT with 8
    heads of 16), weights from VARIANT_SEED (init_model_numpy), on the
    CPU."""
    import gcn_grabcut_torch as gt
    return gt.init_model_numpy(gt.build_model(variant), VARIANT_SEED)


def gat_layer_case(dev):
    """One full-width GAT attention layer on the main path's 1536^2 / 10k
    graph: (the seeded GATTrimapNet, its graph, its second GATv2Conv
    (128 -> 8 heads of 16), the layer's arguments (random inputs, the
    edges sorted by destination, the node mask), the graph's GatPlan at
    the default fallback capacity, built without reading its overflow)."""
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.models.large import build_gat_plan_device
    from gcn_grabcut_torch.models.layers import sort_edges_by_dst

    g = graph_on_card([make_image(IMAGE_HW)],
                      gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS), dev)
    model = variant_model("gat").to(dev)
    x = torch.randn((1, g.max_nodes, HIDDEN), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    args = (x, *sort_edges_by_dst(g.edge_src, g.edge_dst, g.edge_attr,
                                  g.edge_mask), g.node_mask)
    plan = build_gat_plan_device(g.edge_src[0], g.edge_dst[0],
                                 g.edge_attr[0], g.edge_mask[0],
                                 g.max_nodes, check_overflow=False)
    return model, g, model.convs[1], args, plan


def run_variants(dev, card: str, graphs: list) -> None:
    """Phase 9: the GCN and GAT variants at full width through the entry
    points: (a) segment_batch at 1536^2 / 10k per variant (GCN: 6 K1
    launches per forward; GAT: the GatPlan without overflow, banded
    against the edge-list forward, one layer timed); (b) the card against
    the JAX package's outputs (tests/data/torch_variants_jax_ref.npz) on
    the large path (320^2 / 2600) and the dense path (512^2 / 500); (c) one
    fp32 training step card vs CPU and cli.train --model per variant;
    (d) the GAT checkpoint cli.train wrote, through load_model_auto and
    segment_batch at 1536^2 / 10k."""
    import shutil
    import tempfile
    from pathlib import Path

    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.models.large import apply_large
    from gcn_grabcut_torch.ops.spmm import banded_spmm

    cfg = gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    img = make_image(IMAGE_HW)
    g = graph_on_card([img], cfg, dev)
    for variant in VARIANTS:
        pipe = gt.GCNGrabCutPipeline(variant_model(variant), cfg)
        t = time.perf_counter()
        apply_large(pipe.model, g)   # warm the forward; GrabCut is warm
        torch.cuda.synchronize()
        warm = time.perf_counter() - t
        banded_spmm.kernel_launches = 0
        t = time.perf_counter()
        res = pipe.segment_batch([img])[0]
        wall = time.perf_counter() - t
        k1 = banded_spmm.kernel_launches
        k = res.probs.shape[0]
        print(f"{variant} at {IMAGE_HW}^2 (K={k}, D={HIDDEN} n={N_LAYERS}, "
              f"seed {VARIANT_SEED}; {card}): segment_batch B=1 {wall:.3f} s "
              f"({split(res.timing)}; the first forward {warm:.3f} s); "
              f"banded_spmm launches={k1}; FG {res.binary_mask.mean():.4f}",
              flush=True)
        want = N_LAYERS if variant == "gcn" else 0
        if k1 != want:
            fail(f"{variant}: banded_spmm launched {k1} times per forward, "
                 f"expected {want}")
        if res.probs.shape != (k, 3) or not np.isfinite(res.probs).all():
            fail(f"{variant}: posteriors are not finite (K, 3)")

    # The GAT plan of the SLIC graph, and the banded forward against the
    # card's own edge-list forward.
    del g
    model, g, layer, args, plan = gat_layer_case(dev)
    overflow = int(plan.fb_overflow[0])
    valid = g.node_mask[0] > 0
    with torch.no_grad():
        edge = model(g)[0][valid].float()
        highest = apply_large(model, g, plans=plan,
                              precision="highest")[0][valid].float()
        default = apply_large(model, g, plans=plan)[0][valid].float()
    excess = float(((highest - edge).abs() - BANDED_HIGHEST_TOL
                    * (1 + edge.abs())).max())
    scale = float(edge.abs().max())
    d_default = float((default - edge).abs().max())
    print(f"GAT plan at {IMAGE_HW}^2 (n_pad={plan.n_nodes}, R="
          f"{plan.block_rows}, K={plan.k_blocks}): {int(plan.mask_band.sum())}"
          f" window edges, {int(plan.fb_mask.sum())} fallback edges in a "
          f"capacity of {plan.fb_mask.numel()}, fb_overflow={overflow}; "
          f"banded vs edge-list logits: highest max |d| "
          f"{float((highest - edge).abs().max()):.3e} (rtol = atol = "
          f"{BANDED_HIGHEST_TOL:.0e}), default max |d| {d_default:.3e} "
          f"({d_default / scale:.4f} of max |logits| {scale:.3f}, limit "
          f"{BANDED_DEFAULT_REL})", flush=True)
    if overflow:
        fail(f"the SLIC graph's GatPlan overflowed by {overflow} edges")
    if excess > 0 or d_default > BANDED_DEFAULT_REL * scale:
        fail("the banded GAT forward disagrees with the edge-list forward")
    with torch.no_grad():
        times = {name: time_ms(lambda kw=kw: layer(*args, pre_sorted=True,
                                                   **kw), reps=10)
                 for name, kw in (
                     ("edge-list", {}),
                     ("banded default", dict(plan=plan)),
                     ("banded highest", dict(plan=plan,
                                             plan_precision="highest")))}
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        layer(*args, pre_sorted=True, plan=plan)
        peak = torch.cuda.max_memory_allocated() - base
    print(f"GAT attention layer (128 -> 8 x 16) at K={g.max_nodes}, "
          f"E={g.max_edges} ({card}): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in times.items())
          + f"; banded default peak {peak / 2**20:.1f} MiB above its inputs",
          flush=True)
    del model, g, layer, args, plan

    # Against the JAX package on the same images and weights.
    ref = np.load(Path(__file__).resolve().parent / VARIANT_REF)
    for case, (hw, n_segments, seed) in VARIANT_CASES.items():
        img_c = textured_image(hw, seed)
        cfg_c = gt.SuperpixelGraphConfig(n_segments=n_segments)
        rg = gt.build_graph(img_c, cfg_c)
        seg_agree = float((rg.segments == ref[f"{case}_segments"]).mean())
        large = rg.n_nodes > gt.GCNGrabCutPipeline.LARGE_NODE_THRESHOLD
        nm = np.asarray(rg.graph.node_mask[0].cpu()) > 0
        for variant in VARIANTS:
            model = variant_model(variant).to(dev)
            with torch.no_grad():
                out = apply_large(model, rg.graph) if large else \
                    model(rg.graph)
            logits = out[0].float().cpu().numpy()
            want = ref[f"{variant}_{case}_logits"]
            if large:
                err = float(np.abs(logits - want)[nm].max())
                tol = VARIANT_LOGIT_TOL * max(1.0, float(np.abs(want).max()))
                what = "logits"
            else:
                p = torch.softmax(torch.from_numpy(logits), -1).numpy()
                q = torch.softmax(torch.from_numpy(want), -1).numpy()
                err, tol = float(np.abs(p - q)[nm].max()), VARIANT_PROB_TOL
                what = "posteriors"
            mask = gt.GCNGrabCutPipeline(model, cfg_c).segment_batch(
                [img_c])[0].binary_mask
            m_iou = iou(mask > 0, np.unpackbits(
                ref[f"{variant}_{case}_mask"], count=hw * hw).reshape(
                    hw, hw) > 0)
            print(f"{variant} {case} path vs JAX ({hw}^2, K={rg.n_nodes}; "
                  f"{card}): SLIC agreement {seg_agree:.6f}, max |d "
                  f"{what}| {err:.3e} (tol {tol:.1e}), mask IoU {m_iou:.6f} "
                  f"(min {VARIANT_MIN_IOU})", flush=True)
            if seg_agree != 1.0:
                fail(f"{case}: the card's superpixels differ from JAX's")
            if err > tol or m_iou < VARIANT_MIN_IOU:
                fail(f"{variant} {case}: the card disagrees with JAX")

    # Training, then the trained GAT checkpoint through the large path.
    tmp = Path(tempfile.mkdtemp())
    try:
        for variant in VARIANTS:
            run_train_step(dev, card, variant, graphs)
            run_train_cli(graphs, card, variant, save_dir=tmp / variant)
        model, meta = gt.load_model_auto(str(tmp / "gat/final_model.msgpack"))
        pipe = gt.GCNGrabCutPipeline(model, cfg)
        t = time.perf_counter()
        res = pipe.segment_batch([img])[0]
        wall = time.perf_counter() - t
        print(f"trained GAT checkpoint (cli.train, meta variant "
              f"{meta['variant']}) -> load_model_auto -> segment_batch at "
              f"{IMAGE_HW}^2 (K={res.probs.shape[0]}; {card}): {wall:.3f} s "
              f"({split(res.timing)}); FG {res.binary_mask.mean():.4f}",
              flush=True)
        if meta["variant"] != "gat" or not np.isfinite(res.probs).all():
            fail("the trained GAT checkpoint does not segment")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


SERVE_TIMEOUT_S = 600


@contextlib.contextmanager
def serving(server, batcher):
    """Serve on a thread; yields the port; shuts the server down, closes
    its socket and stops its batcher on exit."""
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        batcher.close(SERVE_TIMEOUT_S)
        thread.join(SERVE_TIMEOUT_S)


def http(port: int, path: str, body: bytes | None = None,
         ctype: str = "image/png") -> tuple:
    """(status, JSON payload, seconds) of one GET (no body) or POST."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={} if body is None else {"Content-Type": ctype})
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as r:
            code, payload = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, payload = e.code, json.loads(e.read())
    return code, payload, time.perf_counter() - t


def png_bytes(img: np.ndarray) -> bytes:
    import cv2
    return cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))[1] \
        .tobytes()


def served_mask(payload: dict) -> np.ndarray:
    import base64

    import cv2
    return cv2.imdecode(np.frombuffer(base64.b64decode(
        payload["mask_png_b64"]), np.uint8), cv2.IMREAD_GRAYSCALE)


def serve_reference(batcher, image: np.ndarray, threshold: float):
    """(result, unboxed mask) of segment_batch at B=1 on the request's
    canvas with the server's settings."""
    from gcn_grabcut_torch.cli import serve
    canvas, geom = serve._letterbox(image, batcher.size)
    res = batcher.pipe.segment_batch(
        [canvas], threshold_fg=threshold, threshold_bg=threshold,
        keep_largest=False, filter_radius=batcher.defaults["filter_radius"],
        want_segments=False)[0]
    return res, serve._unbox(res.binary_mask, geom)


def run_serving(card: str) -> float:
    """cli.serve on the card: (a) the recommended ensemble at 512 px behind
    its micro-batcher, 8 clients and 16 requests, held against
    segment_batch and the JAX package's served masks; (b) one ResGCNNet at
    1536^2 / 10 000 superpixels, one request plain and one under
    profile_trace, 7 K1 launches each; (c) a FrameworkConfig round trip
    and save_research_report on (a)'s results.  Returns (a)'s requests
    per second."""
    import base64
    import hashlib
    import queue
    import tempfile
    from pathlib import Path

    import cv2

    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.cli import serve
    from gcn_grabcut_torch.config import FrameworkConfig
    from gcn_grabcut_torch.ops.spmm import banded_spmm
    from gcn_grabcut_torch.utils import profile_trace

    root = Path(__file__).resolve().parent
    ref = np.load(root / SERVE_REF)
    images = [serve_image(h, w, s) for h, w, s in SERVE_IMAGES]
    if (ref["images"].tolist() != [list(x) for x in SERVE_IMAGES]
            or list(ref["sha1"]) != [hashlib.sha1(im.tobytes()).hexdigest()
                                     for im in images]):
        fail("the serving images differ from the JAX fixture's")

    def jax_mask(i: int, alt: bool) -> np.ndarray:
        h, w = images[i].shape[:2]
        return np.unpackbits(ref["mask_alt" if alt else f"mask_{i}"],
                             count=h * w).reshape(h, w)

    # (a) The recommended server.  Request k: image k % 5; request 5
    # (image 0) asks for SERVE_ALT_THRESHOLD, request 3 sends JSON.
    plan = [(k % len(images), k == 5, k == 3) for k in range(SERVE_REQUESTS)]
    spec = ",".join(str(root / p) for p in DENSE_CHECKPOINTS)
    t = time.perf_counter()
    server, batcher = serve.build_server(serve.parse_args(
        ["--checkpoint", spec, "--port", "0", "--batch-wait-ms",
         str(SERVE_WAIT_MS)] + SERVE_FLAGS))
    startup = time.perf_counter() - t
    # References before the server takes requests: one thread at a time
    # drives the pipeline.
    refs = {}
    for i, alt in sorted({(i, alt) for i, alt, _ in plan}):
        refs[i, alt] = serve_reference(
            batcher, images[i],
            SERVE_ALT_THRESHOLD if alt else batcher.defaults["threshold"])
    groups, splits, segment_batch = [], [], batcher.pipe.segment_batch

    def recording(imgs, **kw):
        groups.append(len(imgs))
        out = segment_batch(imgs, **kw)
        splits.append(split(out[0].timing))
        return out
    batcher.pipe.segment_batch = recording

    requests = []
    for i, alt, as_json in plan:
        body, ctype = png_bytes(images[i]), "image/png"
        if as_json:
            body = json.dumps({"image_b64": base64.b64encode(body).decode()
                               }).encode()
            ctype = "application/json"
        path = f"/segment?threshold={SERVE_ALT_THRESHOLD}" if alt \
            else "/segment"
        requests.append((path, body, ctype))
    work: queue.Queue = queue.Queue()
    for k in range(len(plan)):
        work.put(k)
    answers = [None] * len(plan)

    def client():
        while True:
            try:
                k = work.get_nowait()
            except queue.Empty:
                return
            answers[k] = http(port, *requests[k])

    with serving(server, batcher) as port:
        t = time.perf_counter()
        clients = [threading.Thread(target=client)
                   for _ in range(SERVE_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(SERVE_TIMEOUT_S)
        wall = time.perf_counter() - t
        if any(c.is_alive() for c in clients):
            fail("a serving client did not finish")
        health = http(port, "/healthz")
        undecodable = http(port, "/segment", b"not an image")
        unknown = http(port, "/nowhere")
        served = batcher.served

    lat = np.array([a[2] for a in answers])
    ious_ref, ious_jax, exact, fgs = [], [], 0, []
    for k, ((i, alt, _), (code, payload, _)) in enumerate(zip(plan,
                                                              answers)):
        if code != 200:
            fail(f"request {k} answered {code}: {payload}")
        mask = served_mask(payload)
        if mask.shape != images[i].shape[:2]:
            fail(f"request {k}: mask {mask.shape}, image "
                 f"{images[i].shape[:2]}")
        if not set(np.unique(mask).tolist()) <= {0, 255}:
            fail(f"request {k}: mask values {np.unique(mask)}")
        want = refs[i, alt][1]
        ious_ref.append(iou(mask, want))
        exact += bool(((mask > 0) == (want > 0)).all())
        ious_jax.append(iou(mask, jax_mask(i, alt)))
        fgs.append(payload["fg_ratio"])
    timings = sorted({a[1]["timing_ms"] for a in answers})
    rate = len(plan) / wall
    print(f"serving (a), the recommended ensemble ({DENSE_HW} px canvas, "
          f"K={refs[0, False][0].probs.shape[0]}, bgc x3, --batch 8, "
          f"--batch-wait-ms {SERVE_WAIT_MS}; {card}): start-up (load + "
          f"warm-up) {startup:.3f} s; {len(plan)} requests from "
          f"{SERVE_CLIENTS} clients in {wall:.3f} s = "
          f"{rate:.4f} requests/s; latency p50 "
          f"{np.percentile(lat, 50):.3f} s, p95 {np.percentile(lat, 95):.3f}"
          f" s, max {lat.max():.3f} s; groups {groups} (mean "
          f"{np.mean(groups):.2f}); batch timing_ms {timings}; FG "
          f"{min(fgs):.4f}-{max(fgs):.4f}; each group's stage split "
          f"(unsynchronised): {' | '.join(splits)}", flush=True)
    print(f"serving (a) masks: IoU vs segment_batch min {min(ious_ref):.6f} "
          f"({exact} of {len(plan)} exact), vs JAX min {min(ious_jax):.6f} "
          f"(mean {np.mean(ious_jax):.6f}); healthz {health[1]}; "
          f"undecodable {undecodable[0]}, unknown path {unknown[0]}",
          flush=True)
    if min(ious_ref) < SERVE_MIN_IOU:
        fail(f"a served mask has IoU {min(ious_ref):.6f} against "
             "segment_batch")
    if min(ious_jax) < SERVE_MIN_IOU:
        fail(f"a served mask has IoU {min(ious_jax):.6f} against JAX's")
    if served != len(plan) or health[1].get("served") != len(plan):
        fail(f"served {served} (healthz {health[1]}) of {len(plan)}")
    if undecodable[0] != 400 or unknown[0] != 404:
        fail(f"undecodable -> {undecodable[0]}, unknown path -> "
             f"{unknown[0]}")
    if sum(groups) != len(plan) or max(groups) < 2:
        fail(f"groups {groups}: no call coalesced requests")

    # (b) The large server: K1 on every request.
    large = serve_image(IMAGE_HW, IMAGE_HW, 5)
    t = time.perf_counter()
    server, batcher = serve.build_server(serve.parse_args(
        ["--checkpoint", str(root / SERVE_LARGE_CHECKPOINT), "--port", "0",
         "--size", str(IMAGE_HW), "--n-segments", str(N_SEGMENTS),
         "--batch", "1"]))
    startup = time.perf_counter() - t
    want = serve_reference(batcher, large, batcher.defaults["threshold"])[1]
    with serving(server, batcher) as port, \
            tempfile.TemporaryDirectory() as tmp:
        runs = []
        for traced in (False, True):
            banded_spmm.kernel_launches = 0
            t = time.perf_counter()
            with profile_trace(tmp if traced else None):
                code, payload, seconds = http(port, "/segment",
                                              png_bytes(large))
            runs.append((time.perf_counter() - t, seconds,
                         banded_spmm.kernel_launches, code, payload))
        traces = list(Path(tmp).glob("*.pt.trace.json"))
        tallies = [json.loads(p.read_text())
                   for p in Path(tmp).glob("*.mincut.json")]
        size = sum(p.stat().st_size for p in traces)
        t = time.perf_counter()
        events = [e for p in traces
                  for e in json.loads(p.read_text())["traceEvents"]]
        parse_s = time.perf_counter() - t
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    k1 = sum("banded_spmm" in n for n in kernels)
    for (wall, seconds, launches, code, payload), name in zip(
            runs, ("plain", "under profile_trace")):
        if code != 200:
            fail(f"the large server answered {code}: {payload}")
        mask = served_mask(payload)
        print(f"serving (b), ResGCNNet at {IMAGE_HW}^2 / {N_SEGMENTS} "
              f"({SERVE_LARGE_CHECKPOINT}; {card}), one request {name}: "
              f"{wall:.3f} s (HTTP {seconds:.3f} s, batch timing_ms "
              f"{payload['timing_ms']}); banded_spmm launches {launches}; "
              f"IoU vs segment_batch {iou(mask, want):.6f}; FG "
              f"{payload['fg_ratio']:.4f}", flush=True)
        if launches != N_LAYERS + 1:
            fail(f"the large request launched banded_spmm {launches} "
                 f"times, expected {N_LAYERS + 1}")
        if mask.shape != large.shape[:2] or iou(mask, want) < SERVE_MIN_IOU:
            fail("the large server's mask disagrees with segment_batch")
    print(f"serving (b): start-up {startup:.3f} s; profile_trace wrote "
          f"{len(traces)} file(s), {size / 2**20:.1f} MiB, {len(events)} "
          f"events ({len(kernels)} kernels, {k1} banded_spmm), parsed in "
          f"{parse_s:.1f} s", flush=True)
    if len(traces) != 1 or not kernels or k1 < N_LAYERS + 1:
        fail("the profiler trace lacks the card's kernels or K1")
    print(f"serving (b): profile_trace's min-cut tallies {tallies}",
          flush=True)
    n_iter = gt.GrabCutConfig().n_iter
    if len(tallies) != 1 or tallies[0]["solves"] != n_iter \
            or tallies[0]["barriers"] <= 0:
        fail("profile_trace's tallies lack the traced request's solves")

    # (c) Tooling on (a)'s results.
    with tempfile.TemporaryDirectory() as tmp:
        cfg = FrameworkConfig.load(overrides={
            "superpixels.n_segments": DENSE_SEGMENTS,
            "superpixels.bg_connectivity": True,
            "inference.threshold": 0.65, "inference.filter_radius": 4})
        cfg.save(Path(tmp) / "serve.json")
        if FrameworkConfig.load(Path(tmp) / "serve.json").to_dict() \
                != cfg.to_dict():
            fail("FrameworkConfig does not survive a JSON round trip")
        report = Path(tmp) / "report.png"
        gt.save_research_report(
            [dict(image=serve._letterbox(images[i], DENSE_HW)[0],
                  trimap=res.trimap, binary_mask=res.binary_mask,
                  title=f"image {i}{' alt' if alt else ''}")
             for (i, alt), (res, _) in sorted(refs.items())], report)
        grid = cv2.imread(str(report))
        if grid is None or grid.std() == 0:
            fail("save_research_report wrote no image")
        print(f"serving (c): FrameworkConfig JSON round trip equal; "
              f"save_research_report {grid.shape[1]}x{grid.shape[0]} px, "
              f"{report.stat().st_size} bytes", flush=True)
    return rate


def run_data_parallel(dev, card: str, graphs: list, rings: dict,
                      n_nodes: int) -> None:
    """Phase 11: data-parallel training over DP_RANKS logical ranks on the
    card.  (a) One fp32 step from TRAIN_START's weights, dropout on,
    against the solo Trainer's step (loss, every gradient leaf, InputNorm's
    running statistics), with K3 and K2 launched once each; (b) a
    DP_FIT_EPOCHS-epoch fit against the solo fit; (c) the graph axis of a
    MESH_2D mesh on the main path's graph against apply_large."""
    import tempfile
    from pathlib import Path

    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.models.large import apply_large
    from gcn_grabcut_torch.parallel import ring
    from gcn_grabcut_torch.parallel.data import flat_rows
    from gcn_grabcut_torch.parallel.mesh import make_mesh
    from gcn_grabcut_torch.train import trainer as trainer_mod

    root = Path(__file__).resolve().parent
    mesh = make_mesh(n_data=DP_RANKS, devices=[dev] * DP_RANKS)
    kw = dict(hidden_channels=HIDDEN, n_layers=N_LAYERS, dropout=DP_DROPOUT)
    tcfg = trainer_mod.TrainConfig(
        bf16=False, prior_dropout=DP_PRIOR_DROPOUT, weight_decay=3e-4,
        batch_size=TRAIN_GRAPHS, verbose=False, n_epochs=DP_FIT_EPOCHS,
        save_every=100)

    # (a) one step each, after a warm step; the trainer restarts from the
    # same weights and generator state before the timed one.
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, m in (("solo", None), ("dp", mesh)):
            tr = trainer_mod.Trainer("resgcn", kw, tcfg, save_dir=tmp,
                                     device=dev, mesh=m)
            batch = tr._bucket(graphs)
            w = torch.ones(batch.n_graphs, device=dev)
            runs = []
            for timed in (False, True):
                tr._init_state(1)
                tr.load(str(root / TRAIN_START))
                torch.cuda.synchronize()
                ring.ring_all_gather.kernel_launches = 0
                ring.ring_reduce_scatter.kernel_launches = 0
                t = time.perf_counter()
                loss, grads = tr.loss_and_grads(batch, w)
                tr.optimizer.step(grads)
                torch.cuda.synchronize()
                s = time.perf_counter() - t
                launches = (ring.ring_reduce_scatter.kernel_launches,
                            ring.ring_all_gather.kernel_launches)
                runs.append((float(loss),
                             {k: g.cpu() for k, g in grads.items()}))
            out[name] = dict(
                repeat=runs[0][0] == runs[1][0] and all(
                    torch.equal(runs[0][1][k], runs[1][1][k])
                    for k in runs[1][1]),
                loss=float(loss), s=s, launches=launches,
                grads={k: g.cpu() for k, g in grads.items()},
                mean=tr.model.in_norm.running_mean.cpu(),
                var=tr.model.in_norm.running_var.cpu(),
                rows=flat_rows(list(grads.values()), DP_RANKS)[0].shape[0])
    d, p = out["dp"], out["solo"]
    loss_err = abs(d["loss"] - p["loss"]) / abs(p["loss"])
    grad_err, worst = leaf_errors(d["grads"], p["grads"], DP_GRAD_FLOOR)
    stats_err = max(float((d["mean"] - p["mean"]).abs().max()),
                    float((d["var"] - p["var"]).abs().max()))
    k3, k2 = d["launches"]
    n_params = sum(g.numel() for g in d["grads"].values())
    rings["K2"]["launches_data_parallel_step"] = k2
    rings["K3"]["launches_data_parallel_step"] = k3
    print(f"data-parallel step ({DP_RANKS} ranks on one card x "
          f"{TRAIN_GRAPHS // DP_RANKS} graphs, {TRAIN_GRAPHS} x {DENSE_HW}^2 "
          f"hard-synthetic, K={graphs[0].max_nodes}, ResGCNNet D={HIDDEN} "
          f"n={N_LAYERS} fp32 from {TRAIN_START}, dropout {DP_DROPOUT}, "
          f"prior dropout {DP_PRIOR_DROPOUT}; {card}): step "
          f"{1e3 * d['s']:.2f} ms data-parallel, {1e3 * p['s']:.2f} ms solo; "
          f"gradient sum {n_params} parameters as {d['rows']} x 128 fp32 "
          f"rows ({d['rows'] // DP_RANKS} per rank); ring_reduce_scatter "
          f"launches={k3}, ring_all_gather launches={k2} (solo "
          f"{p['launches']}); loss {d['loss']:.6f} rel err {loss_err:.2e} "
          f"(tol {DP_LOSS_TOL:.0e}); gradient err {grad_err:.2e} of each "
          f"leaf's scale (tol {DP_GRAD_TOL:.0e}, floor {DP_GRAD_FLOOR:.0e} "
          f"of the largest; worst {worst}); running stats |d| "
          f"{stats_err:.2e} (tol {TRAIN_STATS_TOL:.0e}); two steps "
          f"bit-identical (loss, every gradient leaf): data-parallel "
          f"{d['repeat']}, solo {p['repeat']}", flush=True)
    if not (d["repeat"] and p["repeat"]):
        fail("two data-parallel or solo steps differ in their bits")
    if (k3, k2) != (1, 1) or p["launches"] != (0, 0):
        fail(f"the data-parallel step launched K3 {k3} and K2 {k2} times "
             f"(solo {p['launches']}); expected 1 and 1 (solo 0)")
    if not (loss_err <= DP_LOSS_TOL and grad_err <= DP_GRAD_TOL
            and stats_err <= TRAIN_STATS_TOL):
        fail("the data-parallel step disagrees with the solo step")

    # K3 and K2 at the gradient sum's shapes, against their plain versions.
    data_ring = mesh.data_mesh(0)
    chunk = d["rows"] // DP_RANKS
    gen = torch.Generator(device=dev).manual_seed(4)
    stacked = torch.randn((DP_RANKS, d["rows"], 128), generator=gen,
                          device=dev)
    bufs = list(stacked)
    parts = ring.ring_reduce_scatter_cuda(bufs, data_ring)
    exact = all(bool(torch.equal(a, b)) for a, b in zip(
        parts, ring.ring_reduce_scatter_plain(bufs))) and all(
        bool(torch.equal(o, torch.cat(parts)))
        for o in ring.ring_all_gather_cuda(parts, data_ring))
    whole = torch.cat(parts)
    times = {
        "K3": (time_ms(lambda: ring.ring_reduce_scatter_cuda(bufs,
                                                              data_ring)),
               time_ms(lambda: ring.ring_reduce_scatter_plain(bufs)),
               time_ms(lambda: stacked.view(DP_RANKS, DP_RANKS, chunk,
                                            128).sum(0)),
               ring_bound(DP_RANKS, chunk, 4, True)[0]),
        "K2": (time_ms(lambda: ring.ring_all_gather_cuda(parts, data_ring)),
               time_ms(lambda: ring.ring_all_gather_plain(parts)),
               time_ms(lambda: whole.expand(DP_RANKS, *whole.shape
                                            ).contiguous()),
               ring_bound(DP_RANKS, chunk, 4, False)[0])}
    print(f"gradient-sum shapes (n={DP_RANKS} chunk={chunk} D=128 fp32; "
          f"{card}): " + ", ".join(
              f"{key} {t[0]:.4f} ms (plain {t[1]:.4f}, yardstick "
              f"{t[2]:.4f}, bound {t[3]:.4f})" for key, t in times.items())
          + f"; exact against the plain versions {exact}", flush=True)
    if not exact:
        fail("K3 or K2 disagrees with its plain version at the gradient "
             "sum's shapes")

    # (b) the fit, each step timed.
    dp_fit_against_solo("resgcn", kw, tcfg, mesh, graphs, dev, card)

    # (c) a 2-D mesh's graph axis on the main path's graph.
    cfg = gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    g = graph_on_card([make_image(IMAGE_HW)], cfg, dev)
    if g.max_nodes != n_nodes:
        fail(f"the graph has {g.max_nodes} nodes, the kernel phase used "
             f"{n_nodes}")
    model = gt.ResGCNNet(hidden_channels=HIDDEN, n_layers=N_LAYERS,
                         generator=torch.Generator().manual_seed(MODEL_SEED)
                         ).to(dev).eval()
    mesh2 = make_mesh(*MESH_2D, devices=[dev] * (MESH_2D[0] * MESH_2D[1]))
    edges = [a[0].cpu().numpy() for a in (g.edge_src, g.edge_dst,
                                          g.edge_mask)]
    aggs = gt.mesh_aggregators(mesh2.graph_mesh(0), *edges, g.max_nodes,
                               method="allgather", halo="xla")
    try:
        gt.mesh_aggregators(mesh2, *edges, g.max_nodes, method="allgather",
                            halo="pallas_ring")
        fail("the ring halo took a 2-D mesh")
    except ValueError:
        pass
    with torch.no_grad():
        logits = model(g, aggregators=aggs)
        ref = apply_large(model, g, precision="highest")
    valid = g.node_mask[0] > 0
    err = float((logits[0][valid] - ref[0][valid]).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    print(f"2-D mesh {mesh2.shape} ({MESH_2D[0] * MESH_2D[1]} ranks on one "
          f"card): graph_mesh(0) of {mesh2.graph_mesh(0).size} ranks through "
          f"mesh_aggregators(allgather, xla) at {IMAGE_HW}^2 / K={n_nodes}: "
          f"max |dlogits| vs apply_large highest={err:.3e} (tol "
          f"{SHARDED_FWD_TOL * scale:.1e}); the ring halo on the 2-D mesh "
          f"raises ValueError", flush=True)
    if err > SHARDED_FWD_TOL * scale or not bool(
            torch.isfinite(logits).all()):
        fail("the 2-D mesh's graph axis disagrees with apply_large")


def dp_fit_against_solo(variant: str, kw: dict, tcfg, mesh, graphs: list,
                        dev, card: str, rtol: float = DP_FIT_LOSS_RTOL
                        ) -> None:
    """Trainer.fit of `variant` for tcfg.n_epochs epochs on `graphs`
    (validated on them), over `mesh` and solo, each step timed: the
    histories must agree within `rtol` (train loss) and JAX's val-score
    bars."""
    import tempfile

    from gcn_grabcut_torch.train import trainer as trainer_mod

    step_fn = trainer_mod.Trainer.train_step
    hist, step_ms, fit_s = {}, {}, {}

    def timed_step(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step_fn(self, *args, **kwargs)
        torch.cuda.synchronize()
        step_ms.setdefault(self.mesh is not None, []).append(
            1e3 * (time.perf_counter() - t))
        return loss

    trainer_mod.Trainer.train_step = timed_step
    try:
        for name, m in (("dp", mesh), ("solo", None)):
            with tempfile.TemporaryDirectory() as tmp:
                t = time.perf_counter()
                hist[name] = trainer_mod.Trainer(
                    variant, kw, tcfg, save_dir=tmp, device=dev,
                    mesh=m).fit(graphs, graphs)
                fit_s[name] = time.perf_counter() - t
    finally:
        trainer_mod.Trainer.train_step = step_fn
    dh, sh = hist["dp"], hist["solo"]
    loss_err = float(np.max(np.abs(np.subtract(dh["train_loss"],
                                               sh["train_loss"]))
                            / np.abs(sh["train_loss"])))
    score_ok = np.allclose(dh["val_score"], sh["val_score"],
                           rtol=DP_SCORE_RTOL, atol=DP_SCORE_ATOL)
    dtype = "bf16" if tcfg.bf16 else "fp32"
    print(f"data-parallel fit ({variant} {dtype}, {tcfg.n_epochs} epochs of "
          f"the {len(graphs)} graphs at batch {tcfg.batch_size}, validated "
          f"on them; {card}): {fit_s['dp']:.2f} s data-parallel, "
          f"{fit_s['solo']:.2f} s solo; ms per step "
          f"{[round(x, 2) for x in step_ms[True]]} data-parallel, "
          f"{[round(x, 2) for x in step_ms[False]]} solo; train loss "
          f"{dh['train_loss']} vs {sh['train_loss']} (max rel err "
          f"{loss_err:.2e}, tol {rtol:.0e}); val score {dh['val_score']} vs "
          f"{sh['val_score']} (rtol {DP_SCORE_RTOL:.0e}, atol "
          f"{DP_SCORE_ATOL:.0e})", flush=True)
    if not (loss_err <= rtol and score_ok):
        fail(f"the data-parallel {variant} {dtype} history departs from the "
             "solo one")


def check_graph_products(dev, card: str) -> None:
    """The models' Linear computes graph by graph (one batched product):
    a rank's graphs must get the rows the whole batch gets.  Each
    (N, K) -> O layer shape of the variants on DP_RANKS' share of
    TRAIN_GRAPHS graphs against all of them; F.linear's one product
    alongside, for information."""
    import torch.nn.functional as F

    from gcn_grabcut_torch.models.layers import Linear

    gen = torch.Generator(device=dev).manual_seed(12)
    share = TRAIN_GRAPHS // DP_RANKS
    parts, same = [], True
    for k, o in ((19, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN * (N_LAYERS + 1),
                                                  HIDDEN), (HIDDEN // 2, 3)):
        x = torch.randn(TRAIN_GRAPHS, DENSE_SEGMENTS, k, generator=gen,
                        device=dev)
        layer = Linear(k, o).to(dev)
        with torch.no_grad():
            ours = bool(torch.equal(layer(x[:share]), layer(x)[:share]))
            plain = bool(torch.equal(
                F.linear(x[:share], layer.weight, layer.bias),
                F.linear(x, layer.weight, layer.bias)[:share]))
        same &= ours
        parts.append(f"({DENSE_SEGMENTS}, {k}) -> {o}: {ours} (F.linear "
                     f"{plain})")
    print(f"Linear rows of {share} graphs vs the same graphs in a batch of "
          f"{TRAIN_GRAPHS}, bitwise equal ({card}): " + "; ".join(parts),
          flush=True)
    if not same:
        fail("a Linear's rows depend on the number of graphs in its batch")


def run_data_parallel_variants(dev, card: str, graphs: list,
                               rings: dict) -> None:
    """Phase 12: data-parallel GCNTrimapNet and GATTrimapNet over phase
    11's mesh and graphs, and ResGCNNet's bf16 fit (see the docstring)."""
    import tempfile

    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.parallel import ring
    from gcn_grabcut_torch.parallel.mesh import make_mesh
    from gcn_grabcut_torch.train import trainer as trainer_mod

    check_graph_products(dev, card)
    mesh = make_mesh(n_data=DP_RANKS, devices=[dev] * DP_RANKS)
    kw = dict(hidden_channels=HIDDEN, n_layers=N_LAYERS, dropout=DP_DROPOUT)
    tcfg = trainer_mod.TrainConfig(
        bf16=False, prior_dropout=DP_PRIOR_DROPOUT, weight_decay=3e-4,
        batch_size=TRAIN_GRAPHS, verbose=False, n_epochs=DP_FIT_EPOCHS,
        save_every=100)
    for variant in DP_VARIANTS:
        # (a) one step each from VARIANT_SEED's weights, after a warm step.
        out = {}
        with tempfile.TemporaryDirectory() as tmp:
            for name, m in (("solo", None), ("dp", mesh)):
                tr = trainer_mod.Trainer(variant, kw, tcfg, save_dir=tmp,
                                         device=dev, mesh=m)
                batch = tr._bucket(graphs)
                w = torch.ones(batch.n_graphs, device=dev)
                for timed in (False, True):
                    tr._init_state(1)
                    gt.init_model_numpy(tr.model, VARIANT_SEED)
                    torch.cuda.synchronize()
                    ring.ring_all_gather.kernel_launches = 0
                    ring.ring_reduce_scatter.kernel_launches = 0
                    t = time.perf_counter()
                    loss, grads = tr.loss_and_grads(batch, w)
                    tr.optimizer.step(grads)
                    torch.cuda.synchronize()
                    s = time.perf_counter() - t
                    launches = (ring.ring_reduce_scatter.kernel_launches,
                                ring.ring_all_gather.kernel_launches)
                out[name] = dict(
                    loss=float(loss), s=s, launches=launches,
                    grads={k: g.cpu() for k, g in grads.items()},
                    stats={k: b.cpu() for k, b in
                           tr.model.named_buffers()})
        d, p = out["dp"], out["solo"]
        loss_err = abs(d["loss"] - p["loss"]) / abs(p["loss"])
        grad_err, worst = leaf_errors(d["grads"], p["grads"], DP_GRAD_FLOOR)
        stats_err = max(float((d["stats"][k] - b).abs().max())
                        for k, b in p["stats"].items())
        k3, k2 = d["launches"]
        rings["K2"][f"launches_data_parallel_step_{variant}"] = k2
        rings["K3"][f"launches_data_parallel_step_{variant}"] = k3
        print(f"data-parallel step, {variant} ({DP_RANKS} ranks on one "
              f"card x {TRAIN_GRAPHS // DP_RANKS} graphs, K="
              f"{graphs[0].max_nodes}, D={HIDDEN} n={N_LAYERS} fp32 from "
              f"init_model_numpy({VARIANT_SEED}), dropout {DP_DROPOUT}, "
              f"prior dropout {DP_PRIOR_DROPOUT}; {card}): step "
              f"{1e3 * d['s']:.2f} ms data-parallel, {1e3 * p['s']:.2f} ms "
              f"solo; ring_reduce_scatter launches={k3}, ring_all_gather "
              f"launches={k2} (solo {p['launches']}); loss {d['loss']:.6f} "
              f"rel err {loss_err:.2e} (tol {DP_LOSS_TOL:.0e}); gradient "
              f"err {grad_err:.2e} of each leaf's scale (tol "
              f"{DP_GRAD_TOL:.0e}, floor {DP_GRAD_FLOOR:.0e} of the "
              f"largest; worst {worst}); running stats of "
              f"{len(p['stats']) // 2} norms |d| {stats_err:.2e} (tol "
              f"{TRAIN_STATS_TOL:.0e})", flush=True)
        if (k3, k2) != (1, 1) or p["launches"] != (0, 0):
            fail(f"the data-parallel {variant} step launched K3 {k3} and K2 "
                 f"{k2} times (solo {p['launches']}); expected 1 and 1")
        if not (loss_err <= DP_LOSS_TOL and grad_err <= DP_GRAD_TOL
                and stats_err <= TRAIN_STATS_TOL):
            fail(f"the data-parallel {variant} step disagrees with the solo "
                 "step")
        # (b)
        dp_fit_against_solo(variant, kw, tcfg, mesh, graphs, dev, card)
    # (c) ResGCNNet in bfloat16 (fault 6: float32 weight gradients).
    dp_fit_against_solo("resgcn", kw, dataclasses.replace(tcfg, bf16=True),
                        mesh, graphs, dev, card)


def cut_energy(excess: torch.Tensor, caps: tuple, fg: torch.Tensor
               ) -> float:
    """The cost of the 8-lattice cut `fg` (True on the source side), in
    float64 on the tensors' device."""
    from gcn_grabcut_torch.ops.maxflow import OFFSETS_8
    e = excess.double()
    cost = e.clamp_min(0)[~fg].sum() + (-e).clamp_min(0)[fg].sum()
    H, W = fg.shape
    for c, (dy, dx) in zip(caps, OFFSETS_8):
        q = fg[max(0, dy):H + min(0, dy), max(0, dx):W + min(0, dx)]
        p = (slice(max(0, -dy), H + min(0, -dy)),
             slice(max(0, -dx), W + min(0, -dx)))
        cost = cost + (c[p].double() * (q != fg[p])).sum()
    return float(cost)


def run_multilevel(dev, card: str, img: np.ndarray,
                   trimap: np.ndarray) -> None:
    """Phase 13: the banded coarse-to-fine min-cut on the main path's
    image and trimap (see the docstring).  Reports; fails on a non-finite
    energy, a banded cut cheaper than the exact one on its own problem, or
    a mask of the wrong shape."""
    from gcn_grabcut_torch import grabcut as gc
    from gcn_grabcut_torch.core.graph import TRIMAP_FG, TRIMAP_PROB_FG
    from gcn_grabcut_torch.ops import gmm as gmm_ops
    from gcn_grabcut_torch.ops import maxflow as mf

    cfg = gc.GrabCutConfig()
    k = cfg.n_components
    tri, degenerate = gc._repair(torch.as_tensor(trimap, device=dev).to(
        torch.uint8))
    if degenerate:
        fail("the main path's trimap is one-sided")
    pix = gc.preprocess_device(torch.as_tensor(img, device=dev).float(),
                               cfg.color_space)
    fg_sel = (tri == TRIMAP_FG) | (tri == TRIMAP_PROB_FG)
    comp0 = torch.where(fg_sel, gmm_ops.kmeans(pix, fg_sel.float(), k, seed=0),
                        gmm_ops.kmeans(pix, (~fg_sel).float(), k, seed=1))
    solve = gc.grid_mincut_multilevel
    problems, masks, secs = {}, {}, {}

    def recording(excess, caps, **kwargs):
        fg = solve(excess, caps, **kwargs)
        problems[level].append((excess, caps, fg))
        return fg

    gc.grid_mincut_multilevel = recording
    try:
        for level in (0,) + ML_LEVELS:
            problems[level] = []
            torch.cuda.synchronize()
            t = time.perf_counter()
            mask, _ = gc._grabcut_solve(pix, tri, comp0, cfg.gamma,
                                        cfg.n_iter, k, ml_levels=level)
            torch.cuda.synchronize()
            secs[level] = time.perf_counter() - t
            masks[level] = (mask == TRIMAP_FG) | (mask == TRIMAP_PROB_FG)
    finally:
        gc.grid_mincut_multilevel = solve
    ok = True
    parts = [f"ml_levels=0 {secs[0]:.3f} s"]
    for level in ML_LEVELS:
        agree = float((masks[level] == masks[0]).float().mean())
        excess, caps, fg = problems[level][-1]
        exact = mf.grid_mincut(excess, caps)
        ratio = cut_energy(excess, caps, fg) / cut_energy(excess, caps,
                                                          exact)
        ok &= (masks[level].shape == masks[0].shape and np.isfinite(ratio)
               and ratio >= 1.0 - 1e-6 and len(problems[level]) == cfg.n_iter)
        parts.append(f"ml_levels={level} {secs[level]:.3f} s, mask agreement "
                     f"with ml_levels=0 {agree:.6f}, last cut's energy / the "
                     f"exact cut's {ratio:.6f}")
    print(f"multilevel GrabCut ({IMAGE_HW}^2 main-path image and trimap, "
          f"{cfg.n_iter} iterations; {card}): " + "; ".join(parts),
          flush=True)
    # The first iteration's energy, solved alone by each solver.
    excess, caps, _ = problems[ML_LEVELS[0]][0]

    def timed_cut(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fg = fn()
        torch.cuda.synchronize()
        return fg, time.perf_counter() - t

    exact, s_exact = timed_cut(lambda: mf.grid_mincut(excess, caps))
    e_exact = cut_energy(excess, caps, exact)
    parts = [f"grid_mincut {s_exact:.3f} s"]
    for level in ML_LEVELS:
        fg, s_ml = timed_cut(lambda: mf.grid_mincut_multilevel(
            excess, caps, levels=level))
        ratio = cut_energy(excess, caps, fg) / e_exact
        ok &= bool(np.isfinite(ratio)) and ratio >= 1.0 - 1e-6
        parts.append(f"levels={level} {s_ml:.3f} s, agreement "
                     f"{float((fg == exact).float().mean()):.6f}, cut cost "
                     f"/ exact {ratio:.6f}")
    print(f"grid_mincut_multilevel on the first iteration's energy "
          f"({IMAGE_HW}^2; {card}): " + "; ".join(parts), flush=True)
    if not ok:
        fail("the multilevel min-cut gave a cut cheaper than the exact one, "
             "a non-finite energy or a mask of the wrong shape")


def run_scatter(dev, card: str) -> None:
    """Phase 14: core/scatter.py on the card against the CPU."""
    from gcn_grabcut_torch.core import scatter as sc

    r = np.random.RandomState(14)
    idx = r.randint(0, SCATTER_SEGMENTS, SCATTER_ROWS)
    idx[idx % 97 == 5] += 1                     # empty segments
    vals = (r.randn(SCATTER_ROWS, SCATTER_COLS) * 3).astype(np.float32)
    w = (r.rand(SCATTER_ROWS) * (r.rand(SCATTER_ROWS) > 0.3)
         ).astype(np.float32)
    mask = (r.rand(SCATTER_ROWS) > 0.25).astype(np.float32)
    h = (r.randn(TRAIN_GRAPHS, DENSE_SEGMENTS, HIDDEN) * 2 + 1
         ).astype(np.float32)
    hm = (r.rand(TRAIN_GRAPHS, DENSE_SEGMENTS) > 0.2).astype(np.float32)
    n = SCATTER_SEGMENTS
    cases = {
        "scatter_add": lambda t: sc.scatter_add(t["v"], t["i"], n),
        "scatter_mean": lambda t: sc.scatter_mean(t["v"], t["i"], n,
                                                  t["w"]),
        "scatter_max": lambda t: sc.scatter_max(t["v"], t["i"], n),
        "scatter_softmax": lambda t: sc.scatter_softmax(t["v"][:, 0],
                                                        t["i"], n, t["m"]),
        "masked_mean": lambda t: sc.masked_mean(t["h"], t["hm"]),
        "masked_softmax": lambda t: sc.masked_softmax(t["h"][..., 0],
                                                      t["hm"]),
        "masked_var": lambda t: torch.cat([
            x.reshape(-1) for x in sc.masked_var(t["h"], t["hm"],
                                                 axis=(0, 1))]),
    }
    arrays = dict(v=vals, i=idx, w=w, m=mask, h=h, hm=hm)
    on = {d: {k: torch.as_tensor(a, device=d) for k, a in arrays.items()}
          for d in (dev, "cpu")}
    errs, ok = {}, True
    for name, fn in cases.items():
        got, want = fn(on[dev]).cpu(), fn(on["cpu"])
        if name == "scatter_max":
            ok &= bool(torch.equal(got, want))
            errs[name] = "exact" if torch.equal(got, want) else "differs"
            continue
        err = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        ok &= err <= SCATTER_TOL
        errs[name] = f"{err:.1e}"
    empty = int((np.bincount(idx, minlength=n) == 0).sum())
    print(f"core/scatter.py card vs CPU ({SCATTER_ROWS} rows into "
          f"{SCATTER_SEGMENTS} segments, {empty} empty; ({TRAIN_GRAPHS}, "
          f"{DENSE_SEGMENTS}, {HIDDEN}) masked; "
          f"{card}): " + ", ".join(f"{k} {v}" for k, v in errs.items())
          + f" (tol {SCATTER_TOL:.0e}, max exact)", flush=True)
    if not ok:
        fail("core/scatter.py on the card disagrees with the CPU")


def check_keep_largest_repeats(dev) -> None:
    """Keep-largest's component sums run in a fixed order: repeated runs
    on one mask give bit-identical sums and masks."""
    from gcn_grabcut_torch.ops.connected import (_clean_mask,
                                                 connected_components)
    from gcn_grabcut_torch.ops.region import segment_sum
    hw = DENSE_HW
    yy, xx = np.mgrid[0:hw, 0:hw]
    mask = np.zeros((hw, hw), np.uint8)
    for cy, cx, r in ((200, 220, 110), (420, 100, 50), (90, 430, 40),
                      (400, 400, 60)):
        mask[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 1
    mask[:, :6] = 1                                 # a frame-like strip
    rng = np.random.RandomState(11)
    post = (0.5 + 0.5 * rng.rand(hw, hw)).astype(np.float32)
    m = torch.from_numpy(mask).to(dev)[None]
    p = torch.from_numpy(post).to(dev)[None]
    labels = connected_components(m > 0).long().reshape(-1).clamp_max(
        hw * hw - 1)
    planes = torch.stack([torch.ones(hw * hw, device=dev), p.reshape(-1)], 1)
    min_area = 0.002 * hw * hw
    outs, sums = [], []
    t = time.perf_counter()
    for _ in range(KEEP_LARGEST_REPEATS):
        outs.append(_clean_mask(m, min_area, True, p))
        sums.append(segment_sum(labels, planes, hw * hw))
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t) / KEEP_LARGEST_REPEATS
    same_mask = all(torch.equal(o, outs[0]) for o in outs)
    same_sums = all(torch.equal(s_, sums[0]) for s_ in sums)
    cpu = _clean_mask(m.cpu(), min_area, True, p.cpu())
    cpu_sums = segment_sum(labels.cpu(), planes.cpu(), hw * hw)
    print(f"keep-largest fixed-order sums ({hw}^2 mask, "
          f"{int(torch.unique(labels).numel()) - 1} components): "
          f"{KEEP_LARGEST_REPEATS} repeats, masks identical {same_mask}, "
          f"sums identical {same_sums}; equal to the CPU's: mask "
          f"{bool(torch.equal(outs[0].cpu(), cpu))}, sums "
          f"{bool(torch.equal(sums[0].cpu(), cpu_sums))}; "
          f"{per_call * 1e3:.2f} ms per clean-up and sum", flush=True)
    if not (same_mask and same_sums):
        fail("keep-largest's sums differ between runs")


def flat_image(hw: int) -> np.ndarray:
    """Uniform colour regions and a uniform disc."""
    img = np.empty((hw, hw, 3), np.uint8)
    img[:] = (70, 90, 120)
    img[2 * hw // 3:] = (60, 110, 50)
    img[:, : hw // 5] = (140, 120, 100)
    yy, xx = np.mgrid[0:hw, 0:hw]
    img[(yy - hw // 2) ** 2 + (xx - int(hw * 0.55)) ** 2 < (hw // 5) ** 2] = (
        220, 60, 40)
    return img


def run_flat_colour(card: str) -> None:
    """Open fault 1: a flat-colour image through the dense path on the card
    and on the CPU (the port on both).  Reported, not gated: the std-Lab
    feature cancels in float32 on uniform regions."""
    import copy

    import gcn_grabcut_torch as gt

    model, _ = load_ensemble()
    cfg = gt.SuperpixelGraphConfig(n_segments=DENSE_SEGMENTS,
                                   bg_connectivity=True)
    img = flat_image(DENSE_HW)
    card_res = gt.GCNGrabCutPipeline(model, cfg).segment_batch(
        [img], **DENSE_SETTINGS)[0]
    t = time.perf_counter()
    cpu_res = gt.GCNGrabCutPipeline(copy.deepcopy(model).cpu(), cfg,
                                    device="cpu").segment_batch(
        [img], **DENSE_SETTINGS)[0]
    cpu_s = time.perf_counter() - t
    seg_agree = float((card_res.segments == cpu_res.segments).mean())
    dp = float(np.abs(card_res.probs - cpu_res.probs).max())
    print(f"flat-colour image through the dense path, card vs CPU ({card}; "
          f"the CPU run {cpu_s:.1f} s): SLIC agreement {seg_agree:.6f}; max "
          f"|dp| {dp:.3e} over {card_res.probs.shape[0]} nodes; trimap "
          f"pixels differing {int((card_res.trimap != cpu_res.trimap).sum())}"
          f", mask pixels differing "
          f"{int((card_res.binary_mask != cpu_res.binary_mask).sum())} of "
          f"{DENSE_HW * DENSE_HW}; FG {card_res.binary_mask.mean():.4f} / "
          f"{cpu_res.binary_mask.mean():.4f}", flush=True)


@contextlib.contextmanager
def recording_calls(module, name: str):
    """Records the positional arguments of every call of module.name (a
    module-level function, looked up at call time) in the yielded list."""
    fn = getattr(module, name)
    calls: list = []

    def recording(*args, **kwargs):
        calls.append(args)
        return fn(*args, **kwargs)

    setattr(module, name, recording)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def spiral_labels(hw: int) -> np.ndarray:
    """Label 1 on a one-pixel square spiral corridor (laps two apart) in
    label 0, label 2 over the bottom-right corner: components that need
    hundreds of Jacobi steps, and a label cut in two."""
    lab = np.zeros((hw, hw), np.int64)
    y = x = 1
    lab[y, x] = 1
    n = hw - 3
    lengths = [n, n, n] + [m for m in range(n - 2, 0, -2) for _ in (0, 1)]
    for i, length in enumerate(lengths):
        dy, dx = ((0, 1), (1, 0), (0, -1), (-1, 0))[i % 4]
        for _ in range(length):
            y, x = y + dy, x + dx
            lab[y, x] = 1
    lab[-6:, -6:] = 2
    return lab


def serpentine_mask(hw: int) -> np.ndarray:
    """One path along every other row, turning at alternate ends."""
    m = np.zeros((hw, hw), bool)
    for i, y in enumerate(range(1, hw - 1, 2)):
        m[y, 1:hw - 1] = True
        if y + 2 < hw - 1:
            m[y + 1, hw - 2 if i % 2 == 0 else 1] = True
    return m


def wall_s(fn) -> float:
    """Host seconds of fn() from a synchronised start to a synchronised
    end (for the plain versions, which sync the host themselves)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def loop_barrier_us(loop) -> float:
    """Device microseconds of one empty grid-wide barrier, loop(n)
    launching n of them on a kernel's grid."""
    loop(10)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    loop(CUT_BARRIERS)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / CUT_BARRIERS


def build_kernel_inputs(dev) -> tuple:
    """Phase 17's inputs to the connectivity kernel and the mask
    components kernel: those recorded at their call sites in the dense
    cell's segment_batch (B=8 at 512^2 and its 0.75-scale rebuild) and the
    large cell's (1536^2), and the cap cases (a spiral with max_sweeps
    CONNECT_CAPS, orphans alone, a serpentine with max_iters
    COMPONENTS_CAPS).  Returns ({name: (labels, k, absorb_sweeps,
    max_sweeps)}, {name: (mask, connectivity, max_iters)}, (the dense
    pipeline, its images, its config, the large config))."""
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.ops import connected as cc
    from gcn_grabcut_torch.ops import slic as slic_ops

    model, _ = load_ensemble()
    cfg = gt.SuperpixelGraphConfig(n_segments=DENSE_SEGMENTS,
                                   bg_connectivity=True)
    pipe = gt.GCNGrabCutPipeline(model, cfg)
    images = [make_image(DENSE_HW, s) for s in range(DENSE_IMAGES)]
    with recording_calls(slic_ops, "repair_connectivity") as dense_rep, \
            recording_calls(cc, "connected_components") as dense_cc:
        pipe.segment_batch(images, **DENSE_SETTINGS)
    large_cfg = gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    large_pipe = gt.GCNGrabCutPipeline(gt.ResGCNNet(
        hidden_channels=HIDDEN, n_layers=N_LAYERS,
        generator=torch.Generator().manual_seed(MODEL_SEED)), large_cfg)
    with recording_calls(slic_ops, "repair_connectivity") as large_rep, \
            recording_calls(cc, "connected_components") as large_cc:
        large_pipe.segment_batch([make_image(IMAGE_HW)])
    if len(dense_rep) != 2 or len(dense_cc) != 1 or len(large_rep) != 1 \
            or len(large_cc) != 1:
        fail(f"recorded {len(dense_rep)} / {len(large_rep)} repairs and "
             f"{len(dense_cc)} / {len(large_cc)} labellings (dense / large)")
    spiral = torch.as_tensor(np.stack([spiral_labels(96),
                                       spiral_labels(96).T.copy()]),
                             device=dev)
    serp = torch.as_tensor(serpentine_mask(512)[None], device=dev)
    repairs = {
        f"dense B={DENSE_IMAGES} {DENSE_HW}^2": (*dense_rep[0][:2], 4, 64),
        f"dense B={DENSE_IMAGES} 0.75-scale rebuild": (*dense_rep[1][:2], 4,
                                                       64),
        f"large {IMAGE_HW}^2": (*large_rep[0][:2], 4, 64)}
    for cap in CONNECT_CAPS:
        repairs[f"spiral 96^2 x 2, max_sweeps={cap}"] = (spiral, 3, 0, cap)
    repairs["absorb only, dense 4 sweeps"] = (dense_rep[0][0], 1, 4, 0)
    labellings = {
        f"dense B={DENSE_IMAGES} {DENSE_HW}^2": (dense_cc[0][0], 8, 512),
        f"large {IMAGE_HW}^2": (large_cc[0][0], 8, 512)}
    for conn in (8, 4):
        for cap in COMPONENTS_CAPS:
            labellings[f"serpentine 512^2, {conn}-conn, max_iters={cap}"] = (
                serp, conn, cap)
    return repairs, labellings, (pipe, images, cfg, large_cfg)


def connectivity_traffic(info: dict, shape: tuple, absorb: int,
                         super_steps: int) -> int:
    """The connectivity kernel's own traffic in bytes, from its tallies:
    what its design moves, beside the bytes the repair needs (the bound).
    An orphan pass reads a 50 x 50 window of labels for each 32 x 32 tile
    and writes the labels (the last, before the components, also the
    same-label bits and a zero size: 9 bytes a pixel); a super-block reads
    a (32 + 2 super_steps)^2 window of components and bits for each tile
    it runs (5 bytes a pixel; the first only the bits) and writes the
    tile's components; the size, score and flag passes read the
    components three times and the labels once and write the flags (17
    bytes a pixel); an absorption pass reads the same window of labels and
    flags for each tile it runs (5 bytes a pixel) and writes the tile's;
    the last pass copies labels, counted whole (8 bytes a pixel)."""
    B, H, W = shape
    n = B * H * W
    tiles = B * -(-H // 32) * -(-W // 32)
    tile, orphan_win = 32 * 32, 50 * 50
    win = (32 + 2 * super_steps) ** 2
    passes = max(1, -(-absorb // 4))
    total = passes * (tiles * orphan_win * 4 + n * 4)
    if not info["blocks"]:
        return total
    total += n * 5
    total += tiles * (win + tile * 4)
    total += (info["tiles_run"] - tiles) * (win * 5 + tile * 4)
    total += n * 17
    total += info["absorb_tiles_run"] * (win + tile) * 5
    return total + n * 8


def components_traffic(info: dict, shape: tuple, band_rows: int) -> int:
    """The mask components kernel's own traffic in bytes, from its sweeps:
    a sweep's row pass reads each band's labels and one row above and
    below ((R + 2) / R x 4 bytes a pixel; the first sweep the 1-byte mask
    instead) and writes the rows' minima (4); the column pass reads the
    minima twice and the labels once (the first sweep the mask) and writes
    the labels (counted whole).  Every image is counted in every sweep:
    for a batch whose images stop early this is an upper bound."""
    B, H, W = shape
    n = B * H * W
    halo = (band_rows + 2) / band_rows
    if not info["sweeps"]:
        return n * 5
    first = n * (halo + 4 + 8 + 1 + 4)
    return int(first + (info["sweeps"] - 1) * n * (halo * 4 + 4 + 8 + 4 + 4))


def build_kernel_case(name: str, kernel, plain, pixels: int,
                      bytes_per_px: int, tally, floor_us: float,
                      traffic) -> dict:
    """One case of phase 17: the kernel against its plain version on the
    card, bit for bit, and its loop counts against the plain version's,
    with the kernel's device ms, the plain version's wall ms, the bytes
    bound (the input read once and the labels written once, over
    PEAK_BYTES_S), its own traffic over PEAK_BYTES_S (traffic(tallies) in
    bytes) and the barrier floor (its barriers times an empty barrier's
    floor_us on its grid).  tally() gives the kernel's counts and the
    plain version's (after kernel() and plain() ran)."""
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    differ = int((got != want).sum())
    info, plain_counts = tally()
    ms = time_ms(kernel, reps=10, warmup=2)
    plain_ms = 1e3 * wall_s(plain)
    bound_ms = 1e3 * pixels * bytes_per_px / PEAK_BYTES_S
    own_ms = 1e3 * traffic(info) / PEAK_BYTES_S
    floor_ms = info["barriers"] * floor_us / 1e3
    print(f"  {name}: {differ} labels differ from the plain version; "
          f"kernel {ms:.4f} ms ({info}; the plain version's "
          f"{plain_counts}), plain {plain_ms:.4f} ms (wall), bytes bound "
          f"{bound_ms:.4f} ms ({ms / bound_ms:.1f}x), own traffic "
          f"{own_ms:.4f} ms, barrier floor {floor_ms:.4f} ms "
          f"({floor_us:.3f} us a barrier)", flush=True)
    if differ:
        fail(f"{name}: the kernel's labels differ from the plain version's "
             f"at {differ} pixels")
    if any(info[k] != v for k, v in plain_counts.items()):
        fail(f"{name}: the kernel's loop counts {info} are not the plain "
             f"version's {plain_counts}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "own_traffic_ms": own_ms, "barriers": info["barriers"],
            "barrier_floor_ms": floor_ms,
            "max_abs_err": float((got.long() - want.long()).abs().max())}


def repair_case(name: str, labels, k: int, absorb: int, sweeps: int,
                floor_us: float) -> dict:
    """build_kernel_case for the connectivity kernel (8 bytes a pixel: the
    labels read and written once); its tallies include tiles run and
    skipped."""
    from gcn_grabcut_torch.ops import slic as slic_ops

    def plain():
        out = slic_ops.absorb_orphans_plain(labels, absorb)
        return (slic_ops.enforce_connectivity_plain(out, k, sweeps)
                if sweeps else out)

    def tally():
        info = slic_ops.kernel_tally(
            slic_ops.repair_connectivity_cuda.last_ctrl)
        want = (slic_ops.enforce_connectivity_plain.last_loops if sweeps
                else {"blocks": 0, "rounds": 0})
        return info, want

    super_steps = slic_ops.kernel_grid()["super_steps"]
    return build_kernel_case(
        f"repair, {name}, K={k}",
        lambda: slic_ops.repair_connectivity_cuda(labels, k, absorb, sweeps),
        plain, labels.numel(), 8, tally, floor_us,
        lambda info: connectivity_traffic(info, tuple(labels.shape), absorb,
                                          super_steps))


def components_case(name: str, mask, conn: int, iters: int,
                    floor_us: float) -> dict:
    """build_kernel_case for the mask components kernel (5 bytes a pixel:
    the mask read once, the labels written once)."""
    from gcn_grabcut_torch.ops import connected as cc

    def tally():
        info = cc.kernel_tally(cc.connected_components_cuda.last_ctrl)
        return info, {"sweeps": cc.connected_components_plain.last_sweeps}

    band = cc.kernel_grid(*mask.shape[1:])["band_rows"]
    return build_kernel_case(
        f"components, {name}",
        lambda: cc.connected_components_cuda(mask, conn, iters),
        lambda: cc.connected_components_plain(mask, conn, iters),
        mask.numel(), 5, tally, floor_us,
        lambda info: components_traffic(info, tuple(mask.shape), band))


def same_arrays(a: dict, b: dict, keys) -> list:
    """The keys whose arrays differ in any bit."""
    return [k for k in keys if a[k].shape != b[k].shape
            or not same_bits(a[k], b[k])]


def run_build_kernels(dev, card: str, records: dict,
                      serving_rps: float) -> None:
    """Phase 17: the batched, sync-free graph build and clean-up.  (a) The
    connectivity kernel (csrc/slic_connectivity.cu) and the mask
    components kernel (csrc/mask_components.cu) against their plain
    versions on the card, bit for bit, with the plain version's loop
    counts, on build_kernel_inputs' cases; each kernel's ms, the plain
    version's, its bytes bound, its barriers and barrier floor, and the
    connectivity kernel's tiles run and skipped.  (b) Launches per dense
    B=8 segment_batch and per build.  (c) The batched build, trimap stage
    and clean-up at B=8 against each image alone, bit for bit.  (d) No
    host sync in build_graph_batch_arrays, _project_probs_device,
    _trimap_stage_device and _post_stage_device
    (torch.cuda.set_sync_debug_mode("error")).  (e) graph_build and dense
    B=8 images/s, and serving's requests/s, beside the per-image build's
    (BUILD_BEFORE)."""
    from gcn_grabcut_torch import pipeline as pl
    from gcn_grabcut_torch.grabcut import grabcut_batch_device
    from gcn_grabcut_torch.graph_build import build_graph_batch_arrays
    from gcn_grabcut_torch.ops import connected as cc
    from gcn_grabcut_torch.ops import image as im
    from gcn_grabcut_torch.ops import slic as slic_ops

    repairs, labellings, (pipe, images, cfg, large_cfg) = \
        build_kernel_inputs(dev)
    print(f"phase 17 ({card}): the connectivity kernel "
          f"(csrc/slic_connectivity.cu: absorb 4 sweeps, then "
          f"enforce_connectivity; grid {slic_ops.kernel_grid()}) and the "
          f"mask components kernel (csrc/mask_components.cu) against their "
          f"plain versions, bit for bit", flush=True)
    a_floor = loop_barrier_us(lambda n: slic_ops.barrier_loop_cuda(n, dev))
    rep = {name: repair_case(name, *case, floor_us=a_floor)
           for name, case in repairs.items()}
    comp = {}
    for name, (mask, conn, iters) in labellings.items():
        _, H, W = mask.shape
        floor = loop_barrier_us(
            lambda n, H=H, W=W: cc.barrier_loop_cuda(H, W, n, dev))
        if name.startswith(("dense", "large")):
            print(f"  components grid at {H} x {W}: {cc.kernel_grid(H, W)}",
                  flush=True)
        comp[name] = components_case(name, mask, conn, iters, floor)

    # (b) Launches per dense B=8 batch.
    slic_ops.repair_connectivity_cuda.kernel_launches = 0
    cc.connected_components_cuda.kernel_launches = 0
    pipe.segment_batch(images, **DENSE_SETTINGS)
    a_batch = slic_ops.repair_connectivity_cuda.kernel_launches
    b_batch = cc.connected_components_cuda.kernel_launches
    rgbs = torch.as_tensor(np.stack(images), device=dev).float()
    slic_ops.repair_connectivity_cuda.kernel_launches = 0
    build_graph_batch_arrays(rgbs, cfg, device=dev)
    a_build = slic_ops.repair_connectivity_cuda.kernel_launches
    print(f"  launches per dense B={DENSE_IMAGES} segment_batch: "
          f"connectivity {a_batch} (one a build: {DENSE_SETTINGS['ms_scales']}"
          f"), components {b_batch}; per build_graph_batch_arrays: "
          f"{a_build}", flush=True)
    if (a_batch, b_batch, a_build) != (len(DENSE_SETTINGS["ms_scales"]), 1,
                                       1):
        fail("the batched build or clean-up did not launch its kernel once "
             "a batch")

    # (c) B=8 against each image alone: the build at both scales, the
    # projection, the trimap stage on the batch's posteriors and the
    # clean-up on the batch's GrabCut masks.
    H = W = DENSE_HW
    hw75 = tuple(max(int(round(DENSE_HW * 0.75)), 64) for _ in range(2))
    keys = ("segments", "x", "edge_src", "edge_dst", "edge_attr",
            "edge_mask", "node_mask", "node_area", "centroids", "prior",
            "counts")
    rgbs75 = im.resize_bilinear(rgbs, hw75)
    out = build_graph_batch_arrays(rgbs, cfg, device=dev)
    out75 = build_graph_batch_arrays(rgbs75, cfg, device=dev)
    g, g75 = (pipe._graph(r)[1] for r in (rgbs, rgbs75))
    probs, probs75 = pipe._predict_probs_batch(g), pipe._predict_probs_batch(
        g75)
    grays = im.rgb_to_gray(rgbs) / 255.0

    def trimap_stage(sl):
        px = torch.stack([
            pl._project_probs_device(probs[sl], out["segments"][sl], (H, W)),
            pl._project_probs_device(probs75[sl], out75["segments"][sl],
                                     (H, W))]).mean(dim=0)
        tri = pl._trimap_stage_device(
            px, out["segments"][sl], grays[sl], out["prior"][sl],
            out["node_mask"][sl], DENSE_SETTINGS["threshold_fg"],
            DENSE_SETTINGS["threshold_bg"], DENSE_SETTINGS["filter_radius"])
        return px, tri

    px, trimaps = trimap_stage(slice(None))
    masks = grabcut_batch_device(rgbs, trimaps, pipe.gc_config)
    min_area = float(0.002 * H * W)

    def post(sl, keep):
        return pl._post_stage_device(masks[sl], trimaps[sl],
                                     out["segments"][sl], min_area, keep,
                                     True, px[sl][..., 1] if keep else None)

    packed = {keep: post(slice(None), keep) for keep in (False, True)}
    bad = []
    for b in range(DENSE_IMAGES):
        sl = slice(b, b + 1)
        one = build_graph_batch_arrays(rgbs[sl], cfg, device=dev)
        bad += [f"build {k} image {b}" for k in same_arrays(
            {k: v[b] for k, v in out.items()},
            {k: v[0] for k, v in one.items()}, keys)]
        one75 = build_graph_batch_arrays(im.resize_bilinear(rgbs[sl], hw75),
                                         cfg, device=dev)
        bad += [f"0.75 build {k} image {b}" for k in same_arrays(
            {k: v[b] for k, v in out75.items()},
            {k: v[0] for k, v in one75.items()}, keys)]
        px1, tri1 = trimap_stage(sl)
        if not same_bits(px1[0], px[b]):
            bad.append(f"pixel posteriors image {b}")
        if not torch.equal(tri1[0], trimaps[b]):
            bad.append(f"trimap image {b}")
        for keep in (False, True):
            if not torch.equal(post(sl, keep)[0], packed[keep][b]):
                bad.append(f"clean-up (keep_largest={keep}) image {b}")
    print(f"  B={DENSE_IMAGES} against each image alone (build at 1.0 and "
          f"0.75, projection, trimap stage, clean-up both ways): "
          f"{len(bad)} arrays differ {bad[:6]}", flush=True)
    if bad:
        fail(f"a batch changed an image's outputs: {bad[:6]}")

    # (d) No host sync in the stages.
    large_rgb = torch.as_tensor(make_image(IMAGE_HW)[None], device=dev
                                ).float()
    stages = {
        f"build_graph_batch_arrays dense B={DENSE_IMAGES}":
            lambda: build_graph_batch_arrays(rgbs, cfg, device=dev),
        f"build_graph_batch_arrays large {IMAGE_HW}^2":
            lambda: build_graph_batch_arrays(large_rgb, large_cfg,
                                             device=dev),
        "_project_probs_device (0.75 -> 1.0)":
            lambda: pl._project_probs_device(probs75, out75["segments"],
                                             (H, W)),
        "_trimap_stage_device": lambda: trimap_stage(slice(None)),
        "_post_stage_device": lambda: post(slice(None), False),
        "_post_stage_device keep_largest": lambda: post(slice(None), True),
    }
    torch.cuda.synchronize()
    for name, fn in stages.items():
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            fail(f"{name} synchronised the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"  host syncs under set_sync_debug_mode('error'): 0 in "
          f"{', '.join(stages)}", flush=True)

    # (e) The end-to-end figures beside the per-image build's.
    builds = [wall_s(lambda: build_graph_batch_arrays(rgbs, cfg, device=dev))
              for _ in range(3)]
    batches = [wall_s(lambda: pipe.segment_batch(images, **DENSE_SETTINGS))
               for _ in range(3)]
    split8 = pipe.segment_batch(images, **DENSE_SETTINGS)[0].timing
    ips = DENSE_IMAGES / float(np.median(batches))
    print(f"  dense B={DENSE_IMAGES} ({card}): build_graph_batch_arrays "
          f"median {float(np.median(builds)):.4f} s (per-image build "
          f"{BUILD_BEFORE['graph_build_s']} s); segment_batch median "
          f"{float(np.median(batches)):.4f} s = {ips:.2f} images/s (before "
          f"{BUILD_BEFORE['dense_images_s']}); device split "
          f"{split(split8)}; serving {serving_rps:.4f} requests/s (before "
          f"{BUILD_BEFORE['serving_requests_s']})", flush=True)

    large_a, large_b = rep[f"large {IMAGE_HW}^2"], comp[f"large {IMAGE_HW}^2"]
    dense_a = rep[f"dense B={DENSE_IMAGES} {DENSE_HW}^2"]
    dense_b = comp[f"dense B={DENSE_IMAGES} {DENSE_HW}^2"]
    records["slic_connectivity"].update({
        "name": "slic_connectivity", "route": "cuda",
        "source": "gcn_grabcut_torch/csrc/slic_connectivity.cu",
        "replaces": "gcn_grabcut_tpu/ops/slic.py:216 (enforce_connectivity's "
                    "lax.while_loops at :263 and :302, _absorb_orphans :173; "
                    "XLA, not Pallas)",
        "max_abs_err": large_a["max_abs_err"], "ms": large_a["ms"],
        "plain_ms": large_a["plain_ms"], "bound_ms": large_a["bound_ms"],
        "bound_by": "bytes", "own_traffic_ms": large_a["own_traffic_ms"],
        "barriers": large_a["barriers"],
        "barrier_floor_ms": large_a["barrier_floor_ms"],
        "dense_ms": dense_a["ms"], "dense_bound_ms": dense_a["bound_ms"],
        "library_ms": None})
    records["mask_components"].update({
        "name": "mask_components", "route": "cuda",
        "source": "gcn_grabcut_torch/csrc/mask_components.cu",
        "replaces": "gcn_grabcut_tpu/ops/connected.py:44 "
                    "(connected_components' lax.while_loop at :79; XLA, not "
                    "Pallas)",
        "max_abs_err": large_b["max_abs_err"], "ms": large_b["ms"],
        "plain_ms": large_b["plain_ms"], "bound_ms": large_b["bound_ms"],
        "bound_by": "bytes", "own_traffic_ms": large_b["own_traffic_ms"],
        "barriers": large_b["barriers"],
        "barrier_floor_ms": large_b["barrier_floor_ms"],
        "dense_ms": dense_b["ms"], "dense_bound_ms": dense_b["bound_ms"],
        "library_ms": None})


# Bytes a pixel each colour-model pass must move (csrc/gmm_passes.cu): the
# pixels (12) and the class plane (1); DRAW two noise planes (8), LABELS
# and FIT the int64 labels (8), TERMINAL e_carry, E_prev, E_t and the
# excess (16).  ASSIGN writes its labels (8 more) on the last iteration
# only.
GMM_PASS_BYTES = {"seed": 1, "draw": 21, "lloyd": 13, "labels": 21,
                  "fit": 21, "assign": 13, "terminal": 29}


def gmm_solve_passes(k: int, n_iter: int) -> dict:
    """The colour-model passes of one lock-step solve by kind: the seeded
    k-means (a seed pass, k - 1 draws, the Lloyd steps, the labels), the
    first fit, and an assign and a terminal pass an iteration."""
    from gcn_grabcut_torch.ops import gmm
    return {"seed": 1, "draw": k - 1, "lloyd": gmm.KMEANS_STEPS,
            "labels": 1, "fit": 1, "assign": n_iter, "terminal": n_iter}


def gmm_case(B: int, hw: int, seed: int):
    """B textured hw^2 images (RGB, float32 on the card) and trimaps round
    each one's disc: FG inside, PR_FG round it, PR_BG beyond, BG at the
    border."""
    imgs = np.stack([textured_image(hw, seed + b) for b in range(B)])
    yy, xx = np.mgrid[0:hw, 0:hw]
    d = np.hypot(yy - hw // 2, xx - int(hw * 0.47)) / (hw // 4)
    tri = np.full((hw, hw), 2, np.uint8)
    tri[d < 1.3] = 3
    tri[d < 0.6] = 1
    edge = hw // 16
    tri[:edge] = tri[-edge:] = tri[:, :edge] = tri[:, -edge:] = 0
    pix = torch.as_tensor(imgs, device="cuda").float()
    return pix, torch.as_tensor(np.stack([tri] * B), device="cuda")


def run_gmm_passes(dev, card: str, record: dict) -> None:
    """The colour-model passes (csrc/gmm_passes.cu) at the main path's
    shapes, 8 x 512^2 and 1 x 1536^2 (RGB, k = 5), into `record`: a
    lock-step solve's k-means and five iterations against the plain steps
    on the card, bit for bit (labels, every fit, the components and E_t
    and the excess of each iteration, given the same carried excess); the
    whole solve's colour models timed both ways, its passes counted; then
    each pass kind's device ms, launched alone on the state a solve left,
    beside its bytes bound at 3.35 TB/s and the plain steps' ms for the
    same work, and the float64 cuBLAS GEMM of one fit's x x^T sums (the
    yardstick the port no longer calls)."""
    from gcn_grabcut_torch.ops import gmm
    k, lam, n_iter = 5, 450.0, 5
    solve_passes = gmm_solve_passes(k, n_iter)
    record.update(kernel="gmm_passes", card=card, shapes={})
    for B, hw in ((8, DENSE_HW), (1, IMAGE_HW)):
        pix, tri = gmm_case(B, hw, seed=40)
        fg = (tri == 1) | (tri == 3)
        n = B * hw * hw
        real_on_card = gmm._on_card
        r = np.random.RandomState(3)
        energies = [[torch.as_tensor(r.randn(B, hw, hw).astype(np.float32)
                                     * 100, device=dev) for _ in range(2)]
                    for _ in range(n_iter)]

        def solve(keep: bool):
            """class_components, the first fit and n_iter x (refit,
            terminal), as _iterate runs them; with `keep` every output."""
            comp = gmm.class_components(pix, fg, k)
            models = gmm.ColourModels(pix, k)
            models.fit(tri, comp)
            out = [comp]
            if keep:
                out += [models.gmm(c)[name].clone() for c in (0, 1)
                        for name in ("weights", "means", "inv_cov",
                                     "log_norm")]
            for it in range(n_iter):
                assigned = models.refit(tri, want_comp=it == n_iter - 1)
                terminal = models.terminal(tri, lam, *energies[it])
                if keep:
                    if it == n_iter - 1:
                        out.append(assigned)
                    out += list(terminal)
                    out += [models.gmm(c)["log_norm"].clone()
                            for c in (0, 1)]
            return out

        def plain_steps(fn):
            gmm._on_card = lambda t: False
            try:
                return fn()
            finally:
                gmm._on_card = real_on_card

        got = solve(True)
        want = plain_steps(lambda: solve(True))
        torch.cuda.synchronize()
        bad = [i for i, (a, b) in enumerate(zip(got, want))
               if not same_bits(a, b)]
        n_out = len(got)
        if bad or n_out != len(want):
            fail(f"gmm passes at B={B} {hw}^2: outputs {bad} of {n_out} "
                 f"differ from the plain steps")
        del got, want

        # The whole solve's colour models, timed and counted.
        before = gmm.CardPasses.kernel_launches
        solve(False)
        solve_launches = gmm.CardPasses.kernel_launches - before
        if solve_launches != sum(solve_passes.values()):
            fail(f"a solve launched {solve_launches} colour-model passes, "
                 f"expected {sum(solve_passes.values())}")
        solve_ms = time_ms(lambda: solve(False), reps=10, warmup=2)
        solve_plain = plain_steps(lambda: time_ms(lambda: solve(False),
                                                  reps=3, warmup=1))

        # Each pass kind alone on a state a solve left (each launch redoes
        # its own work on the model it finds).
        run = gmm.CardPasses(pix, k)
        cls, mask = run._cls(fg), run._cls(tri)
        noise = tuple(gmm.device_noise(s, hw * hw, k - 1, pix.device)
                      for s in gmm.KMEANS_SEEDS)
        labels = torch.empty((B, hw, hw), dtype=torch.int64, device=dev)
        e = [torch.zeros((B, hw, hw), device=dev) for _ in range(4)]
        run.launch(gmm.SEED, cls)
        for i in range(k - 1):
            run.launch(gmm.DRAW, cls, step=i, draws=k - 1, noise=noise)
        for _ in range(gmm.KMEANS_STEPS):
            run.launch(gmm.LLOYD, cls)
        run.launch(gmm.LABELS, cls, comp_out=labels)
        run.launch(gmm.FIT, mask, comp_in=labels)
        launches = {
            "seed": lambda: run.launch(gmm.SEED, cls),
            "draw": lambda: run.launch(gmm.DRAW, cls, step=k - 2,
                                       draws=k - 1, noise=noise),
            "lloyd": lambda: run.launch(gmm.LLOYD, cls),
            "labels": lambda: run.launch(gmm.LABELS, cls, comp_out=labels),
            "fit": lambda: run.launch(gmm.FIT, mask, comp_in=labels),
            "assign": lambda: run.launch(gmm.ASSIGN, mask),
            "terminal": lambda: run.launch(gmm.TERMINAL, mask, e_carry=e[0],
                                           e_prev=e[1], e_t=e[2],
                                           excess=e[3], lam=lam)}

        # The plain steps of the same work (both classes each).
        flat = pix.reshape(B, -1, 3)
        w = fg.reshape(B, -1).float()
        ws = (w, 1.0 - w)
        cen = [torch.rand((B, k, 3), device=dev) * 255 for _ in range(2)]
        fit = gmm.fit_gmm(pix, fg.float(), labels, k)
        xx = (flat[..., :, None] * flat[..., None, :]).reshape(B, -1, 9)
        onehot = torch.nn.functional.one_hot(labels.reshape(B, -1), k
                                             ).float() * w[..., None]

        inactive = torch.where(torch.arange(k, device=dev) <= k - 2, 0.0,
                               float("inf"))

        def plain_draw():
            for c in (0, 1):
                d2 = (gmm._sq_dist(flat, cen[c]) + inactive).amin(dim=-1)
                logits = torch.log((ws[c] * d2).clamp_min(1e-30))
                gmm._rows(flat, torch.argmax(logits + noise[c][k - 2], 1))

        def plain_lloyd():
            for c in (0, 1):
                lab = torch.argmin(gmm._sq_dist(flat, cen[c]), dim=-1)
                oh = torch.nn.functional.one_hot(lab, k).float() \
                    * ws[c][..., None]
                tot, cnt = gmm._pixel_matmul(oh, flat), \
                    gmm._pixel_sum(oh)[..., None]
                torch.where(cnt > 0, tot / cnt.clamp_min(1e-6), cen[c])

        plain = {
            "seed": lambda: [gmm._rows(flat, torch.argmax(v, 1))
                             for v in ws],
            "draw": plain_draw,
            "lloyd": plain_lloyd,
            "labels": lambda: torch.where(fg.reshape(B, -1), *[
                torch.argmin(gmm._sq_dist(flat, c), dim=-1) for c in cen]),
            "fit": lambda: [gmm.fit_gmm(pix, v.reshape(B, hw, hw), labels,
                                        k) for v in ws],
            "assign": lambda: [gmm.fit_gmm(pix, v.reshape(B, hw, hw),
                                           gmm.assign_components(pix, fit),
                                           k) for v in ws],
            "terminal": lambda: e[0] + (torch.where(
                tri == 1, lam, torch.where(tri == 0, -lam, (
                    gmm.gmm_log_prob(pix, fit) - gmm.gmm_log_prob(pix, fit)
                ).clamp(-lam, lam))) - e[1])}
        rows = {}
        for kind in gmm.PASS_KINDS:
            ms = time_ms(launches[kind])
            bound = GMM_PASS_BYTES[kind] * n / PEAK_BYTES_S * 1e3
            rows[kind] = {"ms": round(ms, 4), "bound_ms": round(bound, 4),
                          "plain_ms": round(time_ms(plain[kind], reps=5,
                                                    warmup=1), 4)}
        library = time_ms(lambda: gmm._pixel_matmul(onehot, xx))
        solve_bound = sum(solve_passes[kd] * rows[kd]["bound_ms"]
                          for kd in rows)
        record["shapes"][f"B{B}x{hw}"] = dict(
            passes=rows, library_ms=round(library, 4),
            solve_ms=round(solve_ms, 4), solve_bound_ms=round(solve_bound, 4),
            solve_plain_ms=round(solve_plain, 4),
            solve_launches=solve_launches,
            chunks=dict(zip(gmm.PASS_KINDS, run.chunks)))
        print(f"gmm passes B={B} {hw}^2 (k=5, RGB; {card}): bit for bit "
              f"with the plain steps ({n_out} outputs); a "
              f"solve's colour models {solve_ms:.4f} ms, {solve_launches} "
              f"launches (bound {solve_bound:.4f}; plain steps "
              f"{solve_plain:.4f}); each pass kind alone, ms (bound, plain): "
              + ", ".join(f"{kd} {r['ms']} ({r['bound_ms']}, {r['plain_ms']})"
                          for kd, r in rows.items())
              + f"; float64 GEMM of one fit's x x^T sums {library:.4f}",
              flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if sys.argv[1:] == ["--eval-all"]:
        # The evaluation phase alone, on all EVAL_N images.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = gpu_line()
        print(card, flush=True)
        run_eval_cli(card, limit=EVAL_N)
        return
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]} (only --eval-all)")
    import gcn_grabcut_torch as gt     # fails outside the checkout
    from gcn_grabcut_torch import kernels
    from gcn_grabcut_torch.graph_build import num_nodes_for

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
          f"{card}", flush=True)
    print(optional_packages(), flush=True)

    t = time.perf_counter()
    libs = kernels.build()
    print(f"kernel build: {time.perf_counter() - t:.2f} s "
          f"({', '.join(sorted(libs))})", flush=True)

    k = num_nodes_for(IMAGE_HW, IMAGE_HW,
                      gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS))

    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    record = timed("kernels", check_banded_spmm, dev)
    rings = timed("rings", check_ring_collectives, dev, k)
    timed("ring stress", stress_ring_collectives, dev, k)
    seg_record, seg_arrays = timed("segment sums", check_segment_sum, dev)
    timed("gather audit", audit_gathers, dev, seg_arrays)
    del seg_arrays
    cut_record = {}
    build_records = {"slic_connectivity": {}, "mask_components": {}}
    gmm_record = {}
    main_image = timed("main path", run_main_path, dev, record, seg_record,
                       cut_record, build_records, gmm_record)
    timed("sharded", run_sharded_path, dev, rings, k)
    dense = timed("dense", run_dense_path, dev, card)
    timed("keep-largest", check_keep_largest_repeats, dev)
    timed("flat colour", run_flat_colour, card)
    timed("staged", run_staged_paths, card)
    timed("stream", run_stream, card)
    timed("predict_probs", run_predict_probs, card)
    graphs = timed("train step", run_train_step, dev, card)
    timed("train cli", run_train_cli, graphs, card)
    evaluated = timed("eval cli", run_eval_cli, card)
    timed("inference cli", run_inference_cli, evaluated, card)
    timed("variants", run_variants, dev, card, graphs)
    serving_rps = timed("serving", run_serving, card)
    timed("data parallel", run_data_parallel, dev, card, graphs, rings, k)
    timed("data parallel variants", run_data_parallel_variants, dev, card,
          graphs, rings)
    timed("multilevel", run_multilevel, dev, card, *main_image)
    timed("scatter", run_scatter, dev, card)
    timed("lock step", run_lock_step, dev, card, *dense)
    timed("min-cut kernel", run_mincut_kernel, dev, card, cut_record,
          main_image, dense)
    timed("build kernels", run_build_kernels, dev, card, build_records,
          serving_rps)
    timed("gmm passes", run_gmm_passes, dev, card, gmm_record)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in phase_s.items()),
          flush=True)

    print(json.dumps({"kernels": [record, rings["K2"], rings["K3"],
                                  seg_record, cut_record,
                                  build_records["slic_connectivity"],
                                  build_records["mask_components"],
                                  gmm_record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
