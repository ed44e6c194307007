#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (sk_gs_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

(``--worker`` is the script run as a rank of a mesh phase, which the
script starts itself.)

Drives the port's paths at full width (the ``synthetic_fullscale``
preset: 100,352 Gaussian slots, 512 joints, 400 x 400, random weights from
seed 0) through the entry points a user calls, and checks them: the
command-line entry points ``sk_gs_tpu_torch.cli.train``, ``.test`` and
``.render_repose`` from a YAML config to a checkpoint and back, on the
synthetic scene and on D-NeRF-, WIM- and ZJU-MoCap-layout scenes it
writes (PNG and JPEG frames), and ``.viewer``'s HTTP server; serving
through ``framework.evaluate`` (80,000 alive); training the ``sk`` stage
through ``framework.trainer.SKGSTrainer.train_step`` on the preset's
synthetic scene, made on the card (the ``tile`` schedule, kernels #1/#2);
training the ``init`` family with adaptive density control on the
``chunk`` schedule (kernels #3/#4); training the ``sp`` family with its
stage events on the ``tile`` schedule; and the skeleton initialisation
with the ``sk_init`` family (kernel #1). Phases, one JSON line each:

1. device: the card, the device count and its power limit;
2. build: every hand-written kernel compiled from ``sk_gs_tpu_torch/csrc``
   (one nvcc each, started together, beside the host C++ build of the JPEG
   decoder), with ptxas' register and shared memory lines; then jpeg: the
   port's JPEG decoder on each committed fixture (tests/fixtures/jpeg)
   against its committed Pillow decode (max abs difference 0), and one
   1024-px 4:2:0 and one 800-px 4:4:4 decode timed;
3. kernel: the forward kernel (#1) against its plain PyTorch version on
   the inputs of the first request, error, the kernel's device time by
   torch.profiler, the wrapper's and the plain version's by CUDA events,
   and the blocks resident per SM;
4. kernel_chunk: the chunk schedule's forward kernel (#3) against its plain
   version on the same request binned in chunks, as 3 reports #1, with the
   chunk layout and #1's device time on the same splats;
4a. kernel_preprocess: the preprocess kernel (``csrc/preprocess_fwd.cu``,
   no TPU kernel) against its plain PyTorch version on the first test
   request of each sk benchmark cell (``dnerf_800.serve``,
   ``zju_1024.serve``: 100,352 rows at 800 and 1024 px): on the rows the
   plain version draws, the largest float error over each field's largest
   magnitude there; the culled rows whose non-finite values, colour or tau
   differ; the rows whose integer fields or ``visible`` differ (rounding
   ties); the kernel's device time
   by torch.profiler, the wrapper's by CUDA events, the plain version's
   by CUDA events (host-bound: its ~390 launches) and its device time,
   the bytes and their bound, and the blocks resident per SM;
5. slice: the launch counts (#1-#5) set to 0, 10 renders served at
   distinct (orbit camera, t), the counts read back; per request the
   synchronised time, the pairs and the overflow flag; PSNR / SSIM against
   the same requests rendered by the plain path;
6. reference: a small model rendered on the card and by the plain path on
   the CPU;
7. kernel_bwd: the backward kernel (#2) against its plain version on the
   first training step's inputs and cotangents: the gradient rows of the
   depth-ordered rows, error per column group, the dummy row's zeros, the
   difference between two launches (the atomics' order), the kernel's
   device time by torch.profiler (the in-kernel reduction included), the
   wrapper's (its zeroing of the rows included) and the plain version's by
   CUDA events, the bytes and bound, the blocks resident per SM, and the
   longest and mean tile list;
8. train: one warm-up step, the launch counts set to 0, 10 steps, the
   counts read back; per step the synchronised time and the metrics; the
   loss on the first step's view before and after; the peak memory;
9. grad_path: one step's leaf gradients through the kernels against the
   plain forward and backward on the card, on the same sample, both
   routes from one cotangent of the image losses on the composited image
   (the plain route's: the l1 loss has a kink where a route renders a
   pixel channel exactly at the target), with the count of pixel channels
   whose l1 sign differs between the routes;
10. train_reference: a small model trained 2 steps on the card and on the
   CPU (plain versions), losses, gradients and parameters compared;
11. train_reference_rgba: 10 on an RGBA scene (made once on the CPU, copied
   to the card) with the 'checker' background, and with 'random'
   backgrounds drawn on the host and handed to both runs;
12. kernel_chunk_bwd: the chunk schedule's backward kernel (#4) against its
   plain version on a real ``init`` step's cotangents (the populated start
   of 14, at its first step, before it trains), as 7 reports #2;
13. grad_path_init: that step's leaf gradients through kernels #3 and #4
   against the plain chunk route on the card, as 9 holds them;
14. init_train: the launch counts set to 0, then three starts of the init
   family on the chunk schedule, the counts read back: the flagship start
   (2,000 points, ``init_from_pcd``, ``init_model`` from seed 0; steps 1-3
   and 99-101, densify and prune after step 100), a populated start (a
   random model with 80,000 alive and the warp nets; steps 2995-3004,
   densify, prune and opacity reset after step 3000 with 20,352 dead
   slots) and a full start (99,000 alive, steps 2998-3001: the event after
   step 3000 has fewer dead slots than selected rows and drops some); per
   step the synchronised time and the metrics, per event its counts, per
   start the mean step time before, at and after its event; the peak
   memory;
15. train_reference_init: a small init-family model trained 2 steps across
   a densify event on the card and on the CPU, compared as in 10;
16. sp_events: the populated init start (80,000 alive) across steps
   7499-7501: the superpoint initialisation before step 7500 (512 distinct
   live FPS picks, the first the first live row, the replaced leaves and
   their zero moments), its FPS on the card held against the CPU on the
   same trajectories; then the restart from the flagship's point cloud
   before step 10,000 (2,000 alive, one-hot ``sp_W`` times log 36) and
   steps 10,000-10,003 into ``sp_fix``; per step and per event the
   synchronised time and the counts;
17. sp_train: a random sp-stage model (80,000 alive, 512 superpoints) on
   a fresh trainer (its smooth-loss KNN all zeros until the rebuild before
   step 14,000, as the flagship's), a warm-up step, the launch counts set
   to 0, steps 13,999-14,001, 19,999-20,002 and 29,999-30,001, the counts
   read back (kernels #1 and #2 once a step); per step the synchronised
   time, whether the KNN was all zeros, the sp losses, pairs, overflow and
   non-finite gradients; per event (KNN rebuild, canonical replacement,
   joint tree, superpoint prune / split and merge, densify / prune) its
   counts and synchronised host time; the peak memory; the smooth loss's
   forward and backward alone on the rebuilt and on an all-zero KNN;
18. grad_path_sp: one sp step's leaf gradients through kernels #1/#2
   against the plain route on the card, as 9 holds them;
19. train_reference_sp: a small sp-stage model trained on the card and on
   the CPU, 2 steps on the all-zero smooth-loss KNN (sp_fix into sp) and 2
   steps after its rebuild across the joint tree and the superpoint prune
   / split, compared as in 10, with ``alive``, ``sp_alive`` and
   ``joint_parents`` equal; the ``sp_W`` gradient's bar adds the float32
   rounding of its smooth-loss term, measured against float64 on each
   side;
20. train_reference_options: each option of the trainer on the card
   against the CPU over 2 steps of a small model, both handed the same
   draws (the regularizers' uniforms, the time noise): AdamW, SGD and
   Adan, ``batch_views`` 3 (``sk`` steps), the init regularizers
   (``elastic``, ``acc``, ``arap``, ``arap_p``) across the densify event
   after step 100, the sp regularizers (``re_pos``, ``jp_dist``,
   ``sp_arap_t``, ``sp_arap_ct``) across ``joint_update_interval[1]``
   (19,999-20,000), a net that is not ``is_blender`` (the time noise), and
   bf16 nets (losses 2e-3, gradients 2e-2, and the parameter rule's 1e-3
   and 1% at 2e-2: both devices round the nets' products to bfloat16, in
   another order, and the warped positions carry that into every leaf's
   gradient), as 10 holds them; the small models' ``sp_deform`` heads
   drawn at 2e-3 (the warp moves the Gaussians by ~0.02), and at 0.05
   with the consistency loss off for the init regularizers (at 2e-3 the
   edge-length variance and the stretch they read sit near the warped
   points' rounding); the init regularizers' warp-net gradients at 3e-4
   of each leaf's max plus the float32 rounding of ``elastic`` and
   ``arap`` measured on each side in the same step against a float64
   twin of the net and state (``reg_net_rounding``, as 19 measures
   ``sp_W``'s), TF32 off in the step, its parameters at 2 lr a step, the
   CPU taking the second step from the card's state after the first
   passed that bar (where rounding parts the gradients, the runs' first
   Adam steps part by up to +-lr), and the warp bias's gradient against
   the warp weight's scale (their share of it is large terms
   cancelling);
21. sp_extras_train: 17's start with the weights of
   configs/ablations/loss_re_pos/re_pos1.yaml and loss_sp_arap/sp_arap.yaml
   against the same start without them, steps 13,999-14,001 in turns:
   each step's ms and the added ms, the losses, peak memory, #1/#2 once a
   step;
22. init_reg_train: 14's flagship start with ``elastic``, ``acc``,
   ``arap`` and ``arap_p`` on, steps 1-3 (chunk schedule): ms a step, the
   losses, and ``arap_p``'s KNN over all 100,352 rows alone;
23. init_bf16: the flagship start in float32 and with bf16 nets, steps 2-4
   in turns (ms), then one profiled step of each: device time, the
   matrix-product kernels by name and device time, and whether the bf16
   run's are tensor-core kernels;
24. sk_init_event: the skeleton initialisation at full width on the
   flagship's shape (no ``sk_init`` steps): the random sp-stage model of
   17 takes the last sp step (40,000), then step 40,001 runs the
   initialisation before it, both loops cut to ``SK_EVENT_CUT`` (500) of
   the flagship's min(10,000, 2,000) iterations, then steps
   40,002-40,005 through kernels #1/#2: the event's synchronised time by
   part (sp cache and LBS freeze, joint loop, joint tree, distillation)
   and per loop iteration, the loops' first and last losses, the root, the
   non-finite count of the skeleton (0), peak memory, the steps' metrics
   and launches;
25. sk_init_train: the same model on the sk stages of
   ``configs/synthetic_smoke.yaml`` (10 ``sk_init`` steps,
   ``joint_init_steps`` 50): the last sp step, then, with the launch
   counts at 0, the first 5 ``sk_init`` steps (the initialisation before
   the first), the counts read back (kernel #1 once a step, #2 never: the
   image losses are detached), the ``cmp_*`` losses finite;
26. train_reference_sk_init: the skeleton initialisation (20 + 20
   iterations, the loops checked for host syncs on the card) of a small
   model on the card and on the CPU: the tree, the frozen LBS and the
   caches equal or within 1e-5, the Adam-updated leaves as 10 holds
   parameters; then an ``sk_init`` and an ``sk`` step on both from the
   CPU's state after it, as 10 holds steps;
27. cli_train_smoke: ``sk_gs_tpu_torch.cli.train`` (its ``main``, in this
   process, into a temporary directory) on configs/synthetic_smoke.yaml,
   the whole 180-step schedule with the launch counts at 0: the seconds,
   the ms a step by stage from metrics.jsonl, the files written, the
   results (the JAX package's keys; finite, or null where the JAX
   package writes null), #1 once a step, a ground-truth frame and an
   evaluated view, #2 once a step but the ``sk_init`` steps';
28. cli_train_options: ``cli.train`` on configs/synthetic_smoke.yaml with
   ``train.optimizer=adan train.batch_views=2 train.precision=bf16``, the
   whole schedule, and ``cli.test`` on its ``last.npz``: ms a step by
   stage and its ratio to 27's, #1 twice a step, #2 twice a step but the
   ``sk_init`` steps';
29. cli_test_fullscale: the random full-width model (80,000 alive) with
   its ``sk_cache`` filled at the 48 train frames as ``sk`` training fills
   it, saved through the port's checkpoint at step 40,010 with the
   skeleton initialised; ``cli.test`` on configs/synthetic_fullscale.yaml
   (48 views, 400 px, LPIPS alex and vgg) without and with
   ``test_time_interpolate`` (the first also sweeping FPS over 1,000
   renders): the columns and FPS of each; at the 48 train times the two
   routes' deltas within 1e-4 and their renders at least 60 dB apart;
30. cli_repose_fullscale: ``cli.render_repose`` of that checkpoint with
   ``--orbit --time-sweep --pose-json`` (two keyframes), 20 frames at 400
   px: ms a frame (render, copy to the host, PNG), each PNG decoded by
   the port's reader, #1 once a frame
   (and once a ground-truth frame); a zero pose delta renders as none;
31. cli_train_fullscale: ``cli.train`` on configs/synthetic_fullscale.yaml
   for 20 steps (the flagship start in 100,352 slots, 48 frames, 400 px):
   ms a step, the full-metric evaluation over the 48 views, the files
   written, peak memory;
32. cli_train_dnerf: a D-NeRF-layout scene written at 800 px (the preset's
   chain over 60 times, one orbit camera a time, unpremultiplied RGBA PNGs:
   50 train and 10 val views) and ``cli.train`` on configs/d_nerf.yaml for
   20 steps and the val split's evaluation: each split's load seconds and
   MB on the card, ``read_png`` of one 800-px frame, ms a step, peak
   memory; the loaded images equal the written bytes over white (1e-6),
   the cameras the written ones after the OpenGL -> COLMAP conversion
   (1e-5), #2 once a step and #1 once a step and a view of each
   evaluation; then kernels_800: #1 and #2 on the first step of that
   scene against their plain versions, their device time;
33. cli_train_dnerf_random: the same files through
   configs/d_nerf_400.yaml (downscale 2) with a 'random' background, 10
   steps, RGBA on the card; then 2 trainer steps with each of 'random2',
   'reference' and 'checker' on the first 10 views loaded with it: finite
   losses, #1 and #2 once a step;
34. cli_train_wim: a WIM-layout scene written at 800 px (20 cameras, 4 of
   the 50 frames) and ``cli.train`` on configs/wim_512.yaml (512 px) for
   10 steps and the test split's evaluation: load seconds, the frame and
   camera ids as written, the launches;
35. cli_train_zju: a ZJU-MoCap ``annots.npy`` layout written at 1024 px
   (23 orbit cameras, 2 frames, RGB PNGs and their masks) and ``cli.train``
   on configs/zju.yaml (``is_blender`` false: the time noise live) for 10
   steps: load seconds by split and a view, the cameras as written, ms a
   step, the noise's scale, the launches; cli_train_zju_jpeg: the same
   layout with the frames as baseline 4:2:0 JPEG files at quality 90
   (``encode_jpeg``, a numpy baseline encoder; the masks PNG), decoded by
   the port at least 30 dB from the rendered frames, load seconds beside
   the PNG layout's of the same call;
36. viewer: ``cli.viewer``'s server (127.0.0.1, port 0, a thread) on the
   full-width checkpoint of 29: 20 ``/render`` requests in each mode, 20
   ``/pick``, 20 ``/skeleton`` and ``/info`` by urllib, ms by endpoint,
   #1 exactly once a ``/render``, the ``rgb`` PNG equal to the render
   called directly (``render_eval``'s frame at a zero pose), the
   ``render_topk`` device ms at full width, and ``render_topk`` on the
   card against the CPU on a small scene (ids equal, weights 1e-5);
37. sharded_render: both Gaussian-sharded renderers
   (``parallel/sharded_render.py``) over 2 gloo ranks on this card, each
   rank a process of this script (``--worker``) holding half of serving's
   100,352 slots (80,000 alive), at tile_h 8 (50 tile rows, 25 a band)
   with a pair capacity of 2^21 on both sides, against the one-card
   render: images and opacity 3e-5, radii and visible equal, overflow
   False, the gradients of an l1 loss 5e-4 of each leaf's max, #1 once a
   render and #2 once a backward on each rank; ms a render a rank, the
   band pairs, the rows and bytes exchanged; kernels #1 and #2 at tile_h
   8 against their plain versions first;
38. mesh_view: the trainer's view axis, 2 gloo ranks on this card, one
   view each, against one process at ``batch_views`` 2 from one state,
   at full width: the init family (the populated start, chunk schedule),
   sp and sk, 2 steps each at ``train_reference``'s bars (the statistics,
   caches, ``p2sp`` and joint cost likewise); then the ranks alone across
   an adaptive control event (init) and the sp events (14,000-14,001,
   19,999-20,001), the replicas' largest difference after them 0, and
   what each event's sync found; ms a step, the bytes reduced and the
   reduction's ms, peak memory and launches of each rank;
39. mesh_nccl1: one rank over NCCL, the sk step on a one-rank mesh against
   the step without one, in turns, and NCCL's all-reduce of the step's
   reduction size timed alone;
40. cli_train_parallel: ``cli.train`` over 2 gloo ranks on this card
   (``train.parallel.n_view`` 2, ``batch_views`` 2) against one process
   and its twin (a second run of one process), checkpoint by checkpoint
   (the parameters within 2 lr a step, the alive slots, superpoints and
   tree equal: held at init.npz and at step 100 where the twin holds it,
   reported after the skeleton initialisation, whose MST breaks near-ties
   by last bits); rank 1 writes nothing;
41. mesh_gs: the trainer's gs axis, 2 gloo ranks on this card on a 1 x 2
   mesh at ``batch_views`` 1, each rank computing its half of the
   100,352 slots and blending a band of 25 tile rows (tile_h 8, a pair
   capacity of 2^21: a band holds half) from the splats exchanged
   all-to-all, against one process at the same setup from one state: the
   init family (the populated start, chunk schedule: #3/#4 in a band), sp
   (the random sp-stage model, its smooth-loss KNN rebuilt), sk_init
   (that model with its LBS frozen, on synthetic_smoke's sk stages) and
   sk, 2 steps each at ``train_reference``'s bars, the replicas equal to
   the last bit, no overflow; ms a step, the bytes each kind of
   collective sends a step (the all-to-all blocks, the gathers, the
   reductions) and the merge's bytes and ms, each band's pairs and the
   rows sent, peak memory and launches of each rank; each rank's band
   kernels against their plain versions on its last band's inputs;
42. mesh_gs_2x2: both axes, 4 gloo ranks on this card on a 2 x 2 mesh, 2
   sk steps at ``batch_views`` 2 against one process at ``batch_views``
   2, as 41;
43. cli_train_gs: 40 on the gs axis (``train.parallel.n_gs`` 2,
   ``raster.tile_h=8``, ``batch_views`` 1): the ranks against one process
   and its twin at the same sets, by the same rule;
44. with ``--profile`` only: 24 at the flagship's 2,000 + 2,000
   iterations (profile_sk_init_event); profile_sk_init, each loop's
   iteration on the host clock and under torch.profiler (device time,
   busy share, top kernels) on that model after its initialisation; 26
   over 50 + 50 iterations, reported, not held; and one request's, one
   ``sk`` step's and one ``init`` step's (the flagship start's) stages
   timed with CUDA events, and torch.profiler windows over a few requests
   and steps (device time
   by kernel, device busy share against the same trainer's unprofiled
   steps, the pairs of the window's steps, and any ``index_add_`` kernel in
   a step's window); and for each of those two trainers, its backward
   kernel's device time on one step's inputs, by torch.profiler, alone
   (warm, and after a write that evicts L2) and inside that very step, with
   the step's pairs and tile lists, and on the tile schedule its time with
   every tile's list cut to its first 64, 250 and 1,000 entries; and
   profile_fwd / profile_chunk_fwd: each forward kernel's device time by
   torch.profiler, whole and with the lists cut the same way, its blocks
   per SM, the lists, the share of their entries with o < 1/255, and the
   shares of the plain version's evaluations by outcome (skipped by power,
   alpha below 1/255, added, stopping), for #1
   on the first request and on the ``sk`` step that profile_bwd takes, for
   #3 on the first request binned in chunks and on the populated start's
   first step (before it trains); and profile_train_sp: the sp trainer's
   split and window as above, with its own pieces (LBS weights, the
   sp_stage pass, the smooth loss forward and backward, the joint costs,
   the cache and joint-cost writes) timed alone, and the smooth loss's
   backward scatter named on its own line.

Then a ``kernels`` line (every ported kernel with its launches on its own
training path and on each path, the CLI paths ``cli_train``,
``cli_test``, ``cli_repose``, ``cli_train_dnerf``,
``cli_train_dnerf_random``, ``train_dynamic_bg``, ``cli_train_wim``,
``cli_train_options``, ``cli_train_zju``, ``cli_train_zju_jpeg`` and
``viewer``, the options' paths
``train_sp_extras``, ``train_init_reg`` and ``train_init_bf16`` and the
mesh's (rank 0's) ``sharded_render``, ``exchange_render``,
``mesh_view_{init,sp,sk}``, ``mesh_nccl1``, ``cli_train_parallel``,
``mesh_gs_{init,sp,sk_init,sk}``, ``mesh_gs_2x2_sk`` and ``cli_train_gs``
included, error, times and bound), the card's name
and power limit as nvidia-smi prints them, and last ``{"ok": true,
"device": {...}}``. Any failure raises and exits non-zero; with no CUDA
device it exits non-zero before printing any result, and without the port
beside it the import fails.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from sk_gs_tpu_torch import convert
from sk_gs_tpu_torch.cli import render_repose as cli_repose
from sk_gs_tpu_torch.cli import test as cli_test
from sk_gs_tpu_torch.cli import train as cli_train
from sk_gs_tpu_torch.cli import viewer as cli_viewer
from sk_gs_tpu_torch.cuda_build import build_all
from sk_gs_tpu_torch.data.sampler import UniformSampler
from sk_gs_tpu_torch.data.synthetic import (gt_frame_gaussians,
                                            make_chain_gt,
                                            make_synthetic_scene, orbit_views)
from sk_gs_tpu_torch.framework import build
from sk_gs_tpu_torch.framework import trainer as trainer_mod
from sk_gs_tpu_torch.framework.checkpoint import CheckpointManager
from sk_gs_tpu_torch.framework.checkpoint import load as load_ckpt
from sk_gs_tpu_torch.framework.checkpoint import step_of
from sk_gs_tpu_torch.framework.config import make_config
from sk_gs_tpu_torch.framework.evaluate import evaluate, render_eval
from sk_gs_tpu_torch.framework.presets import (flagship_point_cloud,
                                               synthetic_fullscale)
from sk_gs_tpu_torch.framework.random_model import orbit_view, random_model_flat
from sk_gs_tpu_torch.framework.trainer import (FAMILY,
                                               INIT_SKELETON_MAX_STEPS,
                                               SKGSTrainer, smooth_loss)
from sk_gs_tpu_torch.models import optim, sk_gs_ops, superpoints
from sk_gs_tpu_torch.models.gaussian_splatting import (gaussian_inputs,
                                                       init_from_pcd)
from sk_gs_tpu_torch.models.losses import LossWeights, l1_loss, ssim_loss
from sk_gs_tpu_torch.models.sk_gs import (forward_deltas, init_model,
                                          lbs_weights, smooth_scale)
from sk_gs_tpu_torch.models.sk_gs_ops import sample_trajectories
from sk_gs_tpu_torch.models.skeleton import joint_cost_matrix
from sk_gs_tpu_torch.models.superpoints import select_rows
from sk_gs_tpu_torch.ops.knn import furthest_point_sampling, live_knn_index
from sk_gs_tpu_torch.ops.knn import knn as knn_op
from sk_gs_tpu_torch.ops.transforms import (convert_coord_system, look_at,
                                            perspective_opencv)
from sk_gs_tpu_torch.parallel import (init_distributed, make_mesh,
                                      shard_rows)
from sk_gs_tpu_torch.parallel import collectives as coll
from sk_gs_tpu_torch.parallel import sharded_render
from sk_gs_tpu_torch.parallel.sharded_render import (make_exchange_render,
                                                     make_sharded_render)
from sk_gs_tpu_torch.parallel import trainer as mesh_trainer_mod
from sk_gs_tpu_torch.parallel.trainer import MeshTrainer
from sk_gs_tpu_torch.render import prepare_blend
from sk_gs_tpu_torch.render.binning import build_tile_lists, num_chunks
from sk_gs_tpu_torch.render.blend import (ALPHA_MIN, OUTCOMES, assemble_image,
                                          chunk_waves)
from sk_gs_tpu_torch.render.preprocess import (preprocess, preprocess_fwd,
                                               preprocess_plain)
from sk_gs_tpu_torch.render.render import (blend_tiles, composite_background,
                                           render, render_topk)
from sk_gs_tpu_torch.render.settings import (GaussianInputs, RasterConfig,
                                             ViewParams)
from sk_gs_tpu_torch.render.tile_kernel import (KERNELS, chunk_blend_bwd,
                                                chunk_blend_fwd,
                                                tile_blend_bwd, tile_blend_fwd)
from sk_gs_tpu_torch.utils import jpeg
from sk_gs_tpu_torch.utils.png import read_png, to_uint8, write_png

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# float32 instructions a second (132 SMs x 128 lanes x 1.98 GHz): the rate
# of the separate multiplies and adds that --fmad=false builds, where the
# data sheet's 67 TFLOP/s counts one FMA as two operations
PEAK_FP32_INSTR = 33.5e12
# operations of the forward blend (#1, #3) on what its evaluations come to
# (the plain version's ``stats``): every evaluation dx, dy (2), the
# quadratic form (9) and the skip and pre-test tests (2); a kept one (added
# or stopping) min(power, 0), exp, o * g, min(0.99, .), the keep test,
# T (1 - alpha) and the stop test (8); an added one w and the colour sums
# (1 + 2 ch). exp counted once and only where the entry is kept: a least
# count, since the pre-test also lets through the evaluations within its
# margin below the keep threshold.
FWD_OPS_PER_EVAL = 13
FWD_OPS_PER_KEPT = 8
# operations of one (entry, pixel) evaluation that the backward's forward
# walk does (it has no pre-test): dx, dy (2), the quadratic form (9),
# min(power, 0), exp, o * g, min(0.99, .) and the two skip tests (6)
BLEND_OPS_PER_EVAL = 17
# operations the backward adds for an (entry, pixel) pair that adds to the
# pixel: 1 - alpha, T (1 - alpha), w, B (2 ch - 1), the running sum (2),
# 1 / (1 - alpha), g_alpha (7), g_power, the six conic / position /
# opacity terms (18), w g_color (ch), and the 6 + ch sums over the pixels
# (at ch = 3; counted per adding pair, a least count)
BWD_OPS_PER_ADD = 49
KERNEL_TOL = 1e-4
# the kernels whose launches the served, training and mesh phases count:
# the blend's (#1-#4) and the preprocess (#5)
COUNTED = (*KERNELS, preprocess_fwd)
BWD_TOL = 3e-4          # of each column group's max magnitude
# two launches of a backward kernel on the same inputs differ only in the
# order in which the tiles' atomics land on a row: rounding, far below this
# (of each column group's max magnitude)
RERUN_TOL = 1e-5
GRAD_PATH_TOL = 1e-3    # of each leaf's max magnitude
PROFILER_TRIES = 3
# the losses on the composited image: the gradient paths give both routes
# one cotangent of their sum on the image
IMAGE_LOSSES = ('rgb', 'ssim')
SEED = 0
N_REQUESTS = 10
N_STEPS = 10
# the profile phases time a kernel with every tile's list cut to these
LIST_CUTS = (64, 250, 1000)
# the init family's starts: (name, live slots of a random start or None
# for the flagship's point cloud, steps). An event follows step 100
# (densify + prune) and step 3000 (densify + prune + opacity reset); the
# 'full' start leaves fewer dead slots than rows to clone or split, so the
# event drops some.
INIT_STARTS = (('flagship', None, (1, 2, 3, 99, 100, 101)),
               ('populated', 80_000, tuple(range(2995, 3005))),
               ('full', 99_000, (2998, 2999, 3000, 3001)))
GROUPS = {'xy': slice(0, 2), 'conic': slice(2, 5), 'opacity': slice(5, 6),
          'colour': slice(6, None)}
# the sp family's runs on the flagship schedule: the populated init start
# across the superpoint initialisation (before 7,500) and then across the
# restart from the point cloud (before 10,000) into sp_fix; a random
# sp-stage model on the all-zero smooth-loss KNN (13,999), across its first
# rebuild and a densify (14,000), then across the canonical replacement,
# the KNN rebuild, the joint tree, the superpoint prune / split and densify
# (20,000) and the merge (30,000)
SP_EVENT_STEPS = ((7499, 7500, 7501), (10000, 10001, 10002, 10003))
SP_TRAIN_STEPS = (13999, 14000, 14001, 19999, 20000, 20001, 20002, 29999,
                  30000, 30001)
# train_reference_sp's pairs of steps: on the all-zero smooth-loss KNN
# across sp_fix into sp, and after its rebuild across the sp events
SP_REFERENCE_STEPS = {'zero_knn': (13000, 13001),
                      'rebuilt_knn': (20000, 20001)}
# the trainer's event methods, timed where they run
EVENT_HOOKS = ('_init_superpoints', '_reinit_from_pcd', '_canonical_replace',
               'update_gs_knn', '_update_joint', '_sp_prune_split',
               '_sp_merge', '_densify_prune', '_reset_opacity')
# the FPS's running minimum distances, card against CPU, where a pick breaks
# a near-tie another way
FPS_RTOL = 1e-6
# the skeleton initialisation's parts in sk_gs_ops, timed by sk_init_event
INIT_SKELETON_PARTS = ('freeze_lbs', 'optimize_joint_pos', 'finalize_joints',
                       'distill_sk_deform')
# sk_init_event: joint_init_steps of the default run, and the sk steps
# after the initialisation. At the flagship's 2,000 + 2,000 iterations the
# event took 110.7-140.4 s on the H100, over 120 s once: the default run
# cuts both loops to 500, and --profile runs the flagship's counts
SK_EVENT_CUT = 500
SK_AFTER_INIT = 5
# profile_sk_init: iterations of each loop timed and profiled
N_PROFILED_ITERS = 20
# sk_init_train: the sk stages of configs/synthetic_smoke.yaml, and the
# steps taken of its sk_init stage
SK_INIT_SMOKE = {'sk_init': 10, 'joint_init_steps': 50}
N_SK_INIT_STEPS = 5
# train_reference_sk_init: iterations of each loop, and the factor on the
# random warp net's translation and rotation heads (a fresh net's spread,
# 1e-5, barely moves the superpoints: the joint costs then sit at the
# joint loop's Adam noise, +-lr, where rounding decides them). The
# parameter rule holds a few Adam steps: over longer loops the +-lr moves
# of the entries whose gradient is near zero feed back into every
# gradient, which it does not bound (--profile reports SK_REF_ITERS_LONG)
SK_REF_ITERS = 20
SK_REF_ITERS_LONG = 50
SK_REF_MOTION = 1000.0
# the CLI phases: the configs they run, the step of the random sk
# checkpoint (inside the flagship's sk stage), the agreement bars of the
# interpolated and the net routes at the train times (deltas, max abs; the
# renders, their least PSNR against each other: a last-bit change of a
# delta can reorder a near-tie in the depth sort), the repose frames,
# the full-width training steps, and the keys of results.json as the JAX
# package writes them (uncalibrated LPIPS)
CLI_SMOKE = 'configs/synthetic_smoke.yaml'
CLI_FULLSCALE = 'configs/synthetic_fullscale.yaml'
CLI_SK_STEP = 40_010
CLI_N_ALIVE = 80_000
CLI_INTERP_TOL = 1e-4
CLI_INTERP_PSNR = 60.0
CLI_REPOSE_FRAMES = 20
CLI_FULLSCALE_STEPS = 20
# the 1,000-render FPS sweep of cli.test runs in the default run
CLI_FPS_SWEEP = True
# the real-data layouts, written here from the preset's chain: D-NeRF at
# 800 px (the size of lego's train split, every 6th view for val), WIM at
# 800 px over 4 of its 50 frames
CLI_DNERF = 'configs/d_nerf.yaml'
CLI_DNERF_400 = 'configs/d_nerf_400.yaml'
CLI_WIM = 'configs/wim_512.yaml'
DNERF_HW = 800
DNERF_VIEWS = (50, 10)
DNERF_VAL_EVERY = 6
DNERF_STEPS = 20
DNERF_RANDOM_STEPS = 10
DYNAMIC_VIEWS = 10
DYNAMIC_STEPS = 2
WIM_HW = 800
WIM_CAMERAS = 20
WIM_FRAMES = 4
WIM_STEPS = 10
# the trainer's options: the regularizers' weights (the two
# ablations' own, configs/ablations/loss_re_pos/re_pos1.yaml and
# loss_sp_arap/sp_arap.yaml; the init family's those of the JAX package's
# tests/test_extra_losses.py), the steps of each full-width phase, the bf16
# bar (losses and the nets' gradients: the nets round to bfloat16's 8
# mantissa bits on both devices, in another order of accumulation) and the
# ZJU-MoCap layout (ZJU-MoCap's frame size and camera count, 2 frames)
SP_ABLATION_WEIGHTS = {'re_pos': 1.0, 'sp_arap_t': 0.01, 'sp_arap_ct': 0.01}
SP_REG_WEIGHTS = {'re_pos': 0.5, 'jp_dist': 0.5, 'sp_arap_t': 0.01,
                  'sp_arap_ct': 0.01}
INIT_REG_WEIGHTS = {'elastic': 0.1, 'acc': 0.1, 'arap': 0.1, 'arap_p': 1.0}
SP_EXTRAS_STEPS = (13999, 14000, 14001)
INIT_REG_STEPS = (1, 2, 3)
INIT_BF16_STEPS = (2, 3, 4)
BF16_LOSS_TOL = 2e-3
BF16_GRAD_TOL = 2e-2
CLI_ZJU = 'configs/zju.yaml'
ZJU_HW = 1024
ZJU_CAMERAS = 23
ZJU_FRAMES = 2
ZJU_STEPS = 10
# the ZJU layout's frames as baseline 4:2:0 JPEG (cli_train_zju_jpeg), the
# decoded frames at least this far from the rendered ones
ZJU_JPEG_QUALITY = 90
JPEG_MIN_PSNR = 30.0
JPEG_FIXTURES = Path(__file__).resolve().parent / 'tests' / 'fixtures' / 'jpeg'
# the decodes timed by phase jpeg: (name, side, luma sampling), 4:2:0 and
# 4:4:4, a median of JPEG_TIMED_REPS each
JPEG_TIMED = (('1024_420', 1024, (2, 2)), ('800_444', 800, (1, 1)))
JPEG_TIMED_REPS = 10
# the viewer: requests of each kind, the render modes, topk_weights'
# card-vs-CPU bar on the weights
VIEWER_REQUESTS = 20
VIEWER_MODES = ('rgb', 'opacity', 'superpoints')
TOPK_TOL = 1e-5
CLI_OPTIONS = ('train.optimizer=adan', 'train.batch_views=2',
               'train.precision=bf16')
# kernel names of matrix products (cuBLAS / cuBLASLt / CUTLASS), and the
# marks of a tensor-core one among them
GEMM_MARKS = ('gemm', 'nvjet', 'xmma', 'cutlass')
TENSOR_CORE_MARKS = ('bf16', 'tensorop', 'hmma', 'gmma', 'nvjet', '16816')
CLI_METRIC_KEYS = {'PSNR', 'SSIM', 'SSIM (border-cropped)', 'MS-SSIM',
                   'LPIPS (alex)', 'LPIPS (vgg)', 'LPIPS weights',
                   'LPIPS (alex) [uncalibrated]',
                   'LPIPS (vgg) [uncalibrated]'}
CLI_TRAIN_KEYS = CLI_METRIC_KEYS | {'best_PSNR', 'train_time_s'}
CLI_TEST_KEYS = CLI_METRIC_KEYS | {'FPS', 'stage', 'step', 'capacity',
                                   'pair_capacity', 'n_alive'}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def requests(n: int, width: int, height: int, device):
    """n distinct (orbit camera, t): t between the train frames."""
    views = [orbit_view(2.0 * math.pi * k / n, width, height,
                        elevation=0.3 * math.cos(k), device=device)
             for k in range(n)]
    times = [(k + 0.37) / n for k in range(n)]
    return views, times


def bound(ops: int, nbytes: int, peak: float = PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of the operations at the fp32 rate
    ``peak`` and the bytes at the HBM rate."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def fwd_ops(stats: dict, ch: int) -> int:
    """Operations of a forward blend whose evaluations came to ``stats``."""
    return (FWD_OPS_PER_EVAL * stats['evaluations']
            + FWD_OPS_PER_KEPT * (stats['adds'] + stats['stops'])
            + (1 + 2 * ch) * stats['adds'])


def schedule_kernels(inp, rcfg):
    """(forward kernel, backward kernel, the blend arguments they share
    before the pixel tensors, metadata bytes) of ``rcfg``'s schedule."""
    b = inp.binned
    rows = (inp.geo.detach(), inp.col.detach(), b.sort_gauss)
    if rcfg.chunked:
        meta = (b.chunk_tile, b.chunk_start_flag, b.chunk_src, b.chunk_valid)
        return (chunk_blend_fwd, chunk_blend_bwd, rows + meta,
                4 * 4 * num_chunks(rcfg))
    return (tile_blend_fwd, tile_blend_bwd, rows + (b.tile_start, b.tile_count),
            4 * 2 * rcfg.num_tiles)


def kernel_row(kernel, max_abs_err, ms, plain_ms, ops, nbytes) -> dict:
    """A kernel's entry of the ``kernels`` line (launches are added last)."""
    bound_ms, bound_by = bound(ops, nbytes)
    return {'name': kernel.name, 'route': kernel.route,
            'source': kernel.source, 'replaces': kernel.replaces,
            'max_abs_err': max_abs_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None}


def chunk_layout(b) -> dict:
    """What the chunk schedule's metadata holds: chunks, the ones with
    entries, and the longest chain of chunks of one tile."""
    return {'chunks': int(b.chunk_valid.shape[0]),
            'live_chunks': int((b.chunk_valid > 0).sum()),
            'max_chunks_per_tile': int(torch.ceil(
                b.tile_count.float() / b.chunk_valid.max().clamp(min=1)).max())}


def request_inputs(model, view, t, rcfg):
    """The blend inputs of the request (view, t) binned for ``rcfg``."""
    cfg = model.cfg
    with torch.no_grad():
        d = forward_deltas(cfg, model, torch.tensor(t, device=model.device),
                           'sk')
        g = gaussian_inputs(model.gauss_view(), cfg.gauss, d.d_xyz,
                            d.d_rotation, d.d_scaling)
        return prepare_blend(g, view, rcfg, model.active_sh_degree)


def phase_kernel(model, view, t, schedule: str = 'tile'):
    """The schedule's forward kernel (#1 or #3) against its plain version
    on the first request's binned inputs; on the chunk schedule also kernel
    #1 on the same splats."""
    rcfg = model.rcfg._replace(schedule=schedule)
    with torch.no_grad():
        inp = request_inputs(model, view, t, rcfg)
        b = inp.binned
        kernel, _, args, meta_bytes = schedule_kernels(inp, rcfg)
        args = (*args, rcfg)
        color, alpha = kernel.launch(*args)
        extra = chunk_layout(b) if rcfg.chunked else {}
        stats = {}
        p_color, p_alpha = kernel.plain(*args, stats=stats)
        torch.cuda.synchronize()
        err_c = float((color - p_color).abs().max())
        err_a = float((alpha - p_alpha).abs().max())
        above = int(((color - p_color).abs().amax(-1) > 3e-5).sum()
                    + ((alpha - p_alpha).abs() > 3e-5).sum())
        finite = bool(torch.isfinite(color).all() and torch.isfinite(alpha).all())
        ms = device_ms(kernel, lambda: kernel.launch(*args))
        wrapper_ms = cuda_ms(lambda: kernel.launch(*args), iters=20, warmup=3)
        plain_ms = cuda_ms(lambda: kernel.plain(*args), iters=3, warmup=1)
        if rcfg.chunked:
            tile_args = (*schedule_kernels(inp, model.rcfg)[2], model.rcfg)
            extra['tile_kernel_ms_same_splats'] = device_ms(
                tile_blend_fwd, lambda: tile_blend_fwd.launch(*tile_args))

    pairs = int(b.num_pairs)
    T, P, ch = rcfg.num_tiles, rcfg.pix_per_tile, inp.col.shape[1]
    evals = stats['evaluations']
    ops = fwd_ops(stats, ch)
    nbytes = (4 * pairs + meta_bytes + 4 * inp.geo.numel()
              + 4 * inp.col.numel() + 4 * T * P * (ch + 1))
    row = kernel_row(kernel, max(err_c, err_a), ms, plain_ms, ops, nbytes)
    emit({'phase': 'kernel' if schedule == 'tile' else 'kernel_chunk',
          'kernel': row['name'], 'chunk': rcfg.chunk, 'tiles': T,
          'pixels_per_tile': P, 'channels': ch, 'pairs': pairs,
          'evaluations': evals, 'adds': stats['adds'],
          'stops': stats['stops'], 'ops': ops, 'bytes': nbytes,
          'max_abs_err_color': err_c, 'max_abs_err_alpha': err_a,
          'values_above_3e-5': above, 'tolerance': KERNEL_TOL,
          'finite': finite, 'ms': ms, 'wrapper_ms': wrapper_ms,
          'plain_ms': plain_ms,
          'blocks_per_sm': kernel.blocks_per_sm(rcfg, ch), **extra,
          'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
          'bound_ms_unfused': bound(ops, nbytes, PEAK_FP32_INSTR)[0]})
    if not finite or max(err_c, err_a) > KERNEL_TOL:
        raise AssertionError(f'{kernel.name} disagrees with its plain '
                             f'version: colour {err_c}, alpha {err_a} > '
                             f'{KERNEL_TOL}')
    return row


PRE_FLOAT_FIELDS = ('means2d', 'depths', 'conic', 'colors', 'tau')
PRE_INT_FIELDS = ('radius', 'tiles_touched', 'rect_min', 'rect_max',
                  'visible')
PRE_CELLS = ('dnerf_800.serve', 'zju_1024.serve')
PRE_SEED = 2 ** 31 + 23


def cell_request(cell: str, seed: int = PRE_SEED):
    """The benchmark cell's model (built as its serve entry builds it) and
    the Gaussian inputs, view and config of its first test request."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from bench_port import harness, inputs, program
    c = harness.find_cell(harness.load_spec(), cell)
    sc = c.cfg['scene']
    nf = sc['num_frames']
    model = program.build_model(inputs.model_flat(c.cfg, seed, 'cuda', nf),
                                c.cfg, nf, 'cuda')
    cams = inputs.split_cameras(sc, c.traffic['split'])
    view = program.views(inputs.view_arrays(sc, cams['c2w'][:1]), 'cuda')[0]
    with torch.no_grad():
        d = forward_deltas(model.cfg, model,
                           torch.tensor(float(cams['times'][0]),
                                        device='cuda'), 'sk')
        g = gaussian_inputs(model.gauss_view(), model.cfg.gauss, d.d_xyz,
                            d.d_rotation, d.d_scaling)
    return model, g, view


def preprocess_bytes(g: GaussianInputs) -> int:
    """Bytes the preprocess must move: each input read once (means,
    scales, rotation, opacity, SH, mask) and each output written once
    (means2d, depth, conic, colour, radius, tiles, two rects, visible,
    tau)."""
    n, ch = g.means3d.shape[0], g.sh.shape[2]
    read = 4 * (3 + 3 + 4 + 1 + g.sh.shape[1] * ch) + 1
    written = 4 * (2 + 1 + 3 + ch + 1 + 1 + 2 + 2 + 1) + 1
    return n * (read + written)


def preprocess_errors(got, ref, differ):
    """The kernel's float fields (``got``) against the plain version's
    (``ref``) on the rows whose integer fields agree (``~differ``). On the
    rows the plain version draws: each field's largest error over its
    largest magnitude there, inf where a non-finite value differs. On the
    others (culled, dead), whose projection may pass through 1/1e-7: the
    count of rows whose non-finite values differ, or whose colour or tau
    (which no cull touches) lies more than ``KERNEL_TOL`` from the plain
    one's, relative with a floor of 1. Returns (errors, rows)."""
    drawn, rest = ref.visible & ~differ, ~ref.visible & ~differ
    errs, bad = {}, torch.zeros_like(rest)
    for name in PRE_FLOAT_FIELDS:
        a, b = getattr(got, name), getattr(ref, name)
        x, y = a[drawn], b[drawn]
        fin = torch.isfinite(y)
        if not torch.equal(torch.isfinite(x), fin) \
                or not torch.equal(x[~fin].nan_to_num(), y[~fin].nan_to_num()):
            errs[name] = float('inf')
        elif fin.any():
            errs[name] = (float((x[fin] - y[fin]).abs().max())
                          / max(float(y[fin].abs().max()), 1e-30))
        else:
            errs[name] = 0.0
        fin = torch.isfinite(b)
        wrong = (torch.isfinite(a) != fin) \
            | (~fin & (a.nan_to_num() != b.nan_to_num()))
        if name in ('colors', 'tau'):
            wrong |= fin & ((a - b).abs() > KERNEL_TOL * b.abs().clamp(min=1))
        bad |= rest & wrong.reshape(wrong.shape[0], -1).any(-1)
    return errs, int(bad.sum())


def phase_kernel_preprocess(cells=PRE_CELLS):
    """Kernel #5, the preprocess, against its plain version at the sk
    cells' shapes; one line a cell."""
    rows = []
    for cell in cells:
        model, g, view = cell_request(cell)
        rcfg, active = model.rcfg, model.active_sh_degree
        args = (g, view, rcfg, active)
        with torch.no_grad():
            got = preprocess_fwd.launch(*args)
            ref = preprocess_plain(*args)
            torch.cuda.synchronize()
            differ = torch.zeros(g.means3d.shape[0], dtype=torch.bool,
                                 device='cuda')
            for name in PRE_INT_FIELDS:
                ne = getattr(got, name) != getattr(ref, name)
                differ |= ne.reshape(ne.shape[0], -1).any(-1)
            errs, culled_bad = preprocess_errors(got, ref, differ)
            ms = device_ms(preprocess_fwd, lambda: preprocess_fwd.launch(*args))
            wrapper_ms = cuda_ms(lambda: preprocess_fwd.launch(*args),
                                 iters=20, warmup=3)
            plain_ms = cuda_ms(lambda: preprocess_plain(*args), iters=10,
                               warmup=2)
            on_dev, _ = profile_window(
                lambda: [preprocess_plain(*args) for _ in range(5)])
            plain_device_ms = sum(dev_us(e) for e in on_dev) * 1e-3 / 5
            plain_launches = sum(e.count for e in on_dev
                                 if 'memcpy' not in e.key.lower()) / 5
        nbytes = preprocess_bytes(g)
        bound_ms, bound_by = bound(0, nbytes)
        live = int(g.mask.sum())
        row = {'phase': 'kernel_preprocess', 'cell': cell,
               'kernel': preprocess_fwd.name, 'rows': g.means3d.shape[0],
               'live_rows': live, 'image': [rcfg.image_width,
                                            rcfg.image_height],
               'max_rel_err_drawn': errs, 'culled_rows_bad': culled_bad,
               'int_rows_differing': int(differ.sum()),
               'tie_share_of_live': int(differ.sum()) / live,
               'tolerance': KERNEL_TOL, 'ms': ms, 'wrapper_ms': wrapper_ms,
               'plain_ms': plain_ms, 'plain_device_ms': plain_device_ms,
               'plain_device_ops': plain_launches, 'bytes': nbytes,
               'bound_ms': bound_ms, 'bound_by': bound_by,
               'roofline': bound_ms / ms,
               'blocks_per_sm': preprocess_fwd.blocks_per_sm(
                   rcfg.sh_degree, g.sh.shape[1] * g.sh.shape[2])}
        emit(row)
        rows.append(row)
        if max(errs.values()) > KERNEL_TOL or culled_bad \
                or int(differ.sum()) > 1e-4 * live:
            raise AssertionError(f'preprocess_fwd disagrees with its plain '
                                 f'version on {cell}: {errs}, {culled_bad} '
                                 f'culled rows, {int(differ.sum())} integer '
                                 f'rows')
        del model, g, got, ref
        torch.cuda.empty_cache()
    return rows


def phase_slice(model, views, times, bg):
    """Serve the requests through evaluate with the counts at 0."""
    plain_rcfg = model.rcfg._replace(use_kernel=False)
    refs = [render_eval(model, v, t, bg, rcfg=plain_rcfg)['image']
            for v, t in zip(views, times)]
    render_eval(model, views[0], times[0], bg)          # warm-up
    torch.cuda.synchronize()

    for k in COUNTED:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = evaluate(model, views, refs, times, bg)
    launches = {k.name: k.launches for k in COUNTED}
    peak = torch.cuda.max_memory_allocated()

    n = res['count']
    emit({'phase': 'slice', 'requests': res['requests'], 'count': n,
          'fps': res['fps'], 'launches': launches,
          'max_memory_allocated': peak,
          'PSNR_mean_vs_plain': res['PSNR'] / n,
          'SSIM_mean_vs_plain': res['SSIM'] / n})
    for req in res['requests']:
        if req['overflow'] or not 2 ** 19 <= req['num_pairs'] <= 2 ** 20:
            raise AssertionError(f'pairs out of range: {req}')
    # serving runs the preprocess and forward kernels once a render, the
    # backward never
    expected = {k.name: n if k in (tile_blend_fwd, preprocess_fwd) else 0
                for k in COUNTED}
    if launches != expected:
        raise AssertionError(f'launches {launches} in {n} renders, '
                             f'expected {expected}')
    if not res['PSNR'] / n > 60.0 or not res['SSIM'] / n > 0.9999:
        raise AssertionError('kernel path disagrees with the plain path')
    return launches, sum(r['ms'] for r in res['requests']) / n


def phase_reference(seed, bg):
    """A small model rendered on the card (kernel) and on the CPU (plain)."""
    cfg, rcfg, _ = synthetic_fullscale()
    cfg = cfg._replace(gauss=cfg.gauss._replace(capacity=4096),
                       num_superpoints=64,
                       sk_net=cfg.sk_net._replace(width=64, depth=4,
                                                  skips=(2,)))
    rcfg = rcfg._replace(image_width=96, image_height=80,
                         pair_capacity=2 ** 16)
    flat = random_model_flat(cfg, seed + 1, n_alive=3000, log_scale_mean=-3.0)
    views, times = requests(2, rcfg.image_width, rcfg.image_height, 'cpu')
    errs = []
    for v, t in zip(views, times):
        outs = []
        for dev in ('cuda', 'cpu'):
            model = convert.model_from_flat(flat, cfg, rcfg, device=dev)
            img = render_eval(model, v.to(dev), t, bg.to(dev))['image']
            outs.append(img.cpu())
        if outs[0].shape != (rcfg.image_height, rcfg.image_width, 3):
            raise AssertionError(f'image shape {tuple(outs[0].shape)}')
        if not bool(torch.isfinite(outs[0]).all()):
            raise AssertionError('non-finite pixels')
        errs.append(float((outs[0] - outs[1]).abs().max()))
    emit({'phase': 'reference', 'image': [rcfg.image_height, rcfg.image_width],
          'max_abs_err_cuda_vs_cpu': max(errs), 'tolerance': KERNEL_TOL})
    if max(errs) > KERNEL_TOL:
        raise AssertionError(f'card and CPU renders differ by {max(errs)}')


def fullscale_scene(rcfg, train):
    """The preset's synthetic scene, made on the card."""
    ds = train.dataset
    return make_synthetic_scene(
        seed=train.seed, num_links=ds.num_links,
        gauss_per_link=ds.gauss_per_link, num_frames=ds.num_frames,
        h=ds.image_size, w=ds.image_size, background=ds.background,
        pair_capacity=ds.gt_pair_capacity, chunk=rcfg.chunk, device='cuda')


def fullscale_trainer(cfg, rcfg, train, model=None) -> SKGSTrainer:
    """The preset's synthetic scene and ``model`` (by default the random
    full-width model with 80,000 alive, made trainable) behind the port's
    trainer."""
    scene, meta, _ = fullscale_scene(rcfg, train)
    if model is None:
        model = convert.model_from_flat(random_model_flat(cfg, SEED, 80_000),
                                        cfg, rcfg, device='cuda',
                                        trainable=True)
    return SKGSTrainer(cfg, rcfg, scene, meta, model, LossWeights(train.loss),
                       seed=train.seed, clip_norm=train.clip_norm,
                       optimizer=train.optimizer, skeleton_initialized=True,
                       device='cuda')


def first_view(trainer: SKGSTrainer, step: int) -> int:
    """The view ``train_step(step)`` samples first (a fresh sampler of the
    same seed, so the trainer's own draw counter is left alone)."""
    return UniformSampler(trainer.scene.num_views,
                          trainer.sampler.seed).sample(step)


def step_blend_inputs(trainer: SKGSTrainer, step: int):
    """The blend inputs of training step ``step`` and that step's
    cotangents of the tile colour and alpha (the trainer's forward,
    written out to stop at the blend)."""
    cfg, rcfg, model, scene = (trainer.cfg, trainer.rcfg, trainer.model,
                               trainer.scene)
    idx = first_view(trainer, step)
    trainer.loss_w.set_step(step)
    m2d_off = trainer.zero_grads()
    stage = cfg.stage_at(step)
    d = forward_deltas(cfg, model, scene.times[idx], stage,
                       time_id=scene.time_ids[idx], training=True)
    g = trainer.render_inputs(trainer.family(stage), d)
    inp = prepare_blend(g, scene.view(idx), rcfg, model.active_sh_degree,
                        m2d_off)
    color, alpha = blend_tiles(inp.binned, inp.geo, inp.col, rcfg)
    out = assemble_image(color, alpha, rcfg)
    img = composite_background(out['images'], out['opacity'], trainer.bg)
    image = scene.images[idx]
    lw = trainer.loss_w
    if lw.cfg('image').get('method', 'l1') != 'l1':
        raise AssertionError('the preset trains with the l1 image loss')
    loss = lw.w('image') * l1_loss(img, image) \
        + lw.w('ssim') * ssim_loss(img, image)
    g_color, g_alpha = torch.autograd.grad(loss, (color, alpha))
    return (inp, color.detach(), alpha.detach(), g_color.contiguous(),
            g_alpha.contiguous())


def phase_kernel_bwd(trainer: SKGSTrainer, step: int):
    """The trainer's schedule's backward kernel (#2 or #4) against its plain
    version on a training step's inputs and real cotangents: the gradient
    rows [R, 6 + ch] of the depth-ordered rows. Its time is the kernel's
    device time (its own reduction included); the wrapper's, its zeroing
    of the rows included, is given beside it."""
    rcfg = trainer.rcfg
    inp, color, alpha, g_color, g_alpha = step_blend_inputs(trainer, step)
    b = inp.binned
    fwd, kernel, args, meta_bytes = schedule_kernels(inp, rcfg)
    geo, col = args[:2]
    with torch.no_grad():
        bwd_args = (*args, color, alpha, g_color, g_alpha, rcfg)
        g_rows = kernel.launch(*bwd_args)
        again = kernel.launch(*bwd_args)
        p_rows = kernel.plain(*bwd_args)
        torch.cuda.synchronize()
        errs, rerun = {}, {}
        for name, sl in GROUPS.items():
            scale = max(float(p_rows[:, sl].abs().max()), 1e-30)
            errs[name] = float((g_rows[:, sl] - p_rows[:, sl]).abs().max()) \
                / scale
            rerun[name] = float((again[:, sl] - g_rows[:, sl]).abs().max()) \
                / scale
        finite = bool(torch.isfinite(g_rows).all())
        dummy_zero = not bool(g_rows[-1].any() or again[-1].any())
        max_abs = float((g_rows - p_rows).abs().max())
        stats = {}
        fwd.plain(*args, rcfg, stats=stats)
        ms = device_ms(kernel, lambda: kernel.launch(*bwd_args))
        wrapper_ms = cuda_ms(lambda: kernel.launch(*bwd_args), iters=20,
                             warmup=3)
        plain_ms = cuda_ms(lambda: kernel.plain(*bwd_args), iters=3, warmup=1)
        extra = chunk_layout(b) if rcfg.chunked else {}

    pairs = int(b.num_pairs)
    T, P, ch = rcfg.num_tiles, rcfg.pix_per_tile, col.shape[1]
    evals, adds = stats['evaluations'], stats['adds']
    ops = evals * BLEND_OPS_PER_EVAL + adds * BWD_OPS_PER_ADD
    # each input read once (the rows, the live entries' ids, the metadata,
    # the tiles' colours, alphas and their cotangents), g_rows written once
    nbytes = (4 * (geo.numel() + col.numel() + pairs) + meta_bytes
              + 4 * (2 * T * P * (ch + 1) + g_rows.numel()))
    row = kernel_row(kernel, max_abs, ms, plain_ms, ops, nbytes)
    counts = b.tile_count[b.tile_count > 0].float()
    emit({'phase': 'kernel_bwd' if not rcfg.chunked else 'kernel_chunk_bwd',
          'kernel': row['name'], 'step': step,
          'stage': trainer.cfg.stage_at(step), 'tiles': T,
          'pixels_per_tile': P, 'channels': ch, 'pairs': pairs,
          'rows': int(g_rows.shape[0]), 'evaluations': evals,
          'adds': adds, 'ops': ops, 'bytes': nbytes,
          'err_over_max_by_group': errs, 'max_abs_err': max_abs,
          'tolerance': BWD_TOL, 'finite': finite,
          'dummy_row_zero': dummy_zero,
          'rerun_diff_over_max_by_group': rerun,
          'rerun_tolerance': RERUN_TOL, 'ms': ms, 'wrapper_ms': wrapper_ms,
          'plain_ms': plain_ms,
          'blocks_per_sm': kernel.blocks_per_sm(rcfg, ch),
          'sms': torch.cuda.get_device_properties(0).multi_processor_count,
          'nonempty_tiles': int(counts.numel()),
          'tile_list_longest': int(counts.max()),
          'tile_list_mean': float(counts.mean()), **extra,
          'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
          'bound_ms_unfused': bound(ops, nbytes, PEAK_FP32_INSTR)[0]})
    if not finite or max(errs.values()) > BWD_TOL:
        raise AssertionError(f'{kernel.name} disagrees with its plain '
                             f'version: {errs} > {BWD_TOL}')
    if not dummy_zero or max(rerun.values()) > RERUN_TOL:
        raise AssertionError(f'{kernel.name}: dummy row zero {dummy_zero}, '
                             f'two launches differ by {rerun}')
    return row


def phase_profile_bwd(trainer: SKGSTrainer, step: int, phase: str):
    """The trainer's backward kernel (#2 or #4) on step ``step``'s inputs,
    its device time a launch by torch.profiler three ways: alone, launches
    back to back (warm caches); alone, each launch after a write that
    evicts L2; and inside that very step (the step reads the same inputs:
    the state is unchanged and the forward is deterministic; its pairs are
    checked). On the tile schedule also with every tile's list cut to its
    first LIST_CUTS entries: where in the lists the time goes."""
    rcfg = trainer.rcfg
    inp, color, alpha, g_color, g_alpha = step_blend_inputs(trainer, step)
    b = inp.binned
    _, kernel, args, _ = schedule_kernels(inp, rcfg)
    bwd_args = (*args, color, alpha, g_color, g_alpha, rcfg)

    # twice the H100's 50 MB L2
    flush = torch.empty(25 << 20, dtype=torch.float32, device='cuda')
    with torch.no_grad():
        warm = device_ms(kernel, lambda: kernel.launch(*bwd_args))
        cold = device_ms(kernel, lambda: (flush.fill_(1.0),
                                          kernel.launch(*bwd_args)))
        clipped = {}
        for n in (LIST_CUTS if not rcfg.chunked else ()):
            cut = clip_lists(bwd_args, rcfg, n)
            clipped[n] = device_ms(kernel, lambda: kernel.launch(*cut))
    del flush
    metrics = []
    in_step = device_ms(kernel, lambda: metrics.append(
        trainer.train_step(step)), launches=1)
    pairs, step_pairs = int(b.num_pairs), int(metrics[0]['num_pairs'])
    counts = b.tile_count[b.tile_count > 0].float()
    emit({'phase': phase, 'kernel': kernel.name, 'step': step,
          'pairs': pairs, 'step_pairs': step_pairs,
          'nonempty_tiles': int(counts.numel()),
          'tile_list_longest': int(counts.max()),
          'tile_list_mean': float(counts.mean()),
          'device_ms_warm': warm, 'device_ms_cold_l2': cold,
          'device_ms_in_step': in_step, 'ms_lists_clipped_to': clipped})
    if pairs != step_pairs:
        raise AssertionError(f'{phase}: the step read other inputs '
                             f'({step_pairs} pairs against {pairs})')


def clip_lists(args, rcfg, n: int) -> list:
    """Blend arguments (geo, col, sort_gauss, the schedule's metadata, ...)
    with every tile's list cut to its first ``n`` entries: tile_count
    clamped on the tile schedule; on the chunk schedule each chunk's valid
    count cut at n less the entries of its tile's earlier chunks."""
    cut = list(args)
    if rcfg.chunked:
        room = n - chunk_waves(cut[4]) * rcfg.chunk   # chunk_start_flag
        cut[6] = torch.clamp(torch.minimum(cut[6].long(), room),
                             min=0).to(torch.int32)  # chunk_valid
    else:
        cut[4] = torch.clamp(cut[4], max=n)             # tile_count
    return cut


def listed_rows(args, rcfg) -> torch.Tensor:
    """The rows that the entries of the tiles' lists read, from the blend
    arguments (geo, col, sort_gauss, the schedule's metadata)."""
    src, valid = (args[5], args[6]) if rcfg.chunked else (args[3], args[4])
    src, valid = src.long(), valid.long()
    offs = torch.arange(int(valid.max()), device=src.device)
    listed = offs[None, :] < valid[:, None]
    return args[2].long()[(src[:, None] + offs[None, :])[listed]]


def fwd_case(kernel, inp, rcfg) -> dict:
    """A forward kernel (#1 or #3) on one input: its device time a launch,
    whole and with every tile's list cut to its first LIST_CUTS entries;
    the lists; the share of their entries with o < 1/255 (never kept); and
    what becomes of the plain version's evaluations, as shares of them."""
    b = inp.binned
    args = schedule_kernels(inp, rcfg)[2]
    low_o = float((args[0][listed_rows(args, rcfg), 5] < ALPHA_MIN)
                  .float().mean())
    stats = {}
    with torch.no_grad():
        kernel.plain(*args, rcfg, stats=stats)
        ms = device_ms(kernel, lambda: kernel.launch(*args, rcfg))
        clipped = {}
        for n in LIST_CUTS:
            cut = clip_lists(args, rcfg, n)
            clipped[n] = device_ms(kernel, lambda: kernel.launch(*cut, rcfg))
    counts = b.tile_count[b.tile_count > 0].float()
    evals = stats['evaluations']
    return {'pairs': int(b.num_pairs), 'nonempty_tiles': int(counts.numel()),
            'tile_list_longest': int(counts.max()),
            'tile_list_mean': float(counts.mean()),
            'share_entries_o_below_alpha_min': low_o, 'evaluations': evals,
            'outcome_shares': {k: stats[k] / evals for k in OUTCOMES},
            'ms': ms, 'ms_lists_clipped_to': clipped}


def phase_profile_fwd(phase: str, kernel, rcfg, cases: dict):
    """A forward kernel on each of ``cases`` (name -> ``fwd_case``): where
    in the lists its time goes, and what its evaluations come to."""
    emit({'phase': phase, 'kernel': kernel.name,
          'blocks_per_sm': kernel.blocks_per_sm(rcfg, 3), 'cases': cases})


def view_loss(trainer: SKGSTrainer, step: int, idx: int) -> float:
    trainer.loss_w.set_step(step)
    with torch.no_grad():
        losses = trainer._losses(trainer.cfg.stage_at(step), idx,
                                 trainer.zero_grads())[0]
    return float(sum(losses.values()))


def phase_train(trainer: SKGSTrainer, s0: int):
    """A warm-up step, then N_STEPS steps with the launch counts at 0."""
    idx0 = first_view(trainer, s0)
    loss_before = view_loss(trainer, s0, idx0)
    trainer.train_step(s0)
    torch.cuda.synchronize()
    leaves = trainer.model.leaves()
    watch = ('xyz', 'sp_W', 'sk_deform/layers/0/w', 'global_tr')
    before = {k: leaves[k].detach().clone() for k in watch}

    for k in COUNTED:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for step in range(s0 + 1, s0 + 1 + N_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = {'step': step, 'ms': dt * 1e3}
        rec.update({k: float(v) for k, v in m.items()})
        rec['overflow'] = bool(m['overflow'])
        steps.append(rec)
        emit({'phase': 'train_step', **rec})
    launches = {k.name: k.launches for k in COUNTED}
    peak = torch.cuda.max_memory_allocated()
    loss_after = view_loss(trainer, s0 + N_STEPS, idx0)
    changed = {k: not torch.equal(before[k], leaves[k].detach())
               for k in watch}
    ms = [r['ms'] for r in steps]
    emit({'phase': 'train', 'steps': N_STEPS, 'first_step': s0 + 1,
          'stage': trainer.cfg.stage_at(s0 + 1), 'launches': launches,
          'ms_mean': sum(ms) / len(ms), 'ms_min': min(ms), 'ms_max': max(ms),
          'max_memory_allocated': peak, 'first_view': idx0,
          'loss_first_view_before': loss_before,
          'loss_first_view_after': loss_after, 'changed': changed})
    for r in steps:
        if not math.isfinite(r['loss']) or r['overflow']:
            raise AssertionError(f'bad training step: {r}')
    # the tile schedule: kernels #1 and #2 once a step, #3 and #4 never;
    # autograd records the preprocess, so #5 never
    expected = {k.name: N_STEPS if k in (tile_blend_fwd, tile_blend_bwd)
                else 0 for k in COUNTED}
    if launches != expected:
        raise AssertionError(f'launches {launches} in {N_STEPS} steps, '
                             f'expected {expected}')
    if not all(changed[k] for k in watch[:3]) or changed['global_tr']:
        raise AssertionError(f'leaves moved wrongly: {changed}')
    return launches


def leaf_grads(trainer: SKGSTrainer, step: int, idx: int,
               img_cotangent: torch.Tensor = None):
    """Every leaf's gradient of the step's loss at view ``idx`` (no
    update), with the composited image and the image losses' cotangent on
    it: that part of the gradient enters as ``img_cotangent`` when given
    (else the route's own); the other losses go through autograd."""
    trainer.loss_w.set_step(step)
    m2d_off = trainer.zero_grads()
    losses, _, _, img, _ = trainer._losses(trainer.cfg.stage_at(step), idx,
                                           m2d_off, step)
    if img_cotangent is None:
        img_cotangent, = torch.autograd.grad(
            sum(losses[k] for k in IMAGE_LOSSES), img, retain_graph=True)
    outs, cots = [img], [img_cotangent]
    rest = [v for k, v in losses.items() if k not in IMAGE_LOSSES]
    if rest:
        outs.append(sum(rest))
        cots.append(torch.ones_like(outs[-1]))
    torch.autograd.backward(outs, cots)
    grads = {k: p.grad.detach().clone()
             for k, p in trainer.model.leaves().items() if p.grad is not None}
    return grads, img.detach(), img_cotangent


def route_grads(trainer: SKGSTrainer, plain: SKGSTrainer, step: int):
    """The leaf gradients of ``step`` at its first view through the
    kernels (``trainer``) and through the plain route (``plain``, the same
    model), both from one cotangent of the image losses on the composited
    image, the plain route's: where one route renders a pixel channel
    exactly at the target, the l1 loss's sign(image - target) is 0 there
    and +-1 on the other, which is the loss's kink, not the kernels'. So
    the check holds the kernels' VJP at one upstream gradient. Returns
    (view, kernels' gradients, plain gradients, the pixel channels whose
    l1 sign differs between the routes)."""
    idx = first_view(trainer, step)
    ref, img_p, cot = leaf_grads(plain, step, idx)
    got, img_k, _ = leaf_grads(trainer, step, idx, cot)
    trainer.zero_grads()
    target = trainer.scene.images[idx][..., :3]
    flips = torch.sign(img_k[..., :3] - target) != \
        torch.sign(img_p[..., :3] - target)
    return idx, got, ref, int(flips.sum())


def close_leaves(got, ref, tol, scale_of=None, tol_of=None):
    """Worst error over the leaf's max magnitude, per leaf; raises when the
    non-finite entries differ or a leaf is off by more than ``tol`` (or its
    own in ``tol_of``). ``scale_of`` maps a leaf to another leaf whose max
    magnitude is its scale instead (a leaf whose gradient is zero but for
    rounding)."""
    scale_of, tol_of = scale_of or {}, tol_of or {}
    worst = {}
    for name, r in ref.items():
        g = got[name].to(r.device)
        fin = torch.isfinite(r)
        if not torch.equal(fin, torch.isfinite(g)):
            raise AssertionError(f'{name}: non-finite entries differ')
        s_ref = ref[scale_of.get(name, name)]
        scale = float(s_ref[torch.isfinite(s_ref)].abs().max()) \
            if bool(fin.any()) else 0.0
        err = float((g[fin] - r[fin]).abs().max()) if bool(fin.any()) else 0.0
        worst[name] = err / scale if scale > 0 else err
    bad = {k: v for k, v in worst.items() if v > tol_of.get(k, tol)}
    if bad:
        raise AssertionError(f'gradients differ beyond {tol} '
                             f'({tol_of}): {bad}')
    return worst


def phase_grad_path(trainer: SKGSTrainer, step: int):
    """One step's leaf gradients through the kernels and through the plain
    forward and backward on the card, same model and sample."""
    plain = SKGSTrainer(trainer.cfg, trainer.rcfg._replace(use_kernel=False),
                        trainer.scene, trainer.meta, trainer.model,
                        trainer.loss_w, opt_state=trainer.opt_state,
                        skeleton_initialized=True, device='cuda')
    idx, got, ref, flips = route_grads(trainer, plain, step)
    worst = close_leaves(got, ref, GRAD_PATH_TOL)
    emit({'phase': 'grad_path', 'step': step, 'view': idx,
          'leaves': len(ref), 'tolerance': GRAD_PATH_TOL,
          'image_cotangent': 'shared', 'l1_sign_flips': flips,
          'worst_err_over_max': max(worst.values()),
          'err_over_max_by_leaf': worst})


def params_over_tol(f_c, f_p, grads, lrs, steps: int, scale_of=None,
                    cut_of=None):
    """The worst parameter error over its bound and its leaf
    (tests/test_torch_train.py's bounds): where the gradient exceeded 1e-3
    of the leaf's max at every step (``grads``, one dict a step), 1e-5 of
    the leaf plus 1% of its Adam steps; elsewhere 2 lr a step, since Adam
    moves an entry whose gradient is near zero at any one step by up to
    +-lr at that step. ``scale_of`` as for ``close_leaves``; ``cut_of``
    raises the 1e-3 and the 1% of a leaf (by the name before its first
    '/') to its gradient bar where that is larger: a relative gradient
    error e moves an Adam step by ~e lr."""
    scale_of, cut_of = scale_of or {}, cut_of or {}
    worst, worst_leaf = 0.0, None
    for name, lr in lrs.items():
        got, ref = f_c['params/' + name], f_p['params/' + name]
        cut = max(1e-3, cut_of.get(name.split('/')[0], 0.0))
        step_share = max(0.01, cut)
        big = np.ones(got.shape, bool)
        for step_grads in grads:
            g = step_grads[name].abs().numpy()
            top = float(step_grads[scale_of.get(name, name)].abs().max())
            big &= g > cut * top
        err = np.abs(got - ref)
        scale = float(np.abs(ref).max())
        tol_big = 1e-5 * scale + step_share * lr * steps + 1e-30
        tol_all = 2 * lr * steps + 1e-5 * scale + 1e-30
        leaf = max(float(err[big].max(initial=0.0)) / tol_big,
                   float(err.max()) / tol_all)
        if leaf > worst:
            worst, worst_leaf = leaf, name
    return worst, worst_leaf


def reference_steps(seed: int, scenes: dict) -> dict:
    """The small model trained 2 ``sk`` steps on the card (kernels) and on
    the CPU (plain versions), each on its (scene, meta) of ``scenes``:
    losses, gradients and parameters compared as in
    tests/test_torch_train.py."""
    cfg, rcfg, train = synthetic_fullscale()
    cfg = cfg._replace(gauss=cfg.gauss._replace(capacity=4096),
                       num_superpoints=64, num_frames=6,
                       sk_net=cfg.sk_net._replace(width=64, depth=4,
                                                  skips=(2,)))
    rcfg = rcfg._replace(image_width=96, image_height=80,
                         pair_capacity=2 ** 16)
    flat = random_model_flat(cfg, seed + 1, n_alive=3000, log_scale_mean=-3.0)
    s0 = cfg.stages['sk'][0] + 1
    runs = {}
    for dev in ('cuda', 'cpu'):
        scene, meta = scenes[dev]
        model = convert.model_from_flat(flat, cfg, rcfg, device=dev,
                                        trainable=True)
        tr = SKGSTrainer(cfg, rcfg, scene, meta, model,
                         LossWeights(train.loss), skeleton_initialized=True,
                         device=dev)
        losses, grads = [], []
        for step in (s0, s0 + 1):
            losses.append(float(tr.train_step(step)['loss']))
            grads.append({k: p.grad.detach().cpu().clone()
                          for k, p in model.leaves().items()
                          if p.grad is not None})
        runs[dev] = (losses, grads, convert.model_to_flat(model),
                     tr.lr_trees(s0 + 1))
    (l_c, g_c, f_c, lrs), (l_p, g_p, f_p, _) = runs['cuda'], runs['cpu']
    param_worst, worst_leaf = params_over_tol(f_c, f_p, g_p, lrs, 2)
    # the same bounds with the last step's gradient alone deciding which
    # entries are settled (reported beside the rule above, not checked)
    last_worst, last_leaf = params_over_tol(f_c, f_p, g_p[-1:], lrs, 2)
    return {'image': [80, 96], 'steps': 2,
            'loss_cuda': l_c, 'loss_cpu': l_p,
            'loss_rel_err': max(abs(a - b) / abs(b) for a, b in zip(l_c, l_p)),
            'grad_worst_err_over_max': [max(close_leaves(a, b, 3e-4).values())
                                        for a, b in zip(g_c, g_p)],
            'param_worst_over_tol': param_worst,
            'param_worst_leaf': worst_leaf,
            'param_worst_over_tol_last_step_rule': last_worst,
            'param_worst_leaf_last_step_rule': last_leaf}


def phase_train_reference(seed: int):
    """A small model trained 2 steps on the card (kernels) and on the CPU
    (plain versions), each on the scene it made: losses 2e-4, gradients
    3e-4 of each leaf's max, and parameters as in
    tests/test_torch_train.py (where the gradient exceeds 1e-3 of the
    leaf's max: 1e-5 of the leaf plus 1% of its Adam steps; elsewhere 2 lr
    a step, since Adam moves a near-zero gradient entry by +-lr whatever
    its size)."""
    scenes = {dev: make_synthetic_scene(
        seed=seed, num_links=3, gauss_per_link=60, num_frames=6, h=80, w=96,
        pair_capacity=2 ** 15, device=dev)[:2] for dev in ('cuda', 'cpu')}
    rec = reference_steps(seed, scenes)
    emit({'phase': 'train_reference', **rec})
    if rec['loss_rel_err'] > 2e-4 or rec['param_worst_over_tol'] > 1.0:
        raise AssertionError('card and CPU training differ')


@contextlib.contextmanager
def handed_backgrounds(seed: int):
    """The trainer's 'random' backgrounds drawn on the host from a numpy
    generator of ``seed`` and moved to the step's device: the k-th draw on
    the card and the k-th on the CPU are the same background."""
    rng = np.random.default_rng(seed)
    orig = trainer_mod.sample_background
    draws, calls = [], {}

    def handed(kind, gen, h, w, checker=None, reference_rgb=None):
        if kind != 'random':
            return orig(kind, gen, h, w, checker, reference_rgb)
        k = calls[gen.device.type] = calls.get(gen.device.type, -1) + 1
        while len(draws) <= k:
            draws.append(rng.uniform(size=(h, w, 3)).astype(np.float32))
        return torch.from_numpy(draws[k]).to(gen.device)

    trainer_mod.sample_background = handed
    try:
        yield
    finally:
        trainer_mod.sample_background = orig


def phase_train_reference_rgba(seed: int):
    """phase_train_reference on an RGBA scene (made once on the CPU and
    copied to the card), with the 'checker' background and with 'random'
    backgrounds drawn on the host and handed to both runs; its bars."""
    for kind in ('checker', 'random'):
        scene, meta, _ = make_synthetic_scene(
            seed=seed, num_links=3, gauss_per_link=60, num_frames=6, h=80,
            w=96, pair_capacity=2 ** 15, background=kind, device='cpu')
        with handed_backgrounds(seed):
            rec = reference_steps(seed, {'cuda': (scene.to('cuda'), meta),
                                         'cpu': (scene, meta)})
        emit({'phase': 'train_reference_rgba', 'background': kind,
              'channels': int(scene.images.shape[-1]), **rec})
        if rec['loss_rel_err'] > 2e-4 or rec['param_worst_over_tol'] > 1.0 \
                or scene.images.shape[-1] != 4:
            raise AssertionError(f'card and CPU training differ on RGBA '
                                 f'({kind})')


def flagship_model(cfg, rcfg, train, train_times):
    """The flagship start: 2,000 points from the preset's seed,
    ``init_from_pcd`` and ``init_model``."""
    pts, cols = flagship_point_cloud(train)
    base = init_from_pcd(pts, cols, cfg.gauss, device='cuda')
    return init_model(cfg, rcfg, base, train_times, seed=train.seed,
                      device='cuda')


def populated_model(cfg, rcfg, n_alive: int):
    """A random model with ``n_alive`` live slots and the warp nets, in the
    init stage (SH degree 0, as an init run has it)."""
    model = convert.model_from_flat(
        random_model_flat(cfg, SEED, n_alive), cfg, rcfg, device='cuda',
        trainable=True)
    model.active_sh_degree.zero_()
    return model


def run_init_steps(trainer: SKGSTrainer, start: str, steps):
    """Steps ``steps`` of ``trainer``: a record per step and per event."""
    records, events = [], []
    for step in steps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(step)
        torch.cuda.synchronize()
        rec = {'start': start, 'step': step,
               'stage': trainer.cfg.stage_at(step),
               'ms': (time.perf_counter() - t0) * 1e3,
               'n_alive': int(trainer.model.alive.sum())}
        rec.update({k: float(m[k]) for k in ('loss', 'rgb', 'ssim', 'c_net',
                                              'num_pairs', 'n_bad_grad',
                                              'n_vis', 'psnr')})
        rec['overflow'] = bool(m['overflow'])
        records.append(rec)
        emit({'phase': 'init_step', **rec})
        if trainer.last_event:
            ev = {'start': start, 'after_step': step,
                  **{k: int(v) for k, v in trainer.last_event.items()}}
            events.append(ev)
            emit({'phase': 'init_event', **ev})
    return records, events


def phase_init_train(cfg, rcfg, train, profile: bool = False):
    """The init family at full width on the chunk schedule. First kernel #4
    and the gradient path on the populated start's first step (before it
    trains), and with ``profile`` kernel #3's ``fwd_case`` there; then,
    with the counts at 0, the steps of every start."""
    scene, meta, _ = fullscale_scene(rcfg, train)
    trainers = {}
    for start, n_alive, _ in INIT_STARTS:
        model = (flagship_model(cfg, rcfg, train, meta.train_times)
                 if n_alive is None else populated_model(cfg, rcfg, n_alive))
        trainers[start] = SKGSTrainer(
            cfg, rcfg, scene, meta, model, LossWeights(train.loss),
            seed=train.seed, clip_norm=train.clip_norm,
            optimizer=train.optimizer, device='cuda')
    s0 = INIT_STARTS[1][2][0]
    row = phase_kernel_bwd(trainers['populated'], s0)
    phase_grad_path_init(trainers['populated'], s0)
    fwd_profile = (fwd_case(chunk_blend_fwd, step_blend_inputs(
        trainers['populated'], s0)[0], rcfg) if profile else None)

    for k in COUNTED:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    records, events = [], []
    for start, _, steps in INIT_STARTS:
        recs, evs = run_init_steps(trainers[start], start, steps)
        records += recs
        events += evs
    launches = {k.name: k.launches for k in COUNTED}
    peak = torch.cuda.max_memory_allocated()
    n = len(records)
    ms = [r['ms'] for r in records]
    emit({'phase': 'init_train', 'steps': n, 'launches': launches,
          'ms_mean': sum(ms) / n, 'ms_mean_without_first': sum(ms[1:]) / (n - 1),
          'ms_min': min(ms), 'ms_max': max(ms),
          'ms_by_start': ms_by_start(records, events),
          'max_memory_allocated': peak, 'events': events})
    for r in records:
        if not math.isfinite(r['loss']) or r['overflow']:
            raise AssertionError(f'bad init step: {r}')
    expected = {k.name: n if k in (chunk_blend_fwd, chunk_blend_bwd) else 0
                for k in COUNTED}
    if launches != expected:
        raise AssertionError(f'launches {launches} in {n} init steps, '
                             f'expected {expected}')
    after = {(e['start'], e['after_step']): e for e in events}
    due = {('flagship', 100), ('populated', 3000), ('full', 3000)}
    if set(after) != due \
            or not all(after[k].get('opacity_reset') for k in due
                       if k[1] == 3000) \
            or min(e['n_cloned'] + e['n_split'] for e in events) == 0 \
            or after[('full', 3000)]['n_dropped'] == 0:
        raise AssertionError(f'adaptive control did not run as due: {events}')
    return launches, trainers, row, fwd_profile


def ms_by_start(records, events) -> dict:
    """Each start's mean step time and pairs before its event, the event
    step's (the step and the densify / prune / reset after it), and after."""
    out = {}
    for start, _, steps in INIT_STARTS:
        ev = next((e['after_step'] for e in events if e['start'] == start),
                  steps[-1] + 1)
        recs = [r for r in records if r['start'] == start]
        parts = {'before': [r for r in recs if r['step'] < ev],
                 'event_step': [r for r in recs if r['step'] == ev],
                 'after': [r for r in recs if r['step'] > ev]}
        out[start] = {
            name: {'steps': len(rs),
                   'ms_mean': sum(r['ms'] for r in rs) / len(rs),
                   'pairs_mean': sum(r['num_pairs'] for r in rs) / len(rs)}
            for name, rs in parts.items() if rs}
    return out


def phase_grad_path_init(trainer: SKGSTrainer, step: int):
    """One ``init`` step's leaf gradients through kernels #3 and #4 and
    through the plain chunk route on the card, same model and sample."""
    plain = SKGSTrainer(trainer.cfg, trainer.rcfg._replace(use_kernel=False),
                        trainer.scene, trainer.meta, trainer.model,
                        trainer.loss_w, opt_state=trainer.opt_state,
                        device='cuda')
    idx, got, ref, flips = route_grads(trainer, plain, step)
    # the init family renders every Gaussian at one isotropic scale, so the
    # covariance does not depend on the rotation: its gradient is rounding
    # noise, held against the position gradient's scale instead
    worst = close_leaves(got, ref, GRAD_PATH_TOL, scale_of={'rotation': 'xyz'})
    nets = sorted({k.split('/')[0] for k in ref if '/' in k})
    emit({'phase': 'grad_path_init', 'step': step,
          'stage': trainer.cfg.stage_at(step), 'view': idx,
          'leaves': len(ref), 'nets': nets, 'tolerance': GRAD_PATH_TOL,
          'image_cotangent': 'shared', 'l1_sign_flips': flips,
          'worst_err_over_max': max(worst.values()),
          'max_abs_grad': {k: float(ref[k].abs().max())
                           for k in ('rotation', 'xyz')},
          'err_over_max_by_leaf': worst})
    if not {'sp_deform', 'canonical'} <= set(nets):
        raise AssertionError(f'the warp nets got no gradient: {nets}')


def phase_train_reference_init(seed: int):
    """A small init-family model trained on the card (kernels #3/#4) and
    on the CPU (plain versions) for steps 100 and 101, across the densify /
    prune event after step 100; compared as train_reference compares, and
    ``alive`` exactly. Both draw the split noise from a CPU generator."""
    cfg, rcfg, train = synthetic_fullscale()
    cfg = cfg._replace(gauss=cfg.gauss._replace(capacity=4096),
                       num_superpoints=64, num_frames=6,
                       net=cfg.net._replace(depth=4, width=64),
                       sk_net=cfg.sk_net._replace(width=64, depth=4,
                                                  skips=(2,)))
    rcfg = rcfg._replace(image_width=96, image_height=80,
                         pair_capacity=2 ** 16, schedule='chunk')
    pts, cols = flagship_point_cloud(train)
    runs = {}
    for dev in ('cuda', 'cpu'):
        scene, meta, _ = make_synthetic_scene(
            seed=seed, num_links=3, gauss_per_link=60, num_frames=6, h=80,
            w=96, pair_capacity=2 ** 15, device=dev)
        base = init_from_pcd(pts, cols, cfg.gauss, device=dev)
        model = init_model(cfg, rcfg, base, meta.train_times, seed=seed,
                           device=dev)
        tr = SKGSTrainer(cfg, rcfg, scene, meta, model,
                         LossWeights(train.loss), seed=seed, device=dev)
        losses, grads, events = [], [], []
        for step in (100, 101):
            losses.append(float(tr.train_step(step)['loss']))
            grads.append({k: p.grad.detach().cpu().clone()
                          for k, p in model.leaves().items()})
            events.append({k: int(v) for k, v in tr.last_event.items()})
        runs[dev] = (losses, grads, convert.model_to_flat(model),
                     tr.lr_trees(101), events)
    (l_c, g_c, f_c, lrs, ev_c), (l_p, g_p, f_p, _, ev_p) = (runs['cuda'],
                                                            runs['cpu'])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_c, l_p))
    # the rotation gradient is rounding noise here (see grad_path_init)
    iso = {'rotation': 'xyz'}
    grad_worst = [max(close_leaves(a, b, 3e-4, scale_of=iso).values())
                  for a, b in zip(g_c, g_p)]
    param_worst, worst_leaf = params_over_tol(f_c, f_p, g_p, lrs, 2,
                                              scale_of=iso)
    same_alive = bool(np.array_equal(f_c['alive'], f_p['alive']))
    emit({'phase': 'train_reference_init', 'image': [80, 96], 'steps': 2,
          'loss_cuda': l_c, 'loss_cpu': l_p, 'loss_rel_err': loss_err,
          'events_cuda': ev_c, 'events_cpu': ev_p, 'alive_equal': same_alive,
          'n_alive': int(f_c['alive'].sum()),
          'grad_worst_err_over_max': grad_worst,
          'param_worst_over_tol': param_worst, 'param_worst_leaf': worst_leaf})
    if loss_err > 2e-4 or param_worst > 1.0 or not same_alive \
            or ev_c != ev_p or not ev_c[0]:
        raise AssertionError('card and CPU init training differ')


# ---------------------------------------------------------------- sp family


def time_events(trainer: SKGSTrainer) -> list:
    """Wrap the trainer's event methods: each event that runs appends its
    name, its synchronised host time and its result to the returned log
    (the caller tags the step). The KNN rebuild counts when it ran."""
    log = []
    for name in EVENT_HOOKS:
        fn = getattr(trainer, name)

        def timed(*args, _fn=fn, _name=name, **kw):
            knn = trainer.gs_knn_index
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if _name != 'update_gs_knn' or trainer.gs_knn_index is not knn:
                log.append({'event': _name.strip('_'), 'ms': ms,
                            'result': out})
            return out
        setattr(trainer, name, timed)
    return log


def run_sp_steps(trainer: SKGSTrainer, steps, log: list, phase: str):
    """Steps ``steps``: a record per step (synchronised time, the sp
    losses, pairs, overflow, non-finite gradients) and the events each ran
    before and after it, with their counts."""
    records = []
    for step in steps:
        n_log = len(log)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(step)
        torch.cuda.synchronize()
        rec = {'step': step, 'stage': trainer.cfg.stage_at(step),
               'ms': (time.perf_counter() - t0) * 1e3,
               'n_alive': int(trainer.model.alive.sum()),
               'n_sp_alive': int(trainer.model.sp_alive.sum()),
               'zero_knn': not bool(trainer.gs_knn_index.any())}
        rec.update({k: float(v) for k, v in m.items() if k != 'overflow'})
        rec['overflow'] = bool(m['overflow'])
        rec['counts'] = {k: int(v) for k, v in trainer.last_event.items()}
        rec['events'] = [{'event': e['event'], 'ms': e['ms']}
                         for e in log[n_log:]]
        for e in log[n_log:]:
            e['step'] = step
        records.append(rec)
        emit({'phase': phase + '_step', **rec})
    for r in records:
        if not math.isfinite(r['loss']) or r['overflow']:
            raise AssertionError(f'bad {phase} step: {r}')
    return records


def phase_sp_events(cfg, rcfg, train):
    """The sp family's stage events at full width on the tile schedule.
    The populated init start (80,000 alive, random warp nets) takes steps
    7499-7501: the superpoint initialisation runs before step 7500, its FPS
    checked, and held (card against CPU) on the same trajectories; then
    the restart from the flagship's point cloud before step 10,000, and
    steps 10,000-10,003 into sp_fix."""
    scene, meta, _ = fullscale_scene(rcfg, train)
    model = populated_model(cfg, rcfg, 80_000)
    trainer = SKGSTrainer(cfg, rcfg, scene, meta, model,
                          LossWeights(train.loss), seed=train.seed,
                          pcd=flagship_point_cloud(train), device='cuda')
    checks = {}

    def init_checked(_fn=trainer._init_superpoints):
        idx = _fn()
        ops = trainer.opt_state
        replaced = ('xyz', 'f_dc', 'f_rest', 'scaling', 'rotation',
                    'opacity', 'hyper', 'sp_points', 'sp_hyper')
        p = model.params
        checks['init'] = {
            'n_alive': int(model.alive.sum()),
            'sp_alive_all': bool(model.sp_alive.all()),
            'hyper_1e-2': bool((p['hyper'][:512] == 1e-2).all()
                               and not p['hyper'][512:].any()),
            'sp_hyper_1e-2': bool((p['sp_hyper'] == 1e-2).all()),
            'moments_zero': all(not ops.mu[k].any() and not ops.nu[k].any()
                                for k in replaced),
            'sh_degree': int(model.active_sh_degree)}
        return idx

    def reinit_checked(_fn=trainer._reinit_from_pcd):
        _fn()
        w = model.params['sp_W']
        one = torch.log(torch.tensor(36.0, device=w.device))
        checks['reinit'] = {
            'n_alive': int(model.alive.sum()),
            'sp_W_one_hot_log36': bool(((w == 0) | (w == one)).all()
                                       and ((w == one).sum(-1) == 1).all())}
    trainer._init_superpoints = init_checked
    trainer._reinit_from_pcd = reinit_checked
    log = time_events(trainer)

    records = run_sp_steps(trainer, SP_EVENT_STEPS[0][:1], log, 'sp_events')
    traj = sample_trajectories(cfg, model)
    alive = model.alive.clone()
    t0 = time.perf_counter()
    card, card_d = furthest_point_sampling(traj, cfg.num_superpoints, alive,
                                           return_dists=True)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cpu, cpu_d = furthest_point_sampling(traj.cpu(), cfg.num_superpoints,
                                         alive.cpu(), return_dists=True)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    records += run_sp_steps(trainer, SP_EVENT_STEPS[0][1:], log, 'sp_events')
    records += run_sp_steps(trainer, SP_EVENT_STEPS[1], log, 'sp_events')

    picks = next(e['result'] for e in log if e['event'] == 'init_superpoints')
    card, card_d = card.cpu(), card_d.cpu()
    differ = int((card != cpu).sum())
    fin = torch.isfinite(cpu_d)
    d_err = float(((card_d[fin] - cpu_d[fin]).abs()
                   / cpu_d[fin].abs().clamp(min=1e-30)).max())
    fps = {'n_picks': int(picks.numel()),
           'distinct': int(torch.unique(picks).numel()),
           'all_alive': bool(alive[picks].all()),
           'first_is_first_alive': int(picks[0]) == int(torch.argmax(
               alive.to(torch.int32))),
           'event_equals_card_fps': bool(torch.equal(picks.cpu(), card)),
           'picks_differing_card_vs_cpu': differ,
           'dist_rel_err_card_vs_cpu': d_err, 'dist_tolerance': FPS_RTOL,
           'card_fps_ms': card_ms, 'cpu_fps_ms': cpu_ms,
           'trajectory_width': int(traj.shape[1])}
    events = [{k: v for k, v in e.items() if k != 'result'} for e in log]
    emit({'phase': 'sp_events', 'fps': fps, 'checks': checks,
          'events': events, 'steps': [r['step'] for r in records],
          'ms_by_step': [r['ms'] for r in records],
          'ms_sp_fix_steps_on_the_zero_knn': [
              r['ms'] for r in records
              if r['stage'] == 'sp_fix' and r['zero_knn']],
          'max_memory_allocated': torch.cuda.max_memory_allocated()})
    init, reinit = checks['init'], checks['reinit']
    if (fps['distinct'] != 512 or not fps['all_alive']
            or not fps['first_is_first_alive']
            or not fps['event_equals_card_fps'] or d_err > FPS_RTOL
            or init['n_alive'] != 512 or not init['sp_alive_all']
            or not init['hyper_1e-2'] or not init['sp_hyper_1e-2']
            or not init['moments_zero'] or init['sh_degree'] != 0
            or reinit['n_alive'] != 2000
            or not reinit['sp_W_one_hot_log36']):
        raise AssertionError(f'sp events: {fps} {checks}')


def sp_stage_trainer(cfg, rcfg, train) -> SKGSTrainer:
    """A random sp-stage model (80,000 alive, all 512 superpoints live)
    behind a fresh trainer on the preset's scene, past the superpoint
    events, its skeleton not initialised."""
    scene, meta, _ = fullscale_scene(rcfg, train)
    model = convert.model_from_flat(
        random_model_flat(cfg, SEED, 80_000, sp_stage=True), cfg, rcfg,
        device='cuda', trainable=True)
    return SKGSTrainer(cfg, rcfg, scene, meta, model, LossWeights(train.loss),
                       seed=train.seed, sp_initialized=True,
                       reinit_done=True, device='cuda')


def phase_sp_train(cfg, rcfg, train):
    """The sp family at full width: a random sp-stage model (80,000 alive,
    all 512 superpoints live), one trainer on the tile schedule, built
    fresh so that its smooth-loss KNN is all zeros, as the flagship's is
    until step 14,000; a warm-up step (13,998), then with the launch counts
    at 0 steps 13,999-14,001 (the KNN's first rebuild before 14,000, a
    densify after it), 19,999-20,002 (the canonical replacement and the KNN
    rebuild before 20,000; the joint tree, the superpoint prune / split and
    densify / prune after it) and 29,999-30,001 (the merge after 30,000).
    Then the smooth loss's forward and backward alone on the last step's
    weights, on the rebuilt KNN and on an all-zero one."""
    trainer = sp_stage_trainer(cfg, rcfg, train)
    trainer.train_step(SP_TRAIN_STEPS[0] - 1)
    log = time_events(trainer)
    torch.cuda.synchronize()
    for k in COUNTED:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    records = run_sp_steps(trainer, SP_TRAIN_STEPS, log, 'sp_train')
    launches = {k.name: k.launches for k in COUNTED}
    peak = torch.cuda.max_memory_allocated()
    events = [{k: v for k, v in e.items() if k != 'result'} for e in log]
    ms = [r['ms'] for r in records]
    quiet = [r['ms'] for r in records if not r['events']
             and not r['zero_knn']]
    smooth = smooth_loss_case(trainer, SP_TRAIN_STEPS[-1])
    knn = trainer.gs_knn_index
    zero = torch.zeros_like(knn)
    smooth_ms = {'rebuilt_knn': cuda_ms(lambda: smooth(knn), 5, 1),
                 'zero_knn': cuda_ms(lambda: smooth(zero), 5, 1)}
    emit({'phase': 'sp_train', 'steps': len(records), 'launches': launches,
          'ms_mean': sum(ms) / len(ms), 'ms_min': min(ms), 'ms_max': max(ms),
          'ms_steps_on_the_zero_knn': [r['ms'] for r in records
                                       if r['zero_knn']],
          'ms_mean_steps_without_events_on_a_rebuilt_knn':
              sum(quiet) / max(len(quiet), 1),
          'smooth_fwd_bwd_ms': smooth_ms,
          'max_memory_allocated': peak, 'events': events})
    n = len(records)
    expected = {k.name: n if k in (tile_blend_fwd, tile_blend_bwd) else 0
                for k in COUNTED}
    if launches != expected:
        raise AssertionError(f'launches {launches} in {n} sp steps, '
                             f'expected {expected}')
    if [r['step'] for r in records if r['zero_knn']] != [13999]:
        raise AssertionError('the smooth-loss KNN is not all zeros exactly '
                             'until its first rebuild before step 14,000')
    ran = {(e['event'], e['step']) for e in events}
    due = {('update_gs_knn', 14000), ('densify_prune', 14000),
           ('canonical_replace', 20000), ('update_gs_knn', 20000),
           ('update_joint', 20000), ('sp_prune_split', 20000),
           ('densify_prune', 20000), ('update_gs_knn', 30000),
           ('update_joint', 30000), ('sp_merge', 30000),
           ('densify_prune', 30000)}
    if ran != due:
        raise AssertionError(f'sp events ran {sorted(ran)}, due '
                             f'{sorted(due)}')
    return launches, trainer


def smooth_loss_case(trainer: SKGSTrainer, step: int):
    """The smooth loss's forward and backward alone, on the LBS weights of
    ``step``'s view, over a given KNN index (a closure to time)."""
    model = trainer.model
    idx = first_view(trainer, step)
    with torch.no_grad():
        d = forward_deltas(trainer.cfg, model, trainer.scene.times[idx], 'sp')
    w0 = d.aux['knn_w'].detach()

    def run(index):
        w = w0.clone().requires_grad_(True)
        smooth_loss(w, index, model.alive).backward()
    return run


def phase_grad_path_sp(trainer: SKGSTrainer, step: int):
    """One sp step's leaf gradients through kernels #1 and #2 and through
    the plain route on the card, same model, KNN and sample."""
    plain = SKGSTrainer(trainer.cfg, trainer.rcfg._replace(use_kernel=False),
                        trainer.scene, trainer.meta, trainer.model,
                        trainer.loss_w, opt_state=trainer.opt_state,
                        gs_knn_index=trainer.gs_knn_index,
                        sp_initialized=True, reinit_done=True, device='cuda')
    idx, got, ref, flips = route_grads(trainer, plain, step)
    worst = close_leaves(got, ref, GRAD_PATH_TOL)
    zero = sorted(k for k, v in ref.items() if not v.any())
    emit({'phase': 'grad_path_sp', 'step': step,
          'stage': trainer.cfg.stage_at(step), 'view': idx,
          'leaves': len(ref), 'tolerance': GRAD_PATH_TOL,
          'image_cotangent': 'shared', 'l1_sign_flips': flips,
          'worst_err_over_max': max(worst.values()),
          'leaves_with_zero_gradient': zero,
          'err_over_max_by_leaf': worst})
    if not {'sp_W', 'xyz', 'joint_pos', 'sp_deform/warp/w'} <= set(ref) \
            or not ref['sp_W'].any():
        raise AssertionError('the sp leaves got no gradient')


def smooth_rounding(trainer: SKGSTrainer, d, step: int) -> float:
    """The float32 rounding of the smooth loss's ``sp_W`` gradient on the
    trainer's device: max |g32 - g64| of the step's weighted smooth loss
    through the LBS softmax (LBS_method 'W'), on the step's own
    superpoints, KNN and live rows. On the all-zero KNN, row 0 of that
    gradient is one sum of ~20 K terms a live Gaussian."""
    model = trainer.model
    grads = []
    for dtype in (torch.float32, torch.float64):
        sp_w = model.params['sp_W'].detach().to(dtype).requires_grad_(True)
        w = torch.softmax(select_rows(sp_w, d.aux['knn_i']), dim=-1)
        (trainer.loss_weight('smooth', step) * smooth_loss(
            w, trainer.gs_knn_index, model.alive)).backward()
        grads.append(sp_w.grad.to(torch.float64))
    return float((grads[0] - grads[1]).abs().max())


def sp_w_diagnosis(card, cpu, g_card, g_cpu) -> dict:
    """Where the card's ``sp_W`` gradient differs most from the CPU's, and
    why: the live rows whose discrete choices differ between the two (their
    LBS superpoints, or the sign of a smooth-loss difference w_i - w_j at a
    tie, which moves rows i and j), and at the worst row the gradient
    reaching its LBS weights, dL/dw: the difference between the two sides
    there, carried through the softmax (times the row's largest weight),
    over the leaf's max, is what that difference alone accounts for."""
    _, w_c, i_c, knn, alive = card
    _, w_p, i_p, _, _ = cpu
    gw_c, gw_p = w_c.grad.cpu(), w_p.grad.cpu()
    w_c, w_p = w_c.detach().cpu(), w_p.detach().cpu()
    err = (g_card - g_cpu).abs().amax(-1)
    top = float(g_cpu.abs().max())
    row = int(err.argmax())
    lbs = (i_c != i_p).any(-1) & alive
    sign = lambda w: torch.sign(w[:, None] - w[knn])
    flip = (sign(w_c) != sign(w_p)).any(-1) & alive[:, None]
    kink = flip.any(-1)
    kink[knn[flip]] = True
    d_gw = float((gw_c[row] - gw_p[row]).abs().max())
    return {'worst_row': row, 'worst_row_err_over_max': float(err[row]) / top,
            'worst_row_weights_differ': float((w_c[row] - w_p[row]).abs()
                                              .max()),
            'worst_row_dL_dw_rel_diff': d_gw / max(
                float(gw_p[row].abs().max()), 1e-30),
            'worst_row_dL_dw_diff_through_softmax_over_max':
                d_gw * float(w_p[row].max()) / top,
            'worst_row_lbs_differs': bool(lbs[row]),
            'worst_row_smooth_sign_differs': bool(kink[row]),
            'lbs_rows_differing': int(lbs.sum()),
            'smooth_sign_rows_differing': int(kink.sum())}


def phase_train_reference_sp(seed: int):
    """A small sp-stage model trained on the card (kernels #1/#2) and on
    the CPU (plain versions), two steps from each pair of
    ``SP_REFERENCE_STEPS``, each pair from the same fresh start (its
    smooth-loss KNN all zeros until a rebuild): 13,000-13,001 on the zero
    KNN, across sp_fix into sp (densify after 13,000, opacity reset after
    13,001); 20,000-20,001 after the rebuild before 20,000, across the
    canonical replacement, the joint tree, the superpoint prune / split
    (every eighth superpoint dead and a split threshold of 0, so that it
    splits) and densify / prune. Compared as train_reference compares, with
    ``alive``, ``sp_alive``, ``joint_parents`` and the events equal; the
    ``sp_W`` gradient's bar is 3e-4 of its max plus the float32 rounding of
    its smooth-loss term measured on each side against float64 in the same
    step (``smooth_rounding``): on the zero KNN row 0 sums every live
    Gaussian's terms, in another order on the card's atomics than on the
    CPU."""
    cfg, rcfg, train = synthetic_fullscale()
    cfg = cfg._replace(gauss=cfg.gauss._replace(capacity=4096),
                       num_superpoints=64, num_frames=6,
                       net=cfg.net._replace(depth=4, width=64),
                       sk_net=cfg.sk_net._replace(width=64, depth=4,
                                                  skips=(2,)),
                       sp_split_threshold=0.0)
    if cfg.LBS_method != 'W':
        raise AssertionError('smooth_rounding reads LBS_method W')
    rcfg = rcfg._replace(image_width=96, image_height=80,
                         pair_capacity=2 ** 16)
    flat = random_model_flat(cfg, seed + 1, n_alive=3000,
                             log_scale_mean=-3.0, sp_stage=True)
    flat['sp_alive'][::8] = False
    report = {'phase': 'train_reference_sp', 'image': [80, 96]}
    failed = []
    for pair, steps in SP_REFERENCE_STEPS.items():
        runs = {}
        for dev in ('cuda', 'cpu'):
            scene, meta, _ = make_synthetic_scene(
                seed=seed, num_links=3, gauss_per_link=60, num_frames=6,
                h=80, w=96, pair_capacity=2 ** 15, device=dev)
            model = convert.model_from_flat(flat, cfg, rcfg, device=dev,
                                            trainable=True)
            tr = SKGSTrainer(cfg, rcfg, scene, meta, model,
                             LossWeights(train.loss), seed=seed,
                             sp_initialized=True, reinit_done=True,
                             device=dev)
            rounding = []

            def spy(d, t, step, _tr=tr, _fn=tr.sp_losses, _out=rounding,
                    **kw):
                d.aux['knn_w'].retain_grad()     # dL/dw, after the backward
                _out.append((smooth_rounding(_tr, d, step), d.aux['knn_w'],
                             d.aux['knn_i'].cpu(), _tr.gs_knn_index.cpu(),
                             _tr.model.alive.cpu()))
                return _fn(d, t, step, **kw)
            tr.sp_losses = spy
            losses, grads, events, zero = [], [], [], []
            for step in steps:
                losses.append(float(tr.train_step(step)['loss']))
                grads.append({k: p.grad.detach().cpu().clone()
                              for k, p in model.leaves().items()})
                events.append({k: int(v) for k, v in tr.last_event.items()})
                zero.append(not bool(tr.gs_knn_index.any()))
            runs[dev] = (losses, grads, convert.model_to_flat(model),
                         tr.lr_trees(steps[-1]), events, rounding, zero,
                         torch.sort(tr.gs_knn_index.cpu(), -1).values)
        (l_c, g_c, f_c, lrs, ev_c, s_c, z_c, k_c), \
            (l_p, g_p, f_p, _, ev_p, s_p, z_p, k_p) = runs['cuda'], runs['cpu']
        r_c, r_p = [x[0] for x in s_c], [x[0] for x in s_p]
        where = [sp_w_diagnosis(a, b, gc['sp_W'], gp['sp_W'])
                 for a, b, gc, gp in zip(s_c, s_p, g_c, g_p)]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_c, l_p))
        live = torch.from_numpy(f_p['alive'])
        knn_differ = int(((k_c != k_p).any(-1) & live).sum())
        sp_w_max = [float(g['sp_W'].abs().max()) for g in g_p]
        sp_w_tol = [3e-4 + (a + b) / m for a, b, m in zip(r_c, r_p, sp_w_max)]
        worst, ok = [], True
        for a, b, tol_w in zip(g_c, g_p, sp_w_tol):
            try:
                worst.append(close_leaves(a, b, 3e-4, tol_of={'sp_W': tol_w}))
            except AssertionError as e:
                worst.append(str(e))
                ok = False
        param_worst, worst_leaf = params_over_tol(f_c, f_p, g_p, lrs, 2)
        same = {k: bool(np.array_equal(f_c[k], f_p[k]))
                for k in ('alive', 'sp_alive', 'joint_parents', 'joint_root')}
        others = [max((v for k, v in w.items() if k != 'sp_W'), default=0.0)
                  if isinstance(w, dict) else None for w in worst]
        report[pair] = {
            'steps': list(steps), 'zero_knn': z_c,
            'knn_live_rows_differing': knn_differ,
            'loss_cuda': l_c, 'loss_cpu': l_p, 'loss_rel_err': loss_err,
            'events_cuda': ev_c, 'events_cpu': ev_p, 'equal': same,
            'sp_W_err_over_max': [w['sp_W'] if isinstance(w, dict) else w
                                  for w in worst],
            'sp_W_smooth_rounding_cuda_over_max': [
                a / m for a, m in zip(r_c, sp_w_max)],
            'sp_W_smooth_rounding_cpu_over_max': [
                a / m for a, m in zip(r_p, sp_w_max)],
            'sp_W_tolerance': sp_w_tol, 'sp_W_where': where,
            'other_leaves_worst_err_over_max': others, 'tolerance': 3e-4,
            'param_worst_over_tol': param_worst,
            'param_worst_leaf': worst_leaf}
        if not ok or loss_err > 2e-4 or param_worst > 1.0 \
                or not all(same.values()) or ev_c != ev_p or z_c != z_p:
            failed.append(pair)
    emit(report)
    zero, rebuilt = report['zero_knn'], report['rebuilt_knn']
    if failed or zero['zero_knn'] != [True, True] \
            or rebuilt['zero_knn'] != [False, False] \
            or 'joint_root' not in rebuilt['events_cuda'][0] \
            or not rebuilt['events_cuda'][0].get('n_split_sp'):
        raise AssertionError(f'card and CPU sp training differ: {failed}')


# ---------------------------------------------------------------- skeleton


@contextlib.contextmanager
def timed_parts(log: dict):
    """Time each part of the skeleton initialisation that runs inside the
    block (``INIT_SKELETON_PARTS`` of ``sk_gs_ops``), synchronised, into
    ``log`` by name."""
    saved = {name: getattr(sk_gs_ops, name) for name in INIT_SKELETON_PARTS}

    def timed(*args, _fn, _name, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _fn(*args, **kw)
        torch.cuda.synchronize()
        log[_name] = (time.perf_counter() - t0) * 1e3
        return out
    for name, fn in saved.items():
        setattr(sk_gs_ops, name, functools.partial(timed, _fn=fn, _name=name))
    try:
        yield log
    finally:
        for name, fn in saved.items():
            setattr(sk_gs_ops, name, fn)


def capture_init(trainer: SKGSTrainer, out: dict):
    """Wrap the trainer's skeleton initialisation: its synchronised host
    time and the loops' losses go to ``out``."""
    fn = trainer._init_skeleton

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out['ms'] = (time.perf_counter() - t0) * 1e3
        out['losses'] = {k: v.cpu() for k, v in res.items()}
        return res
    trainer._init_skeleton = run


def non_finite_skeleton(model) -> int:
    """Non-finite entries of ``joints``, ``global_tr`` and the skeleton net."""
    leaves = [model.params['joints'], model.params['global_tr'],
              *model.sk_deform.parameters()]
    return int(sum((~torch.isfinite(x)).sum() for x in leaves))


def phase_sk_init_event(cfg, rcfg, train, phase: str = 'sk_init_event'):
    """The skeleton initialisation at full width on the flagship's shape
    (``sk_init`` empty): phase_sp_train's random sp-stage model trains the
    last sp step (40,000), then step 40,001 runs the initialisation before
    it, min(``joint_init_steps``, 2,000) iterations in each loop (the
    flagship's 2,000, or the default run's cut ``SK_EVENT_CUT``), then
    steps 40,002-40,005;
    all five steps through kernels #1/#2. Reports the event's synchronised
    host time by part (the sp cache and the LBS freeze, the joint loop, the
    joint tree, the distillation) and per loop iteration, the loops' first
    and last losses, the root, the non-finite count (0) and peak memory."""
    trainer = sp_stage_trainer(cfg, rcfg, train)
    s0 = cfg.stages['sk'][0]
    n = min(cfg.joint_init_steps, INIT_SKELETON_MAX_STEPS)
    run_sp_steps(trainer, (s0,), [], phase)
    init, parts = {}, {}
    capture_init(trainer, init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    with timed_parts(parts):
        records = run_sp_steps(trainer, range(s0 + 1, s0 + 1 + SK_AFTER_INIT),
                               [], phase)
    launches = {k.name: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    model = trainer.model
    bad = non_finite_skeleton(model)
    jl, dl = init['losses']['joint_loss'], init['losses']['distill_loss']
    emit({'phase': phase, 'step': s0 + 1, 'iterations': n,
          'event_ms': init['ms'], 'parts_ms': parts,
          'ms_per_iteration': {
              'joint': parts['optimize_joint_pos'] / n,
              'distill': parts['distill_sk_deform'] / n},
          'step_ms_with_event': records[0]['ms'],
          'step_ms_after': [r['ms'] for r in records[1:]],
          'joint_loss_first_last': [float(jl[0]), float(jl[-1])],
          'distill_loss_first_last': [float(dl[0]), float(dl[-1])],
          'joint_root': int(model.joint_root),
          'n_live_joints': int(model.sp_alive.sum()),
          'non_finite': bad, 'launches': launches,
          'max_memory_allocated': peak})
    expected = {k.name: SK_AFTER_INIT if k in (tile_blend_fwd, tile_blend_bwd)
                else 0 for k in KERNELS}
    if bad or launches != expected or not trainer.skeleton_initialized \
            or not all(r['stage'] == 'sk' for r in records) \
            or jl.shape[0] != n or dl.shape[0] != n \
            or not (torch.isfinite(jl).all() and torch.isfinite(dl).all()):
        raise AssertionError(f'{phase}: non-finite {bad}, launches '
                             f'{launches} (expected {expected})')
    return trainer


def phase_profile_sk_init(trainer: SKGSTrainer):
    """Where an iteration of the skeleton initialisation's loops goes: each
    loop run again on ``trainer``'s model (after its initialisation) for
    ``N_PROFILED_ITERS`` iterations, 3 first unprofiled (their host-clock
    time a loop iteration) and then under torch.profiler: device time an
    iteration, the busy share against the unprofiled iteration, the top
    kernels."""
    cfg, model = trainer.cfg, trainer.model
    gen = torch.Generator().manual_seed(SEED)
    tids = torch.randint(0, model.sp_cache.shape[0], (N_PROFILED_ITERS,),
                         generator=gen).to(model.device)
    out = {}
    for name, loop in (('joint', sk_gs_ops.optimize_joint_pos),
                       ('distill', sk_gs_ops.distill_sk_deform)):
        loop(cfg, model, tids[:3])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop(cfg, model, tids)
        torch.cuda.synchronize()
        iter_ms = (time.perf_counter() - t0) * 1e3 / N_PROFILED_ITERS
        on_dev, wall = profile_window(lambda: loop(cfg, model, tids))
        dev = sum(dev_us(e) for e in on_dev) * 1e-3 / N_PROFILED_ITERS
        out[name] = {'iteration_ms': iter_ms,
                     'iteration_ms_profiled': wall * 1e3 / N_PROFILED_ITERS,
                     'device_ms_per_iteration': dev,
                     'device_busy_share': dev / iter_ms,
                     'launches_per_iteration': sum(e.count for e in on_dev)
                     / N_PROFILED_ITERS,
                     'top_device_kernels': top_kernels(
                         on_dev, N_PROFILED_ITERS, 'iteration', k=8)}
    emit({'phase': 'profile_sk_init', 'iterations': N_PROFILED_ITERS, **out})


def sk_init_cfg(cfg):
    """``cfg`` with the sk stages of ``configs/synthetic_smoke.yaml``: 10
    ``sk_init`` steps and ``joint_init_steps`` 50."""
    sched = tuple((k, SK_INIT_SMOKE['sk_init'] if k == 'sk_init' else v)
                  for k, v in cfg.train_schedule)
    return cfg._replace(train_schedule=sched,
                        joint_init_steps=SK_INIT_SMOKE['joint_init_steps'])


def phase_sk_init_train(cfg, rcfg, train):
    """The ``sk_init`` family at full width: phase_sp_train's random
    sp-stage model on the flagship schedule with the sk stages of
    synthetic_smoke (``sk_init_cfg``); the last sp step, then with the
    launch counts at 0 the first ``N_SK_INIT_STEPS`` sk_init steps, the
    skeleton initialisation (50 + 50 iterations) before the first. Kernel
    #1 launches once a step and #2 never: the image losses are detached."""
    cfg = sk_init_cfg(cfg)
    trainer = sp_stage_trainer(cfg, rcfg, train)
    s0 = cfg.stages['sk_init'][0]
    run_sp_steps(trainer, (s0,), [], 'sk_init_train')
    init = {}
    capture_init(trainer, init)
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    records = run_sp_steps(trainer, range(s0 + 1, s0 + 1 + N_SK_INIT_STEPS),
                           [], 'sk_init_train')
    launches = {k.name: k.launches for k in KERNELS}
    cmp = {k: [r[k] for r in records] for k in ('cmp_t', 'cmp_r', 'cmp_s')}
    ms = [r['ms'] for r in records]
    emit({'phase': 'sk_init_train', 'steps': len(records),
          'first_step': s0 + 1, 'launches': launches,
          'event_ms': init['ms'], 'step_ms_with_event': ms[0],
          'step_ms_after': ms[1:], 'cmp': cmp,
          'non_finite': non_finite_skeleton(trainer.model),
          'max_memory_allocated': torch.cuda.max_memory_allocated()})
    expected = {k.name: len(records) if k is tile_blend_fwd else 0
                for k in KERNELS}
    if launches != expected \
            or not all(r['stage'] == 'sk_init' for r in records) \
            or not all(math.isfinite(v) for vs in cmp.values() for v in vs):
        raise AssertionError(f'sk_init_train: launches {launches} (expected '
                             f'{expected}), cmp {cmp}')
    return launches


@contextlib.contextmanager
def no_host_sync():
    """Raise at any operation that synchronises the host with the card
    inside the block (``torch.cuda.set_sync_debug_mode``)."""
    torch.cuda.set_sync_debug_mode('error')
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode('default')


def phase_train_reference_sk_init(seed: int, iters: int = SK_REF_ITERS,
                                  phase: str = 'train_reference_sk_init',
                                  check: bool = True):
    """The skeleton initialisation, then an ``sk_init`` and an ``sk`` step,
    of a small model on the card (kernels #1/#2) and on the CPU (plain
    versions): train_reference_sp's model (every eighth superpoint dead),
    its warp net's translation and rotation heads scaled by
    ``SK_REF_MOTION``, on a schedule with one ``sk_init`` step and
    ``joint_init_steps`` ``iters``; both trainers draw the loops' frames
    from their CPU generator of one seed. On the card the two loops run
    with the host sync check on (``no_host_sync``). The event: ``sp_knn``,
    ``p2sp``, ``joint_parents`` and ``joint_root`` equal; ``sp_cache``,
    ``sp_weights`` and ``joint_cost`` within 1e-5 of their max; the Adam
    leaves (``joint_pos`` over the joint loop, the distilled leaves over
    both loops, since ``joints`` start from ``joint_pos``) by
    ``params_over_tol`` with the CPU's gradients of each iteration. Then
    the two steps, both devices from the CPU's state after the event, as
    train_reference holds them: losses 2e-4, gradients 3e-4 of each leaf's
    max. ``check`` False reports without holding (``--profile`` runs the
    loops longer than the parameter rule covers)."""
    cfg, rcfg, train = synthetic_fullscale()
    sched = tuple((k, 1 if k == 'sk_init' else v)
                  for k, v in cfg.train_schedule)
    cfg = cfg._replace(gauss=cfg.gauss._replace(capacity=4096),
                       num_superpoints=64, num_frames=6,
                       net=cfg.net._replace(depth=4, width=64),
                       sk_net=cfg.sk_net._replace(width=64, depth=4,
                                                  skips=(2,)),
                       train_schedule=sched, joint_init_steps=iters)
    rcfg = rcfg._replace(image_width=96, image_height=80,
                         pair_capacity=2 ** 16)
    flat = random_model_flat(cfg, seed + 1, n_alive=3000,
                             log_scale_mean=-3.0, sp_stage=True)
    flat['sp_alive'][::8] = False
    for head in ('warp', 'rotation'):
        flat[f'params/sp_deform/{head}/w'] *= SK_REF_MOTION
    s0 = cfg.stages['sk_init'][0] + 1
    scenes = {dev: make_synthetic_scene(
        seed=seed, num_links=3, gauss_per_link=60, num_frames=6, h=80, w=96,
        pair_capacity=2 ** 15, device=dev)[:2] for dev in ('cuda', 'cpu')}

    def trainer(dev, model_flat, **flags):
        model = convert.model_from_flat(model_flat, cfg, rcfg, device=dev,
                                        trainable=True)
        return SKGSTrainer(cfg, rcfg, *scenes[dev], model,
                           LossWeights(train.loss), seed=seed,
                           sp_initialized=True, reinit_done=True,
                           device=dev, **flags)

    events = {}
    for dev in ('cuda', 'cpu'):
        tr = trainer(dev, flat)
        init, loop_grads = {}, []
        capture_init(tr, init)
        update = optim.adam_update
        saved = {k: getattr(sk_gs_ops, k)
                 for k in ('optimize_joint_pos', 'distill_sk_deform')}

        def spy(grads, *args, _out=loop_grads, **kw):
            _out.append({k: g.detach().cpu().clone()
                         for k, g in grads.items() if g is not None})
            return update(grads, *args, **kw)

        def checked(*args, _fn, **kw):
            with no_host_sync():
                return _fn(*args, **kw)
        if dev == 'cpu':
            optim.adam_update = spy
        else:
            for k, fn in saved.items():
                setattr(sk_gs_ops, k, functools.partial(checked, _fn=fn))
        try:
            tr.maybe_stage_events(s0)
        finally:
            optim.adam_update = update
            for k, fn in saved.items():
                setattr(sk_gs_ops, k, fn)
        events[dev] = (init, loop_grads, convert.model_to_flat(tr.model))
    (init_c, _, f_c), (init_p, loop_p, f_p) = events['cuda'], events['cpu']
    joint_g = [{'joint_pos': g['jp']} for g in loop_p[:iters]]
    distill_g = loop_p[iters:]
    equal = {k: bool(np.array_equal(f_c[k], f_p[k]))
             for k in ('sp_knn', 'p2sp', 'joint_parents', 'joint_root')}
    close = {k: float(np.abs(f_c[k] - f_p[k]).max()
                      / max(np.abs(f_p[k]).max(), 1e-30))
             for k in ('sp_cache', 'sp_weights', 'joint_cost')}
    lr = sk_gs_ops.INIT_LR
    joint_worst = params_over_tol(f_c, f_p, joint_g, {'joint_pos': lr}, iters)
    distill_worst = params_over_tol(f_c, f_p, distill_g,
                                    {k: lr for k in distill_g[0]}, 2 * iters)

    runs = {}
    for dev in ('cuda', 'cpu'):
        tr = trainer(dev, f_p, skeleton_initialized=True)
        losses, grads = [], []
        for step in (s0, s0 + 1):
            losses.append(float(tr.train_step(step)['loss']))
            grads.append({k: p.grad.detach().cpu().clone()
                          for k, p in tr.model.leaves().items()})
        runs[dev] = (losses, grads)
    (l_c, g_c), (l_p, g_p) = runs['cuda'], runs['cpu']
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_c, l_p))
    grad_worst = [max(close_leaves(a, b, 3e-4).values()) if check
                  else max(close_leaves(a, b, math.inf).values())
                  for a, b in zip(g_c, g_p)]
    emit({'phase': phase, 'image': [80, 96], 'iterations': iters,
          'steps': [s0, s0 + 1],
          'stages': [cfg.stage_at(s0), cfg.stage_at(s0 + 1)],
          'loops_checked_for_host_syncs_on_the_card': True, 'equal': equal,
          'err_over_max': close, 'tolerance': 1e-5,
          'joint_root': int(f_c['joint_root']),
          'distilled_leaves': len(distill_g[0]),
          'param_worst_over_tol_joint_pos': joint_worst[0],
          'param_worst_over_tol_distill': distill_worst[0],
          'param_worst_leaf_distill': distill_worst[1],
          'event_ms_cuda': init_c['ms'], 'event_ms_cpu': init_p['ms'],
          'distill_loss_last': [float(init_c['losses']['distill_loss'][-1]),
                                float(init_p['losses']['distill_loss'][-1])],
          'steps_from': 'the CPU state after the event',
          'loss_cuda': l_c, 'loss_cpu': l_p, 'loss_rel_err': loss_err,
          'grad_worst_err_over_max': grad_worst})
    if check and (not all(equal.values()) or max(close.values()) > 1e-5
                  or joint_worst[0] > 1.0 or distill_worst[0] > 1.0
                  or loss_err > 2e-4 or len(loop_p) != 2 * iters):
        raise AssertionError('card and CPU skeleton initialisation differ')


def phase_profile_train_sp(trainer: SKGSTrainer, s0: int):
    """Where an sp step's time goes: phase_profile_train's split and
    window, and beside it the step's own pieces timed alone on the same
    state by CUDA events (the LBS weights, the sp_stage pass, the smooth
    loss forward and backward, on the rebuilt KNN and on the all-zero one
    that the steps before the first rebuild take, the joint costs, the
    cache and joint-cost writes), and the smooth loss's backward alone
    under torch.profiler on both, whose scatter (the sum over the
    [N, 20, K] gather) is named on its own line."""
    phase_profile_train(trainer, s0, phase='profile_train_sp')
    cfg, model = trainer.cfg, trainer.model
    params = model.params
    idx = first_view(trainer, s0 + 9)
    t = trainer.scene.times[idx]
    tid = trainer.scene.time_ids[idx]
    with torch.no_grad():
        d = forward_deltas(cfg, model, t, 'sp')
    smooth_fwd_bwd = smooth_loss_case(trainer, s0 + 9)
    knn = trainer.gs_knn_index
    zero = torch.zeros_like(knn)

    def joint_fwd_bwd():
        jp = params['joint_pos'].detach().clone().requires_grad_(True)
        cost = joint_cost_matrix(jp, d.aux['spT'], model.sp_alive)
        torch.where(torch.isfinite(cost), cost, 0.0).mean().backward()

    def writes():
        model.sp_cache[tid] = d.aux['cache_row']
        model.joint_cost.mul_(0.9).add_(0.1 * model.joint_cost)

    with torch.no_grad():
        pieces = {
            'lbs_weights': lambda: lbs_weights(cfg, params, model.sp_alive,
                                               params['xyz']),
            'sp_stage': lambda: forward_deltas(cfg, model, t, 'sp'),
            'cache_joint_cost_writes': writes}
        piece_ms = {k: cuda_ms(fn, iters=5, warmup=1)
                    for k, fn in pieces.items()}
    piece_ms['smooth_fwd_bwd'] = cuda_ms(lambda: smooth_fwd_bwd(knn),
                                         iters=5, warmup=1)
    piece_ms['smooth_fwd_bwd_zero_knn'] = cuda_ms(
        lambda: smooth_fwd_bwd(zero), iters=5, warmup=1)
    piece_ms['joint_cost_fwd_bwd'] = cuda_ms(joint_fwd_bwd, iters=5,
                                             warmup=1)
    smooth = {}
    for name, index in (('rebuilt_knn', knn), ('zero_knn', zero)):
        on_dev, _ = profile_window(
            lambda: [smooth_fwd_bwd(index) for _ in range(3)])
        smooth[name] = {
            'kernels': top_kernels(on_dev, 3, 'call', k=6),
            'backward_scatter': top_kernels(
                [e for e in on_dev if is_scatter(e.key)], 3, 'call')}
    emit({'phase': 'profile_train_sp_pieces', 'step_state': s0 + 9,
          'ms': piece_ms, 'smooth_loss': smooth})


def is_scatter(key: str) -> bool:
    """PyTorch's CUDA kernels of an advanced-index backward (the
    accumulating index_put / scatter of a gather's gradient), by name."""
    k = key.lower()
    return any(s in k for s in ('index_put', 'indexing_backward', 'scatter',
                                'index_add', 'indexfunc'))


def phase_profile_train(trainer: SKGSTrainer, s0: int,
                        phase: str = 'profile_train'):
    """Where a training step's time goes: forward (deltas to loss),
    backward, and Adam + statistics by CUDA events over 3 steps; then 3
    whole steps timed unprofiled (synchronised, host clock) and the next 3
    under torch.profiler. The busy share is the window's device time a step
    over that unprofiled step time of the same trainer."""
    splits = {'forward': [], 'backward': [], 'adam_stats': []}
    for step in range(s0, s0 + 3):
        stage = trainer.cfg.stage_at(step)
        trainer.loss_w.set_step(step)
        idx = first_view(trainer, step)
        lrs = trainer.lr_trees(step)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        m2d_off = trainer.zero_grads()
        fwd = trainer._losses(stage, idx, m2d_off)
        total = sum(fwd[0].values())
        ev[1].record()
        total.backward()
        ev[2].record()
        trainer._update(FAMILY[stage], lrs, [trainer._view_record(
            FAMILY[stage], idx, total, *fwd)], m2d_off)
        ev[3].record()
        torch.cuda.synchronize()
        for key, a, b in (('forward', 0, 1), ('backward', 1, 2),
                          ('adam_stats', 2, 3)):
            splits[key].append(ev[a].elapsed_time(ev[b]))
    split_ms = {k: sum(v) / len(v) for k, v in splits.items()}

    n_win = 3
    timed = []
    for step in range(s0 + 3, s0 + 3 + n_win):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(step)
        torch.cuda.synchronize()
        timed.append((time.perf_counter() - t0) * 1e3)
    step_ms = sum(timed) / n_win
    w0 = s0 + 3 + n_win
    metrics = []
    on_dev, wall = profile_window(
        lambda: [metrics.append(trainer.train_step(w0 + k))
                 for k in range(n_win)])
    busy_ms = sum(dev_us(e) for e in on_dev) * 1e-3
    per_step = busy_ms / n_win
    emit({'phase': phase, 'split_ms': split_ms, 'split_steps': [s0, s0 + 2],
          'timed_steps': [s0 + 3, w0 - 1], 'timed_ms': timed,
          'window_steps': [w0, w0 + n_win - 1],
          'window_pairs': [int(m['num_pairs']) for m in metrics],
          'n_alive': int(trainer.model.alive.sum()),
          'window_wall_ms_profiled': wall * 1e3,
          'device_ms_per_step': per_step, 'step_ms': step_ms,
          'device_busy_share': per_step / step_ms,
          'top_device_kernels': top_kernels(on_dev, n_win, 'step'),
          'index_add_kernels': top_kernels(
              [e for e in on_dev if is_index_add(e.key)], n_win, 'step'),
          'blend_kernels': top_kernels(
              [e for e in on_dev if '_blend_' in e.key], n_win, 'step')})


def dev_us(e) -> float:
    return getattr(e, 'self_device_time_total', 0.0)


def device_ms(kernel, fn, launches: int = 20) -> float:
    """``kernel``'s mean device time a launch, by torch.profiler, over the
    launches it records of ``launches`` calls of ``fn`` (each launching it
    once; the profiler may miss a few), after 3 unprofiled calls. Host time
    between launches does not count, as it does in CUDA events around a
    wrapper that takes longer on the host than the kernel on the card."""
    for _ in range(3 if launches > 1 else 0):
        fn()
    # the profiler has returned a window without the kernel's events once
    # (its launch count moved): up to three windows are tried
    for _ in range(PROFILER_TRIES):
        on_dev, _ = profile_window(lambda: [fn() for _ in range(launches)])
        found = [e for e in on_dev if kernel.name + '_kernel<' in e.key]
        if len(found) == 1 and found[0].count >= 1:
            return dev_us(found[0]) * 1e-3 / found[0].count
    raise AssertionError(f'the profiler saw {kernel.name} as '
                         f'{[(e.key, e.count) for e in found]} in '
                         f'{PROFILER_TRIES} windows')


def profile_window(fn):
    """Device-side events (kernels, copies, sets) of ``fn`` under
    torch.profiler, by device time, and the window's wall time. The
    CPU-side op rows carry the same device time again and are left out."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_dev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    on_dev.sort(key=dev_us, reverse=True)
    return on_dev, wall


def is_index_add(key: str) -> bool:
    """PyTorch's CUDA index_add_ kernels (indexFuncSmallIndex /
    indexFuncLargeIndex), by name."""
    return 'indexfunc' in key.lower() or 'index_add' in key.lower()


def top_kernels(on_dev, n, unit: str, k: int = 12):
    return [{'kernel': e.key[:120], f'device_ms_per_{unit}':
             dev_us(e) * 1e-3 / n, f'launches_per_{unit}': e.count / n}
            for e in on_dev[:k]]


def phase_profile(model, views, times, bg, served_ms):
    """Where a request's time goes: stages by CUDA events, then device
    kernels by torch.profiler over a window of whole requests; the busy
    share is their device time over the unprofiled request time
    ``served_ms``."""
    cfg, rcfg, view = model.cfg, model.rcfg, views[0]
    t = torch.tensor(times[0], device=model.device)
    with torch.no_grad():
        d = forward_deltas(cfg, model, t, 'sk')
        g = gaussian_inputs(model.gauss_view(), cfg.gauss, d.d_xyz,
                            d.d_rotation, d.d_scaling)
        pre = preprocess(g, view, rcfg, model.active_sh_degree)
        inp = prepare_blend(g, view, rcfg, model.active_sh_degree)
        tile_color, tile_alpha = blend_tiles(inp.binned, inp.geo, inp.col,
                                             rcfg)

        def assemble_composite():
            img = assemble_image(tile_color, tile_alpha, rcfg)
            return composite_background(img['images'], img['opacity'], bg)

        stages = {
            'forward_deltas': lambda: forward_deltas(cfg, model, t, 'sk'),
            'gaussian_inputs': lambda: gaussian_inputs(
                model.gauss_view(), cfg.gauss, d.d_xyz, d.d_rotation,
                d.d_scaling),
            'preprocess': lambda: preprocess(g, view, rcfg,
                                             model.active_sh_degree),
            'build_tile_lists': lambda: build_tile_lists(pre, rcfg),
            'prepare_blend': lambda: prepare_blend(g, view, rcfg,
                                                   model.active_sh_degree),
            'blend_tiles': lambda: blend_tiles(inp.binned, inp.geo, inp.col,
                                               rcfg),
            'assemble_composite': assemble_composite,
            'render_eval': lambda: render_eval(model, view, times[0], bg),
        }
        stage_ms = {k: cuda_ms(fn, iters=5, warmup=1)
                    for k, fn in stages.items()}

    n_win = 3
    on_dev, wall = profile_window(
        lambda: [render_eval(model, v, tt, bg)
                 for v, tt in zip(views[:n_win], times[:n_win])])
    busy_ms = sum(dev_us(e) for e in on_dev) * 1e-3
    per_req = busy_ms / n_win
    emit({'phase': 'profile', 'stage_ms': stage_ms,
          'window_requests': n_win, 'window_wall_ms_profiled': wall * 1e3,
          'device_ms_per_request': per_req,
          'served_ms_per_request': served_ms,
          'device_busy_share': per_req / served_ms,
          'top_device_kernels': top_kernels(on_dev, n_win, 'request')})


# ---------------------------------------------------------------- the CLIs

def cli_run(fn, argv):
    """``fn(argv)`` with the launch counts set to 0 just before and read
    just after; returns (its result, the launches, the seconds)."""
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out = fn(argv)
    torch.cuda.synchronize()
    return out, {k.name: k.launches for k in KERNELS}, \
        time.perf_counter() - t0


def files_under(root: Path) -> dict:
    """Every file under ``root`` with its size in bytes."""
    return {str(p.relative_to(root)): p.stat().st_size
            for p in sorted(root.rglob('*')) if p.is_file()}


def check_results(res: dict, keys, phase: str):
    """``res`` has exactly ``keys``; every number is finite, the LPIPS
    columns null beside their uncalibrated values (no calibrated weights
    in the repo), as the JAX package writes them."""
    if set(res) != set(keys):
        raise AssertionError(f'{phase}: results keys {sorted(res)} != '
                             f'{sorted(keys)}')
    for k, v in res.items():
        if k in ('LPIPS (alex)', 'LPIPS (vgg)'):
            ok = v is None
        elif isinstance(v, float):
            ok = math.isfinite(v)
        else:
            ok = True
        if not ok:
            raise AssertionError(f'{phase}: {k} = {v}')


def ms_by_stage(out_dir: Path) -> dict:
    """Mean of metrics.jsonl's windowed ms a step, by the stage of each
    logged step."""
    by = {}
    for line in (out_dir / 'metrics.jsonl').read_text().splitlines():
        rec = json.loads(line)
        by.setdefault(rec['stage'], []).append(rec['ms_per_step'])
    return {k: sum(v) / len(v) for k, v in by.items()}


def phase_cli_train_smoke(tmp: Path):
    """``cli.train`` on configs/synthetic_smoke.yaml, the whole 180-step
    schedule on the card: #1 once a training step and once a render of
    the ground truth and of each evaluation, #2 once a step but the
    ``sk_init`` steps'."""
    cfg = make_config(CLI_SMOKE)
    res, launches, secs = cli_run(cli_train.main, [
        '-c', CLI_SMOKE, '--device', 'cuda', '--set', f'output_dir={tmp}',
        f'dataset.root={tmp}'])
    out = tmp / cfg['exp_name']
    sched = cfg['train_schedule']
    steps = sum(sched.values())
    views = cfg['dataset']['num_frames']
    evals = steps // cfg['train']['eval_interval'] + (
        steps % cfg['train']['eval_interval'] > 0) + 1
    expected = {tile_blend_fwd.name: steps + views * (1 + evals),
                tile_blend_bwd.name: steps - sched['sk_init'],
                chunk_blend_fwd.name: 0, chunk_blend_bwd.name: 0}
    files = files_under(out)
    emit({'phase': 'cli_train_smoke', 'seconds': secs, 'steps': steps,
          'ms_per_step_by_stage': ms_by_stage(out), 'launches': launches,
          'expected_launches': expected, 'results': res, 'files': files})
    check_results(json.loads((out / 'results.json').read_text()),
                  CLI_TRAIN_KEYS, 'cli_train_smoke')
    want = {'checkpoints/' + n for n in (
        'checkpoint_00000100.npz', 'init.npz', 'sk_init.npz', 'best.npz',
        'last.npz')} | {'config.yaml', 'metrics.jsonl', 'last.ply',
                        'results.json'}
    if not want <= set(files) or launches != expected:
        raise AssertionError(f'cli_train_smoke: files {sorted(files)}, '
                             f'launches {launches} != {expected}')
    return launches


def sk_checkpoint(tmp: Path, cfg, rcfg) -> Path:
    """The random full-width model (``CLI_N_ALIVE`` alive) with its ``sk_cache``
    filled at the train frames as ``sk`` training writes it, saved through
    the port's checkpoint at step ``CLI_SK_STEP`` with the skeleton
    initialised."""
    flat = random_model_flat(cfg, SEED, n_alive=CLI_N_ALIVE)
    model = convert.model_from_flat(flat, cfg, rcfg, device='cuda')
    with torch.no_grad():
        for tid in range(cfg.num_frames):
            d = forward_deltas(cfg, model, model.train_times[tid], 'sk',
                               time_id=tid, training=True)
            model.sk_cache[tid] = d.aux['cache_row']
    state = {'model/' + k: v for k, v in convert.model_to_flat(model).items()}
    state['flags/skeleton_initialized'] = np.asarray(True)
    return CheckpointManager(tmp).save(state, CLI_SK_STEP, force=True,
                                       name='sk_random.npz')


def interp_agreement(ckpt: Path, cfg, rcfg) -> dict:
    """At each train time, the served deltas and renders through the net
    and through the interpolated ``sk_cache``: the deltas' max abs
    difference, and the renders' max abs difference, the share of pixel
    channels apart by more than ``CLI_INTERP_TOL`` and their least PSNR
    against each other. The cache holds the normalised quaternion, which
    the read path normalises again (a last-bit change), so the deltas
    differ at rounding level and the depth sort may order a near-tie of
    two splats the other way."""
    model = convert.model_from_flat(load_ckpt(ckpt), cfg, rcfg, device='cuda')
    bg = torch.ones(3, device='cuda')
    out = {'deltas_max_abs': 0.0, 'render_max_abs': 0.0,
           'render_share_over_tol': 0.0, 'render_psnr_min': math.inf}
    for tid in range(cfg.num_frames):
        view = orbit_view(2.0 * math.pi * tid / cfg.num_frames,
                          rcfg.image_width, rcfg.image_height, device='cuda')
        t = model.train_times[tid]
        deltas, imgs = [], []
        for interp in (False, True):
            model.cfg = cfg._replace(test_time_interpolate=interp)
            with torch.no_grad():
                d = forward_deltas(model.cfg, model, t, 'sk')
            deltas.append(torch.cat([d.d_xyz, d.d_rotation, d.d_scaling], 1))
            imgs.append(render_eval(model, view, t, bg)['image'])
        diff = (imgs[0] - imgs[1]).abs()
        mse = float(torch.mean(diff ** 2))
        out['deltas_max_abs'] = max(out['deltas_max_abs'], float(
            (deltas[0] - deltas[1]).abs().max()))
        out['render_max_abs'] = max(out['render_max_abs'], float(diff.max()))
        out['render_share_over_tol'] = max(
            out['render_share_over_tol'],
            float((diff > CLI_INTERP_TOL).float().mean()))
        out['render_psnr_min'] = min(out['render_psnr_min'], math.inf
                                     if mse == 0 else -10 * math.log10(mse))
    return out


def phase_cli_test_fullscale(tmp: Path, sweep: bool):
    """``cli.test`` on configs/synthetic_fullscale.yaml (48 views, 400 px,
    LPIPS alex and vgg) with the random ``sk`` checkpoint, without and with
    ``test_time_interpolate``; the first run also sweeps FPS when
    ``sweep``. At the train times the two routes render alike."""
    cfg, rcfg, _ = synthetic_fullscale()
    ckpt = sk_checkpoint(tmp, cfg, rcfg)
    runs, launches = {}, {}
    # the first run renders the ground truth and caches it under
    # dataset.root; the second reads the cache
    for interp in (False, True):
        argv = ['-c', CLI_FULLSCALE, '--load', str(ckpt), '--device', 'cuda',
                '--out', str(tmp / f'test_{interp}.json'), '--set',
                f'dataset.root={tmp}',
                f'model.test_time_interpolate={str(interp).lower()}']
        if sweep and not interp:
            argv.append('--fps-sweep')
        res, launches[interp], secs = cli_run(cli_test.main, argv)
        res['seconds'] = secs
        runs[str(interp).lower()] = res
    agree = interp_agreement(ckpt, cfg, rcfg)
    views = cfg.num_frames
    # the ground truth (first run), the warm-up and the timed evaluation
    # (and the sweep's 1,000 renders and their warm-up)
    expected = {interp: {
        tile_blend_fwd.name: (2 if interp else 3) * views + (
            cli_test.N_SWEEP + cli_test.SWEEP_WARMUP
            if sweep and not interp else 0),
        tile_blend_bwd.name: 0, chunk_blend_fwd.name: 0,
        chunk_blend_bwd.name: 0} for interp in (False, True)}
    emit({'phase': 'cli_test_fullscale', 'runs': runs,
          'launches': {str(k).lower(): v for k, v in launches.items()},
          'interp_vs_net_at_train_times': agree,
          'tolerance': {'deltas': CLI_INTERP_TOL,
                        'render_psnr_min': CLI_INTERP_PSNR}})
    for res in runs.values():
        check_results({k: v for k, v in res.items() if k != 'seconds'},
                      CLI_TEST_KEYS | ({'FPS_sweep'} if 'FPS_sweep' in res
                                       else set()), 'cli_test_fullscale')
        if (res['stage'], res['step'], res['n_alive']) != (
                'sk', CLI_SK_STEP, CLI_N_ALIVE):
            raise AssertionError(f'cli_test_fullscale: {res}')
    if agree['deltas_max_abs'] > CLI_INTERP_TOL \
            or agree['render_psnr_min'] < CLI_INTERP_PSNR \
            or launches != expected:
        raise AssertionError(f'cli_test_fullscale: interpolation {agree}, '
                             f'launches {launches} != {expected}')
    return ckpt, launches[False]


def phase_cli_repose_fullscale(tmp: Path, ckpt: Path):
    """``cli.render_repose`` of the random ``sk`` checkpoint: orbit, time
    sweep and two pose keyframes, ``CLI_REPOSE_FRAMES`` frames at 400 px,
    each a PNG that decodes; #1 once a frame (the ground truth comes from
    cli_test_fullscale's cache). A zero pose delta renders as no delta."""
    cfg, rcfg, _ = synthetic_fullscale()
    rng = np.random.default_rng(SEED)
    poses = tmp / 'poses.json'
    poses.write_text(json.dumps([
        {'joint_deltas': np.zeros((cfg.num_superpoints, 3)).tolist()},
        {'joint_deltas': (0.3 * rng.normal(size=(cfg.num_superpoints, 3)))
         .tolist()}]))
    res, launches, secs = cli_run(cli_repose.main, [
        '-c', CLI_FULLSCALE, '--load', str(ckpt), '--device', 'cuda',
        '--orbit', '--time-sweep', '--pose-json', str(poses),
        '--num-frames', str(CLI_REPOSE_FRAMES), '--out', str(tmp / 'frames'),
        '--set', f'dataset.root={tmp}'])
    shapes = {tuple(read_png(p).shape) for p in res['paths']}
    model = convert.model_from_flat(load_ckpt(ckpt), cfg, rcfg,
                                    device='cuda')
    view = orbit_view(0.3, rcfg.image_width, rcfg.image_height,
                      device='cuda')
    t = torch.tensor(0.4, device='cuda')
    with torch.no_grad():
        zero = cli_repose.render_frame(
            model, view, t, torch.zeros(cfg.num_superpoints, 3,
                                        device='cuda'))
        plain = render_eval(model, view, t, torch.ones(3, device='cuda'),
                            'sk')['image']
    zero_err = float((zero - plain).abs().max())
    expected = {tile_blend_fwd.name: CLI_REPOSE_FRAMES,
                tile_blend_bwd.name: 0, chunk_blend_fwd.name: 0,
                chunk_blend_bwd.name: 0}
    ms = [1e3 * x for x in res['seconds']]
    emit({'phase': 'cli_repose_fullscale', 'seconds': secs,
          'frames': len(res['paths']), 'ms_per_frame': ms,
          'ms_per_frame_mean_after_first': sum(ms[1:]) / max(len(ms) - 1, 1),
          'png_shapes': sorted(shapes), 'zero_delta_max_abs': zero_err,
          'launches': launches, 'expected_launches': expected})
    if shapes != {(rcfg.image_height, rcfg.image_width, 3)} \
            or len(res['paths']) != CLI_REPOSE_FRAMES or zero_err > 0 \
            or launches != expected:
        raise AssertionError(f'cli_repose_fullscale: shapes {shapes}, '
                             f'zero delta {zero_err}, launches {launches}')
    return launches


def phase_cli_train_fullscale(tmp: Path):
    """``cli.train`` on configs/synthetic_fullscale.yaml for its first
    ``CLI_FULLSCALE_STEPS`` steps (init_fix: 2,000 points in 100,352 slots,
    48 frames at 400 px), then the full-metric evaluation over the 48
    views."""
    torch.cuda.reset_peak_memory_stats()
    cfg = make_config(CLI_FULLSCALE)
    res, launches, secs = cli_run(cli_train.main, [
        '-c', CLI_FULLSCALE, '--device', 'cuda', '--steps',
        str(CLI_FULLSCALE_STEPS), '--set', f'output_dir={tmp}',
        f'dataset.root={tmp}'])
    out = tmp / cfg['exp_name']
    files = files_under(out)
    emit({'phase': 'cli_train_fullscale', 'seconds': secs,
          'steps': CLI_FULLSCALE_STEPS,
          'ms_per_step_by_stage': ms_by_stage(out), 'results': res,
          'launches': launches, 'files': files,
          'max_memory_allocated': torch.cuda.max_memory_allocated()})
    check_results(res, CLI_TRAIN_KEYS, 'cli_train_fullscale')
    if 'checkpoints/last.npz' not in files or \
            launches[tile_blend_bwd.name] != CLI_FULLSCALE_STEPS:
        raise AssertionError(f'cli_train_fullscale: files {sorted(files)}, '
                             f'launches {launches}')
    return launches


# ---------------------------------------------------------------- real data

def render_rgba(gt, frame: int, Tv2w: np.ndarray, fovx: float,
                hw: int) -> torch.Tensor:
    """uint8 [hw, hw, 4] on the card: the chain at ``frame`` seen from the
    camera-to-world ``Tv2w`` (OpenCV axes), unpremultiplied RGBA as the
    synthetic scene gives it for a background composited per step."""
    view = ViewParams(
        Tw2v=torch.from_numpy(np.linalg.inv(Tv2w).astype(np.float32)).cuda(),
        Tv2c=perspective_opencv(fovx, size=(hw, hw), n=0.5, f=20.0,
                                device='cuda'),
        campos=torch.from_numpy(Tv2w[:3, 3].astype(np.float32)).cuda(),
        tan_fovx=torch.tensor(math.tan(fovx / 2), device='cuda'),
        tan_fovy=torch.tensor(math.tan(fovx / 2), device='cuda'))
    cfg = RasterConfig(image_width=hw, image_height=hw, sh_degree=0,
                       pair_capacity=2 ** 17)
    with torch.no_grad():
        out = render(gt_frame_gaussians(gt, frame, 'cuda'), view, cfg)
    if bool(out['overflow']):
        raise AssertionError(f'frame {frame}: ground truth overflowed')
    a = out['opacity']
    rgb = out['images'] / torch.clamp(a, 1e-6, 1.0)[..., None]
    return (torch.clamp(torch.cat([rgb, a[..., None]], -1), 0, 1) * 255) \
        .to(torch.uint8)


def write_pngs(paths, frames) -> float:
    """Write the uint8 frames (on the card) as PNGs, several at once;
    returns the seconds."""
    t0 = time.perf_counter()
    host = [f.cpu().numpy() for f in frames]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write_png, paths, host))
    return time.perf_counter() - t0


def gl_camera(Tv2w_cv: np.ndarray) -> np.ndarray:
    """An OpenCV camera-to-world matrix in OpenGL axes (y up, looking
    down -z), as D-NeRF and WIM store them."""
    return Tv2w_cv @ np.diag([1.0, -1.0, -1.0, 1.0])


def write_dnerf(root: Path, train) -> dict:
    """A D-NeRF-layout scene at DNERF_HW px: the preset's chain over
    sum(DNERF_VIEWS) times, one orbit camera a time (the monocular
    protocol), every DNERF_VAL_EVERY-th view in the val split; returns
    what was written."""
    ds = train.dataset
    n = sum(DNERF_VIEWS)
    gt = make_chain_gt(np.random.default_rng(train.seed), ds.num_links,
                       ds.gauss_per_link, n)
    Tv2w, fovx = orbit_views(n, h=DNERF_HW, w=DNERF_HW)
    frames = [render_rgba(gt, i, Tv2w[i], fovx, DNERF_HW) for i in range(n)]
    split = {'train': [], 'val': []}
    for i in range(n):
        split['val' if i % DNERF_VAL_EVERY == 0 else 'train'].append(i)
    paths = []
    for name, ids in split.items():
        (root / name).mkdir(parents=True)
        (root / f'transforms_{name}.json').write_text(json.dumps({
            'camera_angle_x': fovx,
            'frames': [{'file_path': f'./{name}/r_{k:03d}',
                        'transform_matrix': gl_camera(Tv2w[i]).tolist(),
                        'time': i / (n - 1)} for k, i in enumerate(ids)]}))
        paths += [root / name / f'r_{k:03d}.png' for k in range(len(ids))]
    order = split['train'] + split['val']
    write_s = write_pngs(paths, [frames[i] for i in order])
    return {'frames': frames, 'split': split, 'Tv2w': Tv2w, 'fovx': fovx,
            'paths': paths, 'write_s': write_s}


def write_wim(root: Path, train) -> dict:
    """A WIM-layout scene: WIM_CAMERAS cameras on an orbit, each a
    ``cam_XXX.json`` (its OpenGL camera-to-world matrix transposed, pinhole
    intrinsics, WIM_HW px), and the chain at WIM_FRAMES times seen by every
    camera."""
    ds = train.dataset
    gt = make_chain_gt(np.random.default_rng(train.seed), ds.num_links,
                       ds.gauss_per_link, WIM_FRAMES)
    Tv2w, fovx = orbit_views(WIM_CAMERAS, h=WIM_HW, w=WIM_HW)
    focal = WIM_HW / 2 / math.tan(fovx / 2)
    root.mkdir(parents=True)
    for c in range(WIM_CAMERAS):
        (root / f'cam_{c:03d}.json').write_text(json.dumps({'camera_data': {
            'cam2world': gl_camera(Tv2w[c]).T.tolist(), 'width': WIM_HW,
            'height': WIM_HW, 'intrinsics': {'cx': WIM_HW / 2,
                                             'cy': WIM_HW / 2, 'fx': focal,
                                             'fy': focal}}}))
    frames, paths = [], []
    for f in range(WIM_FRAMES):
        for c in range(WIM_CAMERAS):
            frames.append(render_rgba(gt, f, Tv2w[c], fovx, WIM_HW))
            paths.append(root / f'frame_{f:05d}_cam_{c:03d}.png')
    return {'write_s': write_pngs(paths, frames), 'paths': paths}


@contextlib.contextmanager
def timed_loads(name: str):
    """``framework.build``'s loader ``name`` timed: each split's seconds
    (decode, resize and the copy to the card), views, image shape and MB
    on the card, and the scene itself, in the yielded list."""
    orig = getattr(build, name)
    log = []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene, meta = orig(*args, **kw)
        torch.cuda.synchronize()
        log.append({'split': args[2], 'seconds': time.perf_counter() - t0,
                    'views': scene.num_views,
                    'image': list(scene.images.shape[1:]),
                    'mb_on_device': sum(x.numel() * x.element_size()
                                        for x in scene) / 2 ** 20,
                    'scene': scene, 'meta': meta})
        return scene, meta

    setattr(build, name, timed)
    try:
        yield log
    finally:
        setattr(build, name, orig)


def expected_launches(steps: int, eval_views: int) -> dict:
    """#2 once a step, #1 once a step and once a view of each of the two
    evaluations (the one at the last step and the full-metric one)."""
    return {tile_blend_fwd.name: steps + 2 * eval_views,
            tile_blend_bwd.name: steps, chunk_blend_fwd.name: 0,
            chunk_blend_bwd.name: 0}


def train_cli_on(phase: str, config: str, sets, steps: int, loader: str,
                 tmp: Path):
    """``cli.train`` of ``config`` for ``steps`` steps with the launch
    counts at 0, its loads timed; returns (what was measured, the
    launches, the loads)."""
    torch.cuda.reset_peak_memory_stats()
    with timed_loads(loader) as loads:
        res, launches, secs = cli_run(cli_train.main, [
            '-c', config, '--device', 'cuda', '--steps', str(steps),
            '--set', f'output_dir={tmp}', *sets])
    out = tmp / make_config(config)['exp_name']
    check_results(json.loads((out / 'results.json').read_text()),
                  CLI_TRAIN_KEYS, phase)
    logged = [json.loads(line) for line in
              (out / 'metrics.jsonl').read_text().splitlines()]
    rec = {'phase': phase, 'config': config, 'steps': steps,
           'seconds': secs,
           'load': [{k: v for k, v in x.items()
                     if k not in ('scene', 'meta')} for x in loads],
           'ms_per_step_by_stage': ms_by_stage(out),
           'loss_last': logged[-1]['loss'], 'results': res, 'launches': launches,
           'max_memory_allocated': torch.cuda.max_memory_allocated()}
    if not math.isfinite(logged[-1]['loss']):
        raise AssertionError(f'{phase}: loss {logged[-1]["loss"]}')
    return rec, launches, loads


def config_trainer(cfg: dict, scene, meta) -> SKGSTrainer:
    """The trainer ``cli.train`` builds for ``cfg`` on ``scene``."""
    skcfg, rcfg = build.build_model_cfg(cfg, meta, scene.image_size)
    opts = build.trainer_options(cfg)
    pts, cols = build.initial_point_cloud(cfg)
    base = init_from_pcd(pts, cols, skcfg.gauss, device='cuda')
    model = init_model(skcfg, rcfg, base, meta.train_times,
                       seed=opts['seed'], device='cuda')
    return SKGSTrainer(skcfg, rcfg, scene, meta, model,
                       loss_weights=LossWeights(cfg.get('loss', {})),
                       sampler=build.build_sampler(cfg, scene, skcfg),
                       pcd=(pts, cols), device='cuda', **opts)


def phase_kernels_800(trainer: SKGSTrainer, step: int) -> dict:
    """Kernels #1 and #2 on the inputs and cotangents of training step
    ``step`` of an 800-px scene, against their plain versions: error and
    device time by torch.profiler."""
    rcfg = trainer.rcfg
    inp, color, alpha, g_color, g_alpha = step_blend_inputs(trainer, step)
    args = (*schedule_kernels(inp, rcfg)[2], rcfg)
    bwd_args = (*args[:-1], color, alpha, g_color, g_alpha, rcfg)
    with torch.no_grad():
        c, a = tile_blend_fwd.launch(*args)
        pc, pa = tile_blend_fwd.plain(*args)
        fwd_err = max(float((c - pc).abs().max()), float((a - pa).abs().max()))
        rows = tile_blend_bwd.launch(*bwd_args)
        prows = tile_blend_bwd.plain(*bwd_args)
        bwd_err = max(float((rows[:, sl] - prows[:, sl]).abs().max())
                      / max(float(prows[:, sl].abs().max()), 1e-30)
                      for sl in GROUPS.values())
        fwd_ms = device_ms(tile_blend_fwd, lambda: tile_blend_fwd.launch(*args))
        bwd_ms = device_ms(tile_blend_bwd,
                           lambda: tile_blend_bwd.launch(*bwd_args))
    counts = inp.binned.tile_count[inp.binned.tile_count > 0].float()
    rec = {'phase': 'kernels_800', 'step': step,
           'stage': trainer.cfg.stage_at(step),
           'image': [rcfg.image_height, rcfg.image_width],
           'tiles': rcfg.num_tiles, 'pairs': int(inp.binned.num_pairs),
           'pair_capacity': rcfg.pair_capacity,
           'tile_list_longest': int(counts.max()),
           'tile_list_mean': float(counts.mean()),
           'fwd': {'ms': fwd_ms, 'max_abs_err': fwd_err,
                   'tolerance': KERNEL_TOL},
           'bwd': {'ms': bwd_ms, 'err_over_max': bwd_err,
                   'tolerance': BWD_TOL}}
    emit(rec)
    if fwd_err > KERNEL_TOL or bwd_err > BWD_TOL:
        raise AssertionError(f'kernels_800: {rec}')
    return rec


def phase_cli_train_dnerf(tmp: Path, train) -> dict:
    """``cli.train`` on configs/d_nerf.yaml over a D-NeRF-layout scene
    written here at 800 px (DNERF_VIEWS train and val views), DNERF_STEPS
    steps and the evaluation on the val split; the loaded images and
    cameras against what was written; then #1 and #2 on its first step."""
    written = write_dnerf(tmp / 'dnerf' / 'chain', train)
    frame = written['paths'][0]
    reads = []
    for _ in range(3):
        t0 = time.perf_counter()
        read_png(frame)
        reads.append(time.perf_counter() - t0)
    sets = [f'dataset.root={tmp / "dnerf"}', 'dataset.scene=chain']
    rec, launches, loads = train_cli_on(
        'cli_train_dnerf', CLI_DNERF, sets, DNERF_STEPS, 'load_dnerf',
        tmp / 'out')
    train_load = next(x for x in loads if x['split'] == 'train')
    train_scene = train_load['scene']
    ids = written['split']['train']
    rgba = torch.stack([written['frames'][i] for i in ids]).float() / 255.0
    want = rgba[..., :3] * rgba[..., 3:] + 1.0 * (1.0 - rgba[..., 3:])
    img_err = float((train_scene.images - want).abs().max())
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    want_w2v = np.linalg.inv(np.stack([gl_camera(written['Tv2w'][i]) @ flip
                                       for i in ids]))
    cam_err = float(np.abs(train_scene.Tw2v.cpu().numpy() - want_w2v).max())
    expected = expected_launches(DNERF_STEPS, DNERF_VIEWS[1])
    kernels = phase_kernels_800(config_trainer(
        make_config(CLI_DNERF, sets), train_scene, train_load['meta']), 1)
    rec.update({'image_written': [DNERF_HW, DNERF_HW, 4],
                'png_write_s': written['write_s'],
                'read_png_800_rgba_s': reads,
                'image_max_abs_err': img_err, 'image_tolerance': 1e-6,
                'Tw2v_max_abs_err': cam_err, 'Tw2v_tolerance': 1e-5,
                'expected_launches': expected})
    emit(rec)
    if img_err > 1e-6 or cam_err > 1e-5 or launches != expected:
        raise AssertionError(f'cli_train_dnerf: images {img_err}, cameras '
                             f'{cam_err}, launches {launches} != {expected}')
    rec['kernels_800'] = kernels
    return rec


def phase_cli_train_dnerf_random(tmp: Path, white_ms: dict) -> dict:
    """The same files through configs/d_nerf_400.yaml (downscale 2) with a
    'random' background, DNERF_RANDOM_STEPS steps, RGBA on the card; then
    DYNAMIC_STEPS trainer steps with each other dynamic background on the
    first DYNAMIC_VIEWS train views loaded with it."""
    root = tmp / 'dnerf'
    sets = [f'dataset.root={root}', 'dataset.scene=chain',
            'dataset.background=random']
    rec, launches, loads = train_cli_on(
        'cli_train_dnerf_random', CLI_DNERF_400, sets, DNERF_RANDOM_STEPS,
        'load_dnerf', tmp / 'out_random')
    channels = {x['split']: x['image'][-1] for x in loads}
    expected = expected_launches(DNERF_RANDOM_STEPS, DNERF_VIEWS[1])
    cfg = make_config(CLI_DNERF_400, sets)
    dynamic = {}
    for kind in ('random2', 'reference', 'checker'):
        scene, meta = build.load_dnerf(str(root), 'chain', 'train',
                                       downscale=2, background=kind,
                                       num_frames_max=DYNAMIC_VIEWS,
                                       device='cuda')
        trainer = config_trainer(cfg, scene, meta)
        torch.cuda.synchronize()
        for k in KERNELS:
            k.launches = 0
        steps = []
        for step in range(1, DYNAMIC_STEPS + 1):
            t0 = time.perf_counter()
            loss = float(trainer.train_step(step)['loss'])
            steps.append({'loss': loss,
                          'ms': 1e3 * (time.perf_counter() - t0)})
        dynamic[kind] = {'steps': steps, 'image': list(scene.images.shape),
                         'launches': {k.name: k.launches for k in KERNELS}}
    rec.update({'channels_on_device': channels,
                'ms_per_step_white_800': white_ms,
                'expected_launches': expected, 'dynamic': dynamic})
    emit(rec)
    want_dyn = {tile_blend_fwd.name: DYNAMIC_STEPS,
                tile_blend_bwd.name: DYNAMIC_STEPS, chunk_blend_fwd.name: 0,
                chunk_blend_bwd.name: 0}
    bad = [k for k, v in dynamic.items()
           if v['launches'] != want_dyn or v['image'][-1] != 4
           or not all(math.isfinite(s['loss']) for s in v['steps'])]
    if launches != expected or set(channels.values()) != {4} or bad:
        raise AssertionError(f'cli_train_dnerf_random: launches {launches} '
                             f'!= {expected}, channels {channels}, {bad}')
    return {'cli': launches, 'dynamic': {
        name: sum(v['launches'][name] for v in dynamic.values())
        for name in want_dyn}}


def phase_cli_train_wim(tmp: Path, train) -> dict:
    """``cli.train`` on configs/wim_512.yaml (downscale 1.5625, 800 -> 512
    px) over a WIM-layout scene written here, frames [0, WIM_FRAMES):
    WIM_STEPS steps and the test split's evaluation; the views' frame and
    camera ids as written."""
    written = write_wim(tmp / 'wim' / 'chain', train)
    sets = [f'dataset.root={tmp / "wim"}', 'dataset.scene=chain',
            f'dataset.frame_ranges=[0,{WIM_FRAMES}]']
    rec, launches, loads = train_cli_on(
        'cli_train_wim', CLI_WIM, sets, WIM_STEPS, 'load_wim', tmp / 'out')
    ids_ok = True
    for x in loads:
        n_cams = WIM_CAMERAS - 2 if x['split'] == 'train' else 2
        s = x['scene']
        ids_ok &= bool(torch.equal(
            s.time_ids.cpu(), torch.arange(WIM_FRAMES).repeat_interleave(
                n_cams))) and bool(torch.equal(
                    s.camera_ids.cpu(), torch.arange(n_cams).repeat(
                        WIM_FRAMES)))
    expected = expected_launches(WIM_STEPS, 2 * WIM_FRAMES)
    rec.update({'cameras': WIM_CAMERAS, 'frames': WIM_FRAMES,
                'png_write_s': written['write_s'], 'ids_as_written': ids_ok,
                'expected_launches': expected})
    emit(rec)
    if not ids_ok or launches != expected or len(loads) != 2:
        raise AssertionError(f'cli_train_wim: ids {ids_ok}, launches '
                             f'{launches} != {expected}')
    return launches


# ---------------------------------------------------------------- JPEG

# ITU-T T.81 Annex K: the example quantisation tables (natural order) and
# the typical Huffman tables (code counts by length 1-16, symbols), which
# libjpeg writes by default
JPEG_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
              14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
              18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
              92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112,
              100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
             + [99] * 32))
JPEG_HUFF = {  # (class, table): (counts, symbols); class 0 DC, 1 AC
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), range(12)),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), range(12)),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), bytes.fromhex(
        '01020300041105122131410613516107227114328191a1082342b1c11552d1f0'
        '2433627282090a161718191a25262728292a3435363738393a43444546474849'
        '4a535455565758595a636465666768696a737475767778797a83848586878889'
        '8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5'
        'c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8'
        'f9fa')),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119), bytes.fromhex(
        '000102031104052131061241510761711322328108144291a1b1c109233352f0'
        '156272d10a162434e125f11718191a262728292a35363738393a434445464748'
        '494a535455565758595a636465666768696a737475767778797a828384858687'
        '88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3'
        'c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8'
        'f9fa')),
}
JPEG_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])  # zigzag position -> natural position
# the orthonormal 8-point DCT-II: JPEG's FDCT is D x D^T
_U, _X = np.mgrid[0:8, 0:8]
JPEG_DCT = np.where(_U == 0, np.sqrt(1 / 8), np.sqrt(2 / 8)) \
    * np.cos((2 * _X + 1) * _U * np.pi / 16)


def jpeg_quant_tables(quality: int):
    """libjpeg's jpeg_quality_scaling of the Annex K tables, 1..255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [np.clip((q * scale + 50) // 100, 1, 255) for q in JPEG_QUANT]


def _huff_codes(counts, symbols):
    """(code [256], length [256]) of each symbol of a canonical table."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, i, symbols = 0, 0, list(symbols)
    for n_bits, count in enumerate(counts, start=1):
        for _ in range(count):
            code[symbols[i]], length[symbols[i]] = c, n_bits
            c, i = c + 1, i + 1
        c <<= 1
    return code, length


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, 'big') + body


def _block_planes(img: np.ndarray, sampling, mcu_w: int, mcu_h: int):
    """Each component's samples [mcu_h 8 v, mcu_w 8 h] (the image padded
    by edge replication to whole MCUs, chroma averaged over its boxes)."""
    h_img, w_img = img.shape[:2]
    if img.ndim == 2:
        planes = [img.astype(np.float64)]
    else:
        r, g, b = (img[..., i].astype(np.float64) for i in range(3))
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    full_h, full_w = mcu_h * 8 * max_v, mcu_w * 8 * max_h
    out = []
    for plane, (h, v) in zip(planes, sampling):
        plane = np.clip(np.round(plane), 0, 255)
        plane = np.pad(plane, ((0, full_h - h_img), (0, full_w - w_img)),
                       mode='edge')
        fy, fx = max_v // v, max_h // h
        plane = plane.reshape(full_h // fy, fy, full_w // fx, fx) \
            .mean(axis=(1, 3))
        out.append(np.round(plane) - 128.0)
    return out


def _bits_of(values: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The bytes of the codes ``values`` of ``lengths`` bits, MSB first,
    packed back to back and padded with 1 bits, 0xFF stuffed."""
    starts = np.cumsum(lengths) - lengths
    item = np.repeat(np.arange(len(values)), lengths)
    j = np.arange(int(lengths.sum())) - starts[item]
    bits = ((values[item] >> (lengths[item] - 1 - j)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.uint8)])
    data = np.packbits(bits)
    return np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0)


def _entropy(coefs: np.ndarray, comp: np.ndarray, tables) -> np.ndarray:
    """Huffman-coded bytes of the blocks ``coefs`` [B, 64] (zigzag order,
    in scan order) of components ``comp`` [B], every code and length at
    once: each block's DC difference, its AC run/size symbols (ZRL for
    each 16 zeros of a run) and an EOB unless its last coefficient is
    non-zero."""
    n_blocks = len(coefs)
    dc = coefs[:, 0]
    diff = np.empty_like(dc)
    for c in np.unique(comp):
        sel = np.nonzero(comp == c)[0]
        diff[sel] = np.diff(dc[sel], prepend=0)
    b_ac, k_ac = np.nonzero(coefs[:, 1:])
    k_ac = k_ac + 1
    first = np.ones(len(b_ac), bool)
    first[1:] = b_ac[1:] != b_ac[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k_ac[:-1]]))
    run = k_ac - prev - 1
    val = coefs[b_ac, k_ac]
    last = np.zeros(n_blocks, np.int64)
    ends = np.ones(len(b_ac), bool)   # each block's last non-zero AC
    ends[:-1] = b_ac[1:] != b_ac[:-1]
    last[b_ac[ends]] = k_ac[ends]
    eob = np.nonzero(last < 63)[0]
    n_zrl = run // 16
    zrl = np.repeat(np.arange(len(b_ac)), n_zrl)

    def size_extra(v):
        size = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
        extra = np.where(v > 0, v, v + (1 << size) - 1) & ((1 << size) - 1)
        return size, extra

    dc_size, dc_extra = size_extra(diff)
    ac_size, ac_extra = size_extra(val)
    blocks = np.concatenate([np.arange(n_blocks), b_ac[zrl], b_ac, eob])
    order = np.concatenate([np.zeros(n_blocks, np.int64), 2 * k_ac[zrl] - 1,
                            2 * k_ac, np.full(len(eob), 200)])
    symbol = np.concatenate([dc_size, np.full(len(zrl), 0xF0),
                             ((run % 16) << 4) | ac_size,
                             np.zeros(len(eob), np.int64)])
    extra = np.concatenate([dc_extra, np.zeros(len(zrl), np.int64),
                            ac_extra, np.zeros(len(eob), np.int64)])
    extra_len = np.concatenate([dc_size, np.zeros(len(zrl), np.int64),
                                ac_size, np.zeros(len(eob), np.int64)])
    is_ac = np.concatenate([np.zeros(n_blocks, bool),
                            np.ones(len(zrl) + len(b_ac) + len(eob), bool)])
    comps = comp[blocks]
    code = np.zeros(len(blocks), np.int64)
    code_len = np.zeros(len(blocks), np.int64)
    for c in np.unique(comp):
        for cls in (0, 1):
            sel = (comps == c) & (is_ac == bool(cls))
            codes, lens = tables[cls][min(int(c), 1)]
            code[sel], code_len[sel] = codes[symbol[sel]], lens[symbol[sel]]
    idx = np.lexsort((order, blocks))
    return _bits_of((code[idx] << extra_len[idx]) | extra[idx],
                    code_len[idx] + extra_len[idx])


def encode_jpeg(img: np.ndarray, quality: int = 90,
                sampling=((2, 2), (1, 1), (1, 1)), restart_interval: int = 0,
                interleaved: bool = True) -> bytes:
    """A baseline JPEG file (JFIF, Annex K tables) of ``img`` [H, W, 3]
    uint8 RGB (YCbCr, components sampled at ``sampling``, (h, v) each) or
    [H, W] greyscale; ``restart_interval`` MCUs between RSTn markers (0:
    none); ``interleaved`` False writes one scan per component. The
    port's chip run writes frames with it (the card's machine has no
    encoder)."""
    h_img, w_img = img.shape[:2]
    if img.ndim == 2:
        sampling = ((1, 1),)
    n_comp = len(sampling)
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    mcu_w = -(-w_img // (8 * max_h))
    mcu_h = -(-h_img // (8 * max_v))
    quant = jpeg_quant_tables(quality)
    tables = [[_huff_codes(*JPEG_HUFF[(cls, t)]) for t in (0, 1)]
              for cls in (0, 1)]
    coefs = []
    for c, plane in enumerate(_block_planes(img, sampling, mcu_w, mcu_h)):
        by, bx = plane.shape[0] // 8, plane.shape[1] // 8
        blocks = plane.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)
        f = JPEG_DCT @ blocks @ JPEG_DCT.T
        q = quant[min(c, 1)].reshape(8, 8)
        zz = np.round(f / q).astype(np.int64).reshape(by, bx, 64)
        coefs.append(zz[..., JPEG_ZIGZAG])
    head = b'\xff\xd8' + _segment(0xE0, b'JFIF\x00\x01\x01\x00\x00\x01'
                                  b'\x00\x01\x00\x00')
    for t in range(min(n_comp, 2)):
        head += _segment(0xDB, bytes([t]) + bytes(
            quant[t][JPEG_ZIGZAG].astype(np.uint8)))
    head += _segment(0xC0, bytes([8]) + h_img.to_bytes(2, 'big')
                     + w_img.to_bytes(2, 'big') + bytes([n_comp]) + b''.join(
                         bytes([c + 1, (h << 4) | v, min(c, 1)])
                         for c, (h, v) in enumerate(sampling)))
    for (cls, t), (counts, symbols) in JPEG_HUFF.items():
        if t < min(n_comp, 2):
            head += _segment(0xC4, bytes([(cls << 4) | t, *counts,
                                          *symbols]))
    if restart_interval:
        head += _segment(0xDD, restart_interval.to_bytes(2, 'big'))
    scans = [list(range(n_comp))] if interleaved and n_comp > 1 else \
        [[c] for c in range(n_comp)]
    out = [head]
    for scan in scans:
        if len(scan) == 1:  # its own blocks only, in raster order
            c = scan[0]
            h, v = sampling[c]
            wib = -(-(-(-w_img * h // max_h)) // 8)
            hib = -(-(-(-h_img * v // max_v)) // 8)
            units = [coefs[c][:hib, :wib].reshape(-1, 1, 64)]
            comp_of = np.array([c])
        else:  # each MCU's blocks, component by component, row-major
            units = [coefs[c].reshape(mcu_h, v, mcu_w, h, 64)
                     .transpose(0, 2, 1, 3, 4).reshape(mcu_h * mcu_w, h * v,
                                                        64)
                     for c, (h, v) in enumerate(sampling)]
            comp_of = np.concatenate([np.full(h * v, c) for c, (h, v)
                                      in enumerate(sampling)])
        mcus = np.concatenate(units, axis=1)            # [n_mcu, per, 64]
        out.append(_segment(0xDA, bytes([len(scan)]) + b''.join(
            bytes([c + 1, (min(c, 1) << 4) | min(c, 1)]) for c in scan)
            + b'\x00\x3f\x00'))
        step = restart_interval or len(mcus)
        for i, s0 in enumerate(range(0, len(mcus), step)):
            if i:
                out.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
            part = mcus[s0:s0 + step]
            out.append(_entropy(part.reshape(-1, 64),
                                np.tile(comp_of, len(part)), tables)
                       .tobytes())
    out.append(b'\xff\xd9')
    return b''.join(out)


# ---------------------------------------------------------------- options


class HandedDraws:
    """The trainers' random draws (the regularizers' uniforms, the time
    noise) from one numpy generator: the k-th draw of a kind is the same
    on every device it is handed to, as ``handed_backgrounds`` does for
    the backgrounds."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.draws = {}

    def attach(self, trainer: SKGSTrainer):
        counts = {}

        def take(kind, make):
            k = counts[kind] = counts.get(kind, -1) + 1
            made = self.draws.setdefault(kind, [])
            while len(made) <= k:
                made.append(make())
            return torch.from_numpy(made[k]).to(trainer.device)

        trainer.draw_uniform = lambda n: take(('uniform', n), lambda: (
            self.rng.uniform(size=n).astype(np.float32)))
        trainer.draw_time_noise = lambda: take('normal', lambda: np.asarray(
            self.rng.normal(), np.float32))


def small_start(seed: int, family: str, dev: str, cfg, rcfg, train,
                warp_head: float = None):
    """A small model of ``family`` on ``dev`` and its trainer flags:
    train_reference's random sk model, train_reference_init's flagship
    start, train_reference_sp's random sp-stage model (every eighth
    superpoint dead); the init and sp families' ``sp_deform`` net with
    its position (and rotation) heads drawn at ``warp_head``
    (``OPTION_WARP_HEAD`` by default), so that the warp, its time noise and
    the motion regularizers move something (the ``canonical`` net keeps
    its fresh heads)."""
    heads = torch.Generator().manual_seed(seed)
    warp_head = OPTION_WARP_HEAD if warp_head is None else warp_head
    if family == 'init':
        pts, cols = flagship_point_cloud(train)
        base = init_from_pcd(pts, cols, cfg.gauss, device=dev)
        times = np.linspace(0.0, 1.0, cfg.num_frames).astype(np.float32)
        model = init_model(cfg, rcfg, base, times, seed=seed, device=dev)
        with torch.no_grad():
            model.sp_deform.warp.w.copy_(warp_head * torch.randn(
                model.sp_deform.warp.w.shape, generator=heads))
        return model, {}
    flat = random_model_flat(cfg, seed + 1, n_alive=3000,
                             log_scale_mean=-3.0, sp_stage=family == 'sp')
    if family == 'sp':
        flat['sp_alive'][::8] = False
        for head in ('warp', 'rotation'):
            key = f'params/sp_deform/{head}/w'
            flat[key] = (warp_head * torch.randn(
                flat[key].shape, generator=heads)).numpy()
        flags = {'sp_initialized': True, 'reinit_done': True}
    else:
        flags = {'skeleton_initialized': True}
    return convert.model_from_flat(flat, cfg, rcfg, device=dev,
                                   trainable=True), flags


# the spread of the small models' warp heads: a fresh net's 1e-5 moves the
# Gaussians by ~1e-5 (the motion losses would be rounding), 0.05 by ~1,
# and then the rounding of the warped points, which the canonical net
# reads through its 2^9 frequency band, flips its ReLUs between devices;
# 2e-3 moves them by ~0.02. The init regularizers take 0.05 with the
# consistency loss off (the canonical net then trains on nothing): at
# 2e-3 the variance of an edge's length over elastic's 8 times, and
# arap's stretch, are within a few hundred float32 steps of the warped
# points' rounding
OPTION_WARP_HEAD = 2e-3
OPTION_REG_WARP_HEAD = 0.05
# the losses whose float32 rounding ``reg_net_rounding`` measures
ROUNDED_REG_LOSSES = ('elastic', 'arap')
# each option of train_reference_options: its family, steps, trainer
# options, extra loss weights and changes to the small model's config
OPTION_CASES = {
    'adamw': ('sk', None, {'optimizer': 'adamw'}, {}, {}),
    'sgd': ('sk', None, {'optimizer': 'sgd'}, {}, {}),
    'adan': ('sk', None, {'optimizer': 'adan'}, {}, {}),
    'batch_views_3': ('sk', None, {'batch_views': 3}, {}, {}),
    'init_regularizers': ('init', (100, 101), {},
                          {**INIT_REG_WEIGHTS, 'c_net': 0.0},
                          {'warp_head': OPTION_REG_WARP_HEAD,
                           'from_one_state': True,
                           'rounded_net': 'sp_deform'}),
    'sp_regularizers': ('sp', (19999, 20000), {},
                        {**SP_REG_WEIGHTS, 'smooth': 0.0},
                        {'sp_split_threshold': 0.0}),
    'not_is_blender': ('init', (100, 101), {}, {}, {'is_blender': False}),
    'bf16': ('init', (100, 101), {}, {}, {'bf16': True}),
}


@contextlib.contextmanager
def recorded(module, name: str, log: list):
    """``module.name`` recording each call's (arguments, outputs) in
    ``log``."""
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        log.append((args, out))
        return out
    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, fn)


def reg_net_rounding(trainer: SKGSTrainer, family: str, t, draws: dict,
                     step: int) -> dict:
    """The float32 rounding of the ``sp_deform`` net's gradients of the
    weighted ``ROUNDED_REG_LOSSES`` (elastic, arap) on the trainer's
    device, as ``smooth_rounding`` measures ``sp_W``'s: the losses through
    ``trainer.motion_reg_losses`` (``models/regularizers.py``) at the
    step's state and draws, on a float32 copy of the net and on a float64
    copy of it and of the state the losses read; per net leaf max |g32 -
    g64| ('rounding'; 'rounding_by_loss' of each loss alone), both
    gradients ('g32', 'g64', on the host), and
    whether the two made the same discrete choices (elastic's KNN, arap's
    neighbours and kept edges): were they to differ, the difference would
    be no rounding. 'relu_sign_flips' counts the warp net's ReLUs whose
    pre-activation the float32 rounding puts on the other side of 0 than
    float64 does (a kink: the gradient through that unit appears or
    vanishes), with the largest such |pre-activation| in float64."""
    model = trainer.model
    grads, choices, pre_acts = {}, {}, {}
    for dtype in (torch.float32, torch.float64):
        net = copy.deepcopy(model.sp_deform).to(dtype)
        twin = types.SimpleNamespace(
            params={k: model.params[k].detach().to(dtype)
                    for k in ('xyz', 'sp_hyper', 'sp_points')
                    if k in model.params},
            alive=model.alive, sp_alive=model.sp_alive, sp_deform=net)
        view = types.SimpleNamespace(
            cfg=trainer.cfg, model=twin, loss_weight=trainer.loss_weight,
            loss_w=trainer.loss_w)
        knn, graph, relu = [], [], []
        with recorded(trainer_mod, 'calc_lbs_weight', knn), \
                recorded(trainer_mod.reg, 'arap_connectivity', graph), \
                recorded(torch, 'relu', relu):
            out = SKGSTrainer.motion_reg_losses(
                view, family, t.to(dtype),
                {k: v.to(dtype) for k, v in draws.items()}, step)
        pre_acts[dtype] = [args[0].detach() for args, _ in relu]
        names = [f'sp_deform/{n.replace(".", "/")}'
                 for n, _ in net.named_parameters()]
        grads[dtype] = {}
        for part in ROUNDED_REG_LOSSES + ('sum',):
            loss = sum(out[k] for k in ROUNDED_REG_LOSSES) \
                if part == 'sum' else out[part]
            g = torch.autograd.grad(loss, list(net.parameters()),
                                    allow_unused=True, retain_graph=True)
            grads[dtype][part] = {
                n: (torch.zeros_like(p) if gi is None else gi).detach()
                .to(torch.float64).cpu()
                for n, p, gi in zip(names, net.parameters(), g)}
        choices[dtype] = [idx.cpu() for _, (_, idx) in knn] + [
            torch.cat([idx.cpu(), keep.cpu().to(idx.dtype)])
            for _, (idx, _, keep) in graph]
    same = all(torch.equal(a, b) for a, b in
               zip(choices[torch.float32], choices[torch.float64]))
    diff = {part: {k: float((g32 - grads[torch.float64][part][k]).abs()
                            .max()) for k, g32 in leaves.items()}
            for part, leaves in grads[torch.float32].items()}
    flips = [(a.to(torch.float64) > 0) != (b > 0) for a, b in
             zip(pre_acts[torch.float32], pre_acts[torch.float64])]
    at_flips = [b[f].abs() for b, f in zip(pre_acts[torch.float64], flips)
                if bool(f.any())]
    return {'rounding': diff.pop('sum'), 'rounding_by_loss': diff,
            'g32': grads[torch.float32]['sum'],
            'g64': grads[torch.float64]['sum'], 'choices_equal': same,
            'relu_sign_flips': int(sum(int(f.sum()) for f in flips)),
            'relu_flip_max_abs_preact64': max(
                (float(x.max()) for x in at_flips), default=None)}


def option_setup(seed: int, name: str):
    """(family, steps, options, extra, change, cfg, rcfg, train) of the
    option ``name`` of ``OPTION_CASES``: its small model's configs."""
    family, steps, options, extra, change = OPTION_CASES[name]
    cfg, rcfg, train = synthetic_fullscale()
    net = cfg.net._replace(depth=4, width=64)
    sk_net = cfg.sk_net._replace(width=64, depth=4, skips=(2,))
    if change.get('is_blender') is False:
        net = net._replace(is_blender=False)
    if change.get('bf16'):
        net = net._replace(compute_dtype='bfloat16')
        sk_net = sk_net._replace(compute_dtype='bfloat16')
    cfg = cfg._replace(gauss=cfg.gauss._replace(capacity=4096),
                       num_superpoints=64, num_frames=6, net=net,
                       sk_net=sk_net, **{k: v for k, v in change.items()
                                         if k in cfg._fields})
    rcfg = rcfg._replace(image_width=96, image_height=80,
                         pair_capacity=2 ** 16,
                         schedule='chunk' if family == 'init' else 'tile')
    steps = steps or (cfg.stages['sk'][0] + 1, cfg.stages['sk'][0] + 2)
    return family, steps, options, extra, change, cfg, rcfg, train


def option_reference(seed: int, name: str) -> dict:
    """One option of ``OPTION_CASES`` trained 2 steps on the card
    (kernels) and on the CPU (plain versions) from the same small model,
    both handed the same draws; compared as train_reference compares
    (bf16 at its own bar). A case with a ``rounded_net`` holds that net's
    gradients at 3e-4 of each leaf's max plus the float32 rounding of
    ``ROUNDED_REG_LOSSES`` measured on each side in the same step
    (``reg_net_rounding``), its parameters at 2 lr a step; with
    ``from_one_state`` the CPU takes the second step from the card's state
    after the first, which the first step's bar justifies: where the
    rounding parts the gradients, Adam's first steps part by up to +-lr."""
    family, steps, options, extra, change, cfg, rcfg, train = \
        option_setup(seed, name)
    bf16 = bool(change.get('bf16'))
    rounded = change.get('rounded_net')
    loss = {**train.loss, **extra}
    draws = HandedDraws(seed)
    runs, card_states = {}, []
    for dev in ('cuda', 'cpu'):
        scene, meta, _ = make_synthetic_scene(
            seed=seed, num_links=3, gauss_per_link=60, num_frames=6, h=80,
            w=96, pair_capacity=2 ** 15, device=dev)
        model, flags = small_start(seed, family, dev, cfg, rcfg, train,
                                   change.get('warp_head'))
        tr = SKGSTrainer(cfg, rcfg, scene, meta, model, LossWeights(loss),
                         seed=seed, device=dev, **flags, **options)
        draws.attach(tr)
        rounding = []
        if rounded:
            def spy(family, t, d, step, _tr=tr, _fn=tr.motion_reg_losses,
                    _out=rounding):
                _out.append(reg_net_rounding(_tr, family, t, d, step))
                return _fn(family, t, d, step)
            tr.motion_reg_losses = spy
        metrics, grads = [], []
        for i, step in enumerate(steps):
            if dev == 'cpu' and change.get('from_one_state') and i:
                # the CPU takes this step from the card's state before it
                tr.restore({'state/' + k: v for k, v in
                            card_states[i - 1].items()}, steps[i - 1])
            m = tr.train_step(step)
            if dev == 'cuda':
                card_states.append(tr.ckpt_state())
                if torch.backends.cuda.matmul.allow_tf32 \
                        or torch.backends.cudnn.allow_tf32:
                    raise AssertionError(f'{name}: TF32 is on in the step')
            metrics.append({k: float(v) for k, v in m.items()})
            grads.append({k: p.grad.detach().cpu().clone()
                          for k, p in tr.model.leaves().items()})
        runs[dev] = (metrics, grads, convert.model_to_flat(tr.model),
                     tr.lr_trees(steps[-1]), rounding)
    (m_c, g_c, f_c, lrs, r_c), (m_p, g_p, f_p, _, r_p) = \
        runs['cuda'], runs['cpu']
    loss_tol = BF16_LOSS_TOL if bf16 else 2e-4
    # bf16: every leaf at the bf16 bar, since the warped positions carry
    # the nets' rounding (a bfloat16 step of d_xyz) into every gradient,
    # its parameters' settled entries from that bar up; a rounded net's
    # leaves at 3e-4 of their max plus both sides' measured rounding, a
    # bar by step, its parameters held to the 2 lr a step bound alone
    # (no entry's gradient is good to the 1e-3 that the settled-entry
    # rule needs)
    bars = {k.split('/')[0]: BF16_GRAD_TOL for k in g_p[0]} if bf16 else {}
    tol_of = [{k: bars[k.split('/')[0]] for k in g_p[0]
               if k.split('/')[0] in bars} for _ in steps]
    iso = {'rotation': 'xyz'} if family == 'init' else {}
    if any(k in extra for k in INIT_REG_WEIGHTS):
        # the warp bias moves every warped point alike, which the motion
        # and point-ARAP losses do not see (they read differences of
        # warped points): their share of its gradient is their large
        # terms cancelling, held against the warp weight's scale
        iso['sp_deform/warp/b'] = 'sp_deform/warp/w'
    rounding_over_max = []
    if rounded:
        for i, (a, b) in enumerate(zip(r_c, r_p)):
            top = {k: float(g_p[i][iso.get(k, k)].abs().max())
                   for k in a['rounding']}
            rounding_over_max.append({
                dev: {'sum': max(r['rounding'][k] / max(top[k], 1e-30)
                                 for k in top),
                      **{part: max(v[k] / max(top[k], 1e-30) for k in top)
                         for part, v in r['rounding_by_loss'].items()},
                      'relu_sign_flips': r['relu_sign_flips'],
                      'relu_flip_max_abs_preact64':
                          r['relu_flip_max_abs_preact64']}
                for dev, r in (('cuda', a), ('cpu', b))})
            tol_of[i].update({k: 3e-4 + (a['rounding'][k]
                                         + b['rounding'][k])
                              / max(top[k], 1e-30) for k in top})
    cut_of = bars if bf16 else ({rounded: 1.0} if rounded else {})
    rel = lambda k: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                        for a, b in zip(m_c, m_p))
    loss_err = rel('loss')
    grad_worst, grads_ok = [], True
    for a, b, tol in zip(g_c, g_p, tol_of):
        try:
            worst = close_leaves(a, b, 3e-4, scale_of=iso, tol_of=tol)
            grad_worst.append(max(worst.values()))
            if rounded:
                grad_worst[-1] = {'all': grad_worst[-1], rounded: max(
                    v for k, v in worst.items()
                    if k.startswith(rounded + '/'))}
        except AssertionError as e:
            grad_worst.append(str(e))
            grads_ok = False
    choices_equal = all(r['choices_equal'] for r in r_c + r_p)
    param_worst, worst_leaf = params_over_tol(f_c, f_p, g_p, lrs, 2,
                                              scale_of=iso, cut_of=cut_of)
    same = {k: bool(np.array_equal(f_c[k], f_p[k]))
            for k in ('alive', 'sp_alive', 'joint_parents')}
    rec = {'option': name, 'family': family, 'steps': list(steps),
           'trainer_options': options, 'extra_loss_weights': extra,
           'loss_cuda': [m['loss'] for m in m_c],
           'loss_cpu': [m['loss'] for m in m_p],
           'extra_losses_cuda': [{k: m[k] for k in extra if k in m}
                                 for m in m_c],
           'extra_losses_rel_err': {k: rel(k) for k in extra
                                    if k in m_p[-1]},
           'loss_rel_err': loss_err, 'loss_tolerance': loss_tol,
           'grad_worst_err_over_max': grad_worst,
           'grad_tolerance': {'default': 3e-4, **bars},
           'grad_scale_of': iso,
           'param_worst_over_tol': param_worst,
           'param_worst_leaf': worst_leaf, 'equal': same,
           'ok': bool(grads_ok and loss_err <= loss_tol
                      and param_worst <= 1.0 and all(same.values())
                      and choices_equal)}
    if rounded:
        rec.update({'rounded_losses': list(ROUNDED_REG_LOSSES),
                    'rounding_over_max_by_step': rounding_over_max,
                    'rounded_tolerance_min_by_step': [
                        min(v for k, v in t.items()
                            if k.startswith(rounded + '/')) for t in tol_of],
                    'rounding_choices_equal': choices_equal,
                    'second_step_from_card_state':
                        bool(change.get('from_one_state'))})
    return rec


def phase_train_reference_options(seed: int):
    """Every option of ``OPTION_CASES`` (AdamW, SGD, Adan, batch_views 3,
    the init and sp regularizers, a net that is not is_blender, bf16) on
    the card against the CPU, 2 steps each."""
    failed = []
    for name in OPTION_CASES:
        rec = option_reference(seed, name)
        emit({'phase': 'train_reference_options', **rec})
        if not rec['ok']:
            failed.append(name)
    if failed:
        raise AssertionError(f'card and CPU training differ: {failed}')


def timed_step(trainer: SKGSTrainer, step: int, count: dict = None):
    """``train_step(step)`` synchronised: (its metrics as floats, ms); the
    launches it made are added to ``count``."""
    before = {k.name: k.launches for k in KERNELS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = trainer.train_step(step)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if count is not None:
        for k in KERNELS:
            count[k.name] = count.get(k.name, 0) + k.launches \
                - before[k.name]
    return {k: float(v) for k, v in m.items()}, ms


def phase_sp_extras_train(cfg, rcfg, train):
    """The sp_train start (a random sp-stage model, 80,000 alive) with the
    two ablations' weights (``SP_ABLATION_WEIGHTS``) against the same
    start without them, steps ``SP_EXTRAS_STEPS`` taken in turns (plain,
    extras; extras, plain; ...) after a warm-up step each; the launches of
    the extras' steps only, counted from 0."""
    scene, meta, _ = fullscale_scene(rcfg, train)
    flat = random_model_flat(cfg, SEED, 80_000, sp_stage=True)
    trainers = {}
    for name, extra in (('plain', {}), ('extras', SP_ABLATION_WEIGHTS)):
        model = convert.model_from_flat(flat, cfg, rcfg, device='cuda',
                                        trainable=True)
        trainers[name] = SKGSTrainer(
            cfg, rcfg, scene, meta, model, LossWeights({**train.loss,
                                                        **extra}),
            seed=train.seed, sp_initialized=True, reinit_done=True,
            device='cuda')
        trainers[name].train_step(SP_EXTRAS_STEPS[0] - 1)
    for k in KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    launches, records, peak = {}, [], {}
    for i, step in enumerate(SP_EXTRAS_STEPS):
        order = ('plain', 'extras') if i % 2 == 0 else ('extras', 'plain')
        rec = {'step': step}
        for name in order:
            torch.cuda.reset_peak_memory_stats()
            m, ms = timed_step(trainers[name], step,
                               launches if name == 'extras' else None)
            peak[name] = max(peak.get(name, 0),
                             torch.cuda.max_memory_allocated())
            rec[name + '_ms'] = ms
            if name == 'extras':
                rec['losses'] = {k: m[k] for k in ('loss',
                                                   *SP_ABLATION_WEIGHTS)}
                rec['overflow'] = bool(m['overflow'])
        rec['added_ms'] = rec['extras_ms'] - rec['plain_ms']
        records.append(rec)
    added = sorted(r['added_ms'] for r in records)
    n = len(SP_EXTRAS_STEPS)
    expected = {k.name: n if k in (tile_blend_fwd, tile_blend_bwd) else 0
                for k in KERNELS}
    emit({'phase': 'sp_extras_train', 'weights': SP_ABLATION_WEIGHTS,
          'steps': records, 'added_ms_median': added[len(added) // 2],
          'max_memory_allocated': peak, 'launches': launches,
          'expected_launches': expected})
    for r in records:
        if not all(math.isfinite(v) for v in r['losses'].values()) \
                or r['overflow']:
            raise AssertionError(f'bad sp_extras step: {r}')
    if launches != expected:
        raise AssertionError(f'sp_extras_train launches {launches} != '
                             f'{expected}')
    return launches


def flagship_trainer(cfg, rcfg, train, scene, meta, loss) -> SKGSTrainer:
    return SKGSTrainer(cfg, rcfg, scene, meta,
                       flagship_model(cfg, rcfg, train, meta.train_times),
                       LossWeights(loss), seed=train.seed,
                       clip_norm=train.clip_norm, device='cuda')


def phase_init_reg_train(cfg, rcfg, train):
    """The flagship init start on the chunk schedule with the init
    regularizers on (``INIT_REG_WEIGHTS``), steps ``INIT_REG_STEPS`` with
    the counts from 0: ms a step, the losses, and arap_p's KNN over every
    capacity row alone (CUDA events)."""
    scene, meta, _ = fullscale_scene(rcfg, train)
    tr = flagship_trainer(cfg, rcfg, train, scene, meta,
                          {**train.loss, **INIT_REG_WEIGHTS})
    for k in KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    launches, records = {}, []
    for step in INIT_REG_STEPS:
        m, ms = timed_step(tr, step, launches)
        records.append({'step': step, 'stage': cfg.stage_at(step), 'ms': ms,
                        **{k: m[k] for k in ('loss', *INIT_REG_WEIGHTS,
                                             'num_pairs', 'overflow')}})
    peak = torch.cuda.max_memory_allocated()
    model = tr.model
    with torch.no_grad():
        pts = model.params['xyz'] + forward_deltas(
            cfg, model, scene.times[0], 'init', training=True).d_xyz
        far = torch.where(model.alive[:, None], pts, pts + 1e6)
    knn_ms = cuda_ms(lambda: knn_op(far, far, tr.gs_knn_num + 1), 2, 1)
    n = len(INIT_REG_STEPS)
    expected = {k.name: n if k in (chunk_blend_fwd, chunk_blend_bwd) else 0
                for k in KERNELS}
    emit({'phase': 'init_reg_train', 'weights': INIT_REG_WEIGHTS,
          'capacity': int(model.alive.shape[0]),
          'n_alive': int(model.alive.sum()), 'steps': records,
          'arap_p_knn_ms': knn_ms, 'max_memory_allocated': peak,
          'launches': launches, 'expected_launches': expected})
    for r in records:
        if not all(math.isfinite(r[k]) for k in ('loss', *INIT_REG_WEIGHTS)):
            raise AssertionError(f'bad init_reg step: {r}')
    if launches != expected:
        raise AssertionError(f'init_reg_train launches {launches} != '
                             f'{expected}')
    return launches


def gemm_rows(on_dev) -> list:
    """The matrix-product kernels of a profiler window (convolutions left
    out), by device time."""
    return [e for e in on_dev if any(g in e.key.lower() for g in GEMM_MARKS)
            and 'conv' not in e.key.lower()]


def phase_init_bf16(cfg, rcfg, train):
    """The flagship init start in float32 and with the nets in bfloat16
    (``train.precision: bf16``), one trainer each from the same start; a
    warm-up step each, then steps ``INIT_BF16_STEPS`` in turns (ms, host
    clock, synchronised); then one more step of each under torch.profiler:
    its device time, and the matrix-product kernels by name and time (the
    warp nets' GEMMs), whether the bf16 run's are tensor-core kernels."""
    scene, meta, _ = fullscale_scene(rcfg, train)
    bf16 = cfg._replace(
        net=cfg.net._replace(compute_dtype='bfloat16'),
        sk_net=cfg.sk_net._replace(compute_dtype='bfloat16'))
    trainers = {'f32': flagship_trainer(cfg, rcfg, train, scene, meta,
                                        train.loss),
                'bf16': flagship_trainer(bf16, rcfg, train, scene, meta,
                                         train.loss)}
    for tr in trainers.values():
        tr.train_step(INIT_BF16_STEPS[0] - 1)
    for k in KERNELS:
        k.launches = 0
    launches = {}
    ms = {name: [] for name in trainers}
    loss = {name: [] for name in trainers}
    for i, step in enumerate(INIT_BF16_STEPS):
        order = ('f32', 'bf16') if i % 2 == 0 else ('bf16', 'f32')
        for name in order:
            m, t = timed_step(trainers[name], step,
                              launches if name == 'bf16' else None)
            ms[name].append(t)
            loss[name].append(m['loss'])
    step = INIT_BF16_STEPS[-1] + 1
    prof = {}
    for name, tr in trainers.items():
        on_dev, wall = profile_window(lambda tr=tr: tr.train_step(step))
        gemms = gemm_rows(on_dev)
        prof[name] = {
            'device_ms': sum(dev_us(e) for e in on_dev) * 1e-3,
            'wall_ms': wall * 1e3,
            'gemm_device_ms': sum(dev_us(e) for e in gemms) * 1e-3,
            'gemm_kernels': [{'kernel': e.key[:160], 'launches': e.count,
                              'device_ms': dev_us(e) * 1e-3}
                             for e in gemms[:12]]}
    f32_names = {g['kernel'] for g in prof['f32']['gemm_kernels']}
    own = [g['kernel'] for g in prof['bf16']['gemm_kernels']
           if g['kernel'] not in f32_names]
    tensor_cores = any(mark in k.lower() for k in own
                       for mark in TENSOR_CORE_MARKS)
    n = len(INIT_BF16_STEPS)
    expected = {k.name: n if k in (chunk_blend_fwd, chunk_blend_bwd) else 0
                for k in KERNELS}
    emit({'phase': 'init_bf16', 'steps': list(INIT_BF16_STEPS),
          'ms': ms, 'loss': loss, 'profiled_step': step, 'profile': prof,
          'bf16_gemm_kernels_not_in_f32': own,
          'bf16_gemms_on_tensor_cores': tensor_cores,
          'launches': launches, 'expected_launches': expected})
    if not all(math.isfinite(v) for v in loss['bf16']) \
            or launches != expected:
        raise AssertionError(f'init_bf16: loss {loss}, launches '
                             f'{launches} != {expected}')
    return launches


def zju_extrinsics(Tv2w_cv: np.ndarray):
    """(R [3, 3], T [3, 1] in millimetres) of ZJU-MoCap's ``annots.npy``
    for an OpenCV camera-to-world matrix: the world-to-view matrix the
    loader reads in OpenGL axes, which it converts to COLMAP's."""
    to_colmap = convert_coord_system(np.eye(4), 'opengl', 'colmap')
    Tw2v_gl = np.linalg.inv(to_colmap) @ np.linalg.inv(Tv2w_cv)
    return Tw2v_gl[:3, :3], Tw2v_gl[:3, 3:] * 1e3


def write_jpegs(paths, frames, quality: int) -> dict:
    """Write the uint8 RGB frames (on the card) as baseline 4:2:0 JPEG
    files by ``encode_jpeg``, several at once; returns the seconds and
    each file's decode by the port against its frame, PSNR."""
    t0 = time.perf_counter()
    host = [f.cpu().numpy() for f in frames]

    def one(path, img):
        data = encode_jpeg(img, quality)
        Path(path).write_bytes(data)
        dec = jpeg.decode_jpeg(data, str(path)).astype(np.float64)
        mse = float(np.mean((dec - img) ** 2))
        return 10 * math.log10(255.0 ** 2 / max(mse, 1e-12)), len(data)

    with ThreadPoolExecutor(8) as pool:
        out = list(pool.map(one, paths, host))
    return {'write_s': time.perf_counter() - t0,
            'psnr': [q for q, _ in out], 'bytes': [b for _, b in out]}


def write_zju(root: Path, train, fmt: str = 'png') -> dict:
    """A ZJU-MoCap ``annots.npy`` layout (tests/test_torch_loaders.py's
    ``write_zju_annots``) at ZJU_HW px: the preset's chain over ZJU_FRAMES
    frames seen by ZJU_CAMERAS orbit cameras (intrinsics and poses that put
    it in view), each image an RGB PNG, or with ``fmt`` 'jpeg' a baseline
    4:2:0 JPEG at ZJU_JPEG_QUALITY (the real dataset's format), with its
    PNG mask beside it."""
    ds = train.dataset
    gt = make_chain_gt(np.random.default_rng(train.seed), ds.num_links,
                       ds.gauss_per_link, ZJU_FRAMES)
    Tv2w, fovx = orbit_views(ZJU_CAMERAS, h=ZJU_HW, w=ZJU_HW)
    focal = ZJU_HW / 2 / math.tan(fovx / 2)
    scene_root = root / 'CoreView_377'
    (scene_root / 'imgs').mkdir(parents=True)
    (scene_root / 'mask').mkdir()
    K = np.tile(np.array([[focal, 0, ZJU_HW / 2], [0, focal, ZJU_HW / 2],
                          [0, 0, 1]], np.float32), (ZJU_CAMERAS, 1, 1))
    RT = [zju_extrinsics(Tv2w[c]) for c in range(ZJU_CAMERAS)]
    suffix = '.jpg' if fmt == 'jpeg' else '.png'
    images, masks, ims = [], [], []
    for f in range(ZJU_FRAMES):
        names = []
        for c in range(ZJU_CAMERAS):
            rgba = render_rgba(gt, f, Tv2w[c], fovx, ZJU_HW)
            name = f'imgs/f{f:02d}_c{c:02d}{suffix}'
            images.append((scene_root / name, rgba[..., :3]))
            masks.append((scene_root / 'mask' / f'f{f:02d}_c{c:02d}.png',
                          rgba[..., 3:].expand(-1, -1, 3)))
            names.append(name)
        ims.append({'ims': names})
    np.save(scene_root / 'annots.npy', {'cams': {
        'K': K, 'R': np.stack([r for r, _ in RT]).astype(np.float32),
        'T': np.stack([t for _, t in RT]).astype(np.float32)}, 'ims': ims})
    out = {'Tv2w': Tv2w, 'fovx': fovx}
    if fmt == 'jpeg':
        out.update(write_jpegs(*zip(*images), ZJU_JPEG_QUALITY))
        out['write_s'] += write_pngs(*zip(*masks))
    else:
        out['write_s'] = write_pngs(*zip(*(images + masks)))
    return out


def load_per_view(rec: dict) -> dict:
    """Load seconds a view, by split, of a ``train_cli_on`` record."""
    return {x['split']: x['seconds'] / x['views'] for x in rec['load']}


def phase_cli_train_zju(tmp: Path, train, fmt: str = 'png',
                        png: dict = None) -> dict:
    """``cli.train`` on configs/zju.yaml (widths not cut; ``is_blender``
    false: the time noise live) on a ZJU-MoCap layout written at ZJU_HW px
    (ZJU_CAMERAS cameras, ZJU_FRAMES frames) for ZJU_STEPS steps: load
    seconds by split and a view, ms a step, the time noise's scale at
    those steps, the cameras as written, the launches. With ``fmt``
    'jpeg' (phase cli_train_zju_jpeg) the frames are JPEG files, decoded
    by the port (each at least JPEG_MIN_PSNR dB from its rendered frame),
    beside the PNG layout's loads of the same call (``png``, phase
    cli_train_zju's record). Returns (the launches, the record)."""
    phase = 'cli_train_zju' + ('_jpeg' if fmt == 'jpeg' else '')
    root = tmp / ('zju_jpeg' if fmt == 'jpeg' else 'zju')
    written = write_zju(root, train, fmt)
    cfg = make_config(CLI_ZJU, [f'dataset.root={root}'])
    skcfg, _ = build.build_model_cfg(cfg, types.SimpleNamespace(
        num_frames=ZJU_FRAMES), (ZJU_HW, ZJU_HW))
    rec, launches, loads = train_cli_on(
        phase, CLI_ZJU, [f'dataset.root={root}'], ZJU_STEPS, 'load_zju',
        root.with_name(root.name + '_out'))
    scene = loads[0]['scene']
    Tv2w = written['Tv2w'][scene.camera_ids.cpu().numpy()]
    cams_ok = bool(np.allclose(scene.Tw2v.cpu().numpy(),
                               np.linalg.inv(Tv2w), atol=1e-4))
    n_eval = loads[1]['views']
    expected = expected_launches(ZJU_STEPS, n_eval)
    logged = [json.loads(line) for line in (
        root.with_name(root.name + '_out') / cfg['exp_name']
        / 'metrics.jsonl').read_text().splitlines()]
    rec.update({'hw': ZJU_HW, 'cameras': ZJU_CAMERAS, 'frames': ZJU_FRAMES,
                'format': fmt, 'write_s': written['write_s'],
                'load_s_per_view': load_per_view(rec),
                'is_blender': skcfg.net.is_blender,
                'time_noise_scale': [smooth_scale(skcfg, s)
                                     for s in range(1, ZJU_STEPS + 1)],
                'overflow_logged': [bool(r.get('overflow', False))
                                    for r in logged],
                'cameras_as_written': cams_ok,
                'expected_launches': expected})
    psnr_ok = True
    if fmt == 'jpeg':
        psnr_ok = min(written['psnr']) > JPEG_MIN_PSNR
        rec.update({'quality': ZJU_JPEG_QUALITY, 'sampling': '4:2:0',
                    'decoded_psnr_min': min(written['psnr']),
                    'decoded_psnr_mean': float(np.mean(written['psnr'])),
                    'file_kb_mean': float(np.mean(written['bytes'])) / 1e3,
                    'png_load': png['load'],
                    'png_load_s_per_view': png['load_s_per_view'],
                    'load_ratio_to_png': {
                        k: v / png['load_s_per_view'][k]
                        for k, v in rec['load_s_per_view'].items()}})
    emit(rec)
    if skcfg.net.is_blender or not cams_ok or launches != expected \
            or not psnr_ok:
        raise AssertionError(f'{phase}: is_blender {skcfg.net.is_blender}, '
                             f'cameras {cams_ok}, PSNR ok {psnr_ok}, '
                             f'launches {launches} != {expected}')
    return launches, rec


def phase_jpeg(train) -> None:
    """The port's JPEG decoder on the card's host: each committed fixture
    (tests/fixtures/jpeg, written by Pillow and by ``encode_jpeg``) against
    its committed Pillow decode, max abs difference 0; then the decode of
    one frame at each of JPEG_TIMED (the preset's chain rendered at that
    side, encoded at quality 90), ms."""
    files = sorted(JPEG_FIXTURES.glob('*.jpg'))
    fixtures = []
    for f in files:
        got = jpeg.read_jpeg(f)
        ref = read_png(f.with_suffix('.png'))
        ref = ref[..., 0] if got.ndim == 2 else ref
        fixtures.append({'file': f.name, 'shape': list(got.shape),
                         'max_abs_diff': int(np.abs(
                             got.astype(np.int64) - ref).max())
                         if got.shape == ref.shape else None})
    ds = train.dataset
    gt = make_chain_gt(np.random.default_rng(train.seed), ds.num_links,
                       ds.gauss_per_link, 1)
    timed = []
    for name, hw, luma in JPEG_TIMED:
        Tv2w, fovx = orbit_views(1, h=hw, w=hw)
        img = render_rgba(gt, 0, Tv2w[0], fovx, hw)[..., :3].cpu().numpy()
        data = encode_jpeg(img, 90, sampling=(luma, (1, 1), (1, 1)))
        jpeg.decode_jpeg(data)
        ms = []
        for _ in range(JPEG_TIMED_REPS):
            t0 = time.perf_counter()
            dec = jpeg.decode_jpeg(data)
            ms.append((time.perf_counter() - t0) * 1e3)
        mse = float(np.mean((dec.astype(np.float64) - img) ** 2))
        timed.append({'name': name, 'hw': hw, 'bytes': len(data),
                      'ms_median': float(np.median(ms)),
                      'ms_min': min(ms), 'ms_max': max(ms),
                      'psnr': 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))})
    emit({'phase': 'jpeg', 'library': jpeg.LIBRARY.build_info,
          'fixtures': fixtures, 'timed_decode': timed})
    bad = [x for x in fixtures if x['max_abs_diff'] != 0]
    if len(fixtures) < 10 or bad:
        raise AssertionError(f'jpeg: {len(fixtures)} fixtures, differing '
                             f'{bad}')


def http_get(url: str):
    """(status, content type, body, ms on the host clock)."""
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=300) as r:
        body = r.read()
        return r.status, r.headers['Content-Type'], body, \
            (time.perf_counter() - t0) * 1e3


def ms_summary(ms) -> dict:
    return {'n': len(ms), 'median': float(np.median(ms)), 'max': max(ms),
            'min': min(ms)}


def png_bytes_decoded(body: bytes, tmp: Path) -> np.ndarray:
    path = tmp / 'viewer_frame.png'
    path.write_bytes(body)
    return read_png(path)


def topk_card_vs_cpu(seed: int) -> dict:
    """``render_topk`` of a small random scene (300 Gaussians, 64 x 48,
    chunk 64) on the card and on the CPU: ids equal, weights within
    TOPK_TOL."""
    rng = np.random.default_rng(seed)
    n = 300
    q = rng.normal(size=(n, 4)).astype(np.float32)
    arrays = {'means3d': rng.uniform(-0.6, 0.6, (n, 3)),
              'scales': rng.uniform(0.02, 0.12, (n, 3)),
              'rotations': q / np.linalg.norm(q, axis=-1, keepdims=True),
              'opacities': rng.uniform(0.05, 0.99, n),
              'colors': rng.uniform(0, 1, (n, 3))}
    cfg = RasterConfig(image_width=64, image_height=48, sh_degree=0,
                       pair_capacity=2 ** 14, chunk=64)
    out = {}
    for dev in ('cuda', 'cpu'):
        g = GaussianInputs(**{k: torch.tensor(v, dtype=torch.float32,
                                              device=dev)
                              for k, v in arrays.items()})
        eye = np.asarray([0.3, -0.2, -3.0], np.float32)
        view = ViewParams(
            Tw2v=look_at(eye, np.zeros(3, np.float32),
                         np.asarray([0.0, -1.0, 0.0], np.float32),
                         coord='opencv', device=dev),
            Tv2c=perspective_opencv(0.8, size=(64, 48), device=dev),
            campos=torch.from_numpy(eye).to(dev),
            tan_fovx=torch.tensor(math.tan(0.8 / 2) * 64 / 48, device=dev),
            tan_fovy=torch.tensor(math.tan(0.8 / 2), device=dev))
        idx, w = render_topk(g, view, cfg, k=8)
        out[dev] = (idx.cpu(), w.cpu())
    (i_c, w_c), (i_p, w_p) = out['cuda'], out['cpu']
    return {'ids_equal': bool(torch.equal(i_c, i_p)),
            'weights_max_abs_err': float((w_c - w_p).abs().max()),
            'contributors': int((i_p >= 0).sum()), 'tolerance': TOPK_TOL}


def phase_viewer(root: Path, ckpt: Path) -> dict:
    """The port's viewer (``cli.viewer``: ``build_state`` from
    configs/synthetic_fullscale.yaml and the full-width ``sk`` checkpoint,
    its HTTP server on 127.0.0.1, port 0, in a thread): VIEWER_REQUESTS
    ``/render`` requests in each mode, ``/pick`` and ``/skeleton`` requests
    and ``/info`` over urllib at orbit cameras, times and poses; ms a
    request by endpoint (median, max); kernel #1 launched exactly once a
    ``/render`` (the counts at 0 before each, read after); the ``rgb`` PNG
    at a zero pose equal to ``render_eval``'s frame (to_uint8) and at a
    pose to the deltas, render and white composite called directly;
    ``render_topk``'s device ms (CUDA events) alone at full width; and
    ``render_topk`` on the card against the CPU on a small scene. Returns
    the launches over the requests."""
    state = cli_viewer.build_state(cli_viewer.parse_args([
        '-c', CLI_FULLSCALE, '--load', str(ckpt), '--device', 'cuda',
        '--set', f'dataset.root={root}']))
    server = ThreadingHTTPServer(('127.0.0.1', 0),
                                 cli_viewer.make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f'http://127.0.0.1:{server.server_address[1]}'
    rng = np.random.default_rng(SEED)
    m = state.m
    reqs = []
    for i in range(VIEWER_REQUESTS):
        pose = rng.uniform(-0.5, 0.5, (8, 3)) if i % 2 else np.zeros((0, 3))
        reqs.append((2 * math.pi * i / VIEWER_REQUESTS,
                     0.3 + 0.2 * math.sin(i), state.radius0 * (0.9 + 0.1 *
                                                               (i % 3)),
                     i / (VIEWER_REQUESTS - 1),
                     ';'.join(','.join(f'{v:.3f}' for v in r) for r in pose)))
    q = lambda r: (f'theta={r[0]}&phi={r[1]}&radius={r[2]}&t={r[3]}'
                   f'&pose={r[4]}')
    ms = {}
    per_render, bad = [], []
    try:
        status, _, body, ms['info'] = http_get(base + '/info')
        info = json.loads(body)
        torch.cuda.synchronize()
        for k in KERNELS:
            k.launches = 0
        for mode in VIEWER_MODES:
            ms[mode] = []
            for i, r in enumerate(reqs):
                before = {k.name: k.launches for k in KERNELS}
                status, ctype, body, t = http_get(
                    f'{base}/render?mode={mode}&sel={i % m}&' + q(r))
                got = {k.name: k.launches - before[k.name] for k in KERNELS}
                per_render.append(got[tile_blend_fwd.name])
                if (status, ctype) != (200, 'image/png') or got != {
                        tile_blend_fwd.name: 1, tile_blend_bwd.name: 0,
                        chunk_blend_fwd.name: 0, chunk_blend_bwd.name: 0}:
                    bad.append((mode, i, status, got))
                ms[mode].append(t)
        picks, ms['pick'] = [], []
        for i, r in enumerate(reqs):
            x, y = (37 * i + 11) % state.w, (53 * i + 7) % state.h
            _, _, body, t = http_get(f'{base}/pick?x={x}&y={y}&' + q(r))
            picks.append(json.loads(body))
            ms['pick'].append(t)
        skels, ms['skeleton'] = [], []
        for r in reqs:
            _, _, body, t = http_get(f'{base}/skeleton?' + q(r))
            skels.append(json.loads(body))
            ms['skeleton'].append(t)
        torch.cuda.synchronize()
        total = {k.name: k.launches for k in KERNELS}
        # the rgb frame against the render called directly
        frames = {}
        for i in (0, 1):
            r = reqs[i]
            _, _, body, _ = http_get(f'{base}/render?mode=rgb&' + q(r))
            got = png_bytes_decoded(body, root)
            view = state.make_view(r[0], r[1], r[2])
            pose = torch.from_numpy(cli_viewer.parse_pose(r[4], m)).cuda()
            ones = torch.ones(3, device='cuda')
            if i == 0:
                ref = render_eval(state.model, view, r[3], ones, 'sk',
                                  state.rcfg)['image']
            else:
                with torch.no_grad():
                    d = forward_deltas(state.skcfg, state.model,
                                       torch.tensor(r[3], device='cuda'),
                                       'sk', sk_r_delta=pose)
                    g = gaussian_inputs(state.model.gauss_view(),
                                        state.skcfg.gauss, d_xyz=d.d_xyz,
                                        d_rotation=d.d_rotation,
                                        d_scaling=d.d_scaling)
                    out = render(g, view, state.rcfg,
                                 active_sh_degree=state.model
                                 .active_sh_degree)
                    ref = composite_background(out['images'],
                                               out['opacity'], ones)
            ref = to_uint8(ref.cpu().numpy())
            frames['zero_pose' if i == 0 else 'pose'] = int(np.abs(
                got.astype(np.int64) - ref).max()) \
                if got.shape == ref.shape else None
        # render_topk alone, device time
        r = reqs[1]
        with torch.inference_mode():
            view = state.make_view(r[0], r[1], r[2])
            g, _ = state.inputs(r[3], cli_viewer.parse_pose(r[4], m))
            topk_ms = cuda_ms(lambda: render_topk(g, view, state.rcfg,
                                                  k=cli_viewer.PICK_K), 3, 1)
            pre = preprocess(g, view, state.rcfg)
            counts = build_tile_lists(pre, state.rcfg).tile_count
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    small = topk_card_vs_cpu(SEED)
    picked = [p['superpoint'] for p in picks]
    rec = {'phase': 'viewer', 'requests_each': VIEWER_REQUESTS,
           'image': [state.h, state.w], 'info': info,
           'ms_by_endpoint': {k: ms_summary(v) if isinstance(v, list)
                              else v for k, v in ms.items()},
           'fwd_launches_per_render': sorted(set(per_render)),
           'launches': total, 'bad_renders': bad,
           'rgb_png_vs_direct_max_abs_diff': frames,
           'picks_on_a_superpoint': sum(p >= 0 for p in picked),
           'skeleton_alive': [sum(s['alive']) for s in skels[:3]],
           'topk_device_ms': topk_ms, 'topk_k': cli_viewer.PICK_K,
           'longest_tile_list': int(counts.max()),
           'chunk': state.rcfg.chunk, 'topk_card_vs_cpu_small': small}
    emit(rec)
    want = {tile_blend_fwd.name: len(VIEWER_MODES) * VIEWER_REQUESTS,
            tile_blend_bwd.name: 0, chunk_blend_fwd.name: 0,
            chunk_blend_bwd.name: 0}
    if bad or total != want or any(v != 0 for v in frames.values()) \
            or info['width'] != state.w or info['num_joints'] != m \
            or not any(p >= 0 for p in picked) \
            or not small['ids_equal'] \
            or small['weights_max_abs_err'] > TOPK_TOL:
        raise AssertionError(f'viewer: bad renders {bad}, launches {total} '
                             f'!= {want}, frames {frames}, topk {small}')
    return total


def phase_cli_train_options(tmp: Path, smoke_ms: dict) -> dict:
    """``cli.train`` on configs/synthetic_smoke.yaml with Adan, two views
    a step and bf16 nets (``CLI_OPTIONS``), its whole schedule, then
    ``cli.test`` on its ``last.npz``: ms a step by stage beside the
    one-view run's (``smoke_ms``), the results, #1 twice a step and once
    a view of each render, #2 twice a step but the ``sk_init`` steps'."""
    cfg = make_config(CLI_SMOKE, list(CLI_OPTIONS))
    res, launches, secs = cli_run(cli_train.main, [
        '-c', CLI_SMOKE, '--device', 'cuda', '--set', f'output_dir={tmp}',
        f'dataset.root={tmp}', *CLI_OPTIONS])
    out = tmp / cfg['exp_name']
    check_results(json.loads((out / 'results.json').read_text()),
                  CLI_TRAIN_KEYS, 'cli_train_options')
    sched = cfg['train_schedule']
    steps = sum(sched.values())
    k = int(cfg['train']['batch_views'])
    views = cfg['dataset']['num_frames']
    evals = steps // cfg['train']['eval_interval'] + (
        steps % cfg['train']['eval_interval'] > 0) + 1
    expected = {tile_blend_fwd.name: k * steps + views * (1 + evals),
                tile_blend_bwd.name: k * (steps - sched['sk_init']),
                chunk_blend_fwd.name: 0, chunk_blend_bwd.name: 0}
    by_stage = ms_by_stage(out)
    tested, test_launches, test_s = cli_run(cli_test.main, [
        '-c', str(out / 'config.yaml'), '--load',
        str(out / 'checkpoints/last.npz'), '--device', 'cuda', '--out',
        str(tmp / 'test_options.json')])
    emit({'phase': 'cli_train_options', 'options': CLI_OPTIONS,
          'seconds': secs, 'steps': steps, 'ms_per_step_by_stage': by_stage,
          'ratio_to_one_view_by_stage': {
              s: by_stage[s] / smoke_ms[s] for s in by_stage
              if s in smoke_ms},
          'results': res, 'launches': launches,
          'expected_launches': expected, 'test_seconds': test_s,
          'test': {k: tested[k] for k in ('PSNR', 'SSIM', 'FPS', 'stage',
                                          'step')}})
    check_results(tested, CLI_TEST_KEYS, 'cli_train_options test')
    if launches != expected or tested['step'] != steps:
        raise AssertionError(f'cli_train_options: launches {launches} != '
                             f'{expected}')
    return launches


def phase_clis(sweep: bool) -> dict:
    """The CLI phases in one temporary directory; returns their launches
    by path."""
    with tempfile.TemporaryDirectory(prefix='chip_smoke_cli_') as d:
        tmp = Path(d)
        paths = {'cli_train': phase_cli_train_smoke(tmp / 'smoke')}
        smoke_ms = ms_by_stage(tmp / 'smoke' / make_config(CLI_SMOKE)[
            'exp_name'])
        paths['cli_train_options'] = phase_cli_train_options(
            tmp / 'options', smoke_ms)
        ckpt, paths['cli_test'] = phase_cli_test_fullscale(tmp / 'test',
                                                           sweep)
        paths['cli_repose'] = phase_cli_repose_fullscale(tmp / 'test', ckpt)
        phase_cli_train_fullscale(tmp / 'train')
        train = synthetic_fullscale()[2]
        dnerf = phase_cli_train_dnerf(tmp / 'data', train)
        paths['cli_train_dnerf'] = dnerf['launches']
        rnd = phase_cli_train_dnerf_random(tmp / 'data',
                                           dnerf['ms_per_step_by_stage'])
        paths['cli_train_dnerf_random'] = rnd['cli']
        paths['train_dynamic_bg'] = rnd['dynamic']
        paths['cli_train_wim'] = phase_cli_train_wim(tmp / 'data', train)
        paths['cli_train_zju'], png = phase_cli_train_zju(tmp / 'data',
                                                          train)
        paths['cli_train_zju_jpeg'], _ = phase_cli_train_zju(
            tmp / 'data', train, 'jpeg', png)
        paths['viewer'] = phase_viewer(tmp / 'test', ckpt)
    return paths


# ------------------------------------------------------------ the mesh

MESH_RANKS = 2
# (family, the steps held against one process at batch_views 2, the steps
# after them that the ranks alone take across events)
MESH_VIEW_PLAN = (('init', (2996, 2997), (2999, 3000, 3001)),
                  ('sp', (13998, 13999), (14000, 14001, 19999, 20000, 20001)),
                  ('sk', (40001, 40002), ()))
MESH_EXACT = ('alive', 'max_radii2d', 'denom', 'p2sp', 'joint_parents')
MESH_CLOSE = {'xyz_grad_accum': 1e-3, 'sp_cache': 1e-5, 'sk_cache': 1e-5,
              'joint_cost': 1e-5}
MESH_NCCL1_TURNS = 3
SHARDED_TILE_H = 8
SHARDED_PAIR_CAPACITY = 2 ** 21
SHARDED_RENDERS = 5
SHARDED_TOL = 3e-5
SHARDED_GRAD_TOL = 5e-4
SHARDED_LEAVES = ('means3d', 'scales', 'rotations', 'opacities', 'sh')
RENDERERS = {'sharded': make_sharded_render, 'exchange': make_exchange_render}
WORKER_TIMEOUT = 900
# (family, the steps held against one process) of the gs axis, a 1 x 2
# mesh at batch_views 1; and the 2 x 2 mesh's sk steps at batch_views 2
MESH_GS_PLAN = (('init', (2996, 2997)), ('sp', (13998, 13999)),
                ('sk_init', (40001, 40002)), ('sk', (40001, 40002)))
MESH_2X2 = (2, 2)
MESH_2X2_STEPS = (40001, 40002)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def spawn_ranks(worker: str, world: int, tmp: Path, argv_of=lambda r: ()):
    """``world`` ranks, each a process of this script running ``worker``
    (``--worker``) with ``argv_of(rank)``, MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK / LOCAL_RANK in its env, its output in
    ``tmp/<worker>_rank<r>.log``. When a rank fails the others are
    stopped, and the run raises with the failed rank's output. Returns each
    rank's result (``tmp/<worker>_rank<r>.json``)."""
    port = free_port()
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK='0')
        log = open(tmp / f'{worker}_rank{rank}.log', 'w+')
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), '--worker',
             worker, '--tmp', str(tmp), *map(str, argv_of(rank))],
            env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        deadline = time.monotonic() + WORKER_TIMEOUT
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f'{worker} rank {rank} exited with '
                               f'{p.returncode}:\n{out[-6000:]}')
    return [json.loads((tmp / f'{worker}_rank{r}.json').read_text())
            for r in range(world)]


def mesh_trainer(family: str, mesh=None, batch_views: int = MESH_RANKS,
                 band: bool = False) -> SKGSTrainer:
    """The full-width trainer of ``family`` on the preset's scene from
    seed 0: 'init' the populated start (80,000 alive) on the chunk
    schedule, 'sp' the random sp-stage model, 'sk_init' that model on the
    sk stages of synthetic_smoke (``sk_init_cfg``) with its LBS frozen
    (``freeze_lbs``, the skeleton initialisation's first part), 'sk' the
    random model with its skeleton initialised; ``batch_views`` views a
    step, a ``MeshTrainer`` on ``mesh`` when given one. ``band``: the gs
    axis's setup, tile_h 8 (25 tile rows at 16 do not split into 2
    bands), a pair capacity of 2^21 (a band holds half of it) and, for
    'sp', the smooth loss's KNN rebuilt."""
    cfg, rcfg, train = synthetic_fullscale()
    if family == 'init':
        rcfg = rcfg._replace(schedule='chunk')
    if family == 'sk_init':
        cfg = sk_init_cfg(cfg)
    if band:
        rcfg = rcfg._replace(tile_h=SHARDED_TILE_H,
                             pair_capacity=SHARDED_PAIR_CAPACITY)
    scene, meta, _ = fullscale_scene(rcfg, train)
    if family == 'init':
        model = populated_model(cfg, rcfg, 80_000)
    else:
        model = convert.model_from_flat(
            random_model_flat(cfg, SEED, 80_000,
                              sp_stage=family in ('sp', 'sk_init')),
            cfg, rcfg, device='cuda', trainable=True)
    if family == 'sk_init':
        with torch.no_grad():
            sk_gs_ops.freeze_lbs(cfg, model)
    knn = live_knn_index(model.params['xyz'].detach(), model.alive,
                         SKGSTrainer.gs_knn_num) \
        if band and family == 'sp' else None
    cls, kw = (SKGSTrainer, {}) if mesh is None else \
        (MeshTrainer, {'mesh': mesh})
    return cls(cfg, rcfg, scene, meta, model, LossWeights(train.loss),
               seed=train.seed, clip_norm=train.clip_norm,
               optimizer=train.optimizer, batch_views=batch_views,
               gs_knn_index=knn, sp_initialized=family in ('sp', 'sk_init'),
               reinit_done=family in ('sp', 'sk_init'),
               skeleton_initialized=family in ('sk_init', 'sk'),
               device='cuda', **kw)


def mesh_steps(trainer: SKGSTrainer, steps):
    """Steps ``steps`` with the launch counts and the collectives' counts
    at 0: (a record per step, each step's gradients on the host, the
    launches)."""
    for k in COUNTED:
        k.launches = 0
    coll.reset_counts()
    recs, grads = [], []
    for step in steps:
        m, ms = timed_step(trainer, step)
        recs.append({'step': step, 'ms': ms, **m})
        grads.append({k: p.grad.detach().cpu().clone()
                      for k, p in trainer.model.leaves().items()})
    return recs, grads, {k.name: k.launches for k in COUNTED}


def timed_merges(trainer: SKGSTrainer, nbytes: list = None) -> list:
    """Wrap the trainer's ``merge_views``: each call appends its
    synchronised ms (its two all-reduces over the whole mesh and their
    packing), and to ``nbytes`` the bytes this rank sent into them."""
    log, fn = [], trainer.merge_views

    def timed(*args):
        torch.cuda.synchronize()
        t0, b0 = time.perf_counter(), coll.counts['bytes']
        out = fn(*args)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0) * 1e3)
        if nbytes is not None:
            nbytes.append(coll.counts['bytes'] - b0)
        return out
    trainer.merge_views = timed
    return log


def timed_calls(obj, names) -> dict:
    """Wrap the methods ``names`` of ``obj``: each call appends its
    synchronised ms to the returned dict's list under its name."""
    log = {name: [] for name in names}

    def wrap(name, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            log[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed
    for name in names:
        setattr(obj, name, wrap(name, getattr(obj, name)))
    return log


def replica_difference(trainer: SKGSTrainer) -> float:
    """The largest difference between any rank's replica state and rank
    0's (copies are compared; nothing is written)."""
    group = trainer.mesh.group(('view', 'gs'))
    d = coll.broadcast_from([t.clone() for t in trainer.replica_state()],
                            group, 0)
    return float(coll.pmax(torch.tensor([d], device='cuda'), group)[0])


def worker_mesh_view(tmp: Path, rank: int) -> dict:
    """A rank of ``mesh_view``: each family's compared steps (rank 0
    saves their gradients and the model after them), then its event
    steps, and the replicas' difference after them."""
    mesh = make_mesh(MESH_RANKS, 1)
    out = {}
    for family, compare, events in MESH_VIEW_PLAN:
        tr = mesh_trainer(family, mesh)
        merges = timed_merges(tr)
        torch.cuda.reset_peak_memory_stats()
        recs, grads, launches = mesh_steps(tr, compare)
        calls, nbytes = coll.counts['calls'], coll.counts['bytes']
        if rank == 0:
            torch.save({'grads': grads, 'flat': convert.model_to_flat(
                tr.model)}, tmp / f'mesh_view_{family}.pt')
        del grads
        ev_recs, ev_log = [], []
        for step in events:
            m, ms = timed_step(tr, step)
            ev_recs.append({'step': step, 'ms': ms, 'loss': m['loss']})
            if tr.last_event:
                ev_log.append({'after_step': step, **{
                    k: int(v) for k, v in tr.last_event.items()}})
        out[family] = {
            'steps': recs, 'launches': launches,
            'collective_calls_per_step': calls / len(compare),
            'bytes_reduced_per_step': nbytes / len(compare),
            'merge_ms': merges[:len(compare)],
            'max_memory_allocated': torch.cuda.max_memory_allocated(),
            'event_steps': ev_recs, 'events': ev_log,
            'sync_drift_by_event': dict(tr.replica_drift),
            'replica_max_abs_diff': replica_difference(tr)}
        del tr
        torch.cuda.empty_cache()
    return out


def stat_errors(got: dict, ref: dict) -> dict:
    """The statistics, caches, ``p2sp`` and joint cost of two flat models:
    exact ones as the count of differing entries, the others as the error
    over their max."""
    out = {}
    for name in MESH_EXACT:
        out[name] = int(np.sum(got[name] != ref[name]))
    for name in MESH_CLOSE:
        scale = float(np.abs(ref[name]).max())
        err = float(np.abs(got[name] - ref[name]).max())
        out[name] = err / scale if scale > 0 else err
    return out


def against_one_process(family: str, rank_steps, got: dict, recs, grads,
                        flat: dict, lrs: dict, unheld=None):
    """Rank 0's steps (their records ``rank_steps``; ``got``: its
    gradients a step and its model after them) against one process's
    (``recs``, ``grads``, ``flat``), at ``train_reference``'s bars: (the
    loss's relative error, each step's three worst gradient errors over
    their leaf's max, the parameters' worst error over their bound and its
    leaf, the statistics' errors; whether every bar held). ``unheld``
    (``twin_unheld``'s) names each step's leaves whose gradient, and the
    leaves whose parameters, are held to no bar: their errors are
    reported."""
    steps_unheld, params_unheld = unheld or ([{}] * len(recs), {})
    loss_err = max(abs(a['loss'] - b['loss']) / abs(b['loss'])
                   for a, b in zip(rank_steps, recs))
    # the init family's isotropic Gaussians leave the rotation gradient
    # rounding noise (grad_path_init)
    iso = {'rotation': 'xyz'} if family == 'init' else {}
    every = [close_leaves(a, b, math.inf, scale_of=iso)
             for a, b in zip(got['grads'], grads)]
    grad_worst = [{k: v for k, v in sorted(
        ((k, v) for k, v in w.items() if k not in skip),
        key=lambda kv: -kv[1])[:3]} for w, skip in zip(every, steps_unheld)]
    free = set(params_unheld).union(*steps_unheld)
    param_worst, param_leaf = params_over_tol(
        got['flat'], flat, grads,
        {k: v for k, v in lrs.items() if k not in free}, len(recs),
        scale_of=iso)
    stats = stat_errors(got['flat'], flat)
    bad_stats = {k: v for k, v in stats.items() if v > MESH_CLOSE.get(k, 0)}
    held_one = not (loss_err > 2e-4 or param_worst > 1.0 or bad_stats
                    or max(v for w in grad_worst for v in w.values()) > 3e-4)
    return {'loss_rel_err': loss_err,
            'grad_worst_err_over_max_top3': grad_worst,
            'param_worst_over_tol': param_worst,
            'param_worst_leaf': param_leaf, 'stats': stats,
            'unheld_grad_err_over_max': [{k: w[k] for k in skip}
                                         for w, skip in zip(every,
                                                            steps_unheld)],
            'unheld_params_err_over_tol': {
                k: params_over_tol(got['flat'], flat, grads, {k: lrs[k]},
                                   len(recs), scale_of=iso)[0]
                for k in sorted(free)}}, held_one


def twin_unheld(family: str, twin, ref):
    """What a twin run of one process (``twin``: (grads a step, flat);
    ``ref``: (grads a step, flat, lrs), the same steps from one state)
    does not hold against itself at ``train_reference``'s bars: (for each
    step the leaves whose gradient it does not hold, with its error over
    the leaf's max; the leaves whose parameters it does not hold after the
    steps, with their error over the bound). The backward kernels' atomics
    sum in another order on each run; a leaf whose gradient cancels to a
    share of its terms' size (``sp_W``'s through the LBS softmax while the
    superpoints' transforms nearly agree) carries that order into its own
    entries, and Adam turns an entry's last bits near 0 into +-lr, which
    parts the next step's state."""
    iso = {'rotation': 'xyz'} if family == 'init' else {}
    steps = [{k: v for k, v in close_leaves(
        t, r, math.inf, scale_of=iso).items() if v > 3e-4}
        for t, r in zip(twin[0], ref[0])]
    params = {}
    for name, lr in ref[2].items():
        param, _ = params_over_tol(twin[1], ref[1], ref[0], {name: lr},
                                   len(ref[0]), scale_of=iso)
        if param > 1.0:
            params[name] = param
    return steps, params


def one_process_view_steps(family: str, steps):
    """One process's ``family`` steps at batch_views 2 from
    ``mesh_trainer``'s state: (the records, the gradients a step, the model
    after them, the learning rates, the launches, peak memory)."""
    tr = mesh_trainer(family)
    torch.cuda.reset_peak_memory_stats()
    recs, grads, launches = mesh_steps(tr, steps)
    peak = torch.cuda.max_memory_allocated()
    flat = convert.model_to_flat(tr.model)
    lrs = tr.lr_trees(steps[-1])
    del tr
    torch.cuda.empty_cache()
    return recs, grads, flat, lrs, launches, peak


def phase_mesh_view(tmp: Path) -> dict:
    """The trainer's view axis: 2 gloo ranks on this card, one view each,
    against one process at batch_views 2 from one state, for the init
    (chunk schedule), sp and sk families at full width; the ranks then go
    on across events, after which their replicas must not differ. The
    first step is held on every leaf; the second on the leaves that a twin
    run of one process holds against itself (``twin_unheld``), since it
    starts from states that the first step's atomics and Adam parted."""
    t0 = time.perf_counter()
    ranks = spawn_ranks('mesh_view', MESH_RANKS, tmp)
    ranks_s = time.perf_counter() - t0
    paths = {}
    for family, compare, events in MESH_VIEW_PLAN:
        recs, grads, flat, lrs, launches, peak = one_process_view_steps(
            family, compare)
        twin = one_process_view_steps(family, compare)
        steps_unheld, params_unheld = twin_unheld(family, twin[1:3],
                                                  (grads, flat, lrs))
        del twin
        # the first step starts from one state on every side: all held
        unheld = ([{}] + steps_unheld[1:], params_unheld)
        got = torch.load(tmp / f'mesh_view_{family}.pt', weights_only=False)
        r0 = ranks[0][family]
        agree, held_one = against_one_process(family, r0['steps'], got, recs,
                                              grads, flat, lrs, unheld)
        del got, grads
        fwd, bwd = (chunk_blend_fwd, chunk_blend_bwd) if family == 'init' \
            else (tile_blend_fwd, tile_blend_bwd)
        n = len(compare)
        want_rank = {k.name: n if k in (fwd, bwd) else 0 for k in COUNTED}
        want_one = {k: MESH_RANKS * v for k, v in want_rank.items()}
        # the first step of a process is its warm-up: the means leave it
        # (two steps, as train_reference holds: a third would start from
        # states parted by the first two Adam steps' rounding)
        warm = lambda xs: sum(xs[1:]) / len(xs[1:])
        rec = {
            'phase': 'mesh_view', 'family': family, 'backend': 'gloo',
            'ranks': MESH_RANKS, 'device': 'cuda:0, every rank',
            'steps': list(compare), 'ranks_seconds': ranks_s,
            'ms_ranks': [[s['ms'] for s in r[family]['steps']]
                         for r in ranks],
            'ms_one_process': [s['ms'] for s in recs],
            'ms_per_step_ranks': [warm([s['ms'] for s in r[family]['steps']])
                                  for r in ranks],
            'ms_per_step_one_process': warm([s['ms'] for s in recs]),
            'merge_ms_per_step_ranks': [warm(r[family]['merge_ms'])
                                        for r in ranks],
            'bytes_reduced_per_step': r0['bytes_reduced_per_step'],
            'collective_calls_per_step': r0['collective_calls_per_step'],
            'max_memory_allocated_ranks': [r[family]['max_memory_allocated']
                                           for r in ranks],
            'max_memory_allocated_one_process': peak,
            'launches_ranks': [r[family]['launches'] for r in ranks],
            'launches_one_process': launches,
            'loss_ranks': [s['loss'] for s in r0['steps']],
            'loss_one_process': [s['loss'] for s in recs], **agree,
            'twin_unheld': {'steps': steps_unheld, 'params': params_unheld},
            'event_steps': r0['event_steps'], 'events': r0['events'],
            'sync_drift_by_event_ranks': [r[family]['sync_drift_by_event']
                                          for r in ranks],
            'replica_max_abs_diff': r0['replica_max_abs_diff']}
        emit(rec)
        if not held_one:
            raise AssertionError(f'mesh_view {family}: the ranks differ from '
                                 f'one process: {rec}')
        if any(r[family]['launches'] != want_rank for r in ranks) or \
                launches != want_one:
            raise AssertionError(f'mesh_view {family}: launches {rec}')
        if events and not r0['events'] or any(
                r[family]['replica_max_abs_diff'] != 0 for r in ranks):
            raise AssertionError(f'mesh_view {family}: replicas after the '
                                 f'events: {rec}')
        paths[f'mesh_view_{family}'] = r0['launches']
    return paths


def worker_mesh_nccl1(tmp: Path, rank: int) -> dict:
    """One rank over NCCL: the sk step on a one-rank mesh and without a
    mesh, in turns from one state; then one NCCL all-reduce of the
    step's reduction size."""
    trainers = {'one_process': mesh_trainer('sk', None, 1),
                'mesh': mesh_trainer('sk', make_mesh(1, 1), 1)}
    s0 = MESH_VIEW_PLAN[2][1][0]
    for tr in trainers.values():
        tr.train_step(s0)                                   # warm-up
    rec = {k: {'ms': [], 'loss': []} for k in trainers}
    counts = {k: {} for k in trainers}
    for t in range(1, MESH_NCCL1_TURNS + 1):
        order = list(trainers) if t % 2 == 0 else list(trainers)[::-1]
        for name in order:
            m, ms = timed_step(trainers[name], s0 + t, counts[name])
            rec[name]['ms'].append(ms)
            rec[name]['loss'].append(m['loss'])
    tr = trainers['mesh']
    n = tr.model.alive.shape[0]
    numel = sum(p.numel() for p in tr.model.leaves().values()) + 3 * n
    buf = torch.zeros(numel, device='cuda')
    ms = cuda_ms(lambda: dist.all_reduce(buf), iters=10, warmup=2)
    return {'steps': rec, 'launches': counts, 'bucket_bytes': 4 * numel,
            'nccl_all_reduce_ms': ms, 'backend': dist.get_backend()}


def phase_mesh_nccl1(tmp: Path) -> dict:
    """One rank over NCCL (the only NCCL group one card gives): the sk
    step at full width on a one-rank mesh against the step without one,
    in turns; a group of one rank skips its collectives, and the NCCL
    all-reduce of the step's reduction size is timed alone."""
    r = spawn_ranks('mesh_nccl1', 1, tmp)[0]
    steps = r['steps']
    mean = lambda xs: sum(xs) / len(xs)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(
        steps['mesh']['loss'], steps['one_process']['loss']))
    rec = {'phase': 'mesh_nccl1', 'backend': r['backend'],
           'turns': MESH_NCCL1_TURNS,
           'ms_per_step_mesh': mean(steps['mesh']['ms']),
           'ms_per_step_one_process': mean(steps['one_process']['ms']),
           'mesh_overhead_ms_per_step': mean(steps['mesh']['ms'])
           - mean(steps['one_process']['ms']),
           'bucket_bytes': r['bucket_bytes'],
           'nccl_all_reduce_ms_one_rank': r['nccl_all_reduce_ms'],
           'loss_rel_err': loss_err, 'launches': r['launches'], 'ms': steps}
    emit(rec)
    want = {k.name: MESH_NCCL1_TURNS if k in (tile_blend_fwd, tile_blend_bwd)
            else 0 for k in KERNELS}
    if loss_err > 2e-4 or r['launches']['mesh'] != want or \
            r['backend'] != 'nccl':
        raise AssertionError(f'mesh_nccl1: {rec}')
    return {'mesh_nccl1': r['launches']['mesh']}


def worker_sharded_render(tmp: Path, rank: int) -> dict:
    """A rank of ``sharded_render``: its half of the slots through both
    renderers, timed renders, then one render and its backward."""
    data = torch.load(tmp / 'sharded_inputs.pt', weights_only=False)
    mesh = make_mesh(1, MESH_RANKS)
    rcfg = RasterConfig(**data['rcfg'])
    view = ViewParams(*(x.to('cuda') for x in data['view']))
    target = shard_rows(data['target'].to('cuda'), mesh, 'gs')
    out = {}
    for name, make in RENDERERS.items():
        fn = make(mesh, rcfg)
        leaves = {k: shard_rows(v.to('cuda'), mesh, 'gs').clone()
                  for k, v in data['g'].items()}
        for k in SHARDED_LEAVES:
            leaves[k].requires_grad_(True)
        g = GaussianInputs(**leaves)
        with torch.no_grad():
            fn(g, view)                                     # warm-up
            torch.cuda.synchronize()
            for k in KERNELS:
                k.launches = 0
            coll.reset_counts()
            t0 = time.perf_counter()
            for _ in range(SHARDED_RENDERS):
                res = fn(g, view)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / SHARDED_RENDERS
            render_launches = {k.name: k.launches for k in KERNELS}
            wire = coll.counts['bytes'] / SHARDED_RENDERS
        for k in KERNELS:
            k.launches = 0
        res = fn(g, view)
        # this band's terms of the mean l1 over the whole image
        loss = torch.abs(composite_background(
            res['images'], res['opacity'], torch.ones(3, device='cuda'))
            - target).sum() / (target.numel() * MESH_RANKS)
        loss.backward()
        torch.cuda.synchronize()
        grad_launches = {k.name: k.launches for k in KERNELS}
        torch.save({'images': res['images'].detach().cpu(),
                    'opacity': res['opacity'].detach().cpu(),
                    'radii': res['radii'].cpu(),
                    'visible': res['visible'].cpu(),
                    'grads': {k: leaves[k].grad.cpu()
                              for k in SHARDED_LEAVES}},
                   tmp / f'sharded_{name}_rank{rank}.pt')
        sent = res.get('sent')
        out[name] = {
            'ms_per_render': ms, 'render_launches': render_launches,
            'render_and_backward_launches': grad_launches,
            'band_pairs': int(res['num_pairs']),
            'overflow': bool(res['overflow']),
            'collective_bytes_per_render': wire,
            'rows_sent': None if sent is None else sent.tolist()}
        del res, loss, leaves, g
        torch.cuda.empty_cache()
    return out


def phase_sharded_render(model, view, t, tmp: Path) -> dict:
    """Both Gaussian-sharded renderers over 2 gloo ranks on this card,
    each rank holding half of serving's slots (80,000 alive), at tile_h 8
    (50 tile rows, 25 a band) and a pair capacity of 2^21 on both sides,
    against the one-card render: images and opacity 3e-5, radii and
    visible equal, the gradients of an l1 loss 5e-4 of each leaf's max,
    #1 once a render and #2 once a backward on each rank. Kernels #1 and
    #2 at tile_h 8 against their plain versions first."""
    rcfg = model.rcfg._replace(tile_h=SHARDED_TILE_H,
                               pair_capacity=SHARDED_PAIR_CAPACITY)
    cfg = model.cfg
    with torch.no_grad():
        d = forward_deltas(cfg, model, torch.tensor(t, device='cuda'), 'sk')
        g = gaussian_inputs(model.gauss_view(), cfg.gauss, d.d_xyz,
                            d.d_rotation, d.d_scaling)
    arrays = {k: getattr(g, k).detach() for k in SHARDED_LEAVES + ('mask',)}
    target = torch.from_numpy(np.random.default_rng(SEED).uniform(
        size=(rcfg.image_height, rcfg.image_width, 3)).astype(np.float32))
    torch.save({'g': {k: v.cpu() for k, v in arrays.items()},
                'view': [x.cpu() for x in view], 'rcfg': rcfg._asdict(),
                'target': target}, tmp / 'sharded_inputs.pt')
    kernels_h8 = tile_h8_kernels(GaussianInputs(**arrays), view, rcfg)

    ranks = spawn_ranks('sharded_render', MESH_RANKS, tmp)

    leaves = {k: v.clone().requires_grad_(k in SHARDED_LEAVES)
              for k, v in arrays.items()}
    one_ms = cuda_ms(lambda: render(GaussianInputs(**leaves), view, rcfg),
                     iters=SHARDED_RENDERS, warmup=1)
    ref = render(GaussianInputs(**leaves), view, rcfg)
    img = composite_background(ref['images'], ref['opacity'],
                               torch.ones(3, device='cuda'))
    (torch.abs(img - target.to('cuda')).sum() / target.numel()).backward()
    paths = {}
    for name in RENDERERS:
        parts = [torch.load(tmp / f'sharded_{name}_rank{r}.pt',
                            weights_only=False) for r in range(MESH_RANKS)]
        errs = {k: float((torch.cat([p[k] for p in parts])
                          - ref[k].detach().cpu()).abs().max())
                for k in ('images', 'opacity')}
        equal = {k: bool(torch.equal(torch.cat([p[k] for p in parts]),
                                     ref[k].cpu()))
                 for k in ('radii', 'visible')}
        grad_err = {}
        for k in SHARDED_LEAVES:
            r = leaves[k].grad.cpu()
            got = torch.cat([p['grads'][k] for p in parts])
            grad_err[k] = float((got - r).abs().max() / r.abs().max())
        rk = [r[name] for r in ranks]
        rec = {'phase': 'sharded_render', 'renderer': name,
               'backend': 'gloo', 'ranks': MESH_RANKS, 'tile_h': rcfg.tile_h,
               'pair_capacity': rcfg.pair_capacity,
               'slots_per_rank': arrays['means3d'].shape[0] // MESH_RANKS,
               'ms_per_render_ranks': [x['ms_per_render'] for x in rk],
               'ms_per_render_one_card': one_ms,
               'pairs_one_card': int(ref['num_pairs']),
               'band_pairs': [x['band_pairs'] for x in rk],
               'rows_sent_ranks': [x['rows_sent'] for x in rk],
               'bytes_sent_ranks': [
                   None if x['rows_sent'] is None else
                   4 * 14 * sum(min(n, max(rcfg.pair_capacity // MESH_RANKS,
                                            1024))
                                for n in x['rows_sent']) for x in rk],
               'collective_bytes_per_render_ranks': [
                   x['collective_bytes_per_render'] for x in rk],
               'overflow_ranks': [x['overflow'] for x in rk],
               'max_abs_err': errs, 'equal': equal,
               'grad_err_over_max': grad_err,
               'render_launches_ranks': [x['render_launches'] for x in rk],
               'render_and_backward_launches_ranks': [
                   x['render_and_backward_launches'] for x in rk],
               'tile_h8_kernels': kernels_h8}
        emit(rec)
        want_r = {k.name: SHARDED_RENDERS if k is tile_blend_fwd else 0
                  for k in KERNELS}
        want_g = {k.name: 1 if k in (tile_blend_fwd, tile_blend_bwd) else 0
                  for k in KERNELS}
        if max(errs.values()) > SHARDED_TOL or not all(equal.values()) or \
                max(grad_err.values()) > SHARDED_GRAD_TOL or \
                bool(ref['overflow']) or any(x['overflow'] for x in rk):
            raise AssertionError(f'sharded_render {name}: {rec}')
        if any(x['render_launches'] != want_r or
               x['render_and_backward_launches'] != want_g for x in rk):
            raise AssertionError(f'sharded_render {name}: launches {rec}')
        paths[f'{name}_render'] = rk[0]['render_and_backward_launches']
    return paths


def tile_h8_kernels(g: GaussianInputs, view, rcfg) -> dict:
    """Kernels #1 and #2 at ``rcfg``'s tile height against their plain
    versions on the one-card render's inputs (random cotangents for #2):
    the forward's max abs error, the backward's worst error over each
    column group's max."""
    with torch.no_grad():
        inp = prepare_blend(g, view, rcfg)
        b = inp.binned
        args = (inp.geo, inp.col, b.sort_gauss, b.tile_start, b.tile_count)
        c, a = tile_blend_fwd.launch(*args, rcfg)
        pc, pa = tile_blend_fwd.plain(*args, rcfg)
        gen = torch.Generator('cuda').manual_seed(SEED)
        gc = torch.randn(c.shape, generator=gen, device='cuda')
        ga = torch.randn(a.shape, generator=gen, device='cuda')
        rows = tile_blend_bwd.launch(*args, c, a, gc, ga, rcfg)
        prows = tile_blend_bwd.plain(*args, pc, pa, gc, ga, rcfg)
        torch.cuda.synchronize()
    fwd = max(float((c - pc).abs().max()), float((a - pa).abs().max()))
    bwd = {k: float((rows[:, s] - prows[:, s]).abs().max()
                    / prows[:, s].abs().max().clamp(min=1e-30))
           for k, s in GROUPS.items()}
    if fwd > KERNEL_TOL or max(bwd.values()) > BWD_TOL:
        raise AssertionError(f'kernels at tile_h {rcfg.tile_h} disagree '
                             f'with their plain versions: {fwd}, {bwd}')
    return {'tile_h': rcfg.tile_h, 'pairs': int(b.num_pairs),
            'fwd_max_abs_err': fwd, 'bwd_err_over_max': bwd}


# the CLI's mesh phases: (the sets of every run, the mesh's set, views a
# step): the view axis at batch_views 2, and the gs axis at tile_h 8 (the
# smoke config's 48 pixels are 3 tile rows at 16)
CLI_MESHES = {
    'cli_train_parallel': (('train.batch_views=2',),
                           'train.parallel={"n_view": 2, "n_gs": 1}', 2),
    'cli_train_gs': (('raster.tile_h=8',),
                     'train.parallel={"n_view": 1, "n_gs": 2}', 1)}


def cli_parallel_argv(phase: str, out: Path, data: Path,
                      parallel: bool) -> list:
    sets, mesh, _ = CLI_MESHES[phase]
    sets = list(sets) + ([mesh] if parallel else [])
    dev = ['--device', 'cuda:0', '--dist-backend', 'gloo'] if parallel \
        else ['--device', 'cuda']
    return ['-c', CLI_SMOKE, *dev, '--set', f'output_dir={out}',
            f'dataset.root={data}', *sets]


def worker_cli_train(phase: str, tmp: Path, rank: int) -> dict:
    """A rank of ``phase`` (``cli_train_parallel``, ``cli_train_gs``):
    ``cli.train``'s main, its own output directory."""
    _, launches, secs = cli_run(cli_train.main, cli_parallel_argv(
        phase, tmp / f'rank{rank}', tmp / 'data', True))
    return {'launches': launches, 'seconds': secs}


CLI_PARALLEL_CKPTS = ('init.npz', 'checkpoint_00000100.npz', 'sk_init.npz',
                      'last.npz')
# the checkpoints before the skeleton initialisation, whose MST (and the
# frozen LBS's KNN) decide near-ties by the last bits that the backward
# kernels' atomics leave to chance on the card
CLI_PARALLEL_HELD = ('init.npz', 'checkpoint_00000100.npz')
CLI_PARALLEL_EXACT = ('alive', 'sp_alive', 'joint_parents')


def lr_sums(trainer: SKGSTrainer, flat: dict) -> dict:
    """Each leaf's learning rates summed over the steps a checkpoint
    ``flat`` of ``trainer``'s run has taken, with the Adam steps of the
    skeleton initialisation's loops on the leaves they train once it
    has run."""
    out = {}
    for step in range(1, step_of(flat) + 1):
        for k, v in trainer.lr_trees(step).items():
            out[k] = out.get(k, 0.0) + v
    if bool(flat['state/flags/skeleton_initialized']):
        loop = sk_gs_ops.INIT_LR * min(trainer.cfg.joint_init_steps,
                                       INIT_SKELETON_MAX_STEPS)
        for k in out:
            if k.split('/')[0] in sk_gs_ops.DISTILL_LEAVES + ('joint_pos',):
                out[k] += loop
    return out


def ckpt_agreement(got: dict, ref: dict, lrs: dict) -> dict:
    """Two checkpoints of one step: the parameters' worst error over 2 lr
    a step plus 1e-5 of the leaf (the parameter bar where gradients are
    not recorded), and the differing entries of the alive slots, the
    superpoints and the tree."""
    worst, leaf = 0.0, None
    for name, lr in lrs.items():
        g = got['state/model/params/' + name]
        r = ref['state/model/params/' + name]
        err = float(np.abs(g - r).max()) / (
            2 * lr + 1e-5 * float(np.abs(r).max()) + 1e-30)
        if err > worst:
            worst, leaf = err, name
    return {'step': step_of(ref), 'param_worst_over_tol': worst,
            'param_worst_leaf': leaf,
            'differing_entries': {k: int(np.sum(
                got['state/model/' + k] != ref['state/model/' + k]))
                for k in CLI_PARALLEL_EXACT}}


def held(rec: dict) -> bool:
    return rec['param_worst_over_tol'] <= 1.0 and \
        not any(rec['differing_entries'].values())


def phase_cli_train_parallel(tmp: Path,
                             phase: str = 'cli_train_parallel') -> dict:
    """``cli.train`` on configs/synthetic_smoke.yaml, the whole schedule,
    over 2 gloo ranks on this card (each rank its own output directory):
    ``cli_train_parallel`` at batch_views 2 on ``train.parallel.n_view`` 2
    (a view a rank), ``cli_train_gs`` at tile_h 8 on ``n_gs`` 2 (half the
    capacity and a band a rank); against one process of the same sets, and
    that process run again (its twin). At each
    checkpoint both write, the parameters within 2 lr a step plus 1e-5 of
    each leaf (the skeleton initialisation's Adam steps included) and the
    alive slots, the superpoints and the tree equal: held for the ranks
    at init.npz, and at step 100 where the twin holds it; reported from
    the skeleton initialisation on (its MST and KNN break near-ties by
    last bits, which the backward kernels' atomics leave to chance on the
    card: the twin of one process and the ranks each part there in some
    runs; the CPU test holds the whole run bit for bit). Rank 1 writes
    nothing; #1 once a
    step on each rank (and on rank 0 once a view of the ground truth and
    of each evaluation), #2 once a step but the ``sk_init`` steps'."""
    sets, _, k = CLI_MESHES[phase]
    cfg = make_config(CLI_SMOKE, list(sets))
    ranks = spawn_ranks(phase, MESH_RANKS, tmp)
    _, launches, secs = cli_run(cli_train.main, cli_parallel_argv(
        phase, tmp / 'one', tmp / 'data_one', False))
    _, _, twin_secs = cli_run(cli_train.main, cli_parallel_argv(
        phase, tmp / 'twin', tmp / 'data_one', False))
    exp = cfg['exp_name']
    ckpt = lambda run, name: load_ckpt(tmp / run / exp / 'checkpoints' / name)
    run_cfg = make_config(str(tmp / 'one' / exp / 'config.yaml'))
    scene, meta, _, _ = build.build_scene(run_cfg, 'cuda')
    skcfg, rcfg = build.build_model_cfg(run_cfg, meta, scene.image_size)
    agree = {'ranks': {}, 'twin': {}}
    for name in CLI_PARALLEL_CKPTS:
        ref = ckpt('one', name)
        tr = SKGSTrainer(skcfg, rcfg, scene, meta, convert.model_from_flat(
            ref, skcfg, rcfg, device='cuda', trainable=True), device='cuda')
        lrs = lr_sums(tr, ref)
        agree['ranks'][name] = ckpt_agreement(ckpt('rank0', name), ref, lrs)
        agree['twin'][name] = ckpt_agreement(ckpt('twin', name), ref, lrs)
    sched = cfg['train_schedule']
    steps = sum(sched.values())
    views = cfg['dataset']['num_frames']
    evals = steps // cfg['train']['eval_interval'] + (
        steps % cfg['train']['eval_interval'] > 0) + 1
    bwd = steps - sched['sk_init']
    want = [{tile_blend_fwd.name: steps + views * (1 + evals) * (r == 0),
             tile_blend_bwd.name: bwd, chunk_blend_fwd.name: 0,
             chunk_blend_bwd.name: 0} for r in range(MESH_RANKS)]
    want_one = {tile_blend_fwd.name: k * steps + views * (1 + evals),
                tile_blend_bwd.name: k * bwd, chunk_blend_fwd.name: 0,
                chunk_blend_bwd.name: 0}
    rank1_files = files_under(tmp / 'rank1') if (tmp / 'rank1').exists() \
        else {}
    held_at = [n for n in CLI_PARALLEL_HELD
               if n == 'init.npz' or held(agree['twin'][n])]
    rec = {'phase': phase, 'backend': 'gloo', 'sets': list(sets),
           'ranks': MESH_RANKS, 'steps': steps,
           'seconds_ranks': [r['seconds'] for r in ranks],
           'seconds_one_process': secs, 'seconds_twin': twin_secs,
           'ms_per_step_by_stage_ranks': ms_by_stage(tmp / 'rank0' / exp),
           'ms_per_step_by_stage_one_process': ms_by_stage(tmp / 'one' / exp),
           'agreement_ranks': agree['ranks'],
           'agreement_twin': agree['twin'], 'held_at': held_at,
           'launches_ranks': [r['launches'] for r in ranks],
           'launches_one_process': launches,
           'files_rank0': sorted(files_under(tmp / 'rank0')),
           'files_rank1': sorted(rank1_files)}
    emit(rec)
    if not all(held(agree['ranks'][n]) for n in held_at) or rank1_files or \
            (tmp / 'rank1').exists():
        raise AssertionError(f'{phase}: {rec}')
    if [r['launches'] for r in ranks] != want or launches != want_one:
        raise AssertionError(f'{phase}: launches {rec}, expected {want}, '
                             f'{want_one}')
    return {phase: ranks[0]['launches']}


def tally_collectives() -> dict:
    """Wrap ``collectives._run`` in this rank process: the bytes this rank
    sends, by the collective that sent them ('reduce', 'gather',
    'exchange', 'broadcast_from'), added into the returned dict."""
    tally, run = {}, coll._run

    def counted(x, fn):
        kind = fn.__qualname__.split('.')[0].lstrip('_')
        tally[kind] = tally.get(kind, 0) + x.numel() * x.element_size()
        return run(x, fn)
    coll._run = counted
    return tally


def record_bands() -> dict:
    """Wrap the exchange render's preprocess and band in this rank
    process: each preprocess's splat rects and radii ('rects': [N / G, 5]
    rows of rect_min, rect_max, radius, on the host), each band render's
    pairs ('pairs') and rows sent to each rank ('sent'), and the last band
    blend's inputs ('inputs': binned, geo, col, band config)."""
    rec = {'rects': [], 'pairs': [], 'sent': [], 'inputs': None}
    prep, blend = mesh_trainer_mod.preprocess, sharded_render.blend_tiles
    band = mesh_trainer_mod.exchange_render_band

    def prep_recorded(*args, **kw):
        pre = prep(*args, **kw)
        rec['rects'].append(splat_rects(pre))
        return pre

    def blend_recorded(binned, geo, col, bcfg):
        rec['inputs'] = (binned, geo.detach(), col.detach(), bcfg)
        return blend(binned, geo, col, bcfg)

    def band_recorded(*args, **kw):
        out = band(*args, **kw)
        rec['pairs'].append(out[3].num_pairs)
        rec['sent'].append(out[4])
        return out
    mesh_trainer_mod.preprocess = prep_recorded
    sharded_render.blend_tiles = blend_recorded
    mesh_trainer_mod.exchange_render_band = band_recorded
    return rec


def splat_rects(pre) -> torch.Tensor:
    """Each splat's tile rect and radius, [N, 5] int32 on the host: what
    decides which (splat, tile) pairs a render lists."""
    return torch.cat([pre.rect_min, pre.rect_max, pre.radius[:, None]],
                     -1).to(torch.int32).cpu()


def band_kernels(binned, geo, col, bcfg) -> dict:
    """The band's forward and backward kernels (#1/#2, or #3/#4 on the
    chunk schedule) against their plain versions on a band blend's inputs
    (random cotangents for the backward): the forward's max abs error, the
    backward's worst error over each column group's max."""
    inp = types.SimpleNamespace(binned=binned, geo=geo, col=col)
    fwd, bwd, args, _ = schedule_kernels(inp, bcfg)
    with torch.no_grad():
        c, a = fwd.launch(*args, bcfg)
        pc, pa = fwd.plain(*args, bcfg)
        gen = torch.Generator('cuda').manual_seed(SEED)
        gc = torch.randn(c.shape, generator=gen, device='cuda')
        ga = torch.randn(a.shape, generator=gen, device='cuda')
        rows = bwd.launch(*args, c, a, gc, ga, bcfg)
        prows = bwd.plain(*args, pc, pa, gc, ga, bcfg)
        torch.cuda.synchronize()
    err = max(float((c - pc).abs().max()), float((a - pa).abs().max()))
    bwd_err = {k: float((rows[:, sl] - prows[:, sl]).abs().max()
                        / prows[:, sl].abs().max().clamp(min=1e-30))
               for k, sl in GROUPS.items()}
    if err > KERNEL_TOL or max(bwd_err.values()) > BWD_TOL:
        raise AssertionError(f'{fwd.name} / {bwd.name} on a band disagree '
                             f'with their plain versions: {err}, {bwd_err}')
    return {'forward': fwd.name, 'backward': bwd.name,
            'band_image_height': bcfg.image_height, 'tile_h': bcfg.tile_h,
            'pairs': int(binned.num_pairs), 'fwd_max_abs_err': err,
            'bwd_err_over_max': bwd_err}


def add_launches(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def gs_rank_steps(tmp: Path, rank: int, name: str, family: str, mesh,
                  batch_views: int, steps, tally: dict, bands: dict) -> dict:
    """A rank's ``family`` steps on a mesh with a gs axis (``mesh_trainer``
    with ``band``): each step's record, launches, the collectives' bytes
    a step by kind and the merge's bytes and ms, the band pairs and rows
    sent, peak memory, the replicas' largest difference after the steps,
    and the band kernels against their plain versions. The first step is
    the one held against one process: after it each rank saves the splat
    rects of its views (``<name>_<family>_rects_rank<r>.pt``) and rank 0
    its gradients and model (``<name>_<family>.pt``); the others are
    timed only."""
    tr = mesh_trainer(family, mesh, batch_views, band=True)
    merge_bytes = []
    merges = timed_merges(tr, merge_bytes)
    parts = timed_calls(tr, ('_losses', 'exchange_render', '_update'))
    tally.clear()
    for key in ('rects', 'pairs', 'sent'):
        bands[key].clear()
    torch.cuda.reset_peak_memory_stats()
    recs, grads, launches = mesh_steps(tr, steps[:1])
    held = {'grads': grads, 'flat': convert.model_to_flat(tr.model)}
    rects = list(bands['rects'])
    more, _, more_launches = mesh_steps(tr, steps[1:])
    peak = torch.cuda.max_memory_allocated()
    torch.save(rects, tmp / f'{name}_{family}_rects_rank{rank}.pt')
    if rank == 0:
        torch.save(held, tmp / f'{name}_{family}.pt')
    del grads, held
    out = {'steps': recs + more,
           'launches': add_launches(launches, more_launches),
           'bytes_by_collective_per_step': {k: v / len(steps)
                                            for k, v in tally.items()},
           'merge_bytes': merge_bytes, 'merge_ms': merges,
           'ms_by_part': parts,
           'band_pairs': [int(p) for p in bands['pairs']],
           'rows_sent': [x.tolist() for x in bands['sent']],
           'max_memory_allocated': peak,
           'replica_max_abs_diff': replica_difference(tr),
           'band_kernels': band_kernels(*bands['inputs'])}
    bands['inputs'] = None
    del tr
    torch.cuda.empty_cache()
    return out


def worker_mesh_gs(tmp: Path, rank: int) -> dict:
    """A rank of ``mesh_gs``: each family's steps on the 1 x 2 mesh."""
    mesh = make_mesh(1, MESH_RANKS)
    tally, bands = tally_collectives(), record_bands()
    return {family: gs_rank_steps(tmp, rank, 'mesh_gs', family, mesh, 1,
                                  steps, tally, bands)
            for family, steps in MESH_GS_PLAN}


def worker_mesh_gs_2x2(tmp: Path, rank: int) -> dict:
    """A rank of ``mesh_gs_2x2``: the sk steps at batch_views 2 on the
    2 x 2 mesh."""
    mesh = make_mesh(*MESH_2X2)
    tally, bands = tally_collectives(), record_bands()
    return {'sk': gs_rank_steps(tmp, rank, 'mesh_gs_2x2', 'sk', mesh,
                                MESH_2X2[0], MESH_2X2_STEPS, tally, bands)}


@contextlib.contextmanager
def blocked_products(n_gs: int):
    """``superpoints.warp_blend_dense`` (the deltas' [N, M] @ [M, 19] LBS
    product, of the sp and sk families) in this process computed on n_gs
    contiguous row blocks, as the ranks of a gs axis compute it on their
    slices: cuBLAS may sum a product of another row count in another
    order, so the one-process step computed whole parts from the ranks'
    in the last bits, which the step's kinks (the l1 loss at a pixel
    rendered at its target, the alpha clamp, a splat across a tile
    boundary) carry into whole gradient entries."""
    whole = superpoints.warp_blend_dense

    def blocked(points, spT, dense_w, rot_attr, scale_attr):
        parts = [whole(p, spT, w, rot_attr, scale_attr) for p, w in zip(
            points.chunk(n_gs), dense_w.chunk(n_gs))]
        return tuple(torch.cat(x) for x in zip(*parts))
    superpoints.warp_blend_dense = blocked
    trainer_mod.warp_blend_dense = blocked
    try:
        yield
    finally:
        superpoints.warp_blend_dense = whole
        trainer_mod.warp_blend_dense = whole


def one_process_steps(family: str, steps, batch_views: int, n_gs: int,
                      blocked: bool):
    """One process's ``family`` steps at the gs axis's setup (its products
    row-blocked as the ranks' with ``blocked``): (the records, the held
    first step's gradients, the model after it, its learning rates, the
    splat rects of its views, the launches, peak memory)."""
    tr = mesh_trainer(family, None, batch_views, band=True)
    torch.cuda.reset_peak_memory_stats()
    log = []
    render_mod = sys.modules[render.__module__]
    with contextlib.ExitStack() as stack:
        if blocked:
            stack.enter_context(blocked_products(n_gs))
        with recorded(render_mod, 'preprocess', log):
            recs, grads, launches = mesh_steps(tr, steps[:1])
        rects = [splat_rects(out) for _, out in log]
        del log
        flat = convert.model_to_flat(tr.model)
        lrs = tr.lr_trees(steps[0])
        more, _, more_launches = mesh_steps(tr, steps[1:])
    peak = torch.cuda.max_memory_allocated()
    del tr
    torch.cuda.empty_cache()
    return (recs + more, grads, flat, lrs, rects,
            add_launches(launches, more_launches), peak)


def rects_differing(one_rects, tmp: Path, name: str, family: str,
                    shape) -> int:
    """Live splats whose tile rect or radius in some view of the held step
    differs between one process (``one_rects``, a view each) and the ranks
    (rank (v, g) holds slice g of view v's rows)."""
    n_view, n_gs = shape
    ranks = [torch.load(tmp / f'{name}_{family}_rects_rank{r}.pt')
             for r in range(n_view * n_gs)]
    rows = torch.zeros(one_rects[0].shape[0], dtype=torch.bool)
    for v, one in enumerate(one_rects):
        got = torch.cat([ranks[v * n_gs + g][0] for g in range(n_gs)])
        rows |= (got != one).any(-1)
    return int(rows.sum())


def gs_phase_records(name: str, ranks, tmp: Path, plan, batch_views: int,
                     ranks_s: float, shape) -> dict:
    """Each family of ``plan`` on one process at ``batch_views`` (the gs
    axis's setup) against the ranks' run of it: a record each (emitted),
    raising when the ranks' first step misses a bar against the one
    process whose products are row-blocked as the ranks' (``blocked_
    products``), on the leaves where a twin of that run holds itself
    (``twin_unheld``; the others and the plain one process's errors and
    splat rects are reported), a replica differs, a band overflows or the
    launches are not each blend kernel of the schedule once a view a
    step. Returns rank 0's launches by path."""
    paths = {}
    for family, steps in plan:
        got = torch.load(tmp / f'{name}_{family}.pt', weights_only=False)
        rk = [r[family] for r in ranks]
        runs = {run: one_process_steps(family, steps, batch_views,
                                       shape[1], run != 'plain')
                for run in ('plain', 'blocked', 'twin')}
        one_launches = [r[5] for r in runs.values()]
        recs, launches, peak = (runs['plain'][k] for k in (0, 5, 6))
        unheld = twin_unheld(family, (runs['twin'][1], runs['twin'][2]),
                             (runs['blocked'][1], runs['blocked'][2],
                              runs['blocked'][3]))
        against = {}
        for run in ('plain', 'blocked'):
            r_recs, r_grads, r_flat, r_lrs, r_rects = runs[run][:5]
            against[run] = against_one_process(
                family, rk[0]['steps'][:1], got, r_recs[:1], r_grads, r_flat,
                r_lrs, unheld if run == 'blocked' else None)
            against[run][0]['rects_differing'] = rects_differing(
                r_rects, tmp, name, family, shape)
        del got, runs
        agree, held_one = against['blocked']
        fwd, bwd = (chunk_blend_fwd, chunk_blend_bwd) if family == 'init' \
            else (tile_blend_fwd, tile_blend_bwd)
        n = len(steps)
        views = batch_views // shape[0]
        want_rank = {k.name: n * views if k is fwd or (
            k is bwd and family != 'sk_init') else 0 for k in COUNTED}
        want_one = {k: v * shape[0] for k, v in want_rank.items()}
        warm = lambda xs: sum(xs[1:]) / len(xs[1:])
        overflow = [bool(s['overflow']) for r in rk for s in r['steps']] + \
            [bool(s['overflow']) for s in recs]
        rec = {
            'phase': name, 'family': family, 'backend': 'gloo',
            'mesh': {'view': shape[0], 'gs': shape[1]},
            'batch_views': batch_views, 'device': 'cuda:0, every rank',
            'steps': list(steps), 'held_step': steps[0],
            'ranks_seconds': ranks_s, 'tile_h': SHARDED_TILE_H,
            'pair_capacity': SHARDED_PAIR_CAPACITY,
            'ms_ranks': [[s['ms'] for s in r['steps']] for r in rk],
            'ms_one_process': [s['ms'] for s in recs],
            'ms_per_step_ranks': [warm([s['ms'] for s in r['steps']])
                                  for r in rk],
            'ms_per_step_one_process': warm([s['ms'] for s in recs]),
            'merge_ms_per_step_ranks': [warm(r['merge_ms']) for r in rk],
            'merge_bytes_per_step': rk[0]['merge_bytes'][-1],
            'bytes_by_collective_per_step_ranks': [
                r['bytes_by_collective_per_step'] for r in rk],
            'band_pairs_ranks': [r['band_pairs'] for r in rk],
            'pairs_one_process': [s['num_pairs'] for s in recs],
            'pairs_ranks': [s['num_pairs'] for s in rk[0]['steps']],
            'rows_sent_ranks': [r['rows_sent'] for r in rk],
            'max_memory_allocated_ranks': [r['max_memory_allocated']
                                           for r in rk],
            'max_memory_allocated_one_process': peak,
            'launches_ranks': [r['launches'] for r in rk],
            'launches_one_process': launches,
            'band_kernels_ranks': [r['band_kernels'] for r in rk],
            'loss_ranks': [s['loss'] for s in rk[0]['steps']],
            'loss_one_process': [s['loss'] for s in recs],
            'ms_by_part_ranks': [r['ms_by_part'] for r in rk],
            'against_blocked_one_process': agree,
            'twin_unheld': {'steps': unheld[0], 'params': unheld[1]},
            'against_plain_one_process': against['plain'][0],
            'overflow': any(overflow),
            'replica_max_abs_diff_ranks': [r['replica_max_abs_diff']
                                           for r in rk]}
        emit(rec)
        if not held_one or any(overflow) or agree['rects_differing']:
            raise AssertionError(f'{name} {family}: the ranks differ from '
                                 f'one process: {rec}')
        if any(r['launches'] != want_rank for r in rk) or \
                any(x != want_one for x in one_launches):
            raise AssertionError(f'{name} {family}: launches {rec}, '
                                 f'expected {want_rank}, {want_one}')
        if any(r['replica_max_abs_diff'] != 0 for r in rk):
            raise AssertionError(f'{name} {family}: replicas differ: {rec}')
        paths[f'{name}_{family}'] = rk[0]['launches']
    return paths


def phase_mesh_gs(tmp: Path) -> dict:
    """The trainer's gs axis: 2 gloo ranks on this card on a 1 x 2 mesh,
    each computing half of the 100,352 slots and a band of 25 tile rows
    (tile_h 8, pair capacity 2^21), against one process at the same setup
    from one state, 2 steps of each family (init on the chunk schedule:
    #3/#4 in a band; sp on a rebuilt smooth-loss KNN; sk_init with its LBS
    frozen; sk), the first held at ``train_reference``'s bars against one
    process whose LBS products are row-blocked as the ranks', wherever a
    twin run of it holds itself (``twin_unheld``; reported against the
    plain one process), replicas equal to the last bit, no overflow; each
    rank's band kernels against their plain versions on its last band's
    inputs."""
    t0 = time.perf_counter()
    ranks = spawn_ranks('mesh_gs', MESH_RANKS, tmp)
    return gs_phase_records('mesh_gs', ranks, tmp, MESH_GS_PLAN, 1,
                            time.perf_counter() - t0, (1, MESH_RANKS))


def phase_mesh_gs_2x2(tmp: Path) -> dict:
    """Both axes together: 4 gloo ranks on this card on a 2 x 2 mesh, 2 sk
    steps at batch_views 2 (a view a column, a band a row), against one
    process at batch_views 2, as ``mesh_gs``."""
    t0 = time.perf_counter()
    world = MESH_2X2[0] * MESH_2X2[1]
    ranks = spawn_ranks('mesh_gs_2x2', world, tmp)
    return gs_phase_records('mesh_gs_2x2', ranks, tmp,
                            (('sk', MESH_2X2_STEPS),), MESH_2X2[0],
                            time.perf_counter() - t0, MESH_2X2)


def phase_mesh(model, view, t) -> dict:
    """The mesh phases in one temporary directory; returns their launches
    by path (rank 0's)."""
    torch.cuda.empty_cache()
    paths = {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_mesh_') as d:
        tmp = Path(d)
        sub = tmp / 'sharded'
        sub.mkdir()
        paths.update(phase_sharded_render(model, view, t, sub))
        for name, fn in (('view', phase_mesh_view),
                         ('nccl1', phase_mesh_nccl1),
                         ('cli', phase_cli_train_parallel),
                         ('gs', phase_mesh_gs),
                         ('gs_2x2', phase_mesh_gs_2x2),
                         ('cli_gs', functools.partial(
                             phase_cli_train_parallel,
                             phase='cli_train_gs'))):
            sub = tmp / name
            sub.mkdir()
            paths.update(fn(sub))
    return paths


WORKERS = {'mesh_view': worker_mesh_view, 'mesh_nccl1': worker_mesh_nccl1,
           'sharded_render': worker_sharded_render,
           'mesh_gs': worker_mesh_gs, 'mesh_gs_2x2': worker_mesh_gs_2x2,
           **{phase: functools.partial(worker_cli_train, phase)
              for phase in CLI_MESHES}}


def run_worker(name: str, tmp: Path) -> int:
    """A rank process of a mesh phase: the process group from the env
    (NCCL for ``mesh_nccl1``, gloo on this card otherwise), the worker,
    its result written to ``tmp/<name>_rank<r>.json``."""
    torch.cuda.set_device(0)
    if name == 'mesh_nccl1':
        # one rank: init_distributed leaves a group of one process alone
        dist.init_process_group(
            'nccl', init_method='tcp://{MASTER_ADDR}:{MASTER_PORT}'.format(
                **os.environ), world_size=1, rank=0)
        rank = 0
    else:
        rank = init_distributed(backend='gloo')['process_index']
    out = WORKERS[name](tmp, rank)
    (tmp / f'{name}_rank{rank}.json').write_text(json.dumps(out))
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--profile', action='store_true',
                    help='add the stage timing and profiler phase')
    ap.add_argument('--worker', choices=sorted(WORKERS),
                    help='run as a rank of a mesh phase (the script starts '
                    'these itself)')
    ap.add_argument('--tmp', help='the mesh phase\'s directory (--worker)')
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'False); this script runs on the card only', file=sys.stderr)
        return 2
    if args.worker:
        return run_worker(args.worker, Path(args.tmp))
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({'phase': 'device', 'name': name,
          'count': torch.cuda.device_count(), 'nvidia_smi': smi,
          'torch': torch.__version__, 'cuda': torch.version.cuda})

    t0 = time.perf_counter()
    infos = build_all([k.library for k in KERNELS]
                      + [preprocess_fwd.library, jpeg.LIBRARY])
    emit({'phase': 'build', 'seconds': time.perf_counter() - t0,
          'libraries': infos})

    cfg, rcfg, train = synthetic_fullscale()
    phase_jpeg(train)
    flat = random_model_flat(cfg, SEED, n_alive=80_000)
    model = convert.model_from_flat(flat, cfg, rcfg, device='cuda')
    views, times = requests(N_REQUESTS, rcfg.image_width,
                            rcfg.image_height, 'cuda')
    bg = torch.ones(3, device='cuda')

    rows = [phase_kernel(model, views[0], times[0])]
    chunk_row = phase_kernel(model, views[0], times[0], schedule='chunk')
    phase_kernel_preprocess()
    serve_launches, served_ms = phase_slice(model, views, times, bg)
    phase_reference(SEED, torch.ones(3))

    trainer = fullscale_trainer(cfg, rcfg, train)
    s0 = cfg.stages['sk'][0] + 1
    rows.append(phase_kernel_bwd(trainer, s0))
    train_launches = phase_train(trainer, s0)
    s_next = s0 + 1 + N_STEPS
    phase_grad_path(trainer, s_next)
    phase_train_reference(SEED)
    phase_train_reference_rgba(SEED)

    # the init family on the chunk schedule
    init_rcfg = rcfg._replace(schedule='chunk')
    init_launches, init_trainers, chunk_bwd_row, init_fwd_case = \
        phase_init_train(cfg, init_rcfg, train, args.profile)
    rows += [chunk_row, chunk_bwd_row]
    phase_train_reference_init(SEED)

    # the sp family on the tile schedule
    phase_sp_events(cfg, rcfg, train)
    sp_launches, sp_trainer = phase_sp_train(cfg, rcfg, train)
    s_sp = SP_TRAIN_STEPS[-1] + 1
    phase_grad_path_sp(sp_trainer, s_sp)
    phase_train_reference_sp(SEED)

    # the trainer's options: card against CPU, the regularizers at full
    # width, the bf16 nets
    phase_train_reference_options(SEED)
    sp_extras_launches = phase_sp_extras_train(cfg, rcfg, train)
    init_reg_launches = phase_init_reg_train(cfg, init_rcfg, train)
    init_bf16_launches = phase_init_bf16(cfg, init_rcfg, train)

    # the skeleton initialisation and the sk_init family
    phase_sk_init_event(cfg._replace(joint_init_steps=SK_EVENT_CUT), rcfg,
                        train)
    sk_init_launches = phase_sk_init_train(cfg, rcfg, train)
    phase_train_reference_sk_init(SEED)

    # the entry points, from a config to a checkpoint and back
    cli_paths = phase_clis(CLI_FPS_SWEEP or args.profile)
    # the mesh: the trainer's view and gs axes and the Gaussian-sharded
    # renders, 2 (2 x 2: 4) gloo ranks on this card, and one NCCL rank
    mesh_paths = phase_mesh(model, views[0], times[0])
    if args.profile:
        phase_train_reference_sk_init(SEED, SK_REF_ITERS_LONG,
                                      'profile_reference_sk_init', False)
        phase_profile_sk_init(phase_sk_init_event(
            cfg, rcfg, train, 'profile_sk_init_event'))
        phase_profile(model, views, times, bg, served_ms)
        phase_profile_train(trainer, s_next)
        # kernel #1 on the inputs of the step that profile_bwd then trains
        s_prof = s_next + 9
        sk_case = fwd_case(tile_blend_fwd,
                           step_blend_inputs(trainer, s_prof)[0], rcfg)
        phase_profile_bwd(trainer, s_prof, 'profile_bwd')
        phase_profile_fwd('profile_fwd', tile_blend_fwd, rcfg, {
            'request_0': fwd_case(tile_blend_fwd, request_inputs(
                model, views[0], times[0], rcfg), rcfg),
            f'sk_step_{s_prof}': sk_case})
        phase_profile_fwd('profile_chunk_fwd', chunk_blend_fwd, init_rcfg, {
            'request_0': fwd_case(chunk_blend_fwd, request_inputs(
                model, views[0], times[0], init_rcfg), init_rcfg),
            f'init_populated_step_{INIT_STARTS[1][2][0]}': init_fwd_case})
        # the flagship start past its first event
        s_init = INIT_STARTS[0][2][-1] + 1
        phase_profile_train(init_trainers['flagship'], s_init,
                            phase='profile_train_init')
        phase_profile_bwd(init_trainers['flagship'], s_init + 9,
                          'profile_chunk_bwd')
        phase_profile_train_sp(sp_trainer, s_sp + 1)

    paths = {'serve': serve_launches, 'train': train_launches,
             'train_init': init_launches, 'train_sp': sp_launches,
             'train_sk_init': sk_init_launches,
             'train_sp_extras': sp_extras_launches,
             'train_init_reg': init_reg_launches,
             'train_init_bf16': init_bf16_launches, **cli_paths,
             **mesh_paths}
    for row in rows:
        own = 'train_init' if row['name'].startswith('chunk') else 'train'
        row['launches'] = paths[own][row['name']]
        row['launches_by_path'] = {k: v.get(row['name'], 0)
                                   for k, v in paths.items()}
    emit({'kernels': rows})
    emit({'phase': 'done', 'seconds': time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
