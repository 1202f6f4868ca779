#!/usr/bin/env python3
"""On-card check of the radegs_torch serving and training paths (run from
the repository root on a machine with one CUDA card: ``python3 chip_smoke.py``).

1. Setup: the card's name and power limit; nvcc builds every kernel under
   radegs_torch/csrc (one process per source, all at once).
2. Kernels against their plain versions on the JAX bench's parity scene
   (bench.py:156-180: 2000 Gaussians, 256x256) and off-centre at 250x190
   (empty and ragged tiles). Forward: the kernel at one and at two tiles per
   block bit-identical; against ``blend_forward_torch`` the float
   accumulators within abs 1e-4 (summation order and FMA contraction
   differ) and ``med_pos`` different at no more than 1e-4 of the pixels.
   Backward, with seeded random cotangents on all eight differentiable raw
   outputs: G=1 and G=2 bit-identical, two runs bit-identical, and each
   gradient field within 1e-4 x max |plain| of ``blend_backward_torch``.
3. The serving path at full width, the bench's headline scene (bench.py
   build_scene("100k")): 100k Gaussians at 1600x1200, SH degree 3 with every
   band live, written with ``save_gaussian_ply`` and read back with
   ``load_gaussian_ply`` on the card, the Mip 3D filter over 8 orbit cameras,
   then ``render`` of the 8 views (after 2 warm-up views) at two tiles per
   block and again at one. Per-stage times from CUDA events, peak memory.
4. Converged scale: the bench's dense scene (1.2M surface splats at opacity
   0.8, 1600x1200, max_per_tile 8192, ~8M instances per view), 2 views with
   the instance budget set from the measured demand. Launch counts are set
   to 0 before phase 3 and read after phase 4 (the serving path); every
   view's preprocess is the kernel's (``csrc/preprocess_fwd.cu``: the views
   need no gradient), the plain version's counter does not move.
5. Kernels alone. The preprocess kernel at the dense view 0 against its
   plain version (``ops/preprocess.preprocess_torch``), with and without
   the inverse ray-space covariance: every field the same bits (floats on
   the rows valid on both sides; radius and flags on the active rows), as
   tests/test_torch_preprocess_kernel.py holds it; then alone in CUDA
   graphs beside its bytes bound (``preprocess_bytes``) and the plain
   version's time. Its backward kernel (``csrc/preprocess_bwd.cu``) with
   seeded incoming gradients laid out as a train step's, against autograd
   through the plain version on the card (``preprocess_backward_check``),
   then alone in a CUDA graph beside its bytes bound
   (``preprocess_bwd_bytes``) and autograd's backward, at the view's 2^21
   rows and at the same rows four times over (2^23). The backward against the exact reference renderer
   (``rasterize`` with the kernels vs autograd through
   ``ops.reference.render_reference``, 256 Gaussians at 128x96: maps within
   ABS_TOL, gradients within 1e-4 x max |reference|). Then both blend
   kernels at three shapes: (a) the 100k view 0, (b) the dense view 0
   (early termination), (c) the training shape (``create_from_points`` of
   the 100k scene: opacity 0.1, 3-NN scales, view 0, no tile cut). At each,
   the forward's checks of phase 2, the forward kernel alone in CUDA graphs
   (G=1, G=2 in turns), its whole wrapper call (G=1, G=2, G=2, G=1), its
   plain version once, and the least time the card could take for its work
   (bytes and FP32 operations counted from these inputs, each term at its
   least multiplicity: those of dx alone per (instance, tile column), of dy
   alone per (instance, tile row), the exp only where alpha reaches 1/255;
   beside it the full-gate count, every term per pair); then the
   backward's checks of phase 2 and, alone in CUDA graphs, the walk kernel
   (G=1, G=2; there and back), the segment sum, the wrapper's sort and
   ``pack_aux``, the pair; the whole wrapper call; the plain version once;
   the bound.
6. The training path at full width: ``create_from_points`` on the 100k
   scene's centres (jittered, seeded random colours; the KNN at P = 100k),
   the 8 views rendered from the scene as ground truth, then ``train`` for
   100 iterations (densify from 20 every 20 until 90, opacity reset at 80,
   the depth-normal term from 10) at the configured tiles per block
   (``default_g``); then 2 train steps on the dense scene at G=2 and 2 at
   G=1. Launch counts are set to 0 before and read
   after. Fails unless every loss and parameter is finite, the mean loss of
   iterations 51-60 is below that of 1-10, densify ran 3 times and the
   opacity reset once, Gaussians are left at the end, no instance overflow
   after the autotune settles, and the backward kernel ran once per
   iteration. Per-stage medians from CUDA
   events, host ms per iteration, peak memory.

7. The mesh path at full width, all on the card (launch counts set to 0
   before 7b and read after 7e: the mesh path).
   a. The integrate kernels against their plain versions on both parity
      scenes (radius-only binning, the inverse ray-space covariance; each
      scene a state whose preprocess is ``renderer.prepare``'s, so the
      preprocess kernel makes the integrate kernels' inputs): B5
      (``integrate_image``) and B6 (``integrate_points``, ~20k query points:
      near the splats, in the frustum, outside the image, behind the
      camera). The float rows and ``alpha_integrated`` within abs 1e-4, the
      SDF within 1e-5 x the max depth, ``mid_*`` and the median depth equal
      where the median contributor is the same; each kernel bit-identical
      from run to run.
   b. TSDF at converged scale: ``extract_mesh_tsdf`` of phase 4's 1.2M-splat
      scene over the 8 orbit views (voxel 0.004, ``max_resolution`` 768),
      written with ``write_mesh``; seconds of depth maps, block marking,
      fusion and meshing. Fails unless > 10k faces, the median vertex
      distance to the nearer surface of the scene (sphere r = 1.3, plane
      y = -1.4, each widened by 2 sigma of its noise: opaque splats present
      the noise's outer envelope) is below 0.1, and ``blend_fwd`` ran once
      per view.
   c. Marching Tetrahedra: ``extract_mesh_tetrahedra`` of a 50k-splat surface
      scene (``surface_points(50_000)``, KNN scales, opacity 0.8; cut from
      1.2M because scipy's host Delaunay dominates), 8 views,
      ``n_binary_steps=8``, ``decimate="auto"``; seeds, Delaunay seconds,
      cells, crossing edges, faces, the kernels' ms per SDF pass. Fails
      unless the geometric check of 7b holds, ``integrate_image`` ran once
      per view and ``integrate_points`` at least 9 x 8 times.
   d. The kernels alone at the dense view 0 (radius-only binning, budget from
      the measured demand): B5 20 launches, B6 20 launches over 1M jittered
      surface points, then 10 over seeded subsets of 7c's point counts (the
      seeds of its first SDF pass, the crossing edges of each later one);
      each plain version once (B5 on the full view, B6 on a seeded 16k-point
      subset) and each kernel's bound, the least work on these inputs (B5
      gates each tile's 545 distinct samples once, both take the exp only
      where alpha reaches 1/255) and, beside it, the full-gate count (every
      sample of every pixel or point gated, the exp wherever the power test
      passes). The 1M launch must equal the subset's launch bitwise on the
      subset, with tiles of more than 32 points (one work item) and subset
      points in their later work items.
   e. The witness of the geometric checks: the 50k scene of 7c without its
      noise (capacity 2^18, so the default render budget covers the demand).
      TSDF (at max_resolution 384: cut from 7b's 768 for time) and tetra as
      in 7b / 7c, each held to the noise-free surfaces:
      median vertex distance below 0.1 and below 3 splat sigmas of the
      nearer surface. Then ``extract_mesh_unbounded`` (resolution 256;
      median distance below 0.1) and ``cull_mesh`` + ``post_process_mesh``
      of the tetra mesh.

8. The entry points at full width, through the CLIs on a dataset on disk
   (launch counts set to 0 before and read after). A COLMAP dataset is
   written from phase 7e's noise-free 50k-splat scene: 16 orbit views at
   1600x1200 rendered by the port as ground truth (``write_png``), and
   ``sparse/0/{cameras,images,points3D}.bin`` (PINHOLE; the 50k centres
   jittered by N(0, 0.01^2) with seeded colours as points3D). Then, each
   through ``main(argv)``: ``train --eval`` for 300 iterations (one densify
   at 200, no opacity reset; test PSNR at 1 and 300, PLYs at 150 and 300,
   a checkpoint at 150), ``train --start_checkpoint`` to 200, ``train
   --use_decoupled_appearance`` for 50 iterations, ``mesh_extract
   --max_resolution 384`` and ``mesh_extract_tetrahedra``; ``render
   --save_depth --path_frames 8`` as a real subprocess. Fails unless every
   loss is finite, test PSNR rises by 3 dB, the run's files exist, the
   resumed run covers 151-200, the appearance parameters moved and stayed
   finite, every PNG decodes to its shape, both meshes have > 10k faces
   within a median 0.1 of the surfaces (widened by 2 jitter sigmas), and
   the blend and integrate kernels ran. Wall seconds per step.
9. The bisect probes (``radegs_torch/scripts/kernel_bisect.py``, launch
   counts set to 0 before and read after): each of the four kernels of
   ``csrc/bisect_probes.cu`` held to its plain version at the JAX shapes,
   on seeded start / count sets (count 0, unaligned starts, windows ending
   on the last column), on steps that leave the matrix (NaN on the same
   steps) and on the long-run set (steps of 0, 1, 3, 4, 5 and 64 windows in
   25 x 8192: the ring's refills and phase flips), bit-identical run to run
   (a sha256 of the outputs printed, to compare two checkouts), timed alone
   in CUDA graphs of 100 launches in turns with the launch-and-store floor
   (``floor_ms``: ``fill_`` of the (T, 8, 256) output, the least a launch
   that writes it takes), against its plain version, a library call (also
   in a graph) and its bound, and per wrapper
   call from the host (``call_ms``, with the host cost of each piece of a
   wrapper call); then ``window`` at the run layout of the dense view 0
   against its bytes bound, beside the bytes it asks for, the same steps
   with the longest runs first, ``torch.sum`` over the matrix, and the
   kernel built with other ring depths (``WINDOW_VARIANTS``; also timed at
   the JAX shapes).
10. Evaluation, on phase 8's outputs (launch counts set to 0 before and read
   after; runs before phase 9).
   a. LPIPS at 1600x1200 (``eval.lpips.load_weights`` of seeded random
      weights, tests/test_lpips.py's recipe, written as a ``.npz``) of the
      first test render against its gt: float32 on the card within rel 1e-4
      of the same module in float64, the same bits with TF32 allowed by the
      caller and from run to run; ms per pair (CUDA events, median of 5)
      against its FP32 convolution FLOPs over the card's peak; peak memory.
   b. ``python -m radegs_torch.scripts.metrics --lpips_weights`` as a
      subprocess: ``results.json`` with SSIM / PSNR / LPIPS, its PSNR within
      0.5 dB of the train CLI's test PSNR (the 8-bit PNG round trip), view
      0's LPIPS that of 10a; s per view.
   c. Phase 8's TSDF mesh on synthetic ground truth of the noise-free scene
      (samples 0.01 apart on the sphere and the plane square), each CLI
      through ``main(argv)``: ``cull_mesh`` (a TNT ``.log`` of the 16
      cameras, >= 2 views); ``eval_tnt`` (a crop volume, tau = 3 x the
      plane's splat sigma): its precision within 0.02 of the share of its
      estimated points (ICP-transformed, cropped, downsampled) within tau of
      the surfaces; ``eval_dtu`` on a DTU layout (ObsMask all true over the
      bounding box, a Plane keeping everything, the stl cloud, the dataset's
      cameras as ``Calibration/cal18/pos_*.txt``; density 0.02, patch 0.5,
      max_dist 0.3): ``mean_d2s`` within the stl spacing above the
      analytic distance of the same samples, ``overall`` under 3 splat sigmas
      of the nearer surface; ``evaluate_dtu_mesh``: the Procrustes transform
      the identity within 1e-4. Wall seconds of each CLI and the stages of
      ``evaluate_dtu`` / ``evaluate_tnt``.
   d. ``train --ip`` for 30 iterations on phase 8's dataset with a client
      thread speaking the SIBR protocol: 40 keep-alive requests of a 320x240
      view (one frame an iteration while it trains, then frames of the final
      state), then one without keep-alive; the last frame equals ``render`` of
      the state the CLI returns at the same camera and scaling modifier,
      quantised the same way, and the CLI returns.

11. Quality and soak at schedule, cut in depth (launch counts set to 0
   before 11a and read after it: the quality path).
   a. ``radegs_torch.scripts.quality_dense.main`` at full width: the
      closed-form sphere + plane scene (``radegs_torch/scripts/synthetic.py``,
      noise 0),
      600k points, 16 orbit views (12 train / 4 test), 300 iterations
      (cut from 30k: no densify, which starts at 500), evals at 1, 150 and
      300, both meshes (TSDF at voxel 0.004, clamped to 768^3; tetra with
      the 1-sigma seed dedup) scored against the analytic surfaces. Prints
      it/s by bucket, the step's CUDA-event stage medians, peak memory,
      each extractor's stage seconds and the launches of the blend and
      integrate kernels. Fails unless the report is whole (not partial),
      no NaN and no work dropped, test PSNR at 300 at least 1 dB above
      that at 1, and each mesh has > 10k faces and ``overall`` < 0.05
      (2.5x the training state's jitter sigma).
   b. ``soak_dense.main`` at 600k points, 12 views, 400 iterations without
      meshes: sustained it/s and rays/s over the last quarter, the final
      capacity, peak memory. Fails unless the final PSNR is finite.
   c. ``decimation_sweep.main`` at its own default scale (40k points,
      400x300, 6 views), settings ``1.0`` and ``auto``:
      seeds, Delaunay and SDF-pass seconds, and ``verts`` and ``overall``
      beside ``DECIM_SWEEP_R4_CPU.json`` (the JAX record of the same seeds
      and scale; a difference past 2% / 5% is printed as a finding, not
      failed).
12. Multi-rank training (``radegs_torch/parallel``) on phase 6's 100k
   training scene (launch counts set to 0 before and read after, on every
   rank). a. World 1 under NCCL in this process: one multi-rank step of
   view 0 against the single-rank step from the same state (the Adam first
   moments, 0.1 g from zero moments, and the two screen-gradient statistics
   within 1e-4 x max |.| of each; the loss within rel 1e-5), and both
   steps timed in turns. b. World 2 under gloo, both ranks on card 0 (NCCL
   lets no two ranks share a card; the collectives stage through host
   memory): two bands of 38 tile rows (1216 padded rows), the same gates,
   and on every rank of (a) and (b) B3 and B4 fed that rank's band (its
   binning of the gathered rows, the full image's ``ndc_size``) held to
   their plain versions (forward ABS_TOL, backward 1e-4 x max |plain|),
   then 20 iterations of ``train(mesh=)`` with one densify (at 10): loss
   finite and falling, no gather overflow at the end, the blend kernels at
   G = 2 launched on both ranks. Prints ``n_vis``, ``gather_rows``,
   ``full_gather_rows`` and the ms per iteration of the 2 ranks
   time-sharing one card (no scaling figure). The kernels line gives each
   kernel's launches there as ``parallel_launches`` (summed over ranks).
13. The headline bench (``radegs_torch.scripts.bench``, the port of
   ``bench.py``) in this process at full size (launch counts set to 0
   before and read after ``bench.main(["--scene", "both"])``): the 100k
   scene (1600x1200, ``max_per_tile`` 512) with the kernel parity check,
   then the dense scene (1.2M splats, ``create_from_points`` with the KNN
   on the card) settled from the package defaults (``--auto``); then
   ``bench_breakdown`` on the 100k scene. Prints the bench's line and the
   breakdown's, each scene's set-up seconds (outside the timed window),
   settle configurations, step ms, instances and peak memory. Fails unless
   ``kernel_parity_max_err`` <= 1e-4, no timed step drops work, every loss
   is finite, both values are finite and above 0, ``blend_fwd[G=2]`` and
   ``blend_bwd[G=2]`` ran once per step of both scenes (first, settle,
   warm-up, timed) plus once in the parity check, and ``blend_fwd[G=1]`` /
   ``blend_bwd[G=1]`` once each (the parity check). The kernels line gives
   each kernel's launches there as ``bench_launches``.

``python3 chip_smoke.py --bench`` runs only the setup and phase 13.
``python3 chip_smoke.py --quality [WALL_BUDGET_S]`` runs only the setup and
the JAX record's protocol at schedule (``QUALITY_r05.json``: 30k
iterations, evals at 1000, 7000, 15000, 30000, 40 views with every 5th held
out, 600k points), with a checkpoint at ``build/chip_smoke/q30k`` (saved at
each eval and at the wall-budget cut, resumed from when it exists), both
meshes at the end, then the sweep at full scale (600k points, 1600x1200,
settings ``1.0``, ``auto``, ``3.0``; not ``full``, whose Delaunay takes
~5.4M seeds). Reports go to ``build/chip_smoke/``.
``python3 chip_smoke.py --parallel`` runs only the setup, phase 12 (writing
its own 100k scene), ``stress_mesh_growth`` at world 2 (gloo, one card) to its
default target of 1M Gaussians, held to the single-rank loop, and
``bench_scaling`` at worlds 1 and 2 (``--zoom``; world 2 time-shares the
card). The stress report goes to ``build/chip_smoke/``.
``python3 chip_smoke.py --nccl``, on a machine with several cards, runs only
the setup, phase 12 with 12b at one rank a card under NCCL, and
``bench_scaling`` at each power of two up to the card count.
``python3 chip_smoke.py --fwd [CSRC]`` runs only phase 2's forward checks
and the forward at phase 5's three shapes, beside the forward kernel
rebuilt from copies of its source with other constants (``FWD_VARIANTS``)
and, when one is named, another checkout's forward kernel: every output
equal to this tree's bitwise, each launch timed alone in a CUDA graph, this
tree's and the other's at G=2 and G=1 in turns.
``python3 chip_smoke.py --bwd [CSRC]`` runs only phase 2, the reference
check, the fault C1 witness (SSIM through plain ``F.conv2d`` with TF32
allowed) and phase 5's backward shapes, beside the backward kernel
rebuilt from copies of its source with other constants (``BWD_VARIANTS``,
held to the plain version too) or a piece taken out (``BWD_PROBES``,
timed only) and, when one is named, the backward pair built from another
checkout's ``radegs_torch/csrc`` (whose C entry takes ``rank``).
``python3 chip_smoke.py --integrate [CSRC]`` runs only phase 7a and phase
7d (B6 also at SDF_PASS_POINTS, the counts of phase 7c's SDF passes),
beside the integrate kernels rebuilt from copies of their sources with
other constants or a piece taken out (``INTEGRATE_VARIANTS``) and, when
one is named, another
checkout's two integrate kernels and its B6 rebuilt with 32-point work
items: every output equal to this tree's bitwise, each launch timed alone
in a CUDA graph, this tree's and the other's in turns.
``python3 chip_smoke.py --profile`` instead runs the setup and a
torch.profiler pass over both scenes' serving and over 5 training
iterations of the 100k scene (device time by operation, busy share).
``python3 chip_smoke.py --probes [CSRC]`` runs only phase 9 (on the dense
scene it writes and bins as phase 4 does) and, when one is named, beside
another checkout's ``bisect_probes.cu`` (built with ``build.build_copies``;
its C entry takes the same arguments): on every set of phase 9 its
``window`` and ``tri_mm`` must give this tree's bits and its ``aligned``
and ``mm_highest`` stay within ``BISECT_REL_TOL`` of the plain version;
each of its probes joins the turns of this tree's (this tree, the floor,
the other, then back, three times).
``python3 chip_smoke.py --eval`` runs only phase 8 (dataset, train,
render and mesh CLIs) and phase 10.
``python3 chip_smoke.py --train100k`` runs only phase 3's 100k serving at
the configured G and phase 6's 100 iterations of the 100k scene and
``python3 chip_smoke.py --tetra`` only phase 7c: copied into a checkout of
another commit and run there, each compares the two in one call.
``python3 chip_smoke.py --preprocess`` runs only the setup, phases 3-4 with
phase 5's preprocess check, phase 7a (the kernel once per parity scene),
one train step of the dense scene (one forward and one backward launch)
and phase 7b (the kernel once per view); its kernels line holds the
preprocess kernels' three rows alone. In the default run the two rows
(``preprocess_fwd[sh=3,inv=0]`` and ``[sh=3,inv=1]``, the latter with the
inverse ray-space covariance) give the kernel's launches on the serving
path (``launches``) and on the paths of phases 6, 7, 8 and 10
(``train_launches``, ``mesh_launches``, ``cli_launches``,
``eval_launches``) beside 11a, 12b and 13's; a log line gives every SH
degree's launches by path.
``python3 chip_smoke.py --adam`` runs only the setup and the Adam and
statistics kernel (``csrc/adam_stats.cu``) at the train cells' row counts,
2^21 and 2^23 at SH degree 3 (a seeded state mid-training, 70% active):
against the plain chain on the card (every output the same bits), alone in
a CUDA graph beside its bytes bound (1714 B a row), the plain chain's ms a
call, and copies of its source with other constants (``ADAM_VARIANTS``),
each held to its bits and timed in turns with it. The default run does the
same without the copies after phase 13; its kernels line's ``adam_stats``
row gives the kernel's launches on the paths of phases 6, 12b and 13
(``train_launches``, ``parallel_launches``, ``bench_launches``; once an
iteration, checked in 6 and 12b).
``python3 chip_smoke.py --binning`` runs only the setup and the binning
kernels (``csrc/binning.cu`` behind ``ops/binning.bin_gaussians``) at view 0
of the train cells' scenes (the benchmark's 1.2M view at 1600x1200 and its
6.1M view, 2^23 rows, at 1237x822): the lists and counters against the
plain version on the card (the same ints), the count stage (the count
kernel and its scan) and the list stage (the duplicate kernel, the sort,
the ranges kernels) alone in CUDA graphs, the sort alone, the whole call
with its host sync (CUDA events), the plain version's ms a call, and the
bytes bounds, and the same at the demand sweep's budget (2^24, which cuts
the 6.1M view). The default run does the same after the Adam kernel; its
kernels line's ``binning`` row gives the count kernel's launches and the
views the instance budget cut (``budget_path``, which run the count kernel
twice) on every path; phases 3-4 and 6 check that every binning ran the
kernels, and that the served dense views, the dense train steps and the
iterations that did not overflow were not cut.

Every phase that fails raises, and the script exits non-zero without the
result lines. The last three lines are the card's name and power limit, a
JSON object with a ``kernels`` list, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import io
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1600, 1200
N_GAUSS, CAPACITY = 100_000, 131_072
DENSE_N, DENSE_CAPACITY = 1_200_000, 1 << 21
N_VIEWS, WARMUP = 8, 2
# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor cores,
# HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations of blend_fwd.cu, an FMA counted as 2, each at the least
# multiplicity the function allows: a term of dx alone once per (instance,
# tile column), of dy alone once per (instance, tile row), and only what needs
# both per (instance, pixel) pair. The gate: per column 4 (dx, a dx dx, b dx),
# per row 3 (dy, c dy dy), per walked pair 5 (the sum, x -0.5, (b dx) dy, the
# difference, the power test). Its alpha 7 more (~4 for expf, the opacity
# product, the 0.99 clamp, the 1/255 test), which the least walk spends only
# where alpha reaches 1/255 (n_alpha). A blended pair 34 more (transmittance
# 3, weight 1, colour 6, weight sum 1, the dy half of t_ray 2 and its sum 2,
# the dy halves of the coordinate 6 and its sums 6, normal 6, median test 1);
# the dx halves of t_ray (2) and of the coordinate (6) once per (instance,
# column) where a pixel blends. The full-gate count (the bound this script
# reported before the least one) takes all of them per pair and the alpha on
# every walked pair: (4 + 3 + 5 + 7) n_eval + (34 + 8) n_incl.
OPS_GATE_COL, OPS_GATE_ROW, OPS_GATE_PAIR, OPS_ALPHA = 4, 3, 5, 7
OPS_BLEND_PAIR, OPS_BLEND_COL = 34, 8
OPS_GATE = OPS_GATE_COL + OPS_GATE_ROW + OPS_GATE_PAIR
# FP32 operations of blend_bwd.cu, counted per pair: a walked pair the
# same 19 as the forward's full gate (OPS_GATE + OPS_ALPHA); a blended pair
# 125 more (transmittance 3, weight 1, t_ray 4, coord 12, dL/dw 21, prefix 2,
# suffix 2, dL/dalpha 3, median routing 10, the clip gate 2, dL/dG 1, falloff
# products 2, e_x and e_y 8, xy_abs 5, conic 9, opacity 1, rgb 3,
# camera_plane 6, ray_plane 2, normal 3, and 25 adds into the pixel sums);
# the segment sum adds 25 per instance
OPS_BWD_WALKED, OPS_BWD_BLENDED, OPS_BWD_SEGMENT = 19, 125, 25
# FP32 operations of the integrate kernels, counted the same way. Per walked
# pair, the 5 sub-pixel samples' gate: 2 deltas, 9 for the conic form, the
# power test = 12 each, 60 (B5's least walk: 12 at each of a tile's 545
# distinct samples, its 256 centres and 17 x 17 corners, per instance); a
# sample whose power test passes 10 more (~4 for expf, the opacity product,
# the 0.99 clamp, the 1/255 test, 1 - alpha, the T product, the 1e-4 test;
# the least walk: only where alpha reaches 1/255). integrate_image.cu: a
# sample that takes the contributor 5 more (plane depth 4, max 1), a centre
# sample that does 11 (weight 1, colour 6, alpha 1, depth sum 2, median
# test 1).
# integrate_points.cu: a used pair 37 (deltas 2, t_at 4, the ill-conditioned
# test and dz 3, the quadratic form 12 products + 5 sums + 2 scalings, ~4
# for expf, opacity product, clamp, the plane test 2), an included pair 5
# (the 1/255 test, opacity sum 2, transmittance 2)
OPS_SAMPLE, OPS_INT_POWER = 12, 10
OPS_INT_PAIR, TILE_SAMPLES = 5 * OPS_SAMPLE, 256 + 17 * 17
OPS_IMG_TAKEN, OPS_IMG_CENTRE = 5, 11
OPS_PT_USED, OPS_PT_INC = 37, 5
ABS_TOL, MED_POS_TOL = 1e-4, 1e-4
SDF_REL_TOL = 1e-5  # of the max depth
MESH_VIEWS_DIST_TOL = 0.1  # median vertex distance to the scene's surfaces
SHELL_BAND = (0.1, 0.04)  # 2 sigma of surface_points' noise: sphere, plane
# the witness scene (noise-free surfaces): median vertex distance to them in
# splat sigmas of the nearer surface
CLEAN_SIGMA_TOL = 3.0
TETRA_N = 50_000
WITNESS_CAPACITY = 1 << 18  # its default render budget (2^21) covers the demand
WITNESS_TSDF_RES = 384  # the witness TSDF's max_resolution (7b: 768)
BWD_REL_TOL = 1e-4  # of max |plain| per gradient field
# backward pairs built from copies of csrc/blend_bwd.cu with other constants,
# checked and timed beside it at each backward shape by --bwd: pixels per thread,
# instances per round, ring depth, the register cap (tiles resident per SM),
# the segment sum's rows in flight
BWD_VARIANTS = {"K=2": {"K": 2}, "RB=16": {"RB": 16}, "STAGES=2": {"STAGES": 2},
                "MIN_TILES=6": {"MIN_TILES": 6}, "ROW=25": {"ROW": 25},
                "SEG_BATCH=8": {"SEG_BATCH": 8}}
# phase 7c's SDF-pass point counts (the decimated seeds of its first pass, the
# crossing edges of each binary-search step, as a full run of this script
# finds them): --integrate times B6 at them, since it does not run 7c
SDF_PASS_POINTS = (247_815, 130_905)
# integrate kernels built from copies of this tree's sources with other
# constants or with a piece of text replaced, checked and timed beside it by
# --integrate: {label: (kernel, {constant: value} or (old, new))}: the exp
# taken wherever the power test passes (no skip_below), work items (warps) a
# B6 block at the same 32 warps a SM, rows a round, ring depth
NO_SKIP = "-__int_as_float(0x7f800000)"  # -inf: skip_below never skips
INTEGRATE_VARIANTS = {
    "B6 no exp skip": ("integrate_points", ("f[16], sx[k]", f"{NO_SKIP}, sx[k]")),
    "B6 WARPS=8": ("integrate_points", {"WARPS": 8, "MIN_BLOCKS": 4}),
    "B6 RB=16": ("integrate_points", {"RB": 16}),
    "B6 STAGES=3": ("integrate_points", {"STAGES": 3}),
    "B5 no exp skip": ("integrate_image", ("f[12], sx", f"{NO_SKIP}, sx")),
    "B5 RB=32": ("integrate_image", {"RB": 32}),
    "B5 STAGES=2": ("integrate_image", {"STAGES": 2}),
}
# forward kernels built from copies of csrc/blend_fwd.cu with other constants,
# each checked bitwise against the tree and timed beside it at the three
# view-0 shapes by --fwd: pixels per thread (with the register cap of
# MIN_TILES tiles a SM), the register cap, rows a round, ring depth
FWD_VARIANTS = {
    "K=2": {"K": 2, "MIN_TILES": 6}, "K=1": {"K": 1, "MIN_TILES": 4},
    "MIN_TILES=10": {"MIN_TILES": 10}, "RB=16": {"RB": 16},
    "RB=64": {"RB": 64}, "STAGES=2": {"STAGES": 2}, "STAGES=4": {"STAGES": 4},
}
# copies of csrc/blend_bwd.cu with one piece taken out, timed beside it by --bwd (not
# checked: their gradients are wrong by design): the warp reduction replaced
# by a lane's own sum, and the walk cut to its gates (nothing blends)
BWD_PROBES = {
    "no reduction": ("const float s = warp_reduce_scatter(acc, lane);",
                     "float s = 0.0f;\n      for (int c = 0; c < N_GRAD; ++c) s += acc[c];"),
    "gates only": ("if (wb == 0) continue;", "if (wb != 0x7fffffffu) continue;"),
}
# the exact reference renderer's scene (O(H W P) memory) and its tolerance:
# per map abs ABS_TOL, per gradient field REF_REL_TOL x max |reference|
REF_P, REF_W, REF_H = 256, 128, 96
REF_REL_TOL = 1e-4
TRAIN_ITERS = 100
DENSIFY_LOG = (1, 39, 40, 41, 59, 60, 61, 79, 80, 81, TRAIN_ITERS)
DEVICE = "cuda"
# phase 8: the dataset on disk and the CLI runs
DS_VIEWS = 16
DS_JITTER = 0.01  # sigma of the points3D jitter
CLI_ITERS, RESUME_ITERS, APP_ITERS = 300, 200, 50
# one densify inside the run (at 200) and no opacity reset: a reset shortly
# before a densify prunes every Gaussian (ROADMAP.md queue C)
CLI_SCHEDULE = ["--densify_from_iter", "100", "--densification_interval", "100",
                "--densify_until_iter", "250", "--regularization_from_iter", "100",
                "--position_lr_max_steps", str(CLI_ITERS), "--kernel_size", "0.1"]
PSNR_GAIN = 3.0  # dB, test PSNR at 300 over that at 1
# phase 10: evaluation on phase 8's outputs
LPIPS_SEED = 7  # tests/test_lpips.py's random-weight recipe
LPIPS_REL_TOL = 1e-4  # float32 on the card vs float64 on the card
METRICS_PSNR_TOL = 0.5  # dB: the 8-bit PNG round trip against the train CLI's test PSNR
GT_SPACING = STL_SPACING = 0.01  # the synthetic ground truth's sample spacing
DTU_SCAN, DTU_RES = 1, 0.05
# the DTU protocol in the scene's units: phase 8's TSDF mesh (~0.96M vertices,
# edges ~0.015) gets no interior samples at density 0.02, so the radius
# downsample sees its culled vertices, < 1M points; 0.3 = 12 of the sphere's
# splat sigmas
DTU_DENSITY, DTU_PATCH, DTU_MAX_DIST = 0.02, 0.5, 0.3
TNT_PRECISION_TOL = 0.02
VIEWER_ITERS, VIEWER_ALIVE, VIEWER_SCALE = 30, 40, 0.9
VIEWER_W, VIEWER_H = 320, 240
# phase 9: the bisect probes
BISECT_REL_TOL = 1e-5  # x sum |terms| (sums, prefix sum) or x max |plain| (product)
BISECT_SETS = (1, 2)  # seeds of the extra start / count sets
BISECT_OUTSIDE = ([0, -5, 1000, 900], [10, 3, 100, 0])  # NaN: a negative start, past the end
# the long-run set of `window`: steps of 0, 1, 3, 4, 5 and 64 windows in a
# (25, 8192) matrix (a ring of S = 3 or 4 windows, S + 1, and many refills);
# the 64-window step starts unaligned and ends on the last column
LONG_RUN_B, LONG_RUN_WINDOWS = 8192, (0, 1, 3, 4, 5, 64)
LONG_RUN = ([1000, 300, 1100, 2100, 4000, 5], [0, 50, 300, 400, 600, 8187])
# window kernels built beside the one in the source (S = 8), timed with it:
# the other depths of its ring
WINDOW_VARIANTS = {f"S={k}": {"STAGES": k} for k in (2, 3, 4, 6, 12, 16)}

# phase 11: the quality protocol (radegs_torch.scripts.quality_dense) at full
# width with its depth cut: 600k points, 16 views (12 train / 4 test), 300
# iterations (no densify: it starts at 500), both meshes
QUALITY_CUT = ["--n_views", "16", "--eval_every", "4", "--iters", "300",
               "--eval_iters", "1", "150", "300"]
QUALITY_PSNR_GAIN = 1.0  # dB, the last eval's test PSNR over the eval at 1
QUALITY_MIN_FACES = 10_000
QUALITY_OVERALL_TOL = 0.05  # 2.5 x the training state's jitter sigma (0.02)
# the soak at 600k points and 12 views: 400 iterations, so the last quarter's
# rate is taken between two log points (300 and 400)
SOAK_CUT = ["--n_views", "12", "--iters", "400"]
# the sweep at its own default scale (40k points, 400x300, 6 views), beside
# the JAX package's record of the same seeds and scale: "1.0" and "auto"
# ("full" and "3.0" add ~50 s; --quality sweeps at 600k)
SWEEP_SETTINGS = ["1.0", "auto"]
SWEEP_RECORD = "DECIM_SWEEP_R4_CPU.json"
SWEEP_VERTS_DIFF, SWEEP_OVERALL_DIFF = 0.02, 0.05  # a finding past these, not a gate
# --quality: the JAX record's protocol at schedule (QUALITY_r05.json), then
# the sweep at full scale (the JAX script's docstring command) without
# "full" (its Delaunay of ~5.4M seeds)
QUALITY_SCHEDULE = ["--iters", "30000", "--eval_iters", "1000", "7000", "15000", "30000",
                    "--n_views", "40", "--eval_every", "5", "--n_points", "600000"]
SWEEP_FULL_SCALE = ["--n_points", "600000", "--width", "1600", "--height", "1200",
                    "--settings", "1.0", "auto", "3.0"]
# phase 12: multi-rank training on phase 6's 100k scene. One densify (at 10)
# and no opacity reset in PAR_ITERS iterations, the depth-normal term from 5
PAR_ITERS = 20
PAR_OCFG = dict(iterations=PAR_ITERS, densify_from_iter=5, densification_interval=10,
                densify_until_iter=15, opacity_reset_interval=1000, regularization_from_iter=5,
                position_lr_max_steps=PAR_ITERS)
PAR_DENSIFY_AT = 9  # the history's index of iteration 10
PAR_REG_ITER = 10  # the one-step gates start from this iteration (the depth-normal term on)
# the gates against the single-rank step: the Adam first moments after one
# step from zero moments (0.1 g: no sign flips of Adam's update to hide a
# difference) and the screen-gradient statistics within PAR_M1_TOL x max |.|
# of each; the loss within PAR_LOSS_REL
PAR_M1_TOL, PAR_LOSS_REL = 1e-4, 1e-5
PAR_TIMEOUT_S = 600  # the ranks' run and each collective
PAR_TIMED_STEPS = 5


def default_g():
    """The tiles a block of the blend kernels that training and the CLIs use
    (``PipelineConfig.tiles_per_block``; ``render`` defaults to the same)."""
    from radegs_torch.train.config import PipelineConfig

    return PipelineConfig().tiles_per_block


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------ scenes ----


def orbit_cameras(n, device):
    from radegs_torch.core.camera import Camera

    cams = []
    for k in range(n):
        th = 2.0 * math.pi * k / n
        eye = [5.0 * math.sin(th), 0.8, -5.0 * math.cos(th)]
        cams.append(Camera.look_at(eye, [0, 0, 0], [0, 1, 0], 0.9, 0.7, WIDTH, HEIGHT,
                                   device=device))
    return cams


def scene_ply(path, scene, seed=0):
    """Write the bench scene as a reference-format PLY with the port's
    save_gaussian_ply: points and colours from the seed, scales from the
    exact 3-NN spacing (scipy cKDTree), SH degree 3 with small random
    higher bands."""
    from scipy.spatial import cKDTree

    from radegs_torch.core.sh import rgb2sh
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.scripts.synthetic import surface_points

    rng = np.random.default_rng(seed)
    if scene == "dense":
        pts = surface_points(DENSE_N, rng)
        cap, shrink, opacity = DENSE_CAPACITY, 1.0, 0.8
    elif scene == "surface50k":
        pts = surface_points(TETRA_N, rng)
        cap, shrink, opacity = 1 << 16, 1.0, 0.8
    elif scene == "clean50k":
        pts = surface_points(TETRA_N, rng, noise=0.0)
        cap, shrink, opacity = WITNESS_CAPACITY, 1.0, 0.8
    else:
        pts = (rng.normal(size=(N_GAUSS, 3)) * 1.2).astype(np.float32)
        cap, shrink, opacity = CAPACITY, 0.22, 0.1
    n = pts.shape[0]
    cols = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    d2, _ = cKDTree(pts).query(pts, k=4, workers=-1)
    dist2 = np.maximum(np.mean(np.square(d2[:, 1:]), axis=1), 1e-7)
    scales = np.log(np.sqrt(dist2) * shrink)[:, None].repeat(3, axis=1)
    state = gm.state_from_arrays(
        pts, rgb2sh(cols)[:, None, :], rng.normal(size=(n, 15, 3)) * 0.02, scales,
        np.tile([1.0, 0, 0, 0], (n, 1)), np.full((n, 1), math.log(opacity / (1 - opacity))),
        np.ones(n, bool), np.zeros((n, 1)), active_sh_degree=3, device="cpu")
    gm.save_gaussian_ply(path, state)
    return cap


# ------------------------------------------------------------ helpers ----


def compare(kernel, plain):
    """Max abs error over the float accumulators, med_pos mismatch share,
    and the med_t / med_coord error where med_pos agrees."""
    err = 0.0
    for k, v in plain.items():
        if k in ("med_pos", "med_t", "med_coord") or k.startswith("n_"):
            continue
        err = max(err, (kernel[k] - v).abs().max().item())
    same = kernel["med_pos"] == plain["med_pos"]
    flips = 1.0 - same.float().mean().item()
    med_err = max((kernel["med_t"] - plain["med_t"]).abs()[same].max().item(),
                  (kernel["med_coord"] - plain["med_coord"]).abs()[:, same].max().item())
    return err, flips, med_err


def bit_identical(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def same_bits(a, b):
    """Two float32 tensors equal bit for bit, NaN included."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def time_ms(fn, reps, warmup=True):
    if warmup:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps):
    """Device ms per call of ``fn`` with no host time between the calls:
    ``reps`` calls captured in one CUDA graph, replayed once to warm up and
    once between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_bound_ms(binning, table, work, least=True):
    """Least time for the blend's work on these inputs: every input read
    once, every output written once, and the FP32 operations at peak. With
    ``least``, each term at its multiplicity in ``work`` (the gate's dx and
    dy terms per walked (instance, column) and (instance, row), the rest per
    walked pair, the alpha where it reaches 1/255, the blend's dx halves per
    (instance, column) with a blended pixel); else the full-gate count, every
    term per walked or blended pair and the alpha on every walked pair."""
    P = table.shape[0]
    T = binning.tile_count.shape[0]
    n_bytes = (P * 24 * 4 + binning.gauss_id.numel() * 4 + T * 8
               + T * 17 * 256 * 4 + T * 256 * 4)
    n = {k: int(v) for k, v in work.items() if k.startswith("n_")}
    if least:
        ops = (OPS_GATE_COL * n["n_col"] + OPS_GATE_ROW * n["n_row"]
               + OPS_GATE_PAIR * n["n_eval"] + OPS_ALPHA * n["n_alpha"]
               + OPS_BLEND_PAIR * n["n_incl"] + OPS_BLEND_COL * n["n_col_incl"])
    else:
        ops = ((OPS_GATE + OPS_ALPHA) * n["n_eval"]
               + (OPS_BLEND_PAIR + OPS_BLEND_COL) * n["n_incl"])
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), n_bytes, ops


def backward_bound_ms(binning, table, work):
    """Least time for the backward's work on these inputs: features,
    gauss_id, tile ranges, per-tile cotangents + totals (28 rows) and
    med_pos read once; the 25-float instance rows written and read back once,
    with the segment sum's order (N) and ranges (P + 1); the (P, 25) result
    written once. Operations: the walked and blended pairs and the segment
    sum at FP32 peak."""
    P = table.shape[0]
    T = binning.tile_count.shape[0]
    N = binning.gauss_id.numel()
    n_bytes = (P * 24 * 4 + N * 4 + T * 8 + T * 29 * 256 * 4 + 2 * N * 25 * 4 + N * 4
               + (P + 1) * 4 + P * 26 * 4)
    ops = (OPS_BWD_WALKED * int(work["n_eval"]) + OPS_BWD_BLENDED * int(work["n_incl"])
           + OPS_BWD_SEGMENT * N)
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), n_bytes, ops


def random_cotangents(fwd, seed):
    """Seeded standard-normal cotangents of the eight differentiable raw outputs."""
    from radegs_torch.ops import blend

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return {k: torch.randn(fwd[k].shape, generator=gen, device=DEVICE)
            for k in blend.DIFF_KEYS}


def grad_fields(grad):
    """A blend gradient buffer as per-field views: the table's fields, then
    xy_abs (P, 2)."""
    from radegs_torch.core.projection import COLUMNS, column
    from radegs_torch.ops import blend

    return {**{f: column(grad, f) for f in COLUMNS}, "xy_abs": grad[:, blend.XY_ABS:]}


def compare_grads(kernel, plain):
    """Per field of two gradient buffers: max abs error and that error over
    max |plain|."""
    out = {}
    kernel = grad_fields(kernel)
    for k, v in grad_fields(plain).items():
        err = (kernel[k] - v).abs().max().item()
        out[k] = (err, err / max(v.abs().max().item(), 1e-30))
    return out


def check_backward(binning, table, fwd, cot, W, H, label):
    """blend_bwd at G=1 and G=2 bit-identical, two runs bit-identical, each
    field within BWD_REL_TOL of the plain version. Returns the max abs and
    max relative error."""
    from radegs_torch.ops import blend

    b1 = blend.blend_backward(binning, table, fwd, cot, W, H, tiles_per_block=1)
    b2 = blend.blend_backward(binning, table, fwd, cot, W, H, tiles_per_block=2)
    b2r = blend.blend_backward(binning, table, fwd, cot, W, H, tiles_per_block=2)
    torch.cuda.synchronize()
    check(torch.equal(b1, b2), f"{label}: blend_bwd G=1 and G=2 are not bit-identical")
    check(torch.equal(b2, b2r), f"{label}: blend_bwd differs between two runs")
    plain = blend.blend_backward_torch(binning.tile_gauss, table, fwd, cot, W, H)
    errs = compare_grads(b2, plain)
    log(f"{label} backward: G1==G2 and run==rerun bitwise; per field abs err / rel to max "
        "|plain|: " + ", ".join(f"{k} {a:.3e} / {r:.3e}" for k, (a, r) in errs.items()))
    worst = max(r for _, r in errs.values())
    check(worst <= BWD_REL_TOL, f"{label}: backward kernel vs plain rel err {worst}")
    return max(a for a, _ in errs.values()), worst, plain


def bwd_libraries(variants, probes, other=None):
    """Backward pairs (C entry ``radegs_blend_bwd``) built from copies of
    csrc/blend_bwd.cu: with other constants (``variants``: {name: {constant:
    value}}), with a piece of text replaced (``probes``: {name: (old,
    new)}), and, when ``other`` names the csrc directory of another
    checkout, from its blend_bwd.cu as ``other``; all at once
    (``build.build_copies``, into build/chip_smoke/). Prints each build's
    ptxas register and spill lines. Returns {name: (function, checked)}:
    probes are not checked against the plain version."""
    import ctypes

    from radegs_torch.native import build

    src = (build.CSRC / "blend_bwd.cu").read_text()
    copies = {name: (build.with_constants(src, consts), build.CSRC)
              for name, consts in variants.items()}
    for name, (old, new) in probes.items():
        check(old in src, f"backward probe {name}: no {old!r} in blend_bwd.cu")
        copies[name] = src.replace(old, new), build.CSRC
    if other:
        text = open(os.path.join(other, "blend_bwd.cu")).read()
        check("const void* rank," in text, f"{other}/blend_bwd.cu: its C entry takes no rank")
        check("grad_column(" in text, f"{other}/blend_bwd.cu: its segment sum writes the "
              "(P, 25) rows of pallas_blend.py's order, not the table's (P, 26) columns")
        copies["other"] = text, other
    libs = {}
    for name, (lib, out) in build.build_copies(
            copies, os.path.join(ROOT, "build", "chip_smoke", "bwd")).items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas blend_bwd[{name}]: {line.strip()}")
        fn = lib.radegs_blend_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = (fn, name not in probes)
    return libs


class BwdCall:
    """The inputs and outputs of one call of a backward pair, built as
    ``blend.blend_backward`` builds them, to launch the pair, the walk alone
    (num_gauss 0) or the segment sum alone (num_tiles 0) through any
    library's ``radegs_blend_bwd``."""

    def __init__(self, binning, table, fwd, cot, W, H):
        from radegs_torch.ops import blend

        self.T, self.tiles_x = blend._kernel_inputs(binning, table, W, H, 2)
        self.feat = table
        self.P, self.N = self.feat.shape[0], binning.gauss_id.numel()
        self.aux = blend.pack_aux(fwd, cot)
        self.med_pos = fwd["med_pos"].to(torch.int32).contiguous()
        self.rank, self.seg = blend.instance_segments(binning.gauss_id, self.P)
        self.rows = torch.empty((self.N, 32), device=DEVICE)
        self.grad = torch.empty((self.P, blend.GRAD_COLS), device=DEVICE)
        self.binning, self.W, self.H = binning, W, H

    def __call__(self, fn, g=2, walk=True, segment=True):
        b = self.binning
        rc = fn(self.feat.data_ptr(), b.gauss_id.data_ptr(), b.tile_start.data_ptr(),
                b.tile_count.data_ptr(), self.aux.data_ptr(), self.med_pos.data_ptr(),
                self.rank.data_ptr(), self.seg.data_ptr(), self.rows.data_ptr(),
                self.grad.data_ptr(), self.T if walk else 0, self.tiles_x, self.N,
                self.P if segment else 0, self.W, self.H, g,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"backward pair launch failed with CUDA error {rc}")
        return self.grad


def backward_shape(label, binning, table, fwd, cot, W, H, work, libs, reps):
    """One backward shape: ``check_backward`` (G=1 == G=2, run == rerun,
    each field within BWD_REL_TOL of the plain version), every checked
    library of ``libs`` (``bwd_libraries``) held to the plain version too;
    then, each in a CUDA graph of ``reps`` calls (device time alone), the
    walk kernel of the tree at G=1 and G=2 and of every library at G=2 in
    turns (there and back), the segment sum alone (the tree's and another
    checkout's), the wrapper's ``instance_segments`` and ``pack_aux``, and
    the pair (walk + segment sum); the whole wrapper call by CUDA events
    around ``reps`` calls from the host (G=1, G=2, another checkout's; there
    and back); the plain version once; the bound of ``backward_bound_ms`` for
    the pairs ``work`` counts."""
    from radegs_torch.native import build
    from radegs_torch.ops import blend

    bwd_abs, bwd_rel, plain = check_backward(binning, table, fwd, cot, W, H, label)
    call = BwdCall(binning, table, fwd, cot, W, H)
    tree = build.entry("blend_bwd", 10, 7)
    lib_rel = {}
    for name, (fn, checked) in libs.items():
        if checked:
            got = call(fn).clone()
            lib_rel[name] = max(r for _, r in compare_grads(got, plain).values())
            check(lib_rel[name] <= BWD_REL_TOL, f"{label}: backward {name} vs plain rel err "
                  f"{lib_rel[name]}")
    order = [("G=1", tree, 1), ("G=2", tree, 2)] + [
        (name, fn, 2) for name, (fn, _) in libs.items()]
    walk = {}
    for rnd in range(2):
        for name, fn, g in (order if rnd == 0 else order[::-1]):
            walk.setdefault(name, []).append(graph_ms(
                lambda fn=fn, g=g: call(fn, g, segment=False), reps))
    sums = {"tree": tree}
    if "other" in libs:
        sums["other"] = libs["other"][0]
    segment = {name: graph_ms(lambda fn=fn: call(fn, 2, walk=False), reps)
               for name, fn in sums.items()}
    sort_ms = graph_ms(lambda: blend.instance_segments(binning.gauss_id, call.P), reps)
    pack_ms = graph_ms(lambda: blend.pack_aux(fwd, cot), reps)
    pair = {g: graph_ms(lambda g=g: call(tree, g), reps) for g in (1, 2)}
    calls = {g: lambda g=g: blend.blend_backward(binning, table, fwd, cot, W, H,
                                                 tiles_per_block=g) for g in (1, 2)}
    if "other" in sums:
        calls["other"] = other_wrapper(sums["other"], binning, table, fwd, cot, W, H)
    wrapper = {}
    for g in list(calls) + list(calls)[::-1]:
        wrapper.setdefault(g, []).append(time_ms(calls[g], reps))
    plain_ms = time_ms(lambda: blend.blend_backward_torch(binning.tile_gauss, table, fwd, cot,
                                                          W, H), 1)
    bound, bound_by, n_bytes, ops = backward_bound_ms(binning, table, work)
    log(f"{label} backward pieces ({binning.gauss_id.numel()} instances, {int(work['n_eval'])} "
        f"pairs walked, {int(work['n_incl'])} blended; device ms alone in CUDA graphs of "
        f"{reps}): walk kernel " + ", ".join(f"{k} {v}" for k, v in walk.items())
        + "; segment sum " + ", ".join(f"{k} {v:.4f}" for k, v in segment.items())
        + f"; instance_segments {sort_ms:.4f}; pack_aux {pack_ms:.4f}; pair G=1 {pair[1]:.4f}, "
        f"G=2 {pair[2]:.4f}; whole wrapper (host-issued, there and back) "
        + ", ".join(f"{k} {v}" for k, v in wrapper.items())
        + f"; plain {plain_ms:.3f}; bound {bound:.4f} ms by {bound_by} ({n_bytes} bytes, {ops} "
        f"FP32 operations): pair G=2 at {100 * bound / pair[2]:.1f}% of it; checked "
        "libraries vs plain rel " + ", ".join(f"{k} {v:.2e}" for k, v in lib_rel.items()))
    return dict(abs=bwd_abs, rel=max([bwd_rel] + list(lib_rel.values())), walk=walk,
                segment=segment, sort_ms=sort_ms, pack_ms=pack_ms, pair=pair, wrapper=wrapper,
                plain_ms=plain_ms, bound=bound, bound_by=bound_by,
                n_inst=binning.gauss_id.numel())


def other_wrapper(fn, binning, table, fwd, cot, W, H):
    """A call of another checkout's whole backward wrapper at G=2 around its
    pair ``fn``: this checkout's ``blend.blend_backward`` with the entry
    swapped."""
    from radegs_torch.ops import blend

    def swapped():
        entry = blend._entry
        blend._entry = lambda name: fn
        try:
            return blend.blend_backward(binning, table, fwd, cot, W, H, tiles_per_block=2)
        finally:
            blend._entry = entry

    return swapped


def fwd_entry(lib):
    """``radegs_blend_fwd`` of a built library with its ctypes signature
    (another checkout's forward kernel has the same C entry)."""
    import ctypes

    fn = lib.radegs_blend_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fwd_libraries(variants, other=None):
    """Forward kernels (C entry ``radegs_blend_fwd``) built from copies of
    csrc/blend_fwd.cu with other constants (``variants``: {name: {constant:
    value}}) and, when ``other`` names the csrc directory of another
    checkout, from its blend_fwd.cu as ``other``; all at once
    (``build.build_copies``, into build/chip_smoke/fwd/). Prints each build's
    ptxas register and spill lines. Returns {name: C entry}."""
    from radegs_torch.native import build

    src = (build.CSRC / "blend_fwd.cu").read_text()
    copies = {name: (build.with_constants(src, consts), build.CSRC)
              for name, consts in variants.items()}
    if other:
        copies["other"] = open(os.path.join(other, "blend_fwd.cu")).read(), other
    libs = {}
    for name, (lib, out) in build.build_copies(
            copies, os.path.join(ROOT, "build", "chip_smoke", "fwd")).items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas blend_fwd[{name}]: {line.strip()}")
        libs[name] = fwd_entry(lib)
    return libs


class FwdCall:
    """The inputs and outputs of one forward kernel launch, built once as
    ``blend.blend_forward`` builds them, to launch any library's
    ``radegs_blend_fwd`` (``fwd_entry``) alone."""

    def __init__(self, binning, table, W, H):
        from radegs_torch.ops import blend

        self.T, self.tiles_x = blend._kernel_inputs(binning, table, W, H, 2)
        self.feat = table
        self.out = torch.empty((self.T, blend.N_OUT, 256), device=DEVICE)
        self.med = torch.empty((self.T, 256), dtype=torch.int32, device=DEVICE)
        self.binning = binning

    def __call__(self, fn, g=2):
        b = self.binning
        rc = fn(self.feat.data_ptr(), b.gauss_id.data_ptr(), b.tile_start.data_ptr(),
                b.tile_count.data_ptr(), self.out.data_ptr(), self.med.data_ptr(), self.T,
                self.tiles_x, g, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"forward kernel launch failed with CUDA error {rc}")
        return self.out, self.med


def forward_shape(label, binning, table, work, plain_ms, libs, reps):
    """One forward shape: the kernel through ``blend.blend_forward`` at G=1
    and G=2 against the plain output ``work`` (abs ABS_TOL, med_pos flips <=
    MED_POS_TOL), G=1 == G=2 and run == rerun bitwise, and every library of
    ``libs`` (``fwd_libraries``) equal to this tree's output bitwise; then
    each launch alone in CUDA graphs of ``reps`` (``in_turns``: this tree and
    another checkout's at G=2 and G=1, medians of 4; the variants once), the
    whole wrapper call by CUDA events around ``reps`` host-issued calls (G=1,
    G=2, G=2, G=1), beside the plain version's ``plain_ms`` and both
    bounds."""
    from radegs_torch.native import build
    from radegs_torch.ops import blend

    W, H = WIDTH, HEIGHT
    k1 = blend.blend_forward(binning, table, W, H, tiles_per_block=1)
    k2 = blend.blend_forward(binning, table, W, H, tiles_per_block=2)
    k2r = blend.blend_forward(binning, table, W, H, tiles_per_block=2)
    torch.cuda.synchronize()
    check(bit_identical(k1, k2), f"{label}: blend_fwd G=1 and G=2 are not bit-identical")
    check(bit_identical(k2, k2r), f"{label}: blend_fwd differs between two runs")
    err, flips, med_err = compare(k2, work)
    check(err <= ABS_TOL and med_err <= ABS_TOL, f"{label}: kernel vs plain {err}, {med_err}")
    check(flips <= MED_POS_TOL, f"{label}: med_pos flips {flips}")
    call = FwdCall(binning, table, W, H)
    tree = fwd_entry(build.load("blend_fwd"))
    ref = [x.clone() for x in call(tree, 2)]
    check(all(same_bits(a, b) for a, b in zip(ref, (blend.pack_raw(k2), k2["med_pos"]))),
          f"{label}: a launch alone differs from the wrapper's output")
    calls = {"G=1": lambda: call(tree, 1), "G=2": lambda: call(tree, 2)}
    calls.update({name: (lambda e=e: call(e, 2)) for name, e in libs.items()})
    if "other" in libs:
        calls["other, G=1"] = lambda: call(libs["other"], 1)
    same = {k: all(same_bits(a, b) for a, b in zip(c(), ref)) for k, c in calls.items()}
    check(all(same.values()), f"{label}: forward outputs differ from this tree's: {same}")
    alone = in_turns(calls, ["G=1", "G=2"] + (["other", "other, G=1"] if "other" in libs
                                              else []), reps)
    wrapper = {}
    for g in (1, 2, 2, 1):
        wrapper.setdefault(g, []).append(round(time_ms(
            lambda g=g: blend.blend_forward(binning, table, W, H, tiles_per_block=g), reps), 4))
    bound, bound_by, n_bytes, ops = kernel_bound_ms(binning, table, work)
    full, _, _, ops_full = kernel_bound_ms(binning, table, work, least=False)
    med = {k: float(np.median(v)) for k, v in alone.items()}
    log(f"{label} forward ({binning.gauss_id.numel()} instances, max per tile "
        f"{int(binning.max_tile_count)}; pairs walked {int(work['n_eval'])}, alpha >= 1/255 "
        f"{int(work['n_alpha'])}, blended {int(work['n_incl'])}; (instance, row) / (instance, "
        f"column) walked {int(work['n_row'])} / {int(work['n_col'])}, (instance, column) "
        f"blended {int(work['n_col_incl'])}): vs plain max abs err "
        f"{err:.3e}, med_pos flips {flips:.3e}, med err {med_err:.3e}; G1==G2, run==rerun "
        f"and every library equal bitwise {same}; device ms alone (graphs of "
        f"{reps}, in turns) {alone}; whole wrapper (host-issued, G1,G2,G2,G1) {wrapper}; plain "
        f"{plain_ms:.3f}; least bound {bound:.4f} ms by {bound_by} ({n_bytes} bytes, {ops} FP32 "
        f"operations): G=1 at {100 * bound / med['G=1']:.1f}%, G=2 at "
        f"{100 * bound / med['G=2']:.1f}%; full-gate bound {full:.4f} ms ({ops_full} "
        "operations)" + (f"; other at {100 * bound / med['other']:.1f}% of the least bound, "
                         f"this tree {med['other'] / med['G=2']:.2f}x faster at G=2"
                         if "other" in med else ""))
    return dict(alone={g: med[f"G={g}"] for g in (1, 2)}, alone_runs=alone,
                wrapper={g: float(np.median(v)) for g, v in wrapper.items()},
                plain_ms=plain_ms, bound=bound, bound_by=bound_by, bound_full=full,
                err=max(err, med_err))


def view0_binning(state, cam, max_per_tile, capacity):
    """The preprocess's table and the binning (with ``tile_gauss``) of one
    view, the instance budget set from the view's measured demand."""
    from radegs_torch.ops.binning import default_instance_budget, round_budget
    from radegs_torch.ops.rasterize import bin_prep
    from radegs_torch.renderer import prepare

    prep = prepare(state, cam, 0.1)
    need = int(bin_prep(prep, WIDTH, HEIGHT, default_instance_budget(capacity), max_per_tile,
                        need_tile_gauss=False).n_instances)
    binning = bin_prep(prep, WIDTH, HEIGHT, round_budget(need), max_per_tile,
                       need_tile_gauss=True)
    check(int(binning.n_overflow) == 0 and int(binning.tile_overflow) == 0,
          f"view 0 binning dropped work: {int(binning.n_overflow)}, "
          f"{int(binning.tile_overflow)}")
    return prep.table, binning


def view0_shapes(path, cap, dpath, dcap, cams):
    """The blend's three view-0 shapes, one at a time: (a) the 100k view 0
    (``max_per_tile`` 512, as served), (b) the dense view 0 (8192, early
    termination), (c) the training shape: ``create_from_points`` of the 100k
    scene's centres (opacity 0.1, 3-NN scales; ``training_scene``), view 0,
    no tile cut. Yields (shape, label, binning, table, work, plain_ms, reps):
    ``work`` the plain forward's output with its pair counts, ``plain_ms``
    the ms of one more plain call without the counts (CUDA events, as
    ``time_ms``)."""
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.ops import blend
    from radegs_torch.ops.binning import MAX_PER_TILE_CAP, default_instance_budget

    dev = torch.device(DEVICE)
    for shape in ("a", "b", "c"):
        if shape == "a":
            state = gm.update_3d_filter(
                gm.load_gaussian_ply(path, sh_degree=3, capacity=cap, device=dev), cams)
            max_per_tile, capacity, label, reps = 512, cap, "(a) 100k view 0", 20
        elif shape == "b":
            state = gm.update_3d_filter(
                gm.load_gaussian_ply(dpath, sh_degree=3, capacity=dcap, device=dev), cams)
            max_per_tile, capacity, label, reps = 8192, dcap, "(b) dense view 0", 10
        else:
            _, state, _ = training_scene(path, cap, cams, default_instance_budget(cap))
            max_per_tile, capacity, label = MAX_PER_TILE_CAP, state.capacity, "(c) training view 0"
            reps = 10
        with torch.no_grad():
            table, binning = view0_binning(state, cams[0], max_per_tile, capacity)
            del state
            work = blend.blend_forward_torch(binning.tile_gauss, table, WIDTH, HEIGHT,
                                             count_work=True)
            plain_ms = time_ms(lambda: blend.blend_forward_torch(binning.tile_gauss, table,
                                                                 WIDTH, HEIGHT), 1, warmup=False)
        yield shape, label, binning, table, work, plain_ms, reps
        del table, binning, work
        torch.cuda.empty_cache()


def backward_shapes(path, cap, dpath, dcap, cams, libs):
    """The forward (``forward_shape``, this tree's kernel alone) and the
    backward (``backward_shape``, with seeded random cotangents and the plain
    forward's pair counts) at the three shapes of ``view0_shapes``. Returns
    {shape: backward results, with the forward's under "fwd"}."""
    from radegs_torch.ops import blend

    out = {}
    for shape, label, binning, table, work, plain_ms, reps in view0_shapes(
            path, cap, dpath, dcap, cams):
        with torch.no_grad():
            fwd_res = forward_shape(f"phase 5 {label}", binning, table, work, plain_ms, {},
                                    reps)
            fwd = blend.blend_forward(binning, table, WIDTH, HEIGHT)
            cot = random_cotangents(fwd, {"a": 12, "b": 14, "c": 15}[shape])
            out[shape] = backward_shape(f"phase 5 {label}", binning, table, fwd, cot, WIDTH,
                                        HEIGHT, work, libs, reps)
        out[shape].update(max_tile=int(binning.max_tile_count), fwd=fwd_res)
        del fwd, cot
    return out


def reference_check():
    """The backward kernel against the exact reference renderer on the card:
    ``rasterize`` (the blend kernels, G=2) of a seeded REF_P-Gaussian scene
    at REF_W x REF_H, a seeded weighted sum of its seven maps, the gradients
    w.r.t. the nine blend inputs against ``torch.autograd`` through
    ``ops.reference.render_reference`` (no code shared with the kernels or
    their plain versions). Maps within ABS_TOL, gradients within
    REF_REL_TOL x max |reference| per field. Returns the max relative error."""
    from radegs_torch.core.camera import Camera
    from radegs_torch.core.projection import PreprocessOut, preprocess_gaussians
    from radegs_torch.ops.rasterize import rasterize
    from radegs_torch.ops.reference import render_reference

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(9)
    P = REF_P

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    q = rng.normal(size=(P, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cam = Camera.look_at([0.3, -0.2, -3.5], [0, 0, 0], [0, 1, 0], 0.9, 0.9, REF_W, REF_H,
                         device=dev)
    prep = preprocess_gaussians(t(rng.normal(size=(P, 3)) * 0.6),
                                t(np.exp(rng.normal(size=(P, 3)) * 0.4) * 0.08), t(q),
                                t(rng.uniform(0.3, 0.99, size=(P, 1))),
                                t(rng.normal(size=(P, 16, 3)) * 0.3), sh_degree=3, camera=cam)
    fields = ["xy", "conic", "opacity", "rgb", "view_point", "camera_plane", "ray_plane",
              "normal", "ts"]
    names = {"render": "render", "mask": "alpha", "expected_depth": "expected_depth",
             "median_depth": "median_depth", "expected_coord": "expected_coord",
             "median_coord": "median_coord", "normal": "normal"}
    bg = t([0.3, 0.2, 0.1])
    leaves = {f: getattr(prep, f).detach().clone().requires_grad_(True) for f in fields}
    rest = prep.valid, prep.radius, prep.well_conditioned
    out = rasterize(PreprocessOut.from_fields(*rest, **leaves), cam, bg, max_per_tile=1024,
                    instance_budget=1 << 16, tiles_per_block=2)
    check(int(out["binning"].n_overflow) == 0 and int(out["binning"].tile_overflow) == 0,
          "reference scene binning dropped work")
    weights = {k: t(rng.normal(size=tuple(out[k].shape))) for k in names}
    sum((weights[k] * out[k]).sum() for k in names).backward()
    ref_leaves = {f: getattr(prep, f).detach().clone().requires_grad_(True) for f in fields}
    ref = render_reference(PreprocessOut.from_fields(*rest, **ref_leaves), REF_W, REF_H,
                           cam.focal_x, cam.focal_y, bg)
    map_err = max((out[k] - ref[r]).abs().max().item() for k, r in names.items())
    sum((weights[k] * ref[r]).sum() for k, r in names.items()).backward()
    rel = {f: ((leaves[f].grad - ref_leaves[f].grad).abs().max()
               / ref_leaves[f].grad.abs().max().clamp_min(1e-30)).item() for f in fields}
    ended = int((ref["t_final"] < 1e-3).sum())
    log(f"phase 5 reference check ({P} Gaussians, {REF_W}x{REF_H}, "
        f"{int(out['binning'].n_instances)} instances, {ended} pixels ended): maps max abs err "
        f"{map_err:.3e}; gradients vs autograd through render_reference, rel to max |ref|: "
        + ", ".join(f"{f} {v:.2e}" for f, v in rel.items()))
    check(map_err <= ABS_TOL, f"kernel maps vs the reference renderer: {map_err}")
    check(max(rel.values()) <= REF_REL_TOL, f"kernel gradients vs the reference: {rel}")
    return max(rel.values())


def tf32_witness():
    """What fault C1 was worth: the SSIM of a seeded 1600x1200 image pair
    with its input gradient, and the appearance transform of that image with
    its parameters' gradients, each through the port's pinned float32
    convolutions and through plain ``F.conv2d`` with cuDNN's TF32 allowed,
    against float64 on the card. Logs the errors."""
    import torch.nn.functional as F

    from radegs_torch.models import appearance
    from radegs_torch.ops import ssim as ssim_mod
    from radegs_torch.ops.conv import conv2d_fp32 as conv2d_fp32_ref

    gen = torch.Generator(device=DEVICE).manual_seed(21)
    a = torch.rand((3, HEIGHT, WIDTH), generator=gen, device=DEVICE)
    b = (a + 0.1 * torch.randn(a.shape, generator=gen, device=DEVICE)).clamp(0, 1)
    _, app = appearance.init_appearance(gen)

    def plain_conv(x, weight, bias=None, padding=(0, 0), groups=1):
        return F.conv2d(x, weight, bias, padding=padding, groups=groups)

    def run(dtype):
        x = a.to(dtype).clone().requires_grad_(True)
        s = ssim_mod.ssim(x, b.to(dtype))
        s.backward()
        params = {"net": {k: v.to(dtype).clone().requires_grad_(True)
                          for k, v in app["net"].items()},
                  "embeddings": app["embeddings"].to(dtype)}
        out, _ = appearance.appearance_transform(params, a.to(dtype), 3)
        out.square().sum().backward()
        return s.item(), x.grad, out, torch.cat([v.grad.flatten()
                                                 for v in params["net"].values()])

    def rel(u, v):
        return ((u.double() - v).abs().max() / v.abs().max()).item()

    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        s64, g64, o64, p64 = run(torch.float64)
        errs = {}
        for name in ("pinned float32", "F.conv2d, TF32 allowed"):
            if name != "pinned float32":
                ssim_mod.conv2d_fp32 = appearance.conv2d_fp32 = plain_conv
            try:
                s32, g32, o32, p32 = run(torch.float32)
            finally:
                ssim_mod.conv2d_fp32 = appearance.conv2d_fp32 = conv2d_fp32_ref
            errs[name] = (abs(s32 - s64), rel(g32, g64), rel(o32, o64), rel(p32, p64))
    finally:
        torch.backends.cudnn.allow_tf32 = before
    log("fault C1 witness vs float64 on the card, 1600x1200 (SSIM abs err, its input "
        "gradient, appearance output, its parameters' gradients, rel to max): "
        + ", ".join(f"{k} " + " / ".join(f"{e:.3e}" for e in v) for k, v in errs.items()))


# ------------------------------------------------------------- phases ----


def setup():
    from radegs_torch.native import build

    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}"
        f" ({smi})")
    t0 = time.perf_counter()
    took = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall, per source "
        + ", ".join(f"{k} {v:.2f} s" for k, v in took.items()))
    for name in took:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return smi


def parity_scene(W=256, H=256, target=(0, 0, 0), backward=True):
    """Phase 2: kernel vs plain at G=1 and G=2 on bench.py's parity scene
    (and, off-centre at a size that is not a multiple of 16, with empty and
    ragged tiles): the forward (also run == rerun bitwise), and the backward
    unless ``backward`` is False."""
    from radegs_torch.core.camera import Camera
    from radegs_torch.core.projection import preprocess_gaussians
    from radegs_torch.ops import blend
    from radegs_torch.ops.rasterize import bin_prep

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(3)
    P = 2000
    cam = Camera.look_at([0, 0.3, -4.0], target, [0, 1, 0], 0.9, 0.9, W, H, device=dev)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    prep = preprocess_gaussians(
        t(rng.normal(size=(P, 3)) * 0.9), t(rng.uniform(0.02, 0.25, (P, 3))),
        t(np.tile([1.0, 0, 0, 0], (P, 1))), t(rng.uniform(0.05, 0.95, (P, 1))),
        t(rng.uniform(0, 1, (P, 1, 3))), sh_degree=0, camera=cam, kernel_size=0.1)
    binning = bin_prep(prep, W, H, instance_budget=1 << 15, max_per_tile=512,
                       need_tile_gauss=True)
    table = prep.table
    plain = blend.blend_forward_torch(binning.tile_gauss, table, W, H)
    k1 = blend.blend_forward(binning, table, W, H, tiles_per_block=1)
    k2 = blend.blend_forward(binning, table, W, H, tiles_per_block=2)
    torch.cuda.synchronize()
    check(bit_identical(k1, k2), "blend_fwd G=1 and G=2 are not bit-identical")
    check(bit_identical(k2, blend.blend_forward(binning, table, W, H, tiles_per_block=2)),
          "blend_fwd differs between two runs")
    err, flips, med_err = compare(k1, plain)
    log(f"phase 2 parity scene: P={P} {W}x{H} n_instances={int(binning.n_instances)} "
        f"(budget 32768, n_overflow {int(binning.n_overflow)}), empty tiles "
        f"{int((binning.tile_count == 0).sum())} of {binning.tile_count.numel()}, max_tile="
        f"{int(binning.max_tile_count)}: G1==G2 bitwise, max abs err {err:.3e}, "
        f"med_pos flips {flips:.3e}, med_t/med_coord err where med_pos agrees {med_err:.3e}")
    check(err <= ABS_TOL and med_err <= ABS_TOL, f"kernel vs plain error {err}, {med_err}")
    check(flips <= MED_POS_TOL, f"med_pos flips {flips}")
    if not backward:
        return max(err, med_err), None, None
    bwd_abs, bwd_rel, _ = check_backward(binning, table, k1, random_cotangents(k1, 11), W, H,
                                         f"phase 2 {W}x{H}")
    return max(err, med_err), bwd_abs, bwd_rel


def serve(state, cameras, max_per_tile, budget, tiles_per_block, label, warmup=0):
    """Render every camera through ``render`` (after ``warmup`` views); raise
    the budget to the measured demand on overflow. Returns per-view stage
    times and binning diagnostics, and the budget used."""
    from radegs_torch.ops.binning import round_budget
    from radegs_torch.renderer import render

    rows = []
    views = [cameras[i % len(cameras)] for i in range(warmup)] + list(cameras)
    for i, cam in enumerate(views):
        for _ in range(2):
            events = []
            t0 = time.perf_counter()
            with torch.no_grad():
                out = render(state, cam, [0.0, 0.0, 0.0], kernel_size=0.1,
                             max_per_tile=max_per_tile, instance_budget=budget,
                             tiles_per_block=tiles_per_block, device=DEVICE,
                             events=events)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            b = out["binning"]
            if int(b.n_overflow) == 0:
                break
            budget = round_budget(int(b.n_instances))
            log(f"  {label}: view {i} overflowed, instance budget -> {budget}")
        check(int(b.n_overflow) == 0, f"{label}: view {i} still overflows at {budget}")
        for k in ("render", "mask", "expected_depth", "median_depth", "expected_coord",
                  "median_coord", "normal"):
            v = out[k]
            check(v.shape[-2:] == (HEIGHT, WIDTH), f"{k} shape {tuple(v.shape)}")
            check(bool(torch.isfinite(v).all()), f"{label}: {k} not finite")
        if i < warmup:
            continue
        ev = dict(events)
        names = ["start", "preprocess", "binning", "blend", "normalize"]
        stages = {n: ev[a].elapsed_time(ev[n]) for a, n in zip(names, names[1:])}
        rows.append(dict(stages, view_ms=ev["start"].elapsed_time(ev["normalize"]),
                         wall_ms=wall, n_instances=int(b.n_instances),
                         n_overflow=int(b.n_overflow), tile_overflow=int(b.tile_overflow),
                         max_tile=int(b.max_tile_count)))
    return rows, budget


def report(label, rows, budget, launches, peak):
    med = {k: float(np.median([r[k] for r in rows]))
           for k in ("preprocess", "binning", "blend", "normalize", "view_ms", "wall_ms")}
    log(f"{label}: {len(rows)} views, instance budget {budget}, median ms: preprocess "
        f"{med['preprocess']:.3f}, binning {med['binning']:.3f}, kernel {med['blend']:.3f}, "
        f"normalisation {med['normalize']:.3f}, per view {med['view_ms']:.3f} (events) / "
        f"{med['wall_ms']:.3f} (host clock); n_instances "
        f"{[r['n_instances'] for r in rows]}, n_overflow {sum(r['n_overflow'] for r in rows)}, "
        f"tile_overflow {[r['tile_overflow'] for r in rows]}, max per tile "
        f"{max(r['max_tile'] for r in rows)}, kernel launches {launches}, "
        f"peak memory {peak / 2**30:.3f} GiB")
    return med


def serving(workdir):
    """Phases 3 and 4: the serving path at full width, then converged scale,
    the preprocess kernel on its path (each view needs no gradient)."""
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.ops import blend
    from radegs_torch.ops import preprocess as pp
    from radegs_torch.ops.binning import default_instance_budget, round_budget
    from radegs_torch.ops.rasterize import bin_prep
    from radegs_torch.renderer import prepare
    from radegs_torch.utils import trace

    dev = torch.device(DEVICE)
    cams = orbit_cameras(N_VIEWS, dev)
    results = {}

    # ---- phase 3: 100k headline scene, the serving path ----
    t0 = time.perf_counter()
    path = os.path.join(workdir, "scene100k.ply")
    cap = scene_ply(path, "100k")
    log(f"phase 3 scene written in {time.perf_counter() - t0:.1f} s")
    blend.reset_launches()  # the serving path starts here
    pp.reset_launches()
    binning_launches(reset=True)
    n_plain = trace.counters("preprocess").get("plain", 0)
    torch.cuda.reset_peak_memory_stats()
    state = gm.update_3d_filter(
        gm.load_gaussian_ply(path, sh_degree=3, capacity=cap, device=dev), cams)
    budget = default_instance_budget(cap)
    rows2, budget = serve(state, cams, 512, budget, 2, "100k G=2", warmup=WARMUP)
    rows1, budget = serve(state, cams, 512, budget, 1, "100k G=1", warmup=1)
    launches_100k = dict(blend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    results["g2"] = report("phase 3 100k 1600x1200 G=2", rows2, budget,
                           launches_100k["blend_fwd[G=2]"], peak)
    results["g1"] = report("phase 3 100k 1600x1200 G=1", rows1, budget,
                           launches_100k["blend_fwd[G=1]"], peak)

    # ---- phase 4: dense converged-scale scene, the serving path continued ----
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dpath = os.path.join(workdir, "dense.ply")
    dcap = scene_ply(dpath, "dense")
    log(f"phase 4 scene written in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    state = gm.update_3d_filter(
        gm.load_gaussian_ply(dpath, sh_degree=3, capacity=dcap, device=dev), cams)
    dcams = cams[:2]
    with torch.no_grad():  # the demand of each view sets the budget
        need = 0
        for cam in dcams:
            b = bin_prep(prepare(state, cam, 0.1), WIDTH, HEIGHT,
                         default_instance_budget(dcap), 8192, need_tile_gauss=False)
            need = max(need, int(b.n_instances))
    g = default_g()
    before = blend.LAUNCHES[f"blend_fwd[G={g}]"]
    dense_bin = binning_launches()  # phase 4's views: their budget cuts nothing
    rowsd, dbudget = serve(state, dcams, 8192, round_budget(need), g, f"dense G={g}")
    results["dense"] = report(f"phase 4 dense 1.2M 1600x1200 G={g}", rowsd, dbudget,
                              blend.LAUNCHES[f"blend_fwd[G={g}]"] - before,
                              torch.cuda.max_memory_allocated())
    launches = {**dict(blend.LAUNCHES), **dict(pp.LAUNCHES),
                **binning_launches()}  # the serving path ends here
    log(f"serving path kernel launches: {launches}")
    check_binning_path("the serving path", launches)
    check_binning_path("phase 4's served views", {k: launches[k] - v for k, v in
                                                  dense_bin.items()}, cut=0)
    check(all(launches[f"blend_fwd[G={g}]"] > 0 for g in (1, 2)),
          f"a forward kernel never ran on the serving path: {launches}")
    check(pp.LAUNCHES["preprocess_fwd[sh=3,inv=0]"] > 0
          and trace.counters("preprocess").get("plain", 0) == n_plain,
          f"the serving path ran the plain preprocess: {launches}")
    results["pre"] = preprocess_check(state, cams[0], "phase 5 dense view 0")
    del state
    torch.cuda.empty_cache()
    results.update(launches=launches, path=path, dpath=dpath, cap=cap, dcap=dcap, cams=cams,
                   budget=budget, dbudget=dbudget)
    return results


def full_scale(workdir):
    """Phases 3 and 4 (``serving``) and phase 5 (the preprocess kernel at
    the dense view 0, the backward against the reference renderer, then both
    blend kernels at their three shapes)."""
    results = serving(workdir)
    # ---- phase 5: the kernels alone at three shapes, the forward's and the
    # backward's (launches here are not counted) ----
    ref_rel = reference_check()
    r = results
    results.update(ref_rel=ref_rel, bwd=backward_shapes(r["path"], r["cap"], r["dpath"],
                                                        r["dcap"], r["cams"], {}))
    return results


# the least bytes of the preprocess kernel: an active row reads its 59
# parameter floats (SH degree 3), its 3D filter and its active flag, an
# inactive row its flag alone; every row writes 24 feature floats, its
# radius and two flags, and 9 floats of invraycov when asked
def preprocess_bytes(state, inv):
    n, P = int(state.active.sum()), state.capacity
    m = (state.max_sh_degree + 1) ** 2
    return n * 4 * (3 + 3 * m + 3 + 4 + 1 + 1) + P + P * (4 * (24 + 1 + 9 * inv) + 2)


PRE_FIELDS = ("xy", "depth", "view_point", "conic", "opacity", "rgb", "camera_plane",
              "ray_plane", "normal", "ts")


def compare_preprocess(got, want, active):
    """Rows whose bits differ: of each float field over the rows valid on
    both sides (``invraycov`` too when asked), of ``radius``, ``valid`` and
    ``well_conditioned`` over the active rows."""
    both = got.valid & want.valid
    out = {f: int((getattr(got, f) != getattr(want, f))[active].sum())
           for f in ("radius", "valid", "well_conditioned")}
    for f in PRE_FIELDS + (("invraycov",) if got.invraycov is not None else ()):
        a = getattr(got, f)[both]
        b = getattr(want, f)[both].reshape(a.shape)
        out[f] = int((a.view(torch.int32) != b.view(torch.int32)).reshape(len(a), -1)
                     .any(1).sum())
    return out


def preprocess_check(state, cam, label, reps=20):
    """The preprocess kernel at one view: against its plain version with
    and without the inverse ray-space covariance, then alone in a CUDA graph
    (``reps`` launches) beside its bytes bound, and the plain version's ms
    per call (CUDA events)."""
    from radegs_torch.ops import preprocess as pp

    res = {}
    with torch.no_grad():
        for inv in (False, True):
            want = pp.preprocess_torch(state, cam, 0.1, 1.0, inv)
            got = pp.preprocess_forward(state, cam, 0.1, 1.0, inv)
            torch.cuda.synchronize()
            e = compare_preprocess(got, want, state.active)
            del got, want
            log(f"{label} preprocess kernel vs plain (invraycov {inv}), rows with other "
                "bits: " + ", ".join(f"{k} {v}" for k, v in e.items()))
            check(not any(e.values()),
                  f"{label}: the preprocess kernel is not the plain version bit for bit: {e}")
        for inv in (False, True):
            res[f"alone_{int(inv)}"] = graph_ms(
                lambda: pp.preprocess_forward(state, cam, 0.1, 1.0, inv), reps)
            res[f"bound_{int(inv)}"] = preprocess_bytes(state, inv) / PEAK_BYTES * 1e3
        res["plain_ms"] = time_ms(lambda: pp.preprocess_torch(state, cam, 0.1), 3)
    log(f"{label} preprocess kernel alone (CUDA graph of {reps}): {res['alone_0']:.4f} ms, "
        f"with invraycov {res['alone_1']:.4f} ms; bytes bound {res['bound_0']:.4f} / "
        f"{res['bound_1']:.4f} ms ({res['alone_0'] / res['bound_0']:.2f}x / "
        f"{res['alone_1'] / res['bound_1']:.2f}x); plain version {res['plain_ms']:.3f} ms "
        f"({int(state.active.sum())} active of {state.capacity} rows)")
    res["bwd"] = preprocess_backward_check(state, cam, label, reps)
    # the same rows four times over: 2^23 rows at capacity 2^21
    big = state.replace(params=state.params.map(lambda x: torch.cat([x] * 4)),
                        filter_3d=torch.cat([state.filter_3d] * 4),
                        active=torch.cat([state.active] * 4))
    res["bwd_4x"] = preprocess_backward_check(big, cam, f"{label} x4", 5, check_grads=False)
    del big
    torch.cuda.empty_cache()
    return res


# the least bytes of the preprocess backward kernel: an active row reads its
# 59 parameter floats (SH degree 3), its 3D filter, its active flag and the
# 24 floats of its incoming gradient, an inactive row its flag alone; every
# row writes its 59 gradient floats
def preprocess_bwd_bytes(state):
    n, P = int(state.active.sum()), state.capacity
    width = 3 + 3 * (state.max_sh_degree + 1) ** 2 + 3 + 4 + 1
    return n * 4 * (width + 1 + 24) + P + P * 4 * width


def train_cotangents(state, seed):
    """A seeded incoming gradient of the preprocess's table, laid out as a
    train step hands it over: the first 24 columns of the blend backward's
    (P, 26) buffer."""
    from radegs_torch.ops import blend

    P, dev = state.capacity, state.device
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((P, blend.GRAD_COLS), generator=g, device=dev)[:, :blend.XY_ABS]


def preprocess_backward_check(state, cam, label, reps=20, check_grads=True):
    """The backward kernel at one view, with seeded incoming gradients laid
    out as a train step's: (``check_grads``) against autograd through the
    plain version on the card, row by row (the largest component's gap over
    the row's largest gradient; a row past 1e-3 is one whose gradient
    cancels, as tests/test_torch_preprocess_grad.py holds it to float64 and
    finds; at most 1e-4 of the active rows may be), non-finite rows the same,
    an inactive row zeros; then alone in a CUDA graph beside its bytes bound
    (``preprocess_bwd_bytes``), and autograd's backward through the plain
    version (CUDA events)."""
    from radegs_torch.ops import preprocess as pp

    res = {}
    cots = train_cotangents(state, 20)
    params = state.params.map(lambda x: x.detach().clone().requires_grad_(True))
    prep = pp.preprocess_torch(state.replace(params=params), cam, 0.1)
    outs, grads = prep.table, cots
    res["plain_ms"] = time_ms(lambda: torch.autograd.backward(outs, grads, retain_graph=True), 3)
    if check_grads:
        for _, x in params.items():
            x.grad.zero_()
        torch.autograd.backward(outs, grads, retain_graph=True)
        got = pp.preprocess_backward(state, cam, 0.1, 1.0, cots)
        torch.cuda.synchronize()
        act, n = state.active, int(state.active.sum())
        worst, share = {}, {}
        for name, g in got.items():
            if g.numel() == 0:
                continue
            check(bool((g[~act] == 0).all()), f"{label}: preprocess_bwd gave an inactive row of "
                  f"{name} a gradient")
            a, k = getattr(params, name).grad[act].reshape(n, -1), g[act].reshape(n, -1)
            fin = torch.isfinite(a).all(1)
            check(torch.equal(fin, torch.isfinite(k).all(1)),
                  f"{label}: preprocess_bwd's non-finite rows of {name} differ from autograd's")
            rel = ((k - a).abs().amax(1) / a.abs().amax(1).clamp_min(1e-30))[fin]
            worst[name], share[name] = float(rel.max()), float((rel > 1e-3).float().mean())
        log(f"{label} preprocess_bwd vs autograd through the plain version, largest row gap "
            "(share of rows past 1e-3): " + ", ".join(f"{k} {worst[k]:.2e} ({share[k]:.1e})"
                                                     for k in worst))
        check(max(share.values()) <= 1e-4,
              f"{label}: preprocess_bwd is not autograd's gradient: {share}")
        res["worst_rel"] = max(worst.values())
        del got
    del prep, outs, grads, params
    torch.cuda.empty_cache()
    res["alone"] = graph_ms(lambda: pp.preprocess_backward(state, cam, 0.1, 1.0, cots), reps)
    res["bound"] = preprocess_bwd_bytes(state) / PEAK_BYTES * 1e3
    log(f"{label} preprocess_bwd alone (CUDA graph of {reps}): {res['alone']:.4f} ms; bytes "
        f"bound {res['bound']:.4f} ms ({res['alone'] / res['bound']:.2f}x, "
        f"{preprocess_bwd_bytes(state)} B); autograd's backward through the plain version "
        f"{res['plain_ms']:.3f} ms ({int(state.active.sum())} active of {state.capacity} rows)")
    return res


def preprocess_rows(pre, launches):
    """The kernels-list rows of the preprocess kernel at SH degree 3 (the
    dense view 0), without and with the inverse ray-space covariance;
    ``launches`` holds the serving path's counts."""
    return [{"name": f"preprocess_fwd[sh=3,inv={inv}]", "route": "cuda",
             "source": "radegs_torch/csrc/preprocess_fwd.cu",
             "replaces": "none (the JAX preprocess is XLA)",
             "launches": launches[f"preprocess_fwd[sh=3,inv={inv}]"], "same_bits": True,
             "alone_ms": pre[f"alone_{inv}"], "plain_ms": pre["plain_ms"] if inv == 0 else None,
             "bound_ms": pre[f"bound_{inv}"], "bound_by": "bytes", "library_ms": None}
            for inv in (0, 1)] + [
        {"name": "preprocess_bwd[sh=3]", "route": "cuda",
         "source": "radegs_torch/csrc/preprocess_bwd.cu",
         "replaces": "none (the JAX preprocess's gradient is XLA's autograd)",
         "launches": launches["preprocess_bwd[sh=3]"], "max_rel_gap": pre["bwd"]["worst_rel"],
         "alone_ms": pre["bwd"]["alone"], "plain_ms": pre["bwd"]["plain_ms"],
         "bound_ms": pre["bwd"]["bound"], "alone_ms_2p23": pre["bwd_4x"]["alone"],
         "plain_ms_2p23": pre["bwd_4x"]["plain_ms"], "bound_ms_2p23": pre["bwd_4x"]["bound"],
         "bound_by": "bytes", "library_ms": None}]


def train_step_launches(state, cam, budget):
    """The preprocess kernels' launches in one ``make_train_step`` of
    ``state`` at ``cam`` (a seeded random ground truth): one forward and one
    backward, and the plain preprocess never."""
    from radegs_torch.ops import preprocess as pp
    from radegs_torch.train import loop
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
    from radegs_torch.utils import trace

    dev = state.device
    gt = torch.rand((3, cam.height, cam.width), generator=torch.Generator(device=dev)
                    .manual_seed(3), device=dev)
    step = loop.make_train_step(ModelConfig(kernel_size=0.1), OptimizationConfig(),
                                PipelineConfig(max_per_tile=8192, instance_budget=budget), 1.0)
    pp.reset_launches()
    binning_launches(reset=True)
    plain = trace.counters("preprocess").get("plain", 0)
    step(loop.init_train_state(state), cam, gt, torch.zeros(3, device=dev), 0, cam.width,
         cam.height)
    torch.cuda.synchronize()
    launches = dict(pp.LAUNCHES)
    log(f"one train step's preprocess launches: { {k: v for k, v in launches.items() if v} }")
    check(launches["preprocess_fwd[sh=3,inv=0]"] == 1 and launches["preprocess_bwd[sh=3]"] == 1
          and sum(launches.values()) == 2 and trace.counters("preprocess").get("plain", 0) == plain,
          f"a train step's preprocess is not one forward and one backward launch: {launches}")
    return launches


# the least bytes of Adam and the statistics (csrc/adam_stats.cu): every
# parameter float's p, g, m and v read and p, m and v written (7 x 4 B), and
# a row's statistics: the screen gradient (8 B), the abs-gradient's sector
# (8 B), the visible and active flags and the radius (6 B), five
# accumulators read and written (40 B)
def adam_stats_bytes(state):
    P = state.capacity
    width = sum(p.numel() for _, p in state.params.items()) // P
    return P * (7 * 4 * width + 62)


def adam_inputs(P, seed):
    """A seeded state of ``P`` rows mid-training at SH degree 3 (70% active,
    scattered; moments non-zero), its step's gradients and the statistics'
    inputs of a 1237 x 822 view, all on the card."""
    from radegs_torch.models import gaussian_model as gm

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = dict(xyz=(P, 3), f_dc=(P, 1, 3), f_rest=(P, 15, 3), scaling=(P, 3),
                  rotation=(P, 4), opacity=(P, 1))

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def rand(scale):
        return torch.rand(P, generator=gen, device=dev) * scale

    active = rand(1.0) < 0.7
    state = gm.GaussianState(
        params=gm.GaussianParams(**{k: randn(s) for k, s in shapes.items()}), active=active,
        filter_3d=torch.zeros((P, 1), device=dev), max_radii2d=torch.floor(rand(40.0)),
        grad_accum=rand(1.0), grad_abs_accum=rand(1.0), grad_abs_max=rand(1e-2),
        denom=torch.floor(rand(9.0)),
        adam_m=gm.GaussianParams(**{k: randn(s, 1e-2) for k, s in shapes.items()}),
        adam_v=gm.GaussianParams(**{k: randn(s, 1e-2).abs_() for k, s in shapes.items()}),
        adam_step=99, active_sh_degree=3, max_sh_degree=3)
    grads = gm.GaussianParams(**{k: randn(s, 1e-3) for k, s in shapes.items()})
    visible = rand(1.0) < 0.5
    radii = torch.where(visible, torch.floor(rand(60.0)), 0.0)
    xy_abs = torch.stack([randn((P,), 1e-4).abs_(), torch.zeros(P, device=dev)], 1)
    return state, grads, randn((P, 2), 1e-4), xy_abs, visible, radii, (618.5, 411.0)


def adam_outputs(state):
    from radegs_torch.train import optim

    out = {f"{part}.{k}": t for part in ("params", "adam_m", "adam_v")
           for k, t in getattr(state, part).items()}
    return out | {f: getattr(state, f) for f in optim.STATS_FIELDS}


def adam_differing(got, want):
    """The outputs whose bits differ, with the count of differing floats."""
    a, b = adam_outputs(got), adam_outputs(want)
    return {k: int((a[k].view(torch.int32) != b[k].view(torch.int32)).sum()) for k in a
            if not same_bits(a[k], b[k])}


@contextlib.contextmanager
def adam_entry(fn):
    """``optim.adam_and_stats_kernel`` launching ``fn`` (a C entry with the
    kernel's signature) while open."""
    from radegs_torch.train import optim

    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_float] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    keep = optim._entry
    optim._entry = lambda: fn
    try:
        yield
    finally:
        optim._entry = keep


# copies of csrc/adam_stats.cu with other constants, held to the kernel's
# bits and timed beside it by --adam
ADAM_VARIANTS = {"ITEMS=2": {"ITEMS": 2}, "ITEMS=4": {"ITEMS": 4}, "NT=128": {"NT": 128},
                 "NT=512": {"NT": 512}}


def adam_alone(variants=False):
    """The Adam and statistics kernel at the train cells' row counts (2^21,
    2^23; SH degree 3): against the plain chain on the card (every output
    the same bits), alone in a CUDA graph beside its bytes bound, and the
    plain chain's ms a call (CUDA events). ``variants``: the kernel rebuilt
    from copies of its source with other constants (``ADAM_VARIANTS``),
    each held to the kernel's bits and timed in turns with it."""
    from radegs_torch.native import build
    from radegs_torch.train import optim

    libs = {}
    if variants:
        text = (build.CSRC / "adam_stats.cu").read_text()
        libs = {label: lib.radegs_adam_stats for label, (lib, _) in build.build_copies(
            {label: (build.with_constants(text, c), build.CSRC)
             for label, c in ADAM_VARIANTS.items()},
            os.path.join(ROOT, "build", "chip_smoke", "adam")).items()}
    res = {}
    for log2, reps in ((21, 20), (23, 10)):
        args = adam_inputs(1 << log2, 22 + log2)
        lrs = optim.GroupLRs(xyz=5.9e-4)
        got = optim.adam_and_stats_kernel(args[0], args[1], lrs, *args[2:])
        want = optim.adam_and_stats_torch(args[0], args[1], lrs, *args[2:])
        torch.cuda.synchronize()
        diff = adam_differing(got, want)
        log(f"adam_stats at 2^{log2} rows vs the plain chain, floats with other bits: {diff}")
        check(not diff, f"adam_stats at 2^{log2} rows is not the plain chain bit for bit: {diff}")
        del want
        row = {"alone": graph_ms(lambda: optim.adam_and_stats_kernel(args[0], args[1], lrs,
                                                                     *args[2:]), reps),
               "plain_ms": time_ms(lambda: optim.adam_and_stats_torch(args[0], args[1], lrs,
                                                                      *args[2:]), 3),
               "bound": adam_stats_bytes(args[0]) / PEAK_BYTES * 1e3}
        log(f"adam_stats alone at 2^{log2} rows (CUDA graph of {reps}): {row['alone']:.4f} ms; "
            f"bytes bound {row['bound']:.4f} ms ({adam_stats_bytes(args[0])} B, "
            f"{100 * row['bound'] / row['alone']:.1f}% of it); plain chain "
            f"{row['plain_ms']:.3f} ms")
        for label, fn in libs.items():
            with adam_entry(fn):
                other = optim.adam_and_stats_kernel(args[0], args[1], lrs, *args[2:])
            torch.cuda.synchronize()
            diff = adam_differing(other, got)
            check(not diff, f"adam_stats {label} is not the kernel bit for bit: {diff}")
            del other
            turns = []
            for _ in range(3):
                turns.append(graph_ms(lambda: optim.adam_and_stats_kernel(
                    args[0], args[1], lrs, *args[2:]), reps))
                with adam_entry(fn):
                    turns.append(graph_ms(lambda: optim.adam_and_stats_kernel(
                        args[0], args[1], lrs, *args[2:]), reps))
            row[label] = (float(np.median(turns[0::2])), float(np.median(turns[1::2])))
            log(f"adam_stats {label} at 2^{log2} rows, same bits; in turns (medians of 3) "
                f"kernel {row[label][0]:.4f} ms, {label} {row[label][1]:.4f} ms")
        res[log2] = row
        del got, args
        torch.cuda.empty_cache()
    return res


def adam_row(res, launches):
    """The kernels-list row of the Adam and statistics kernel; ``launches``
    maps a path (train, parallel, bench) to its ``launches.adam`` counts."""
    return {"name": "adam_stats", "route": "cuda", "source": "radegs_torch/csrc/adam_stats.cu",
            "replaces": "none (radegs_tpu/train/optim.py:adam_step and the statistics are XLA)",
            "same_bits": True, "alone_ms": res[21]["alone"], "plain_ms": res[21]["plain_ms"],
            "bound_ms": res[21]["bound"], "alone_ms_2p23": res[23]["alone"],
            "plain_ms_2p23": res[23]["plain_ms"], "bound_ms_2p23": res[23]["bound"],
            "bound_by": "bytes", "library_ms": None,
            **{f"{path}_launches": d.get("adam_stats", 0) for path, d in launches.items()}}


def cell_view(cell, seed=2147483659):
    """View 0 of a benchmark cell's scene (``benchmark/``: its points, the
    reference's 3-NN scales, the state as a viewer loads it): its
    configuration and the view's preprocess on the card."""
    from benchmark import jobs, program, run
    from benchmark.reference import scene as rs
    from radegs_torch.renderer import prepare

    dev = torch.device(DEVICE)
    _, cfg, _ = run.cell_inputs(run.load_json(os.path.join(ROOT, "BENCHMARK.json")), cell)
    pts, cols = jobs.scene.points_and_colors(cfg, seed)
    cams = program.cameras(jobs.scene.view_eyes(cfg), cfg, dev)
    dist2 = rs.mean_dist2_knn(torch.as_tensor(pts, device=dev))
    state = program.load_state(cfg, jobs.scene_params(cfg, pts, cols, dev, dist2), cams, dev)
    with torch.no_grad():
        prep = prepare(state, cams[0], cfg["kernel_size"])
    del state
    return cfg, prep


# the least bytes of a binning: a valid row's xy, conic, opacity, depth (7
# floats), radius and flag read once (33 B), another row's flag alone (1 B);
# each instance's gauss_id and tile_id written (8 B); each tile's start and
# count (8 B)
def binning_bytes(P, V, n, T):
    return 33 * V + (P - V) + 8 * n + 8 * T


# the design's bytes besides: each instance's 12-byte (key, id) pair
# written by the duplicate kernel, read and written by the sort (keys and
# their order), read by the ranges pass (48 B more an instance)
def binning_design_bytes(P, V, n, T):
    return binning_bytes(P, V, n, T) + 48 * n


BINNING_LISTS = ("gauss_id", "tile_id", "tile_start", "tile_count", "n_instances",
                 "n_overflow", "tile_overflow", "max_tile_count", "n_culled")


def same_binning(label, got, want, launches, expected):
    """The kernels' lists and counters equal the plain version's, from the
    ``expected`` launches."""
    diff = [f for f in BINNING_LISTS if not torch.equal(getattr(got, f), getattr(want, f))]
    log(f"binning at {label} vs the plain version, fields that differ: {diff}; "
        f"launches {launches}")
    check(not diff, f"binning at {label}: the kernels' lists differ from the plain "
          f"version's in {diff}")
    check(launches == expected, f"binning at {label}: launches {launches}, not {expected}")


def check_binning_path(label, launches, cut=None):
    """Every binning of a path ran the kernels: the duplicate and ranges
    kernels once a binning, the count kernel once more for each binning
    the instance budget cut (``budget_path``; ``cut``, where given, how many
    the budget cut)."""
    n, dup, rng, bp = (launches[k] for k in ("binning_count", "binning_duplicate",
                                             "binning_ranges", "budget_path"))
    check(dup > 0 and dup == rng and n == dup + bp and (cut is None or bp == cut),
          f"{label}: binning launches {launches}" + ("" if cut is None else f", {cut} cut"))


def binning_alone():
    """The binning kernels at view 0 of the train cells' scenes: against the
    plain version on the card (the same ints), also under the demand sweep's
    budget (2^24, which cuts the 6.1M view), the count and list stages alone
    in CUDA graphs, the sort alone, the whole call with its sync (CUDA
    events), the plain version's ms a call, and the bytes bounds."""
    from radegs_torch.core.projection import column
    from radegs_torch.ops import binning as bn

    res = {}
    for label, cell, reps in (("1.2M", "train-surface-1.2M", 20),
                              ("6.1M", "train-surface-6.1M", 10)):
        cfg, prep = cell_view(cell)
        t = prep.table
        view = (column(t, "xy"), prep.radius, column(t, "depth"), prep.valid, cfg["width"],
                cfg["height"])
        cuts = dict(conic=column(t, "conic"), opacity=column(t, "opacity"))
        budget, mpt = bn.budget_cap(cfg["capacity"]), bn.MAX_PER_TILE_CAP
        fast = {**{k: 1 for k in bn.STAGES}, "budget_path": 0}
        bn.reset_launches()
        got = bn.bin_gaussians(*view, budget, mpt, **cuts)
        launches = binning_launches()
        want = bn.bin_gaussians_torch(*view, budget, mpt, **cuts)
        torch.cuda.synchronize()
        same_binning(f"{label} view 0", got, want, launches, fast)
        del want
        # the demand sweep's budget: the 6.1M view's demand passes it
        sweep = bn.MAX_INSTANCE_BUDGET
        cut = int(got.n_instances) > sweep
        bn.reset_launches()
        got_s = bn.bin_gaussians(*view, sweep, mpt, **cuts)
        launches = binning_launches()
        want = bn.bin_gaussians_torch(*view, sweep, mpt, **cuts)
        torch.cuda.synchronize()
        same_binning(f"{label} view 0, budget {sweep}", got_s, want, launches,
                     {**fast, "binning_count": 1 + cut, "budget_path": int(cut)})
        del want, got_s
        budget_ms = time_ms(lambda: bn.bin_gaussians(*view, sweep, mpt, **cuts), reps)
        P, n, T = t.shape[0], got.gauss_id.numel(), got.tile_count.numel()
        V = int(prep.valid.sum())
        ps = bn.count_stage(*view, mpt, **cuts)
        order = torch.sort(got.gauss_id, stable=True).indices  # the kernels' row order
        keys = ((got.tile_id.long() << 32) | bn._depth_bits(view[2][got.gauss_id.long()]))[order]
        row = {"P": P, "n": n, "T": T,
               "count_ms": graph_ms(lambda: bn.count_stage(*view, mpt, **cuts), reps),
               "list_ms": graph_ms(lambda: bn.list_stage(ps, n), reps),
               "sort_ms": graph_ms(lambda: torch.sort(keys, stable=True), reps),
               "call_ms": time_ms(lambda: bn.bin_gaussians(*view, budget, mpt, **cuts), reps),
               "plain_ms": time_ms(lambda: bn.bin_gaussians_torch(*view, budget, mpt, **cuts),
                                   3),
               "budget_ms": budget_ms, "budget_cut": cut,
               "bound": binning_bytes(P, V, n, T) / PEAK_BYTES * 1e3,
               "design_bound": binning_design_bytes(P, V, n, T) / PEAK_BYTES * 1e3}
        log(f"binning at {label} view 0 ({P} rows, {V} valid, {n} instances, {T} tiles): "
            f"count stage {row['count_ms']:.4f} ms, list stage {row['list_ms']:.4f} ms (the "
            f"sort alone {row['sort_ms']:.4f}), CUDA graphs of {reps}; a whole call with its "
            f"sync {row['call_ms']:.4f} ms; at budget {sweep} ({'cut' if cut else 'no cut'}) "
            f"{budget_ms:.4f} ms; plain version {row['plain_ms']:.3f} ms; least-bytes bound "
            f"{row['bound']:.4f} ms ({binning_bytes(P, V, n, T)} B), with the design's sort "
            f"traffic {row['design_bound']:.4f} ms ({binning_design_bytes(P, V, n, T)} B)")
        res[label] = row
        del got, ps, order, keys, prep, t, view, cuts
        torch.cuda.empty_cache()
    return res


def binning_row(res, launches):
    """The kernels-list row of the binning kernels; ``launches`` maps a path
    to its launch counts, of which the count kernel's (one a binning on the
    kernels' path) and ``budget_path`` are read."""
    return {"name": "binning", "route": "cuda", "source": "radegs_torch/csrc/binning.cu",
            "replaces": "none (radegs_tpu/ops/binning.py is XLA)", "same_bits": True,
            **{f"{k}_{label}": row[k] for label, row in res.items()
               for k in ("count_ms", "list_ms", "sort_ms", "call_ms", "plain_ms", "budget_ms",
                         "bound", "design_bound")},
            "bound_by": "bytes", "library_ms": None,
            **{f"{path}_launches": d.get("binning_count", 0) for path, d in launches.items()},
            **{f"{path}_budget_path": d.get("budget_path", 0) for path, d in launches.items()}}


def binning_launches(reset=False):
    """The binning kernels' launch counts and ``budget_path`` so far; with
    ``reset``, set to 0 after the read."""
    from radegs_torch.ops import binning as bn

    out = {**dict(bn.LAUNCHES), **dict(bn.BUDGET_PATH)}
    if reset:
        bn.reset_launches()
    return out


def preprocess_only(workdir):
    """``--preprocess``: phases 3-4 (the serving path) with the preprocess
    kernel at the dense view 0, phase 7a and phase 7b."""
    from radegs_torch.ops import blend
    from radegs_torch.ops import integrate as ig
    from radegs_torch.ops import preprocess as pp

    res = serving(workdir)
    pp.reset_launches()
    binning_launches(reset=True)
    parity = [integrate_parity(), integrate_parity(250, 190, (1.6, 0, 0))]
    n_7a = pp.LAUNCHES["preprocess_fwd[sh=0,inv=1]"]
    check(n_7a == 2, f"7a: the preprocess kernel ran {n_7a} times for 2 parity scenes")
    ig.reset_launches()  # the TSDF path starts here
    blend.reset_launches()
    pp.reset_launches()
    binning_launches(reset=True)
    views = mesh_views()
    state = load_scene(res["dpath"], res["dcap"], views)
    train_launches = train_step_launches(state, views[0][0], res["dbudget"])
    pp.reset_launches()
    binning_launches(reset=True)
    _, verts, _ = mesh_tsdf(state, views, workdir, "7b TSDF of the dense 1.2M scene")
    mesh_geometry(verts, "7b TSDF")
    n_pre = pp.LAUNCHES["preprocess_fwd[sh=3,inv=0]"]
    log(f"7b preprocess launches {dict(pp.LAUNCHES)}")
    check(n_pre == len(views), f"7b: the preprocess kernel ran {n_pre} times for {len(views)} "
          "views")
    rows = preprocess_rows(res["pre"], res["launches"])
    for row in rows:
        row.update(tsdf_launches=pp.LAUNCHES[row["name"]],
                   train_step_launches=train_launches[row["name"]])
    log(f"7a preprocess_fwd[sh=0,inv=1] launches {n_7a}, integrate max abs err "
        f"{max(p[0] for p in parity):.3e}")
    return rows


def nerf_extent(cameras):
    """The scene extent of the reference's getNerfppNorm: 1.1 x the largest
    distance of a camera centre from their mean."""
    centres = torch.stack([c.camera_center for c in cameras])
    return float(1.1 * (centres - centres.mean(0)).norm(dim=1).max())


def stage_medians(step_events):
    """Per-stage medians (ms) and counts from each iteration's (stage, event)
    marks: a stage lasts from the previous mark to its own."""
    per = {}
    for events in step_events:
        for (_, a), (name, b) in zip(events, events[1:]):
            per.setdefault(name, []).append(a.elapsed_time(b))
    return {k: float(np.median(v)) for k, v in per.items()}, {k: len(v) for k, v in per.items()}


def training_scene(path, cap, cams, budget):
    """The training set-up: the 8 views rendered from the 100k scene as
    ground truth, and ``create_from_points`` on the scene's centres jittered
    by a seeded sigma = 0.01 with seeded random colours (the KNN at P = 100k).
    Returns (scene, initial state, seconds of create_from_points)."""
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.renderer import render
    from radegs_torch.train.loop import SceneLike

    dev = torch.device(DEVICE)
    scene_state = gm.update_3d_filter(
        gm.load_gaussian_ply(path, sh_degree=3, capacity=cap, device=dev), cams)
    gts = []
    with torch.no_grad():
        for cam in cams:
            out = render(scene_state, cam, [0.0, 0.0, 0.0], kernel_size=0.1, max_per_tile=512,
                         instance_budget=budget, device=DEVICE)
            check(int(out["binning"].n_overflow) == 0, "ground truth render overflowed")
            gts.append(out["render"])
    gen = torch.Generator(device=dev).manual_seed(5)
    xyz = scene_state.params.xyz[scene_state.active]
    pts = xyz + 0.01 * torch.randn(xyz.shape, generator=gen, device=dev)
    cols = torch.rand(xyz.shape, generator=gen, device=dev)
    del scene_state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g0 = gm.create_from_points(pts, cols, sh_degree=3, device=dev)
    torch.cuda.synchronize()
    scene = SceneLike(cameras=[(c, gt, i) for i, (c, gt) in enumerate(zip(cams, gts))],
                      extent=nerf_extent(cams))
    return scene, g0, time.perf_counter() - t0


TRAIN_MCFG = dict(kernel_size=0.1)
# the opacity reset comes after the last densify (both at 80): a densify 20
# steps after a reset prunes every Gaussian, since 20 Adam steps cannot lift
# a reset opacity (0.01) past the 0.05 prune threshold (the reference leaves
# 100 steps, 3000 and 3100)
TRAIN_OCFG = dict(iterations=TRAIN_ITERS, densify_from_iter=20, densification_interval=20,
                  densify_until_iter=90, opacity_reset_interval=80, regularization_from_iter=10,
                  position_lr_max_steps=TRAIN_ITERS)


def train_100k(path, cap, cams, budget):
    """Phase 6's first part: ``train`` for 100 iterations of the 100k scene
    at 1600x1200 (at ``default_g()``), checked and reported. Returns its numbers and the
    scene extent."""
    from radegs_torch.ops import blend
    from radegs_torch.ops import preprocess as pp
    from radegs_torch.train import optim
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
    from radegs_torch.train.loop import train

    scene, g0, knn_s = training_scene(path, cap, cams, budget)
    extent = scene.extent
    mcfg, ocfg = ModelConfig(**TRAIN_MCFG), OptimizationConfig(**TRAIN_OCFG)
    pcfg = PipelineConfig(max_per_tile=512)
    n0, c0 = int(g0.n_active()), g0.capacity
    log(f"phase 6 set-up: create_from_points of {n0} points (KNN included) {knn_s:.3f} s, "
        f"capacity {c0}, scene extent {extent:.4f}")

    # ---- the training path starts here ----
    blend.reset_launches()
    pp.reset_launches()
    binning_launches(reset=True)
    optim.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_events, host = [], []
    t0 = time.perf_counter()
    ts, hist = train(scene, g0, mcfg, ocfg, pcfg, seed=0, log_every=1, device=DEVICE,
                     step_events=step_events,
                     callbacks=[lambda it, ts, m: host.append(time.perf_counter())])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches_100 = dict(blend.LAUNCHES)
    losses = [h["loss"] for h in hist]
    first, mid = float(np.mean(losses[:10])), float(np.mean(losses[50:60]))
    n_densify = sum(any(n == "densify" for n, _ in ev) for ev in step_events)
    n_reset = sum(any(n == "reset_opacity" for n, _ in ev) for ev in step_events)
    overflowed = [h["iteration"] for h in hist if h["n_overflow"] > 0]
    med, counts = stage_medians(step_events)
    host_ms = 1e3 * float(np.median(np.diff(host)))
    log(f"phase 6 training 100k 1600x1200 G={default_g()}, {TRAIN_ITERS} iterations in "
        f"{wall:.3f} s: "
        f"median ms per iteration {host_ms:.3f} (host clock); CUDA-event medians ms: "
        + ", ".join(f"{k} {v:.3f} (x{counts[k]})" for k, v in med.items())
        + f"; n_active {n0} -> {int(ts.gaussians.n_active())}, capacity {c0} -> "
        f"{ts.gaussians.capacity}; densify {n_densify}x, opacity reset {n_reset}x; peak memory "
        f"{peak / 2**30:.3f} GiB; kernel launches {launches_100}")
    log("  loss per iteration: " + " ".join(f"{x:.5f}" for x in losses))
    log("  n_instances per iteration: " + " ".join(str(int(h["n_instances"])) for h in hist))
    log("  n_active after iterations " + ", ".join(
        f"{h['iteration']}: {h['n_active']}" for h in hist if h["iteration"] in DENSIFY_LOG))
    log(f"  iterations with instance overflow: {overflowed}; tile overflow at "
        f"{[h['iteration'] for h in hist if h['tile_overflow'] > 0]}; psnr first/last "
        f"{hist[0]['psnr']:.3f} / {hist[-1]['psnr']:.3f}")
    check(len(losses) == TRAIN_ITERS and all(math.isfinite(x) for x in losses),
          "training losses not finite")
    for name, p in ts.gaussians.params.items():
        check(bool(torch.isfinite(p).all()), f"parameter {name} not finite after training")
    check(mid < first, f"loss did not fall: iterations 1-10 {first}, 51-60 {mid}")
    check(n_densify >= 3 and n_reset == 1, f"densify ran {n_densify}x, reset {n_reset}x")
    check(hist[-1]["n_active"] > 0, "training ended with no Gaussian")
    check(all(h["n_overflow"] == 0 for h in hist[-20:]),
          f"instance overflow after the autotune settled: {overflowed}")
    # a step bins once; the iterations that overflowed were cut by the kernels
    check_binning_path("phase 6's iterations", binning_launches(), cut=len(overflowed))
    g = default_g()
    check(launches_100[f"blend_bwd[G={g}]"] == TRAIN_ITERS,
          f"blend_bwd[G={g}] launched {launches_100[f'blend_bwd[G={g}]']}x in {TRAIN_ITERS} "
          "steps")
    results = dict(train_med=med, train_host_ms=host_ms, train_peak=peak, loss_first=first,
                   loss_mid=mid)
    del ts, g0, scene, hist
    torch.cuda.empty_cache()
    return results, extent


def training(res):
    """Phase 6: the training path at full width on the 100k scene, then
    train steps at converged scale (the backward alone there is phase 5's
    shape (b))."""
    from dataclasses import replace

    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.ops import blend
    from radegs_torch.ops import preprocess as pp
    from radegs_torch.train import optim
    from radegs_torch.ops.binning import round_budget
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
    from radegs_torch.train.loop import TrainState, make_train_step

    dev = torch.device(DEVICE)
    cams = res["cams"]
    # ---- the training path starts here (blend.reset_launches in train_100k) ----
    results, extent = train_100k(res["path"], res["cap"], cams, res["budget"])
    mcfg, ocfg = ModelConfig(**TRAIN_MCFG), OptimizationConfig(**TRAIN_OCFG)
    pcfg = PipelineConfig(max_per_tile=512)

    # ---- converged scale: train steps on the dense scene, G=2 then G=1, with
    # one budget segment above the served demand (the steps move the scales) ----
    dstate = gm.update_3d_filter(
        gm.load_gaussian_ply(res["dpath"], sh_degree=3, capacity=res["dcap"], device=dev), cams)
    gt = torch.full((3, HEIGHT, WIDTH), 0.5, device=dev)
    bg = torch.zeros(3, device=dev)
    dts = TrainState(gaussians=dstate, iteration=ocfg.regularization_from_iter)
    dbudget = round_budget(res["dbudget"] + 1)
    del dstate
    torch.cuda.reset_peak_memory_stats()
    drows = []
    dense_bin = binning_launches()
    for g in (2, 2, 1, 1):
        step = make_train_step(mcfg, ocfg, replace(pcfg, max_per_tile=8192, tiles_per_block=g,
                                                   instance_budget=dbudget),
                               spatial_lr_scale=extent)
        events = []
        t0 = time.perf_counter()
        dts, met = step(dts, cams[0], gt, bg, 0, WIDTH, HEIGHT, events=events)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        check(int(met["n_overflow"]) == 0 and math.isfinite(float(met["loss"])),
              f"dense step: overflow {int(met['n_overflow'])}, loss {float(met['loss'])}")
        stages, _ = stage_medians([events])
        drows.append((g, wall, stages, int(met["n_instances"])))
    dpeak = torch.cuda.max_memory_allocated()
    launches = dict(blend.LAUNCHES)  # the training path ends here
    pre_launches = dict(pp.LAUNCHES)
    adam_launches = dict(optim.LAUNCHES)
    bin_launches = binning_launches()
    check_binning_path("phase 6's dense steps", {k: bin_launches[k] - v for k, v in
                                                 dense_bin.items()}, cut=0)
    for g, wall, stages, n in drows:
        log(f"phase 6 dense train step G={g}: {wall:.3f} ms (host clock), "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f" ms; {n} instances")
    log(f"phase 6 dense peak memory {dpeak / 2**30:.3f} GiB; training path kernel launches "
        f"{launches}, preprocess {pre_launches}")
    check(all(v > 0 for v in launches.values()), f"a kernel never ran on the training path: "
          f"{launches}")

    check(adam_launches["adam_stats"] == TRAIN_ITERS + len(drows),
          f"the training path launched adam_stats {adam_launches} times, not once a step")
    results.update(launches=launches, pre_launches=pre_launches, adam_launches=adam_launches,
                   binning_launches=bin_launches, dense_rows=drows, dense_peak=dpeak)
    return results


# ------------------------------------------------------------ phase 7 ----


def surface_distance(verts, band=(0.0, 0.0)):
    """Distance of each vertex to the nearer surface of ``surface_points``:
    the sphere r = 1.3 and the plane y = -1.4, each widened to a shell of
    half-width ``band`` (sphere, plane). Returns (distance, the share of
    vertices nearer the sphere, their median radius, the others' median y)."""
    v = np.asarray(verts, np.float64)
    r = np.linalg.norm(v, axis=1)
    ds, dp = np.abs(r - 1.3), np.abs(v[:, 1] + 1.4)
    near_s = ds < dp
    d = np.minimum(np.maximum(ds - band[0], 0.0), np.maximum(dp - band[1], 0.0))
    return (d, float(near_s.mean()), float(np.median(r[near_s])) if near_s.any() else 0.0,
            float(np.median(v[~near_s, 1])) if (~near_s).any() else 0.0)


def mesh_geometry(verts, label):
    """The geometric check of phases 7b and 7c: the median distance of the
    vertices to the scene's surfaces. The splat centres lie on NOISY
    surfaces (bench.py: radial noise sigma 0.05 on the sphere, 0.02 on the
    plane) and opaque splats present the OUTER envelope of that noise, so
    the check measures to the 2-sigma shells (r = 1.3 +- 0.1, y = -1.4 +-
    0.04); the distance to the noise-free surfaces is reported beside it."""
    d, share, r_med, y_med = surface_distance(verts, SHELL_BAND)
    d0 = surface_distance(verts)[0]
    dist, dist0 = float(np.median(d)), float(np.median(d0))
    log(f"  {label} geometry: median distance to the 2-sigma shells {dist:.5f}, to the "
        f"noise-free sphere / plane {dist0:.5f}; {share:.4f} of the vertices nearer the "
        f"sphere (median radius {r_med:.5f}), the rest median y {y_med:.5f}")
    check(dist < MESH_VIEWS_DIST_TOL, f"{label} mesh median distance {dist}")
    return dist, dist0


def frustum_points(cam, n_in, n_out, n_behind, rng):
    """World points in the camera's frustum (random pixel, depth 1.5-7),
    beside the image (pixel coordinates up to half a width outside), and
    behind the camera."""
    W, H = cam.width, cam.height
    fx, fy = float(cam.focal_x), float(cam.focal_y)
    u = np.concatenate([rng.uniform(0, W, n_in), rng.uniform(-0.5 * W, 0, n_out),
                        rng.uniform(0, W, n_behind)])
    v = np.concatenate([rng.uniform(0, H, n_in), rng.uniform(0, H, n_out),
                        rng.uniform(0, H, n_behind)])
    d = np.concatenate([rng.uniform(1.5, 7, n_in + n_out), -rng.uniform(0.5, 3, n_behind)])
    p_view = np.stack([(u - W / 2) / fx * d, (v - H / 2) / fy * d, d], 1)
    R, T = cam.R.cpu().numpy().astype(np.float64), cam.T.cpu().numpy().astype(np.float64)
    return ((p_view - T) @ R.T).astype(np.float32)  # p_view = R^T p + T


def integrate_bound_ms(kind, P, n_inst, T, n_points, work, least=True):
    """Least time for an integrate kernel's work on these inputs: features,
    gauss_id and tile ranges read once, the outputs written once (B5: 13
    rows + the median index per pixel; B6: the points' xy and depth read,
    one alpha written), and the counted walk at FP32 peak. The full-gate walk
    (``least=False``): each pixel's or point's 5 samples gated, the exp
    wherever the power test passes; the least walk: B5 gates each tile's
    distinct samples once, and both take the exp only where alpha reaches
    1/255."""
    if kind == "image":
        n_bytes = P * 12 * 4 + n_inst * 4 + T * 8 + T * 14 * 256 * 4
        if least:
            ops = (OPS_SAMPLE * TILE_SAMPLES * (work["n_pairs"] // 256)
                   + OPS_INT_POWER * work["n_lat_alpha"] + OPS_IMG_TAKEN * work["n_lat_taken"]
                   + OPS_IMG_CENTRE * work["n_centre"])
        else:
            ops = (OPS_INT_PAIR * work["n_pairs"] + OPS_INT_POWER * work["n_power"]
                   + OPS_IMG_TAKEN * work["n_taken"] + OPS_IMG_CENTRE * work["n_centre"])
    else:
        n_bytes = P * 16 * 4 + n_inst * 4 + T * 8 + n_points * 16
        ops = (OPS_INT_PAIR * work["n_pairs"]
               + OPS_INT_POWER * work["n_alpha" if least else "n_power"]
               + OPS_PT_USED * work["n_used"] + OPS_PT_INC * work["n_inc"])
    ops = int(ops)
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), n_bytes, ops


def integrate_demand(state, cameras):
    """The largest radius-only instance demand over the views (binned with a
    budget of 1: the count is taken before the budget cut)."""
    from radegs_torch.ops.binning import bin_gaussians
    from radegs_torch.renderer import prepare

    need = 0
    with torch.no_grad():
        for cam in cameras:
            prep = prepare(state, cam, 0.1)
            b = bin_gaussians(prep.xy, prep.radius, prep.depth, prep.valid, WIDTH, HEIGHT,
                              instance_budget=1, max_per_tile=8192)
            need = max(need, int(b.n_instances))
    return need


def compare_image(rows_k, med_k, rows_p, med_p):
    """Max abs error over the float rows 0:8, the share of pixels whose
    median contributor differs, and the median depth / mid_* error where it
    is the same."""
    err = (rows_k[:, :8] - rows_p[:, :8]).abs()
    same = med_k == med_p
    med_err = max((rows_k[:, 4] - rows_p[:, 4]).abs()[same].max().item(),
                  (rows_k[:, 8:] - rows_p[:, 8:]).abs().amax(1)[same].max().item())
    return err[:, [0, 1, 2, 3, 5, 6, 7]].max().item(), 1.0 - same.float().mean().item(), med_err


def integrate_parity(W=256, H=256, target=(0, 0, 0)):
    """Phase 7a: B5 and B6 against their plain versions on the parity scene
    of phase 2 (with the inverse ray-space covariance, radius-only binning),
    the scene a state (log-scales, opacity logits, no 3D filter) whose
    preprocess is ``prepare``'s, as ``integrate_prepare``'s: on a card the
    preprocess kernel makes the integrate kernels' inputs."""
    from radegs_torch.core.camera import Camera
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.ops import integrate as ig
    from radegs_torch.ops.binning import bin_gaussians
    from radegs_torch.renderer import prepare

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(3)
    P = 2000
    cam = Camera.look_at([0, 0.3, -4.0], target, [0, 1, 0], 0.9, 0.9, W, H, device=dev)
    centres = rng.normal(size=(P, 3)) * 0.9
    scales, opac = rng.uniform(0.02, 0.25, (P, 3)), rng.uniform(0.05, 0.95, (P, 1))
    shs, quats = rng.uniform(0, 1, (P, 1, 3)), np.tile([1.0, 0, 0, 0], (P, 1))
    state = gm.state_from_arrays(centres, shs, np.zeros((P, 0, 3)), np.log(scales), quats,
                                 np.log(opac / (1 - opac)), np.ones(P, bool), np.zeros((P, 1)),
                                 0, 0, device=dev)
    with torch.no_grad():
        prep = prepare(state, cam, 0.1, compute_invraycov=True)
    binning = bin_gaussians(prep.xy, prep.radius, prep.depth, prep.valid, W, H,
                            instance_budget=1 << 16, max_per_tile=2048, need_tile_gauss=True)
    feat = ig.image_features(prep)
    r1, m1 = ig.integrate_image_rows(binning, feat, W, H)
    r2, m2 = ig.integrate_image_rows(binning, feat, W, H)
    rp, mp = ig.integrate_image_torch(binning.tile_gauss, feat, W, H)
    torch.cuda.synchronize()
    check(torch.equal(r1, r2) and torch.equal(m1, m2), "integrate_image differs between runs")
    img_err, flips, med_err = compare_image(r1, m1, rp, mp)

    # ~20k query points: near the splats, in the frustum, beside the image,
    # behind the camera
    pts_np = np.concatenate([
        (centres[rng.integers(0, P, 8000)] + rng.normal(size=(8000, 3)) * 0.05),
        frustum_points(cam, 8000, 2000, 2000, rng)]).astype(np.float32)
    pts = ig.project_points(torch.from_numpy(pts_np).to(dev), cam)
    pfeat = ig.point_features(prep)
    a1 = ig.integrate_points_alpha(binning, pfeat, pts, W, H)
    a2 = ig.integrate_points_alpha(binning, pfeat, pts, W, H)
    mid_k = {k: r1[:, 8 + j] for j, k in enumerate(ig.MID_KEYS)}
    mid_p = {k: rp[:, 8 + j] for j, k in enumerate(ig.MID_KEYS)}
    ap, sdf_p = ig.integrate_points_torch(binning.tile_gauss, pfeat, pts, mid_p, (W + 15) // 16)
    sdf_k = ig.point_sdf_from_mid(pts, mid_k, (W + 15) // 16)
    torch.cuda.synchronize()
    check(torch.equal(a1, a2), "integrate_points differs between runs")
    a_err = (a1 - ap).abs().max().item()
    # the SDF where the point's pixel has the same median contributor
    within = (pts.pixel[:, 1] % 16) * 16 + (pts.pixel[:, 0] % 16)
    same_px = (m1 == mp)[pts.tile, within]
    max_depth = max(rp[:, 5].max().item(), 1e-30)
    sdf_err = (sdf_k - sdf_p).abs()[same_px].max().item() / max_depth
    n_valid = int(pts.valid.sum())
    log(f"phase 7a integrate parity {W}x{H}: n_instances {int(binning.n_instances)}, "
        f"max per tile {int(binning.max_tile_count)}, empty tiles "
        f"{int((binning.tile_count == 0).sum())} of {binning.tile_count.numel()}; "
        f"integrate_image run==rerun bitwise, float rows max abs err {img_err:.3e}, median "
        f"contributor differs at {flips:.3e} of the pixels, median depth / mid_* err where "
        f"it agrees {med_err:.3e}; integrate_points over {pts_np.shape[0]} points "
        f"({n_valid} valid) run==rerun bitwise, alpha max abs err {a_err:.3e}, SDF err / max "
        f"depth {sdf_err:.3e}")
    check(img_err <= ABS_TOL and a_err <= ABS_TOL, f"integrate kernels vs plain: image "
          f"{img_err}, alpha {a_err}")
    check(flips <= MED_POS_TOL and med_err == 0.0, f"median contributor flips {flips}, "
          f"median error where it agrees {med_err}")
    check(sdf_err <= SDF_REL_TOL, f"SDF error {sdf_err} of the max depth")
    check(0 < n_valid < pts_np.shape[0], "the query points miss a class")
    return max(img_err, a_err), img_err, a_err


def mesh_views():
    return [(cam, None, i) for i, cam in enumerate(orbit_cameras(N_VIEWS, torch.device(DEVICE)))]


def load_scene(path, cap, views):
    from radegs_torch.models import gaussian_model as gm

    return gm.update_3d_filter(gm.load_gaussian_ply(path, sh_degree=3, capacity=cap,
                                                    device=torch.device(DEVICE)),
                               [v[0] for v in views])


def mesh_tsdf(state, views, workdir, label, max_resolution=768):
    """``extract_mesh_tsdf`` over ``views`` (voxel 0.004, ``max_resolution``),
    written with ``write_mesh`` and read back; fails unless > 10k faces and
    ``blend_fwd`` ran once per view."""
    from radegs_torch.mesh.tsdf import extract_mesh_tsdf
    from radegs_torch.ops import blend
    from radegs_torch.utils import ply as plyio

    before = sum(blend.LAUNCHES.values())
    stats = {}
    out = os.path.join(workdir, "tsdf.ply")
    t0 = time.perf_counter()
    verts, faces = extract_mesh_tsdf(state, views, 0.1, [0.0, 0.0, 0.0], voxel_size=0.004,
                                     out_path=out, max_per_tile=8192,
                                     max_resolution=max_resolution,
                                     verbose=False, device=DEVICE, stats=stats)
    wall = time.perf_counter() - t0
    n_blend = sum(blend.LAUNCHES.values()) - before
    rv, rf = plyio.read_mesh(out)
    log(f"phase {label}, {len(views)} views at {WIDTH}x{HEIGHT}: {wall:.3f} s "
        f"(depth maps {stats['depth_maps']:.3f}, block marking {stats['mark']:.3f}, "
        f"fusion {stats['fuse']:.3f}, meshing {stats['mesh']:.3f}); "
        f"{stats['active_blocks']} active blocks; {len(verts)} vertices, {len(faces)} "
        f"faces; blend_fwd launches {n_blend}")
    check(len(faces) > 10_000, f"{label}: TSDF mesh has {len(faces)} faces")
    check(n_blend == len(views), f"{label}: blend_fwd ran {n_blend} times for {len(views)} views")
    check(rv.shape == verts.shape and rf.shape == faces.shape, f"{label}: PLY does not read back")
    return dict(wall=wall, stats=stats, n_verts=len(verts), n_faces=len(faces)), verts, faces


@contextlib.contextmanager
def timed_integrate():
    """CUDA events around every call of the two integrate kernel wrappers
    (the launch and its wrapper's packing; for B6 the point sort and work
    items, as phase 7d times them). Yields the list of (kernel, query
    points, start, end) it fills."""
    from radegs_torch.ops import integrate as ig

    calls = []

    def timed(name, fn, n_points):
        def call(*args):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args)
            end.record()
            calls.append((name, n_points(args), start, end))
            return out
        return call

    orig = ig.integrate_image_rows, ig.integrate_points_alpha
    ig.integrate_image_rows = timed("integrate_image", orig[0], lambda a: 0)
    ig.integrate_points_alpha = timed("integrate_points", orig[1], lambda a: a[2].xy.shape[0])
    try:
        yield calls
    finally:
        ig.integrate_image_rows, ig.integrate_points_alpha = orig


def mesh_tetra(state, views, workdir, label, n_binary_steps=8):
    """``extract_mesh_tetrahedra`` over ``views`` (``decimate="auto"``, the
    instance budget from the measured radius-only demand), the integrate
    wrappers timed by ``timed_integrate``; fails unless > 1000 faces,
    ``integrate_image`` ran once per view and ``integrate_points`` at least
    (1 + n_binary_steps) times per view."""
    from radegs_torch.mesh.extract_tetra import extract_mesh_tetrahedra
    from radegs_torch.ops import integrate as ig
    from radegs_torch.ops.binning import round_budget

    need = integrate_demand(state, [v[0] for v in views])
    budget = round_budget(need)
    before = dict(ig.LAUNCHES)
    stats = {}
    t0 = time.perf_counter()
    with timed_integrate() as events:
        verts, faces = extract_mesh_tetrahedra(
            state, views, 0.1, [0.0, 0.0, 0.0], out_path=os.path.join(workdir, "tetra.ply"),
            n_binary_steps=n_binary_steps, max_per_tile=8192, instance_budget=budget,
            verbose=False, decimate="auto", device=DEVICE, stats=stats)
    wall = time.perf_counter() - t0
    launches = {k: ig.LAUNCHES[k] - before[k] for k in before}
    torch.cuda.synchronize()
    b5_ms = sum(a.elapsed_time(b) for name, _, a, b in events if name == "integrate_image")
    # B6 per SDF pass: the first pass walks the seeds, every binary-search
    # step the crossing edges' midpoints (one launch per view and chunk)
    b6 = [(n, a.elapsed_time(b)) for name, n, a, b in events if name == "integrate_points"]
    n_cross = stats["n_crossing"]
    b6_first = sum(ms for n, ms in b6 if n != n_cross)
    b6_step = sum(ms for n, ms in b6 if n == n_cross) / max(n_binary_steps, 1)
    log(f"phase {label}, {len(views)} views at {WIDTH}x{HEIGHT}, instance budget {budget} "
        f"(radius-only demand {need}): {wall:.3f} s; seeds {stats['n_seeds']} -> "
        f"{stats['n_seeds_decimated']} after the dedup; Delaunay {stats['delaunay_s']:.3f} s, "
        f"{stats['n_cells']} cells; {n_cross} crossing edges, {len(verts)} vertices, "
        f"{len(faces)} faces; wrapper calls: integrate_image {b5_ms:.3f} ms over the views; "
        f"integrate_points {b6_first:.3f} ms in the first SDF pass, {b6_step:.3f} ms per "
        f"binary-search step ({len(b6)} launches); SDF pass s {stats['sdf_pass_s']}; "
        f"launches {launches}")
    check(len(faces) > 1000, f"{label}: tetra mesh has {len(faces)} faces")
    check(launches["integrate_image"] == len(views),
          f"{label}: integrate_image ran {launches['integrate_image']} times for "
          f"{len(views)} views")
    check(launches["integrate_points"] >= (1 + n_binary_steps) * len(views),
          f"{label}: integrate_points ran {launches['integrate_points']} times")
    return dict(wall=wall, stats=stats, n_verts=len(verts), n_faces=len(faces), b5_ms=b5_ms,
                b6_first_ms=b6_first, b6_step_ms=b6_step), verts, faces


def splat_sigmas(state):
    """Median splat sigma (the KNN scale) of the sphere's and the plane's splats."""
    act = state.active
    xyz = state.params.xyz[act].cpu().numpy().astype(np.float64)
    sig = state.get_scaling()[act][:, 0].cpu().numpy()
    near_s = np.abs(np.linalg.norm(xyz, axis=1) - 1.3) < np.abs(xyz[:, 1] + 1.4)
    return float(np.median(sig[near_s])), float(np.median(sig[~near_s]))


def clean_geometry(verts, sigmas, label):
    """The witness check of phase 7e on the noise-free scene: the phase 7b
    median distance to the analytic surfaces (< 0.1), and that distance in
    splat sigmas of the nearer surface (< CLEAN_SIGMA_TOL). A depth or
    meshing fault that moves the surface by the 0.07 left unexplained on the
    noisy scenes would show here as ~3 sigma of the sphere's splats."""
    v = np.asarray(verts, np.float64)
    rs = np.linalg.norm(v, axis=1) - 1.3  # outward offsets
    yp = v[:, 1] + 1.4
    near_s = np.abs(rs) < np.abs(yp)
    d = np.where(near_s, np.abs(rs), np.abs(yp))
    dn = np.where(near_s, np.abs(rs) / sigmas[0], np.abs(yp) / sigmas[1])
    dist, dist_sigma = float(np.median(d)), float(np.median(dn))
    off_s = float(np.median(rs[near_s])) if near_s.any() else 0.0
    off_p = float(np.median(yp[~near_s])) if (~near_s).any() else 0.0
    log(f"  {label} geometry (noise-free surfaces): median distance {dist:.5f} = "
        f"{dist_sigma:.3f} splat sigmas (sphere sigma {sigmas[0]:.5f}, plane "
        f"{sigmas[1]:.5f}); {near_s.mean():.4f} of the vertices nearer the sphere, median "
        f"outward offset {off_s:.5f} there, {off_p:.5f} above the plane")
    check(dist < MESH_VIEWS_DIST_TOL, f"{label} mesh median distance {dist}")
    check(dist_sigma < CLEAN_SIGMA_TOL, f"{label} mesh median distance {dist_sigma} sigmas")
    return dict(dist=dist, dist_sigma=dist_sigma, off_sphere=off_s, off_plane=off_p)


def mesh_witness(workdir):
    """Phase 7e: the noise-free witness scene (``surface_points(50_000)``
    without its noise, KNN scales, opacity 0.8): TSDF and tetra held to the
    analytic surfaces; then ``extract_mesh_unbounded`` (resolution 256) and
    ``cull_mesh`` + ``post_process_mesh`` of the tetra mesh on the card."""
    from radegs_torch.mesh.culling import cull_mesh, post_process_mesh
    from radegs_torch.mesh.unbounded import extract_mesh_unbounded
    from radegs_torch.ops.binning import default_instance_budget

    views = mesh_views()
    path = os.path.join(workdir, "clean50k.ply")
    cap = scene_ply(path, "clean50k")
    state = load_scene(path, cap, views)
    need = integrate_demand(state, [v[0] for v in views])
    check(need <= default_instance_budget(cap), f"7e render budget below the demand {need}")
    sigmas = splat_sigmas(state)
    # 384^3, not 7b's 768^3: the host meshing of the larger grid took 80 s
    # here, and phase 8 meshes this scene's dataset again
    tsdf, verts, _ = mesh_tsdf(state, views, workdir, "7e TSDF of the noise-free 50k scene",
                               max_resolution=WITNESS_TSDF_RES)
    tsdf_geo = clean_geometry(verts, sigmas, "7e TSDF")
    tetra, verts, faces = mesh_tetra(state, views, workdir,
                                     "7e tetra of the noise-free 50k scene")
    tetra_geo = clean_geometry(verts, sigmas, "7e tetra")

    t0 = time.perf_counter()
    uv, uf, uc = extract_mesh_unbounded(state, views, 0.1, [0.0, 0.0, 0.0], resolution=256,
                                        block=64, max_per_tile=8192, verbose=False,
                                        device=DEVICE)
    t_unb = time.perf_counter() - t0
    d_unb = float(np.median(surface_distance(uv)[0]))
    log(f"phase 7e unbounded (resolution 256): {t_unb:.3f} s, {len(uv)} vertices, {len(uf)} "
        f"faces; median distance to the noise-free surfaces {d_unb:.5f}")
    check(len(uf) > 10_000 and uc.shape == (len(uv), 3), f"7e unbounded mesh: {len(uf)} faces")
    check(d_unb < MESH_VIEWS_DIST_TOL, f"7e unbounded mesh median distance {d_unb}")

    t0 = time.perf_counter()
    cv, cf = cull_mesh(verts, faces, [v[0] for v in views], min_views=1, device=DEVICE)
    pv, pf = post_process_mesh(cv, cf)
    t_cull = time.perf_counter() - t0
    log(f"phase 7e culling of the tetra mesh: {t_cull:.3f} s; {len(faces)} faces -> "
        f"{len(cf)} seen from a view -> {len(pf)} in the large clusters")
    check(0 < len(pf) <= len(cf) <= len(faces), "7e culling emptied the mesh")
    del state
    torch.cuda.empty_cache()
    return dict(sigmas=sigmas, tsdf=tsdf, tsdf_geo=tsdf_geo, tetra=tetra, tetra_geo=tetra_geo,
                unbounded=dict(wall=t_unb, n_faces=len(uf), dist=d_unb),
                cull=dict(wall=t_cull, n_faces=len(cf), n_kept=len(pf)))


def integrate_entry(lib, kernel, text):
    """``radegs_<kernel>`` of a built library, with its ctypes signature read
    from the kernel's source ``text`` (B5 may take a tile order, B6 the
    points per item; an older checkout's entries take neither). Returns
    (function, pointer count, int count)."""
    import ctypes

    fn = getattr(lib, f"radegs_{kernel}")
    if kernel == "integrate_image":
        n_ptr, n_int = (7 if "const void* tile_order" in text else 6), 2
    else:
        n_ptr, n_int = 10, (2 if "int points_per_item" in text else 1)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, n_ptr, n_int


def integrate_libraries(other):
    """The integrate C entries that --integrate holds beside this tree's:
    copies of this tree's sources with other constants or a piece of text
    replaced (INTEGRATE_VARIANTS) and, when ``other`` names the csrc
    directory of another checkout, its two integrate kernels and its
    integrate_points.cu rebuilt with ITEM = BATCH = 32 (one warp a work
    item, the items cut at 32), all built at once
    (``build.build_copies``, into build/chip_smoke/integrate/). Prints each
    build's ptxas register and spill lines. Returns {label: (kernel,
    ``integrate_entry``, items, floats)}: ``items`` None for this tree's work
    items, else the points per item of a list in tile order, stable in the
    point id (``tile_items``); ``floats`` the width of the feature rows
    the kernel reads (its first columns of this tree's rows)."""
    from radegs_torch.native import build

    def floats(text):
        return 4 * int(re.search(r"constexpr int NF = (\d+);", text).group(1))

    copies, meta = {}, {}
    for label, (kernel, edit) in INTEGRATE_VARIANTS.items():
        text = (build.CSRC / f"{kernel}.cu").read_text()
        if isinstance(edit, dict):
            text = build.with_constants(text, edit)
        else:
            check(edit[0] in text, f"integrate variant {label}: no {edit[0]!r} in {kernel}.cu")
            text = text.replace(*edit)
        copies[label], meta[label] = (text, build.CSRC), (kernel, None)
    if other:
        for kernel in ("integrate_image", "integrate_points"):
            text = open(os.path.join(other, f"{kernel}.cu")).read()
            item = re.search(r"constexpr int ITEM = (\d+);", text)
            copies[f"other {kernel}"] = text, other
            meta[f"other {kernel}"] = kernel, (int(item.group(1)) if item else None)
        text = copies["other integrate_points"][0]
        copies["other integrate_points ITEM=32"] = (
            build.with_constants(text, {"ITEM": 32, "BATCH": 32}), other)
        meta["other integrate_points ITEM=32"] = "integrate_points", 32
    libs = {}
    for label, (lib, out) in build.build_copies(
            copies, os.path.join(ROOT, "build", "chip_smoke", "integrate")).items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {label}: {line.strip()}")
        kernel, items = meta[label]
        text = copies[label][0]
        libs[label] = kernel, integrate_entry(lib, kernel, text), items, floats(text)
    return libs


def tile_items(pts, T, per_item):
    """Work items of the block-per-item design: valid points in tile order,
    stable in the id, each tile's run cut into items of at most ``per_item``
    points."""
    dev = pts.tile.device
    vid = pts.valid.nonzero()[:, 0]
    tiles_s, idx = torch.sort(pts.tile[vid], stable=True)
    counts = torch.bincount(tiles_s, minlength=T)
    n_items = (counts + per_item - 1) // per_item
    item_tile = torch.repeat_interleave(torch.arange(T, device=dev), n_items)
    first = torch.cumsum(n_items, 0) - n_items
    k = torch.arange(item_tile.shape[0], device=dev) - first[item_tile]
    item_start = (torch.cumsum(counts, 0) - counts)[item_tile] + k * per_item
    item_count = torch.clamp_max(counts[item_tile] - k * per_item, per_item)
    return tuple(x.to(torch.int32) for x in (vid[idx], item_tile, item_start, item_count))


class PointLaunch:
    """One B6 launch through a C entry on prepared work items: this tree's
    (``per_item`` None; heaviest tile first as its wrapper lists them, or in
    tile order) or a list cut at ``per_item`` (``tile_items``, in tile
    order)."""

    def __init__(self, binning, pfeat_table, pts, T, per_item=None, heavy_first=True):
        from radegs_torch.ops import integrate as ig

        if per_item is None:
            self.order, it, ist, ic = ig.point_work_items(pts, binning.tile_count)
            if not heavy_first:  # back to tile order, the unused entries last
                perm = torch.argsort(torch.where(ic > 0, ist, ist.numel() + pts.tile.numel()))
                it, ist, ic = it[perm], ist[perm], ic[perm]
        else:
            self.order, it, ist, ic = tile_items(pts, T, per_item)
        self.per_item = ig.POINTS_PER_ITEM if per_item is None else per_item
        self.items = it, ist, ic
        sel = self.order.long()
        self.pfeat = torch.stack([pts.xy[sel, 0], pts.xy[sel, 1], pts.depth[sel],
                                  torch.zeros_like(pts.depth[sel])], 1).contiguous()
        self.out = torch.ones((pts.xy.shape[0],), dtype=torch.float32, device=pts.xy.device)
        self.binning, self.table = binning, pfeat_table

    def __call__(self, entry):
        (fn, _, n_int), b, (it, ist, ic) = entry, self.binning, self.items
        ints = (it.shape[0], self.per_item)[:n_int]
        rc = fn(self.table.data_ptr(), b.gauss_id.data_ptr(), b.tile_start.data_ptr(),
                b.tile_count.data_ptr(), self.pfeat.data_ptr(), self.order.data_ptr(),
                it.data_ptr(), ist.data_ptr(), ic.data_ptr(), self.out.data_ptr(), *ints,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"integrate_points launch failed with CUDA error {rc}")
        return self.out


def in_turns(calls, first, reps=5):
    """Device ms of each call alone (``graph_ms``, ``reps`` launches), the
    labels ``first`` (this tree, and the other checkout's if given) timed in
    turns around the rest: first, reversed(first), the rest, first,
    reversed(first). Returns {label: [ms, ...]}."""
    rest = [k for k in calls if k not in first]
    seq = list(first) + list(reversed(first)) + rest + list(first) + list(reversed(first))
    ms = {}
    for k in seq:
        ms.setdefault(k, []).append(round(graph_ms(calls[k], reps), 4))
    return ms


def integrate_ab(libs, binning, feat, pfeat, point_sets):
    """--integrate at the dense view 0: this tree's B5 and B6 against the C
    entries of ``libs`` on the same inputs. Every output must equal this
    tree's bit for bit (B5 in natural and heaviest-first tile order where the
    kernel takes one; B6 over each of ``point_sets``, {name: points}). Device
    ms per launch, alone in CUDA graphs, in turns (``in_turns``)."""
    from radegs_torch.native import build
    from radegs_torch.ops import integrate as ig

    W, H, T = WIDTH, HEIGHT, binning.tile_count.numel()
    tiles_x = (W + 15) // 16
    tree = {k: integrate_entry(build.load(k), k, (build.CSRC / f"{k}.cu").read_text())
            for k in ("integrate_image", "integrate_points")}
    other = [k for k in libs if k.startswith("other ")]
    heavy = ig.heaviest_first(binning.tile_count)

    def image_call(entry, order=None, floats=ig.N_IMG_FEAT):
        fn, n_ptr, _ = entry
        rows = torch.empty((T, 13, 256), dtype=torch.float32, device=DEVICE)
        med = torch.empty((T, 256), dtype=torch.int32, device=DEVICE)
        table = feat[:, :floats].contiguous()
        head = [table.data_ptr(), binning.gauss_id.data_ptr(), binning.tile_start.data_ptr(),
                binning.tile_count.data_ptr()]
        if n_ptr == 7:
            head.append(order.data_ptr())

        def call(table=table):  # the table lives as long as the call
            rc = fn(*head, rows.data_ptr(), med.data_ptr(), T, tiles_x,
                    torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"integrate_image launch failed with CUDA error {rc}")
            return rows, med
        return call

    # this tree's wrapper launches the tiles heaviest first
    calls = {"tree": image_call(tree["integrate_image"], heavy),
             "tree, tiles in natural order": image_call(
                 tree["integrate_image"], torch.arange(T, dtype=torch.int32, device=DEVICE))}
    for label, (kernel, entry, _, floats) in libs.items():
        if kernel == "integrate_image":
            calls[label] = image_call(entry, heavy if entry[1] == 7 else None, floats)
    ref = [x.clone() for x in calls["tree"]()]
    same = {k: all(torch.equal(a, b) for a, b in zip(c(), ref)) for k, c in calls.items()}
    img_first = ["tree"] + [k for k in other if k.endswith("integrate_image")]
    img_ms = in_turns(calls, img_first)
    log(f"--integrate B5 at the dense view 0 ({T} tiles): equal to this tree bitwise {same}; "
        f"device ms per launch (graph of 5, in turns) {img_ms}")
    check(all(same.values()), f"B5 outputs differ from this tree's: {same}")

    for name, pts in point_sets.items():
        entry = tree["integrate_points"]
        launches = {"tree": (PointLaunch(binning, pfeat, pts, T), entry),
                    "tree, points in tile order": (
                        PointLaunch(binning, pfeat, pts, T, ig.POINTS_PER_ITEM), entry),
                    "tree, items in tile order": (
                        PointLaunch(binning, pfeat, pts, T, heavy_first=False), entry)}
        for label, (kernel, lib_entry, items, floats) in libs.items():
            if kernel == "integrate_points":
                launches[label] = (PointLaunch(binning, pfeat[:, :floats].contiguous(), pts, T,
                                               items), lib_entry)
        calls = {k: (lambda lp=lp, fn=fn: lp(fn)) for k, (lp, fn) in launches.items()}
        ref = calls["tree"]().clone()
        same = {k: same_bits(c(), ref) for k, c in calls.items()}
        first = ["tree"] + [k for k in other if k.endswith("integrate_points")]
        pt_ms = in_turns(calls, first)
        log(f"--integrate B6 over {name} ({int(pts.valid.sum())} valid, "
            f"{launches['tree'][0].items[0].shape[0]} work items): equal to this tree bitwise "
            f"{same}; device ms per launch (graph of 5, in turns) {pt_ms}")
        check(all(same.values()), f"B6 outputs over {name} differ from this tree's: {same}")


def integrate_alone(res, sdf_points=(), libs=None):
    """Phase 7d: the integrate kernels alone at the dense view 0 (launches
    here are not counted); B6 also over seeded subsets of the 1M points of
    the sizes in ``sdf_points`` (phase 7c's SDF passes). Given ``libs``
    (--integrate), ``integrate_ab`` on the same inputs."""
    from radegs_torch.ops import integrate as ig
    from radegs_torch.ops.binning import bin_gaussians, round_budget
    from radegs_torch.renderer import prepare
    from radegs_torch.scripts.synthetic import surface_points

    dev = torch.device(DEVICE)
    views = mesh_views()
    state = load_scene(res["dpath"], res["dcap"], views)
    W, H, T = WIDTH, HEIGHT, ((WIDTH + 15) // 16) * ((HEIGHT + 15) // 16)
    with torch.no_grad():
        prep = prepare(state, views[0][0], 0.1, compute_invraycov=True)
        del state

        def binned(budget):
            return bin_gaussians(prep.xy, prep.radius, prep.depth, prep.valid, W, H,
                                 instance_budget=budget, max_per_tile=8192,
                                 need_tile_gauss=True)

        need = int(binned(1).n_instances)
        budget = round_budget(need)
        binning = binned(budget)
        check(int(binning.n_overflow) == 0, "7d binning overflowed")
        feat, pfeat = ig.image_features(prep), ig.point_features(prep)
        P, n_inst = feat.shape[0], int(binning.gauss_id.numel())
        rows, med = ig.integrate_image_rows(binning, feat, W, H)
        t0 = time.perf_counter()
        rp, mp, iwork = ig.integrate_image_torch(binning.tile_gauss, feat, W, H,
                                                 count_work=True)
        torch.cuda.synchronize()
        img_plain_ms = (time.perf_counter() - t0) * 1e3
        img_err, flips, med_err = compare_image(rows, med, rp, mp)
        mid = {k: rows[:, 8 + j] for j, k in enumerate(ig.MID_KEYS)}
        del rp, mp

        rng = np.random.default_rng(7)
        N = 1_000_000
        pts_np = surface_points(N, rng) + rng.normal(size=(N, 3)).astype(np.float32) * 0.02
        pts = ig.project_points(torch.from_numpy(pts_np).to(dev), views[0][0])
        a_full = ig.integrate_points_alpha(binning, pfeat, pts, W, H)
        # a seeded 16k subset of the same projected points, spread over the
        # whole index range: in the 1M launch its points sit at every rank of
        # their tile's run, so in every work item of a tile, not only the first
        sel = torch.from_numpy(np.sort(rng.choice(N, 16_384, replace=False))).to(dev)
        sub = ig.PointProjection(*(f[sel] for f in pts))
        a_sub = ig.integrate_points_alpha(binning, pfeat, sub, W, H)
        t0 = time.perf_counter()
        ap, _, pwork_sub = ig.integrate_points_torch(binning.tile_gauss, pfeat, sub, mid,
                                                     (W + 15) // 16, count_work=True)
        torch.cuda.synchronize()
        pt_plain_ms = (time.perf_counter() - t0) * 1e3
        a_err = (a_sub - ap).abs().max().item()
        # a point's walk does not depend on the work item that holds it, so
        # the 1M launch must equal the subset's launch bitwise; the subset's
        # rank in its tile's run (of the 1M points) says how many of its
        # points a later item (rank >= 256) walked
        counts_pts = torch.bincount(pts.tile[pts.valid], minlength=T)
        order = ig.point_work_items(pts, binning.tile_count)[0][:int(pts.valid.sum())]
        order = order.to(torch.int64)
        first = torch.cumsum(counts_pts, 0) - counts_pts
        rank = torch.full((N,), -1, dtype=torch.int64, device=dev)
        rank[order] = torch.arange(order.numel(), device=dev) - first[pts.tile[order]]
        n_later = int((rank[sel] >= ig.POINTS_PER_ITEM).sum())
        max_tile_pts = int(counts_pts.max())
        n_big = int((counts_pts > ig.POINTS_PER_ITEM).sum())
        split_same = torch.equal(a_full[sel], a_sub)
        # the B6 work of the 1M points: pairs exact from the tile counts, the
        # data-dependent shares from the 16k subset
        counts = binning.tile_count.to(torch.int64)
        n_pairs = int(counts[pts.tile[pts.valid]].sum())
        share = n_pairs / max(int(pwork_sub["n_pairs"]), 1)
        pwork = {"n_pairs": n_pairs, **{k: int(v) * share for k, v in pwork_sub.items()
                                        if k != "n_pairs"}}
        timing = {}
        for name in ("image", "points", "points", "image"):  # in turns
            fn = ((lambda: ig.integrate_image_rows(binning, feat, W, H)) if name == "image"
                  else (lambda: ig.integrate_points_alpha(binning, pfeat, pts, W, H)))
            timing.setdefault(name, []).append(time_ms(fn, 10))
        ib = integrate_bound_ms("image", P, n_inst, T, 0, iwork)
        pb = integrate_bound_ms("points", P, n_inst, T, int(pts.valid.sum()), pwork)
        ib_full = integrate_bound_ms("image", P, n_inst, T, 0, iwork, least=False)
        pb_full = integrate_bound_ms("points", P, n_inst, T, int(pts.valid.sum()), pwork,
                                 least=False)
        # B6 at the point counts the extractions launch it on, the work
        # counted as for the 1M points
        small, point_sets = [], {f"{N} points": pts}
        for k in sdf_points:
            idx = torch.from_numpy(np.sort(rng.permutation(N)[:k])).to(dev)
            pk = ig.PointProjection(*(f[idx] for f in pts))
            point_sets[f"{k} points"] = pk
            ms_k = time_ms(lambda: ig.integrate_points_alpha(binning, pfeat, pk, W, H), 10)
            pairs_k = int(counts[pk.tile[pk.valid]].sum())
            share_k = pairs_k / max(int(pwork_sub["n_pairs"]), 1)
            work_k = {"n_pairs": pairs_k, **{key: int(v) * share_k for key, v in pwork_sub.items()
                                             if key != "n_pairs"}}
            small.append((k, ms_k, *(integrate_bound_ms("points", P, n_inst, T,
                                                        int(pk.valid.sum()), work_k, least)[0]
                                     for least in (True, False))))
    log(f"phase 7d integrate kernels alone at the dense view 0: {n_inst} instances "
        f"(radius-only demand {need}, budget {budget}), max per tile "
        f"{int(binning.max_tile_count)}, tile_overflow {int(binning.tile_overflow)}; "
        f"integrate_image ms (2 x 10 launches) {timing['image']}, plain {img_plain_ms:.3f} "
        f"(full view), bound {ib[0]:.4f} ms by {ib[1]} ({ib[2]} bytes, {ib[3]} FP32 "
        f"operations; full-gate bound {ib_full[0]:.4f} ms, {ib_full[3]} operations; work "
        f"{dict((k, int(v)) for k, v in iwork.items())}); vs plain: float "
        f"rows {img_err:.3e}, median flips {flips:.3e}, median err {med_err:.3e}; "
        f"integrate_points over {N} points ({int(pts.valid.sum())} valid; at most "
        f"{max_tile_pts} in a tile, {n_big} tiles over {ig.POINTS_PER_ITEM}) ms (2 x 10 "
        f"launches) {timing['points']}, plain {pt_plain_ms:.3f} on a 16384-point subset, "
        f"bound {pb[0]:.4f} ms by {pb[1]} ({pb[2]} bytes, {pb[3]} FP32 operations; full-gate "
        f"bound {pb_full[0]:.4f} ms, {pb_full[3]} operations; work "
        f"{dict((k, int(v)) for k, v in pwork.items())}); subset alpha err {a_err:.3e}; the "
        f"1M launch equals the subset's launch bitwise: {split_same} ({n_later} of the "
        f"subset's points in a later work item of their tile); at the SDF passes' point "
        f"counts (points, ms of 10 launches, bound ms, full-gate bound ms): {small}")
    check(img_err <= ABS_TOL and a_err <= ABS_TOL, f"7d kernel vs plain: {img_err}, {a_err}")
    check(flips <= MED_POS_TOL and med_err == 0.0, f"7d median flips {flips}, err {med_err}")
    check(max_tile_pts > ig.POINTS_PER_ITEM and n_later > 0,
          f"7d: no tile's run was split into work items ({max_tile_pts} points at most)")
    check(split_same, "7d: the 1M-point launch differs from the subset's launch")
    if libs is not None:
        with torch.no_grad():
            integrate_ab(libs, binning, feat, pfeat, point_sets)
    return dict(img_ms=float(np.median(timing["image"])), pt_ms=float(np.median(timing["points"])),
                img_plain_ms=img_plain_ms, pt_plain_ms=pt_plain_ms, img_bound=ib, pt_bound=pb,
                img_bound_full=ib_full, pt_bound_full=pb_full,
                img_err=img_err, a_err=a_err, pt_small=small)


def mesh_path(res, workdir):
    """Phase 7: integrate parity, then the mesh path (TSDF, tetra, the
    witness scene with unbounded extraction and culling), then the kernels
    alone."""
    from radegs_torch.ops import blend
    from radegs_torch.ops import integrate as ig
    from radegs_torch.ops import preprocess as pp

    parity = [integrate_parity(), integrate_parity(250, 190, (1.6, 0, 0))]
    ig.reset_launches()  # the mesh path starts here
    blend.reset_launches()
    pp.reset_launches()
    binning_launches(reset=True)
    views = mesh_views()
    state = load_scene(res["dpath"], res["dcap"], views)
    tsdf, verts, _ = mesh_tsdf(state, views, workdir, "7b TSDF of the dense 1.2M scene")
    tsdf["dist"], tsdf["dist0"] = mesh_geometry(verts, "7b TSDF")
    del state
    torch.cuda.empty_cache()
    path = os.path.join(workdir, "surface50k.ply")
    state = load_scene(path, scene_ply(path, "surface50k"), views)
    tetra, verts, _ = mesh_tetra(state, views, workdir, f"7c tetra of the {TETRA_N}-splat scene")
    tetra["dist"], tetra["dist0"] = mesh_geometry(verts, "7c tetra")
    del state
    torch.cuda.empty_cache()
    witness = mesh_witness(workdir)
    # the mesh path ends here
    launches = {**dict(ig.LAUNCHES), **dict(blend.LAUNCHES), **dict(pp.LAUNCHES),
                **binning_launches()}
    log(f"mesh path kernel launches: {launches}")
    check(all(ig.LAUNCHES[k] > 0 for k in ig.LAUNCHES), f"an integrate kernel never ran on "
          f"the mesh path: {launches}")
    check(all(any(v > 0 for k, v in pp.LAUNCHES.items() if k.endswith(f"inv={i}]"))
              for i in (0, 1)), f"the preprocess kernel did not serve TSDF (inv=0) and tetra "
          f"(inv=1) on the mesh path: {launches}")
    alone = integrate_alone(res, (tetra["stats"]["n_seeds_decimated"],
                                  tetra["stats"]["n_crossing"]))
    return dict(parity=parity, tsdf=tsdf, tetra=tetra, witness=witness, launches=launches,
                alone=alone)


# ------------------------------------------------------------ phase 8 ----


def rotmat_to_qvec(R):
    """(w, x, y, z) of a rotation matrix (Shepperd's method): the inverse of
    COLMAP's qvec2rotmat."""
    m = np.asarray(R, np.float64)
    tr = np.trace(m)
    k = int(np.argmax([tr, m[0, 0], m[1, 1], m[2, 2]]))
    if k == 0:
        s = 2.0 * math.sqrt(1.0 + tr)
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    elif k == 1:
        s = 2.0 * math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2])
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
    elif k == 2:
        s = 2.0 * math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2])
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
    else:
        s = 2.0 * math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1])
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    return np.asarray(q)


def write_colmap_dataset(root, cams, images, points, colors):
    """A COLMAP dataset on disk: ``images/view_XXX.png`` (``write_png``) and
    ``sparse/0/{cameras,images,points3D}.bin`` written with ``struct`` (one
    PINHOLE camera; each point with a two-entry track)."""
    from radegs_torch.data.colmap import qvec2rotmat
    from radegs_torch.utils.image import write_png

    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    W, H = cams[0].width, cams[0].height
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, 1, W, H)
                + struct.pack("<4d", float(cams[0].focal_x), float(cams[0].focal_y), W / 2, H / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for k, (cam, img) in enumerate(zip(cams, images)):
            w2c = cam.R.cpu().numpy().astype(np.float64).T
            q = rotmat_to_qvec(w2c)
            q /= np.linalg.norm(q)  # the float32 rotation is orthonormal to ~1e-7
            check(np.abs(qvec2rotmat(q) - w2c).max() < 1e-6, "rotation -> qvec round trip")
            name = f"view_{k:03d}.png"
            f.write(struct.pack("<i4d3di", k + 1, *q, *cam.T.cpu().numpy().astype(np.float64), 1)
                    + name.encode() + b"\x00" + struct.pack("<Q", 0))
            write_png(os.path.join(root, "images", name), img)
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for i, (p, c) in enumerate(zip(points.tolist(), colors.tolist())):
            f.write(struct.pack("<Q3d3BdQ4i", i + 1, *p, *c, 0.5, 2, 1, i, 2, i))


def run_cli(mod, argv, label):
    """``mod.main(argv)`` with its standard output captured; returns (result,
    wall seconds, the output)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    tail = " | ".join(ln.strip() for ln in text.strip().splitlines()[-2:])
    log(f"  {label}: {wall:.3f} s; ends: {tail}")
    return out, wall, text


def cli_ms_per_iteration(text):
    """Median ms per iteration from the training CLI's progress lines
    (``[   it] ... X it/s``), the first two iterations left out."""
    ips = [float(m.group(2)) for m in re.finditer(r"\[\s*(\d+)\] loss .* ([\d.]+) it/s", text)]
    return 1e3 / float(np.median(ips[2:])) if len(ips) > 2 else float("nan")


def check_pngs(paths, shapes):
    """Every PNG decodes to one of its allowed shapes (by file-name suffix)."""
    from radegs_torch.utils.image import read_png

    for p in paths:
        shape = read_png(p).shape
        want = shapes["_depth" if p.endswith("_depth.png") else
                      "_normal" if p.endswith("_normal.png") else ""]
        check(shape in want, f"{p} decodes to {shape}, not {want}")
    return len(paths)


def entry_points(workdir, tr_res):
    """Phase 8: the CLIs on a COLMAP dataset on disk at 1600x1200."""
    import glob

    from radegs_torch.data.scene import Scene
    from radegs_torch.models.appearance import init_appearance
    from radegs_torch.ops import blend
    from radegs_torch.ops import integrate as ig
    from radegs_torch.ops import preprocess as pp
    from radegs_torch.renderer import render
    from radegs_torch.scripts import mesh_extract, mesh_extract_tetrahedra
    from radegs_torch.scripts import train as train_cli
    from radegs_torch.utils.image import read_png

    dev = torch.device(DEVICE)
    walls = {}
    # ---- the dataset: phase 7e's noise-free scene as ground truth ----
    t0 = time.perf_counter()
    cams = orbit_cameras(DS_VIEWS, dev)
    path = os.path.join(workdir, "ds_scene.ply")
    cap = scene_ply(path, "clean50k")
    state = load_scene(path, cap, [(c, None, i) for i, c in enumerate(cams)])
    images = []
    with torch.no_grad():
        for cam in cams:
            out = render(state, cam, [0.0, 0.0, 0.0], kernel_size=0.1, max_per_tile=8192,
                         device=DEVICE)
            check(int(out["binning"].n_overflow) == 0, "phase 8 ground truth overflowed")
            images.append((out["render"].clamp(0, 1).permute(1, 2, 0) * 255 + 0.5)
                          .to(torch.uint8).cpu().numpy())
    rng = np.random.default_rng(8)
    centres = state.params.xyz[state.active].cpu().numpy().astype(np.float64)
    points = centres + rng.normal(size=centres.shape) * DS_JITTER
    colors = rng.integers(0, 256, size=centres.shape)
    del state
    ds = os.path.join(workdir, "dataset")
    write_colmap_dataset(ds, cams, images, points, colors)
    walls["dataset_write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    png = read_png(os.path.join(ds, "images", "view_000.png"))
    walls["png_decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = Scene(ds, eval_split=True, device=dev)
    torch.cuda.synchronize()
    walls["scene_read"] = time.perf_counter() - t0
    n_train, n_test = len(scene.getTrainCameras()), len(scene.getTestCameras())
    # the written bytes as the reader scales them (numpy float32 / 255 on the
    # host: CUDA's scalar division is a multiply by the reciprocal)
    gt_err = max(float(np.abs(gt.cpu().numpy() - images[int(im.split("_")[-1])].transpose(
        2, 0, 1).astype(np.float32) / 255.0).max())
                 for (_, gt, _), im in zip(scene.getTestCameras(),
                                           [c.image_name for c in scene.info.test_cameras]))
    log(f"phase 8 dataset: {DS_VIEWS} views at {WIDTH}x{HEIGHT}, {len(points)} points3D, "
        f"written in {walls['dataset_write']:.3f} s (renders, PNG, sparse); one PNG decode "
        f"{walls['png_decode']:.3f} s; Scene read (eval split) {walls['scene_read']:.3f} s for "
        f"{n_train} train + {n_test} test views; test gt vs the written pixels {gt_err:.3e}")
    check(png.shape == (HEIGHT, WIDTH, 3) and (n_train, n_test) == (14, 2),
          f"dataset: png {png.shape}, split {n_train}/{n_test}")
    check(gt_err == 0.0, f"the Scene's gt differs from the written pixels by {gt_err}")
    del scene
    torch.cuda.empty_cache()

    # ---- the entry points (launch counts: the phase 8 path) ----
    blend.reset_launches()
    ig.reset_launches()
    pp.reset_launches()
    binning_launches(reset=True)
    m1, m2, m3 = (os.path.join(workdir, m) for m in ("m1", "m2", "m3"))
    (ts, hist, tpsnr), walls["train"], text = run_cli(train_cli, [
        "-s", ds, "-m", m1, "--eval", "--iterations", str(CLI_ITERS), "--test_iterations", "1",
        str(CLI_ITERS), "--save_iterations", "150", str(CLI_ITERS), "--checkpoint_iterations",
        "150", "--log_every", "1", *CLI_SCHEDULE], "train")
    ms_it = cli_ms_per_iteration(text)
    losses = [h["loss"] for h in hist]
    log(f"phase 8 train: {CLI_ITERS} iterations, {ms_it:.3f} ms per iteration (the CLI's "
        f"it/s, median; phase 6: {tr_res['train_host_ms']:.3f}); test PSNR {tpsnr}; n_active "
        + ", ".join(f"{h['iteration']}: {h['n_active']}" for h in hist
                    if h["iteration"] in (1, 199, 200, CLI_ITERS))
        + f"; loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    check(len(losses) == CLI_ITERS and all(math.isfinite(x) for x in losses),
          "phase 8 train losses not finite")
    check(tpsnr[CLI_ITERS] >= tpsnr[1] + PSNR_GAIN, f"test PSNR {tpsnr}")
    for rel in ("cfg_args", "cameras.json", "history.json", "input.ply", "chkpnt150",
                "point_cloud/iteration_150/point_cloud.ply",
                f"point_cloud/iteration_{CLI_ITERS}/point_cloud.ply"):
        check(os.path.exists(os.path.join(m1, rel)), f"phase 8 train wrote no {rel}")
    del ts
    (ts, hist, _), walls["resume"], text = run_cli(train_cli, [
        "-s", ds, "-m", m2, "--eval", "--start_checkpoint", os.path.join(m1, "chkpnt150"),
        "--iterations", str(RESUME_ITERS), "--log_every", "1", *CLI_SCHEDULE], "resume")
    its = [h["iteration"] for h in hist]
    log(f"phase 8 resume from 150: iterations {its[0]}..{its[-1]}, loss {hist[0]['loss']:.5f} "
        f"-> {hist[-1]['loss']:.5f}")
    check(its[0] == 151 and its[-1] == RESUME_ITERS and ts.iteration == RESUME_ITERS,
          f"resumed run covers {its[0]}..{its[-1]}")
    check(all(math.isfinite(h["loss"]) for h in hist), "resumed losses not finite")
    del ts
    (ts, hist, _), walls["appearance"], text = run_cli(train_cli, [
        "-s", ds, "-m", m3, "--use_decoupled_appearance", "--iterations", str(APP_ITERS),
        "--log_every", "1", *CLI_SCHEDULE], "appearance")
    _, init = init_appearance(torch.Generator(device=dev).manual_seed(1))  # train(): seed + 1
    moved = {k: float((ts.app_params["net"][k] - v).abs().max()) for k, v in init["net"].items()}
    moved["embeddings"] = float((ts.app_params["embeddings"] - init["embeddings"]).abs().max())
    finite = all(bool(torch.isfinite(v).all()) for v in
                 [*ts.app_params["net"].values(), ts.app_params["embeddings"]])
    log(f"phase 8 appearance: {APP_ITERS} iterations, {cli_ms_per_iteration(text):.3f} ms per "
        f"iteration; loss {hist[0]['loss']:.5f} -> {hist[-1]['loss']:.5f}; largest change per "
        f"tensor {min(moved.values()):.3e} .. {max(moved.values()):.3e}")
    check(all(math.isfinite(h["loss"]) for h in hist) and finite, "appearance run not finite")
    check(all(v > 0 for v in moved.values()), f"appearance parameters did not move: {moved}")
    del ts, init
    torch.cuda.empty_cache()

    # ---- render as a real subprocess ----
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    proc = subprocess.run([sys.executable, "-m", "radegs_torch.scripts.render", "-m", m1,
                           "--save_depth", "--path_frames", "8"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    walls["render"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"render exited {proc.returncode}: {proc.stderr[-2000:]}")
    sets = {m.group(1): (int(m.group(2)), float(m.group(3))) for m in re.finditer(
        r"(\w+): wrote (\d+) renders to \S+ in ([\d.]+) s", proc.stdout)}
    frames = re.search(r"wrote (\d+) orbit frames to \S+ in ([\d.]+) s", proc.stdout)
    pngs = sorted(glob.glob(os.path.join(m1, "*", "ours_*", "*", "*.png"))
                  + glob.glob(os.path.join(m1, "video_*", "*.png"))
                  + glob.glob(os.path.join(ds, "images", "*.png")))
    n_png = check_pngs(pngs, {"": [(HEIGHT, WIDTH, 3)], "_depth": [(HEIGHT, WIDTH),
                                                                   (HEIGHT, WIDTH, 3)],
                              "_normal": [(HEIGHT, WIDTH, 3)]})
    log(f"phase 8 render (subprocess, exit 0): {walls['render']:.3f} s in all; "
        + ", ".join(f"{k} {n} views in {s:.3f} s ({s / n:.3f} s per view: render, PNG "
                    f"writes with depth and normal)" for k, (n, s) in sets.items())
        + (f", orbit {frames.group(1)} frames in {float(frames.group(2)):.3f} s" if frames
           else "") + f"; {n_png} PNGs decode to their shapes")
    check(set(sets) == {"train", "test"} and frames is not None, f"render output: {proc.stdout}")
    # per train / test view: render, depth, normal, gt; per orbit frame: frame,
    # depth; the dataset's images
    check(n_png == 4 * DS_VIEWS + 2 * 8 + DS_VIEWS, f"{n_png} PNGs written")

    # ---- both mesh extractors ----
    (verts, faces), walls["tsdf"], _ = run_cli(mesh_extract, ["-m", m1, "--max_resolution",
                                                             "384"], "mesh_extract")
    band = (2 * DS_JITTER, 2 * DS_JITTER)
    d_tsdf = float(np.median(surface_distance(verts, band)[0]))
    (tv, tf), walls["tetra"], _ = run_cli(mesh_extract_tetrahedra, ["-m", m1],
                                          "mesh_extract_tetrahedra")
    d_tetra = float(np.median(surface_distance(tv, band)[0]))
    # the phase 8 path ends here
    launches = {**dict(blend.LAUNCHES), **dict(ig.LAUNCHES), **dict(pp.LAUNCHES),
                **binning_launches()}
    log(f"phase 8 meshes: TSDF {walls['tsdf']:.3f} s, {len(verts)} vertices, {len(faces)} "
        f"faces, median distance {d_tsdf:.5f}; tetra {walls['tetra']:.3f} s, {len(tv)} "
        f"vertices, {len(tf)} faces, median distance {d_tetra:.5f} (to the sphere / plane "
        f"widened by {band[0]}); kernel launches {launches}")
    check(len(faces) > 10_000 and len(tf) > 10_000, f"meshes: {len(faces)}, {len(tf)} faces")
    check(d_tsdf < MESH_VIEWS_DIST_TOL and d_tetra < MESH_VIEWS_DIST_TOL,
          f"mesh distances {d_tsdf}, {d_tetra}")
    check(all(launches[k] > 0 for k in ("integrate_image", "integrate_points"))
          and any(v > 0 for k, v in launches.items() if k.startswith("blend_fwd"))
          and any(v > 0 for k, v in launches.items() if k.startswith("blend_bwd")),
          f"a kernel never ran on the phase 8 path: {launches}")
    log("phase 8 wall seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
    return dict(walls=walls, ms_it=ms_it, launches=launches, workdir=workdir, ds=ds, m1=m1,
                tpsnr=tpsnr, tsdf_mesh=(verts, faces))


# ----------------------------------------------------------- phase 10 ----


def write_lpips_weights(path):
    """Seeded random LPIPS weights (tests/test_lpips.py's recipe: VGG16
    convolutions N(0, 1) x 0.3, heads |N(0, 1)|) as the ``.npz`` layout of
    the converted weights."""
    from radegs_torch.eval.lpips import N_CHANNELS, VGG16_CFG

    rng = np.random.default_rng(LPIPS_SEED)
    w, cin, ci = {}, 3, 0
    for item in VGG16_CFG:
        if item == "M":
            continue
        w[f"conv{ci}_w"] = rng.normal(size=(item, cin, 3, 3)).astype(np.float32) * 0.3
        w[f"conv{ci}_b"] = rng.normal(size=(item,)).astype(np.float32) * 0.3
        cin, ci = item, ci + 1
    for k, c in enumerate(N_CHANNELS):
        w[f"lin{k}"] = np.abs(rng.normal(size=(c,)).astype(np.float32))
    np.savez(path, **w)


def lpips_flops(H, W):
    """FP32 operations of one LPIPS pair: the 13 VGG16 convolutions up to
    relu5_3 on both images (an FMA counted as 2; each pool floors odd
    sizes). The bias, ReLU, normalisation and heads add < 1%."""
    from radegs_torch.eval.lpips import TAP_AFTER_CONV, VGG16_CFG

    macs, cin, ci = 0, 3, 0
    for item in VGG16_CFG:
        if item == "M":
            H, W = H // 2, W // 2
            continue
        if ci > TAP_AFTER_CONV[-1]:
            break
        macs += H * W * item * cin * 9
        cin, ci = item, ci + 1
    return 2 * 2 * macs


def eval_lpips(workdir, m1):
    """10a: LPIPS of the first test render against its gt at 1600x1200 with
    seeded random weights loaded through ``load_weights``."""
    from radegs_torch.eval.lpips import load_weights
    from radegs_torch.utils.image import read_png

    path = os.path.join(workdir, "lpips_random.npz")
    write_lpips_weights(path)
    base = os.path.join(m1, "test", f"ours_{CLI_ITERS}")
    r, g = (torch.from_numpy(read_png(os.path.join(base, sub, "00000.png")).astype(np.float32)
                             .transpose(2, 0, 1) / 255.0).to(DEVICE) for sub in ("renders", "gt"))
    check(r.shape == (3, HEIGHT, WIDTH), f"test render {tuple(r.shape)}")
    model = load_weights(path, device=DEVICE)
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        score = model(r, g)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base_mem
        rerun = model(r, g)
        torch.backends.cudnn.allow_tf32 = True  # a caller that allows TF32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = model(r, g)
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        ms = sorted(time_ms(lambda: model(r, g), 1, warmup=False) for _ in range(5))[2]
        f64 = float(load_weights(path, device=DEVICE).double()(r.double(), g.double()))
    rel = abs(float(score) - f64) / abs(f64)
    flops = lpips_flops(HEIGHT, WIDTH)
    bound = flops / PEAK_FP32 * 1e3
    log(f"phase 10a LPIPS at {WIDTH}x{HEIGHT} (random weights, seed {LPIPS_SEED}): "
        f"{float(score):.9g}; float64 {f64:.9g} (rel err {rel:.3e}); rerun and with TF32 "
        f"allowed by the caller bit-identical {same_bits(score, rerun)}, "
        f"{same_bits(score, tf32)}; {ms:.3f} ms per pair (CUDA events, median of 5), "
        f"{flops / 1e12:.3f} TFLOP of convolution: {flops / ms / 1e9:.1f} TFLOP/s, "
        f"{bound / ms:.1%} of the FP32 peak ({bound:.3f} ms bound); peak memory "
        f"{peak / 2**30:.3f} GiB")
    check(rel < LPIPS_REL_TOL, f"LPIPS float32 {float(score)} vs float64 {f64}")
    check(same_bits(score, rerun), "LPIPS run != rerun")
    check(same_bits(score, tf32), "LPIPS changed with TF32 allowed: the fp32 pin is broken")
    return dict(path=path, score=float(score))


def eval_metrics(m1, tpsnr, lp):
    """10b: the metrics CLI as a subprocess on phase 8's test renders."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    proc = subprocess.run([sys.executable, "-m", "radegs_torch.scripts.metrics", "-m", m1,
                           "--lpips_weights", lp["path"], "--device", DEVICE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"metrics exited {proc.returncode}: {proc.stderr[-2000:]}")
    method = f"ours_{CLI_ITERS}"
    with open(os.path.join(m1, "results.json")) as f:
        res = json.load(f)[method]
    with open(os.path.join(m1, "per_view.json")) as f:
        per_view = json.load(f)[method]
    timing = re.search(rf"{method}: .*\((\d+) views in ([\d.]+) s\)", proc.stdout)
    check(timing is not None, f"metrics output: {proc.stdout}")
    n, secs = int(timing.group(1)), float(timing.group(2))
    log(f"phase 10b metrics (subprocess, exit 0): {wall:.3f} s wall; {method}: SSIM "
        f"{res['SSIM']:.6f} PSNR {res['PSNR']:.4f} LPIPS {res['LPIPS']:.6f} over {n} views, "
        f"{secs / n:.3f} s per view (PNG decode, SSIM, PSNR, LPIPS); the train CLI's test "
        f"PSNR {tpsnr[CLI_ITERS]:.4f}")
    check(res.keys() == {"SSIM", "PSNR", "LPIPS"} and n == 2, f"results.json: {res}")
    check(abs(res["PSNR"] - tpsnr[CLI_ITERS]) < METRICS_PSNR_TOL,
          f"metrics PSNR {res['PSNR']} vs the train CLI's {tpsnr[CLI_ITERS]}")
    check(abs(per_view["LPIPS"]["00000.png"] - lp["score"]) <= 1e-5 * abs(lp["score"]),
          f"metrics LPIPS of view 0 {per_view['LPIPS']['00000.png']} vs 10a {lp['score']}")


def surface_samples(spacing):
    """Points on phase 8's noise-free surfaces ~``spacing`` apart: a
    Fibonacci lattice on the sphere r = 1.3 and a square grid on the plane
    y = -1.4 over x, z in [-3, 3] (surface_points' extent)."""
    n = int(4 * math.pi * 1.3**2 / spacing**2)
    k = np.arange(n) + 0.5
    phi, theta = np.arccos(1 - 2 * k / n), math.pi * (1 + 5**0.5) * k
    sphere = 1.3 * np.stack([np.cos(theta) * np.sin(phi), np.cos(phi),
                             np.sin(theta) * np.sin(phi)], 1)
    g = np.arange(-3.0, 3.0 + spacing / 2, spacing)
    gx, gz = np.meshgrid(g, g, indexing="ij")
    plane = np.stack([gx.ravel(), np.full(gx.size, -1.4), gz.ravel()], 1)
    return np.concatenate([sphere, plane], 0)


def finite_surface_distance(p):
    """Distance to the noise-free sphere and to the plane square (x, z in
    [-3, 3]), the nearer; and whether the sphere is the nearer."""
    p = np.asarray(p, np.float64)
    ds = np.abs(np.linalg.norm(p, axis=1) - 1.3)
    out = np.maximum(np.abs(p[:, [0, 2]]) - 3.0, 0.0)
    dp = np.sqrt((p[:, 1] + 1.4) ** 2 + (out**2).sum(1))
    return np.minimum(ds, dp), ds < dp


def write_traj_log(path, cams):
    """A TNT ``.log`` of the cameras' camera-to-world matrices."""
    with open(path, "w") as f:
        for i, cam in enumerate(cams):
            m = np.linalg.inv(cam.world_view.cpu().numpy().astype(np.float64))
            f.write(f"{i} {i} 0\n" + "".join(" ".join(repr(float(v)) for v in row) + "\n"
                                             for row in m))


def write_dtu_dir(root, cams, stl):
    """A DTU reference directory for phase 8's scene: ObsMask all true over
    its bounding box, a Plane keeping everything, the stl cloud and the
    dataset's cameras as ``Calibration/cal18/pos_*.txt`` (P = K [R | t])."""
    from scipy.io import savemat

    from radegs_torch.utils.ply import write_point_cloud

    for sub in ("ObsMask", os.path.join("Points", "stl"), os.path.join("Calibration", "cal18")):
        os.makedirs(os.path.join(root, sub))
    bb = np.array([[-3.5, -1.7, -3.5], [3.5, 1.7, 3.5]])
    shape = tuple(np.ceil((bb[1] - bb[0]) / DTU_RES).astype(int) + 1)
    savemat(os.path.join(root, "ObsMask", f"ObsMask{DTU_SCAN}_10.mat"),
            {"ObsMask": np.ones(shape, bool), "BB": bb, "Res": np.array([[DTU_RES]])})
    savemat(os.path.join(root, "ObsMask", f"Plane{DTU_SCAN}.mat"),
            {"P": np.array([[0.0], [0.0], [0.0], [1.0]])})
    write_point_cloud(os.path.join(root, "Points", "stl", f"stl{DTU_SCAN:03}_total.ply"),
                      stl.astype(np.float32))
    for i, cam in enumerate(cams):
        K = np.array([[float(cam.focal_x), 0, cam.width / 2], [0, float(cam.focal_y),
                                                                cam.height / 2], [0, 0, 1]])
        w2c = cam.world_view.cpu().numpy().astype(np.float64)
        np.savetxt(os.path.join(root, "Calibration", "cal18", f"pos_{i + 1:03d}.txt"),
                   K @ w2c[:3])


def dtu_vis_check(out_dir, sigmas):
    """From ``evaluate_dtu``'s error clouds: the analytic mean distance of
    the downsampled samples it averaged (red-white: in the mask, d2s below
    max_dist) and the 3-sigma bounds of both directions, each sample at the
    splat sigma of its nearer surface."""
    from radegs_torch.utils.ply import read_point_cloud

    out = {}
    for side in ("d2s", "s2d"):
        pts, col, _ = read_point_cloud(os.path.join(out_dir, f"vis_{DTU_SCAN:03}_{side}.ply"))
        used = col[:, 0] > 0.5  # green: beyond max_dist, blue: outside the mask
        d, near_s = finite_surface_distance(pts[used])
        out[side] = (float(d.mean()), CLEAN_SIGMA_TOL * float(
            np.where(near_s, sigmas[0], sigmas[1]).mean()), int(used.sum()), len(pts))
    return out


def eval_meshes(ep):
    """10c: phase 8's TSDF mesh through cull_mesh, eval_tnt, eval_dtu and
    evaluate_dtu_mesh on synthetic ground truth of the noise-free scene."""
    from radegs_torch.eval.tnt import crop_polygon_volume, voxel_downsample
    from radegs_torch.scripts import cull_mesh, eval_dtu, eval_tnt, evaluate_dtu_mesh
    from radegs_torch.utils.ply import write_mesh, write_point_cloud

    workdir, walls = ep["workdir"], {}
    cams = orbit_cameras(DS_VIEWS, torch.device(DEVICE))
    state = load_scene(os.path.join(workdir, "ds_scene.ply"), WITNESS_CAPACITY,
                       [(c, None, i) for i, c in enumerate(cams)])
    sigmas = splat_sigmas(state)
    del state
    tau = CLEAN_SIGMA_TOL * max(sigmas)
    tsdf_ply = os.path.join(workdir, "tsdf.ply")
    write_mesh(tsdf_ply, *ep["tsdf_mesh"])
    log_path = os.path.join(workdir, "orbit.log")
    write_traj_log(log_path, cams)
    t0 = time.perf_counter()
    gt = surface_samples(GT_SPACING)
    walls["ground_truth"] = time.perf_counter() - t0

    culled = os.path.join(workdir, "tsdf_cull.ply")
    (cv, cf), walls["cull_mesh"], _ = run_cli(cull_mesh, [
        "--traj-path", log_path, "--ply-path", tsdf_ply, "--out", culled, "--width", str(WIDTH),
        "--height", str(HEIGHT), "--fx", repr(float(cams[0].focal_x)), "--fy",
        repr(float(cams[0].focal_y)), "--min-views", "2", "--device", DEVICE], "cull_mesh")
    check(0 < len(cf) <= len(ep["tsdf_mesh"][1]), f"cull_mesh kept {len(cf)} faces")

    tnt = os.path.join(workdir, "tnt", "Orbit")
    os.makedirs(tnt)
    write_point_cloud(os.path.join(tnt, "Orbit.ply"), gt.astype(np.float32))
    shutil.copyfile(log_path, os.path.join(tnt, "Orbit_COLMAP_SfM.log"))
    crop = os.path.join(tnt, "Orbit.json")
    with open(crop, "w") as f:
        json.dump({"class_name": "SelectionPolygonVolume", "orthogonal_axis": "Z",
                   "axis_min": -3.2, "axis_max": 3.2,
                   "bounding_polygon": [[-3.2, -1.6, 0], [3.2, -1.6, 0], [3.2, 1.6, 0],
                                        [-3.2, 1.6, 0]]}, f)
    (r, st), walls["eval_tnt"], _ = run_cli(eval_tnt, [
        "--dataset_dir", tnt, "--traj_path", log_path, "--ply_path", culled, "--out_dir",
        os.path.join(workdir, "tnt_out"), "--tau", repr(tau)], "eval_tnt")
    T = st["transform"]
    est = cv.astype(np.float64) @ T[:3, :3].T + T[:3, 3]
    est = voxel_downsample(crop_polygon_volume(est, crop), tau / 2.0)
    share = float((finite_surface_distance(est)[0] < tau).mean())
    scale = float(np.cbrt(np.linalg.det(T[:3, :3])))
    angle = math.degrees(math.acos(np.clip((np.trace(T[:3, :3]) / scale - 1) / 2, -1, 1)))
    log(f"phase 10c eval_tnt: tau {tau:.5f} (3 x the plane's splat sigma; sigmas {sigmas[0]:.5f}"
        f" / {sigmas[1]:.5f}), precision {r['precision']:.5f} recall {r['recall']:.5f} F1 "
        f"{r['f1']:.5f}; the share of its {len(est)} estimated points within tau of the "
        f"surfaces {share:.5f}; ICP's transform: scale {scale:.6f}, rotation {angle:.4f} deg, "
        f"translation {np.round(T[:3, 3], 5).tolist()}; stages: "
        f"registration {st['registration_s']:.3f} s, crop and downsample "
        f"{st['downsample_s']:.3f} s, histogram queries {st['histo_s']:.3f} s")
    check(abs(r["precision"] - share) < TNT_PRECISION_TOL,
          f"TnT precision {r['precision']} vs the analytic share {share}")

    dtu = os.path.join(workdir, "dtu")
    stl = surface_samples(STL_SPACING)
    write_dtu_dir(dtu, cams, stl)
    dtu_args = ["--downsample_density", repr(DTU_DENSITY), "--patch_size", repr(DTU_PATCH),
                "--max_dist", repr(DTU_MAX_DIST), "--visualize_threshold", repr(DTU_MAX_DIST)]
    vis = os.path.join(workdir, "dtu_vis")
    (dr, ds_), walls["eval_dtu"], _ = run_cli(eval_dtu, [
        "--data", culled, "--scan", str(DTU_SCAN), "--dataset_dir", dtu, "--vis_out_dir", vis,
        *dtu_args], "eval_dtu")
    chk = dtu_vis_check(vis, sigmas)
    bound = (chk["d2s"][1] + chk["s2d"][1]) / 2
    log(f"phase 10c eval_dtu: mean_d2s {dr['mean_d2s']:.6f} (analytic {chk['d2s'][0]:.6f} over "
        f"its {chk['d2s'][2]} of {chk['d2s'][3]} samples), mean_s2d {dr['mean_s2d']:.6f} "
        f"(stl {len(stl)} points {STL_SPACING} apart), overall {dr['overall']:.6f} (3-sigma "
        f"bound {bound:.6f}); stages: sampling {ds_['sample_s']:.3f} s ({ds_['n_samples']} "
        f"points), radius downsample {ds_['downsample_s']:.3f} s ({ds_['n_down']} points), KD "
        f"queries {ds_['kd_s']:.3f} s")
    check(ds_["n_samples"] <= 1_200_000, f"radius_downsample over {ds_['n_samples']} points")
    check(-1e-6 <= dr["mean_d2s"] - chk["d2s"][0] <= STL_SPACING,
          f"DTU mean_d2s {dr['mean_d2s']} vs analytic {chk['d2s'][0]}")
    check(dr["overall"] < bound, f"DTU overall {dr['overall']} above {bound}")

    (T, mr, ms), walls["evaluate_dtu_mesh"], _ = run_cli(evaluate_dtu_mesh, [
        "-m", ep["m1"], "--DTU", dtu, "--scan_id", str(DTU_SCAN), "--mesh", culled, *dtu_args,
        "--device", DEVICE],
        "evaluate_dtu_mesh")
    dev_T = float(np.abs(T - np.eye(4)).max())
    log(f"phase 10c evaluate_dtu_mesh: Procrustes transform - I max {dev_T:.3e}; overall "
        f"{mr['overall']:.6f} (eval_dtu {dr['overall']:.6f}); stages: sampling "
        f"{ms['sample_s']:.3f} s, radius downsample {ms['downsample_s']:.3f} s, KD queries "
        f"{ms['kd_s']:.3f} s")
    check(dev_T < 1e-4, f"evaluate_dtu_mesh transform is not the identity: {T}")
    log("phase 10c wall seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))


def viewer_message(cam, keep_alive, scaling_modifier):
    """The SIBR client's request for ``cam``: the column-major world_view with
    its y / z columns negated (network_gui.py:73-76)."""
    wv = cam.world_view.cpu().numpy().T.copy()
    wv[:, 1] *= -1
    wv[:, 2] *= -1
    return {"resolution_x": cam.width, "resolution_y": cam.height, "train": True,
            "fov_y": float(cam.fovy), "fov_x": float(cam.fovx), "z_near": cam.znear,
            "z_far": cam.zfar, "shs_python": False, "rot_scale_python": False,
            "keep_alive": keep_alive, "scaling_modifier": scaling_modifier,
            "view_matrix": wv.reshape(-1).tolist(),
            "view_projection_matrix": np.eye(4).reshape(-1).tolist()}


def viewer_client(port, cam, n_alive, frames, errors):
    """Connect (retrying until the CLI listens), request ``n_alive`` frames
    with keep_alive and one without, keep each reply."""
    import socket

    def recv(s, n):
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            check(len(chunk) > 0, "the viewer server closed the connection")
            buf += chunk
        return buf

    try:
        deadline = time.monotonic() + 300
        while True:
            try:
                s = socket.create_connection(("127.0.0.1", port), timeout=300)
                break
            except ConnectionRefusedError:
                check(time.monotonic() < deadline, "the train CLI never listened")
                time.sleep(0.01)
        with s:
            for k in range(n_alive + 1):
                payload = json.dumps(viewer_message(cam, k < n_alive, VIEWER_SCALE)).encode()
                s.sendall(len(payload).to_bytes(4, "little") + payload)
                img = recv(s, cam.width * cam.height * 3)
                verify = recv(s, int.from_bytes(recv(s, 4), "little")).decode()
                frames.append((time.perf_counter(), img, verify))
    except Exception as e:  # raised in the main thread after the join
        errors.append(e)


def eval_viewer(ep):
    """10d: the train CLI with --ip serving a client thread 320x240 frames."""
    import socket
    import threading

    from radegs_torch.core.camera import Camera
    from radegs_torch.renderer import render
    from radegs_torch.scripts import train as train_cli
    from radegs_torch.train.config import PipelineConfig

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    th = 2.0 * math.pi * 3 / DS_VIEWS
    cam = Camera.look_at([5.0 * math.sin(th), 0.8, -5.0 * math.cos(th)], [0, 0, 0], [0, 1, 0],
                         0.9, 0.7, VIEWER_W, VIEWER_H, device=DEVICE)
    frames, errors = [], []
    client = threading.Thread(target=viewer_client,
                              args=(port, cam, VIEWER_ALIVE, frames, errors))
    client.start()
    m4 = os.path.join(ep["workdir"], "m4")
    (ts, hist, _), wall, _ = run_cli(train_cli, [
        "-s", ep["ds"], "-m", m4, "--iterations", str(VIEWER_ITERS), "--ip", "127.0.0.1",
        "--port", str(port), "--log_every", "10", "--kernel_size", "0.1", "--device", DEVICE],
        "train --ip")
    client.join(timeout=120)
    check(not client.is_alive() and not errors, f"viewer client: {errors}")
    pcfg = PipelineConfig()
    with torch.no_grad():
        want = render(ts.gaussians, cam, torch.zeros(3, device=DEVICE), kernel_size=0.1,
                      scaling_modifier=VIEWER_SCALE, max_per_tile=pcfg.max_per_tile,
                      tiles_per_block=pcfg.tiles_per_block, device=DEVICE)["render"]
    want = (np.clip(want.cpu().numpy(), 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    gaps = np.diff([f[0] for f in frames])
    log(f"phase 10d viewer: train --ip {VIEWER_ITERS} iterations in {wall:.3f} s; "
        f"{len(frames)} frames of {VIEWER_W}x{VIEWER_H} served (median {np.median(gaps) * 1e3:.3f}"
        f" ms apart); the last equals render of the final state at scaling modifier "
        f"{VIEWER_SCALE}: {frames[-1][1] == want.tobytes()}; distinct frames "
        f"{len({f[1] for f in frames})}")
    check(len(frames) == VIEWER_ALIVE + 1 and all(f[2] == ep["ds"] for f in frames),
          f"{len(frames)} frames, verify {frames[-1][2] if frames else None}")
    check(frames[-1][1] == want.tobytes(), "the viewer's last frame differs from render")
    check(len({f[1] for f in frames}) > 1, "every frame the same: none came during training")
    check(len(hist) > 0 and hist[-1]["iteration"] == VIEWER_ITERS, "train --ip did not finish")


def evaluation(ep):
    """Phase 10: LPIPS on the card, the metrics CLI, the mesh evaluation CLIs
    and the network viewer, on phase 8's outputs (launch counts set to 0
    before and read after, and returned)."""
    from radegs_torch.ops import blend
    from radegs_torch.ops import integrate as ig
    from radegs_torch.ops import preprocess as pp

    t0 = time.perf_counter()
    blend.reset_launches()
    ig.reset_launches()
    pp.reset_launches()
    binning_launches(reset=True)
    eval_metrics(ep["m1"], ep["tpsnr"], eval_lpips(ep["workdir"], ep["m1"]))
    eval_meshes(ep)
    eval_viewer(ep)
    # the phase 10 path ends here
    launches = {**dict(blend.LAUNCHES), **dict(ig.LAUNCHES), **dict(pp.LAUNCHES),
                **binning_launches()}
    g = default_g()
    log(f"phase 10 kernel launches: {launches}; {time.perf_counter() - t0:.1f} s in all")
    check(launches[f"blend_fwd[G={g}]"] > 0 and launches[f"blend_bwd[G={g}]"] > 0,
          f"a blend kernel never ran on the phase 10 path: {launches}")
    return launches


# ------------------------------------------------------------ phase 9 ----


def bisect_bound_ms(probe, start, count, feat):
    """Least time for a probe's work on these inputs: what it reads (the
    window columns it sums, once each; for the products the values that
    reach rows 0..7 of the output), start / count, the (T, 8, 256) output
    written once; FP32 operations at peak, only those the outputs need: an
    add per summed value; every column of w and x is f[0, 0:128], so per
    step mm_highest is 8 dot products of length 128 (2 per multiply-add)
    and tri_mm the 7 adds of the prefix sum of f[0, 0:8]."""
    from radegs_torch.ops import bisect

    T = start.shape[0]
    out_bytes = T * 8 * 256 * 4
    if probe == "window":
        start_al, n = bisect.window_bounds(start, count)
        cols = torch.zeros(feat.shape[1] // bisect.CH, dtype=torch.bool, device=feat.device)
        for a, k in zip((start_al // bisect.CH).tolist(), n.tolist()):
            cols[a:a + k] = True
        n_bytes = int(cols.sum()) * bisect.CH * 25 * 4 + T * 8 + out_bytes
        ops = int(n.sum()) * bisect.CH * 25
    elif probe == "aligned":
        n_bytes, ops = bisect.CH * 25 * 4 + out_bytes, T * bisect.CH * 25
    elif probe == "mm_highest":
        n_bytes, ops = 8 * bisect.CH * 4 + out_bytes, T * 8 * bisect.CH * 2
    else:
        n_bytes, ops = 8 * 4 + out_bytes, T * 7
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), n_bytes, ops


def bisect_library(probe, start, count, feat):
    """One PyTorch call computing the probe's function (its inputs gathered
    beforehand): torch.sum over the gathered windows, torch.matmul (TF32
    off), torch.cumsum."""
    from radegs_torch.ops import bisect

    if probe == "aligned":
        win = feat[:, :bisect.CH].contiguous()
        return lambda: torch.sum(win)
    if probe == "window":
        start_al, n = bisect.window_bounds(start, count)
        g = torch.zeros((start.shape[0], 25, max(int(n.max()), 1) * bisect.CH),
                        device=feat.device)
        for t, (a, k) in enumerate(zip(start_al.tolist(), n.tolist())):
            g[t, :, :k * bisect.CH] = feat[:, a:a + k * bisect.CH]
        return lambda: torch.sum(g, dim=(1, 2))
    if probe == "mm_highest":
        basis = feat[:19, :bisect.CH].contiguous()
        w = feat[0, :bisect.CH][:, None].expand(bisect.CH, 256).contiguous()
        return lambda: torch.matmul(basis, w)
    row = feat[0, :bisect.CH].contiguous()
    return lambda: torch.cumsum(row, 0)


def probe_held(probe, out, plain, start, count, feat):
    """Max abs error of a probe kernel's output against its plain version
    and its largest share of the tolerance: BISECT_REL_TOL x the sum of
    |terms| of each output (per step for the window sums, per row for the
    prefix sum), x max |plain| for mm_highest. Fails unless both put NaN on
    the same steps."""
    from radegs_torch.ops import bisect

    a = feat.abs()
    if probe == "window":
        tol = bisect.window_torch(start, count, a)
    elif probe == "tri_mm":
        tol = torch.cumsum(a[0, :8], 0)[None, :, None].expand_as(plain)
    elif probe == "aligned":
        tol = a[:, :bisect.CH].sum().expand_as(plain)
    else:
        tol = bisect.mm_highest_torch(start, count, feat).abs().max().expand_as(plain)
    nan = torch.isnan(plain)
    check(torch.equal(torch.isnan(out), nan), f"bisect {probe}: NaN on other steps than plain")
    diff = (out - plain).abs()[~nan]
    if diff.numel() == 0:
        return 0.0, 0.0
    share = diff / (BISECT_REL_TOL * tol[~nan]).clamp_min(1e-30)
    return float(diff.max()), float(share.max())


def probe_copies(other=None):
    """The probes' C entry built from copies of csrc/bisect_probes.cu, one
    per variant of WINDOW_VARIANTS ({constant: value} replacing the source's
    ``constexpr ... <constant> = ...;``) and, when ``other`` names the csrc
    directory of another checkout, from its bisect_probes.cu as "other"
    (its C entry takes the same arguments); compiled with build.py's flags all
    at once into build/chip_smoke/probes/ and bound with ctypes, the
    other's ptxas register and spill lines logged. Returns {label: function
    (probe, start, count, feat) -> out}."""
    import ctypes

    from radegs_torch.native import build
    from radegs_torch.ops import bisect

    src = (build.CSRC / "bisect_probes.cu").read_text()
    copies = {name: (build.with_constants(src, consts), build.CSRC)
              for name, consts in WINDOW_VARIANTS.items()}
    if other:
        copies["other"] = open(os.path.join(other, "bisect_probes.cu")).read(), other
    kernels = {}
    for name, (lib, text) in build.build_copies(
            copies, os.path.join(ROOT, "build", "chip_smoke", "probes")).items():
        if name == "other":
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas bisect_probes[{name}]: {line.strip()}")
        fn = lib.radegs_bisect_probes
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run(probe, start, count, feat, fn=fn, name=name):
            out = torch.empty((start.shape[0], 8, 256), device=feat.device)
            rc = fn(start.data_ptr(), count.data_ptr(), feat.data_ptr(), out.data_ptr(),
                    bisect.PROBES.index(probe), start.shape[0], feat.shape[1],
                    torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"bisect {probe} of {name} launch failed with CUDA error {rc}")
            return out

        kernels[name] = run
    return kernels


def wrapper_costs(start, count, feat, reps=500):
    """Host microseconds per call of each piece a probe wrapper call may
    pay (the checks, the entry lookup, a device switch, the stream lookup,
    the output allocation, the launch), then of the whole wrapper call, for
    ``aligned`` at the JAX shapes."""
    from radegs_torch.native import build
    from radegs_torch.ops import bisect

    dev = feat.device
    T, B = start.shape[0], feat.shape[1]
    fn = build.entry("bisect_probes", 4, 3)
    out = torch.empty((T, 8, 256), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def checks():
        build.check_tensor("start", start, torch.int32, (T,), dev)
        build.check_tensor("count", count, torch.int32, (T,), dev)
        build.check_tensor("feat", feat, torch.float32, (25, B), dev)

    def switch():
        with torch.cuda.device(dev):
            pass

    pieces = {
        "check_tensor x3": checks,
        "build.entry": lambda: build.entry("bisect_probes", 4, 3),
        "torch.cuda.device": switch,
        "current_device": torch.cuda.current_device,
        "current_stream(dev)": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch.empty": lambda: torch.empty((T, 8, 256), dtype=torch.float32, device=dev),
        "launch": lambda: fn(start.data_ptr(), count.data_ptr(), feat.data_ptr(),
                             out.data_ptr(), 0, T, B, stream),
        "wrapper call": lambda: bisect.aligned(start, count, feat),
    }
    us = {}
    for name, piece in pieces.items():
        piece()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            piece()
        us[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    return us


def bisect_probes(res, other=None):
    """Phase 9: the bisect probes through their CLI, held to their plain
    versions on five start / count sets, timed in turns with the
    launch-and-store floor, then ``window`` at the dense view 0's run
    layout. Given the csrc directory of another checkout (``--probes
    CSRC``), its probes too: on every set ``window`` and ``tri_mm`` must
    give this tree's bits and ``aligned`` and ``mm_highest`` stay within
    the tolerance, each timed alone in the same turns."""
    from radegs_torch.ops import bisect
    from radegs_torch.ops import blend
    from radegs_torch.ops.rasterize import bin_prep
    from radegs_torch.renderer import prepare
    from radegs_torch.scripts import kernel_bisect as kb

    dev = torch.device(DEVICE)
    bisect.reset_launches()  # the bisect path starts here
    failed, wall, text = run_cli(kb, [], "kernel_bisect")
    launches = dict(bisect.LAUNCHES)  # the bisect path ends here
    log(f"phase 9 kernel_bisect: {' | '.join(text.strip().splitlines())}; launches {launches}")
    check(failed == 0 and all(v > 0 for v in launches.values()),
          f"kernel_bisect: {failed} probes failed, launches {launches}")
    copies = probe_copies(other)
    long_feat = torch.from_numpy(np.random.default_rng(0).normal(size=(25, LONG_RUN_B))
                                 .astype(np.float32)).to(dev)
    sets = [kb.inputs(dev, st, ct) for st, ct in
            [(kb.START, kb.COUNT)] + [kb.seeded_set(s) for s in BISECT_SETS] + [BISECT_OUTSIDE]]
    sets.append(tuple(torch.tensor(x, dtype=torch.int32, device=dev) for x in LONG_RUN)
                + (long_feat,))
    start_al, n = bisect.window_bounds(*sets[-1][:2])
    check(n.tolist() == list(LONG_RUN_WINDOWS) and int((start_al + n * 128).max()) == LONG_RUN_B,
          f"long-run set: windows {n.tolist()}")
    jstart, jcount, jfeat = kb.inputs(dev)  # timed at the JAX shapes
    # the launch-and-store floor: the least a launch that writes the (T, 8,
    # 256) output takes in this harness (a yardstick, not the bound)
    floor_out = torch.empty((jstart.shape[0], 8, 256), device=dev)
    rows = {}
    for probe in bisect.PROBES:
        err_max, worst, other_share, h = 0.0, 0.0, 0.0, hashlib.sha256()
        for start, count, feat in sets:
            out = bisect.WRAPPERS[probe](start, count, feat)
            again = bisect.WRAPPERS[probe](start, count, feat)
            plain = bisect.PLAIN[probe](start, count, feat)
            torch.cuda.synchronize()
            check(same_bits(out, again), f"bisect {probe} differs between two runs")
            err, share = probe_held(probe, out, plain, start, count, feat)
            check(share <= 1.0, f"bisect {probe} on {start.tolist()} / {count.tolist()}: error "
                  f"{err} at {share} of the tolerance")
            err_max, worst = max(err_max, err), max(worst, share)
            h.update(out.cpu().numpy().tobytes())
            if other:
                o = copies["other"](probe, start, count, feat)
                check(same_bits(o, copies["other"](probe, start, count, feat)),
                      f"bisect {probe} of the other checkout differs between two runs")
                if probe in ("window", "tri_mm"):
                    check(same_bits(o, out), f"bisect {probe}: the other checkout's bits differ")
                other_share = max(other_share,
                                  probe_held(probe, o, plain, start, count, feat)[1])
                check(other_share <= 1.0, f"bisect {probe} of the other checkout on "
                      f"{start.tolist()}: error at {other_share} of the tolerance")
        # each alone in graphs of 100 launches, in turns: this tree, the
        # floor, the other checkout's, then back, three times
        calls = {"tree": functools.partial(bisect.WRAPPERS[probe], jstart, jcount, jfeat),
                 "floor": functools.partial(floor_out.fill_, 0.0)}
        if other:
            calls["other"] = functools.partial(copies["other"], probe, jstart, jcount, jfeat)
        turns = {k: [] for k in calls}
        for k in (list(calls) + list(calls)[::-1]) * 3:
            turns[k].append(round(graph_ms(calls[k], 100), 6))
        ms, floor_ms = float(np.median(turns["tree"])), float(np.median(turns["floor"]))
        call_ms = float(np.median([time_ms(lambda: bisect.WRAPPERS[probe](jstart, jcount, jfeat),
                                           200) for _ in range(3)]))
        plain_ms = time_ms(lambda: bisect.PLAIN[probe](jstart, jcount, jfeat), 1)
        library_ms = graph_ms(bisect_library(probe, jstart, jcount, jfeat), 100)
        bound = bisect_bound_ms(probe, jstart, jcount, jfeat)
        rows[probe] = dict(err=err_max, ms=ms, floor_ms=floor_ms, call_ms=call_ms,
                           plain_ms=plain_ms, library_ms=library_ms, bound=bound)
        log(f"phase 9 bisect {probe}: {len(sets)} start/count sets (the last: windows "
            f"{list(LONG_RUN_WINDOWS)} in {LONG_RUN_B} columns), max abs err {err_max:.3e} "
            f"({worst:.3f} of the tolerance), run == rerun bitwise, outputs sha256 "
            f"{h.hexdigest()[:16]}; kernel {ms:.6f} ms, floor {floor_ms:.6f} (fill_ of the "
            f"output) (medians of 6 CUDA graphs of 100 launches, in turns: {turns}), call_ms "
            f"{call_ms:.5f} (per wrapper call from the host, median of 3 x 200), plain "
            f"{plain_ms:.4f}, library {library_ms:.5f} (graph), bound {bound[0]:.7f} ms by "
            f"{bound[1]} ({bound[2]} bytes, {bound[3]} FP32 operations)"
            + (f"; the other checkout's {np.median(turns['other']):.6f} ms (median), "
               + ("bitwise equal on every set" if probe in ("window", "tri_mm") else
                  f"at {other_share:.3f} of the tolerance") if other else ""))
    costs = wrapper_costs(jstart, jcount, jfeat)
    log("phase 9 probe wrapper pieces, host us per call: "
        + ", ".join(f"{k} {v:.3f}" for k, v in costs.items()))

    # window at the run layout of the dense view 0: the blend's instances in
    # sorted order as 25 feature rows, each tile's run streamed in windows
    state = load_scene(res["dpath"], res["dcap"], mesh_views())
    with torch.no_grad():
        prep = prepare(state, mesh_views()[0][0], 0.1)
        del state
        binning = bin_prep(prep, WIDTH, HEIGHT, res["dbudget"], 8192, need_tile_gauss=False)
        table = prep.table
        n_inst = binning.gauss_id.numel()
        feat = torch.zeros((25, n_inst), device=dev)
        feat[:table.shape[1]] = table[binning.gauss_id.long()].T
        feat = bisect.pad_columns(feat)
        start, count = binning.tile_start.contiguous(), binning.tile_count.contiguous()
        out = bisect.window(start, count, feat)
        t0 = time.perf_counter()
        plain = bisect.window_torch(start, count, feat)
        torch.cuda.synchronize()
        dplain_ms = (time.perf_counter() - t0) * 1e3
        derr, dshare = probe_held("window", out, plain, start, count, feat)
        check(same_bits(out, bisect.window(start, count, feat)),
              "dense window differs between two runs")
        dms = [graph_ms(lambda: bisect.window(start, count, feat), 20) for _ in range(2)]
        fwd_ms = time_ms(lambda: blend.blend_forward(binning, table, WIDTH, HEIGHT), 5)
        dbound = bisect_bound_ms("window", start, count, feat)
        # the bytes the kernel asks for (every window of every step, a window
        # at a boundary between two tiles twice) and two yardsticks: the same
        # steps with the longest runs first (the tail) and torch.sum over the
        # whole matrix (the card's streaming rate)
        _, n = bisect.window_bounds(start, count)
        read_bytes = int(n.sum()) * bisect.CH * 25 * 4
        unique_bytes = dbound[2] - start.numel() * (8 + 8 * 256 * 4)  # less start / count, out
        order = torch.argsort(n, descending=True, stable=True)
        s_lf, c_lf = start[order].contiguous(), count[order].contiguous()
        check(same_bits(bisect.window(s_lf, c_lf, feat), out[order]),
              "dense window, longest runs first: another result")
        lf_ms = graph_ms(lambda: bisect.window(s_lf, c_lf, feat), 20)
        sum_ms = graph_ms(lambda: torch.sum(feat), 20)
        # the ring at other depths: each gives the kernel's result bit for
        # bit; timed here and at the JAX shapes
        variants = {}
        for name in WINDOW_VARIANTS:
            fn = functools.partial(copies[name], "window")
            check(same_bits(fn(start, count, feat), out) and
                  same_bits(fn(jstart, jcount, jfeat), bisect.window(jstart, jcount, jfeat)),
                  f"window variant {name} gives another result than the kernel")
            variants[name] = ([graph_ms(lambda: fn(start, count, feat), 20) for _ in range(2)],
                              graph_ms(lambda: fn(jstart, jcount, jfeat), 100))
    log(f"phase 9 window at the dense view 0's run layout: {n_inst} instances ({feat.shape[1]} "
        f"columns), {start.numel()} tiles, max run {int(count.max())}; kernel ms (2 CUDA "
        f"graphs of 20 launches) {dms}, bound {dbound[0]:.4f} ms by {dbound[1]} ({dbound[2]} "
        f"bytes, {unique_bytes} of them the windows' unique columns); the kernel asks for "
        f"{read_bytes} bytes ({int(n.sum())} windows); longest "
        f"runs first {lf_ms:.4f} ms; torch.sum over the matrix ({feat.numel() * 4} bytes) "
        f"{sum_ms:.4f} ms; variants (dense ms in 2 graphs of 20, ms at the JAX shapes in a "
        f"graph of 100) {variants}; plain {dplain_ms:.3f} ms, max abs err "
        f"{derr:.3e} ({dshare:.3f} of the tolerance), run == rerun bitwise; blend_fwd at the "
        f"same binning {fwd_ms:.4f} ms (5 launches)")
    check(dshare <= 1.0, f"dense window: error {derr} at {dshare} of the tolerance")
    return dict(rows=rows, launches=launches, dense=dict(ms=dms, bound=dbound, fwd_ms=fwd_ms))


def probes_only(workdir, other):
    """``--probes [CSRC]``: phase 9 alone, on the dense scene it writes and
    bins as phase 4 does (the budget from the measured demand of its 2
    views); given the csrc directory of another checkout, beside its
    probes."""
    from radegs_torch.ops.binning import default_instance_budget, round_budget
    from radegs_torch.ops.rasterize import bin_prep
    from radegs_torch.renderer import prepare

    dpath = os.path.join(workdir, "dense.ply")
    dcap = scene_ply(dpath, "dense")
    state = load_scene(dpath, dcap, mesh_views())
    with torch.no_grad():
        need = max(int(bin_prep(prepare(state, cam, 0.1), WIDTH, HEIGHT,
                                default_instance_budget(dcap), 8192,
                                need_tile_gauss=False).n_instances)
                   for cam, _, _ in mesh_views()[:2])
    del state
    torch.cuda.empty_cache()
    bisect_probes(dict(dpath=dpath, dcap=dcap, dbudget=round_budget(need)), other)


# ----------------------------------------------------------- phase 11 ----


def quality_cut(workdir):
    """Phase 11a: ``quality_dense.main`` at full width with its depth cut
    (launch counts set to 0 before and read after: the quality path)."""
    from radegs_torch.ops import blend
    from radegs_torch.ops import integrate as ig
    from radegs_torch.ops import preprocess as pp
    from radegs_torch.scripts import quality_dense

    t0 = time.perf_counter()
    step_events = []
    blend.reset_launches()  # the quality path starts here
    ig.reset_launches()
    pp.reset_launches()
    binning_launches(reset=True)
    rep = quality_dense.main([*QUALITY_CUT, "--report", os.path.join(workdir, "quality.json")],
                             step_events=step_events)
    # the quality path ends here
    launches = {**dict(blend.LAUNCHES), **dict(ig.LAUNCHES), **dict(pp.LAUNCHES),
                **binning_launches()}
    wall = time.perf_counter() - t0
    ev, h = rep["eval"], rep["health"]
    stages, _ = stage_medians(step_events)
    log(f"phase 11a quality_dense {rep['resolution'][0]}x{rep['resolution'][1]}, "
        f"{QUALITY_CUT}: {wall:.1f} s; test PSNR "
        + ", ".join(f"{e['iter']}: {e['psnr_test']:.4f}" for e in ev)
        + f" dB (train {ev[-1]['psnr_train']:.4f}); {rep['n_active_final']} splats, capacity "
        f"{rep['capacity_final']}; health {h}")
    log(f"phase 11a it/s by bucket {rep['it_per_s_by_1k']}, sustained "
        f"{rep['sustained_it_per_s']:.3f} it/s (host clock), train {rep['train_wall_s']:.1f} s; "
        "step stage medians (CUDA events, ms) "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; peak memory {rep['device']['max_memory_allocated'] / 2**30:.3f} GiB")
    for name in ("tsdf", "tetra"):
        m = rep[name]
        st = {k: (round(v, 3) if isinstance(v, float) else
                  [round(x, 3) for x in v] if isinstance(v, list) else v)
              for k, v in m["stats"].items()}
        log(f"phase 11a {name}: {m['wall_s']:.1f} s, {m['verts']} vertices, {m['faces']} faces; "
            f"accuracy {m['accuracy_mean']:.5f}, completeness {m['completeness_mean']:.5f}, "
            f"overall {m['overall']:.5f}; stages {st}")
    log(f"phase 11a kernel launches: {launches}")
    check(not rep["partial"], "phase 11a: the report says partial")
    check(h["nan_events"] == 0 and h["overflow_events"] == 0, f"phase 11a: health {h}")
    check(ev[-1]["psnr_test"] >= ev[0]["psnr_test"] + QUALITY_PSNR_GAIN,
          f"phase 11a: test PSNR {ev[0]['psnr_test']:.3f} -> {ev[-1]['psnr_test']:.3f} dB")
    for name in ("tsdf", "tetra"):
        m = rep[name]
        check(m["faces"] > QUALITY_MIN_FACES and m["overall"] < QUALITY_OVERALL_TOL,
              f"phase 11a {name}: {m['faces']} faces, overall {m['overall']:.5f}")
    g = default_g()
    check(all(launches[k] > 0 for k in (f"blend_fwd[G={g}]", f"blend_bwd[G={g}]",
                                       "integrate_image", "integrate_points")),
          f"a kernel never ran on the quality path: {launches}")
    return {"report": rep, "launches": launches, "stages": stages, "wall_s": wall}


def soak_cut(workdir):
    """Phase 11b: ``soak_dense.main`` at 600k points, no meshes."""
    from radegs_torch.scripts import soak_dense

    t0 = time.perf_counter()
    rep = soak_dense.main([*SOAK_CUT, "--report", os.path.join(workdir, "soak.json")])
    log(f"phase 11b soak_dense {SOAK_CUT}: {time.perf_counter() - t0:.1f} s; sustained "
        f"{rep['sustained_it_per_s']:.4f} it/s, {rep['sustained_rays_per_s']:.1f} rays/s "
        f"(host clock); final PSNR {rep['final_psnr']:.4f} dB, {rep['final_instances']:.0f} "
        f"instances; {rep['n_active_final']} splats, capacity {rep['capacity_final']}; peak "
        f"memory {rep['device']['max_memory_allocated'] / 2**30:.3f} GiB")
    check(math.isfinite(rep["final_psnr"]) and math.isfinite(rep["final_instances"]),
          f"phase 11b: final PSNR {rep['final_psnr']}, instances {rep['final_instances']}")
    return rep


def sweep(workdir, argv, label, record=None):
    """``decimation_sweep.main`` with each setting's seeds, Delaunay and
    SDF-pass seconds; beside ``record`` (a JAX report of the same seeds and
    scale) the vertex counts and overall scores (a finding past
    SWEEP_VERTS_DIFF / SWEEP_OVERALL_DIFF, not a gate)."""
    from radegs_torch.scripts import decimation_sweep

    t0 = time.perf_counter()
    stats = {}
    name = re.sub(r"\W+", "_", label).strip("_")
    rep = decimation_sweep.main([*argv, "--report", os.path.join(workdir, f"{name}.json")],
                                stats=stats)
    log(f"{label} decimation_sweep {rep['n_points']} points {rep['resolution']} "
        f"{rep['n_views']} views: {time.perf_counter() - t0:.1f} s; sigma_median "
        f"{rep['sigma_median']:.6g}")
    old = {r["setting"]: r for r in record["results"]} if record else {}
    for r in rep["results"]:
        st = stats[r["setting"]]
        line = (f"  {r['setting']}: voxel {r['decimate_voxel']}, seeds {st['n_seeds']} -> "
                f"{st['n_seeds_decimated']}, Delaunay {st['delaunay_s']:.1f} s, SDF passes "
                f"{sum(st['sdf_pass_s']):.1f} s, wall {r['wall_s']} s; {r['verts']} vertices, "
                f"overall {r['overall']:.6f} (accuracy {r['accuracy_mean']:.6f}, completeness "
                f"{r['completeness_mean']:.6f})")
        if r["setting"] in old:
            o = old[r["setting"]]
            dv = (r["verts"] - o["verts"]) / o["verts"]
            do = (r["overall"] - o["overall"]) / o["overall"]
            far = abs(dv) > SWEEP_VERTS_DIFF or abs(do) > SWEEP_OVERALL_DIFF
            line += (f"; record {o['verts']} vertices ({dv:+.2%}), overall {o['overall']:.6f} "
                     f"({do:+.2%}){' FINDING: past 2% / 5%' if far else ''}")
        log(line)
        check(r["verts"] > 0 and math.isfinite(r["overall"]), f"{label} {r['setting']}: {r}")
    return rep, stats


def quality(workdir):
    """Phase 11: the quality protocol with its depth cut, the soak and the
    decimation sweep beside the JAX record."""
    t0 = time.perf_counter()
    q = quality_cut(workdir)
    soak_cut(workdir)
    with open(os.path.join(ROOT, SWEEP_RECORD)) as f:
        record = json.load(f)
    sweep(workdir, ["--settings", *SWEEP_SETTINGS], "phase 11c", record)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s in all")
    return q


def quality_schedule(workdir, wall_budget):
    """--quality: the JAX record's protocol at schedule, resumed from
    ``build/chip_smoke/q30k`` when it exists (the report says which), meshes
    at the end, then the sweep at full scale."""
    from radegs_torch.scripts import quality_dense

    t0 = time.perf_counter()
    argv = [*QUALITY_SCHEDULE, "--checkpoint", os.path.join(workdir, "q30k"),
            "--report", os.path.join(workdir, "quality_schedule.json")]
    if wall_budget is not None:
        argv += ["--wall_budget", str(wall_budget)]
    rep = quality_dense.main(argv)
    log(f"--quality: {time.perf_counter() - t0:.1f} s; iterations {rep['iters_completed']} of "
        f"{rep['iters']} (partial {rep['partial']}, recovered {rep['recovered_from_checkpoint']})"
        f"; test PSNR " + ", ".join(f"{e['iter']}: {e['psnr_test']:.4f}" for e in rep["eval"])
        + f" dB; health {rep['health']}; sustained {rep['sustained_it_per_s']} it/s; "
        f"by bucket {rep['it_per_s_by_1k']}; {rep['n_active_final']} splats, capacity "
        f"{rep['capacity_final']}; peak memory "
        f"{rep['device']['max_memory_allocated'] / 2**30:.3f} GiB")
    for name in ("tsdf", "tetra"):
        m = rep[name]
        log(f"--quality {name}: {m['wall_s']:.1f} s, {m['verts']} vertices, {m['faces']} faces,"
            f" overall {m['overall']:.6f} (accuracy {m['accuracy_mean']:.6f}, completeness "
            f"{m['completeness_mean']:.6f}); stages {m['stats']}")
    check(rep["health"]["nan_events"] == 0, f"--quality: health {rep['health']}")
    sweep(workdir, SWEEP_FULL_SCALE, "--quality sweep")
    log(f"--quality: {time.perf_counter() - t0:.1f} s in all")


def profile_serving(workdir):
    """``--profile``: torch.profiler over 3 views of the 100k scene and 1 of
    the dense scene; prints the device time by operation and the device's
    busy share of the window, and writes Chrome traces into ``workdir``'s
    parent (build/chip_smoke/)."""
    from torch.profiler import ProfilerActivity, profile

    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.ops.binning import default_instance_budget, round_budget
    from radegs_torch.renderer import render

    dev = torch.device(DEVICE)
    cams = orbit_cameras(N_VIEWS, dev)
    out_dir = os.path.dirname(workdir)
    for scene, views, max_per_tile in (("100k", 3, 512), ("dense", 1, 8192)):
        path = os.path.join(workdir, f"{scene}.ply")
        cap = scene_ply(path, scene)
        state = gm.update_3d_filter(
            gm.load_gaussian_ply(path, sh_degree=3, capacity=cap, device=dev), cams)
        budget = default_instance_budget(cap)
        with torch.no_grad():
            for cam in cams[:2]:  # warm-up, and the budget from the demand
                b = render(state, cam, [0, 0, 0], kernel_size=0.1, max_per_tile=max_per_tile,
                           instance_budget=budget, device=DEVICE)["binning"]
                if int(b.n_overflow):
                    budget = round_budget(int(b.n_instances))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for cam in cams[:views]:
                    render(state, cam, [0, 0, 0], kernel_size=0.1, max_per_tile=max_per_tile,
                           instance_budget=budget, device=DEVICE)
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - t0) * 1e6
        ka = prof.key_averages()
        kernels = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        n_ops = sum(e.count for e in ka if e.key.startswith("aten::"))
        log(f"profile {scene}: {views} views in {window_us / 1e3:.3f} ms, device busy "
            f"{busy_us / 1e3:.3f} ms ({100 * busy_us / window_us:.1f}% of the window); "
            f"per view {sum(e.count for e in kernels) / views:.0f} kernels from "
            f"{n_ops / views:.0f} aten ops")
        log(ka.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
        prof.export_chrome_trace(os.path.join(out_dir, f"profile_{scene}.json"))
        del state
        torch.cuda.empty_cache()


def profile_training(workdir):
    """``--profile``: torch.profiler over iterations 21-25 of ``train`` on the
    100k scene (after the work-buffer autotune has settled, before any
    densify); prints the device time by operation and the busy share."""
    from torch.profiler import ProfilerActivity, profile

    from radegs_torch.ops.binning import default_instance_budget
    from radegs_torch.train.config import ModelConfig, OptimizationConfig, PipelineConfig
    from radegs_torch.train.loop import train

    cams = orbit_cameras(N_VIEWS, torch.device(DEVICE))
    path = os.path.join(workdir, "train100k.ply")
    cap = scene_ply(path, "100k")
    scene, g0, _ = training_scene(path, cap, cams, default_instance_budget(cap))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def around(it, ts, m):
        if it == 20:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        elif it == 25:
            torch.cuda.synchronize()
            window["us"] = (time.perf_counter() - window["t0"]) * 1e6
            prof.stop()

    train(scene, g0, ModelConfig(kernel_size=0.1),
          OptimizationConfig(iterations=25, densify_from_iter=100, regularization_from_iter=10),
          PipelineConfig(max_per_tile=512), log_every=25, device=DEVICE, callbacks=[around])
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"profile training 100k: iterations 21-25 in {window['us'] / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / window['us']:.1f}% of the window); per "
        f"iteration {sum(e.count for e in kernels) / 5:.0f} kernels from "
        f"{sum(e.count for e in ka if e.key.startswith('aten::')) / 5:.0f} aten ops")
    log(ka.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
    prof.export_chrome_trace(os.path.join(os.path.dirname(workdir), "profile_train.json"))


def train_ab(workdir):
    """``--train100k``: phase 3's 100k serving at ``default_g()`` and phase
    6's 100 iterations of the 100k scene, nothing else."""
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.ops import blend
    from radegs_torch.ops.binning import default_instance_budget

    dev = torch.device(DEVICE)
    cams = orbit_cameras(N_VIEWS, dev)
    path = os.path.join(workdir, "scene100k.ply")
    cap = scene_ply(path, "100k")
    blend.reset_launches()
    state = gm.update_3d_filter(
        gm.load_gaussian_ply(path, sh_degree=3, capacity=cap, device=dev), cams)
    g = default_g()
    rows, budget = serve(state, cams, 512, default_instance_budget(cap), g, f"100k G={g}",
                         warmup=WARMUP)
    report(f"phase 3 100k 1600x1200 G={g}", rows, budget, blend.LAUNCHES[f"blend_fwd[G={g}]"],
           torch.cuda.max_memory_allocated())
    del state
    torch.cuda.empty_cache()
    train_100k(path, cap, cams, budget)


def tetra_only(workdir):
    """``--tetra``: phase 7c alone, the Marching Tetrahedra extraction of the
    50k-splat scene (its SDF passes run B6 at the sizes of the main path)."""
    views = mesh_views()
    path = os.path.join(workdir, "surface50k.ply")
    state = load_scene(path, scene_ply(path, "surface50k"), views)
    _, verts, _ = mesh_tetra(state, views, workdir, f"7c tetra of the {TETRA_N}-splat scene")
    mesh_geometry(verts, "7c tetra")


def integrate_only(workdir, other):
    """``--integrate [CSRC]``: phase 7a and phase 7d alone (B6 also at
    SDF_PASS_POINTS), beside INTEGRATE_VARIANTS and, given the csrc directory
    of another checkout, its integrate kernels (``integrate_libraries``)."""
    parity = [integrate_parity(), integrate_parity(250, 190, (1.6, 0, 0))]
    libs = integrate_libraries(other)
    dpath = os.path.join(workdir, "dense.ply")
    integrate_alone(dict(dpath=dpath, dcap=scene_ply(dpath, "dense")), SDF_PASS_POINTS, libs)
    log(f"integrate kernels vs plain, max abs err over phase 7a: "
        f"{max(p[0] for p in parity):.3e}")


# ----------------------------------------------------------- phase 12 ----


def parallel_scene(workdir, res=None):
    """Phase 12's scene: phase 6's 100k training scene (8 views at
    1600x1200 rendered from the 100k scene, ``create_from_points`` of its
    jittered centres, capacity 131072, SH 3) with its 3D filter, saved for
    the ranks. Returns (path of the saved scene, the scene, the state)."""
    from radegs_torch.models import gaussian_model as gm

    dev = torch.device(DEVICE)
    if res is None:
        path, cap, cams, budget = os.path.join(workdir, "scene100k.ply"), None, None, None
        cap = scene_ply(path, "100k")
        cams = orbit_cameras(N_VIEWS, dev)
    else:
        path, cap, cams, budget = res["path"], res["cap"], res["cams"], res["budget"]
    scene, g0, _ = training_scene(path, cap, cams, budget)
    g0 = gm.update_3d_filter(g0, cams)
    saved = os.path.join(workdir, "parallel_scene.pt")
    torch.save({"gaussians": gm.per_slot(g0, lambda x: x.cpu()),
                "gts": [gt.cpu() for _, gt, _ in scene.cameras], "extent": scene.extent},
               saved)
    return saved, scene, g0


def load_parallel_scene(saved, dev):
    """The saved phase-12 scene on ``dev``: (SceneLike, initial state)."""
    from radegs_torch.models import gaussian_model as gm
    from radegs_torch.train.loop import SceneLike

    data = torch.load(saved, weights_only=False)
    cams = orbit_cameras(N_VIEWS, dev)
    scene = SceneLike(cameras=[(c, gt.to(dev), i) for i, (c, gt) in
                               enumerate(zip(cams, data["gts"]))], extent=data["extent"])
    return scene, gm.per_slot(data["gaussians"], lambda x: x.to(dev))


def parallel_configs(pcfg):
    from radegs_torch.train.config import ModelConfig, OptimizationConfig

    return ModelConfig(**TRAIN_MCFG), OptimizationConfig(**PAR_OCFG), pcfg


@contextlib.contextmanager
def band_inputs():
    """Record what the multi-rank step hands ``rasterize`` while the block
    runs: [(the gathered rows with band-local xy, the band's arguments)]."""
    from radegs_torch.parallel import step as pstep

    seen, inner = [], pstep.rasterize

    def spy(prep, camera, bg, **kw):
        seen.append((prep, kw))
        return inner(prep, camera, bg, **kw)

    pstep.rasterize = spy
    try:
        yield seen
    finally:
        pstep.rasterize = inner


def band_kernels(prep, kw, label):
    """B3 and B4 on one rank's band as the multi-rank step feeds them: the
    band's binning of the gathered rows at the band's width and height and
    the GOF statistic at the full image's NDC scale (``ndc_size``), against
    the plain forward (ABS_TOL; med_pos flips <= MED_POS_TOL) and
    ``blend_backward_torch(ndc_size=)`` (each field within BWD_REL_TOL x
    max |plain|), with seeded cotangents. Returns (forward max abs error,
    backward worst relative error)."""
    from radegs_torch.ops import blend
    from radegs_torch.ops.rasterize import bin_prep

    W, H, g = kw["render_width"], kw["render_height"], kw["tiles_per_block"]
    ndc = (WIDTH, HEIGHT)
    with torch.no_grad():
        binning = bin_prep(prep, W, H, kw["instance_budget"], kw["max_per_tile"],
                           need_tile_gauss=True)
        table = prep.table.detach()
        fwd = blend.blend_forward(binning, table, W, H, tiles_per_block=g)
        err, flips, med_err = compare(fwd, blend.blend_forward_torch(binning.tile_gauss, table,
                                                                     W, H))
        cot = random_cotangents(fwd, 12)
        grads = blend.blend_backward(binning, table, fwd, cot, W, H, tiles_per_block=g,
                                     ndc_size=ndc)
        errs = compare_grads(grads, blend.blend_backward_torch(binning.tile_gauss, table, fwd,
                                                               cot, W, H, ndc_size=ndc))
    torch.cuda.synchronize()
    worst = max(r for _, r in errs.values())
    log(f"{label}: {W}x{H} rows from global row {kw['band_row0']}, ndc_size {ndc}, "
        f"n_instances {int(binning.n_instances)} (overflow {int(binning.n_overflow)} / "
        f"{int(binning.tile_overflow)}); blend_fwd[G={g}] vs plain max abs err {err:.3e}, "
        f"med_pos flips {flips:.3e}, med_t/med_coord err {med_err:.3e}; blend_bwd[G={g}] vs "
        "plain per field abs / rel to max |plain|: "
        + ", ".join(f"{k} {a:.3e} / {r:.3e}" for k, (a, r) in errs.items()))
    check(int(binning.n_overflow) == 0 and int(binning.tile_overflow) == 0,
          f"{label}: the band's binning overflowed")
    check(err <= ABS_TOL and med_err <= ABS_TOL, f"{label}: forward vs plain {err}, {med_err}")
    check(flips <= MED_POS_TOL, f"{label}: med_pos flips {flips}")
    check(worst <= BWD_REL_TOL, f"{label}: backward vs plain rel err {worst}")
    return max(err, med_err), worst


def one_sharded_step(mesh, scene, g0, pcfg, label):
    """One multi-rank step of view 0 from ``g0`` (depth-normal term on),
    then ``band_kernels`` on the band this rank rendered in it: (metrics,
    the canonical first moments and screen-gradient statistics {name:
    tensor}, the step's launches, the band check's errors)."""
    from radegs_torch import parallel as par
    from radegs_torch.ops import blend
    from radegs_torch.train.loop import TrainState

    mcfg, ocfg, pcfg = parallel_configs(pcfg)
    cam, gt, _ = scene.cameras[0]
    n = mesh.world
    ts = par.shard_train_state(TrainState(gaussians=par.to_strided(g0, n),
                                          iteration=PAR_REG_ITER), mesh)
    step = par.make_sharded_train_step(mcfg, ocfg, pcfg, scene.extent, mesh, WIDTH, HEIGHT)
    gt_p = par.pad_gt(gt, par.band_layout(HEIGHT, n)[2])
    bg = torch.zeros(3, device=mesh.device)
    blend.reset_launches()
    with band_inputs() as seen:
        ts, met = step(ts, cam, gt_p, bg, 0)
    torch.cuda.synchronize()
    launches = dict(blend.LAUNCHES)
    (prep, kw), = seen
    band = band_kernels(prep, kw, f"{label} rank {mesh.rank} band")
    g = par.to_canonical(par.gather_gaussian_state(ts.gaussians, mesh), n)
    return ({k: float(v) for k, v in met.items()}, gate_fields(g), launches, band)


def gate_fields(g):
    """What phase 12 holds to the single-rank step: the first moment of each
    parameter group and the two screen-gradient statistics (the GOF one
    scaled by the full image's size, also in a band)."""
    return {**{f"m_{k}": v for k, v in g.adam_m.items()},
            "grad_accum": g.grad_accum, "grad_abs_accum": g.grad_abs_accum}


def rank_phase12(mesh, saved, pcfg):
    """Phase 12b on one rank: one step for the gates, then ``train(mesh=)``
    for PAR_ITERS iterations with the launch counts set to 0 just before."""
    from radegs_torch.ops import blend
    from radegs_torch.ops import preprocess as pp
    from radegs_torch.train import optim
    from radegs_torch.train.loop import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene, g0 = load_parallel_scene(saved, mesh.device)
    met, gate, step_launches, band = one_sharded_step(mesh, scene, g0, pcfg,
                                                      f"phase 12b world {mesh.world}")
    gate = {k: v.cpu() for k, v in gate.items()} if mesh.rank == 0 else None
    stamps = []
    blend.reset_launches()  # the multi-rank training path starts here
    pp.reset_launches()
    binning_launches(reset=True)
    optim.reset_launches()
    t0 = time.perf_counter()
    ts, hist = train(scene, g0, *parallel_configs(pcfg), seed=0, log_every=1, mesh=mesh,
                     device=mesh.device,
                     callbacks=[lambda it, ts, m: stamps.append(time.perf_counter())])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**dict(blend.LAUNCHES), **dict(pp.LAUNCHES), **binning_launches(),
                **dict(optim.LAUNCHES)}  # ... and ends here
    finite = all(bool(torch.isfinite(p).all()) for _, p in ts.gaussians.params.items())
    return dict(step=met, gate=gate, step_launches=step_launches, band=band,
                backend=mesh.backend, hist=hist, launches=launches,
                wall=wall, host_ms=1e3 * float(np.median(np.diff(stamps))), finite=finite,
                n_active=int(ts.gaussians.n_active()), capacity=ts.gaussians.capacity)


def gates_agree(m, ref, label):
    """The gate of ``gate_fields``: each within PAR_M1_TOL x its max |.| in
    the single-rank step; returns the worst ratio."""
    worst = 0.0
    for k, r in ref.items():
        err = float((m[k].to(r.device) - r).abs().max())
        scale = float(r.abs().max())
        check(err <= PAR_M1_TOL * scale, f"{label}: {k} off by {err:.3e} (max |.| "
              f"{scale:.3e})")
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def parallel_training(workdir, res=None, world=2, device="cuda:0"):
    """Phase 12: multi-rank training on the card. (a) World 1 under NCCL in
    this process: one multi-rank step against the single-rank step (first
    moments and statistics within PAR_M1_TOL x max |.|, loss within
    PAR_LOSS_REL). (b) World 2 under gloo, both ranks on card 0 (two bands
    of 38 tile rows, 1216 padded rows): the same gates, then PAR_ITERS
    iterations of ``train(mesh=)`` with one densify; the blend kernels at
    G = 2 must launch on every rank. In (a) and on every rank of (b), B3
    and B4 on the rank's band are held to their plain versions
    (``band_kernels``). ``world`` / ``device`` set (b)'s ranks, their
    backend ``parallel.default_backend``'s (``--nccl``: a card a rank,
    NCCL)."""
    import torch.distributed as dist

    from radegs_torch import parallel as par
    from radegs_torch.ops.binning import round_budget
    from radegs_torch.renderer import render
    from radegs_torch.train.config import PipelineConfig
    from radegs_torch.train.loop import TrainState, make_train_step

    t_start = time.perf_counter()
    g = default_g()
    saved, scene, g0 = parallel_scene(workdir, res)
    cam, gt, _ = scene.cameras[0]
    with torch.no_grad():  # the step's work buffers from view 0's demand
        b = render(g0, cam, [0.0, 0.0, 0.0], kernel_size=0.1, device=DEVICE)["binning"]
    # twice the demand: each band's budget is half of it, enough for any split
    pcfg = PipelineConfig(instance_budget=round_budget(2 * int(b.n_instances)),
                          max_per_tile=max(512, 1 << (2 * int(b.max_tile_count) - 1).bit_length()))
    mcfg, ocfg, _ = parallel_configs(pcfg)
    ref_step = make_train_step(mcfg, ocfg, pcfg, spatial_lr_scale=scene.extent)
    ts_ref, m_ref = ref_step(TrainState(gaussians=g0, iteration=PAR_REG_ITER), cam, gt,
                             torch.zeros(3, device=DEVICE), 0, WIDTH, HEIGHT)
    loss_ref = float(m_ref["loss"])
    check(int(m_ref["n_overflow"]) == 0 and int(m_ref["tile_overflow"]) == 0,
          f"phase 12 single-rank step overflowed: {m_ref}")
    gate_ref = gate_fields(ts_ref.gaussians)
    del ts_ref

    # ---- 12a: world 1, NCCL, in this process ----
    dist.init_process_group("nccl", init_method="file://" + os.path.join(workdir, "pg12a"),
                            rank=0, world_size=1)
    try:
        mesh = par.make_mesh_1d()
        met1, gate1, launches1, band1 = one_sharded_step(mesh, scene, g0, pcfg,
                                                         "phase 12a world 1")
        # the multi-rank machinery's own cost: world-1 steps against
        # single-rank steps from the same state, in turns
        w1_step = par.make_sharded_train_step(mcfg, ocfg, pcfg, scene.extent, mesh, WIDTH,
                                              HEIGHT)
        gt_p = par.pad_gt(gt, par.band_layout(HEIGHT, 1)[2])
        bg = torch.zeros(3, device=DEVICE)
        calls = {
            "single rank": lambda ts: ref_step(ts, cam, gt, bg, 0, WIDTH, HEIGHT),
            "world 1": lambda ts: w1_step(ts, cam, gt_p, bg, 0)}
        step_ms = {k: [] for k in calls}
        for _ in range(PAR_TIMED_STEPS):
            for name, call in calls.items():
                ts = TrainState(gaussians=g0, iteration=PAR_REG_ITER)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call(ts)
                torch.cuda.synchronize()
                step_ms[name].append(1e3 * (time.perf_counter() - t0))
    finally:
        dist.destroy_process_group()
    step_ms = {k: float(np.median(v)) for k, v in step_ms.items()}
    w1 = gates_agree(gate1, gate_ref, "phase 12a world 1")
    rel1 = abs(met1["loss"] - loss_ref) / abs(loss_ref)
    check(rel1 <= PAR_LOSS_REL, f"phase 12a loss {met1['loss']} vs {loss_ref}")
    check(launches1[f"blend_fwd[G={g}]"] == 1 and launches1[f"blend_bwd[G={g}]"] == 1,
          f"phase 12a launches {launches1}")
    log(f"phase 12a world 1 (nccl): loss {met1['loss']:.7f} vs single rank {loss_ref:.7f} "
        f"(rel {rel1:.2e}); first moments and screen-gradient statistics worst {w1:.2e} of "
        f"max |.|; B3 / B4 on its band vs plain: forward {band1[0]:.3e} abs, backward "
        f"{band1[1]:.3e} of max |plain|; n_vis {met1['n_vis']:.0f}, gather_rows {met1['gather_rows']:.0f}, full_gather_rows "
        f"{met1['full_gather_rows']:.0f}; launches {launches1}; one step of view 0, median of "
        f"{PAR_TIMED_STEPS} in turns (host clock): single rank {step_ms['single rank']:.3f} ms, "
        f"world 1 {step_ms['world 1']:.3f} ms")
    del gate1

    # ---- 12b: world 2, gloo, both ranks on card 0 ----
    _, band_px, h_pad = par.band_layout(HEIGHT, world)
    sharing = (f"{world} ranks time-sharing one card" if device == "cuda:0" and world > 1
               else "a card a rank")
    outs = par.run_ranks(rank_phase12, world, device=device, timeout_s=PAR_TIMEOUT_S,
                         args=(saved, pcfg))
    r0 = outs[0].result
    backend = r0["backend"]
    w2 = gates_agree(r0["gate"], gate_ref, f"phase 12b world {world}")
    rel2 = abs(r0["step"]["loss"] - loss_ref) / abs(loss_ref)
    check(rel2 <= PAR_LOSS_REL, f"phase 12b loss {r0['step']['loss']} vs {loss_ref}")
    for r, o in enumerate(outs):
        la = o.result["launches"]
        check(la[f"blend_fwd[G={g}]"] > 0 and la[f"blend_bwd[G={g}]"] > 0,
              f"phase 12b rank {r}: a blend kernel never ran on the training path: {la}")
        check(la["adam_stats"] == PAR_ITERS, f"phase 12b rank {r}: adam_stats launched "
              f"{la['adam_stats']} times in {PAR_ITERS} iterations")
        check(o.result["hist"][-1]["loss"] == r0["hist"][-1]["loss"],
              "phase 12b: the ranks report different losses")
    hist = r0["hist"]
    losses = [h["loss"] for h in hist]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(all(math.isfinite(x) for x in losses) and r0["finite"], "phase 12b not finite")
    check(last < first, f"phase 12b loss did not fall: {first} -> {last}")
    check(hist[-1]["n_vis_overflow"] == 0, f"phase 12b gather overflow {hist[-1]}")
    check(hist[PAR_DENSIFY_AT]["n_active"] != hist[PAR_DENSIFY_AT - 1]["n_active"],
          "phase 12b: the densify changed nothing")
    launches = {k: sum(o.result["launches"][k] for o in outs) for k in r0["launches"]}
    log(f"phase 12b world {world} ({backend}, {sharing}; bands of {band_px} rows, "
        f"{h_pad} padded): step loss {r0['step']['loss']:.7f} (rel {rel2:.2e}), first moments "
        f"and statistics worst {w2:.2e} of max |.|; B3 / B4 on each rank's band vs plain "
        f"(forward abs, backward of max |plain|): "
        + ", ".join(f"{b[0]:.3e} / {b[1]:.3e}" for b in (o.result["band"] for o in outs))
        + f"; {PAR_ITERS} iterations of train(mesh=): "
        f"{r0['host_ms']:.3f} ms per iteration, median (host clock, {sharing}"
        + (": no scaling figure" if sharing != "a card a rank" else "")
        + f"), {r0['wall']:.3f} s in all; loss {first:.5f} -> {last:.5f}; "
        f"n_active {hist[0]['n_active']} -> {r0['n_active']} (capacity {r0['capacity']}); "
        f"n_vis {hist[-1]['n_vis']:.0f} (worst rank {hist[-1]['n_vis_max']:.0f}), gather_rows "
        f"{hist[-1]['gather_rows']:.0f}, full_gather_rows {hist[-1]['full_gather_rows']:.0f}; "
        f"launches per rank {[o.result['launches'] for o in outs]}")
    log("  loss per iteration: " + " ".join(f"{x:.5f}" for x in losses))
    log(f"phase 12: {time.perf_counter() - t_start:.1f} s in all")
    return {"launches": launches, "gate_worst": max(w1, w2), "step_ms": step_ms,
            "band_worst": [max(b[i] for b in [band1] + [o.result["band"] for o in outs])
                           for i in (0, 1)]}


def nccl_only(workdir):
    """--nccl, on a machine with several cards: phase 12 with (b) at one
    rank a card under NCCL, then ``bench_scaling`` at every power of two up
    to the card count (a card a rank, so with its efficiency figure)."""
    from radegs_torch.scripts import bench_scaling

    cards = torch.cuda.device_count()
    check(cards > 1, f"--nccl needs several cards, found {cards}")
    parallel_training(workdir, world=cards, device="cuda")
    bench_scaling.main(["--world_sizes", *[str(1 << k) for k in range(cards.bit_length())
                                           if 1 << k <= cards], "--zoom"])


def parallel_only(workdir):
    """--parallel: phase 12 alone, then the growth stress at world 2 to its
    default target and the weak-scaling script at worlds 1 and 2."""
    from radegs_torch.scripts import bench_scaling, stress_mesh_growth

    parallel_training(workdir)
    t0 = time.perf_counter()
    stress_mesh_growth.main(["--world_size", "2", "--report",
                             os.path.join(workdir, "stress_mesh_growth.json")])
    log(f"--parallel stress_mesh_growth: {time.perf_counter() - t0:.1f} s")
    bench_scaling.main(["--world_sizes", "1", "2", "--zoom"])


def backward_only(workdir, other):
    """``--bwd [CSRC]``: phase 2, the reference check, the fault C1 witness
    and phase 5's backward at its three shapes, beside BWD_VARIANTS,
    BWD_PROBES and, given the csrc directory of another checkout, its
    backward pair."""
    parity = [parity_scene(), parity_scene(250, 190, (1.6, 0, 0))]
    reference_check()
    tf32_witness()
    libs = bwd_libraries(BWD_VARIANTS, BWD_PROBES, other)
    cams = orbit_cameras(N_VIEWS, torch.device(DEVICE))
    path, dpath = os.path.join(workdir, "scene100k.ply"), os.path.join(workdir, "dense.ply")
    cap, dcap = scene_ply(path, "100k"), scene_ply(dpath, "dense")
    backward_shapes(path, cap, dpath, dcap, cams, libs)
    log(f"backward vs plain, max rel err over phase 2: {max(p[2] for p in parity):.3e}")


def forward_only(workdir, other):
    """``--fwd [CSRC]``: phase 2's forward checks, then the forward at the
    three view-0 shapes (``forward_shape``) beside FWD_VARIANTS and, given
    the csrc directory of another checkout, its forward kernel (its own C
    entry, fed the same binning)."""
    parity = [parity_scene(backward=False), parity_scene(250, 190, (1.6, 0, 0), backward=False)]
    libs = fwd_libraries(FWD_VARIANTS, other)
    cams = orbit_cameras(N_VIEWS, torch.device(DEVICE))
    path, dpath = os.path.join(workdir, "scene100k.ply"), os.path.join(workdir, "dense.ply")
    cap, dcap = scene_ply(path, "100k"), scene_ply(dpath, "dense")
    for _, label, binning, table, work, plain_ms, reps in view0_shapes(
            path, cap, dpath, dcap, cams):
        with torch.no_grad():
            forward_shape(f"--fwd {label}", binning, table, work, plain_ms, libs, reps)
    log(f"forward vs plain, max abs err over phase 2: {max(p[0] for p in parity):.3e}")


# ------------------------------------------------------------ phase 13 ----


BENCH_PARITY_TOL = 1e-4  # PERF.md section 2's limit for the blend kernels


def bench_phase():
    """Phase 13: the headline bench and its breakdown at full size, checked
    and reported. Returns the bench's record, the breakdown's fields and
    the bench's kernel launches."""
    from radegs_torch.ops import blend
    from radegs_torch.ops import preprocess as pp
    from radegs_torch.train import optim
    from radegs_torch.scripts import bench, bench_breakdown

    t0 = time.perf_counter()
    # ---- the bench path starts here ----
    blend.reset_launches()
    pp.reset_launches()
    binning_launches(reset=True)
    optim.reset_launches()
    details = {}
    rec = bench.main(["--scene", "both"], details=details)
    launches = {**dict(blend.LAUNCHES), **dict(pp.LAUNCHES), **binning_launches(),
                **dict(optim.LAUNCHES)}  # the bench path ends here
    t_bench = time.perf_counter() - t0
    log(f"phase 13 bench: {json.dumps(rec)}")
    for scene, d in details.items():
        steps = [d["first"]] + d["steps"]
        log(f"phase 13 {scene}: set-up {d['setup_s']:.3f} s (build_scene: "
            f"create_from_points with the KNN on the card, the 3D filter; outside the timed "
            f"window); configurations (max_per_tile, instance_budget) {d['configs']}; "
            f"{d['n_steps']} steps, {d['step_ms']:.3f} ms a timed step (host clock, "
            f"{bench.ITERS} steps); n_instances "
            + " ".join(str(int(m["n_instances"])) for m in steps)
            + f"; overflow at the first step {d['first']['n_overflow']:.0f} instances, "
            f"{d['first']['tile_overflow']:.0f} tile; losses "
            + " ".join(f"{m['loss']:.6f}" for m in steps)
            + f"; peak memory {d['peak_bytes'] / 2**30:.3f} GiB")
        check(all(m["n_overflow"] == 0 and m["tile_overflow"] == 0 for m in d["steps"]),
              f"phase 13 {scene}: a timed step dropped work")
        check(all(math.isfinite(m["loss"]) for m in steps), f"phase 13 {scene}: loss not finite")
    err = rec["kernel_parity_max_err"]
    check(err <= BENCH_PARITY_TOL, f"phase 13 kernel parity {err} > {BENCH_PARITY_TOL}")
    for k in ("value", "value_dense"):
        check(math.isfinite(rec[k]) and rec[k] > 0, f"phase 13 {k} = {rec[k]}")
    n_steps = sum(d["n_steps"] for d in details.values())
    want = {"blend_fwd[G=2]": n_steps + 1, "blend_bwd[G=2]": n_steps + 1,
            "blend_fwd[G=1]": 1, "blend_bwd[G=1]": 1}
    log(f"phase 13 bench {t_bench:.1f} s; kernel launches {launches} (want {want})")
    check(all(launches[k] == v for k, v in want.items()),
          f"phase 13 launches {launches}, want {want}")

    t1 = time.perf_counter()
    fields = bench_breakdown.main([])
    log(f"phase 13 breakdown: {json.dumps(fields)}")
    full, span = fields["full"], fields["event_span"]
    log(f"phase 13 breakdown 100k: {full} ms a step on the host clock (the mean), {span} ms "
        f"from a step's first to its last event (the median); full - event_span "
        f"{full - span:.2f} ms; {time.perf_counter() - t1:.1f} s")
    check(all(v is not None and math.isfinite(v) and v >= 0 for v in fields.values()),
          f"phase 13 breakdown {fields}")
    log(f"phase 13 {time.perf_counter() - t0:.1f} s")
    return {"rec": rec, "breakdown": fields, "launches": launches}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "radegs_torch")):
        sys.exit("chip_smoke: run from a checkout of the repository (radegs_torch/ missing)")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = setup()
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    if sys.argv[1:] == ["--profile"]:
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            profile_serving(tmp)
            profile_training(tmp)
        return
    if sys.argv[1:2] == ["--probes"]:
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            probes_only(tmp, sys.argv[2] if len(sys.argv) > 2 else None)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if sys.argv[1:2] == ["--bwd"]:
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            backward_only(tmp, sys.argv[2] if len(sys.argv) > 2 else None)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if sys.argv[1:2] == ["--fwd"]:
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            forward_only(tmp, sys.argv[2] if len(sys.argv) > 2 else None)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if sys.argv[1:2] == ["--integrate"]:
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            integrate_only(tmp, sys.argv[2] if len(sys.argv) > 2 else None)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if sys.argv[1:] == ["--preprocess"]:
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            rows = preprocess_only(tmp)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        print(json.dumps({"kernels": rows}))
        return
    if sys.argv[1:] == ["--adam"]:
        res = adam_alone(variants=True)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        print(json.dumps({"kernels": [adam_row(res, {})]}))
        return
    if sys.argv[1:] == ["--binning"]:
        res = binning_alone()
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(smi)
        print(json.dumps({"kernels": [binning_row(res, {})]}))
        return
    if sys.argv[1:] == ["--tetra"]:
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            tetra_only(tmp)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if sys.argv[1:] == ["--eval"]:
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            evaluation(entry_points(tmp, {"train_host_ms": float("nan")}))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if sys.argv[1:2] == ["--quality"]:
        quality_schedule(workdir, float(sys.argv[2]) if len(sys.argv) > 2 else None)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if sys.argv[1:] == ["--nccl"]:
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            nccl_only(tmp)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if sys.argv[1:] == ["--parallel"]:
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            parallel_only(tmp)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if sys.argv[1:] == ["--bench"]:
        bench_phase()
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return
    if sys.argv[1:] == ["--train100k"]:
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            train_ab(tmp)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return
    parity = [parity_scene(), parity_scene(250, 190, (1.6, 0, 0))]
    err2 = max(p[0] for p in parity)
    tf32_witness()
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        res = full_scale(tmp)
        tr = training(res)
        mesh = mesh_path(res, tmp)
        ep = entry_points(tmp, tr)
        ev = evaluation(ep)
        probes = bisect_probes(res)
        qual = quality(tmp)
        par12 = parallel_training(tmp, res)
    bench13 = bench_phase()
    adam = adam_alone()
    binned = binning_alone()
    kernels = []
    fwd = res["bwd"]["a"]["fwd"]
    for g, replaces in ((1, "radegs_tpu/ops/pallas_blend.py:263"),
                        (2, "radegs_tpu/ops/pallas_blend_mt.py:73")):
        kernels.append({  # at the 100k view 0: ms per wrapper call, alone_ms per shape
            "name": f"blend_fwd[G={g}]", "route": "cuda",
            "source": "radegs_torch/csrc/blend_fwd.cu", "replaces": replaces,
            "launches": res["launches"][f"blend_fwd[G={g}]"],
            "max_abs_err": max([err2] + [v["fwd"]["err"] for v in res["bwd"].values()]),
            "ms": fwd["wrapper"][g],
            "alone_ms": {k: v["fwd"]["alone"][g] for k, v in res["bwd"].items()},
            "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound"], "bound_by": fwd["bound_by"],
            "bound_full_gate_ms": fwd["bound_full"], "library_ms": None,
        })
    bwd = res["bwd"]
    for g, replaces in ((1, "radegs_tpu/ops/pallas_blend.py:600"),
                        (2, "radegs_tpu/ops/pallas_blend_mt.py:357")):
        kernels.append({  # at the 100k view 0: ms per wrapper call, pair_ms the pair alone
            "name": f"blend_bwd[G={g}]", "route": "cuda",
            "source": "radegs_torch/csrc/blend_bwd.cu", "replaces": replaces,
            "launches": tr["launches"][f"blend_bwd[G={g}]"],
            "max_abs_err": max([p[1] for p in parity] + [v["abs"] for v in bwd.values()]),
            "ms": float(np.median(bwd["a"]["wrapper"][g])), "pair_ms": bwd["a"]["pair"][g],
            "plain_ms": bwd["a"]["plain_ms"],
            "bound_ms": bwd["a"]["bound"], "bound_by": bwd["a"]["bound_by"],
            "library_ms": None,
        })
    alone = mesh["alone"]
    for name, key, replaces, err in (
            ("integrate_image", "img", "radegs_tpu/ops/pallas_integrate.py:258",
             max([p[1] for p in mesh["parity"]] + [alone["img_err"]])),
            ("integrate_points", "pt", "radegs_tpu/ops/pallas_integrate.py:62",
             max([p[2] for p in mesh["parity"]] + [alone["a_err"]]))):
        bound = alone[f"{key}_bound"]
        kernels.append({  # at the dense view 0 (B6 over 1M points): ms per wrapper call
            "name": name, "route": "cuda", "source": f"radegs_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": mesh["launches"][name], "max_abs_err": err,
            "ms": alone[f"{key}_ms"], "plain_ms": alone[f"{key}_plain_ms"],
            "bound_ms": bound[0], "bound_by": bound[1],
            "bound_full_gate_ms": alone[f"{key}_bound_full"][0], "library_ms": None,
        })
    for probe, line in zip(("aligned", "window", "mm_highest", "tri_mm"), (43, 53, 72, 86)):
        row = probes["rows"][probe]
        kernels.append({
            "name": f"bisect_{probe}", "route": "cuda",
            "source": "radegs_torch/csrc/bisect_probes.cu",
            "replaces": f"scripts/_kernel_bisect.py:{line}",
            "launches": probes["launches"][f"bisect_{probe}"], "max_abs_err": row["err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1], "library_ms": row["library_ms"],
            "floor_ms": row["floor_ms"],
        })
    pre_rows = preprocess_rows(res["pre"], res["launches"])
    # the preprocess kernel's launches on the paths of phases 6, 7, 8 and 10
    for k in pre_rows:
        k.update(train_launches=tr["pre_launches"][k["name"]],
                 mesh_launches=mesh["launches"][k["name"]], cli_launches=ep["launches"][k["name"]],
                 eval_launches=ev[k["name"]])
    kernels += pre_rows
    kernels.append(adam_row(adam, {"train": tr["adam_launches"], "parallel": par12["launches"],
                                   "bench": bench13["launches"]}))
    for k in kernels:  # launches on phase 11a's quality path, 12b's ranks, 13's bench
        k["quality_launches"] = qual["launches"].get(k["name"], 0)
        k["parallel_launches"] = par12["launches"].get(k["name"], 0)
        k["bench_launches"] = bench13["launches"].get(k["name"], 0)
    kernels.append(binning_row(binned, {
        "serve": res["launches"], "train": tr["binning_launches"], "mesh": mesh["launches"],
        "cli": ep["launches"], "eval": ev, "quality": qual["launches"],
        "parallel": par12["launches"], "bench": bench13["launches"]}))
    pre_names = [k for k in res["launches"] if k.startswith("preprocess_")]
    log("preprocess kernel launches by path (every SH degree): " + "; ".join(
        f"{path} " + ", ".join(f"{k} {d[k]}" for k in pre_names if d[k])
        for path, d in (("serve", res["launches"]), ("train", tr["pre_launches"]),
                        ("mesh", mesh["launches"]), ("cli", ep["launches"]), ("eval", ev),
                        ("quality", qual["launches"]), ("parallel", par12["launches"]),
                        ("bench", bench13["launches"]))))
    log(f"backward kernel vs plain, max rel err per field over phases 2 and 5: "
        f"{max([p[2] for p in parity] + [v['rel'] for v in bwd.values()]):.3e}; vs the "
        f"reference renderer {res['ref_rel']:.3e}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
