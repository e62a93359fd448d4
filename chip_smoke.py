#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mlic_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards 4    # path 11 across the 4 cards of a host

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the eight CUDA kernels from ``mlic_tpu_torch/csrc`` (one nvcc per
   source, in parallel);
3. reads the repository's trained MLICPP_S from its orbax directory
   ``ckpts/bench_default`` without orbax (``utils.checkpoint.read_orbax``:
   the system zstd library through ctypes) and loads it strictly (the
   ``weights`` line: whether libzstd resolves, seconds, 670 arrays,
   11,794,180 parameters);
4. path 1, the serving path: a codec of MLICPP_S at full width -- the
   trained weights, bf16 transforms, an explicit 512 rANS lanes, stream
   format v4 -- built by ``Codec.update``, then three requests of batches
   of 8 dead-leaves frames of 768x512 through ``Codec.compress`` and
   ``Codec.decompress``, asserting that the decoder's y_hat and x_hat are
   bit-identical to the encoder's, that K1-K4, K6 and K7 were launched on
   that path, and that each request launched what the configuration gives
   (``request_launches``: K7, K3 and K6 once, K4 1 + 2 * slice_num times,
   K8 7 * slice_num - 6 times a direction and twice more in g_a, K1 and K2
   none -- they run only in ``update`` -- and K5 none, its switch off);
   bpp and escape share per request; then one request of the North star's
   batch, 128 distinct frames (``tools.batch_contract.contract_frames``:
   the pool's 16, flipped and rolled), the same way;
5. path 13, batch invariance (the ``batch_128_request``,
   ``batch_contract``, ``k8_cases`` and ``batch_contracts`` lines): the
   batch of 128 timed whole, profiled (device busy ms, idle share, kernel
   launches) with its peak memory and K8's device-side launch count equal
   to the host's; the JAX package's batch contract
   (``tools.batch_contract.check``) on it -- each of the 128 frames
   compressed alone gives the batch's y and z strings byte for byte, every
   hooked entropy-path module (h_s, chctx, ginter, gintra, local, ep, lrp)
   the batch's entries bit for bit, its own entries too on the images at
   0, 18, ..., 108, 127 (and every weighted layer of g_a and h_a its own),
   whose containers decode alone to the batch's y_hat -- and the same for
   MLICPP_L at batch 32 (path 6) and the small
   decoder at batch 8 (path 7); K8 (``ops/invariant_matmul``) against its
   plain version (the PyTorch op an image at a time) at every product
   shape of one compress and decompress of S, L and the small decoder, at
   batches 1, 8 and 128: bit-equal to K8's chain oracle (one thread an
   output, the plain fmaf loop; ``_build.ORACLES``), within 2 gamma_K
   (|A|.|B| + |bias|) elementwise (K8_BF16_TOL more for bf16 operands),
   image i's rows at every batch bit-equal to K8 on image i alone, the
   calls a direction what the configuration gives, and the same at a few
   ragged shapes of every path of the kernel (``k8_edge_cases``); timed
   (ms, queued, the one batched PyTorch call, the per-image loop, the
   bound) at batches 8 and 128 on S, 32 on L and 8 on the small decoder,
   summed a direction into the kernels line's K8 row; the
   ``stream_hashes`` line: sha256 of the streams of path 1's
   first batch, the batch of 128 and path 6's first L batch;
6. times more requests whole and, alternately, by the stages that
   ``Codec.compress``/``decompress`` record (median, min, max of each),
   and profiles one more compress and decompress (device busy time, idle
   share against the median whole time, top ops and the port's kernels by
   device time); then one request of the earlier runs' payload -- seeded
   random weights, noise frames -- with its own profile;
7. path 2, the file-based evaluation path: the trained model under the
   ``bfloat16_mixed`` policy with ``MLIC_FUSED_BLOCKS=1`` and the
   reference's automatic lane count (``Codec(n_lanes="auto")``) through
   ``mlic_tpu_torch.eval.evaluate_codec`` into a temporary directory --
   four dead-leaves frames of 512x768 and one cropped to 500x750 (the
   pad-and-crop path) -- asserting what ``evaluate_codec`` asserts (the
   decoder's x_hat bit-identical to the encoder's, read back from the
   file), finite bpp, PSNR and MS-SSIM beside the escape share and the lane
   count resolved, K5 launched once a fusable tail of g_a and twice one of
   g_s an image (``k5_per_image``, from the configuration by the JAX
   package's rule: 20 for MLICPP_S) and launches of every
   other kernel;
8. g_a and g_s at the serving size with the fused tail off and on, under
   ``float32`` and ``bfloat16_mixed``: difference and median times;
9. holds every kernel against its plain PyTorch version on the card:
   K1-K4, K6 and K7 on a payload with the codec's shapes and 3% escapes
   (exact equality; K3, K6 and K7 also at 16, 1024 and 1 lanes, on a
   ragged geometry and at batch 128, their streams byte-identical to the
   plain back end's; K7 also timed against the composition of K1, K2 and
   PyTorch ops it replaced; K3's chain bound read from its own SASS, its
   reciprocal divide against // over every frequency; the launches and
   host synchronizations of one ``encode_rans_v4``, from the host's
   runtime calls: at most 6 and none, and K7, K3 and K6 run on the card
   by their own device-side launch counts, ``device_proof``),
   K4 also on seeded states and tables in both modes at 16,
   256, 512 and 1024 lanes (clusters of 1, 4, 8 and 8 blocks; timed), K5
   at every shape of the path, at a ragged size and at other widths, in
   f32 and bf16 (within the stated tolerance, and both against a float64
   evaluation: in bf16 the kernel's error may be at most twice the plain
   version's); times kernel, plain version and, for the row select,
   ``table[row]``; K5's shared-memory plan must take every width of the
   configurations (the depthwise tails of every model of CONFIGS), and a
   width that cannot fit a block must raise, in the wrapper and in the C
   entry point;
10. round-trips at 16 and 1024 lanes, and checks the f32 analysis
   transform on the card against the CPU on a small input;
11. path 8, the reference's codec (the ``host_coded`` line): path 1's
   model through ``Codec(backend="steps")`` and ``"fused"`` on path 1's
   first batch -- the host rANS coder (``entropy/rans``, built by g++ into
   ``build/host/``) codes z and y, one stream of each an image, every
   phase crossing to the host -- each round trip bit-exact, steps and
   fused byte-identical, both reconstructing path 1's device-backend
   y_hat and x_hat, no kernel launched but K8 (not in ``update`` either); bpp
   beside the v4 stream's, ms a direction and the host coder's share;
   MLICPP_S_VBR at level 3 and the seeded ``vr_entbttlnck`` +
   ``quant_offset`` model at two levels through steps, bit-exact; one
   frame through ``python -m mlic_tpu_torch.tools.test --backend steps``
   and ``tools.decode``, which reads the backend from the streams
   (subprocesses), the PNG the encoder's x_hat rounded;
12. path 9, the serving pipeline (the ``serve_pipeline`` line):
   ``tools.serve.main`` on the trained MLICPP_S at 512 lanes, 32
   synthetic frames in batches of 8 with ``--verify`` and containers, then
   without; on path 1's codec, ``roundtrip_stream`` (two batches in
   flight) against serial compress + decompress over 4 batches
   (byte-identical streams, bit-identical x_hat), the host
   synchronizations of a steady-state ``compress_begin`` (0, by
   ``torch.cuda.set_sync_debug_mode`` and the profiler), one image of a
   batch written as a container and decoded alone by ``tools.decode`` to
   g_s of the encoder's y_hat; img/s of the pipeline and the serial loop over 3
   alternated rounds, and the card's idle share in a profiled round;
13. path 3, training (the ``train`` line): MLICPP_S at full width warm-
   started from the trained weights under ``bfloat16_mixed``, Adam,
   lambda 0.0483, mse, batches of 8 random 256x256 crops of a dead-leaves
   pool (``pool_batches``): 3 warm-up steps, 20 timed (median, min, max ms,
   peak memory), one profiled (device busy time, idle share); losses at the
   first and last steps, all finite; every main tensor with a nonzero
   gradient moved, the
   quantiles moved, and their gradient of the RD loss alone is exactly
   zero; no kernel launched.  Then a ``CheckpointManager`` save and a
   restore into a fresh trainer, whose next step's loss must equal the
   uninterrupted run's; and one f32 step of MLICPP_S at batch 1, 128x128,
   on the card against the CPU (loss within 1e-4, the gradient's global
   norm within 1e-3, relative);
14. from training to serving: ``Codec.update`` on the fine-tuned weights and
   one 512-lane request of 8 dead-leaves frames, bit-exact with K1-K4, K6
   and K7 launched; its real bpp beside ``Trainer.evaluate``'s likelihood
   estimate on the same frames;
15. path 4, variable-bitrate serving (the ``vbr_serve`` line): MLICPP_S_VBR
   under ``bfloat16`` at 512 lanes on the trained MLICPP_S weights
   (``load_matching``: every trained leaf taken, Gain at gain_init, whose
   top level is 1.0), one batch of 8 frames at each of the 6 levels and at
   ``inputscale`` 0.3, two rounds (the second timed): each request
   bit-exact with K7, K3, K6 and K4 launched, level 5's streams byte-equal
   to path 1's MLICPP_S codec's on the same frames, bpp rising with the
   level, bpp, escape share and encode/decode ms per level; profiles of
   levels 0 and 5 (the port's kernels' device time per request);
   ``evaluate_codec_vbr`` over one frame at levels 0 and 5 through files
   with the VBR header; one ``vr_entbttlnck`` + ``quant_offset`` model on
   seeded weights whose level 0 needs wider factorized-prior rows than its
   top level, coded at both (the width ratchet, QuantABCD on the card);
16. path 5, MGDA training (the ``vbr_train`` line): three steps of
   MLICPP_S_VBR from the trained weights under ``bfloat16_mixed``, batch 8
   of 256x256 crops, all 6 levels a step: ms a step, peak memory, losses
   finite, alpha on the simplex, no kernel launched; one f32 step at 1 x
   128^2 against the CPU at path 3's tolerances; then ``tools.rd_vbr``
   (the ``rd_vbr`` line) on MLICPP_S_VBR from the trained weights, two
   320x320 frames at every level and one interpolated gain through files,
   each decoded bit-exactly, the rate monotone in the gain;
17. path 6, the flagship MLICPP_L (the ``l_path`` line): its trained
   weights read from ``ckpts/bench_default_MLICPP_L`` (the ``weights_L``
   line: 1,215 arrays, stored in bfloat16, widened to f32), loaded strictly,
   under ``bfloat16`` at 512 lanes: ``Codec.update`` and path 1's three
   batches of 8, then one batch of 32 (the JAX package's L record's), each
   bit-exact with the launches its configuration gives (K4 21 times a
   decompress), bpp, escape share and peak memory; whole and staged times,
   a profile, g_s's device time at batch 8; K1-K4, K6 and K7 against
   their plain versions, exact, on a payload of L's shapes (20 y phases, a
   z of 192 channels, about 996 encode steps; K3, K6 and K7 also on item
   8's other geometries, K4 on all 21 phases; the kernels line's
   ``at_MLICPP_L``); ``evaluate_codec`` over two
   frames under ``bfloat16_mixed`` with the fused tails (K5's launches an
   image from the model) and a profile of one ``decompress_one_image``;
   then path 3 at L's width (the ``train_L`` line): 3 + 5 steps of 8 x
   256^2 from the trained weights under ``bfloat16_mixed`` (ms a step,
   peak memory, losses finite, no kernel), a resume whose next loss is
   exact, one f32 step at 1 x 128^2 against the CPU;
18. path 7, the small-decoder family at full width on seeded weights (the
   ``sd_path`` line): MLICPP_M_SMALL_DEC, two batches of 8 bit-exact, g_s's
   device time beside L's; MLICPP_M_SMALL_DEC_VBR at its 5 levels and at
   ``inputscale`` 0.3, bit-exact, bpp of the top level above level 0's;
   its ``vr_entbttlnck`` + ``quant_offset`` request, whose lowest gain
   (0.002424) widens the rows; the decoder-only deployment of both:
   ``tools.extract_decoder`` and ``python -m mlic_tpu_torch.tools.decode``
   in a subprocess with the fused tails, whose PNG must hold the encoder
   side's reconstruction, and a profiled in-process decode whose K5
   launches cover the (320, 320) and (48, 48) tails; then the
   frozen-encoder training of MLICPP_M_SMALL_DEC (the
   ``train_small_decoder_frozen`` line): ``tools.train --freeze`` on g_a
   and h_a for 3 steps, every frozen leaf bit-equal to the start and every
   other leaf with a gradient moved;
19. path 10, the codec's other paths (the ``codec_paths`` line), on path
   1's settings and frames (path 1's ``update`` must take no fallback):
   format v3 (``MLIC_UNIFIED_Z=0``: z coded on the host) over 3 batches,
   bit-exact with K7, K3 and K6 once and K4 2 * slice_num times a
   request, its y streams the port's ``encode_global`` of the phase
   symbols, bpp beside v4's, the host z coder's share, an image of a batch
   decoded alone by ``tools.decode``; fallback A (the encode-shaped check
   forced to fail in this process) writing path 1's bytes through K7's
   gather mode; fallback B (validation forced to fail) bit-exact at v4 and
   v3 over 3 batches, and K7's gather mode and K4's row mode on all y
   phases at width 3,136 against their plain versions, exact, timed (the
   kernels line's ``y_gather`` and ``y_rows`` rows, the latter with its
   chain bound); ``tools.test`` and ``tools.decode`` under
   ``MLIC_UNIFIED_Z=0`` (subprocesses, PNG exact) and
   ``tools.ab_stream_format`` at batch 8, 2 segments a regime;
20. path 11, scale-out (the ``train_recipe``, ``data_parallel_world_1``,
   ``sharded``, ``poelic``, ``statistics`` and ``scale_out`` lines):
   ``tools.train`` in a subprocess on a folder of dead-leaves PNGs from the
   trained MLICPP_S with the reference's recipe -- ``--augment
   autoaugment``, ``--patch-milestones 2:128``, validation every 2 steps on
   a ``--test-dataset`` of two 768x512 frames with ``--save-recon`` -- for 4
   steps of 8 x 256^2 (the patch size must switch at step 2, the losses and
   validation be finite, the reconstructions written at the frames' size),
   and again without AutoAugment (ms a step of both); ``tools.train``
   plainly and under RANK=0 WORLD_SIZE=1 over NCCL, 3 steps, every step's
   metrics and the final weights bit-equal; ``parallel.serving.
   ShardedCodec`` of path 1's model on ["cuda:0"] and ["cuda:0",
   "cuda:0"], path 1's 3 batches of 8 at 512 lanes, each bit-exact, each
   shard's streams and y_hat path 1's codec's for the shard's images, the
   launches of a batch the configuration's times the shards, K1 and K2 in
   each replica's ``update``, the streams that differ from the batch-8
   bytes counted, ms a direction; ``tools.serve --sharded --verify``;
   3 POELIC steps (``poelic_train_step``, a seeded VGG16) of MLICPP_S at 8
   x 256^2 (ms, peak memory, finite losses) and an f32 step against the
   CPU at path 3's tolerances; ``tools.statistics`` on 4 frames, its bpp
   within 1e-6 of ``Trainer.evaluate``'s;
21. path 12, the last modules (the ``last_modules`` line): ``tools.macs``
   for MLICPP_S, MLICPP_M_SMALL_DEC and MLICPP_L (dense and depthwise) at
   1920x1088 (GMACs, parameters -- L's 83.50 M and 41.72 M exact -- and the
   forward's ms beside PARITY.md's XLA counts); ``tools.profile_codec`` at
   batch 8, 512 lanes, bfloat16 on the trained weights (its stage sums
   beside path 1's whole request, ``parametric`` true);
   ``tools.microbench``'s ctx, encode, decode and fusedblk sets and
   ``tools.profile_modules``; ``tools.jpeg_anchor`` on rd_vbr's frames and
   ``tools.bdrate`` of rd_vbr's curve against it (finite);
   ``tools.rd_curve`` on ``ckpts/bench_default`` against
   ``evaluate_codec`` of the same frames; LPIPS and DISTS on seeded
   weights (0 on identical frames, more against x_hat, the card within
   1e-4 of the CPU); ``analysis.freq`` on the card within 1e-6 of the CPU;
   format v2 on path 1's payload (the device bytes the host coder's, K4's
   lane layout decoding every y phase exactly in both modes, against its
   plain version, timed: the kernels line's ``lanes`` and ``lanes_rows``
   rows).  Every kernel's device-side launch count over the path must
   equal the host's;
22. path 14, the published MLIC++ architecture (the ``published_path``
   line; run after path 7's frozen-encoder training): dense MLICPP_S in
   bf16 on seeded weights, one request of a batch of 8, bit-exact with the
   launches its configuration gives (g_a's last stage and h_a's 3x3
   convolutions at N 96 and g_a.out at N 160 through K8's bf16 halo path;
   cuDNN ordered the last stage's sums by the batch), the batch contract
   at 8 and K8 at its product shapes at batches 1 and 8; then dense
   MLICPP_L (N 192, M 320, 10 slices) on seeded weights written as the
   reference writes a checkpoint (``module.`` prefixes, compressai's CDF buffers),
   converted by ``python -m
   mlic_tpu_torch.tools.convert_reference_checkpoint --dense --strict`` in
   a subprocess and loaded strictly, bit-equal to the weights written;
   ``Codec.update`` at 512 lanes and two requests of batches of 8, each
   bit-exact with its configuration's launches (K8 2 x 64 + 11), a request
   whose device-side launch counts equal the host's, a profile (device
   busy ms, idle share), the batch contract at 8 and K8 at every product
   shape at batches 1 and 8 against its chain oracle (timed at 8; the
   ``k8_cases`` lines of ``MLICPP_S_dense`` and ``MLICPP_L_dense``);
23. prints one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
   line last.

With ``--cards N`` on a host of N cards it runs path 11's scale-out
across them instead (``multi_card``): ``tools.train`` over N processes and
NCCL against one process on the global batch (f32, SGD, 2 steps: losses
within rtol 1e-4, weights within rtol 2e-4, atol 2e-6), ``ShardedCodec``
with a replica on each card over path 1's batches (each shard's streams
the single codec's) and ``tools.serve --sharded``, ``tools.statistics``
over N processes against one; then the ``{"ok": true, ...}`` line.

Exits non-zero, before printing any result, without CUDA or without the
repository beside it; any failed phase raises, and no kernel failure is
caught to carry on without the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
MODEL = "MLICPP_S"
BATCH, HEIGHT, WIDTH = 8, 512, 768
BIG_BATCH = 128                 # the North star's batch: K3, K6, K7 exact
N_LANES = 512
MAX_ENCODE_LAUNCHES = 6         # encode_rans_v4: K7, K3, K6 and no more
ENCODE_KERNELS = ("rans_encode_prep", "rans_encode_scan",
                  "rans_encode_compact")
N_REQUESTS = 3
STAGE_REQUESTS = 7
ESC_SHARE = 0.03
EVAL_FRAMES = 4                 # full 512x768 frames on path 2, plus a crop
EVAL_CROP = (500, 750)
FUSED_SWITCH = "MLIC_FUSED_BLOCKS"
# K5 against its plain version: |k - p| <= tol * (1 + |p|), the tolerances
# of the same comparison on the JAX side.  f32: the two sum the same
# products in different orders.  bf16: they round at the same points, so a
# different sum order moves a result by one bf16 step (2^-8 relative) where
# a sum lies near a rounding boundary, and a few such steps compound.
K5_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32
# operations/s outside the tensor cores, bf16 operations/s in them.
HBM_BPS = 3.35e12
F32_OPS = 67e12
BF16_OPS = 989e12
# Operations per CDF evaluation: a dozen float ops around erfcf, which the
# CUDA math library computes in about 25 more.
CDF_OPS = 36
# Cycles a dependent integer instruction waits for its operand: the
# shortest latency of the integer pipes, taken low so that K3's chain bound
# stays a bound (the script does not measure it).
DEP_CYCLES = 4
# Cycles of a load that hits in L2, taken at the low end of what
# microbenchmarks of Hopper report (about 200-270), so that K4's row-mode
# chain bound stays a bound (the script does not measure it).
L2_HIT_CYCLES = 200
# Host calls that wait for the card: encode_rans_v4 must make none.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
# Host calls that launch a kernel, cuda* and cu* (matched as prefixes:
# some tracers add a version suffix to the name).
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel", "cuLaunchCooperativeKernel")
# K4 against its plain version on seeded inputs: (lanes, images, steps).
K4_LANE_CASES = ((16, 3, 20), (256, 4, 12), (512, 2, 12), (1024, 2, 12))
# The repository's trained MLICPP_S (tools/make_bench_ckpt.py, lambda
# 0.0483), an orbax directory read without orbax.
REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(REPO, "ckpts", "bench_default")
CKPT_ARRAYS, CKPT_PARAMS = 670, 11_794_180
# Path 3, training: the JAX CLI's batch and crop (tools/train.py:40-41),
# its dead-leaves pool image size, lambda and optimizer.
TRAIN_BATCH, TRAIN_PATCH, TRAIN_POOL, TRAIN_POOL_SIZE = 8, 256, 16, 320
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
LMBDA = 0.0483
# One f32 training step on the card against the CPU (batch 1, 128x128):
# relative tolerances of the loss and of the gradient's global norm.
CPU_STEP_SHAPE = (1, 128, 128, 3)
CPU_LOSS_RTOL, CPU_GRAD_NORM_RTOL = 1e-4, 1e-3
# Paths 4 and 5: the variable-bitrate model at MLICPP_S's width, on the
# trained MLICPP_S weights (its Gain at gain_init, whose top level is 1.0);
# one request above the levels' range at a continuous gain; MGDA steps.
VBR_MODEL = "MLICPP_S_VBR"
VBR_INPUTSCALE = 0.3
VBR_TOP = 5                     # gain 1.0: MLICPP_S's arithmetic
VBR_TRAIN_STEPS = 3
# Path 6: the JAX package's flagship MLICPP_L (N=192, M=320, 10 slices) on
# its trained weights (bench.py:193-207), stored in bfloat16; one request at
# the batch of the JAX package's L record; the file-based evaluation of two
# frames with the fused tails.
L_MODEL = "MLICPP_L"
L_CHECKPOINT = os.path.join(os.path.dirname(CHECKPOINT),
                            "bench_default_MLICPP_L")
L_CKPT_ARRAYS = 1215
L_BIG_BATCH = 32                # path 1's 16 frames and their mirror images
L_EVAL_FRAMES = 2
# Path 7: the small-decoder family at full width (N=192, M=320, 10 slices,
# a 48-wide g_s) on seeded weights, no trained checkpoint existing: two
# batches of the fixed-rate model, the VBR twin at every level, and the
# decoder-only deployment through the two CLIs.
SD_MODEL = "MLICPP_M_SMALL_DEC"
SD_VBR_MODEL = "MLICPP_M_SMALL_DEC_VBR"
SD_BATCHES = 2
SD_FILE_LEVEL = 2               # the VBR file of the decoder-only deployment
# Path 8: the reference's host-coded backends on path 1's model and batch;
# the VBR level coded through them (gain 0.4 of MLICPP_S_VBR's six).
VBR_HOST_LEVEL = 3
# Path 9: the serving CLI's frames (with and without --verify), and the
# rounds of the pipelined and the serial loop, alternated.
SERVE_FRAMES, SERVE_ROUNDS = 32, 3
# rd_vbr on path 4's model: frames and their size (tools/rd_vbr.py's
# dead-leaves hold-out set, cut from 6 frames).
RD_VBR_FRAMES, RD_VBR_SIZE = 2, 320
# Path 3 at the ten-slice width: MLICPP_L's steps; the small decoder's
# frozen-encoder training through the CLI (g_a and h_a, the reference's
# mlicpp_small_decoder.py:508-517).
L_TRAIN_WARMUP, L_TRAIN_STEPS = 3, 5
SD_FREEZE = r"^\['(g_a|h_a)'\]"
SD_TRAIN_STEPS = 3
# Path 11, scale-out: the training CLI with the reference's recipe
# (AutoAugment, a patch milestone, validation with reconstructions) and
# under a process group of one over NCCL; the sharded codec at one and two
# shards of the card; POELIC steps; tools.statistics.
SCALE_TRAIN_STEPS, SCALE_PATCH_SWITCH = 4, (2, 128)
SCALE_DP_STEPS = 3
SHARD_DEVICES = (("cuda:0",), ("cuda:0", "cuda:0"))
POELIC_STEPS = 3
STATS_FRAMES = 4
# ``--cards N``: the data-parallel steps against one process
MULTI_TRAIN_STEPS = 2
# the kernels a coded request launches (K1 and K2 run in update only)
# the keys of a kernel's row at L's shapes that the kernels line carries
AT_L_KEYS = ("launches", "status", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms", "kernel_ms", "queued_ms",
             "shape", "words", "escapes", "phases_checked")
REQUEST_KERNELS = ("rans_encode_prep", "rans_encode_scan",
                   "rans_encode_compact", "rans_decode_phase",
                   "invariant_matmul")
KERNEL_SYMBOLS = {"select_rows": "select_rows_kernel",
                  "eval_cdf": "eval_cdf_kernel",
                  "rans_encode_prep": "rans_encode_prep_kernel",
                  "rans_encode_scan": "rans_encode_kernel",
                  "rans_encode_compact": "rans_compact_kernel",
                  "rans_decode_phase": "rans_decode_kernel",
                  "fused_block_tail": "fused_block_tail_",
                  # K8's three: _kernel, _kernel_halo, _kernel_bytes
                  "invariant_matmul": "invariant_matmul_kernel"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls by CUDA events, the
    calls enqueued while the stream is held busy (``torch.cuda._sleep``,
    about 0.5 ms a call): where a wrapper's host time exceeds its kernel's,
    ``cuda_ms`` measures the host and this measures the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 1e6))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, symbol: str, reps: int = 5) -> float | None:
    """Device time of the CUDA kernel named ``symbol`` per call of ``fn``,
    from ``torch.profiler`` (launch overhead on the host excluded); None
    when the trace holds none of its launches (late in a long process the
    profiler has dropped every device record)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if symbol in e.key]
    if not sum(e.count for e in rows):
        return None
    return sum(e.self_device_time_total for e in rows) / 1e3 / reps


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        d = (a.double() - b.double()).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def bound(nbytes: float, ops: float, peak_ops: float = F32_OPS):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stream_stats(codec, enc) -> dict:
    """bpp of a compressed batch's streams and the share of its symbols
    (y and z) coded as escapes (each stream's header holds its count)."""
    streams = enc["strings"][0]
    n_bytes = sum(len(s) for s in streams)
    n_esc = sum(int(np.frombuffer(s[8:12], np.uint32)[0]) for s in streams)
    zh, zw = enc["shape"]
    b, h, w = enc["y_hat"].shape[:3]
    n_sym = enc["y_hat"].numel() + b * zh * zw * codec.model.cfg.N
    return {"bpp": 8.0 * n_bytes / (b * h * w * 256), "escape_share":
            n_esc / n_sym, "escapes": n_esc, "symbols": n_sym}


def streams_sha256(enc) -> str:
    """sha256 of a compressed batch's streams (each group's count, each
    stream's length and bytes, in order)."""
    h = hashlib.sha256()
    for group in enc["strings"]:
        h.update(len(group).to_bytes(8, "little"))
        for s in group:
            h.update(len(s).to_bytes(8, "little"))
            h.update(s)
    return h.hexdigest()


def serve(codec, frames, label: str | None = None, cfg=None):
    """The main path: compress -> decompress per request, bit-exact y_hat
    and x_hat, x_hat finite with the frames' shape; one row a request
    (with ``label`` as its "path").  With ``cfg``, each request's kernel
    launches must be what ``request_launches(cfg)`` derives."""
    import torch

    from mlic_tpu_torch.ops import _build
    rows = []
    for r, x in enumerate(frames):
        before = _build.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = codec.compress(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec = codec.decompress(enc["strings"], enc["shape"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after = _build.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        if not torch.equal(enc["y_hat"], dec["y_hat"]):
            n = int((enc["y_hat"] != dec["y_hat"]).sum())
            raise AssertionError(f"request {r}: y_hat differs at {n} entries")
        x_hat = dec["x_hat"]
        if not torch.equal(enc["x_hat"], x_hat):
            raise AssertionError(f"request {r}: decoder x_hat differs from "
                                 "the encoder's")
        if tuple(x_hat.shape) != tuple(x.shape) \
                or not bool(torch.isfinite(x_hat).all()):
            raise AssertionError(f"request {r}: bad x_hat {tuple(x_hat.shape)}")
        rows.append({**({"path": label} if label else {}), "request": r,
                     "batch": list(x.shape), **stream_stats(codec, enc),
                     "streams_sha256": streams_sha256(enc),
                     "encode_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3,
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "launches": launches})
        print(json.dumps(rows[-1]), flush=True)
        if cfg is not None:
            check_request_launches(launches, cfg, f"{label or 'serve'} "
                                   f"request {r}")
        if r == 0:
            x_ref = codec.model.synthesize(enc["y_hat"])
            if not torch.equal(x_ref, x_hat):
                raise AssertionError("x_hat != g_s(encoder y_hat)")
    return rows


def stage_times(codec, frames, label: str = "stage_split") -> dict:
    """Where a request's time goes: STAGE_REQUESTS requests timed whole
    (no synchronize inside), each followed by one whose ``compress`` and
    ``decompress`` record their own stages (a synchronize after each).
    Prints median, min and max of both; returns the whole medians."""
    import torch
    whole = {"compress": [], "decompress": []}
    stages = {}
    for r in range(STAGE_REQUESTS):
        x = frames[r % len(frames)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = codec.compress(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        codec.decompress(enc["strings"], enc["shape"])
        torch.cuda.synchronize()
        whole["compress"].append((t1 - t0) * 1e3)
        whole["decompress"].append((time.perf_counter() - t1) * 1e3)
        marks = {"compress": {}, "decompress": {}}
        enc = codec.compress(x, timings=marks["compress"])
        dec = codec.decompress(enc["strings"], enc["shape"],
                               timings=marks["decompress"])
        if not torch.equal(enc["y_hat"], dec["y_hat"]):
            raise AssertionError(f"staged request {r}: y_hat differs")
        for phase, t in marks.items():
            for name, ms in t.items():
                stages.setdefault(f"{phase}.{name}", []).append(ms)

    def stats(v):
        return {"median": float(np.median(v)), "min": min(v), "max": max(v)}
    print(json.dumps({label: {
        "requests": STAGE_REQUESTS,
        "whole_ms": {k: stats(v) for k, v in whole.items()},
        "stages_ms": {k: stats(v) for k, v in stages.items()}}}), flush=True)
    return {k: float(np.median(v)) for k, v in whole.items()}


def device_rows(prof) -> tuple:
    """The device work a profile recorded: ([(ms, count, name)] by name,
    largest first; ms of user annotations).  An annotation (a
    ``record_function`` range such as the optimizer's ``Optimizer.step``)
    spans ops on the device, so it is kept apart, not added to their
    busy time."""
    from torch.autograd import DeviceType
    acc, spans = {}, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if getattr(e, "is_user_annotation", False) \
                or e.name.startswith("Optimizer."):
            spans += ms
            continue
        row = acc.setdefault(e.name, [0.0, 0])
        row[0] += ms
        row[1] += 1
    return sorted(((ms, n, k) for k, (ms, n) in acc.items()),
                  reverse=True), spans


def profile_request(codec, x, wall_ms: dict, top: int = 8,
                    label: str = "profile", level: dict | None = None):
    """Device busy time of one compress and one decompress under
    ``torch.profiler`` (``kernels_in``), the idle share against the median
    unprofiled wall time of the same phase, and the top kernels by device
    time; ``level`` ({"s", "inputscale"}) codes a VBR model's request at
    that level.  Returns the printed dict."""
    level = level or {}
    out, enc = {}, {}
    for phase in ("compress", "decompress"):
        if phase == "compress":
            prof = kernels_in(lambda: enc.update(codec.compress(x, **level)),
                              top)
        else:
            prof = kernels_in(lambda: codec.decompress(
                enc["strings"], enc["shape"], **level), top)
        wall = wall_ms[phase]
        out[phase] = {"device_busy_ms": prof["device_busy_ms"],
                      "unprofiled_wall_ms": wall,
                      "idle_share": 1.0 - prof["device_busy_ms"] / wall,
                      **{k: v for k, v in prof.items()
                         if k != "device_busy_ms"}}
    print(json.dumps({label: out}), flush=True)
    return out


def request_launches(cfg) -> dict:
    """What one compress and one decompress launch of each kernel, from
    the configuration: the rANS encode's K7, K3 and K6 once, K4 once for z
    and twice a slice; K1 and K2 none (``Codec.update`` only), K5 none
    (its switch off); K8 as ``k8_per_direction`` gives in each direction
    and ``k8_in_analysis`` in the compress."""
    return {"select_rows": 0, "eval_cdf": 0, "rans_encode_prep": 1,
            "rans_encode_scan": 1, "rans_encode_compact": 1,
            "rans_decode_phase": 1 + 2 * cfg.slice_num,
            "fused_block_tail": 0,
            "invariant_matmul": 2 * k8_per_direction(cfg)
            + k8_in_analysis(cfg)}


def check_request_launches(got: dict, cfg, where: str) -> None:
    want = request_launches(cfg)
    if got != want:
        raise AssertionError(f"{where}: launches {got} a request, the "
                             f"configuration gives {want}")


def fused_tails(cfg, transform_dtype: str, part: str) -> list:
    """The (C, N) widths of the residual-block tails of ``part`` ("g_a" or
    "g_s") that K5 computes with the switch on, one entry a tail, from the
    configuration's fields by the JAX package's rule
    (``mlic_tpu/models/layers.py:197``, ``_fused_tail``) and its wiring
    (``mlic_tpu/models/mlicpp.py:77-94``, ``transforms.py:23-135``): only
    depthwise blocks fuse -- g_a is dense under ``small_decoder`` -- a GELU
    tail always, a GDN or IGDN tail only where GDN's dtype is the block's
    compute dtype (``float32``, ``bfloat16_mixed``; not ``bfloat16``).  g_a:
    three GELU and three GDN tails, N wide; g_s: rb0 at its head's width
    (M, or the synthesis width under ``old_synthesis``), then three GELU
    and three IGDN tails at the synthesis width (N, or N // 4 under
    ``small_decoder``)."""
    gdn = 3 if transform_dtype != "bfloat16" else 0
    if part == "g_a":
        if not cfg.depthwise or cfg.small_decoder:
            return []
        return [(cfg.N, cfg.N)] * (3 + gdn)
    if not cfg.depthwise:
        return []
    n = cfg.N // 4 if cfg.small_decoder else cfg.N
    head = n if cfg.old_synthesis else cfg.M
    return [(head, head)] + [(n, n)] * (3 + gdn)


def k5_per_image(cfg, transform_dtype: str) -> int:
    """K5's launches a coded image with the switch on: g_a once (compress),
    g_s twice (the encoder's reconstruction and the decoder's)."""
    return (len(fused_tails(cfg, transform_dtype, "g_a"))
            + 2 * len(fused_tails(cfg, transform_dtype, "g_s")))


def kernels_in(fn, top: int = 8) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (kernels, copies and
    sets on the card): the device's busy ms and launches, {kernel: [device
    ms, launches]} of the port's kernels, and the ``top`` ops by device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows, _ = device_rows(prof)
    return {"device_busy_ms": sum(r[0] for r in rows),
            "kernel_launches": sum(r[1] for r in rows),
            "port_kernels_ms_launches": {
                name: [sum(r[0] for r in rows if sym in r[2]),
                       sum(r[1] for r in rows if sym in r[2])]
                for name, sym in KERNEL_SYMBOLS.items()},
            "top": [[k[:70], ms, n] for ms, n, k in rows[:top]]}


def make_payload(codec, rng, batch: int = BATCH):
    """Symbols and scale indexes with the codec's shapes (2 * slice_num y
    phases of (H/16) x (W/32) x slice_ch per image, z of (H/64) x (W/64) x
    N: 10 phases of 32x24x32 and a z of 8x12x96 at MLICPP_S, 20 phases and
    8x12x192 at MLICPP_L) and ESC_SHARE escapes."""
    from mlic_tpu_torch.entropy.cdf import get_scale_table
    cfg = codec.model.cfg
    mv = codec.tables["max_value"].cpu().numpy().astype(np.int64)
    off = codec.tables["offsets"].cpu().numpy().astype(np.int64)
    n_phases = 2 * cfg.slice_num
    n_per = (HEIGHT // 16) * (WIDTH // 32) * cfg.slice_ch
    idx = rng.integers(0, 64, (batch, n_phases * n_per))
    sym = np.rint(rng.standard_normal(idx.shape) * get_scale_table()[idx])
    sym = np.clip(sym, off[idx], off[idx] + mv[idx] - 1)
    esc = rng.random(idx.shape) < ESC_SHARE
    big = mv[idx] // 2 + 1 + rng.integers(0, 1000, idx.shape)
    sym = np.where(esc, rng.choice([-1, 1], idx.shape) * big, sym)
    n_z = (HEIGHT // 64) * (WIDTH // 64) * cfg.N
    zr = codec.z_rows_base + np.arange(n_z) % cfg.N
    z = off[zr] + rng.integers(0, mv[zr], (batch, n_z))
    zesc = rng.random(z.shape) < ESC_SHARE
    z = np.where(zesc, off[zr] - 1 - rng.integers(0, 100, z.shape), z)
    return sym.astype(np.int32), idx.astype(np.int32), z.astype(np.int32)


def back_end_case(secs, z, sym, lanes: int, n_phases: int, label: str):
    """K3 and K6 against their plain versions on the card, on the prep's
    sections ``secs`` of z and y and their symbols: exact equality of x,
    masks, words, buf[:sum(img_n)], img_n, ebuf[:sum(ecount)] and ecount.
    Returns (row, K3's outputs, K6's dict, the plain side's position-order
    inputs and scan outputs)."""
    import torch

    from mlic_tpu_torch.entropy import device_rans as dr
    (st_z, fm_z, esc_z), (st_y, fm_y, esc_y) = secs
    got = dr.rans_encode_scan(st_z, fm_z, st_y, fm_y, lanes, n_phases)
    comp = dr.rans_encode_compact(*got, esc_z, z, esc_y, sym, lanes,
                                  n_phases)
    torch.cuda.synchronize()

    def layout(a, b, pad):
        return dr.encode_layout_plain(a, b, lanes, n_phases, pad)

    start16 = dr.u16_bits(layout(st_z, st_y, dr._PAD_START))
    freqm1 = dr.u16_bits(layout(fm_z, fm_y, dr._PAD_FREQM1))
    esc_pos, sym_pos = layout(esc_z, esc_y, False), layout(z, sym, 0)
    ref = dr.rans_encode_scan_plain(start16, freqm1, lanes)
    want = dr.compact_streams_global(*ref, esc_pos, sym_pos, z.shape[0])
    n, ne = int(want["img_n"].sum()), int(want["ecount"].sum())
    pairs = {"x": (got[0], ref[0]), "words": (got[1], ref[1]),
             "masks": (got[2], ref[2]),
             "buf": (comp["buf"][:n], want["buf"][:n]),
             "img_n": (comp["img_n"], want["img_n"]),
             "ebuf": (comp["ebuf"][:ne], want["ebuf"]),
             "ecount": (comp["ecount"], want["ecount"])}
    differ = [k for k, (g, r) in pairs.items()
              if g.shape != r.shape or not torch.equal(g, r)]
    row = {"case": label, "lanes": lanes, "images": z.shape[0],
           "steps": start16.shape[0], "n_z": z.shape[1],
           "n_per": sym.shape[1] // n_phases, "words": n, "escapes": ne,
           "exact": not differ,
           "max_abs_err_scan": max_abs_err(pairs[k] for k in
                                           ("x", "words", "masks")),
           "max_abs_err_compact": max_abs_err(
               pairs[k] for k in ("buf", "img_n", "ebuf", "ecount")
               if pairs[k][0].shape == pairs[k][1].shape)}
    if differ or ne == 0:
        print(json.dumps({"encode_back_end_cases": [row]}), flush=True)
        raise AssertionError(f"K3/K6 ({label}, {lanes} lanes) differ from "
                             f"their plain versions in {differ}, or no "
                             f"escape was coded")
    return row, got, comp, (start16, freqm1, esc_pos, sym_pos, ref)


def prep_case(codec, sym, idx, z):
    """K7 on the card against its plain version: the sections and the max
    abs error over all six outputs (raises unless 0)."""
    from mlic_tpu_torch.entropy import device_rans as dr
    args = (sym, idx, z, codec.tables, codec.z_rows_base, codec.model.cfg.N)
    got, ref = dr.rans_encode_prep(*args), dr.encode_prep_plain(*args)
    err = max_abs_err((g, r) for gs, rs in zip(got, ref)
                      for g, r in zip(gs, rs))
    if err != 0.0 or any(g.shape != r.shape for gs, rs in zip(got, ref)
                         for g, r in zip(gs, rs)):
        raise AssertionError(f"K7 differs from its plain version at "
                             f"{tuple(sym.shape)} (max abs err {err})")
    return got, err


def check_back_end_cases(codec, sym, idx, z):
    """K3, K6 and K7 exact against their plain versions beyond the serving
    payload: 16 lanes (two images a warp), 1024 lanes, one lane a image
    (five images a warp), and a ragged geometry at 512 lanes with pads in
    both sections."""
    cfg = codec.model.cfg
    n_phases = 2 * cfg.slice_num
    n_per = sym.shape[1] // n_phases
    rows = []
    for lanes, b, cut_per, cut_z, label in (
            (16, BATCH, 1000, 1000, "partial warp"),
            (1024, BATCH, n_per, z.shape[1], "widest"),
            (1, 5, 300, 100, "one lane"),
            (N_LANES, 3, 1234, 1000, "ragged")):
        s = sym[:b].reshape(b, n_phases, n_per)[:, :, :cut_per] \
            .reshape(b, -1).contiguous()
        i = idx[:b].reshape(b, n_phases, n_per)[:, :, :cut_per] \
            .reshape(b, -1).contiguous()
        zz = z[:b, :cut_z].contiguous()
        secs, prep_err = prep_case(codec, s, i, zz)
        rows.append(back_end_case(secs, zz, s, lanes, n_phases, label)[0])
        rows[-1]["max_abs_err_prep"] = prep_err
    return rows


def check_big_batch(codec, n_phases: int) -> dict:
    """K7, K3 and K6 exact against their plain versions at the North
    star's batch (BIG_BATCH frames of 768x512, 512 lanes: 498 steps x
    65,536 lanes), and their times there."""
    import torch

    from mlic_tpu_torch.entropy import device_rans as dr
    sym, idx, z = (torch.from_numpy(a).cuda() for a in make_payload(
        codec, np.random.default_rng(SEED + 6), BIG_BATCH))
    secs, prep_err = prep_case(codec, sym, idx, z)
    row, got, _, _ = back_end_case(secs, z, sym, N_LANES, n_phases,
                                   "north star batch")
    (_, _, esc_z), (_, _, esc_y) = secs
    prep_args = (sym, idx, z, codec.tables, codec.z_rows_base,
                 codec.model.cfg.N)
    compact_args = (*got, esc_z, z, esc_y, sym, N_LANES, n_phases)
    row.update({"max_abs_err_prep": prep_err,
                "prep_queued_ms": queued_ms(
                    lambda: dr.rans_encode_prep(*prep_args)),
                "compact_queued_ms": queued_ms(
                    lambda: dr.rans_encode_compact(*compact_args))})
    print(json.dumps({"encode_back_end_big_batch": row}), flush=True)
    return row


def _sass_regs(operand: str) -> list:
    """The registers and predicates a SASS operand names."""
    import re
    return re.findall(r"\b(U?R\d+|U?P\d+)\b", operand)


def sass_step_chains(code: list) -> list:
    """The dependent instructions of K3's steps, from its SASS instructions
    ``code``: for each two consecutive emit compares on one state register
    x (``ISETP.GE.U32.AND P, PT, Rx, Rlimit, PT``), the longest path of the
    register data flow from the first compare to the second's x, as the
    opcodes on it.  A predicated write depends on its old value and its
    predicate; ``.WIDE`` writes a register pair; a carry-out predicate is a
    destination."""
    import re
    emit = re.compile(r"ISETP\.GE\.U32\.AND P\d+, PT, (R\d+)(?:\.reuse)?, "
                      r"R\d+(?:\.reuse)?, PT$")
    marks = [(i, m.group(1)) for i, t in enumerate(code)
             if (m := emit.match(t))]
    chains = []
    for (i, x), (j, x2) in zip(marks, marks[1:]):
        if x != x2:
            continue
        path = {x: []}
        for t in code[i:j]:
            guard = re.match(r"@!?(U?P\d+)\s+", t)
            op, _, rest = (t[guard.end():] if guard else t).partition(" ")
            ops = [o.strip() for o in rest.split(",")] if rest else []
            if not ops or not re.match(r"U?[RP]\d+$", ops[0].split(".")[0]):
                continue                    # no register written
            dests, srcs = [ops[0].split(".")[0]], ops[1:]
            if op.startswith("ISETP"):
                srcs = ops[2:]
            elif len(ops) > 1 and re.match(r"P\d+$", ops[1]) and \
                    not op.startswith(("SEL", "IMAD.X", "IADD3.X")):
                dests, srcs = dests + [ops[1]], ops[2:]
            if ".WIDE" in op:
                dests.append(f"R{int(dests[0][1:]) + 1}")
            names = [r for o in srcs for r in _sass_regs(o)]
            if guard:
                names += [guard.group(1)] + dests
            live = [path[r] for r in names if r in path]
            for d in dests:
                if live:
                    path[d] = max(live, key=len) + [op]
                else:
                    path.pop(d, None)
        chains.append(path.get(x2, []))
    return chains


def clocks_under_load(fn, reps: int = 200) -> dict:
    """The SM clock (MHz) and board power (W) that ``nvidia-smi`` reads
    while ``reps`` calls of ``fn`` queued back to back run on the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(reps):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split(",")
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    return {"sm_clock_mhz": float(out[0]), "power_w": float(out[1]),
            "still_busy": busy}


def sm_clock_max_mhz() -> float:
    """The card's highest SM clock in MHz (``nvidia-smi``)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True)
        .stdout.split()[0])


def k3_chain_bound(S: int) -> dict:
    """K3's bound by its chain, read from its own SASS (``cuobjdump -sass``
    of the built library, written to build/kernels/rans_encode.sass): the
    dependent instructions of one step of the consumer warp, from one emit
    compare to the next, times S steps at DEP_CYCLES cycles each (the
    dependent-issue latency of the integer pipes, a lower bound) at the
    card's highest SM clock (``nvidia-smi``)."""
    import re
    from collections import Counter
    from pathlib import Path

    from mlic_tpu_torch.ops import _build
    lib = _build.KERNELS["rans_encode_scan"].library_path()
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    (lib.parent / "rans_encode.sass").write_text(text)
    block = text[text.index(KERNEL_SYMBOLS["rans_encode_scan"]):]
    if "Function :" in block:
        block = block[:block.index("Function :")]
    code = [t.strip() for t in
            re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", block)]
    per_step = Counter()
    step = None
    for chain in sass_step_chains(code):
        k = sum(op.startswith("ISETP.GE.U32") for op in chain)
        if k and len(chain) % k == 0:
            per_step[len(chain) // k] += k
            if k == 1 and step is None:
                step = chain
    if not per_step or step is None:
        raise AssertionError("no step of K3's chain found in its SASS")
    n_dep = per_step.most_common(1)[0][0]
    mhz = sm_clock_max_mhz()
    return {"chain_bound_ms": S * n_dep * DEP_CYCLES / (mhz * 1e3),
            "chain_instructions_a_step": n_dep,
            "chain_steps_read": dict(per_step), "chain_step": step,
            "sm_clock_max_mhz": mhz, "dep_cycles": DEP_CYCLES}


def check_divide(kern, dev) -> int:
    """K3's reciprocal divide against // over every frequency in [1, 2^16],
    at the edges of its quotients and at seeded x; returns the pairs
    checked."""
    import torch
    divmod_fn = kern.function("rans_divmod_launch",
                              [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                       ctypes.c_void_p])
    d = torch.arange(1, (1 << 16) + 1, dtype=torch.int64, device=dev)
    top = ((1 << 32) - 1) // d
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    cols = [torch.zeros_like(d), d - 1, d, d + 1, top * d - 1, top * d,
            torch.full_like(d, (1 << 32) - 1), (d << 16) - 1,
            (d << 16) - 1 - d] + [
        torch.randint(0, 1 << 32, d.shape, generator=gen, device=dev)
        for _ in range(64)]
    x = torch.stack(cols, 1).clamp(0, (1 << 32) - 1)
    dd = d[:, None].expand_as(x).contiguous()
    x32 = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
    d32 = dd.to(torch.int32)
    q = torch.empty_like(x32)
    rc = divmod_fn(x32.data_ptr(), d32.data_ptr(), q.data_ptr(), x32.numel(),
                   stream_ptr())
    torch.cuda.synchronize()
    if rc or not torch.equal(q.long() & 0xFFFFFFFF, x // dd):
        raise AssertionError(f"K3's reciprocal divide differs from // on the "
                             f"card (rc {rc})")
    return x.numel()


def _profiled(fn) -> list:
    """The profiler's events of ``fn()`` followed by a device synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return list(prof.events())


def encode_profile(encode, *args) -> dict:
    """Kernel launches, copies, sets and host synchronizations of
    ``encode(*args)`` by ``torch.profiler``, warmed up once.  Launches
    and synchronizations are the host's runtime calls; the calls of a
    profiled empty call (the closing synchronize and the profiler's own)
    are not counted.  The device's records name the kernels that ran; the
    profiler has been seen to drop some of them, so ``device_kernels`` may
    fall short of ``kernel_launches``, never exceed it."""
    import torch
    from torch.autograd import DeviceType

    def host_calls(events, names):
        return [e.name for e in events if e.device_type == DeviceType.CPU
                and e.name.startswith(names)]

    def without(found, base):
        found = list(found)
        for name in base:
            found.remove(name)
        return found

    encode(*args)
    torch.cuda.synchronize()
    empty = _profiled(lambda: None)
    events = _profiled(lambda: encode(*args))
    syncs = without(host_calls(events, SYNC_CALLS),
                    host_calls(empty, SYNC_CALLS))
    launches = without(host_calls(events, LAUNCH_CALLS),
                       host_calls(empty, LAUNCH_CALLS))
    device = [e.name for e in events if e.device_type == DeviceType.CUDA]
    copies = [n for n in device if n.startswith("Memcpy")]
    sets = [n for n in device if n.startswith("Memset")]
    return {"kernel_launches": len(launches), "launch_calls": launches,
            "device_kernels": len(device) - len(copies) - len(sets),
            "device_copies": len(copies), "device_sets": len(sets),
            "host_synchronizations": len(syncs), "sync_calls": syncs,
            "kernels": [n[:60] for n in device]}


def check_kernels(codec, counts, extras: bool = True):
    """K1-K4, K6 and K7 against their plain versions on a payload of the
    codec's shapes (K3, K6 and K7 also on check_back_end_cases' geometries,
    K4 on every phase, z included); timings and bounds at those shapes.
    ``extras`` adds what path 1's codec alone carries: the composition K7
    replaced, the launches of one ``encode_rans_v4``, the batch of 128,
    K3's chain bound and its reciprocal divide."""
    import torch

    from mlic_tpu_torch.codec import encode_rans_v4
    from mlic_tpu_torch.entropy import device_rans as dr
    from mlic_tpu_torch.entropy.parametric import eval_cdf, eval_cdf_plain
    from mlic_tpu_torch.entropy.stream import assemble_streams
    from mlic_tpu_torch.ops._build import KERNELS, stream_handle
    from mlic_tpu_torch.ops.select_rows import select_rows, select_rows_plain

    dev = codec.device
    cfg = codec.model.cfg
    tables = codec.tables
    rp = tables["row_params"]
    n_phases = 2 * cfg.slice_num
    sym_np, idx_np, z_np = make_payload(codec, np.random.default_rng(SEED + 1))
    sym, idx, z = (torch.from_numpy(a).to(dev) for a in (sym_np, idx_np, z_np))
    out = []

    def entry(name, source, replaces, err, ms, plain_ms, nbytes, ops,
              library_ms, shape, call):
        bms, by = bound(nbytes, ops)
        symbol = KERNEL_SYMBOLS[name]
        out.append({"name": name, "route": "cuda",
                    "source": f"mlic_tpu_torch/csrc/{source}",
                    "replaces": replaces, "launches": counts[name],
                    "status": "exact" if err == 0.0 else "differs",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
                    "kernel_ms": kernel_ms(call, symbol),
                    "queued_ms": queued_ms(call), "shape": shape})
        if err != 0.0:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err})")

    # K1 at the decoder's per-phase shape: [steps, B*n_lanes] rows.
    rows = dr.phase_order(idx[:, :idx.shape[1] // n_phases], N_LANES,
                          rp.shape[0] - 1).contiguous()
    got, ref = select_rows(rows, rp), select_rows_plain(rows, rp)
    n = rows.numel()
    entry("select_rows", "select_rows.cu", "mlic_tpu/ops/pallas_select.py:93",
          max_abs_err([(got, ref)]), cuda_ms(lambda: select_rows(rows, rp), 50),
          cuda_ms(lambda: select_rows_plain(rows, rp), 10),
          4 * n + 4 * 6 * n + rp.numel() * 4, 0,
          cuda_ms(lambda: rp[rows.long()], 50), list(rows.shape),
          lambda: select_rows(rows, rp))
    if extras:
        # the floor: an empty kernel on K1's grid, on the same stream
        empty = KERNELS["select_rows"].function(
            "select_rows_empty_launch", [ctypes.c_longlong, ctypes.c_void_p])
        out[-1]["empty_kernel_queued_ms"] = queued_ms(
            lambda: empty(n, stream_handle(rows)))

    # K2 as the encoder uses it: slot and slot+1 over the whole y payload.
    m, b, A, C, Bc, Lf = select_rows(idx, rp)
    L = Lf.to(torch.int32)
    v = sym - (-((L - 1) >> 1))
    slot = torch.where((v < 0) | (v >= L), L, v)
    k = torch.stack([slot, slot + 1]).contiguous()
    got, ref = eval_cdf(k, m, b, A, C, Bc), eval_cdf_plain(k, m, b, A, C, Bc)
    n = sym.numel()
    entry("eval_cdf", "eval_cdf.cu", "mlic_tpu/entropy/parametric.py:93",
          max_abs_err([(got, ref)]), cuda_ms(lambda: eval_cdf(k, m, b, A, C, Bc), 20),
          cuda_ms(lambda: eval_cdf_plain(k, m, b, A, C, Bc), 5),
          8 * n + 20 * n + 8 * n, 2 * n * CDF_OPS, None, list(k.shape),
          lambda: eval_cdf(k, m, b, A, C, Bc))

    # K7, the prep, against its plain version and, timed, the composition
    # of K1, K2 and PyTorch ops it replaced.
    secs, prep_err = prep_case(codec, sym, idx, z)
    prep_args = (sym, idx, z, tables, codec.z_rows_base, cfg.N)
    n_y, n_zt = sym.numel(), z.numel()
    composition = functools.partial(dr.encode_prep_plain, *prep_args,
                                    select=select_rows, cdf=eval_cdf)
    entry("rans_encode_prep", "rans_encode_prep.cu",
          "mlic_tpu/entropy/device_rans.py:419", prep_err,
          cuda_ms(lambda: dr.rans_encode_prep(*prep_args), 20),
          cuda_ms(lambda: dr.encode_prep_plain(*prep_args), 5),
          17 * n_y + 13 * n_zt + rp.numel() * 4, 2 * n_y * CDF_OPS, None,
          [BATCH, sym.shape[1] + z.shape[1]],
          lambda: dr.rans_encode_prep(*prep_args))
    if extras:
        out[-1].update({"composition_ms": cuda_ms(composition, 10),
                        "composition_queued_ms": queued_ms(composition),
                        "composition": "gather_start_freq + "
                                       "analytic_start_freq through K1 "
                                       "select_rows and K2 eval_cdf"})

    # The launches of one rANS encode: K7, K3, K6 and nothing else.  (Taken
    # before the batch-128 checks: in a run of the whole script, traces
    # taken after them held no device events.)  The trace must hold at most
    # MAX_ENCODE_LAUNCHES kernel launches, as the host's launch calls count
    # them, and no synchronization.  That K7, K3 and K6 ran on the card is
    # shown by their own device-side counts (``device_proof``), each equal
    # to the host's, not by the trace's device records: the profiler has
    # dropped those (it named no K7 in three traces of one run), so the
    # records are printed and not required.
    if extras:
        enc_args = (sym, idx, z, tables, N_LANES, n_phases, codec.z_rows_base)
        prof = encode_profile(encode_rans_v4, *enc_args)
        prof["device_records_name_k7_k3_k6"] = all(
            any(KERNEL_SYMBOLS[k] in n for n in prof["kernels"])
            for k in ENCODE_KERNELS)
        print(json.dumps({"encode_rans_v4_profile": prof}), flush=True)
        _, host = device_proof(lambda: encode_rans_v4(*enc_args),
                               "encode_rans_v4",
                               {k: 1 for k in ENCODE_KERNELS})
        if prof["host_synchronizations"] \
                or not prof["device_kernels"] <= prof["kernel_launches"] \
                <= MAX_ENCODE_LAUNCHES \
                or sum(host.values()) > MAX_ENCODE_LAUNCHES:
            raise AssertionError(f"encode_rans_v4: {prof['kernel_launches']} "
                                 f"launches, synchronizations "
                                 f"{prof['sync_calls']}, {host} by the "
                                 f"host's counts (at most "
                                 f"{MAX_ENCODE_LAUNCHES} launches and no "
                                 f"synchronization)")

    # K3 and K6 over the whole stream of the batch, from the prep's sections.
    (st_z, fm_z, esc_z), (st_y, fm_y, esc_y) = secs
    row, got, comp, (start16, freqm1, esc_pos, sym_steps, ref) = \
        back_end_case(secs, z, sym, N_LANES, n_phases, "serving")
    row["max_abs_err_prep"] = prep_err
    cases = [row] + check_back_end_cases(codec, sym, idx, z)
    for case in cases:
        case["model"] = cfg.name
    print(json.dumps({"encode_back_end_cases": cases}), flush=True)
    big = check_big_batch(codec, n_phases) if extras else None
    streams = assemble_streams(comp, N_LANES)
    plain_streams = assemble_streams(dr.compact_streams_global(
        *ref, esc_pos, sym_steps, BATCH), N_LANES)
    if streams != plain_streams:
        raise AssertionError("K3 + K6 streams differ from the plain back end's")
    scan_args = (st_z, fm_z, st_y, fm_y, N_LANES, n_phases)
    S, L = start16.shape
    W = -(-N_LANES // 32)
    n_real = BATCH * (z.shape[1] + sym.shape[1])
    entry("rans_encode_scan", "rans_encode.cu",
          "mlic_tpu/entropy/device_rans.py:525", row["max_abs_err_scan"],
          cuda_ms(lambda: dr.rans_encode_scan(*scan_args), 20),
          cuda_ms(lambda: dr.rans_encode_scan_plain(start16, freqm1,
                                                    N_LANES), 1),
          8 * n_real + 2 * S * L + 4 * S * BATCH * W + 8 * L, 10 * S * L,
          None, [S, L], lambda: dr.rans_encode_scan(*scan_args))
    if extras:
        out[-1].update(k3_chain_bound(S))
        out[-1]["divide_checked"] = check_divide(dr.ENCODE_KERNEL, dev)
    n_words = int(comp["img_n"].sum())
    n_esc = int(comp["ecount"].sum())
    compact_args = (*got, esc_z, z, esc_y, sym, N_LANES, n_phases)
    entry("rans_encode_compact", "rans_compact.cu",
          "mlic_tpu/entropy/device_rans.py:602", row["max_abs_err_compact"],
          cuda_ms(lambda: dr.rans_encode_compact(*compact_args), 20),
          cuda_ms(lambda: dr.compact_streams_global(
              *got, esc_pos, sym_steps, BATCH), 5),
          4 * S * BATCH * W + 2 * (n_words - 2 * L) + n_real + 4 * n_esc
          + 8 * L + 2 * n_words + 4 * n_esc + 8 * BATCH, 0, None,
          [S, L], lambda: dr.rans_encode_compact(*compact_args))
    out[-1].update({"words": n_words, "escapes": n_esc})
    if extras:
        out[-1]["big_batch_queued_ms"] = big["compact_queued_ms"]
        next(k for k in out if k["name"] == "rans_encode_prep")[
            "big_batch_queued_ms"] = big["prep_queued_ms"]

    # K4 phase by phase over those streams, timed on the first y phase.
    err, (call, plain, rows1, got1, ptr0) = decode_phases(
        codec, streams, idx, z, sym_steps)
    P = rows1.numel()
    consumed = int((got1[3] - ptr0).sum())
    Lrow = rp[rows1.long(), 5].to(torch.int64).clamp(min=1)
    evals = float(torch.floor(torch.log2(Lrow.double())).sum())
    entry("rans_decode_phase", "rans_decode.cu",
          "mlic_tpu/entropy/device_rans.py:169", err, cuda_ms(call, 10),
          cuda_ms(plain, 1),
          4 * P + 5 * P + 2 * consumed + 16 * rows1.shape[1] + 8 * BATCH
          + rp.numel() * 4, evals * CDF_OPS + 20 * P, None,
          list(rows1.shape), call)
    out[-1]["phases_checked"] = n_phases + 1
    n_z_steps = -(-z.shape[1] // N_LANES)
    n_per_steps = -(-(idx.shape[1] // n_phases) // N_LANES)
    if n_z_steps + n_phases * n_per_steps != S:
        raise AssertionError("stream steps differ from the codec's layout")
    return out


def decode_phases(codec, streams, idx, z, sym_steps,
                  y_parametric: bool = True) -> tuple:
    """K4 phase by phase over ``streams`` (the payload ``idx``, ``z`` coded
    at N_LANES by the codec's tables): the z phase by its integer rows,
    each y phase parametrically or (``y_parametric`` False) by its integer
    rows; kernel and plain version on the same carry, then the escape
    patch; the symbols must come back as ``sym_steps`` (position order).
    Returns (the max abs error, (kernel call, plain call, rows, kernel
    outputs, word pointers before) of the first y phase)."""
    import torch

    from mlic_tpu_torch.entropy import device_rans as dr
    from mlic_tpu_torch.entropy.stream import parse_global
    dev, cfg, tables = codec.device, codec.model.cfg, codec.tables
    n_phases = 2 * cfg.slice_num
    n_per = idx.shape[1] // n_phases
    parsed = [parse_global(s) for s in streams]
    words = torch.from_numpy(np.concatenate([p[1] for p in parsed])
                             .view(np.int16)).to(dev)
    img_begin = torch.tensor(np.cumsum([0] + [len(p[1]) for p in parsed[:-1]]),
                             dtype=torch.int32, device=dev)
    esc_vals = torch.from_numpy(np.concatenate([p[2] for p in parsed])).to(dev)
    esc_begin = torch.tensor(np.cumsum([0] + [len(p[2]) for p in parsed[:-1]]),
                             dtype=torch.int32, device=dev)
    x, ptr = dr.rans_init_global(words, img_begin, N_LANES)
    esc_count = torch.zeros_like(esc_begin)
    pad_row = codec.z_rows_base - 1
    z_rows = dr.phase_order(
        (codec.z_rows_base + torch.arange(z.shape[1], device=dev,
                                          dtype=torch.int32) % cfg.N)
        [None].expand(z.shape[0], -1), N_LANES, pad_row).contiguous()
    decoded, err, timed = [], 0.0, None
    for k in range(n_phases + 1):
        if k == 0:
            args = (z_rows, tables, False)
            steps = codec.z_steps_row
        else:
            args = (dr.phase_order(idx[:, (k - 1) * n_per:k * n_per],
                                   N_LANES, pad_row).contiguous(), tables,
                    y_parametric)
            steps = codec.n_steps
        call = functools.partial(dr.rans_decode_phase, words, x, ptr,
                                 N_LANES, steps, *args)
        plain = functools.partial(dr.rans_decode_phase_plain, words, x, ptr,
                                  N_LANES, steps, *args)
        got, ref = call(), plain()
        err = max(err, max_abs_err(zip(got, ref)))
        if k == 1:
            timed = (call, plain, args[0], got, ptr)
        sym_k, esc_count = dr.patch_escapes(got[0], got[1], esc_count,
                                            esc_vals, esc_begin, N_LANES)
        decoded.append(sym_k)
        x, ptr = got[2], got[3]
    if not torch.equal(torch.cat(decoded), sym_steps.reshape(-1)):
        raise AssertionError("decoded payload differs from the encoded one")
    return err, timed


def stream_ptr() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def check_decode_lanes(codec):
    """K4 against its plain version, exact, in both modes, on seeded
    states, words and table rows at each of K4_LANE_CASES: every cluster
    size the codec's lane counts give."""
    import torch

    from mlic_tpu_torch.entropy import device_rans as dr
    tables = codec.tables
    rp = tables["row_params"]
    rng = np.random.default_rng(SEED + 4)
    rows = []
    for lanes, B, S in K4_LANE_CASES:
        BL = B * lanes
        words = torch.from_numpy(rng.integers(0, 1 << 16, 20 * S * BL)
                                 .astype(np.uint16).view(np.int16)).cuda()
        x = torch.from_numpy(rng.integers(1 << 16, 1 << 32, BL)).cuda()
        ptr = torch.from_numpy((np.arange(B) * 10 * S * lanes)
                               .astype(np.int32)).cuda()
        idx = torch.from_numpy(rng.integers(0, rp.shape[0] - 1, (S, BL))
                               .astype(np.int32)).cuda()
        for mode, parametric, steps in (
                ("parametric", True, codec.n_steps),
                ("rows", False, codec.z_steps_row)):
            call = functools.partial(dr.rans_decode_phase, words, x, ptr,
                                     lanes, steps, idx, tables, parametric)
            got = call()
            ref = dr.rans_decode_phase_plain(words, x, ptr, lanes, steps,
                                             idx, tables, parametric)
            exact = all(torch.equal(g, r) for g, r in zip(got, ref))
            rows.append({"lanes": lanes, "images": B, "steps": S,
                         "mode": mode,
                         "threads_per_lane": dr.decode_group(lanes),
                         "blocks_per_image": dr.decode_blocks_per_image(
                             lanes), "exact": exact,
                         "ms": cuda_ms(call, 10)})
            if not exact:
                print(json.dumps({"rans_decode_lanes": rows}), flush=True)
                raise AssertionError(f"K4 differs from its plain version at "
                                     f"{lanes} lanes ({mode})")
    print(json.dumps({"rans_decode_lanes": rows}), flush=True)


def eval_path(state, pool) -> dict:
    """Path 2: the file-based evaluation entry point at full width, with
    the fused block tail (K5) in g_a and g_s, over the first EVAL_FRAMES
    frames of ``pool`` and a crop.  Returns its launch counts."""
    import torch

    from mlic_tpu_torch.codec import Codec, auto_lanes
    from mlic_tpu_torch.eval import evaluate_codec, pad_to_multiple
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.ops import _build

    os.environ[FUSED_SWITCH] = "1"
    model = get_model(MODEL, transform_dtype="bfloat16_mixed")
    model.load_state_dict(state)
    images = [f.astype(np.float32) / 255.0 for f in pool[:EVAL_FRAMES]]
    images.append(images[0][:EVAL_CROP[0], :EVAL_CROP[1]])
    lines = []
    _build.reset_launch_counts()
    codec = Codec(model, device="cuda")         # n_lanes="auto"
    codec.update()
    with tempfile.TemporaryDirectory() as save_dir:
        # raises unless every decoder x_hat, read back from its file, is
        # bit-identical to the encoder's
        res = evaluate_codec(
            codec, images, save_dir,
            log=lambda line: lines.append(f"{line} lanes={codec.n_lanes}"))
        files = sorted(os.listdir(save_dir))
    counts = _build.launch_counts()
    per_image = k5_per_image(model.cfg, "bfloat16_mixed")
    # the escape share of the same images' streams
    n_esc = n_sym = 0
    for img in images:
        st = stream_stats(codec, codec.compress(pad_to_multiple(img[None])[0]))
        n_esc, n_sym = n_esc + st["escapes"], n_sym + st["symbols"]
    print(json.dumps({"eval_path": {
        "model": MODEL, "weights": "trained (ckpts/bench_default)",
        "transform_dtype": "bfloat16_mixed",
        FUSED_SWITCH: "1", "lanes": "auto", "lanes_resolved": codec.n_lanes,
        "images": [list(i.shape) for i in images], "files": files,
        "per_image": lines, "average": res,
        "escape_share": n_esc / n_sym, "launches": counts,
        "k5_per_image": per_image}}), flush=True)
    if res["n_images"] != len(images) or len(files) != len(images):
        raise AssertionError(f"eval path: {res['n_images']} images, "
                             f"{len(files)} files for {len(images)} inputs")
    want_lanes = auto_lanes(model.cfg, HEIGHT, WIDTH)
    if codec.n_lanes != want_lanes:
        raise AssertionError(f"eval path: resolved {codec.n_lanes} lanes, "
                             f"auto_lanes gives {want_lanes}")
    bad = [k for k in ("bpp", "psnr", "ms_ssim") if not np.isfinite(res[k])]
    if bad or not res["bpp"] > 0:
        raise AssertionError(f"eval path: not finite: {bad}, bpp {res['bpp']}")
    if counts["fused_block_tail"] != per_image * len(images):
        raise AssertionError(
            f"eval path: K5 launched {counts['fused_block_tail']} times, "
            f"expected {per_image} per image")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the eval path: {missing}")
    # the latent too: decoder y_hat == encoder y_hat on a full frame
    enc = codec.compress(images[0][None])
    dec = codec.decompress(enc["strings"], enc["shape"])
    if not (torch.equal(enc["y_hat"], dec["y_hat"])
            and torch.equal(enc["x_hat"], dec["x_hat"])):
        raise AssertionError("eval path: decoder y_hat or x_hat differs")
    os.environ.pop(FUSED_SWITCH)
    return counts


def fused_against_unfused(state, frames):
    """g_a (through ``analyze``) and g_s (through ``synthesize``) on one
    serving batch with the fused tail off and on: the difference of y and
    of x_hat against the output's scale, and the median time of each, the
    two settings taken in turns (off, on, on, off)."""
    import torch

    from mlic_tpu_torch.models.registry import get_model
    x = torch.from_numpy(frames).cuda()
    rows = {}
    for policy, tol in (("float32", 1e-5), ("bfloat16_mixed", 5e-2)):
        model = get_model(MODEL, transform_dtype=policy)
        model.load_state_dict(state)
        model.cuda().eval()
        outs, ms = {}, {}
        with torch.no_grad():
            for switch in ("0", "1", "1", "0") * 3:
                os.environ[FUSED_SWITCH] = switch
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y, _ = model.analyze(x)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                x_hat = model.synthesize(torch.round(outs.get("y0", y)))
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                outs.setdefault("y0", y)       # one latent feeds every g_s
                outs[switch] = (y, x_hat)
                ms.setdefault(switch, []).append(((t1 - t0) * 1e3,
                                                  (t2 - t1) * 1e3))
        os.environ.pop(FUSED_SWITCH)
        row = {"tolerance_of_scale": tol}
        for i, name in enumerate(("y", "x_hat")):
            ref, got = outs["0"][i], outs["1"][i]
            scale = float(ref.abs().max())
            err = float((ref - got).abs().max())
            row[name] = {"max_abs_diff": err, "scale": scale,
                         "of_scale": err / scale}
            # the first round of each setting pays set-up: leave it out
            for switch, key in (("0", "unfused_ms"), ("1", "fused_ms")):
                row[name][key] = float(np.median(
                    [m[i] for m in ms[switch][1:]]))
        rows[policy] = row
    print(json.dumps({"fused_against_unfused": {
        "batch": list(frames.shape), "g_a_through": "analyze (with h_a)",
        "g_s_through": "synthesize", **rows}}), flush=True)
    for policy, row in rows.items():
        for name in ("y", "x_hat"):
            if not row[name]["of_scale"] <= row["tolerance_of_scale"]:
                raise AssertionError(
                    f"fused {name} under {policy} differs from unfused by "
                    f"{row[name]['of_scale']} of its scale")


def _tail_f64(mid, skip, conv, gdn, act):
    """The block tail's formula in float64, nothing rounded."""
    import torch
    import torch.nn.functional as F

    from mlic_tpu_torch.models.layers import _gdn_effective
    d = torch.float64
    g = F.gelu(mid.to(d), approximate="tanh")
    a = F.conv2d(g, conv.dw.depth.weight.to(d), conv.dw.depth.bias.to(d),
                 padding=1, groups=mid.shape[1])
    h = F.conv2d(a, conv.dw.point.weight.to(d), conv.dw.point.bias.to(d))
    if act == "gelu":
        return F.gelu(h, approximate="tanh") + skip.to(d)
    gamma, beta = _gdn_effective(gdn)
    norm = F.conv2d(h * h, gamma.to(d).t()[:, :, None, None], beta.to(d))
    return h * (norm.sqrt() if act == "igdn" else norm.rsqrt()) + skip.to(d)


def check_fused_block(launches: int):
    """K5 against ``fused_block_tail_plain`` on the card at every shape of
    the path at the serving batch, at a ragged size with other widths and
    with C != N, in f32 and bf16; both against float64; times of the
    path's shapes.  Returns K5's entry of the kernels line."""
    import torch

    from mlic_tpu_torch.models import layers as tl
    from mlic_tpu_torch.models.config import CONFIGS
    from mlic_tpu_torch.ops.fused_block import (
        ACTS,
        KERNEL,
        MAX_SMEM,
        fused_block_tail,
        fused_block_tail_plain,
        smem_bytes,
    )

    N = 96
    sizes = ((HEIGHT // 2, WIDTH // 2), (HEIGHT // 4, WIDTH // 4),
             (HEIGHT // 8, WIDTH // 8))
    cases = [(act, BATCH, N, N, h, w, True) for act in ("gdn", "igdn", "gelu")
             for h, w in sizes]
    cases.append(("gelu", BATCH, 160, 160, HEIGHT // 16, WIDTH // 16, True))
    cases.append(("gdn", 1, N, N, HEIGHT // 2, WIDTH // 2, True))
    for act in ("gdn", "igdn", "gelu"):
        cases += [(act, 1, c, n, 37, 53, False) for c, n in
                  ((96, 96), (160, 160), (192, 192), (320, 320), (48, 48),
                   (320, 48), (40, 72), (100, 36))]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    rows, head = [], None
    for act, b, c, n, h, w, on_path in cases:
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            conv = tl.Conv3x3(c, n, 1, True, dt).cuda()
            gdn = tl.GDN(n, inverse=act == "igdn",
                         dtype=None if dt == torch.float32 else dt).cuda()
            ped = gdn._OFFSET ** 2
            with torch.no_grad():
                conv.dw.depth.weight.copy_(randn(c, 1, 3, 3, scale=1 / 3))
                conv.dw.depth.bias.copy_(randn(c, scale=0.1))
                conv.dw.point.weight.copy_(randn(n, c, 1, 1, scale=c ** -0.5))
                conv.dw.point.bias.copy_(randn(n, scale=0.1))
                gdn.beta.copy_((1.0 + randn(n).abs() + ped).sqrt())
                gdn.gamma.copy_((0.1 * torch.eye(n, device="cuda")
                                 + 0.02 * randn(n, n).abs() + ped).sqrt())
                mid, skip = randn(b, c, h, w).to(dt), randn(b, n, h, w).to(dt)
                gamma, beta = (None, None) if act == "gelu" else (
                    t.contiguous() for t in tl._gdn_effective(gdn))
                args = (mid, skip, conv.dw.depth.weight, conv.dw.depth.bias,
                        conv.dw.point.weight, conv.dw.point.bias, gamma, beta)
                got = fused_block_tail(*args, act=act)
                torch.cuda.synchronize()
                ref = fused_block_tail_plain(*args, act=act)
                exact = _tail_f64(mid, skip, conv, gdn, act)
                if got.dtype != dt or got.shape != ref.shape:
                    raise AssertionError(f"K5 returned {got.dtype} "
                                         f"{tuple(got.shape)}")
                diff = (got.double() - ref.double()).abs()
                row = {"act": act, "dtype": name, "mid": [b, c, h, w], "N": n,
                       "max_abs_err": float(diff.max()),
                       "err_of_tolerance": float(
                           (diff / (1 + ref.double().abs())).max())
                       / K5_TOL[name],
                       "kernel_vs_f64": float((got.double() - exact)
                                              .abs().max()),
                       "plain_vs_f64": float((ref.double() - exact)
                                             .abs().max())}
                del exact, diff
                if on_path:
                    def unfused(conv=conv, gdn=gdn, mid=mid, skip=skip,
                                act=act):
                        t = conv(tl.gelu(mid))
                        return (tl.gelu(t) if act == "gelu" else gdn(t)) + skip

                    call = functools.partial(fused_block_tail, *args, act=act)
                    pix = b * h * w
                    ops = pix * (2 * c * n + 18 * c
                                 + (0 if act == "gelu" else 2 * n * n))
                    nbytes = (mid.numel() + 2 * skip.numel()) \
                        * mid.element_size() + 4 * sum(
                            t.numel() for t in args[2:] if t is not None)
                    row["bound_ms"], row["bound_by"] = bound(
                        nbytes, ops,
                        F32_OPS if dt == torch.float32 else BF16_OPS)
                    row["ms"] = cuda_ms(call, 10)
                    row["plain_ms"] = cuda_ms(functools.partial(
                        fused_block_tail_plain, *args, act=act), 3)
                    row["unfused_ms"] = cuda_ms(unfused, 5)
                    if head is None and dt == torch.bfloat16:
                        row["kernel_ms"] = kernel_ms(
                            call, KERNEL_SYMBOLS["fused_block_tail"])
                        row["queued_ms"] = queued_ms(call)
                        head = row
                rows.append(row)
                if not (row["err_of_tolerance"] <= 1.0 and (
                        dt == torch.float32 or row["kernel_vs_f64"]
                        <= 2 * row["plain_vs_f64"])):
                    print(json.dumps({"fused_block_tail_checks": rows}),
                          flush=True)
                    raise AssertionError(f"K5 differs from its plain version "
                                         f"beyond tolerance, or errs against "
                                         f"float64 more than twice as much "
                                         f"as the plain version: {row}")
    print(json.dumps({"fused_block_tail_checks": rows,
                      "tolerance": K5_TOL}), flush=True)

    # The kernel's shared-memory plan takes every width the configurations
    # send through the fused tail (every configuration of CONFIGS, with its
    # old synthesis head too: the depthwise tails of g_a and g_s), C != N
    # too, in both dtypes and all three tails, and two bf16 blocks an SM at
    # C = N = 96.
    widths = {(96, 160), (160, 96)}
    for cfg in CONFIGS.values():
        for c in (cfg, dataclasses.replace(cfg, old_synthesis=True)):
            widths.update(fused_tails(c, "float32", "g_a")
                          + fused_tails(c, "float32", "g_s"))
    plan = {f"{c}x{n}": {f"{act}_{str(dt).split('.')[1]}":
                         smem_bytes(c, n, act, dt) for act in ACTS
                         for dt in (torch.float32, torch.bfloat16)}
            for c, n in sorted(widths)}
    print(json.dumps({"fused_block_tail_smem_bytes": plan,
                      "max": MAX_SMEM}), flush=True)
    if max(v for p in plan.values() for v in p.values()) > MAX_SMEM \
            or 2 * plan["96x96"]["gdn_bfloat16"] > 228 * 1024:
        raise AssertionError("K5's shared-memory plan does not take the "
                             "configurations' widths")
    # A launch that cannot run (its tile needs more shared memory than a
    # block may have) must raise, and must not poison the next launch.
    wide = 4096
    bad = (randn(1, wide, 8, 8), randn(1, wide, 8, 8), randn(wide, 1, 3, 3),
           randn(wide), randn(wide, wide, 1, 1), randn(wide),
           randn(wide, wide), randn(wide))
    try:
        fused_block_tail(*bad, act="gdn")
    except ValueError as e:
        print(json.dumps({"fused_block_tail_refuses": str(e)}), flush=True)
    else:
        raise AssertionError("K5 took a width that cannot fit a block")
    # the C entry point refuses it too, before any launch
    out_bad = torch.empty_like(bad[1])
    try:
        KERNEL.launch(*(t.data_ptr() for t in (bad[0], bad[1], out_bad)),
                      *(t.data_ptr() for t in bad[2:]), 1, wide, wide, 8, 8,
                      ACTS["gdn"], 0, stream_ptr())
    except RuntimeError as e:
        print(json.dumps({"fused_block_tail_launch_refuses": str(e)}),
              flush=True)
    else:
        raise AssertionError("K5's entry point took a width that cannot fit")
    fused_block_tail(*args, act=act)        # the last case again: still runs
    torch.cuda.synchronize()

    return {"name": "fused_block_tail", "route": "cuda",
            "source": "mlic_tpu_torch/csrc/fused_block_tail.cu",
            "replaces": "mlic_tpu/ops/pallas_fused_block.py:148",
            "launches": launches, "status": "within tolerance",
            "tolerance": K5_TOL["bfloat16"],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "kernel_ms": head["kernel_ms"], "queued_ms": head["queued_ms"],
            "unfused_ms": head["unfused_ms"],
            "shape": head["mid"], "dtype": head["dtype"], "act": head["act"]}


def check_lane_widths(model, frames):
    """Round trips at other lane counts (a partial warp, the widest block):
    bit-exact y_hat through the kernels."""
    import torch

    from mlic_tpu_torch.codec import Codec
    for lanes, x in ((16, frames[0][:2, :128, :256]), (1024, frames[0])):
        codec = Codec(model, n_lanes=lanes, device="cuda")
        enc = codec.compress(np.ascontiguousarray(x))
        dec = codec.decompress(enc["strings"], enc["shape"])
        if not torch.equal(enc["y_hat"], dec["y_hat"]):
            raise AssertionError(f"{lanes} lanes: y_hat differs")
        print(json.dumps({"lanes": lanes, "shape": list(x.shape),
                          "roundtrip": "bit-exact"}), flush=True)


def check_small_reference(state_dict):
    """The f32 analysis transform on the card against the CPU."""
    import torch

    from mlic_tpu_torch.models.registry import get_model
    x = np.random.default_rng(SEED + 2).random((1, 64, 128, 3),
                                               dtype=np.float32)
    ys = []
    for dev in ("cpu", "cuda"):
        m = get_model(MODEL, transform_dtype="float32")
        m.load_state_dict(state_dict)
        m.to(dev).eval()
        with torch.no_grad():
            ys.append(m.analyze(torch.from_numpy(x).to(dev))[0].cpu())
    err = float((ys[0] - ys[1]).abs().max())
    scale = float(ys[0].abs().max())
    print(json.dumps({"analyze_f32_cpu_vs_cuda_max_abs_err": err,
                      "y_max_abs": scale}), flush=True)
    if not err <= 1e-4 * max(scale, 1.0):
        raise AssertionError(f"analyze on the card differs from the CPU: {err}")


def load_trained(path: str = CHECKPOINT, name: str = MODEL,
                 n_arrays: int = CKPT_ARRAYS,
                 n_params: int | None = CKPT_PARAMS,
                 label: str = "weights") -> dict:
    """Trained weights from an orbax directory (by default the trained
    MLICPP_S): whether the system zstd library resolves, the reader's
    seconds, the array and parameter counts (``n_params`` None: the
    model's), and a strict load into the port's model ``name`` (the
    ``label`` line).  Returns the state_dict."""
    import ctypes.util

    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.utils.checkpoint import read_orbax
    from mlic_tpu_torch.weights import from_flax
    zstd = ctypes.util.find_library("zstd")
    t0 = time.perf_counter()
    tree = read_orbax(path)
    secs = time.perf_counter() - t0

    def leaves(t):
        for v in t.values():
            yield from (leaves(v) if isinstance(v, dict) else (v,))
    arrays = list(leaves(tree))
    state = from_flax(tree["params"])
    model = get_model(name)
    res = model.load_state_dict(state, strict=True)
    if n_params is None:
        n_params = sum(t.numel() for t in model.state_dict().values())
    row = {"libzstd": zstd, "model": name,
           "checkpoint": os.path.relpath(path, REPO),
           "read_orbax_s": secs, "arrays": len(arrays),
           "parameters": int(sum(a.size for a in arrays)),
           "dtypes": sorted({str(a.dtype) for a in arrays}),
           "missing": res.missing_keys, "unexpected": res.unexpected_keys}
    print(json.dumps({label: row}), flush=True)
    if (row["arrays"], row["parameters"]) != (n_arrays, n_params) \
            or res.missing_keys or res.unexpected_keys:
        raise AssertionError(f"trained weights: {row}")
    return state

def seeded_model(name: str, transform_dtype: str, **overrides):
    """``name`` with the seeded random weights of ``init_params``."""
    import torch

    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.weights import init_params
    model = get_model(name, transform_dtype=transform_dtype, **overrides)
    model.load_state_dict(init_params(model,
                                      torch.Generator().manual_seed(SEED)))
    return model


def seeded_request(noise_frames) -> None:
    """One request of the earlier runs' payload -- seeded random weights,
    noise frames -- beside the trained path: its row and its profile."""
    from mlic_tpu_torch.codec import Codec
    model = seeded_model(MODEL, "bfloat16")
    codec = Codec(model, n_lanes=N_LANES, device="cuda")
    codec.update()
    serve(codec, [noise_frames])                        # set-up request
    row = serve(codec, [noise_frames])[0]
    print(json.dumps({"seeded_payload": {
        "weights": "seeded random", "frames": "noise", **row}}), flush=True)
    profile_request(codec, noise_frames, {"compress": row["encode_ms"],
                                          "decompress": row["decode_ms"]},
                    label="profile_seeded_payload")


def _trainer(state, transform_dtype="bfloat16_mixed", device="cuda",
             name: str = MODEL):
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.train.trainer import TrainConfig, Trainer
    model = get_model(name, transform_dtype=transform_dtype)
    model.load_state_dict(state)
    return Trainer(model, TrainConfig(lmbda=LMBDA, metric="mse",
                                      optimizer="adam", seed=SEED),
                   device=device)


def _floats(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def check_rd_gradient_of_quantiles(trainer, batch) -> None:
    """The quantiles' gradient of the RD loss alone is exactly zero (the
    STE path gives -g + g); only the aux loss moves them."""
    import torch

    from mlic_tpu_torch.loss import rate_distortion_loss
    model = trainer.model
    x = torch.from_numpy(batch).cuda().float() / 255.0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    rd = rate_distortion_loss(model(x, True, None, gen), x, LMBDA)
    q = model.entropy_bottleneck.quantiles
    (grad,) = torch.autograd.grad(rd["loss"], [q])
    if int(torch.count_nonzero(grad)):
        raise AssertionError(f"the quantiles' RD gradient is not zero: "
                             f"{int(torch.count_nonzero(grad))} entries")


def nondeterministic_ops(trainer, batch) -> list:
    """The ops of one training step that PyTorch reports as having no
    deterministic CUDA implementation (``use_deterministic_algorithms`` in
    warn-only mode, for that step alone)."""
    import warnings

    import torch

    from mlic_tpu_torch.train.trainer import train_step
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught, \
                torch.enable_grad():
            warnings.simplefilter("always")
            train_step(trainer.state, batch, trainer.cfg)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(".")[0][:120] for w in caught
                   if "deterministic" in str(w.message)})


def check_resume(trainer, batches, state, name: str = MODEL) -> dict:
    """Save the trainer's state with CheckpointManager, restore it into a
    fresh trainer and take the same two steps on both: the first step's
    loss must be equal (its forward reads identical weights), the second's
    difference is reported with the ops that may make a backward
    nondeterministic."""
    from mlic_tpu_torch.train.trainer import train_step
    from mlic_tpu_torch.utils.checkpoint import CheckpointManager
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(str(trainer.state.step), trainer.state)
        fresh = _trainer(state, name=name)
        mgr.restore(mgr.latest_tag(), fresh.state)
    if fresh.state.step != trainer.state.step:
        raise AssertionError("restored step differs")
    ref = [_floats(train_step(trainer.state, b, trainer.cfg))
           for b in batches]
    got = [_floats(train_step(fresh.state, b, fresh.cfg)) for b in batches]
    diffs = [max(abs(r[k] - g[k]) for k in r) for r, g in zip(ref, got)]
    row = {"restored_step": fresh.state.step - len(batches),
           "losses_uninterrupted": [r["loss"] for r in ref],
           "losses_resumed": [g["loss"] for g in got],
           "max_metric_diff_by_step": diffs,
           "first_step_exact": diffs[0] == 0.0}
    if diffs[1]:
        row["nondeterministic_ops"] = nondeterministic_ops(fresh, batches[0])
    if diffs[0] != 0.0:
        print(json.dumps({"resume": row}), flush=True)
        raise AssertionError(f"resumed step's loss differs by {diffs[0]}")
    return row


def check_cpu_step(state, pool, name: str = MODEL) -> dict:
    """One f32 training step of ``name`` at batch 1, 128x128, on the card
    and on the CPU, with the same noise: loss and the gradient's global
    norm within their relative tolerances (TF32 off on the card)."""
    import torch

    from mlic_tpu_torch.train.trainer import train_step
    from mlic_tpu_torch.models.config import model_config
    b, h, w, _ = CPU_STEP_SHAPE
    x = pool[:b, :h, :w]
    noise = torch.from_numpy(np.random.default_rng(SEED + 10).uniform(
        -0.5, 0.5, (model_config(name).N, b * (h // 64) * (w // 64))
    ).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        tr = _trainer(state, "float32", dev, name)
        m = train_step(tr.state, x, tr.cfg, noise=noise.to(dev))
        out[dev] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])}
    row = {"model": name, "shape": list(CPU_STEP_SHAPE), **out,
           "loss_rel_diff": abs(out["cuda"]["loss"] - out["cpu"]["loss"])
           / abs(out["cpu"]["loss"]),
           "grad_norm_rel_diff": abs(out["cuda"]["grad_norm"]
                                     - out["cpu"]["grad_norm"])
           / out["cpu"]["grad_norm"],
           "tolerances": [CPU_LOSS_RTOL, CPU_GRAD_NORM_RTOL]}
    if not (row["loss_rel_diff"] <= CPU_LOSS_RTOL
            and row["grad_norm_rel_diff"] <= CPU_GRAD_NORM_RTOL):
        print(json.dumps({"cpu_step": row}), flush=True)
        raise AssertionError(f"f32 step on the card differs from the CPU: "
                             f"{row}")
    return row


def train_path(state) -> dict:
    """Path 3: training.  MLICPP_S at full width, warm-started from the
    trained weights, under the CLI's card default ``bfloat16_mixed``,
    Adam, lambda 0.0483, mse, batches of 8 random 256x256 crops of a
    dead-leaves pool: TRAIN_WARMUP steps, then TRAIN_STEPS timed ones and
    one profiled; then resume, the f32 step against the CPU.  Returns the
    trainer, whose model is the fine-tuned one, and the launch counts of
    the port's kernels over the training steps (training launches none of
    them, which the line shows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mlic_tpu_torch.data.folder import dead_leaves_pool, pool_batches
    from mlic_tpu_torch.ops import _build
    from mlic_tpu_torch.train.optimizers import param_labels
    from mlic_tpu_torch.train.trainer import train_step
    pool = dead_leaves_pool(TRAIN_POOL, TRAIN_POOL_SIZE, SEED + 9,
                            cache_dir="")
    n = TRAIN_WARMUP + TRAIN_STEPS
    batches = list(pool_batches(pool, TRAIN_BATCH, TRAIN_PATCH, n + 3,
                                seed=SEED + 1))
    with torch.enable_grad():
        _build.reset_launch_counts()
        tr = _trainer(state)
        check_rd_gradient_of_quantiles(tr, batches[0])
        before = {k: p.detach().clone()
                  for k, p in tr.model.named_parameters()}
        ms, metrics = [], []
        torch.cuda.reset_peak_memory_stats()
        for b in batches[:n]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = train_step(tr.state, b, tr.cfg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append(m)
        peak = torch.cuda.max_memory_allocated() / 2**30
        timed = ms[TRAIN_WARMUP:]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            train_step(tr.state, batches[n], tr.cfg)
            torch.cuda.synchronize()
        rows, spans = device_rows(prof)
        busy = sum(r[0] for r in rows)
        counts = _build.launch_counts()
        labels = param_labels(tr.model)
        moved = {k: not torch.equal(p.detach(), before[k])
                 for k, p in tr.model.named_parameters()}
        main = [k for k in labels if labels[k] == "main"]
        # Leaves with an exactly-zero gradient in the last step are listed,
        # and need not move; every other main tensor must.
        grads = dict((k, p.grad) for k, p in tr.model.named_parameters())
        zero_grad = [k for k in main
                     if grads[k] is None or not torch.any(grads[k])]
        unmoved = [k for k in main if not moved[k] and k not in zero_grad]
        first, last = _floats(metrics[0]), _floats(metrics[-1])
        row = {
            "model": MODEL, "weights": "trained (ckpts/bench_default)",
            "transform_dtype": "bfloat16_mixed", "optimizer": "adam",
            "lambda": LMBDA, "metric": "mse",
            "batch": [TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 3],
            "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_STEPS,
            "step_ms": {"median": float(np.median(timed)),
                        "min": min(timed), "max": max(timed)},
            "first_step_ms": ms[0], "peak_mem_gib": peak,
            "profiled_step": {"device_busy_ms": busy,
                              "annotations_ms": spans,
                              "idle_share": 1.0 - busy / np.median(timed),
                              "kernel_launches": sum(r[1] for r in rows),
                              "top": [[k[:70], t, c]
                                      for t, c, k in rows[:8]]},
            "first": first, "last": last,
            "main_tensors_moved": sum(moved[k] for k in main),
            "main_tensors": len(main),
            "main_tensors_zero_gradient": zero_grad,
            "quantiles_moved": moved["entropy_bottleneck.quantiles"],
            "quantiles_rd_gradient": "exactly zero",
            "launches": counts}
        finite = all(np.isfinite(v) for m in (first, last)
                     for v in m.values())
        if not finite or any(counts.values()) or unmoved \
                or not row["quantiles_moved"]:
            print(json.dumps({"train": row}), flush=True)
            raise AssertionError(f"training: finite {finite}, launches "
                                 f"{counts}, main tensors not moved "
                                 f"{unmoved}, quantiles moved "
                                 f"{row['quantiles_moved']}")
        row["resume"] = check_resume(tr, batches[n + 1:n + 3], state)
        row["cpu_step"] = check_cpu_step(state, pool)
    print(json.dumps({"train": row}), flush=True)
    return tr, counts


def serve_after_training(trainer, frames) -> dict:
    """``Codec.update`` on the fine-tuned weights, then one 512-lane
    request of the dead-leaves batch ``frames``: bit-exact (``serve``),
    K1-K4, K6 and K7 launched; the codec's real bpp beside the trainer's
    likelihood estimate on the same frames (the JAX package's: the mass of
    [y - 1/2, y + 1/2] around the unrounded latent, mlicpp.py:205) and the
    information content of the coded symbols.  Returns the launch
    counts."""
    import torch

    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.ops import _build
    _build.reset_launch_counts()
    codec = Codec(trainer.model, n_lanes=N_LANES, device="cuda")
    codec.update()
    row = serve(codec, [frames])[0]
    counts = _build.launch_counts()
    est = trainer.evaluate([f.astype(np.float32) / 255.0 for f in frames])
    # The information content of the y symbols the codec coded, each under
    # the Gaussian of its table scale: between the two, it shows whether a
    # gap lies in the coder or in the estimate.
    model = codec.model
    y, z_sym = model.analyze(torch.from_numpy(frames).cuda())
    _, sym, idx = model.codec_encode_pass(y, z_sym)
    sig, v = model.scale_table[idx.long()], sym.double()
    p = (torch.special.ndtr((v + 0.5) / sig) - torch.special.ndtr(
        (v - 0.5) / sig)).clamp(min=2.0 ** -16)
    y_bits_bpp = float(-torch.log2(p).sum()) / frames[..., 0].size
    missing = [k for k, v in counts.items()
               if v <= 0 and k != "fused_block_tail"]
    print(json.dumps({"serve_after_training": {
        "bpp": row["bpp"], "likelihood_bpp": est["bpp"],
        "coded_y_symbols_information_bpp": y_bits_bpp,
        "escape_share": row["escape_share"], "psnr_eval_forward": est["psnr"],
        "ms_ssim_eval_forward": est.get("ms_ssim"), "launches": counts}}),
        flush=True)
    if missing:
        raise AssertionError(f"kernels not launched serving the fine-tuned "
                             f"weights: {missing}")
    return counts


def vbr_model(state, transform_dtype, **overrides):
    """MLICPP_S_VBR with every leaf it shares with the trained MLICPP_S
    taken from ``state`` (``load_matching``); Gain stays at gain_init,
    QuantABCD at its seeded draw.  Returns (model, names taken)."""
    import torch

    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.utils.checkpoint import load_matching
    from mlic_tpu_torch.weights import init_params
    model = get_model(VBR_MODEL, transform_dtype=transform_dtype,
                      **overrides)
    own = init_params(model, torch.Generator().manual_seed(SEED))
    merged, taken = load_matching(own, state)
    model.load_state_dict(merged)
    return model, taken


def vbr_request(codec, x, s: int, inputscale: float = 0.0) -> tuple:
    """One VBR request, compress then decompress at the level: bit-exact
    y_hat and x_hat, finite, the input's shape.  Returns (row, encoded)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = codec.compress(x, s=s, inputscale=inputscale)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dec = codec.decompress(enc["strings"], enc["shape"], s=s,
                           inputscale=inputscale)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not (torch.equal(enc["y_hat"], dec["y_hat"])
            and torch.equal(enc["x_hat"], dec["x_hat"])):
        raise AssertionError(f"VBR level {s}, inputscale {inputscale}: the "
                             "decoder's y_hat or x_hat differs")
    if tuple(dec["x_hat"].shape) != tuple(x.shape) \
            or not bool(torch.isfinite(dec["x_hat"]).all()):
        raise AssertionError(f"VBR level {s}: bad x_hat")
    return ({"level": s, "inputscale": inputscale,
             "gain": float(codec._scale_for(s, inputscale)),
             **stream_stats(codec, enc), "encode_ms": (t1 - t0) * 1e3,
             "decode_ms": (t2 - t1) * 1e3}, enc)


def vbr_options_request(x, name: str = VBR_MODEL) -> dict:
    """``vr_entbttlnck`` and ``quant_offset`` on seeded weights: the
    bottleneck's quantiles widened to +-1400 and zqstep set to give a step
    near 1.0 at the top level and 0.5 at level 0, so level 0's
    factorized-prior rows outgrow the Gaussian rows' width.  Codes the top
    level, then level 0 (the codec rebuilds the cached step at the wider
    width), then decodes the top level's stream again."""
    import torch

    from mlic_tpu_torch.codec import Codec
    model = seeded_model(name, "bfloat16", vr_entbttlnck=True,
                         quant_offset=True)
    top = len(model.cfg.gain_init) - 1
    with torch.no_grad():
        q = model.entropy_bottleneck.quantiles
        q[:, 0, 0], q[:, 0, 2] = q[:, 0, 1] - 1400.0, q[:, 0, 1] + 1400.0
        model.zqstep_0.weight.fill_(1.0)
        model.zqstep_0.bias.zero_()
        model.zqstep_1.weight.copy_(torch.eye(10))
        model.zqstep_1.bias.zero_()
        # softplus(0.6097 - 0.06835 / gain): 1.0 at gain 1; 0.5 at 0.0656,
        # and at any smaller gain by the bound
        model.zqstep_2.weight.fill_(-0.06835 / 10)
        model.zqstep_2.bias.fill_(0.6097)
    codec = Codec(model, n_lanes=N_LANES, device="cuda")
    codec.update()
    rows, widths = [], []
    first = None
    for s in (top, 0):
        row, enc = vbr_request(codec, x, s)
        first = first or enc
        row["z_step"] = codec._z_qs_for(s, 0.0)
        rows.append(row)
        widths.append(codec.tables["cdf_rows"].shape[1])
    dec = codec.decompress(first["strings"], first["shape"], s=top)
    again = torch.equal(dec["y_hat"], first["y_hat"])
    out = {"model": name, "weights": "seeded, quantiles +-1400",
           "vr_entbttlnck": True,
           "quant_offset": True, "requests": rows, "row_widths": widths,
           "z_steps_row": codec.z_steps_row,
           "top_level_decodes_after_ratchet": again}
    if not (widths[1] > widths[0] and again):
        print(json.dumps({"vbr_options": out}), flush=True)
        raise AssertionError(f"VBR options: widths {widths}, first stream "
                             f"decodes after the ratchet: {again}")
    return out


def vbr_serve_path(state, frames, fixed_codec) -> tuple:
    """Path 4: MLICPP_S_VBR under ``bfloat16`` at 512 lanes on the trained
    weights (load_matching), one batch of 8 frames at every level and at
    ``inputscale`` VBR_INPUTSCALE, twice (the second round timed); each
    request bit-exact, K7, K3, K6 and K4 launched; level 5's streams equal
    to the MLICPP_S codec's on the same frames; bpp rising with the level.
    Then a profile of levels 0 and 5 (the port's kernels' device time per
    request), ``evaluate_codec_vbr`` over one frame at levels 0 and 5
    through files, and the options request.  Returns (launch counts of
    the coded requests, {level: profile})."""
    import torch

    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.eval import evaluate_codec_vbr
    from mlic_tpu_torch.ops import _build
    model, taken = vbr_model(state, "bfloat16")
    if len(taken) != len(state) or not torch.equal(
            model.Gain.detach().cpu(), torch.tensor(model.cfg.gain_init)):
        raise AssertionError(f"VBR weights: {len(taken)} of {len(state)} "
                             "trained leaves taken, or Gain != gain_init")
    x = frames[0]
    requests = [(s, 0.0) for s in range(len(model.cfg.lmbda))]
    requests.append((0, VBR_INPUTSCALE))
    fixed = fixed_codec.compress(x)["strings"]
    _build.reset_launch_counts()
    codec = Codec(model, n_lanes=N_LANES, device="cuda")
    codec.update()
    rows = []
    for rnd in range(2):
        for s, isc in requests:
            before = _build.launch_counts()
            row, enc = vbr_request(codec, x, s, isc)
            after = _build.launch_counts()
            row["launches"] = {k: after[k] - before[k] for k in after}
            check_request_launches(row["launches"], model.cfg,
                                   f"VBR level {s}, inputscale {isc}")
            if s == VBR_TOP and not isc and enc["strings"] != fixed:
                raise AssertionError("VBR level 5 (gain 1.0): streams "
                                     "differ from the MLICPP_S codec's")
            if rnd == 1:
                rows.append(row)
    counts = _build.launch_counts()
    bpp = [r["bpp"] for r in rows[:len(model.cfg.lmbda)]]
    profiles = {}
    for s in (0, VBR_TOP):
        r = rows[s]
        # the request's kernels ran on the card by their own device-side
        # counts; the trace gives the times
        profiles[s], _ = device_proof(
            lambda: profile_request(
                codec, x, {"compress": r["encode_ms"],
                           "decompress": r["decode_ms"]},
                label=f"profile_vbr_level_{s}", level={"s": s}),
            f"profiled VBR level {s}", {k: 1 for k in REQUEST_KERNELS})
    with tempfile.TemporaryDirectory() as d:
        ev = evaluate_codec_vbr(codec, [x[0].astype(np.float32) / 255.0], d,
                                levels=[0, VBR_TOP], log=lambda line: None)
        headers = {}
        for s in (0, VBR_TOP):
            with open(os.path.join(d, f"level_{s}", "img_000.bin"), "rb") as f:
                headers[s] = list(np.frombuffer(f.read(16), ">u4"))
    options = vbr_options_request(x)
    out = {"model": VBR_MODEL, "weights": "trained MLICPP_S (load_matching)",
           "transform_dtype": "bfloat16", "lanes": N_LANES,
           "batch": list(x.shape), "leaves_taken": len(taken),
           "gain": list(model.cfg.gain_init), "levels": rows,
           "bpp_by_level": bpp, "level_5_streams_equal_MLICPP_S": True,
           "launches": counts,
           "evaluate_codec_vbr": {str(k): v for k, v in ev.items()},
           "file_headers": {str(k): [int(v) for v in h]
                            for k, h in headers.items()},
           "options": options}
    print(json.dumps({"vbr_serve": out}), flush=True)
    if any(b >= a for a, b in zip(bpp[1:], bpp[:-1])):
        raise AssertionError(f"VBR bpp does not rise with the level: {bpp}")
    if not ev[0]["bpp"] < ev[VBR_TOP]["bpp"] or any(
            headers[s][2] != s for s in headers):
        raise AssertionError(f"evaluate_codec_vbr: {ev}, headers {headers}")
    return counts, profiles


def vbr_cpu_step(state, pool) -> dict:
    """One f32 MGDA step of MLICPP_S_VBR at batch 1, 128x128, on the card
    and on the CPU, with the same noise: the loss (mean over levels), each
    level's loss and the gradient's global norm within path 3's relative
    tolerances."""
    from mlic_tpu_torch.models.config import model_config
    from mlic_tpu_torch.train.trainer import TrainConfig, create_train_state
    from mlic_tpu_torch.train.vbr import vbr_train_step
    import torch
    b, h, w, _ = CPU_STEP_SHAPE
    x = pool[:b, :h, :w]
    noise = torch.from_numpy(np.random.default_rng(SEED + 11).uniform(
        -0.5, 0.5, (model_config(VBR_MODEL).N, b * (h // 64) * (w // 64))
    ).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        model, _ = vbr_model(state, "float32")
        cfg = TrainConfig(lmbda=LMBDA, seed=SEED)
        m = vbr_train_step(create_train_state(model, cfg, dev), x, cfg,
                           noise=noise.to(dev))
        out[dev] = {"loss": float(m["loss"]),
                    "loss_per_level": m["loss_per_level"].tolist(),
                    "grad_norm": float(m["grad_norm"]),
                    "alpha": m["alpha"].tolist()}
    per_level = max(abs(a - c) / abs(c) for a, c in zip(
        out["cuda"]["loss_per_level"], out["cpu"]["loss_per_level"]))
    row = {"shape": list(CPU_STEP_SHAPE), **out,
           "loss_rel_diff": abs(out["cuda"]["loss"] - out["cpu"]["loss"])
           / abs(out["cpu"]["loss"]),
           "level_loss_max_rel_diff": per_level,
           "grad_norm_rel_diff": abs(out["cuda"]["grad_norm"]
                                     - out["cpu"]["grad_norm"])
           / out["cpu"]["grad_norm"],
           "tolerances": [CPU_LOSS_RTOL, CPU_GRAD_NORM_RTOL]}
    if not (row["loss_rel_diff"] <= CPU_LOSS_RTOL
            and per_level <= CPU_LOSS_RTOL
            and row["grad_norm_rel_diff"] <= CPU_GRAD_NORM_RTOL):
        print(json.dumps({"vbr_cpu_step": row}), flush=True)
        raise AssertionError(f"f32 MGDA step on the card differs from the "
                             f"CPU: {row}")
    return row


def vbr_train_path(state) -> dict:
    """Path 5: MGDA multi-rate training of MLICPP_S_VBR from the trained
    weights under ``bfloat16_mixed``, Adam, batches of 8 random 256x256
    crops of path 3's dead-leaves pool, all 6 levels a step: VBR_TRAIN_STEPS
    steps timed, peak memory, losses finite, alpha on the simplex, no
    kernel launched; then the f32 step against the CPU.  Returns the
    launch counts."""
    import torch

    from mlic_tpu_torch.data.folder import dead_leaves_pool, pool_batches
    from mlic_tpu_torch.ops import _build
    from mlic_tpu_torch.train.trainer import TrainConfig, create_train_state
    from mlic_tpu_torch.train.vbr import vbr_train_step
    pool = dead_leaves_pool(TRAIN_POOL, TRAIN_POOL_SIZE, SEED + 9,
                            cache_dir="")
    batches = list(pool_batches(pool, TRAIN_BATCH, TRAIN_PATCH,
                                VBR_TRAIN_STEPS, seed=SEED + 2))
    with torch.enable_grad():
        model, _ = vbr_model(state, "bfloat16_mixed")
        cfg = TrainConfig(lmbda=LMBDA, metric="mse", optimizer="adam",
                          seed=SEED)
        st = create_train_state(model, cfg, "cuda")
        _build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        ms, metrics = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = vbr_train_step(st, b, cfg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: v.tolist() for k, v in m.items()})
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        row = {"model": VBR_MODEL, "weights": "trained MLICPP_S "
               "(load_matching)", "transform_dtype": "bfloat16_mixed",
               "optimizer": "adam", "metric": "mse",
               "levels": len(model.cfg.lmbda), "lmbda": list(model.cfg.lmbda),
               "batch": [TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 3],
               "step_ms": ms, "peak_mem_gib": peak, "steps": metrics,
               "launches": counts}
        row["cpu_step"] = vbr_cpu_step(state, pool)
    print(json.dumps({"vbr_train": row}), flush=True)
    finite = all(np.isfinite(m["loss_per_level"]).all()
                 and np.isfinite(m["grad_norm"]) for m in metrics)
    simplex = all(min(m["alpha"]) >= 0 and abs(sum(m["alpha"]) - 1) < 1e-5
                  for m in metrics)
    if not finite or not simplex or any(counts.values()):
        raise AssertionError(f"VBR training: finite {finite}, alpha on the "
                             f"simplex {simplex}, launches {counts}")
    return counts


def l_path(frames, pool, k8_all: list, contracts: list) -> dict:
    """Path 6: MLICPP_L on its trained weights (the ``weights_L`` line),
    under ``bfloat16`` at 512 lanes: ``Codec.update``, the N_REQUESTS
    batches of path 1 and one batch of L_BIG_BATCH frames (path 1's 16 and
    their mirror images), each bit-exact with the launches the
    configuration gives (K4 1 + 2 * 10 a decompress); then the whole and
    staged times, a profile, g_s's device time at batch 8, K1-K4, K6 and
    K7 against their plain versions on a payload of L's shapes
    (``check_kernels`` without its extras), and
    ``evaluate_codec`` over L_EVAL_FRAMES frames under ``bfloat16_mixed``
    with the fused tails (K5 as many times an image as the model has
    fusable tails in g_a and, twice, in g_s), and a profile of one
    ``decompress_one_image`` there.  Between, the batch contract at
    L_BIG_BATCH (``batch_contract_phase``, into ``contracts``) and K8 at L's
    product shapes (``k8_cases``, into ``k8_all``).  Returns the launch
    counts and g_s's ms, the kernels' rows at L's shapes and the trained
    state_dict."""
    import torch

    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.eval import decompress_one_image, evaluate_codec
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.ops import _build
    t_path = time.perf_counter()
    state = load_trained(L_CHECKPOINT, L_MODEL, L_CKPT_ARRAYS, None,
                         "weights_L")
    model = get_model(L_MODEL, transform_dtype="bfloat16")
    model.load_state_dict(state, strict=True)
    cfg = model.cfg
    big = np.ascontiguousarray(np.concatenate([pool, pool[:, :, ::-1]]))
    _build.reset_launch_counts()
    codec = Codec(model, n_lanes=N_LANES, device="cuda")
    t0 = time.perf_counter()
    codec.update()
    update_s = time.perf_counter() - t0
    in_update = _build.launch_counts()
    rows = serve(codec, frames, "L", cfg)
    rows += serve(codec, [big], f"L_batch_{L_BIG_BATCH}", cfg)
    counts = _build.launch_counts()
    contracts.append(batch_contract_phase(codec, big, L_MODEL))
    k8_all += k8_cases(codec, frames[0], L_MODEL, timed_at=(L_BIG_BATCH,))
    if not (in_update["select_rows"] and in_update["eval_cdf"]):
        raise AssertionError(f"path 6: update launched {in_update}")
    missing = [k for k, v in counts.items()
               if v <= 0 and k != "fused_block_tail"]
    if missing:
        raise AssertionError(f"kernels not launched on path 6: {missing}")
    wall_ms = stage_times(codec, frames, "stage_split_L")
    prof = profile_request(codec, frames[0], wall_ms, label="profile_L")
    enc = codec.compress(frames[0])
    g_s_ms = cuda_ms(lambda: model.synthesize(enc["y_hat"]), 5)
    del enc
    # K1-K4, K6 and K7 against their plain versions at L's coding shapes,
    # which no MLICPP_S codec gives them: 20 y phases, a z of 192 channels,
    # about twice the encode steps.
    kernel_rows = check_kernels(codec, counts, extras=False)
    print(json.dumps({"kernels_at_L": kernel_rows}), flush=True)
    del codec

    os.environ[FUSED_SWITCH] = "1"
    fused = get_model(L_MODEL, transform_dtype="bfloat16_mixed")
    fused.load_state_dict(state, strict=True)
    per_image = k5_per_image(cfg, "bfloat16_mixed")
    images = [f.astype(np.float32) / 255.0 for f in pool[:L_EVAL_FRAMES]]
    _build.reset_launch_counts()
    ecodec = Codec(fused, device="cuda")        # n_lanes="auto"
    ecodec.update()
    with tempfile.TemporaryDirectory() as d:
        res = evaluate_codec(ecodec, images, d, log=lambda line: None)
        eval_counts = _build.launch_counts()
        decode_prof = kernels_in(lambda: decompress_one_image(
            ecodec, os.path.join(d, "img_000.bin")))
    os.environ.pop(FUSED_SWITCH)
    out = {"model": L_MODEL, "weights": "trained (ckpts/"
           "bench_default_MLICPP_L)", "transform_dtype": "bfloat16",
           "lanes": N_LANES, "update_s": update_s,
           "launches_in_update": in_update, "launches": counts,
           "launches_a_request": request_launches(cfg),
           "requests": rows, "g_s_ms_batch_8": g_s_ms,
           "profile_decompress_k4": prof["decompress"][
               "port_kernels_ms_launches"]["rans_decode_phase"],
           "eval": {"transform_dtype": "bfloat16_mixed", FUSED_SWITCH: "1",
                    "lanes_resolved": ecodec.n_lanes, "average": res,
                    "launches": eval_counts, "k5_per_image": per_image,
                    "decompress_one_image_profile": decode_prof},
           "path_s": time.perf_counter() - t_path}
    print(json.dumps({"l_path": out}), flush=True)
    k5_decode = decode_prof["port_kernels_ms_launches"]["fused_block_tail"]
    if eval_counts["fused_block_tail"] != per_image * len(images) \
            or k5_decode[1] != len(fused_tails(cfg, "bfloat16_mixed",
                                               "g_s")):
        raise AssertionError(f"path 6 eval: K5 launched "
                             f"{eval_counts['fused_block_tail']} times "
                             f"({per_image} an image expected), "
                             f"{k5_decode[1]} in one decode")
    bad = [k for k in ("bpp", "psnr", "ms_ssim") if not np.isfinite(res[k])]
    if bad or res["n_images"] != len(images):
        raise AssertionError(f"path 6 eval: {res}")
    return {"serve": counts, "eval": eval_counts, "g_s_ms": g_s_ms,
            "kernels": kernel_rows, "state": state,
            "first_batch": {k: rows[0][k] for k in ("bpp",
                                                    "streams_sha256")}}


def decoder_only(frames) -> dict:
    """The decoder-only deployment of the small decoder, fixed rate and
    its VBR twin at level SD_FILE_LEVEL, under ``bfloat16_mixed`` with the
    fused tails: the seeded weights saved as a torch file,
    ``tools.extract_decoder`` to a decoder-only file, one frame written by
    ``compress_one_image``, ``python -m mlic_tpu_torch.tools.decode`` in a
    subprocess on the card, whose PNG must hold the encoder side's x_hat
    rounded; then one in-process ``decompress_one_image`` by a codec of
    the decoder-only weights (the CLI's ``decoder_state``), profiled: x_hat
    equal to the encoder's, K5 launched once a fusable tail of g_s, at
    (320, 320) and (48, 48), and g_a, h_a still zero."""
    from collections import Counter

    import torch
    from PIL import Image

    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.eval import compress_one_image, decompress_one_image
    from mlic_tpu_torch.models import layers
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.tools import decode, extract_decoder
    os.environ[FUSED_SWITCH] = "1"
    x = frames[0][:1].astype(np.float32) / 255.0
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, level in ((SD_MODEL, None), (SD_VBR_MODEL, SD_FILE_LEVEL)):
            model = seeded_model(name, "bfloat16_mixed")
            full = os.path.join(d, f"{name}.pt")
            dec_file = os.path.join(d, f"{name}_decoder.pt")
            torch.save(model.state_dict(), full)
            kept = extract_decoder.main(["--checkpoint", full,
                                         "--out", dec_file])
            bits, pngs = (os.path.join(d, f"{name}_{k}")
                          for k in ("bits", "png"))
            os.makedirs(bits)
            path = os.path.join(bits, "img_000.bin")
            enc = compress_one_image(Codec(model, device="cuda"), x, path,
                                     s=level)
            del model
            cmd = [sys.executable, "-m", "mlic_tpu_torch.tools.decode",
                   "--model", name, "--bitstream-dir", bits, "--output-dir",
                   pngs, "--checkpoint", dec_file, "--transform-dtype",
                   "bfloat16_mixed"] + (["--vbr"] if level is not None
                                        else [])
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=REPO, capture_output=True,
                                  text=True, timeout=600,
                                  env=dict(os.environ, **{FUSED_SWITCH: "1"}))
            cli_s = time.perf_counter() - t0
            if proc.returncode:
                raise AssertionError(f"decode CLI failed ({proc.returncode})"
                                     f": {proc.stderr[-3000:]}")
            png = np.asarray(Image.open(os.path.join(pngs, "img_000.png")))
            want = np.clip(enc["x_hat_enc"][0] * 255.0 + 0.5, 0,
                           255).astype(np.uint8)

            dm = get_model(name, transform_dtype="bfloat16_mixed")
            dm.load_state_dict(decode.decoder_state(dm, dec_file))
            dcodec = Codec(dm, device="cuda")
            dcodec.update()
            decompress_one_image(dcodec, path, vbr=level is not None)
            widths, plain = Counter(), layers.fused_block_tail

            def recording(mid, skip, *args, **kw):
                widths[f"{mid.shape[1]}x{skip.shape[1]}"] += 1
                return plain(mid, skip, *args, **kw)

            got = {}
            layers.fused_block_tail = recording
            try:
                prof = kernels_in(lambda: got.update(decompress_one_image(
                    dcodec, path, vbr=level is not None)))
            finally:
                layers.fused_block_tail = plain
            encoder_zero = all(not bool(t.any()) for k, t in
                               dm.state_dict().items()
                               if extract_decoder.is_encoder(k))
            k5 = prof["port_kernels_ms_launches"]["fused_block_tail"]
            tails = fused_tails(dm.cfg, "bfloat16_mixed", "g_s")
            want_widths = Counter(f"{c}x{n}" for c, n in tails)
            row = {"model": name, "level": level, "frame": list(x.shape),
                   "bpp": enc["bpp"], "decoder_leaves": len(kept),
                   "cli_s": cli_s, "cli_stdout": proc.stdout.strip()[-300:],
                   "png_equals_encoder_x_hat": bool(np.array_equal(png,
                                                                   want)),
                   "in_process_x_hat_bit_exact": bool(np.array_equal(
                       got["x_hat"], enc["x_hat_enc"])),
                   "k5_widths": dict(widths),
                   "k5_widths_by_the_rule": dict(want_widths),
                   "k5_launches_profiled": k5[1],
                   "k5_ms": k5[0], "decode_profile": prof,
                   "g_a_h_a_zero": encoder_zero}
            out[name] = row
            if not (row["png_equals_encoder_x_hat"]
                    and row["in_process_x_hat_bit_exact"] and encoder_zero
                    and widths == want_widths and k5[1] == len(tails)
                    and widths["320x320"] and widths["48x48"]):
                print(json.dumps({"decoder_only": out}), flush=True)
                raise AssertionError(f"decoder-only deployment of {name}: "
                                     f"{row}")
    os.environ.pop(FUSED_SWITCH)
    return out


def sd_path(frames, l_g_s_ms: float, k8_all: list, contracts: list) -> dict:
    """Path 7: the small-decoder family at full width on seeded weights.
    MLICPP_M_SMALL_DEC under ``bfloat16`` at 512 lanes: SD_BATCHES batches
    of 8 frames, bit-exact with the configuration's launches, and g_s's
    device time at batch 8 beside path 6's L g_s; MLICPP_M_SMALL_DEC_VBR:
    one batch at each level and at ``inputscale`` VBR_INPUTSCALE, each
    bit-exact with those launches, bpp at the top level (gain 1.0) above
    level 0's; the ``vr_entbttlnck`` + ``quant_offset`` request whose
    lowest level (gain 0.002424) widens the rows; the decoder-only
    deployment.  After its batches, the batch contract at 8 and K8 at its
    product shapes (into ``contracts`` and ``k8_all``).  Returns the launch
    counts of the whole path."""
    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.ops import _build
    t_path = time.perf_counter()
    _build.reset_launch_counts()
    model = seeded_model(SD_MODEL, "bfloat16")
    codec = Codec(model, n_lanes=N_LANES, device="cuda")
    codec.update()
    rows = serve(codec, frames[:SD_BATCHES], "small_decoder", model.cfg)
    contracts.append(batch_contract_phase(codec, frames[0], SD_MODEL))
    k8_all += k8_cases(codec, frames[0], SD_MODEL, timed_at=(8,))
    enc = codec.compress(frames[0])
    g_s_ms = cuda_ms(lambda: model.synthesize(enc["y_hat"]), 5)
    del enc, codec, model

    vbr = seeded_model(SD_VBR_MODEL, "bfloat16")
    vcodec = Codec(vbr, n_lanes=N_LANES, device="cuda")
    vcodec.update()
    top = len(vbr.cfg.gain_init) - 1            # gain 1.0
    levels = [(s, 0.0) for s in range(top + 1)]
    levels.append((0, VBR_INPUTSCALE))
    vrows = []
    for s, isc in levels:
        before = _build.launch_counts()
        row, _ = vbr_request(vcodec, frames[0], s, isc)
        after = _build.launch_counts()
        row["launches"] = {k: after[k] - before[k] for k in after}
        check_request_launches(row["launches"], vbr.cfg,
                               f"{SD_VBR_MODEL} level {s}, inputscale {isc}")
        vrows.append(row)
    del vcodec, vbr
    options = vbr_options_request(frames[0], SD_VBR_MODEL)
    deployed = decoder_only(frames)
    counts = _build.launch_counts()
    out = {"model": SD_MODEL, "weights": "seeded random",
           "transform_dtype": "bfloat16", "lanes": N_LANES,
           "requests": rows, "g_s_ms_batch_8": g_s_ms,
           "l_g_s_ms_batch_8": l_g_s_ms,
           "vbr": {"model": SD_VBR_MODEL, "levels": vrows,
                   "bpp_by_level": [r["bpp"] for r in vrows[:top + 1]],
                   "options": options},
           "decoder_only": deployed, "launches": counts,
           "path_s": time.perf_counter() - t_path}
    print(json.dumps({"sd_path": out}), flush=True)
    if not vrows[top]["bpp"] > vrows[0]["bpp"]:
        raise AssertionError(f"{SD_VBR_MODEL}: bpp at the top level "
                             f"{vrows[top]['bpp']} not above level 0's "
                             f"{vrows[0]['bpp']}")
    return counts


def host_request(codec, x, s: int = 0, inputscale: float = 0.0,
                 host_s: list | None = None) -> tuple:
    """One request through a host-coded backend (steps or fused): compress
    then decompress, y_hat and x_hat bit-exact, finite, the input's shape.
    ``host_s`` (a one-element list the timing wrappers of
    ``TimedHostCoder`` add to) splits each direction's host-coder
    seconds off.  Returns (row, encoded, decoded)."""
    import torch
    spent = host_s if host_s is not None else [0.0]
    torch.cuda.synchronize()
    spent[0] = 0.0
    t0 = time.perf_counter()
    enc = codec.compress(x, s=s, inputscale=inputscale)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host_enc, spent[0] = spent[0], 0.0
    dec = codec.decompress(enc["strings"], enc["shape"], s=s,
                           inputscale=inputscale)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not (torch.equal(enc["y_hat"], dec["y_hat"])
            and torch.equal(enc["x_hat"], dec["x_hat"])):
        n = int((enc["y_hat"] != dec["y_hat"]).sum())
        raise AssertionError(f"{codec.backend} backend, level {s}, "
                             f"inputscale {inputscale}: the decoder's y_hat "
                             f"differs at {n} entries, or its x_hat")
    if tuple(dec["x_hat"].shape) != tuple(x.shape) \
            or not bool(torch.isfinite(dec["x_hat"]).all()):
        raise AssertionError(f"{codec.backend} backend: bad x_hat")
    n_bytes = sum(len(b) for group in enc["strings"] for b in group)
    b, h, w = x.shape[:3]
    row = {"backend": codec.backend, "level": s, "inputscale": inputscale,
           "bpp": 8.0 * n_bytes / (b * h * w),
           "z_bytes": sum(len(z) for z in enc["strings"][1]),
           "encode_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3,
           "encode_host_coder_ms": host_enc * 1e3,
           "decode_host_coder_ms": spent[0] * 1e3}
    row["encode_host_share"] = row["encode_host_coder_ms"] / row["encode_ms"]
    row["decode_host_share"] = row["decode_host_coder_ms"] / row["decode_ms"]
    return row, enc, dec


class TimedHostCoder:
    """While active, the host rANS coder's entry points that the codec
    calls add their seconds to ``self.spent[0]``."""

    def __init__(self):
        from mlic_tpu_torch import codec
        from mlic_tpu_torch.entropy.rans import coder
        self.spent = [0.0]
        self.targets = [(codec, "encode_with_indexes"),
                        (codec, "decode_with_indexes"),
                        (coder.RansDecoder, "decode_stream")]
        self.saved = [getattr(o, n) for o, n in self.targets]

    def __enter__(self):
        spent = self.spent

        def timed(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kw):
                t = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    spent[0] += time.perf_counter() - t
            return wrapper
        for (obj, name), fn in zip(self.targets, self.saved):
            setattr(obj, name, timed(fn))
        return self.spent

    def __exit__(self, *exc):
        for (obj, name), fn in zip(self.targets, self.saved):
            setattr(obj, name, fn)


def host_coded_clis(model, frame) -> dict:
    """One frame through ``python -m mlic_tpu_torch.tools.test --backend
    steps`` into a folder, read back by ``tools.decode`` (which tells the
    streams' kind from the files; both subprocesses on the card, the
    trained weights): the PNG must equal the encoder's x_hat rounded, and
    the file the bytes that an in-process steps codec writes for the
    frame."""
    from PIL import Image

    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.eval import compress_one_image
    common = ["--model", MODEL, "--checkpoint", CHECKPOINT,
              "--transform-dtype", "bfloat16"]
    with tempfile.TemporaryDirectory() as d:
        images, bits, pngs = (os.path.join(d, k)
                              for k in ("images", "bits", "png"))
        os.makedirs(images)
        Image.fromarray(frame).save(os.path.join(images, "frame.png"))
        secs = {}
        for name, args in (
                ("test", ["--dataset", images, "--save-dir", bits,
                          "--backend", "steps"]),
                ("decode", ["--bitstream-dir", bits, "--output-dir", pngs])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", f"mlic_tpu_torch.tools.{name}",
                 *common, *args], cwd=REPO, capture_output=True, text=True,
                timeout=600)
            secs[name] = time.perf_counter() - t0
            if proc.returncode:
                raise AssertionError(f"tools.{name} on steps streams failed "
                                     f"({proc.returncode}): "
                                     f"{proc.stderr[-3000:]}")
        path = os.path.join(bits, "img_000.bin")
        again = os.path.join(d, "again.bin")
        enc = compress_one_image(Codec(model, device="cuda",
                                       backend="steps"),
                                 frame[None].astype(np.float32) / 255.0,
                                 again)
        png = np.asarray(Image.open(os.path.join(pngs, "img_000.png")))
        with open(path, "rb") as f, open(again, "rb") as g:
            same_file = f.read() == g.read()
    want = np.clip(enc["x_hat_enc"][0] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    row = {"frame": list(frame.shape), "bpp": enc["bpp"], "cli_s": secs,
           "file_equals_in_process": same_file,
           "png_equals_encoder_x_hat": bool(np.array_equal(png, want))}
    if not (same_file and row["png_equals_encoder_x_hat"]):
        raise AssertionError(f"the steps backend's CLIs: {row}")
    return row


def host_coded_path(state, model, frames, dev_codec) -> dict:
    """Path 8, the reference's codec: the trained MLICPP_S (path 1's model)
    through ``backend="steps"`` and ``"fused"`` on path 1's first batch,
    twice (the second timed): each round trip bit-exact, steps and fused
    byte-identical, both reconstructing path 1's device-backend y_hat and
    x_hat; no kernel launched but K8 (the context's products, on the card
    whichever backend codes), in ``update`` or a request.  bpp beside the
    v4 stream's, ms a direction and the host coder's share of it, the
    coder built (``rans_backend``).  Then MLICPP_S_VBR on the trained
    weights at level VBR_HOST_LEVEL and the seeded ``vr_entbttlnck`` +
    ``quant_offset`` model at its top level and level 0 through steps, and
    the two CLIs (``host_coded_clis``).  Returns the launch counts."""
    import torch

    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.entropy.rans import coder, rans_backend
    from mlic_tpu_torch.ops import _build
    t_path = time.perf_counter()
    x = frames[0]
    ref = dev_codec.compress(x)
    ref_dec = dev_codec.decompress(ref["strings"], ref["shape"])
    backend = rans_backend()
    _build.reset_launch_counts()
    rows, streams = {}, {}
    with TimedHostCoder() as spent:
        for name in ("steps", "fused"):
            codec = Codec(model, device="cuda", backend=name)
            codec.update()
            for _ in range(2):
                row, enc, dec = host_request(codec, x, host_s=spent)
            row["y_hat_equals_device_backend"] = torch.equal(enc["y_hat"],
                                                             ref["y_hat"])
            row["x_hat_equals_device_backend"] = torch.equal(
                dec["x_hat"], ref_dec["x_hat"])
            row["y_hat_entries_differing"] = int(
                (enc["y_hat"] != ref["y_hat"]).sum())
            rows[name], streams[name] = row, enc["strings"]
            print(json.dumps({"host_coded_request": row}), flush=True)
        counts = _build.launch_counts()
        vmodel, _ = vbr_model(state, "bfloat16")
        vbr_row = host_request(Codec(vmodel, device="cuda", backend="steps"),
                               x, VBR_HOST_LEVEL, host_s=spent)[0]
        del vmodel
        omodel = seeded_model(VBR_MODEL, "bfloat16", vr_entbttlnck=True,
                              quant_offset=True)
        ocodec = Codec(omodel, device="cuda", backend="steps")
        option_rows = [host_request(ocodec, x[:2], s, host_s=spent)[0]
                       for s in (len(omodel.cfg.gain_init) - 1, 0)]
        del omodel, ocodec
    clis = host_coded_clis(model, x[0])
    out = {"model": MODEL, "weights": "trained (ckpts/bench_default)",
           "transform_dtype": "bfloat16", "batch": list(x.shape),
           "rans_backend": backend,
           "library": os.path.relpath(coder.library_path(), REPO),
           "requests": rows, "v4_bpp": stream_stats(dev_codec, ref)["bpp"],
           "steps_fused_streams_identical": streams["steps"] ==
           streams["fused"], "launches": counts,
           "vbr": {"model": VBR_MODEL, **vbr_row},
           "options": {"model": VBR_MODEL, "weights": "seeded",
                       "vr_entbttlnck": True, "quant_offset": True,
                       "requests": option_rows},
           "clis": clis, "path_s": time.perf_counter() - t_path}
    print(json.dumps({"host_coded": out}), flush=True)
    bad = [k for k in ("y_hat_equals_device_backend",
                       "x_hat_equals_device_backend")
           for r in rows.values() if not r[k]]
    others = {k: v for k, v in counts.items() if k != "invariant_matmul"}
    if bad or not out["steps_fused_streams_identical"] \
            or any(others.values()) or not counts["invariant_matmul"]:
        raise AssertionError(f"path 8: {bad}, steps and fused identical "
                             f"{out['steps_fused_streams_identical']}, "
                             f"launches {counts}")
    return counts


def steady_begin_syncs(codec, x) -> dict:
    """Host synchronizations of one steady-state ``compress_begin``: the
    warnings of ``torch.cuda.set_sync_debug_mode("warn")``, and the
    runtime calls that wait for the device under the profiler
    (``encode_profile``; its copies are listed apart: the queued copies to
    pinned memory do not wait).  Both must be 0."""
    import warnings

    import torch
    for _ in range(2):
        codec.compress_end(codec.compress_begin(x))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            h = codec.compress_begin(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    codec.compress_end(h)
    prof = encode_profile(codec.compress_begin, x)
    torch.cuda.synchronize()
    caught = [w for w in caught if "synchroniz" in str(w.message)
              and "prototype" not in str(w.message)]
    waits = [c for c in prof["sync_calls"] if not c.startswith("cudaMemcpy")]
    out = {"sync_debug_warnings": len(caught),
           "warnings": [str(w.message)[:160] for w in caught][:5],
           "waiting_calls": waits,
           "copies": [c for c in prof["sync_calls"]
                      if c.startswith("cudaMemcpy")],
           "kernel_launches": prof["kernel_launches"]}
    if caught or waits:
        raise AssertionError(f"compress_begin synchronizes: {out}")
    return out


def pipeline_path(model, codec, frames) -> dict:
    """Path 9, the serving pipeline: ``tools.serve.main`` on the trained
    MLICPP_S at 512 lanes, SERVE_FRAMES synthetic frames in batches of 8
    with ``--verify`` and containers, then the same frames without
    (K1 and K2 in ``update``, K7, K3, K6 and K4 launched); on path 1's
    codec, ``roundtrip_stream`` over 4 batches against serial ``compress``
    + ``decompress`` (byte-identical streams, bit-identical x_hat), the
    host synchronizations of a steady-state ``compress_begin`` (0), one
    image of a batch written as a container and decoded alone by
    ``tools.decode`` (its x_hat g_s of the encoder's y_hat for the image,
    bit for bit); img/s of the pipeline and
    of the serial loop alternated over SERVE_ROUNDS rounds, and the
    card's idle share: one profiled pipelined round's device busy time
    against the unprofiled median.  Returns the launch
    counts of the CLI runs."""
    import torch

    from mlic_tpu_torch.ops import _build
    from mlic_tpu_torch.tools import decode, serve
    t_path = time.perf_counter()
    common = ["--checkpoint", CHECKPOINT, "--transform-dtype", "bfloat16",
              "--synthetic", "--batch", str(BATCH), "--lanes", str(N_LANES)]
    _build.reset_launch_counts()
    with tempfile.TemporaryDirectory() as d:
        verified = serve.main(common + ["--n", str(SERVE_FRAMES), "--verify",
                                        "--out", d])
        n_files = len(os.listdir(d))
    plain = serve.main(common + ["--n", str(SERVE_FRAMES)])
    counts = _build.launch_counts()
    missing = [k for k in ("select_rows", "eval_cdf") + REQUEST_KERNELS
               if not counts[k]]
    if missing or n_files != SERVE_FRAMES:
        raise AssertionError(f"path 9: serve CLI launched no {missing}, "
                             f"wrote {n_files} containers")

    batches = [frames[0], frames[1],
               np.ascontiguousarray(frames[0][:, :, ::-1]),
               np.ascontiguousarray(frames[1][:, ::-1])]
    serial = []
    for x in batches:
        enc = codec.compress(x)
        serial.append((enc, codec.decompress(enc["strings"], enc["shape"])))
    piped = list(codec.roundtrip_stream(batches))
    same = [g[0]["strings"] == w[0]["strings"]
            and torch.equal(g[1]["x_hat"], w[1]["x_hat"])
            and torch.equal(g[1]["x_hat"], g[0]["x_hat"])
            for g, w in zip(piped, serial)]
    syncs = steady_begin_syncs(codec, frames[1])

    enc = serial[0][0]
    with tempfile.TemporaryDirectory() as d:
        bits = os.path.join(d, "bits")
        serve._write(bits, ["frame"], 0, 1, enc, (HEIGHT, WIDTH))
        got = decode.main(["--model", MODEL, "--checkpoint", CHECKPOINT,
                           "--transform-dtype", "bfloat16",
                           "--bitstream-dir", bits,
                           "--output-dir", os.path.join(d, "png")])
    # The decoder's y_hat is the encoder's bit for bit, so its x_hat is
    # g_s of the encoder's y_hat at batch 1; g_s (bf16) of the batch of 8
    # rounds other bits, reported beside.
    single = torch.from_numpy(got["frame.bin"][0]).cuda()
    want = model.synthesize(enc["y_hat"][:1])[0]
    container_diff = int((single != want).sum())
    batch_x_hat_diff = float((single - enc["x_hat"][0]).abs().max())
    del serial, piped, enc

    def run_serial():
        for x in batches:
            e = codec.compress(x)
            codec.decompress(e["strings"], e["shape"])

    def run_pipeline():
        for _ in codec.roundtrip_stream(batches):
            pass

    img_s = {"pipeline": [], "serial": []}
    for r in range(SERVE_ROUNDS):
        order = (("pipeline", run_pipeline), ("serial", run_serial))
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            img_s[name].append(len(batches) * BATCH
                               / (time.perf_counter() - t0))
    prof = kernels_in(run_pipeline)
    wall = len(batches) * BATCH / float(np.median(img_s["pipeline"])) * 1e3
    out = {"model": MODEL, "weights": "trained (ckpts/bench_default)",
           "transform_dtype": "bfloat16", "lanes": N_LANES,
           "serve_cli_verify": verified, "serve_cli": plain,
           "containers": n_files, "launches": counts,
           "roundtrip_stream_equals_serial": same,
           "begin_syncs": syncs,
           "container_decode_x_hat_entries_differing": container_diff,
           "container_x_hat_max_abs_diff_to_batch_x_hat": batch_x_hat_diff,
           "img_s": {k: {"median": float(np.median(v)), "all": v}
                     for k, v in img_s.items()},
           "profiled_pipeline_round": {
               "unprofiled_median_wall_ms": wall,
               "device_busy_ms": prof["device_busy_ms"],
               "idle_share": 1.0 - prof["device_busy_ms"] / wall,
               "port_kernels_ms_launches": prof["port_kernels_ms_launches"]},
           "path_s": time.perf_counter() - t_path}
    print(json.dumps({"serve_pipeline": out}), flush=True)
    if not all(same) or container_diff:
        raise AssertionError(f"path 9: pipeline equal to serial {same}, "
                             f"container decode differs at "
                             f"{container_diff} entries")
    return counts


class EnvSet:
    """While active, the environment holds ``values`` (None removes a
    name); the earlier values come back after."""

    def __init__(self, **values):
        self.values = values
        self.saved = {}

    def __enter__(self):
        for k, v in self.values.items():
            self.saved[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Forced:
    """While active, the port's check ``name`` of ``Codec.update``
    (``entropy.parametric``) reports ``count`` entries differing: a
    fallback forced in this process only; the package has no switch."""

    def __init__(self, name: str, count: int = 5):
        from mlic_tpu_torch.entropy import parametric
        self.mod, self.name, self.count = parametric, name, count
        self.saved = getattr(parametric, name)

    def __enter__(self):
        setattr(self.mod, self.name, lambda *a, **k: self.count)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.saved)


def v3_request_launches(cfg) -> dict:
    """A format-v3 request's launches: K7, K3 and K6 once (no z section),
    K4 twice a slice (no z phase), K1, K2 and K5 none."""
    return {**request_launches(cfg),
            "rans_decode_phase": 2 * cfg.slice_num}


def coded_requests(codec, frames, label: str, want: dict | None = None,
                   ref=None) -> tuple:
    """Each batch of ``frames`` compressed and decompressed, bit-exact
    (y_hat and x_hat), timed whole; with ``want`` each request's launches
    must be those; with ``ref`` (a codec) the streams must be its bytes on
    the same batch.  Returns (rows, the first batch's compress result)."""
    import torch

    from mlic_tpu_torch.ops import _build
    rows, first = [], None
    for r, x in enumerate(frames):
        before = _build.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = codec.compress(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec = codec.decompress(enc["strings"], enc["shape"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after = _build.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        if not (torch.equal(enc["y_hat"], dec["y_hat"])
                and torch.equal(enc["x_hat"], dec["x_hat"])):
            raise AssertionError(f"{label} request {r}: not bit-exact")
        if want is not None and launches != want:
            raise AssertionError(f"{label} request {r}: launches {launches}"
                                 f", want {want}")
        same = None
        if ref is not None:
            same = ref.compress(x)["strings"] == enc["strings"]
            if not same:
                raise AssertionError(f"{label} request {r}: streams differ "
                                     "from the reference codec's")
        b, h, w = enc["y_hat"].shape[:3]
        n_bytes = sum(len(s) for g in enc["strings"] for s in g)
        rows.append({"path": label, "request": r, **stream_stats(codec, enc),
                     "bpp": 8.0 * n_bytes / (b * h * w * 256),
                     "z_bytes": sum(len(z) for z in enc["strings"][1]),
                     "encode_ms": (t1 - t0) * 1e3,
                     "decode_ms": (t2 - t1) * 1e3, "launches": launches,
                     "streams_equal_reference": same})
        first = enc if first is None else first
    return rows, first


def staged_shares(codec, x, stage: dict) -> dict:
    """One request with ``timings``: each direction's stages (ms) and the
    share of the named ``stage`` ({direction: stage name}) in it."""
    marks = {"compress": {}, "decompress": {}}
    enc = codec.compress(x, timings=marks["compress"])
    codec.decompress(enc["strings"], enc["shape"],
                     timings=marks["decompress"])
    out = {"stages_ms": marks}
    for direction, name in stage.items():
        out[f"{direction}_{name}_share"] = (marks[direction][name]
                                            / sum(marks[direction].values()))
    return out


def v3_container_alone(model, enc) -> int:
    """Image 0 of a format-v3 batch written as a container and decoded
    alone by ``tools.decode``: entries of its x_hat that differ from g_s
    of the encoder's y_hat for the image (0 wanted)."""
    import torch

    from mlic_tpu_torch.tools import decode, serve
    with tempfile.TemporaryDirectory() as d:
        bits = os.path.join(d, "bits")
        serve._write(bits, ["frame"], 0, 1, enc, (HEIGHT, WIDTH))
        got = decode.main(["--model", MODEL, "--checkpoint", CHECKPOINT,
                           "--transform-dtype", "bfloat16",
                           "--bitstream-dir", bits,
                           "--output-dir", os.path.join(d, "png")])
    single = torch.from_numpy(got["frame.bin"][0]).cuda()
    return int((single != model.synthesize(enc["y_hat"][:1])[0]).sum())


def v3_clis(model, frame) -> dict:
    """One frame through ``python -m mlic_tpu_torch.tools.test`` under
    ``MLIC_UNIFIED_Z=0`` into a folder and back through ``tools.decode``
    (subprocesses on the card, the trained weights): the file must be
    format v3 and the bytes an in-process v3 codec writes, the PNG the
    encoder's x_hat rounded."""
    from PIL import Image

    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.entropy.stream import (
        stream_is_global,
        stream_is_unified,
    )
    from mlic_tpu_torch.eval import compress_one_image
    from mlic_tpu_torch.utils import bitstream
    common = ["--model", MODEL, "--checkpoint", CHECKPOINT,
              "--transform-dtype", "bfloat16"]
    with tempfile.TemporaryDirectory() as d, EnvSet(MLIC_UNIFIED_Z="0"):
        images, bits, pngs = (os.path.join(d, k)
                              for k in ("images", "bits", "png"))
        os.makedirs(images)
        Image.fromarray(frame).save(os.path.join(images, "frame.png"))
        secs = {}
        for name, args in (("test", ["--dataset", images, "--save-dir",
                                     bits]),
                           ("decode", ["--bitstream-dir", bits,
                                       "--output-dir", pngs])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", f"mlic_tpu_torch.tools.{name}",
                 *common, *args], cwd=REPO, capture_output=True, text=True,
                timeout=600)
            secs[name] = time.perf_counter() - t0
            if proc.returncode:
                raise AssertionError(f"tools.{name} under MLIC_UNIFIED_Z=0 "
                                     f"failed ({proc.returncode}): "
                                     f"{proc.stderr[-3000:]}")
        path = os.path.join(bits, "img_000.bin")
        again = os.path.join(d, "again.bin")
        enc = compress_one_image(Codec(model, device="cuda"),
                                 frame[None].astype(np.float32) / 255.0,
                                 again)
        with open(path, "rb") as f:
            bitstream.read_uints(f, 2)
            strings, _ = bitstream.read_body(f)
        png = np.asarray(Image.open(os.path.join(pngs, "img_000.png")))
        with open(path, "rb") as f, open(again, "rb") as g:
            same_file = f.read() == g.read()
    y, z = strings[0][0], strings[1][0]
    want = np.clip(enc["x_hat_enc"][0] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    row = {"frame": list(frame.shape), "bpp": enc["bpp"], "cli_s": secs,
           "file_is_v3": stream_is_global(y) and not stream_is_unified(y)
           and len(z) > 0, "file_equals_in_process": same_file,
           "png_equals_encoder_x_hat": bool(np.array_equal(png, want))}
    if not (row["file_is_v3"] and same_file
            and row["png_equals_encoder_x_hat"]):
        raise AssertionError(f"the v3 CLIs: {row}")
    return row


def ab_stream_format_cli() -> dict:
    """``python -m mlic_tpu_torch.tools.ab_stream_format`` at batch 8, 2
    segments of each format in each regime (a subprocess): its JSON
    line, every segment bit-exact."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mlic_tpu_torch.tools.ab_stream_format",
         "--batch", str(BATCH), "--reps", "2"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"tools.ab_stream_format failed "
                             f"({proc.returncode}): {proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["cli_s"] = time.perf_counter() - t0
    if not out["bit_exact"]:
        raise AssertionError("ab_stream_format: a segment not bit-exact")
    return out


def fallback_kernels(codec, param_k4: dict) -> list:
    """K7's y-gather mode and K4's row mode on y phases against their
    plain versions on the card, exact, on a payload of the serving shapes
    (3% escapes) over fallback B's tables (width 3,136, 12 levels): K7 on
    the whole batch, K4 on the z phase and all 2 * slice_num y phases of
    the payload's streams, which must decode to the payload.  Timed; the
    kernels line's rows.  ``param_k4`` is K4's parametric row of this run
    (its queued ms a y phase is printed beside the row mode's)."""
    import torch

    from mlic_tpu_torch.codec import encode_rans_v4
    from mlic_tpu_torch.entropy import device_rans as dr
    from mlic_tpu_torch.entropy.stream import assemble_streams
    dev = codec.device
    cfg = codec.model.cfg
    tables = codec.tables
    n_phases = 2 * cfg.slice_num
    sym, idx, z = (torch.from_numpy(a).to(dev) for a in make_payload(
        codec, np.random.default_rng(SEED + 10)))
    prep_args = (sym, idx, z, tables, codec.z_rows_base, cfg.N)
    got = dr.rans_encode_prep(*prep_args, y_gather=True)
    ref = dr.encode_prep_plain(*prep_args, y_gather=True)
    err = max_abs_err((g, r) for gs, rs in zip(got, ref)
                      for g, r in zip(gs, rs))
    if err != 0.0:
        raise AssertionError(f"K7 gather mode differs from its plain "
                             f"version (max abs err {err})")
    n_y, n_zt = sym.numel(), z.numel()
    width = tables["cdf_rows"].shape[1]
    table_bytes = tables["cdf_rows"].numel() * 4 + 8 * tables[
        "cdf_rows"].shape[0]
    call = functools.partial(dr.rans_encode_prep, *prep_args, y_gather=True)
    bms, by = bound(17 * n_y + 13 * n_zt + table_bytes, 0)
    rows = [{"name": "rans_encode_prep", "mode": "y_gather", "route": "cuda",
             "source": "mlic_tpu_torch/csrc/rans_encode_prep.cu",
             "replaces": "mlic_tpu/entropy/device_rans.py:468",
             "launches": 0, "status": "exact", "max_abs_err": err,
             "ms": cuda_ms(call, 20),
             "plain_ms": cuda_ms(functools.partial(
                 dr.encode_prep_plain, *prep_args, y_gather=True), 5),
             "bound_ms": bms, "bound_by": by, "library_ms": None,
             "bound_ms_entries_per_position": bound(
                 25 * n_y + 21 * n_zt, 0)[0],
             "kernel_ms": kernel_ms(call, KERNEL_SYMBOLS["rans_encode_prep"]),
             "queued_ms": queued_ms(call), "shape": [BATCH, n_y // BATCH +
                                                     n_zt // BATCH],
             "width": width}]

    comp = encode_rans_v4(sym, idx, z, tables, N_LANES, n_phases,
                          codec.z_rows_base, y_gather=True)
    err, (call, plain, rws, got1, ptr0) = decode_phases(
        codec, assemble_streams(comp, N_LANES), idx, z,
        dr.encode_layout_plain(z, sym, N_LANES, n_phases, 0), False)
    if err != 0.0:
        raise AssertionError(f"K4 row mode differs from its plain version "
                             f"(max abs err {err})")
    P = rws.numel()
    consumed = int((got1[3] - ptr0).sum())
    bms, by = bound(4 * P + 5 * P + 2 * consumed + 16 * rws.shape[1]
                    + 8 * BATCH + table_bytes, P * (2 * codec.n_steps + 20))
    # the bound by its chain, as K3's: each step of a lane waits on its
    # search, ceil(levels / log2 T) - 1 rounds of loads of the rows after
    # the first (which does not depend on the state), then the word read;
    # the rows (815 KB) outgrow an SM's L1, so each load is an L2 hit at
    # least
    group = dr.decode_group(N_LANES)
    rounds = -(-codec.n_steps // (group.bit_length() - 1))
    mhz = sm_clock_max_mhz()
    chain_ms = rws.shape[0] * rounds * L2_HIT_CYCLES / (mhz * 1e3)
    rows.append({"name": "rans_decode_phase", "mode": "y_rows",
                 "route": "cuda", "source": "mlic_tpu_torch/csrc/rans_decode.cu",
                 "replaces": "mlic_tpu/entropy/device_rans.py:217",
                 "launches": 0, "status": "exact", "max_abs_err": err,
                 "ms": cuda_ms(call, 10), "plain_ms": cuda_ms(plain, 1),
                 "bound_ms": bms, "bound_by": by, "library_ms": None,
                 "kernel_ms": kernel_ms(call,
                                        KERNEL_SYMBOLS["rans_decode_phase"]),
                 "queued_ms": queued_ms(call), "shape": list(rws.shape),
                 "levels": codec.n_steps, "width": width,
                 "phases_checked": n_phases + 1,
                 "chain_bound_ms": chain_ms,
                 "chain_loads_a_step": rounds, "steps": rws.shape[0],
                 "threads_per_lane": group, "l2_hit_cycles": L2_HIT_CYCLES,
                 "sm_clock_max_mhz": mhz,
                 "parametric_queued_ms": param_k4["queued_ms"]})
    return rows


def encode_global_v3(codec, sym, idx) -> list:
    """The port's host ``encode_global`` of each image's y phases (int32
    [B, n_y] symbols and scale indexes, phase-major), each phase padded to
    a lane multiple with pad-row symbols, over the codec's Gaussian rows:
    the oracle of the device encoder's v3 y streams."""
    from mlic_tpu_torch.entropy.rans.coder import encode_global
    _, lengths, offsets, table = codec._gauss
    n_phases = 2 * codec.model.cfg.slice_num
    n_per = sym.shape[1] // n_phases
    pad = -n_per % codec.n_lanes
    sym = np.pad(sym.reshape(len(sym), n_phases, n_per),
                 ((0, 0), (0, 0), (0, pad)))
    idx = np.pad(idx.reshape(len(idx), n_phases, n_per),
                 ((0, 0), (0, 0), (0, pad)),
                 constant_values=codec.z_rows_base - 1)
    return [encode_global(s_b.ravel(), i_b.ravel(), codec.n_lanes, table,
                          lengths, offsets) for s_b, i_b in zip(sym, idx)]


def codec_paths(model, codec, frames, kernels) -> dict:
    """Path 10, the codec's other paths (the ``codec_paths`` line), on path
    1's trained MLICPP_S codec settings and frames: (1) format v3 coded on
    the card, 3 batches bit-exact with each request's launches exact
    (``v3_request_launches``), the y streams the port's ``encode_global``
    of the phase symbols, bpp beside v4's, ms a direction and the host z
    coder's share, an image of a batch decoded alone by ``tools.decode``;
    (2) fallback A forced (``self_check_encode``), path 1's bytes with K7
    in gather mode; (3) fallback B forced (``validate_tables``), bit-exact
    at v4 and v3 over 3 batches, bpp beside the parametric table's, and
    K7's gather mode and K4's row mode against their plain versions
    (``fallback_kernels``: the kernels line's two rows); (4) the CLIs:
    ``tools.test`` and ``tools.decode`` under ``MLIC_UNIFIED_Z=0`` and
    ``tools.ab_stream_format``.  Returns the launch counts of the path."""
    import torch

    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.ops import _build
    t_path = time.perf_counter()
    cfg = model.cfg
    x = frames[0]

    def make(**env):
        with EnvSet(**env):
            c = Codec(model, n_lanes=N_LANES, device="cuda")
            c.update()
        return c

    _build.reset_launch_counts()
    v3 = make(MLIC_UNIFIED_Z="0")
    v3_rows, enc3 = coded_requests(v3, frames, "v3",
                                   v3_request_launches(cfg))
    with torch.no_grad():
        _, sym, idx = model.codec_encode_pass(*model.analyze(
            v3._images(x)))
    packed = encode_global_v3(v3, sym.cpu().numpy(), idx.cpu().numpy())
    v3_out = {"requests": v3_rows,
              "streams_equal_encode_global": packed == enc3["strings"][0],
              "v4_bpp": stream_stats(codec, codec.compress(x))["bpp"],
              **staged_shares(v3, x, {"compress": "z_encode",
                                      "decompress": "z_decode"}),
              "container_alone_entries_differing": v3_container_alone(
                  model, enc3)}
    print(json.dumps({"codec_paths_v3": v3_out}), flush=True)

    with Forced("self_check_encode"):
        fa = make()
    if not fa.parametric or fa.analytic_enc_rows:
        raise AssertionError("fallback A not taken")
    a_rows, _ = coded_requests(fa, frames[:1], "fallback_A", ref=codec)
    with Forced("validate_tables"):
        fb = make()
        fb3 = make(MLIC_UNIFIED_Z="0")
    if fb.parametric or "row_params" in fb.tables:
        raise AssertionError("fallback B not taken")
    b_rows, _ = coded_requests(fb, frames, "fallback_B_v4")
    b3_rows, _ = coded_requests(fb3, frames, "fallback_B_v3")
    k4 = next(k for k in kernels if k["name"] == "rans_decode_phase")
    fb_kernels = fallback_kernels(fb, k4)
    # launches in the mode: K7 in each fallback request; K4 on y phases in
    # B's requests (a v4 request's first K4 is its z phase)
    fb_kernels[0]["launches"] = sum(r["launches"]["rans_encode_prep"]
                                    for r in a_rows + b_rows + b3_rows)
    fb_kernels[1]["launches"] = sum(r["launches"]["rans_decode_phase"]
                                    for r in b_rows + b3_rows) - len(b_rows)
    print(json.dumps({"codec_paths_fallback_kernels": fb_kernels}),
          flush=True)

    counts = _build.launch_counts()
    clis = v3_clis(model, x[0])
    ab = ab_stream_format_cli()
    out = {"model": MODEL, "weights": "trained (ckpts/bench_default)",
           "transform_dtype": "bfloat16", "lanes": N_LANES,
           "v3": v3_out,
           "fallback_A": {"requests": a_rows},
           "fallback_B": {"v4": b_rows, "v3": b3_rows,
                          "parametric_bpp": {"v4": v3_out["v4_bpp"],
                                             "v3": v3_rows[0]["bpp"]},
                          "levels": fb.n_steps,
                          "width": fb.tables["cdf_rows"].shape[1]},
           "clis": clis, "ab_stream_format": ab,
           "launches": counts, "path_s": time.perf_counter() - t_path}
    print(json.dumps({"codec_paths": out}), flush=True)
    bad = [k for k, v in (("v3 streams equal encode_global",
                           v3_out["streams_equal_encode_global"]),
                          ("v3 container alone",
                           not v3_out["container_alone_entries_differing"]))
           if not v]
    if bad:
        raise AssertionError(f"path 10: {bad}")
    return counts, fb_kernels


def rd_vbr_path() -> tuple:
    """``tools.rd_vbr`` on path 4's MLICPP_S_VBR (the trained MLICPP_S
    through ``load_matching``) under ``bfloat16``: RD_VBR_FRAMES frames
    of RD_VBR_SIZE^2, every level and one interpolated gain through files
    (each decoded bit-exactly by ``evaluate_codec``); the tool raises
    unless the rate is monotone in the gain.  Returns the launch counts and
    the curve (path 12's BD-rate against JPEG reads it)."""
    from mlic_tpu_torch.ops import _build
    from mlic_tpu_torch.tools import rd_vbr
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    with tempfile.TemporaryDirectory() as d:
        curve = rd_vbr.main([
            "--model", VBR_MODEL, "--checkpoint", CHECKPOINT,
            "--out", os.path.join(d, "rd_vbr.json"),
            "--n-images", str(RD_VBR_FRAMES),
            "--image-size", str(RD_VBR_SIZE), "--interp", "1",
            "--transform-dtype", "bfloat16",
            "--save-dir", os.path.join(d, "eval")])
    counts = _build.launch_counts()
    out = {k: curve[k] for k in ("bpp", "psnr", "gain", "kind",
                                 "monotone_rate", "monotone_psnr",
                                 "backend")}
    out.update(launches=counts, path_s=time.perf_counter() - t0)
    print(json.dumps({"rd_vbr": out}), flush=True)
    from mlic_tpu_torch.models.config import model_config
    n_levels = len(model_config(VBR_MODEL).gain_init)
    if len(curve["bpp"]) != n_levels + 1 or not curve["monotone_rate"] \
            or not all(counts[k] for k in REQUEST_KERNELS):
        raise AssertionError(f"rd_vbr: {out}")
    return counts, curve


def l_train_path(state) -> dict:
    """Path 3 at the ten-slice width: MLICPP_L from its trained weights
    under ``bfloat16_mixed``, Adam, lambda 0.0483, batches of 8 random
    256x256 dead-leaves crops: L_TRAIN_WARMUP steps, L_TRAIN_STEPS timed
    (ms, peak memory), losses finite, no kernel launched; a resume whose
    next loss is exact; one f32 step at 1 x 128^2 against the CPU.
    Returns the launch counts."""
    import torch

    from mlic_tpu_torch.data.folder import dead_leaves_pool, pool_batches
    from mlic_tpu_torch.ops import _build
    from mlic_tpu_torch.train.trainer import train_step
    t_path = time.perf_counter()
    pool = dead_leaves_pool(TRAIN_POOL, TRAIN_POOL_SIZE, SEED + 9,
                            cache_dir="")
    n = L_TRAIN_WARMUP + L_TRAIN_STEPS
    batches = list(pool_batches(pool, TRAIN_BATCH, TRAIN_PATCH, n + 2,
                                seed=SEED + 1))
    with torch.enable_grad():
        _build.reset_launch_counts()
        tr = _trainer(state, name=L_MODEL)
        torch.cuda.reset_peak_memory_stats()
        ms, metrics = [], []
        for b in batches[:n]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(_floats(train_step(tr.state, b, tr.cfg)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = _build.launch_counts()
        timed = ms[L_TRAIN_WARMUP:]
        row = {"model": L_MODEL,
               "weights": "trained (ckpts/bench_default_MLICPP_L)",
               "transform_dtype": "bfloat16_mixed", "optimizer": "adam",
               "lambda": LMBDA, "metric": "mse",
               "batch": [TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 3],
               "warmup_steps": L_TRAIN_WARMUP, "timed_steps": L_TRAIN_STEPS,
               "step_ms": {"median": float(np.median(timed)),
                           "min": min(timed), "max": max(timed)},
               "first_step_ms": ms[0], "peak_mem_gib": peak,
               "losses": [m["loss"] for m in metrics], "launches": counts}
        finite = all(np.isfinite(v) for m in metrics for v in m.values())
        if not finite or any(counts.values()):
            print(json.dumps({"train_L": row}), flush=True)
            raise AssertionError(f"MLICPP_L training: finite {finite}, "
                                 f"launches {counts}")
        row["resume"] = check_resume(tr, batches[n:n + 2], state, L_MODEL)
        del tr
        row["cpu_step"] = check_cpu_step(state, pool, L_MODEL)
    row["path_s"] = time.perf_counter() - t_path
    print(json.dumps({"train_L": row}), flush=True)
    return counts


def sd_freeze_path() -> dict:
    """MLICPP_M_SMALL_DEC through ``tools.train --freeze`` (its encoder,
    g_a and h_a, the reference's ``mlicpp_small_decoder.py:508-517``
    pattern) for SD_TRAIN_STEPS steps of 8 x 256^2 dead-leaves crops on
    the card, from the CLI's seeded weights: every frozen leaf bit-equal
    to the start, every other leaf with a nonzero gradient in one step
    from the start (a step taken here, on the CLI's first batch) moved.
    Returns the launch counts."""
    import torch

    from mlic_tpu_torch.data.folder import dead_leaves_pool, pool_batches
    from mlic_tpu_torch.ops import _build
    from mlic_tpu_torch.tools import train as train_cli
    from mlic_tpu_torch.train.optimizers import frozen_names
    from mlic_tpu_torch.train.trainer import (
        TrainConfig,
        create_train_state,
        train_step,
    )
    t_path = time.perf_counter()
    start = {k: v.clone() for k, v in
             seeded_model(SD_MODEL, "bfloat16_mixed").state_dict().items()}
    _build.reset_launch_counts()
    with tempfile.TemporaryDirectory() as d, torch.enable_grad():
        last = train_cli.main([
            "--model", SD_MODEL, "--synthetic", "--synthetic-kind",
            "dead_leaves", "--pool-size", str(TRAIN_POOL),
            "--pool-image-size", str(TRAIN_POOL_SIZE), "--steps",
            str(SD_TRAIN_STEPS), "--batch-size", str(TRAIN_BATCH),
            "--patch-size", str(TRAIN_PATCH), "--freeze", SD_FREEZE,
            "--ckpt-dir", d, "--log-freq", "1"])
        end = torch.load(os.path.join(d, "mlic_tpu_torch",
                                      f"checkpoint_{SD_TRAIN_STEPS}.pt"),
                         map_location="cpu", weights_only=True)["model"]
    counts = _build.launch_counts()
    cli_s = time.perf_counter() - t_path
    model = seeded_model(SD_MODEL, "bfloat16_mixed")
    frozen = frozen_names(model, SD_FREEZE)
    cfg = TrainConfig(lmbda=LMBDA, metric="mse", optimizer="adam", seed=SEED)
    batch = next(pool_batches(dead_leaves_pool(TRAIN_POOL, TRAIN_POOL_SIZE,
                                               SEED),
                              TRAIN_BATCH, TRAIN_PATCH, 1, seed=SEED + 1))
    with torch.enable_grad():
        st = create_train_state(model, cfg, "cuda", SD_FREEZE)
        train_step(st, batch, cfg)
        with_grad = {k for k, p in model.named_parameters()
                     if p.grad is not None and bool(torch.any(p.grad))}
    del st, model
    params = [k for k in start if k in with_grad or k in frozen]
    frozen_changed = [k for k in frozen if not torch.equal(end[k], start[k])]
    unmoved = [k for k in with_grad - frozen
               if torch.equal(end[k], start[k])]
    row = {"model": SD_MODEL, "weights": "seeded (the CLI's --seed 0)",
           "freeze": SD_FREEZE, "steps": SD_TRAIN_STEPS,
           "last": last, "cli_s": cli_s, "frozen_leaves": len(frozen),
           "frozen_changed": frozen_changed,
           "leaves_with_gradient": len(with_grad - frozen),
           "leaves_with_gradient_unmoved": unmoved,
           "leaves_checked": len(params), "launches": counts,
           "path_s": time.perf_counter() - t_path}
    print(json.dumps({"train_small_decoder_frozen": row}), flush=True)
    if not frozen or frozen_changed or unmoved \
            or not np.isfinite(last["loss"]) or any(counts.values()):
        raise AssertionError(f"frozen-encoder training: {row}")
    return counts


def _run_tool(module: str, args: list, env: dict | None = None) -> str:
    """``python -m mlic_tpu_torch.tools.<module> args`` from the repository
    root on the card; returns its standard output, raises on failure."""
    proc = subprocess.run(
        [sys.executable, "-m", f"mlic_tpu_torch.tools.{module}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=None if env is None else {**os.environ, **env})
    if proc.returncode:
        raise AssertionError(f"tools.{module} failed ({proc.returncode}): "
                             f"{proc.stdout[-1500:]}{proc.stderr[-3000:]}")
    return proc.stdout


def _train_run(stdout: str, work: str) -> dict:
    """What a ``tools.train`` run shows: its segments (first step, patch
    size) and each logged step's host ms from the log, and every step's
    metrics and validation at full precision from ``metrics.jsonl``."""
    import re
    with open(os.path.join(work, "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return {
        "segments": [[int(s), int(p)] for p, s in re.findall(
            r"^patch (\d+) from step (\d+)$", stdout, re.M)],
        "step_ms": [float(v) for v in re.findall(
            r"^step \d+ \| (\d+) ms/it", stdout, re.M)],
        "train": [{k: v for k, v in r.items() if k.startswith("train/")}
                  for r in records if "train/loss" in r],
        "val": [{k: v for k, v in r.items() if k != "time"}
                for r in records if "val/psnr" in r]}


def train_recipe_cli() -> dict:
    """``tools.train`` in a subprocess on a folder of dead-leaves PNGs
    (TRAIN_POOL images of 320^2; two 768x512 frames to validate on), from
    the trained MLICPP_S: SCALE_TRAIN_STEPS steps of 8 x 256^2 crops with
    the reference's AutoAugment, the patch size switching to 128 at step 2,
    validation every 2 steps with its reconstructions written; then the
    same run without AutoAugment and validation.  The patch size must
    switch where the schedule says, every loss and validation metric be
    finite, the reconstructions be written at the test frames' size, and
    AutoAugment change the losses.  Reports the host ms of each step."""
    from PIL import Image

    from mlic_tpu_torch.data.folder import dead_leaves_pool
    t_path = time.perf_counter()
    switch, small = SCALE_PATCH_SWITCH
    train_pool = dead_leaves_pool(TRAIN_POOL, TRAIN_POOL_SIZE, SEED + 11,
                                  cache_dir="")
    test_pool = dead_leaves_pool(2, HEIGHT, SEED + 12, width=WIDTH,
                                 cache_dir="")
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        for name, imgs in (("train", train_pool), ("test", test_pool)):
            os.makedirs(os.path.join(d, name))
            for i, img in enumerate(imgs):
                Image.fromarray(img).save(os.path.join(d, name,
                                                       f"{name}{i:02d}.png"))
        common = ["--model", MODEL, "--pretrained", CHECKPOINT, "--dataset",
                  os.path.join(d, "train"), "--steps", str(SCALE_TRAIN_STEPS),
                  "--batch-size", str(TRAIN_BATCH), "--patch-size",
                  str(TRAIN_PATCH), "--patch-milestones", f"{switch}:{small}",
                  "--log-freq", "1", "--seed", str(SEED)]
        recipe = ["--augment", "autoaugment", "--test-dataset",
                  os.path.join(d, "test"), "--val-every", "2",
                  "--val-images", "2", "--save-recon"]
        for label, extra in (("autoaugment", recipe), ("plain", [])):
            ckpt = os.path.join(d, label)
            t0 = time.perf_counter()
            out = _run_tool("train", common + extra + ["--ckpt-dir", ckpt])
            runs[label] = {**_train_run(out, os.path.join(
                ckpt, "mlic_tpu_torch")), "cli_s": time.perf_counter() - t0}
        val_dir = os.path.join(d, "autoaugment", "mlic_tpu_torch", "val")
        recons = {}
        for f in sorted(os.listdir(val_dir)):
            a = np.asarray(Image.open(os.path.join(val_dir, f)))
            recons[f] = {"shape": list(a.shape), "std": float(a.std())}
    want_segments = [[0, TRAIN_PATCH], [switch, small]]
    want_recons = [f"step{s}_img{i}.png" for s in (2, 4) for i in (0, 1)]
    aug, plain = runs["autoaugment"], runs["plain"]
    finite = all(np.isfinite(v) for r in (aug, plain)
                 for rec in r["train"] + r["val"] for v in rec.values())
    row = {"model": MODEL, "weights": "trained (ckpts/bench_default)",
           "batch": [TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 3],
           "patch_milestones": f"{switch}:{small}",
           "step_ms_autoaugment": aug["step_ms"],
           "step_ms_plain": plain["step_ms"],
           "segments": aug["segments"], "val": aug["val"],
           "losses_autoaugment": [r["train/loss"] for r in aug["train"]],
           "losses_plain": [r["train/loss"] for r in plain["train"]],
           "recons": recons,
           "cli_s": {k: r["cli_s"] for k, r in runs.items()},
           "path_s": time.perf_counter() - t_path}
    print(json.dumps({"train_recipe": row}), flush=True)
    bad_recons = [f for f in want_recons if f not in recons
                  or recons[f]["shape"] != [HEIGHT, WIDTH, 3]
                  or not recons[f]["std"]]
    if aug["segments"] != want_segments or plain["segments"] != want_segments \
            or len(aug["train"]) != SCALE_TRAIN_STEPS \
            or len(plain["train"]) != SCALE_TRAIN_STEPS \
            or [r["step"] for r in aug["val"]] != [2, 4] or bad_recons \
            or not finite or row["losses_autoaugment"] == row["losses_plain"]:
        raise AssertionError(f"training recipe: bad reconstructions "
                             f"{bad_recons}, {row}")
    return row


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def data_parallel_world1() -> dict:
    """``tools.train`` (the trained MLICPP_S, SCALE_DP_STEPS steps of 8 x
    256^2 dead-leaves crops) plainly and under RANK=0, WORLD_SIZE=1 over
    NCCL: the process group's backend must be nccl, and every step's
    metrics and the final weights bit-equal to the plain run's (the mean
    over one process divides by 1; the noise is the global batch's
    slice, all of it)."""
    import torch
    t_path = time.perf_counter()
    common = ["--model", MODEL, "--pretrained", CHECKPOINT, "--synthetic",
              "--synthetic-kind", "dead_leaves", "--pool-size",
              str(TRAIN_POOL), "--pool-image-size", str(TRAIN_POOL_SIZE),
              "--steps", str(SCALE_DP_STEPS), "--batch-size",
              str(TRAIN_BATCH), "--patch-size", str(TRAIN_PATCH),
              "--log-freq", "1", "--seed", str(SEED)]
    dist_env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    runs, weights, backend = {}, {}, None
    with tempfile.TemporaryDirectory() as d:
        for label, env in (("plain", None), ("nccl_world_1", dist_env)):
            ckpt = os.path.join(d, label)
            t0 = time.perf_counter()
            out = _run_tool("train", common + ["--ckpt-dir", ckpt], env)
            runs[label] = {**_train_run(out, os.path.join(
                ckpt, "mlic_tpu_torch")), "cli_s": time.perf_counter() - t0}
            if env is not None:
                line = [s for s in out.splitlines()
                        if s.startswith("process group:")]
                backend = line[0].split("backend ")[1].split(",")[0] \
                    if line else None
            weights[label] = torch.load(os.path.join(
                ckpt, "mlic_tpu_torch", f"checkpoint_{SCALE_DP_STEPS}.pt"),
                map_location="cpu", weights_only=True)["model"]
    plain, dp = runs["plain"], runs["nccl_world_1"]
    differ = [k for k in weights["plain"]
              if not torch.equal(weights["plain"][k],
                                 weights["nccl_world_1"][k])]
    row = {"backend": backend, "steps": SCALE_DP_STEPS,
           "losses_plain": [r["train/loss"] for r in plain["train"]],
           "losses_nccl_world_1": [r["train/loss"] for r in dp["train"]],
           "metrics_bit_equal": plain["train"] == dp["train"],
           "weights_differing": differ, "tensors": len(weights["plain"]),
           "step_ms_plain": plain["step_ms"],
           "step_ms_nccl_world_1": dp["step_ms"],
           "cli_s": {k: r["cli_s"] for k, r in runs.items()},
           "path_s": time.perf_counter() - t_path}
    print(json.dumps({"data_parallel_world_1": row}), flush=True)
    if backend != "nccl" or not row["metrics_bit_equal"] or differ \
            or len(plain["train"]) != SCALE_DP_STEPS:
        raise AssertionError(f"data parallelism at world size 1: {row}")
    return row


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def sharded_path(model, codec, frames, device_lists=SHARD_DEVICES) -> dict:
    """``ShardedCodec`` of path 1's model (512 lanes, format v4) on each
    of ``device_lists``, over path 1's 3 batches of 8 after a
    warm-up batch: each batch bit-exact (x_hat), each shard's streams
    ``Codec.compress``'s of the shard's images on path 1's codec and its
    decoded y_hat that codec's, the launches of a batch the configuration's
    times the shards; the count of streams that differ from the
    single-device batch-8 bytes (bf16 g_a may round by batch), ms a
    direction, and the launches of each replica's ``update``.  Then
    ``tools.serve --sharded --verify``.  Returns the launch counts of the
    path's sharded work (the single codec's reference requests excluded)."""
    import copy

    import torch

    from mlic_tpu_torch.ops import _build
    from mlic_tpu_torch.parallel.serving import ShardedCodec
    from mlic_tpu_torch.tools import serve as serve_cli
    t_path = time.perf_counter()
    cfg = model.cfg
    single = [codec.compress(x)["strings"][0] for x in frames]
    total = dict.fromkeys(_build.launch_counts(), 0)

    def counted(fn, *args):
        before = _build.launch_counts()
        out = fn(*args)
        got = _diff(_build.launch_counts(), before)
        for k, v in got.items():
            total[k] += v
        return out, got

    rows = []
    for devices in device_lists:
        n = len(devices)
        per = BATCH // n
        sc = ShardedCodec(copy.deepcopy(model), list(devices),
                          n_lanes=N_LANES, encode_recon=True)
        _, in_update = counted(sc.update)
        if not sc.parametric or not sc.analytic_enc_rows:
            raise AssertionError(f"sharded update took a fallback: {devices}")
        warm, _ = counted(sc.compress, frames[0])
        counted(sc.decompress, warm["strings"], warm["shape"])
        want = {k: v * n for k, v in request_launches(cfg).items()}
        enc_ms, dec_ms, differ, shard_mismatch = [], [], 0, []
        for r, x in enumerate(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc, l_enc = counted(sc.compress, x)
            t1 = time.perf_counter()
            dec, l_dec = counted(sc.decompress, enc["strings"], enc["shape"])
            t2 = time.perf_counter()
            enc_ms.append((t1 - t0) * 1e3)
            dec_ms.append((t2 - t1) * 1e3)
            launches = {k: l_enc[k] + l_dec[k] for k in l_enc}
            if launches != want:
                raise AssertionError(f"sharded {devices} batch {r}: launches "
                                     f"{launches}, want {want}")
            if not torch.equal(dec["x_hat"], enc["x_hat"]) \
                    or tuple(dec["x_hat"].shape) != tuple(x.shape) \
                    or not bool(torch.isfinite(dec["x_hat"]).all()):
                raise AssertionError(f"sharded {devices} batch {r}: x_hat")
            for i in range(n):
                sl = slice(i * per, (i + 1) * per)
                part = codec.compress(x[sl])
                if enc["strings"][0][sl] != part["strings"][0] \
                        or not torch.equal(dec["y_hat"][sl], part["y_hat"]):
                    shard_mismatch.append([r, i])
            differ += sum(a != b for a, b in zip(enc["strings"][0],
                                                 single[r]))
        row = {"devices": list(devices), "shards": n, "batch": BATCH,
               "lanes": N_LANES, "batches": len(frames),
               "encode_ms": enc_ms, "decode_ms": dec_ms,
               "encode_ms_median": float(np.median(enc_ms)),
               "decode_ms_median": float(np.median(dec_ms)),
               "launches_per_shard_a_batch": {k: v // n
                                              for k, v in want.items()},
               "launches_per_replica_update": {k: v / n for k, v in
                                               in_update.items()},
               "shards_differing_from_codec": shard_mismatch,
               "streams_differing_from_batch_8": differ,
               "streams": BATCH * len(frames)}
        rows.append(row)
        print(json.dumps({"sharded": row}), flush=True)
        if shard_mismatch or not in_update["select_rows"] \
                or not in_update["eval_cdf"]:
            raise AssertionError(f"sharded codec {devices}: {row}")
        del sc
    cli, _ = counted(serve_cli.main, [
        "--checkpoint", CHECKPOINT, "--transform-dtype", "bfloat16",
        "--synthetic", "--n", str(2 * BATCH), "--batch", str(BATCH),
        "--lanes", str(N_LANES), "--sharded", "--verify"])
    if not (cli["sharded"] and cli["shards"] == torch.cuda.device_count()
            and cli["parametric"] and cli["analytic_enc_rows"]):
        raise AssertionError(f"tools.serve --sharded: {cli}")
    print(json.dumps({"sharded_serve_cli": cli,
                      "sharded_path_s": time.perf_counter() - t_path}),
          flush=True)
    return total


def seeded_vgg():
    """A VGG16 feature extractor with PyTorch's default initialization
    from seed SEED (no pretrained weights are in the repository)."""
    import torch

    from mlic_tpu_torch.perceptual import Vgg16Features
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        return Vgg16Features()


def poelic_path(state) -> dict:
    """POELIC_STEPS perceptual steps (``poelic_train_step``) of MLICPP_S
    from the trained weights under ``bfloat16_mixed``, batches of 8 x
    256^2 dead-leaves crops, a seeded VGG16: ms a step, peak memory, every
    loss term finite, the VGG untouched, no kernel launched; one f32 step
    at 1 x 128^2 on the card against the CPU at path 3's tolerances."""
    import torch

    from mlic_tpu_torch.data.folder import dead_leaves_pool, pool_batches
    from mlic_tpu_torch.models.config import model_config
    from mlic_tpu_torch.ops import _build
    from mlic_tpu_torch.train.trainer import poelic_train_step
    t_path = time.perf_counter()
    pool = dead_leaves_pool(TRAIN_POOL, TRAIN_POOL_SIZE, SEED + 9,
                            cache_dir="")
    batches = list(pool_batches(pool, TRAIN_BATCH, TRAIN_PATCH, POELIC_STEPS,
                                seed=SEED + 1))
    vgg = seeded_vgg()
    vgg_start = {k: v.clone() for k, v in vgg.state_dict().items()}
    before = _build.launch_counts()
    with torch.enable_grad():
        tr = _trainer(state)
        vgg_card = seeded_vgg().cuda()
        torch.cuda.reset_peak_memory_stats()
        ms, metrics = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(_floats(poelic_train_step(tr.state, b, tr.cfg,
                                                     vgg_card)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        vgg_moved = [k for k, v in vgg_card.state_dict().items()
                     if not torch.equal(v.cpu(), vgg_start[k])]
        del tr
        counts = _diff(_build.launch_counts(), before)
        b, h, w, _ = CPU_STEP_SHAPE
        x = pool[:b, :h, :w]
        noise = torch.from_numpy(np.random.default_rng(SEED + 10).uniform(
            -0.5, 0.5, (model_config(MODEL).N, b * (h // 64) * (w // 64))
        ).astype(np.float32))
        cpu = {}
        for dev in ("cpu", "cuda"):
            t = _trainer(state, "float32", dev)
            m = poelic_train_step(t.state, x, t.cfg, vgg.to(dev),
                                  noise=noise.to(dev))
            cpu[dev] = {"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"])}
    rel = {k: abs(cpu["cuda"][k] - cpu["cpu"][k]) / abs(cpu["cpu"][k])
           for k in ("loss", "grad_norm")}
    row = {"model": MODEL, "weights": "trained (ckpts/bench_default)",
           "vgg": "seeded (torch default init, seed 0)",
           "transform_dtype": "bfloat16_mixed",
           "batch": [TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 3],
           "step_ms": ms, "peak_mem_gib": peak, "first": metrics[0],
           "last": metrics[-1], "vgg_changed": vgg_moved,
           "launches": counts, "f32_step_vs_cpu": {
               "shape": list(CPU_STEP_SHAPE), **cpu,
               "loss_rel_diff": rel["loss"],
               "grad_norm_rel_diff": rel["grad_norm"],
               "tolerances": [CPU_LOSS_RTOL, CPU_GRAD_NORM_RTOL]},
           "path_s": time.perf_counter() - t_path}
    print(json.dumps({"poelic": row}), flush=True)
    finite = all(np.isfinite(v) for m in metrics for v in m.values())
    if not finite or vgg_moved or any(counts.values()) \
            or not rel["loss"] <= CPU_LOSS_RTOL \
            or not rel["grad_norm"] <= CPU_GRAD_NORM_RTOL:
        raise AssertionError(f"POELIC: {row}")
    return row


def statistics_path(state, frames) -> dict:
    """``tools.statistics`` on STATS_FRAMES 768x512 dead-leaves frames (the
    trained MLICPP_S, ``bfloat16_mixed``): a row for every file, bpp within
    1e-6 of ``Trainer.evaluate``'s on the same frames, PSNR and MS-SSIM
    finite.  Returns the launch counts (none expected)."""
    import csv

    from PIL import Image

    from mlic_tpu_torch.ops import _build
    from mlic_tpu_torch.tools import statistics as stats_cli
    t_path = time.perf_counter()
    x = frames[0][:STATS_FRAMES]
    before = _build.launch_counts()
    with tempfile.TemporaryDirectory() as d:
        images = os.path.join(d, "images")
        os.makedirs(images)
        for i, f in enumerate(x):
            Image.fromarray(f).save(os.path.join(images, f"frame{i}.png"))
        out = os.path.join(d, "stats.csv")
        t0 = time.perf_counter()
        stats_cli.main(["--model", MODEL, "--checkpoint", CHECKPOINT,
                        "--dataset", images, "--out", out,
                        "--transform-dtype", "bfloat16_mixed"])
        cli_s = time.perf_counter() - t0
        with open(out) as fh:
            rows = list(csv.DictReader(fh))
    counts = _diff(_build.launch_counts(), before)
    ev = _trainer(state).evaluate([f.astype(np.float32) / 255.0 for f in x])
    diffs = [abs(float(r["bpp"]) - e["bpp"])
             for r, e in zip(rows, ev["per_image"])]
    row = {"frames": STATS_FRAMES, "names": [r["name"] for r in rows],
           "bpp": [float(r["bpp"]) for r in rows],
           "psnr": [float(r["psnr"]) for r in rows],
           "ms_ssim": [float(r["ms_ssim"]) for r in rows],
           "evaluate_bpp": [e["bpp"] for e in ev["per_image"]],
           "max_bpp_diff": max(diffs) if diffs else None, "cli_s": cli_s,
           "launches": counts, "path_s": time.perf_counter() - t_path}
    print(json.dumps({"statistics": row}), flush=True)
    names = [f"frame{i}.png" for i in range(STATS_FRAMES)]
    finite = all(np.isfinite(row[k]).all() for k in ("bpp", "psnr",
                                                     "ms_ssim"))
    if row["names"] != names or not finite or row["max_bpp_diff"] > 1e-6:
        raise AssertionError(f"tools.statistics: {row}")
    return counts


def scale_out_path(state, model, codec, frames) -> dict:
    """Path 11: the reference's training recipe through ``tools.train``,
    a world-size-1 NCCL run, the sharded codec, POELIC and
    ``tools.statistics``.  Returns the launch counts of the path run in
    this process (training runs no kernel; its CLIs run in subprocesses)."""
    t_path = time.perf_counter()
    recipe = train_recipe_cli()
    dp = data_parallel_world1()
    counts = sharded_path(model, codec, frames)
    poelic = poelic_path(state)
    stats = statistics_path(state, frames)
    for k, v in stats.items():
        counts[k] += v
    missing = [k for k in ("select_rows", "eval_cdf") + REQUEST_KERNELS
               if not counts[k]]
    print(json.dumps({"scale_out": {
        "launches": counts, "train_recipe_s": recipe["path_s"],
        "data_parallel_s": dp["path_s"], "poelic_s": poelic["path_s"],
        "path_s": time.perf_counter() - t_path}}), flush=True)
    if missing:
        raise AssertionError(f"path 11 launched no {missing}")
    return counts


def _launch_ranks(n: int, module: str, args: list) -> list:
    """``tools.<module> args`` in ``n`` processes of one process group
    (RANK, LOCAL_RANK = 0..n-1, a free localhost port); returns their
    outputs.  A rank that fails, or a run past its time limit, ends every
    rank at once (the others would wait in a collective) and raises."""
    port = str(_free_port())
    with tempfile.TemporaryDirectory() as d:
        logs = [open(os.path.join(d, f"rank{r}.log"), "w+")
                for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", f"mlic_tpu_torch.tools.{module}", *args],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "RANK": str(r), "LOCAL_RANK": str(r),
                 "WORLD_SIZE": str(n), "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": port}) for r, log in enumerate(logs)]
        deadline = time.monotonic() + 600
        try:
            while any(p.poll() is None for p in procs) \
                    and not any(p.returncode for p in procs) \
                    and time.monotonic() < deadline:
                time.sleep(0.5)
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
    bad = [(r, p.returncode, o[-2000:]) for r, (p, o)
           in enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        raise AssertionError(f"tools.{module} over {n} processes: {bad}")
    return outs


def _multi_train_flags() -> list:
    """``tools.train``'s flags in ``multi_card_train``, but --ckpt-dir."""
    return ["--model", MODEL, "--pretrained", CHECKPOINT, "--synthetic",
            "--synthetic-kind", "dead_leaves", "--pool-size",
            str(TRAIN_POOL), "--pool-image-size", str(TRAIN_POOL_SIZE),
            "--steps", str(MULTI_TRAIN_STEPS), "--batch-size",
            str(TRAIN_BATCH), "--patch-size", str(TRAIN_PATCH),
            "--transform-dtype", "float32", "--optimizer", "sgd",
            "--log-freq", "1", "--seed", str(SEED)]


def batch_split_first_step(n: int) -> dict:
    """The first step's RD loss of ``multi_card_train``'s run, computed in
    this process on one card from the same weights, batch and noise as
    ``tools.train`` takes them: in one training forward of the global
    batch (what one process computes) and in ``n`` forwards of a slice
    each, with the slice's columns of the same z noise, their losses
    averaged (what ``n`` ranks compute and all-reduce).  Reports both
    losses, their relative difference, how far g_a's output y and h_s's
    output differ between the two, and the entries of y_hat and z_hat (the
    quantized latents g_s and h_s take) that differ by at least 1/2, i.e.
    round to another integer.  Then the global batch's loss once more with
    the context models' batch-spanning products (``models/context.
    per_image``, one call a batch in training) run an image at a time: if
    those products are where the batch size changes the floats, this loss
    sits by the slices' mean and not by the whole batch's."""
    import torch

    from mlic_tpu_torch.data.folder import dead_leaves_pool, pool_batches
    from mlic_tpu_torch.loss import rate_distortion_loss
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.ops import invariant_matmul as im
    from mlic_tpu_torch.tools.train import parse_args
    from mlic_tpu_torch.train.trainer import (
        TrainConfig,
        _to_batch,
        create_train_state,
        z_noise,
    )
    from mlic_tpu_torch.utils.checkpoint import load_matching
    from mlic_tpu_torch.weights import init_params, load_checkpoint
    args = parse_args(_multi_train_flags())
    model = get_model(args.model, args.transform_dtype)
    model.load_state_dict(init_params(
        model, torch.Generator().manual_seed(args.seed)))
    weights, _ = load_matching(model.state_dict(),
                               load_checkpoint(args.pretrained))
    model.load_state_dict(weights)
    state = create_train_state(model, TrainConfig(seed=args.seed), "cuda")
    pool = dead_leaves_pool(args.pool_size, args.pool_image_size,
                            seed=args.seed)
    x = _to_batch(next(pool_batches(pool, args.batch_size, args.patch_size,
                                    args.steps, seed=args.seed + 1)),
                  "cuda")
    noise = z_noise(model, x, state.generator)
    seen = {"y": [], "y_hat": [], "z_hat": [], "hyper": []}
    hooks = [model.g_a.register_forward_hook(
                 lambda m, i, o: seen["y"].append(o.detach())),
             model.h_s.register_forward_hook(
                 lambda m, i, o: seen["hyper"].append(o.detach())),
             model.g_s.register_forward_pre_hook(
                 lambda m, i: seen["y_hat"].append(i[0].detach())),
             model.h_s.register_forward_pre_hook(
                 lambda m, i: seen["z_hat"].append(i[0].detach()))]
    k, cols = len(x) // n, noise.shape[1] // n

    def loss(sl, cl):
        out = model(x[sl], True, noise[:, cl], state.generator)
        return float(rate_distortion_loss(out, x[sl], args.lmbda,
                                          args.metrics)["loss"].detach())
    with torch.enable_grad():       # training's path: one call a batch
        whole = loss(slice(None), slice(None))
        split = float(np.mean([loss(slice(i * k, (i + 1) * k),
                                    slice(i * cols, (i + 1) * cols))
                               for i in range(n)]))
        for h in hooks:
            h.remove()
        im.ROUTE = "plain"              # the products an image at a time
        try:
            alone = loss(slice(None), slice(None))
        finally:
            im.ROUTE = "auto"
    y_whole, y_split = seen["y"][0], torch.cat(seen["y"][1:])
    hyper = int((seen["hyper"][0] != torch.cat(seen["hyper"][1:])).sum())
    jump = {k: int(((seen[k][0] - torch.cat(seen[k][1:])).abs() >= 0.5)
                   .sum()) for k in ("y_hat", "z_hat")}
    row = {"ranks": n, "batch": len(x), "loss_whole": whole,
           "loss_split": split,
           "loss_rel_diff": abs(whole - split) / abs(whole),
           "loss_whole_products_per_image": alone,
           "per_image_rel_diff_to_split": abs(alone - split) / abs(split),
           "y_entries": y_whole.numel(),
           "y_entries_differing": int((y_whole != y_split).sum()),
           "y_max_abs_diff": float((y_whole - y_split).abs().max()),
           "h_s_entries_differing": hyper,
           "y_hat_entries_rounding_otherwise": jump["y_hat"],
           "z_hat_entries_rounding_otherwise": jump["z_hat"]}
    print(json.dumps({"batch_split_first_step": row}), flush=True)
    return row


def multi_card_train(n: int) -> dict:
    """``tools.train`` over ``n`` cards (one process a card, NCCL) against
    one process on the global batch: MLICPP_S from the trained weights in
    f32 (TF32 off), SGD, 2 steps of 8 x 256^2 dead-leaves crops (8 / n
    images a card).  The weights within rtol 2e-4, atol 2e-6 (the JAX
    package's bounds for its sharded step, tests/test_parallel.py:44-47).
    The first step's loss within rtol 1e-5 (the CPU test's bound) of
    ``batch_split_first_step``'s mean over ``n`` slices, the computation
    the ranks make, and the one process's within 1e-6 of that function's
    whole-batch loss.  Every step's loss within CPU_LOSS_RTOL of the one
    process's: the context models' products round otherwise at a batch of
    8 / n than at 8, and y_hat entries then round to another integer;
    ``batch_split_first_step`` measures both on the card."""
    import torch
    t_path = time.perf_counter()
    common = _multi_train_flags()
    with tempfile.TemporaryDirectory() as d:
        runs, weights = {}, {}
        for label in ("one_process", f"{n}_processes"):
            ckpt = os.path.join(d, label)
            t0 = time.perf_counter()
            if label == "one_process":
                out = _run_tool("train", common + ["--ckpt-dir", ckpt])
            else:
                out = _launch_ranks(n, "train",
                                    common + ["--ckpt-dir", ckpt])[0]
            work = os.path.join(ckpt, "mlic_tpu_torch")
            runs[label] = {**_train_run(out, work), "out": out,
                           "cli_s": time.perf_counter() - t0}
            weights[label] = torch.load(os.path.join(
                work, f"checkpoint_{MULTI_TRAIN_STEPS}.pt"),
                map_location="cpu", weights_only=True)["model"]
    split = batch_split_first_step(n)
    one, dp = runs["one_process"], runs[f"{n}_processes"]
    group = [s for s in dp["out"].splitlines()
             if s.startswith("process group:")]
    loss_rel = [abs(a["train/loss"] - b["train/loss"]) / abs(b["train/loss"])
                for a, b in zip(dp["train"], one["train"])]
    first_vs_split = abs(dp["train"][0]["train/loss"] - split["loss_split"]) \
        / abs(split["loss_split"])
    one_vs_whole = abs(one["train"][0]["train/loss"] - split["loss_whole"]) \
        / abs(split["loss_whole"])
    outside = [k for k, w in weights["one_process"].items()
               if not torch.allclose(weights[f"{n}_processes"][k], w,
                                     rtol=2e-4, atol=2e-6)]
    row = {"cards": n, "process_group": group[0] if group else None,
           "steps": MULTI_TRAIN_STEPS, "batch": TRAIN_BATCH,
           "losses_one_process": [r["train/loss"] for r in one["train"]],
           "losses_data_parallel": [r["train/loss"] for r in dp["train"]],
           "loss_rel_diff": loss_rel,
           "first_loss_rel_diff_to_split": first_vs_split,
           "first_loss_rel_diff_one_process_to_whole": one_vs_whole,
           "weights_outside_bounds": outside,
           "tensors": len(weights["one_process"]),
           "step_ms_one_process": one["step_ms"],
           "step_ms_data_parallel": dp["step_ms"],
           "cli_s": {k: r["cli_s"] for k, r in runs.items()},
           "path_s": time.perf_counter() - t_path}
    print(json.dumps({"multi_card_train": row}), flush=True)
    if not group or "backend nccl" not in group[0] \
            or len(loss_rel) != MULTI_TRAIN_STEPS \
            or first_vs_split > 1e-5 or one_vs_whole > 1e-6 \
            or max(loss_rel) > CPU_LOSS_RTOL or outside:
        raise AssertionError(f"data parallelism over {n} cards: {row}")
    return row


def multi_card_statistics(n: int, frames) -> dict:
    """``tools.statistics`` over ``n`` processes (a card each) on the 2 x 8
    frames of path 1, against one process: the CSV has every file, in the
    round-robin order of the shards, each row within 1e-6 (bpp) and rtol
    1e-5 (PSNR, MS-SSIM) of the one-process row."""
    import csv

    from PIL import Image
    t_path = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        images = os.path.join(d, "images")
        os.makedirs(images)
        for i, f in enumerate(np.concatenate(frames[:2])):
            Image.fromarray(f).save(os.path.join(images, f"frame{i:02d}.png"))
        common = ["--model", MODEL, "--checkpoint", CHECKPOINT, "--dataset",
                  images, "--transform-dtype", "bfloat16_mixed"]
        _run_tool("statistics", common + ["--out", os.path.join(d, "1.csv")])
        _launch_ranks(n, "statistics",
                      common + ["--out", os.path.join(d, "n.csv")])
        with open(os.path.join(d, "1.csv")) as f1, \
                open(os.path.join(d, "n.csv")) as fn:
            one = {r["name"]: r for r in csv.DictReader(f1)}
            many = list(csv.DictReader(fn))
    names = sorted(one)
    order = [x for r in range(n) for x in names[r::n]]
    diffs = {k: max(abs(float(r[k]) - float(one[r["name"]][k]))
                    / (1.0 if k == "bpp" else abs(float(one[r["name"]][k])))
                    for r in many) for k in ("bpp", "psnr", "ms_ssim")}
    row = {"cards": n, "files": len(one), "rows": len(many),
           "order_ok": [r["name"] for r in many] == order,
           "max_bpp_diff": diffs["bpp"], "max_psnr_rel_diff": diffs["psnr"],
           "max_ms_ssim_rel_diff": diffs["ms_ssim"],
           "path_s": time.perf_counter() - t_path}
    print(json.dumps({"multi_card_statistics": row}), flush=True)
    if not (row["order_ok"] and diffs["bpp"] <= 1e-6
            and diffs["psnr"] <= 1e-5 and diffs["ms_ssim"] <= 1e-5):
        raise AssertionError(f"tools.statistics over {n} cards: {row}")
    return row


def multi_card(n: int) -> int:
    """``python3 chip_smoke.py --cards N``: path 11's scale-out across the
    N cards of one host, where the no-argument run has one -- data-parallel
    training over NCCL against one process, ``ShardedCodec`` with a replica
    on each card (and ``tools.serve --sharded``), ``tools.statistics`` over
    N processes -- then the ``{"ok": true, ...}`` line."""
    import torch

    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.data.folder import dead_leaves_pool
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.ops import _build
    if torch.cuda.device_count() != n:
        print(f"chip_smoke: --cards {n}, but {torch.cuda.device_count()} "
              "cards are visible", file=sys.stderr)
        return 2
    if TRAIN_BATCH % n or BATCH % n:
        print(f"chip_smoke: batches of {BATCH} do not divide over {n} "
              "cards", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    card = card_line()
    print(card, flush=True)
    os.environ.pop(FUSED_SWITCH, None)
    os.environ.pop("MLIC_UNIFIED_Z", None)
    with tempfile.TemporaryDirectory() as pool_cache:
        os.environ["MLIC_POOL_CACHE"] = pool_cache
        print(json.dumps({"build_s": _build.build()}), flush=True)
        state = load_trained()
        model = get_model(MODEL, transform_dtype="bfloat16")
        model.load_state_dict(state)
        pool = dead_leaves_pool(2 * BATCH, HEIGHT, SEED, width=WIDTH,
                                cache_dir="")
        frames = [pool[(r % 2) * BATCH:(r % 2 + 1) * BATCH]
                  for r in range(N_REQUESTS)]
        codec = Codec(model, n_lanes=N_LANES, device="cuda")
        codec.update()
        multi_card_train(n)
        counts = sharded_path(model, codec, frames, (tuple(
            f"cuda:{i}" for i in range(n)),))
        multi_card_statistics(n, frames)
        os.environ.pop("MLIC_POOL_CACHE")
    print(json.dumps({"multi_card": {"cards": n, "launches": counts}}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# --------------------------------------------------------------------------
# Path 12: the last modules of the JAX package -- the RD and profiling
# tools, the perceptual metrics, the analysis package and stream format v2
# --------------------------------------------------------------------------
def device_proof(fn, label: str, want: dict):
    """Runs ``fn`` between two synchronizes and holds the device's count of
    each kernel's launches (``ops/_build.device_launch_counts``: the
    kernels count themselves in device memory) equal to the host's, and at
    least ``want`` ({kernel: launches}).  Independent of the profiler: a
    kernel that the host launched and the card never ran fails it.
    Prints both counts; returns (``fn()``, the host's counts)."""
    import torch

    from mlic_tpu_torch.ops import _build
    torch.cuda.synchronize()
    h0, d0 = _build.launch_counts(), _build.device_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    h1, d1 = _build.launch_counts(), _build.device_launch_counts()
    host = {k: h1[k] - h0[k] for k in h1}
    dev = {k: d1[k] - d0[k] for k in d1}
    print(json.dumps({"device_launches": {"of": label, "host": host,
                                          "device": dev}}), flush=True)
    short = {k: host[k] for k, n in want.items() if host[k] < n}
    if dev != host or short:
        raise AssertionError(f"{label}: launches on the device {dev}, by the "
                             f"host {host}; too few: {short} (want {want})")
    return out, host


# Path 12's MACs rows: (model, depthwise override) at 1920x1088.
MACS_CASES = (("MLICPP_S", None), ("MLICPP_M_SMALL_DEC", None),
              ("MLICPP_L", False), ("MLICPP_L", None))
L_PARAMS_M = {False: 83.50, None: 41.72}    # PARITY.md:11-12
METRIC_ATOL = {"lpips": 1e-5, "dists": 1e-4}  # tests/test_perceptual_metrics
METRIC_CARD_CPU = 1e-4
FREQ_CARD_CPU = 1e-6
TOOL_REPS = 5


def macs_rows() -> list:
    """``tools.macs`` at 1920x1088: torch GMACs (FlopCounterMode on the
    meta device), parameters and the forward's ms on the card, beside the
    JAX tool's XLA count (PARITY.md)."""
    from mlic_tpu_torch.tools import macs
    rows = []
    for name, dw in MACS_CASES:
        r = macs.decoder_cost(name, 1088, 1920, depthwise=dw, device="cuda")
        r["convs"] = "dense" if dw is False else "config"
        rows.append(r)
        if name == "MLICPP_L" and round(r["params_m"], 2) != L_PARAMS_M[dw]:
            raise AssertionError(f"MLICPP_L ({r['convs']}): {r['params_m']} "
                                 f"M parameters, PARITY.md has "
                                 f"{L_PARAMS_M[dw]} M")
        if not (np.isfinite(r["gmacs"]) and r["gmacs"] > 0
                and r["forward_ms"] > 0):
            raise AssertionError(f"macs: {r}")
    return rows


def with_env(env: dict, fn):
    """``fn()`` with ``env`` set, the variables restored after."""
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def profile_tools(wall_ms: dict) -> dict:
    """``tools.profile_codec`` (batch 8, 512 lanes, bfloat16, the trained
    weights) beside path 1's whole request, ``tools.microbench``'s ctx,
    encode, decode and fusedblk sets and ``tools.profile_modules``, in this
    process, a few reps each."""
    import contextlib
    import io

    from mlic_tpu_torch.tools import (microbench, profile_codec,
                                      profile_modules)

    def quiet(fn):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            return fn()

    prof = quiet(lambda: with_env(
        {"PROF_BATCH": str(BATCH), "PROF_LANES": str(N_LANES),
         "PROF_REPS": "2", "PROF_BF16": "1", "PROF_CKPT": CHECKPOINT},
        lambda: profile_codec.main([])))
    stages = prof["ms_per_image"]
    split = {ph: sum(v for k, v in stages.items() if k.startswith(ph[0]))
             * BATCH for ph in ("compress", "decompress")}
    prof["stage_sum_ms_per_batch"] = split
    prof["path1_whole_ms_per_batch"] = wall_ms
    if not prof["parametric"] or not prof["analytic_enc_rows"]:
        raise AssertionError(f"profile_codec: a fallback table: {prof}")
    bench = {}
    for which in ("ctx", "encode", "decode", "fusedblk"):
        bench[which] = quiet(lambda: with_env(
            {"MB_SET": which, "MB_REPS": str(TOOL_REPS),
             "MB_CKPT": CHECKPOINT}, lambda: microbench.main([])))
    modules = quiet(lambda: with_env({"PM_REPS": "3"},
                                     lambda: profile_modules.main([])))
    bad = [r for out in (*bench.values(), modules) for r in out["modules"]
           if not (np.isfinite(r["ms_per_call"]) and r["ms_per_call"] > 0)]
    if bad:
        raise AssertionError(f"microbench / profile_modules rows: {bad}")
    return {"profile_codec": prof, "microbench": bench,
            "profile_modules": modules}


def rd_tools(state, frames, vbr_curve: dict) -> dict:
    """``tools.jpeg_anchor`` on rd_vbr's frames and ``tools.bdrate`` of
    rd_vbr's curve (the trained MLICPP_S_VBR) against it; ``tools.rd_curve``
    on ``ckpts/bench_default`` over two of path 1's frames against
    ``evaluate_codec`` of the same weights and frames in this process."""
    from PIL import Image

    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.eval import evaluate_codec
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.tools import bdrate, jpeg_anchor, rd_curve
    out = {}
    with tempfile.TemporaryDirectory() as d:
        vbr_path = os.path.join(d, "rd_vbr.json")
        with open(vbr_path, "w") as f:
            json.dump(vbr_curve, f)
        jpeg = jpeg_anchor.main(["--out", os.path.join(d, "jpeg.json"),
                                 "--n-images", str(RD_VBR_FRAMES),
                                 "--image-size", str(RD_VBR_SIZE)])
        bd = bdrate.main(["--test", vbr_path, "--anchor",
                          os.path.join(d, "jpeg.json")])
        out["jpeg"] = {k: jpeg[k] for k in ("bpp", "psnr", "quality")}
        out["vbr"] = {k: vbr_curve[k] for k in ("bpp", "psnr")}
        out["bdrate_vbr_vs_jpeg"] = bd
        if not all(np.isfinite(v) for v in bd.values()):
            raise AssertionError(f"BD-rate against JPEG not finite: {bd}")
        img_dir = os.path.join(d, "frames")
        os.makedirs(img_dir)
        for i in range(2):
            Image.fromarray(frames[0][i]).save(
                os.path.join(img_dir, f"f{i}.png"))
        curve = rd_curve.main([
            "--model", MODEL, "--ckpts", CHECKPOINT, "--lambdas",
            str(LMBDA), "--out", os.path.join(d, "rd.json"), "--images",
            img_dir, "--n-images", "2", "--backend", "device",
            "--save-dir", os.path.join(d, "rd_eval")])
        model = get_model(MODEL)
        model.load_state_dict(state)
        codec = Codec(model, device="cuda")
        codec.update()
        ref = evaluate_codec(codec, [f.astype(np.float32) / 255.0
                                     for f in frames[0][:2]],
                             os.path.join(d, "ref_eval"), log=lambda l: None)
    out["rd_curve"] = {k: curve[k] for k in ("bpp", "psnr", "ms_ssim",
                                             "backend")}
    out["evaluate_codec"] = {k: ref[k] for k in ("bpp", "psnr", "ms_ssim")}
    if abs(curve["bpp"][0] - ref["bpp"]) > 1e-6 \
            or abs(curve["psnr"][0] - ref["psnr"]) > 1e-4:
        raise AssertionError(f"rd_curve {out['rd_curve']} differs from "
                             f"evaluate_codec {out['evaluate_codec']}")
    return out


def metrics_and_analysis(frames, x_hat) -> dict:
    """LPIPS and DISTS on seeded weights (0 on identical frames, more on a
    frame against its reconstruction, the card within METRIC_CARD_CPU of
    the CPU on a crop) and ``analysis.freq`` features and clustering on the
    card against the CPU."""
    import torch

    from mlic_tpu_torch import perceptual_metrics as pm
    from mlic_tpu_torch.analysis import cluster, freq
    a = torch.from_numpy(frames[0][:2].astype(np.float32) / 255.0)
    b = x_hat[:2].float().clamp(0, 1).cpu()
    out = {}
    for name, init, fn in (("lpips", pm.init_lpips, pm.lpips_fn),
                           ("dists", pm.init_dists, pm.dists_fn)):
        sd = init(torch.Generator().manual_seed(SEED))
        card, cpu = fn(sd, "cuda"), fn(sd, "cpu")
        same = card(a.cuda(), a.cuda()).cpu()
        diff = card(a.cuda(), b.cuda()).cpu()
        crop = (slice(None), slice(0, 128), slice(0, 128))
        on_card = card(a[crop].cuda(), b[crop].cuda()).cpu()
        on_cpu = cpu(a[crop], b[crop])
        gap = float((on_card - on_cpu).abs().max())
        out[name] = {"identical": same.tolist(), "x_vs_x_hat": diff.tolist(),
                     "card_vs_cpu_max_abs": gap}
        if float(same.abs().max()) > METRIC_ATOL[name] \
                or not float(diff.min()) > METRIC_ATOL[name] \
                or gap > METRIC_CARD_CPU:
            raise AssertionError(f"{name} on seeded weights: {out[name]}")
    imgs = list(frames[0][:4])
    card = freq.frequency_features(imgs, 16, "cuda")
    cpu = freq.frequency_features(imgs, 16, "cpu")
    gap = float(np.abs(card - cpu).max())
    clusters = cluster.cluster_images(imgs, k=2, device="cuda")
    out["freq"] = {"features_card_vs_cpu_max_abs": gap,
                   "labels": clusters["labels"].tolist()}
    if gap > FREQ_CARD_CPU:
        raise AssertionError(f"analysis.freq: card and CPU differ by {gap}")
    return out


def v2_host_streams(codec, sym, idx) -> list:
    """The port's host ``encode_interleaved`` of each image's y phases,
    each phase padded to a lane multiple with pad-row symbols: the oracle
    of the device's v2 bytes."""
    from mlic_tpu_torch.entropy.rans.coder import encode_interleaved
    _, lengths, offsets, table = codec._gauss
    n_phases = 2 * codec.model.cfg.slice_num
    n_per = sym.shape[1] // n_phases
    pad = -n_per % N_LANES
    sym = np.pad(sym.reshape(len(sym), n_phases, n_per),
                 ((0, 0), (0, 0), (0, pad)))
    idx = np.pad(idx.reshape(len(idx), n_phases, n_per),
                 ((0, 0), (0, 0), (0, pad)),
                 constant_values=codec.z_rows_base - 1)
    return [encode_interleaved(s_b.ravel(), i_b.ravel(), N_LANES, table,
                               lengths, offsets) for s_b, i_b in zip(sym, idx)]


def v2_path(codec) -> list:
    """Format v2 on path 1's batch-8 payload at 512 lanes: the device
    encode (K7, K3, the per-lane compaction) byte-equal to the host coder;
    K4's lane layout decoding every y phase, parametric and by the integer
    rows, exactly back to the payload, each launch against its plain
    version; timed (the kernels line's ``lanes`` rows)."""
    import torch

    from mlic_tpu_torch.entropy import device_rans as dr
    from mlic_tpu_torch.entropy.stream import (assemble_lane_streams,
                                               lane_decode_inputs)
    from mlic_tpu_torch.ops import _build
    dev, tables = codec.device, codec.tables
    n_phases = 2 * codec.model.cfg.slice_num
    sym_np, idx_np, _ = make_payload(codec, np.random.default_rng(SEED + 12))
    sym, idx = (torch.from_numpy(a).to(dev) for a in (sym_np, idx_np))
    enc = functools.partial(dr.encode_interleaved_device, sym, idx, tables,
                            N_LANES, n_phases, "lanes",
                            codec.analytic_enc_rows)
    comp, _ = device_proof(enc, "v2 encode", {"rans_encode_prep": 1,
                                              "rans_encode_scan": 1})
    streams = assemble_lane_streams(comp, N_LANES)
    host = v2_host_streams(codec, sym_np, idx_np)
    if streams != host:
        bad = [b for b, (s1, s2) in enumerate(zip(streams, host)) if s1 != s2]
        raise AssertionError(f"v2: device bytes differ from the host coder's "
                             f"for images {bad}")
    args = lane_decode_inputs(streams, dev)
    pad_row = codec.z_rows_base - 1
    n_per = idx.shape[1] // n_phases
    lengths = codec._gauss[1]
    row_steps = int(np.ceil(np.log2(lengths.max())))
    rows_ph = [dr.phase_order(idx[:, k * n_per:(k + 1) * n_per], N_LANES,
                              pad_row).contiguous() for k in range(n_phases)]
    out = []
    for mode, parametric, steps in (("lanes", True, codec.n_steps),
                                    ("lanes_rows", False, row_steps)):
        x, ptr = dr.rans_init(args["words"], args["lane_begin"])
        esc_count = torch.zeros_like(args["esc_begin"])
        decoded, err, timed = [], 0.0, None
        h0 = _build.launch_counts()["rans_decode_phase"]

        def run_phases():
            nonlocal x, ptr, esc_count, err, timed
            for k, rws in enumerate(rows_ph):
                call = functools.partial(
                    dr.rans_decode_phase, args["words"], x, ptr, N_LANES,
                    steps, rws, tables, parametric, "lanes")
                got = call()
                ref = dr.rans_decode_phase_plain(
                    args["words"], x, ptr, N_LANES, steps, rws, tables,
                    parametric, "lanes")
                err = max(err, max_abs_err(zip(got, ref)))
                if k == 0:
                    timed = (call, functools.partial(
                        dr.rans_decode_phase_plain, args["words"], x, ptr,
                        N_LANES, steps, rws, tables, parametric, "lanes"),
                        rws, got, ptr)
                sym_k, esc_count = dr.patch_escapes(
                    got[0], got[1], esc_count, args["esc"],
                    args["esc_begin"], N_LANES)
                decoded.append(sym_k.reshape(-1, BATCH, N_LANES).permute(
                    1, 0, 2).reshape(BATCH, -1)[:, :n_per])
                x, ptr = got[2], got[3]

        device_proof(run_phases, f"K4 {mode}",
                     {"rans_decode_phase": n_phases})
        launches = _build.launch_counts()["rans_decode_phase"] - h0
        if err != 0.0 or not torch.equal(torch.cat(decoded, 1), sym):
            raise AssertionError(f"K4 {mode}: max abs err {err} against its "
                                 f"plain version, or the payload differs")
        call, plain, rws, got1, ptr0 = timed
        P = rws.numel()
        consumed = int((got1[3] - ptr0).sum())
        table_bytes = (tables["row_params"] if parametric
                       else tables["cdf_rows"]).numel() * 4
        ops = (float(torch.floor(torch.log2(tables["row_params"][
            rws.long(), 5].double().clamp(min=1))).sum()) * CDF_OPS + 20 * P
            if parametric else P * (2 * steps + 20))
        bms, by = bound(4 * P + 5 * P + 2 * consumed + 16 * rws.shape[1]
                        + table_bytes, ops)
        group = dr.decode_group(N_LANES)
        rounds = -(-steps // (group.bit_length() - 1))
        row = {"name": "rans_decode_phase", "mode": mode, "route": "cuda",
               "source": "mlic_tpu_torch/csrc/rans_decode.cu",
               "replaces": "mlic_tpu/entropy/device_rans.py:169",
               "launches": launches, "status": "exact", "max_abs_err": err,
               "ms": cuda_ms(call, 10), "plain_ms": cuda_ms(plain, 1),
               "bound_ms": bms, "bound_by": by, "library_ms": None,
               "kernel_ms": kernel_ms(call,
                                      KERNEL_SYMBOLS["rans_decode_phase"]),
               "queued_ms": queued_ms(call), "shape": list(rws.shape),
               "levels": steps, "phases_checked": n_phases,
               "threads_per_lane": group, "steps": rws.shape[0]}
        if not parametric:
            # the chain, as the global layout's row mode: each step waits
            # on rounds - 1 dependent loads of the rows after the first,
            # each an L2 hit at least, then its word read
            mhz = sm_clock_max_mhz()
            row.update(chain_bound_ms=rws.shape[0] * rounds * L2_HIT_CYCLES
                       / (mhz * 1e3), chain_loads_a_step=rounds,
                       l2_hit_cycles=L2_HIT_CYCLES, sm_clock_max_mhz=mhz)
        out.append(row)
    print(json.dumps({"v2_path": {"images": BATCH, "lanes": N_LANES,
                                  "bytes": [len(s) for s in streams],
                                  "device_equals_host": True,
                                  "k4_lanes": out}}), flush=True)
    return out


def last_modules_path(state, codec, frames, wall_ms: dict,
                      vbr_curve: dict) -> tuple:
    """Path 12 (the ``last_modules`` line): ``tools.macs``,
    ``tools.profile_codec``, ``tools.microbench``, ``tools.profile_modules``,
    ``tools.jpeg_anchor`` with ``tools.bdrate`` against rd_vbr's curve,
    ``tools.rd_curve`` against ``evaluate_codec``, LPIPS and DISTS, the
    analysis package and format v2 with K4's lane layout.  Returns the
    path's launch counts and K4's lane-layout rows of the kernels line."""
    from mlic_tpu_torch.ops import _build
    t0 = time.perf_counter()

    def run():
        enc = codec.compress(frames[0])
        out = {"macs": macs_rows(), **profile_tools(wall_ms),
               "rd": rd_tools(state, frames, vbr_curve),
               "metrics_analysis": metrics_and_analysis(frames,
                                                        enc["x_hat"])}
        return out, v2_path(codec)

    # every kernel ran on the card in this path, by its own device count
    (out, lanes_rows), counts = device_proof(
        run, "path 12", dict.fromkeys(_build.KERNELS, 1))
    out.update(launches=counts, path_s=time.perf_counter() - t0)
    print(json.dumps({"last_modules": out}), flush=True)
    return counts, lanes_rows


# Path 13: batch invariance.  K8's products at batches 1, 8 and 128 against
# their plain versions; the JAX package's batch contract on the card.
K8_BATCHES = (1, 8, 128)
# |kernel - plain| <= 2 gamma_K (|A|.|B| + |bias|) elementwise, gamma_K =
# K u / (1 - K u), u = 2^-24: both sum the same K products of f32 values in
# other orders, each within gamma_K of the exact sum (the a priori bound of a
# K-long f32 sum).  bf16 operands add 2^-6 (|A|.|B| + |bias|): K8 rounds
# its f32 sum to bf16 once, cuDNN the product and again after its bias.
K8_BF16_TOL = 2.0 ** -6
K8_OPS = ("linear", "kt_v", "ctx_q", "conv2d")
K8_SOURCE = "mlic_tpu_torch/csrc/invariant_matmul.cu"
K8_REPLACES = ("none (XLA products of mlic_tpu/models/context.py:172, "
               ":218-219, :237, :272, and the analysis transforms' "
               "convolutions that cuDNN orders by the batch)")


def k8_per_direction(cfg) -> int:
    """K8's launches in the entropy path of one coding direction: each
    slice's window fusion, and from the second slice on the inter and
    intra contexts' two contractions and reprojection."""
    return cfg.slice_num + 6 * (cfg.slice_num - 1)


def k8_in_analysis(cfg) -> int:
    """K8's launches in g_a and h_a (``models/transforms.py``): the 1x1
    convolutions over the image's channels (two in a depthwise encoder,
    the skip alone in a dense one), and in a dense encoder the four 3x3
    convolutions of g_a's last stage, g_a's last convolution and h_a's
    five."""
    if cfg.depthwise and not cfg.small_decoder:
        return 2
    return 1 + 4 + 1 + 5


def capture_products(codec, x) -> list:
    """The K8 calls of one compress and one decompress of ``x``: [(op,
    args, kwargs, direction)], the arguments as the model handed them."""
    from mlic_tpu_torch.ops import invariant_matmul as im
    calls, where = [], ["compress"]
    orig = {n: getattr(im, n) for n in K8_OPS}

    def wrap(name):
        def f(*args, **kwargs):
            calls.append((name, args, kwargs, where[0]))
            return orig[name](*args, **kwargs)
        return f
    for n in K8_OPS:
        setattr(im, n, wrap(n))
    try:
        enc = codec.compress(x)
        where[0] = "decompress"
        codec.decompress(enc["strings"], enc["shape"])
    finally:
        for n in K8_OPS:
            setattr(im, n, orig[n])
    return calls


def _k8_shape(name, args) -> dict:
    """(groups, M, N, K) of one call, its bytes (each input once, the
    output once) and f32 operations."""
    a, b = args[0], args[1]
    es = a.element_size()
    if name == "linear":
        g, k, n = a.shape[0], a.shape[-1], b.shape[0]
        m = a[0].numel() // k
        nbytes = a.numel() * es + b.numel() * es + g * m * n * es
    elif name == "kt_v":
        g, m, n, k = a.shape[0] * a.shape[2], a.shape[3], b.shape[3], \
            a.shape[1]
        nbytes = (a.numel() + b.numel() + g * m * n) * es
    elif name == "ctx_q":
        g, m, n, k = b.shape[0] * b.shape[2], b.shape[1], a.shape[3], \
            b.shape[3]
        nbytes = (a.numel() + b.numel() + g * m * n) * es
    else:
        s = args[3] if len(args) > 3 else 1
        g, n, win = a.shape[0], b.shape[0], b.shape[-1]
        m = ((a.shape[2] - 1) // s + 1) * ((a.shape[3] - 1) // s + 1)
        k = a.shape[1] * win * win
        nbytes = (a.numel() + b.numel() + g * m * n) * es
    if len(args) > 2 and args[2] is not None:
        nbytes += args[2].numel() * es
    return {"groups": g, "mnk": [m, n, k], "bytes": nbytes,
            "ops": 2.0 * g * m * n * k}


def _k8_images(name, args, pick):
    """``args`` with ``pick`` applied to the operands that carry the image
    axis (both of an attention contraction, the input of the others)."""
    lead = (0, 1) if name in ("kt_v", "ctx_q") else (0,)
    return tuple(pick(t) if i in lead else t for i, t in enumerate(args))


def _k8_batch(name, args, b: int):
    """``args`` at batch ``b``: the first ``b`` images, or the captured
    batch repeated."""
    import torch
    n = args[0].shape[0]
    return _k8_images(name, args, lambda t: t[:b] if b <= n else torch.cat(
        [t] * (-(-b // n)))[:b])


def _k8_absref(name, args):
    """The same product of |operands| in float64: the scale of the bound."""
    import torch
    a = [None if t is None or not torch.is_tensor(t) else t.double().abs()
         for t in args]
    if name == "linear":
        return torch.nn.functional.linear(a[0], a[1], a[2])
    if name == "kt_v":
        return torch.einsum("bnhd,bnhe->bhde", a[0], a[1])
    if name == "ctx_q":
        return torch.einsum("bhde,bnhd->bnhe", a[0], a[1])
    s = args[3] if len(args) > 3 else 1
    return torch.nn.functional.conv2d(a[0], a[1], a[2], s,
                                      args[1].shape[-1] // 2)


_K8_ORACLE = {}


def k8_oracle():
    """K8's chain oracle (``_build.ORACLES``: one thread an output, the
    plain fmaf loop, not counted on the device) as ``run(fn, args)``: the
    product ``fn`` of ``ops/invariant_matmul`` through the same wrapper and
    ``Problem``, launched on the oracle's entry point."""
    from mlic_tpu_torch.ops import _build
    from mlic_tpu_torch.ops import invariant_matmul as im
    if "fn" not in _K8_ORACLE:
        _K8_ORACLE["fn"] = _build.KERNELS["invariant_matmul"].function(
            *_build.ORACLES["invariant_matmul"])
    entry = _K8_ORACLE["fn"]

    class Oracle:
        def launch(self, *a):
            rc = entry(*a)
            if rc != 0:
                raise RuntimeError(f"K8's oracle failed to launch "
                                   f"(cudaError {rc})")

    def run(fn, args):
        old = im.KERNEL, im.ROUTE
        im.KERNEL, im.ROUTE = Oracle(), "kernel"
        try:
            return fn(*args)
        finally:
            im.KERNEL, im.ROUTE = old
    return run


def k8_timed(name, fn, xb) -> dict:
    """K8's times on ``xb`` (back to back, queued), its bound, the one
    batched PyTorch call and the per-image loop; at BIG_BATCH, for a
    product bound by operations, the SM clock and power under its load."""
    from mlic_tpu_torch.ops import invariant_matmul as im
    sb = _k8_shape(name, xb)
    bms, by = bound(sb["bytes"], sb["ops"])
    row = {"batch": xb[0].shape[0], "ms": cuda_ms(lambda: fn(*xb), 5),
           "queued_ms": queued_ms(lambda: fn(*xb), 5), "bound_ms": bms,
           "bound_by": by, "bound_parts_ms": [sb["bytes"] / HBM_BPS * 1e3,
                                              sb["ops"] / F32_OPS * 1e3]}
    old = im.ROUTE
    try:
        im.ROUTE = "batched"
        row["library_ms"] = cuda_ms(lambda: fn(*xb), 5)
        im.ROUTE = "plain"
        row["plain_ms"] = cuda_ms(lambda: fn(*xb), 2)
    finally:
        im.ROUTE = old
    row["share_of_bound"] = bms / row["queued_ms"]
    if row["batch"] == BIG_BATCH and by == "operations":
        row["under_load"] = clocks_under_load(lambda: fn(*xb))
    return row


def k8_case(name, args, label: str, oracle, timed_at=(),
            batches=K8_BATCHES) -> dict:
    """One product at each batch of ``batches``: bit-equal to the chain
    oracle (``oracle`` from ``k8_oracle``), image i of batch B bit-equal to
    K8 on image i alone, every row within the stated bound of the plain
    version; timed at each batch of ``timed_at`` (``at_batch_<B>``,
    ``k8_timed``)."""
    import torch

    from mlic_tpu_torch.ops import invariant_matmul as im
    fn = getattr(im, name)
    x8 = _k8_batch(name, args, min(8, args[0].shape[0]))
    n8 = x8[0].shape[0]
    one = [fn(*_k8_images(name, x8, lambda t, i=i: t[i:i + 1]))
           for i in range(n8)]
    shape = _k8_shape(name, x8)
    k = shape["mnk"][2]
    u = 2.0 ** -24
    gamma = k * u / (1 - k * u)
    bf16 = args[0].dtype == torch.bfloat16
    absref = _k8_absref(name, x8)
    tol = 2 * gamma * absref + (K8_BF16_TOL * absref if bf16 else 0.0)
    row = {"model": label, "op": name, "dtype": str(args[0].dtype),
           "shape_a_image": list(args[0].shape[1:]),
           "groups_per_image": shape["groups"] // n8, "mnk": shape["mnk"],
           "max_abs_err": 0.0, "max_err_over_bound": 0.0,
           "rows_equal_batch_1": True, "oracle_equal": True}
    for b in batches:
        xb = _k8_batch(name, x8, b)
        got = fn(*xb)
        row["oracle_equal"] &= torch.equal(got, oracle(fn, xb))
        old, im.ROUTE = im.ROUTE, "plain"
        try:
            ref = fn(*xb)
        finally:
            im.ROUTE = old
        for c in range(0, b, n8):
            d = (got[c:c + n8].double() - ref[c:c + n8].double()).abs()
            t = tol[:min(n8, b - c)]
            row["max_abs_err"] = max(row["max_abs_err"], float(d.max()))
            row["max_err_over_bound"] = max(
                row["max_err_over_bound"],
                float((d / t.clamp(min=1e-300)).max()))
        same = all(torch.equal(got[i], one[i % n8][0]) for i in range(b))
        row["rows_equal_batch_1"] &= same
        del got, ref
    for b in timed_at:
        row[f"at_batch_{b}"] = k8_timed(name, fn, _k8_batch(name, x8, b))
    if row["max_err_over_bound"] > 1.0 or not row["rows_equal_batch_1"] \
            or not row["oracle_equal"]:
        raise AssertionError(f"K8 {label} {name}: {row}")
    return row


def k8_cases(codec, x, label: str, timed_at=(), batches=K8_BATCHES) -> list:
    """K8 against its chain oracle and its plain version at every product
    shape of one compress and one decompress of ``x`` by ``codec``
    (``k8_case`` a shape at ``batches``, timed at the batches of
    ``timed_at``), each case with the calls it stands for in each
    direction."""
    import torch
    with torch.no_grad():
        return _k8_cases(codec, x, label, timed_at, k8_oracle(), batches)


def _k8_cases(codec, x, label: str, timed_at, oracle, batches) -> list:
    calls = capture_products(codec, x)
    cases = {}
    for name, args, kwargs, direction in calls:
        args = args + tuple(kwargs.values())
        key = (name, tuple(tuple(t.shape) if hasattr(t, "shape") else t
                           for t in args))
        if key not in cases:
            cases[key] = (name, args, {"compress": 0, "decompress": 0})
        cases[key][2][direction] += 1
    rows = []
    for name, args, per in cases.values():
        row = k8_case(name, args, label, oracle, timed_at, batches)
        row["calls"] = per
        rows.append(row)
    want = {"compress": k8_per_direction(codec.model.cfg)
            + k8_in_analysis(codec.model.cfg),
            "decompress": k8_per_direction(codec.model.cfg)}
    got = {d: sum(r["calls"][d] for r in rows) for d in want}
    if got != want:
        raise AssertionError(f"K8 {label}: calls {got} a direction, the "
                             f"configuration gives {want}")
    print(json.dumps({"k8_cases": {"model": label, "cases": rows}}),
          flush=True)
    return rows


def k8_edge_cases() -> list:
    """K8 against its chain oracle and its plain version at ragged shapes
    that no model gives it (``k8_case`` each, seeded operands): the byte
    path at a pixel count that is not a multiple of 8, over a strided view,
    f32 and bf16; the halo gather at image sizes that are no multiple of
    its tile (f32 5x5 at 32, 64 and 96 outputs, over a channels-last view;
    bf16 3x3 at strides 1 and 2, at 64 outputs and at the widths of the
    dense encoders that no multiple of 64 divides: 32 (MLICPP_TINY's h_a),
    96 (MLICPP_S's h_a) and 160 (its g_a.out), at image sizes whose
    batch of 128 takes the tall tiles); the tiled f32 gather at 3x3 over
    an odd
    channel count (a half K tile) with 40 outputs, at 5x5 and stride 2, and
    a 1x1 of stride 2 over 20 channels; a 1x1 read in place (16-byte
    copies along the pixels) over 108 pixels; linears of K 17 and N 24 or
    64 (4-byte copies with checks), and of whole tiles at N 96 (64 and 128
    rows: the copies that step by a constant);
    the attention contractions at odd widths (16-byte copies) and over
    views that start one element in (4-byte copies)."""
    import torch

    from mlic_tpu_torch.device import configure_determinism
    configure_determinism()             # the plain version without TF32
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)
    bf = torch.bfloat16
    img = r(2, 3, 14, 19)
    imb = r(2, 3, 14, 19, dtype=bf)
    cases = [
        ("conv2d", (img[..., ::2, ::2], r(5, 3, 1, 1), r(5))),
        ("conv2d", (imb[..., ::2, ::2], r(5, 3, 1, 1, dtype=bf),
                    r(5, dtype=bf))),
        ("conv2d", (r(2, 5, 9, 11), r(40, 5, 3, 3), r(40))),
        ("conv2d", (r(2, 6, 9, 11, dtype=bf), r(64, 6, 3, 3, dtype=bf),
                    None)),
        ("conv2d", (r(2, 4, 13, 10, dtype=bf), r(64, 4, 3, 3, dtype=bf),
                    r(64, dtype=bf), 2)),
        ("conv2d", (r(2, 3, 13, 21), r(96, 3, 5, 5), r(96))),
        ("conv2d", (r(2, 3, 13, 21), r(32, 3, 5, 5), r(32))),
        ("conv2d", (r(2, 6, 13, 21, dtype=bf), r(32, 6, 3, 3, dtype=bf),
                    r(32, dtype=bf))),
        ("conv2d", (r(2, 6, 17, 35, dtype=bf), r(32, 6, 3, 3, dtype=bf),
                    None, 2)),
        ("conv2d", (r(2, 4, 13, 21, dtype=bf), r(96, 4, 3, 3, dtype=bf),
                    r(96, dtype=bf))),
        ("conv2d", (r(2, 4, 17, 35, dtype=bf), r(96, 4, 3, 3, dtype=bf),
                    r(96, dtype=bf), 2)),
        ("conv2d", (r(2, 8, 11, 19, dtype=bf), r(160, 8, 3, 3, dtype=bf),
                    None)),
        ("conv2d", (r(2, 8, 17, 35, dtype=bf), r(160, 8, 3, 3, dtype=bf),
                    r(160, dtype=bf), 2)),
        ("conv2d", (r(2, 7, 13, 10), r(64, 7, 5, 5), r(64), 2)),
        ("conv2d", (r(2, 20, 9, 12), r(96, 20, 1, 1), None, 2)),
        ("conv2d", (r(2, 20, 9, 12), r(96, 20, 1, 1), r(96))),
        ("conv2d", (r(2, 9, 11, 6).permute(0, 3, 1, 2), r(64, 6, 5, 5),
                    r(64))),
        ("linear", (r(2, 33, 17), r(24, 17), r(24))),
        ("linear", (r(2, 33, 17), r(64, 17), r(64))),
        ("linear", (r(2, 64, 32), r(96, 32), None)),
        ("linear", (r(8, 384, 16), r(96, 16), r(96))),
        ("kt_v", (r(2, 37, 3, 12), r(2, 37, 3, 20))),
        ("ctx_q", (r(2, 3, 12, 20), r(2, 37, 3, 12))),
        ("kt_v", (r(2, 37, 3, 13)[..., 1:], r(2, 37, 3, 13)[..., 1:])),
    ]
    oracle = k8_oracle()
    rows = []
    with torch.no_grad():
        for name, args in cases:
            rows.append(k8_case(name, args, "edge", oracle))
    print(json.dumps({"k8_edge_cases": rows}), flush=True)
    return rows


def k8_row(cases: list, counts: dict) -> dict:
    """K8's row of the kernels line: MLICPP_S's products at batch 128
    summed over the calls of one direction (decompress; compress adds the
    analysis convolutions), the same sums for every model at every batch
    it was timed at (``per_direction_<model>_<batch>``), the errors over
    every case of every model."""
    def directions(rows, key):
        out = {d: {k: sum(r[key][k] * r["calls"][d] for r in rows) for k in (
            "ms", "queued_ms", "plain_ms", "library_ms", "bound_ms")}
            for d in ("compress", "decompress")}
        for d in out:
            out[d]["launches"] = sum(r["calls"][d] for r in rows)
        return out
    sums = {}
    for model in dict.fromkeys(r["model"] for r in cases):
        rows = [r for r in cases if r["model"] == model]
        for key in (k for k in rows[0] if k.startswith("at_batch_")):
            sums[f"{model}_{key[3:]}"] = directions(rows, key)
    s128 = [r for r in cases if r["model"] == MODEL]
    key = f"at_batch_{BIG_BATCH}"
    parts = [sum(r[key]["bound_parts_ms"][i] * r["calls"]["decompress"]
                 for r in s128) for i in (0, 1)]
    dec = sums[f"{MODEL}_batch_{BIG_BATCH}"]["decompress"]
    return {"name": "invariant_matmul", "route": "cuda", "source": K8_SOURCE,
            "replaces": K8_REPLACES, "launches": counts["invariant_matmul"],
            "status": "within bound, batch-invariant",
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "max_err_over_bound": max(r["max_err_over_bound"]
                                      for r in cases),
            "oracle_equal": all(r["oracle_equal"] for r in cases),
            **{k: dec[k] for k in ("ms", "queued_ms", "plain_ms",
                                   "library_ms", "bound_ms")},
            "bound_by": "bytes" if parts[0] >= parts[1] else "operations",
            "batch": BIG_BATCH, "model": MODEL,
            "per_direction": sums, "cases_checked": len(cases)}


def big_request(codec, x) -> dict:
    """The main path's batch of 128 timed: two more whole requests (after
    ``serve``'s), a profiled compress and decompress (device busy ms, idle
    share against the whole medians, K8's ms and launches, the launches
    held to what the configuration gives), peak memory, and the device's
    own launch counts of one compress held equal to the host's."""
    import torch
    whole = {"compress": [], "decompress": []}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = codec.compress(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        codec.decompress(enc["strings"], enc["shape"])
        torch.cuda.synchronize()
        whole["compress"].append((t1 - t0) * 1e3)
        whole["decompress"].append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall = {k: float(np.median(v)) for k, v in whole.items()}
    prof = profile_request(codec, x, wall, label="profile_batch_128")
    cfg = codec.model.cfg
    want = {"compress": k8_per_direction(cfg) + k8_in_analysis(cfg),
            "decompress": k8_per_direction(cfg)}
    k8 = {p: prof[p]["port_kernels_ms_launches"]["invariant_matmul"]
          for p in want}
    if {p: k8[p][1] for p in want} != want:
        raise AssertionError(f"batch 128: the profile finds K8's launches "
                             f"{k8}, the configuration gives {want}")
    _, host = device_proof(lambda: codec.compress(x), "batch_128 compress",
                           {"invariant_matmul": 1})
    row = {"batch": list(x.shape), "whole_ms": whole, "peak_mem_gib": peak,
           "launches_compress": host, "k8_profiler_ms_launches": k8,
           "kernel_launches": {p: prof[p]["kernel_launches"]
                               for p in ("compress", "decompress")},
           "idle_share": {p: prof[p]["idle_share"]
                          for p in ("compress", "decompress")}}
    print(json.dumps({"batch_128_request": row}), flush=True)
    return row


def batch_contract_phase(codec, frames, label: str) -> dict:
    """``tools.batch_contract.check`` on the card: the batch's streams
    against each image's alone byte for byte, every hooked entropy-path
    module's entries, the containers at its fixed indices decoded alone.
    Raises on any count that is not 0."""
    from mlic_tpu_torch.tools import batch_contract as bc
    t0 = time.perf_counter()
    res = bc.check(codec, frames)
    res.pop("module_entries")
    res.update(model=label, broken=bc.broken(res),
               phase_s=time.perf_counter() - t0)
    print(json.dumps({"batch_contract": res}), flush=True)
    if res["broken"]:
        raise AssertionError(f"batch contract of {label} at batch "
                             f"{len(frames)}: {res['broken']}")
    return res


# Path 14: the published MLIC++ architecture, dense MLICPP_L (N 192, M 320,
# 10 slices; the reference's converter: "published MLIC++ weights use dense
# convs"), from a checkpoint in the reference's format; and dense MLICPP_S,
# whose h_a (N 96) and g_a.out (M 160) K8 takes on its bf16 halo path.  No
# trained published weights are in the repository: both run seeded weights,
# so their rates test plumbing only.
PUBLISHED_MODEL = "MLICPP_L"
PUBLISHED_LABEL = "MLICPP_L_dense"
PUBLISHED_REQUESTS = 2
DENSE_S_LABEL = "MLICPP_S_dense"
K8_PUBLISHED_BATCHES = (1, 8)


def reference_checkpoint(model, path: str) -> dict:
    """``model``'s seeded weights (``init_params``) written as the
    reference writes a checkpoint: ``{"epoch", "state_dict"}``, the names
    under ``module.`` (``torch.nn.DataParallel``'s) and compressai's
    buffers beside the parameters (the CDF tables, the scale table, the
    Swin index), which the converter skips.  Returns the port's
    state_dict the file was made from."""
    import torch

    from mlic_tpu_torch.tools.convert_reference_checkpoint import \
        to_reference
    from mlic_tpu_torch.weights import init_params
    cfg = model.cfg
    want = init_params(model, torch.Generator().manual_seed(SEED))
    sd = to_reference(want, cfg)
    i32 = torch.int32
    for part, rows in (("entropy_bottleneck", cfg.N),
                       ("gaussian_conditional", 64)):
        sd[f"{part}._quantized_cdf"] = torch.zeros(rows, 64, dtype=i32)
        sd[f"{part}._offset"] = torch.zeros(rows, dtype=i32)
        sd[f"{part}._cdf_length"] = torch.zeros(rows, dtype=i32)
    sd["gaussian_conditional.scale_table"] = torch.exp(
        torch.linspace(np.log(0.11), np.log(256.0), 64))
    win = cfg.context_window ** 2
    for i in range(cfg.slice_num):
        sd[f"local_context.{i}.relative_position_index"] = torch.zeros(
            win, win, dtype=torch.long)
    torch.save({"epoch": 0, "state_dict": {f"module.{k}": v
                                           for k, v in sd.items()}}, path)
    return want


def dense_s_request(frames, k8_all: list, contracts: list) -> dict:
    """Dense MLICPP_S in bf16 on seeded weights at 512 lanes: one request
    of a batch of 8, bit-exact with the launches its configuration gives
    (K8 11 times in g_a and h_a: g_a's last stage and h_a's five at N 96
    and g_a.out at M 160 on the bf16 halo path); the batch contract at 8
    and K8 at its product shapes at batches 1 and 8 (timed at 8).  Returns
    the request's row and the launch counts of ``update`` and the
    request."""
    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.ops import _build
    _build.reset_launch_counts()
    model = seeded_model(MODEL, "bfloat16", depthwise=False)
    codec = Codec(model, n_lanes=N_LANES, device="cuda")
    codec.update()
    rows = serve(codec, frames[:1], DENSE_S_LABEL, model.cfg)
    counts = _build.launch_counts()
    contracts.append(batch_contract_phase(codec, frames[0], DENSE_S_LABEL))
    k8_all += k8_cases(codec, frames[0], DENSE_S_LABEL, timed_at=(BATCH,),
                       batches=K8_PUBLISHED_BATCHES)
    return {"rows": rows, "launches": counts}


def published_path(frames, k8_all: list, contracts: list) -> dict:
    """Path 14.  Dense MLICPP_S (``dense_s_request``); then dense
    MLICPP_L under ``bfloat16``: its seeded weights written as a reference
    checkpoint (``reference_checkpoint``), converted by ``python -m
    mlic_tpu_torch.tools.convert_reference_checkpoint --dense --strict``
    in a subprocess, read by ``weights.load_checkpoint`` bit-equal to the
    weights written and loaded strictly; ``Codec.update`` at 512 lanes
    (no fallback), PUBLISHED_REQUESTS requests of batches of 8, each
    bit-exact with the launches the configuration gives, every coding
    kernel launched and K5 not; one more request whose device-side launch
    counts equal the host's; a profile (device busy ms, idle share); the
    batch contract at 8 and K8 at every product shape at batches 1 and 8
    against its chain oracle (timed at 8).  Returns the launch counts."""
    import torch

    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.ops import _build
    from mlic_tpu_torch.weights import load_checkpoint
    t_path = time.perf_counter()
    dense_s = dense_s_request(frames, k8_all, contracts)
    model = get_model(PUBLISHED_MODEL, transform_dtype="bfloat16",
                      depthwise=False)
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "mlicpp_l_dense.pth.tar")
        dst = os.path.join(d, "mlicpp_l_dense.pt")
        want = reference_checkpoint(model, src)
        cmd = [sys.executable, "-m",
               "mlic_tpu_torch.tools.convert_reference_checkpoint",
               "--torch-ckpt", src, "--model", PUBLISHED_MODEL, "--dense",
               "--strict", "--out", dst]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        cli_s = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"converter CLI failed ({proc.returncode})"
                                 f": {proc.stderr[-3000:]}")
        state = load_checkpoint(dst)
    if sorted(state) != sorted(want) \
            or not all(torch.equal(state[k], want[k]) for k in want):
        raise AssertionError("path 14: the converted weights differ from "
                             "the weights written")
    model.load_state_dict(state, strict=True)
    cfg = model.cfg
    _build.reset_launch_counts()
    codec = Codec(model, n_lanes=N_LANES, device="cuda")
    t0 = time.perf_counter()
    codec.update()
    update_s = time.perf_counter() - t0
    if not codec.parametric or not codec.analytic_enc_rows:
        raise AssertionError(f"{PUBLISHED_LABEL}: Codec.update took a "
                             "fallback")
    in_update = _build.launch_counts()
    rows = serve(codec, [frames[r % len(frames)]
                         for r in range(PUBLISHED_REQUESTS)],
                 PUBLISHED_LABEL, cfg)
    counts = _build.launch_counts()
    missing = [k for k, v in counts.items()
               if v <= 0 and k != "fused_block_tail"]
    if missing or counts["fused_block_tail"] \
            or not (in_update["select_rows"] and in_update["eval_cdf"]):
        raise AssertionError(f"path 14: launches {counts}, in update "
                             f"{in_update}")

    def request():
        enc = codec.compress(frames[0])
        return codec.decompress(enc["strings"], enc["shape"])
    want_launches = request_launches(cfg)
    _, host = device_proof(request, f"{PUBLISHED_LABEL} request",
                           {k: v for k, v in want_launches.items() if v})
    check_request_launches(host, cfg, f"{PUBLISHED_LABEL} device proof")
    prof = profile_request(codec, frames[0],
                           {"compress": rows[-1]["encode_ms"],
                            "decompress": rows[-1]["decode_ms"]},
                           label="profile_published_L")
    contracts.append(batch_contract_phase(codec, frames[0], PUBLISHED_LABEL))
    k8_all += k8_cases(codec, frames[0], PUBLISHED_LABEL, timed_at=(BATCH,),
                       batches=K8_PUBLISHED_BATCHES)
    out = {"model": PUBLISHED_LABEL, "depthwise": cfg.depthwise,
           "weights": "seeded, written in the reference's format, "
                      "converted by the port's CLI",
           "parameters": sum(t.numel() for t in state.values()),
           "converter_cli_s": cli_s,
           "converter_stdout": proc.stdout.strip()[-400:],
           "transform_dtype": "bfloat16", "lanes": N_LANES,
           "update_s": update_s, "launches_in_update": in_update,
           "launches": counts, "launches_a_request": want_launches,
           "requests": rows,
           "device_busy_ms": {p: prof[p]["device_busy_ms"] for p in prof},
           "idle_share": {p: prof[p]["idle_share"] for p in prof},
           "dense_s": dense_s, "path_s": time.perf_counter() - t_path}
    print(json.dumps({"published_path": out}), flush=True)
    del codec, model
    return {"published_L": counts, "dense_S": dense_s["launches"]}


def main(argv=None) -> int:
    import argparse

    import torch
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, default=None,
                   help="run only path 11's scale-out across this many "
                        "cards of one host")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if args.cards is not None:
        return multi_card(args.cards)
    torch.set_grad_enabled(False)       # path 3 enables it for training
    from mlic_tpu_torch.codec import Codec
    from mlic_tpu_torch.data.folder import dead_leaves_pool
    from mlic_tpu_torch.models.registry import get_model
    from mlic_tpu_torch.ops import _build
    from mlic_tpu_torch.tools.batch_contract import contract_frames

    card = card_line()
    print(card, flush=True)
    os.environ.pop(FUSED_SWITCH, None)      # path 1 runs the unfused tails
    os.environ.pop("MLIC_UNIFIED_Z", None)  # format v4
    # the CLIs' dead-leaves pools render once into a directory of this run
    pool_cache = tempfile.TemporaryDirectory()
    os.environ["MLIC_POOL_CACHE"] = pool_cache.name
    t0 = time.perf_counter()
    per = _build.build()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "per_kernel_s": per}), flush=True)

    state = load_trained()
    model = get_model(MODEL, transform_dtype="bfloat16")
    model.load_state_dict(state)
    # two batches of dead-leaves frames (the first EVAL_FRAMES are path 2's)
    pool = dead_leaves_pool(2 * BATCH, HEIGHT, SEED, width=WIDTH,
                            cache_dir="")
    frames = [pool[(r % 2) * BATCH:(r % 2 + 1) * BATCH]
              for r in range(N_REQUESTS)]
    # the North star's batch: 128 distinct frames (the pool's 16, flipped
    # and rolled)
    x128 = contract_frames(BIG_BATCH, HEIGHT, WIDTH, pool=pool)

    # path 1: the server builds its codec and tables, then serves
    _build.reset_launch_counts()
    codec = Codec(model, n_lanes=N_LANES, device="cuda")
    t0 = time.perf_counter()
    codec.update()
    print(json.dumps({"update_s": time.perf_counter() - t0,
                      "parametric": codec.parametric,
                      "analytic_enc_rows": codec.analytic_enc_rows}),
          flush=True)
    if not codec.parametric or not codec.analytic_enc_rows:
        raise AssertionError("Codec.update took a fallback on the main "
                             "path: the parametric table failed a check")
    in_update = _build.launch_counts()
    hashed = {"path_1_first_batch": serve(codec, frames, cfg=model.cfg)[0]}
    hashed[f"batch_{BIG_BATCH}"] = serve(codec, [x128], f"batch_{BIG_BATCH}",
                                         model.cfg)[0]
    counts = _build.launch_counts()
    per_batch = {k: (v - in_update[k]) / (N_REQUESTS + 1)
                 for k, v in counts.items()}
    print(json.dumps({"launches_on_main_path": counts,
                      "launches_in_update": in_update,
                      "launches_per_batch": per_batch}), flush=True)
    missing = [k for k, v in counts.items()
               if v <= 0 and k != "fused_block_tail"]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    big_request(codec, x128)
    contracts = [batch_contract_phase(codec, x128, MODEL)]
    wall_ms = stage_times(codec, frames)
    profile_request(codec, frames[0], wall_ms)
    noise = np.random.default_rng(SEED).integers(
        0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
    seeded_request(noise)
    eval_counts = eval_path(state, pool)
    fused_against_unfused(state, frames[0])
    kernels = check_kernels(codec, counts)
    kernels.append(check_fused_block(eval_counts["fused_block_tail"]))
    k8_all = k8_cases(codec, frames[0], MODEL, timed_at=(8, BIG_BATCH))
    k8_edge_cases()
    check_decode_lanes(codec)
    check_lane_widths(model, frames)
    check_small_reference(state)
    host_counts = host_coded_path(state, model, frames, codec)
    pipe_counts = pipeline_path(model, codec, frames)
    paths_counts, fb_kernels = codec_paths(model, codec, frames, kernels)
    trainer, train_counts = train_path(state)
    after = serve_after_training(trainer, frames[0])
    del trainer
    vbr_counts, vbr_profiles = vbr_serve_path(state, frames, codec)
    vbr_train_counts = vbr_train_path(state)
    rd_counts, rd_curve = rd_vbr_path()
    last_counts, lanes_rows = last_modules_path(state, codec, frames,
                                                wall_ms, rd_curve)
    l_counts = l_path(frames, pool, k8_all, contracts)
    l_train_counts = l_train_path(l_counts.pop("state"))
    sd_counts = sd_path(frames, l_counts["g_s_ms"], k8_all, contracts)
    sd_train_counts = sd_freeze_path()
    pub_counts = published_path(frames, k8_all, contracts)
    scale_counts = scale_out_path(state, model, codec, frames)
    kernels.append(k8_row(k8_all, counts))
    hashed["L_first_batch"] = l_counts["first_batch"]
    print(json.dumps({"stream_hashes": {
        k: {f: r[f] for f in ("bpp", "streams_sha256")}
        for k, r in hashed.items()}}), flush=True)
    print(json.dumps({"batch_contracts": [
        {k: c[k] for k in ("model", "batch", "y_bytes_differing",
                           "z_bytes_differing", "broken")}
        for c in contracts]}), flush=True)
    for k in kernels:
        k["launches_by_path"] = {"serve": counts[k["name"]],
                                 "eval": eval_counts[k["name"]],
                                 "train": train_counts[k["name"]],
                                 "serve_after_training": after[k["name"]],
                                 "vbr_serve": vbr_counts[k["name"]],
                                 "vbr_train": vbr_train_counts[k["name"]],
                                 "l_serve": l_counts["serve"][k["name"]],
                                 "l_eval": l_counts["eval"][k["name"]],
                                 "small_decoder": sd_counts[k["name"]],
                                 "host_coded": host_counts[k["name"]],
                                 "serve_pipeline": pipe_counts[k["name"]],
                                 "codec_paths": paths_counts[k["name"]],
                                 "rd_vbr": rd_counts[k["name"]],
                                 "train_L": l_train_counts[k["name"]],
                                 "train_small_decoder_frozen":
                                     sd_train_counts[k["name"]],
                                 "scale_out": scale_counts[k["name"]],
                                 **{p: c[k["name"]]
                                    for p, c in pub_counts.items()},
                                 "last_modules": last_counts[k["name"]]}
        at_l = [r for r in l_counts["kernels"] if r["name"] == k["name"]]
        if at_l:
            k["at_MLICPP_L"] = {key: at_l[0][key] for key in AT_L_KEYS
                                if key in at_l[0]}
        k["vbr_request_profiler_ms"] = {
            f"level_{s}": sum(p[ph]["port_kernels_ms_launches"][k["name"]][0]
                              for ph in ("compress", "decompress"))
            for s, p in vbr_profiles.items()}
    for k in fb_kernels:
        k["launches_by_path"] = {"codec_paths": k["launches"]}
    for k in lanes_rows:
        k["launches_by_path"] = {"last_modules": k["launches"]}
    kernels += fb_kernels + lanes_rows
    pool_cache.cleanup()
    os.environ.pop("MLIC_POOL_CACHE")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
