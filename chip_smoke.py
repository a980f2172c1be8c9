#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (gomatching_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device check and kernel build (nvcc, from the sources in this checkout); ptxas's
     registers, stack and spills of the lane-layout kernels B1-B5 (and B1, B2 and B5 on bf16
     value) and of B5's table build (f32 and bf16), and from the runtime
     their registers, local memory (which must be 0; B3 at most 64 registers) and resident
     warps per SM; the same for the footprint kernel's three instantiations (B6a-c), on
     f32 and on bf16 value, at the dynamic shared memory of a block under the shipped
     budget (local memory 0), and for the
     -DFP_WARPS=8 measurement build (blocks of 8 warps) under a budget of 0; ptxas's
     report and the runtime's registers, local memory (which must be 0) and static shared
     memory of the probe kernels (T1's passes, T2's three instantiations) and of T1's
     earlier form in the -DT1_L2_GATHER measurement build;
  2. each hand-written kernel against its plain PyTorch version at the full-width
     ICDAR15 shapes (1000x1778 input: levels (125,223) (63,112) (32,56) (16,28),
     S=37171 tokens, M=8 heads, D=32, L=4, P=4, 100x25 decoder queries), with
     locations and offsets outside the maps; max |kernel - plain| against
     ATOL_KERNEL, the same bits on a second call, and the kernel's / plain version's
     time beside the roofline bound and its rate in corner rows per second; then B1 at
     the EDGE_CASES shapes (L*P not a multiple of 8 or 64, one level, a 1-wide and a
     1-tall level, B*M > 1 with B > 1), locations partly off the maps, the same way;
  3. one frame through the full-depth spotter with the kernels and with the plain
     versions (same seeded weights, TF32 off): encoder memory, then the decoder from
     the same proposals, compared at ATOL_PATH;
  4. the main path: ``VideoPredictor`` on configs/GoMatching_ICDAR15.yaml at full
     width with seeded random weights and a lowered detection threshold, over
     N_FRAMES synthetic 720x1280 frames; XML/JSON written and parsed back; each
     kernel must have launched 6 x (spot batches) times in that run;
  5. the same frames once more under torch.profiler: device time by kernel, B1's and
     B2's shares;
  6. each backward kernel (B3: B1's VJP, B4: B2's VJP) against its plain version
     (autograd through grid_sample) at the pretraining shapes (1280x1280 square input:
     levels (160,160) (80,80) (40,40) (20,20), S=34000, B=1, 100x25 decoder queries),
     with locations and offsets outside the maps; max |kernel - plain| / max |plain| of
     each gradient against RTOL_BWD, and times (CUDA events and the profiler's device
     time) beside the bound; B3's dLoc and dAttn and B4's dOffsets and dLogits the same
     bits on a second call; then B3 (EDGE_LQ queries) and B4 at the EDGE_CASES shapes,
     locations and offsets partly off the maps and off grid lines, the same way; B3's
     wrapper refuses D = 16 on the card (ValueError, no launch);
  7. one full-width pretraining step (forward, costs, host Hungarian, losses,
     backward) with the kernels, with the plain versions, and with the plain versions
     in float64 at the same matches: same seeded weights, image and targets, TF32 off;
     identical matches and top-k proposals, losses within RTOL_LOSS; every backward
     kernel call of the step, on its own inputs, as close to the f64 VJP as the plain
     f32 one (F64_RATIO); every parameter gradient within RTOL_GRAD (L2) and
     RTOL_GRAD_MAX (largest entry) of the plain step's, beside the count of samples
     that fall in another grid cell in one step than in the other;
  8. the pretraining path: ``gomatching_tpu_torch.train_net.main`` (--task spotter) at
     TRAIN_SIZE 1280 over a synthetic dataset of 720x1280 images with text boxes; finite
     losses, moved parameters, a checkpoint that loads back strictly, each of B1-B4
     launched 6 x steps times; ms/step, images/s and peak memory over the steps after
     warm-up; host wall per stage; one step under torch.profiler, with B3's and B4's
     device time in it;
  9. B5 (the corner-merged sampler of TPU.SAMPLING_IMPL 'pallas') against its plain
     version and against the B1 kernel at the full-width encoder (Lq = S) and decoder
     (Lq = 2500) shapes, locations partly outside the maps, at ATOL_KERNEL, the same
     bits on a second call, and B5's table-build kernel against its plain version
     (exactly); kernel, plain, library and bound times, and the table's bytes;
 10. one frame through the full-depth spotter of configs/GoMatching_PP_ICDAR15.yaml
     under 'pallas' (B5 and its table build launched, nothing else), against the plain
     merged version and against the 'vmem' route (B1/B2) on the same weights, at
     ATOL_PATH;
 11. the GoMatching++ path: ``VideoPredictor`` on that config with 'pallas' over the
     same frames as phase 4; XML/JSON parsed back; B5 and its table build launched
     12 x (spot batches) times each and B1-B4 never; frames/s; the same clip under 'vmem' and 'pallas' in turns
     (frames/s of each); one profile with B5's and the table build's shares;
 12. the footprint entries B6a-c (``ms_deform_attn_encoder_vmem``, ``_vmem_tm``, ``_vmem_v3``,
     ``ms_deform_attn_encoder_fused``; one kernel) at the full-width encoder shapes with
     TILED_HALO 5 and the default tiles, offsets beyond the halo for >= 5% of samples and
     beyond the maps for some: each against its plain version and against the B1 kernel
     on the same locations at ATOL_KERNEL, the same bits on a second call; its launch
     counted; the copy route and buffers printed; a (source, target) pair over the
     shared-memory budget on the direct route, reading nothing from shared memory; a
     raise under autograd; the shipped build and budget (one block of 16 warps an SM,
     large buffers), four blocks of 8 warps an SM (the -DFP_WARPS=8 measurement build)
     and one block of 16 warps, both under a budget of 0 (every pair direct), each within
     ATOL_KERNEL of plain, timed in turns with their resident warps per SM and share of
     corner taps read from shared memory; kernel, plain and bound times beside B1's and
     B2's on the same function;
 13. the sampler benchmark ``gomatching_tpu_torch.tools.bench_deform_attn.main`` at B=3
     over every sampler (B1, B2, B5, B6a natural and tile-major, B6b, B6c) and two
     tilesets, with f32 value (each within ATOL_KERNEL of the exact gather) and with bf16
     value and attention, JAX's dtypes (each output within one bf16 rounding of it); each
     of the four B6 entries launched in each; every sampler's time per encoder call on the
     same samples (B6a-c beside B1 and B2);
 14. the probe kernels (``csrc/probes.cu``): an empty kernel's device time (the launch
     floor); T1 ``gather_rows_sum`` in the four cases of the gather rate probe, its slice
     plan and its scratch sizes (the C entry's against ``gather_probe.scratch_sizes``), on
     an integer-valued table (kernel, plain version and the float64 sum exactly equal)
     and on a randn table (within RTOL_GATHER of the sum of |terms|, the same bits
     twice); its device time by pass, beside the byte bound and the shared-memory bound
     (gathered bytes at SMEM_BYTES_PER_CLOCK an SM at the card's SM clock); the earlier
     form (the -DT1_L2_GATHER build) against the shipped one in turns, and both on
     all-zero indices (every gathered row the same); its pass B against the
     -DT1_NO_SLICE_COPY build's (no slice copies; timing only) in turns; T2 ``onehot_g`` in its three
     variants on coordinates in (-2, F + 1), at the probe's Q and at G_LARGE_Q (f32
     within ATOL_G, the bf16-output variants bit for bit or within one bf16 ulp; the
     count of elements that differ from plain printed); kernel (CUDA events and the
     profiler's device time), plain, library and bound times; then the path of this
     slice, both probe tools' ``main`` (``gomatching_tpu_torch.tools.bench_gather``,
     ``.probe_bf16_g``), each kernel launched;
 15. B1 (decoder and encoder shapes), B2 and B5 from a measurement build of
     ``csrc/ms_deform_attn.cu`` (-DMSDA_GATHER_ROW0: every gathered row is row 0 of its
     base, an L1 hit) against the real build on the same inputs, in turns: how much of
     each kernel's time the memory system adds; and B4 and B3 from a build without their
     dValue atomics (-DMSDA_NO_SCATTER) against the real build at the pretraining shape,
     in turns: what the scatter costs beside the gather;
 16. the tracker-training path: ``gomatching_tpu_torch.train_net.main`` (--task tracker) on
     configs/GoMatching_ICDAR15.yaml at full width, seeded random weights and both
     proposal thresholds at TRACK_THRESH, over a synthetic dataset of two 12-frame
     720x1280 videos with 8 drifting text instances each and a still image (a
     GEN_IMAGE_MOTION clip): N_TRACK_STEPS iterations with finite losses, proposals and
     matched tracks in each; B1 launched (ENC_LAYERS + DEC_LAYERS) times a clip (the
     padded clips' masked encoder and the decoder) and no other sampler; the rescore
     checkpoint loads back strictly and only roi_heads moved; ms/iter, its data stage,
     frames per clip, host wall by stage (spot / host / update) and peak memory; 2
     iterations of configs/GoMatching_PP_ICDAR15.yaml; one with TPU.TRAIN_UPLOAD_UINT8
     False (no masks: B2 in the encoder, B1 in the decoder); one step on one clip with the
     kernels and with the plain samplers (thresholds in a gap of the fused scores): the
     same proposals, matches and targets, losses and the updated roi_heads within
     RTOL_LOSS; one profiled step (device time, busy share, B1's share); the peak memory
     of a 12-frame 1280x1280 spot;
 17. B1 and B2 on bf16 value (the production precision path) against their plain bf16
     versions at the main path's shapes (value (3, 37171, 8, 32) bf16; B1 at the decoder's
     2500 and the masked encoder's 37171 queries): every element within one bf16 ulp of
     plain (ATOL_KERNEL where the value is so near 0 that its ulp is below the f32 sums'
     reordering noise), the same bits twice; kernel times beside the f32 kernels' on the
     same values in turns, device times, plain times, byte bounds (value and output bytes
     halved), and registers and local memory;
 18. the production inference path: ``VideoPredictor`` on both shipped configs with
     MODEL.PRECISION bfloat16, TPU.UPLOAD_FORMAT yuv420 and the default sampler, at full
     width over phase 4's frames: frames/s (median of N_REPEATS), B2 and B1 on bf16 value
     launched ENC_LAYERS and DEC_LAYERS times a spot batch and nothing else, XML/JSON, device
     time per clip, busy share, peak memory, device time by class (convolutions, GEMMs,
     elementwise, B1, B2, ...); on ICDAR15 one spot batch with the kernels and with the
     plain bf16 samplers (the encoder memory, then the decoder from the same proposals,
     each output within PATH_ULPS bf16 ulps of its largest magnitude), the clip's ids with
     the plain samplers and its agreement with phase 4's f32 / RGB run (reported);
 19. tracker training in the production configuration: ``train_net.main`` (--task tracker)
     with MODEL.PRECISION bfloat16 and TPU.TRAIN_UPLOAD_FORMAT yuv420 on phase 16's dataset,
     N_PROD_TRACK_STEPS iterations with finite losses, B1 on bf16 value launched
     (ENC_LAYERS + DEC_LAYERS) times a clip and nothing else, only roi_heads moved, an f32
     checkpoint that loads back strictly; ms/iter, data and spot stages, peak memory; one
     profiled step on phase 16's profiled clip against that step's device time;
 20. the last kernels on bf16 value: B5's table build and B5 (``ms_deform_attn_merged`` on
     bf16 value) at the ICDAR15 shapes (S = 37171, encoder Lq = S and 2500 decoder queries)
     and at the DSText shapes (1280x2276: levels DS_SHAPES, S = 60640, 7500 decoder
     queries), B = 3, locations partly off the maps: the table the plain table's bits
     exactly, B5 every element within one bf16 ulp of its plain bf16 version (or within
     ATOL_KERNEL near 0), each the same bits twice; then the four B6 entries on bf16 value
     at phase 12's inputs (offsets beyond the halo for >= 5% of samples), each held the same
     way; for each, times beside the f32 kernel on the same values in turns, device time,
     plain time, the byte bound with bf16 value and output, registers and local memory
     (which must be 0), index_select for the table, and the B6 entries' staged share in bf16
     beside f32's;
 21. GoMatching++ production on 'pallas': ``VideoPredictor`` on
     configs/GoMatching_PP_ICDAR15.yaml and configs/GoMatching_PP_DSText.yaml with
     MODEL.PRECISION bfloat16, TPU.UPLOAD_FORMAT yuv420 and TPU.SAMPLING_IMPL pallas at full
     width over phase 4's frames: B5 bf16 and its table build each launched ENC_LAYERS +
     DEC_LAYERS times a spot batch and no other sampler, XML/JSON parsed back, frames/s
     (median of N_REPEATS), device time per clip, busy share, peak memory; one spot batch
     with the kernels and with the plain bf16 merged sampler from the same proposals
     (within PATH_ULPS), the samplers' shapes checked against phase 20's; then
     N_PP_TRACK_STEPS tracker iterations of GoMatching++ under 'pallas' with
     MODEL.PRECISION bfloat16 and TPU.TRAIN_UPLOAD_FORMAT yuv420 on phase 16's dataset:
     finite losses, B5 bf16 and its table launched ENC_LAYERS + DEC_LAYERS times a clip and
     nothing else, an f32 checkpoint in which only roi_heads moved.
 22. the other corpora: ``gomatching_tpu_torch.eval.main`` (the CLI's entry point) on
     configs/GoMatching_DSText.yaml, GoMatching_BOVText.yaml (its 5462-way text head
     decoded through a CUSTOM_DICT table of 5461 codepoints that the phase writes) and
     GoMatching_ArTVideo.yaml at full width in the production configuration (bf16 + I420,
     the default sampler), each over a JPEG tree of phase 4's frames in the corpus's layout
     (DSText and BOVText <root>/<Cls>/<video>, ArTVideo flat; a warm-up video, then one
     timed video, N_REPEATS on DSText), decoded on eval's prefetch thread: B2 and B1 on bf16
     value launched ENC_LAYERS and DEC_LAYERS times a spot batch and no other sampler,
     XML/JSON parsed back, frames/s through eval (and the time its consumer waited for
     decoded frames) and over the frames in memory (median of N_REPEATS), device time per
     clip with B1's and B2's shares, busy share, peak memory; on DSText (1280x2276, 300 x 25 decoder queries) one spot batch with
     the kernels against the plain bf16 samplers within PATH_ULPS, the samplers' shapes
     checked; each corpus's results scored by ``gomatching_tpu_torch.tools.eval_tracking``
     against a GT written from them in each of its protocol modes (MOTA = IDF1 = 1, hmean
     1), then with one track's id changed from its middle frame on (1 ID switch);
     ``--show`` on one BOVText video (every frame drawn into vis/).
 23. the Swin and ViTAEv2 trunks: ``VideoPredictor`` on configs/GoMatching_ICDAR15.yaml with
     MODEL.BACKBONE.NAME build_swin_backbone (SWIN.TYPE tiny, in f32 and in the production
     configuration; small for one f32 clip) and build_vitaev2_backbone (f32 and production)
     at full width over phase 4's frames: B2 and B1 (f32 or on bf16 value) launched
     ENC_LAYERS and DEC_LAYERS times a spot batch and nothing else, XML/JSON parsed back,
     frames/s, device time per clip, peak memory; the spot with the kernels against the
     plain samplers, at ATOL_PATH in f32; in bf16 each sampler call of the spot within one
     bf16 ulp of the plain bf16 sampler on its own inputs and each output within
     max(PATH_ULPS, twice the drift the plain samplers show when each call's output moves
     one ulp); then one ViTAEv2-S spot batch at DSText's 1280x2276 (stage 3's global
     attention over 11440 tokens) in each precision, with its peak memory;
 24. video spotter pretraining (MODEL.META_ARCHITECTURE TransformerPureVideoDetector):
     ``train_net.main`` (--task spotter) at INPUT.TRAIN_SIZE 1280 on phase 16's videos,
     N_VIDEO_STEPS steps with ResNet-50 and with Swin-T (SWIN.DROP_PATH_RATE 0.2): clips on
     padded canvases with their frames' true sizes (the masked encoder), finite losses, B1
     and B3 launched ENC_LAYERS + DEC_LAYERS times a step and nothing else, checkpoints that
     load back strictly, ms/step and peak memory; one step with the kernels against the plain
     samplers (identical matches and top-k, losses within RTOL_LOSS, every parameter's
     gradient within RTOL_GRAD / RTOL_GRAD_MAX, gradient norms by module); B3 at the masked
     encoder's shape (Lq = S): each call of the step against the plain backward (dValue and
     dAttn within RTOL_BWD, dLoc within it away from grid lines) and as close to the f64 VJP
     as plain f32 (F64_RATIO), its time, device time and bound;
 25. tracker training under the other freeze policies: ``train_net.main`` (--task tracker)
     for 2 iterations on phase 16's dataset under FREEZE_TYPE '' and under Backbone with
     MODEL.PRECISION bfloat16 (FREEZE_OPTS: weight decay 1 and no warm-up, so that one
     step's decay shows in f32): B1 launched ENC_LAYERS + DEC_LAYERS times a clip and nothing
     else; in the checkpoint after the first iteration every trainable spotter tensor within
     DECAY_ULPS of p * (1 - lr * wd) (zero gradient behind the detached spot, AdamW's
     decoupled decay), every frozen one unchanged and f32, roi_heads moved; a tensorboard
     event file in OUTPUT_DIR/tb.
 26. data parallel on this card: DP_RANKS processes (``parallel.launch``, a gloo group,
     every rank on cuda:0, which NCCL refuses), for ICDAR15 GoMatching tracker training at
     full width on phase 16's dataset in f32 and in bf16 with the I420 training wire: one
     averaged step (``Trainer.step_multi``, one clip a rank, padded to the common canvas
     and frame count) against the one-process ``step_multi`` of the same two clips
     (losses within DP_LOSS_RTOL, the updated roi_heads within RTOL_LOSS, thresholds in a
     gap of the fused scores), the ranks' heads the same bits; then N_DP_STEPS iterations
     through ``train_net.main --num-gpus 2`` on each rank: finite averaged losses, B1 (f32
     or bf16) launched ENC_LAYERS + DEC_LAYERS times a step on each rank and nothing else,
     the ranks' heads the same bits after the last step, one checkpoint holding rank 0's
     head and one metrics.json line; ms/iter, data stage, the all-reduce's host wall and
     peak memory per rank; then phase 4's frames through ``VideoPredictor`` with a group
     (TPU.SPOT_BATCH DP_SPOT_BATCH split over the ranks, the rows gathered on the host)
     against the single-process predictor: B2 and B1 launched on each rank for its share,
     scores within DP_SCORE_ATOL, track ids and XML identical unless a score lies within
     DP_SCORE_ATOL of the threshold; a rank that fails or outlives DP_TIMEOUT_S fails it.
 27. every checkpoint form ``MODEL.WEIGHTS`` reads, and the training throughput tool: phase
     4's seeded state_dict written as a detectron2 ``.pkl`` (a protocol 2 pickle of numpy
     arrays with the model zoo's extra keys), as a ``.pth`` whose optimizer state and
     iteration are numpy, and as the port converter's ``.npz``; each loaded through
     ``model_weights`` to phase 4's tensors bit for bit; phase 4's frames through
     ``VideoPredictor`` from the ``.pkl``: every tracked field the same bits as phase 4's
     run, with its B1 / B2 launches; then ``tools/bench_train.main`` at its defaults (the
     tracker step on a 4-frame 736x736 clip), with every proposal passing, and with
     ``--pretrain --iters 3``: ms/iter with the upload / spot / host / update split, the
     projected hours for 30 000 iterations, peak memory, finite losses, B1 12 launches a
     tracker step and B1-B4 6 each a pretraining step, nothing else.
The line before the last is {"kernels": [...]} (B1-B5, B5's table build, the four B6
entries, T1, T2, B1 and B2 on bf16 value, and B5, its table build and the four B6 entries
on bf16 value); the last is {"ok": true, "device": {...}}.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ATOL_KERNEL = 1e-4  # f32: the kernel and grid_sample sum the same taps in another order
ATOL_PATH = 2e-3  # 6 encoder / 6 decoder layers amplify those differences
# f32 atomics reorder the dValue sums, and x is rounded another way than grid_sample's
RTOL_BWD = 1e-4
RTOL_LOSS = 1e-4
# Each backward kernel call of a step, on its own inputs: max |g_kernel - g_f64| <=
# max(F64_RATIO * max |g_plain_f32 - g_f64|, RTOL_BWD * max |g_f64|), per gradient
# (the kernel is as close to the f64 VJP as the plain f32 one, up to atomics' order).
F64_RATIO = 2.0
# The step as a whole, kernels vs plain, per parameter: |dg|_2 <= RTOL_GRAD * |g|_2 and
# max |dg| <= RTOL_GRAD_MAX * max |g|. The two steps' forwards differ in the last bits,
# so a few samples fall in another grid cell in one than in the other; each then takes
# the bilinear derivative of the other side, which moves single entries of the
# gradients upstream (phase 7 counts those samples). Read on an NVIDIA H100 80GB HBM3,
# 700 W: 1.7e-2 at point_embed, while each kernel call is as exact as the plain one.
RTOL_GRAD = 1e-2
RTOL_GRAD_MAX = 5e-2
TRAIN_SHAPES = [(160, 160), (80, 80), (40, 40), (20, 20)]  # 1280x1280 at strides 8..64
TRAIN_SIZE = 1280
N_TRAIN_STEPS, N_TRAIN_WARMUP = 8, 3
N_TRACK_STEPS, N_TRACK_WARMUP = 8, 3  # phase 16's tracker-training iterations
TRACK_VIDEO_FRAMES = 12  # frames per synthetic training video: room for 2 * TRAIN_LEN
# Phase 16's proposal thresholds (INFERENCE_TH_TRAIN and ASSO_THRESH, 0.3 in the config):
# seeded random heads score ~0.01 (the classifier's prior bias), so at 0.3 no proposal
# would pass and the association losses would be empty; at 0.001 every proposal passes
TRACK_THRESH = 0.001
# Phase 16's kernel-vs-plain step: the weights' and the clip's seed. With SEED 1 (the CLI
# run's) two of the encoder's proposal scores near the top-100 cut are within the
# samplers' last-bit differences, so the two steps decode other queries; with SEED 5 the
# top-101 scores of every frame are >= 1.2e-6 apart and both steps pick the same
# (NVIDIA H100 80GB HBM3, 700 W; seeds 2-5 all agree)
TRACK_AB_SEED = 5
ADAMW_EPS = 1e-8  # engine/optim.py's AdamW
SHAPES = [(125, 223), (63, 112), (32, 56), (16, 28)]
B, M, D, L, P = 3, 8, 32, 4, 4  # B = TPU.SPOT_BATCH, the main path's batch
NQ, NPTS = 100, 25
N_FRAMES = 8
N_REPEATS = 5  # timed runs of the clip; the first is the checked, counted one
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
TILED_HALO = 5  # TPU.TILED_HALO of the configs: the footprints' margin in target cells
TILESETS = "8x16,8x16,8x16,8x16;16x16,16x16,16x16,16x16"  # phase 13's tile sweep
# T1 on a randn table, kernel vs plain: |k - p| <= RTOL_GATHER * sum |terms|. Each f32
# addition rounds by at most 2**-24 of its result, so a sum in which no term passes
# through more than h additions is within h * 2**-24 * sum |terms| of the exact one. The
# kernel's deepest chain at the probe's shapes is at most 152 additions (128 a lane's
# accumulator before a flush, 2 + 5 to the warp's sum, <= 3 flushes, 5 block levels, 9
# in the final pass; csrc/probes.cu), its earlier form's 276; torch's reduction is taken
# to be no deeper than 276, so the two differ by at most 2 * 276 * 2**-24.
RTOL_GATHER = 2 * 276 * 2.0 ** -24
ATOL_G = 1e-6  # T2 in f32: the kernel does _g_kernel's ops in its order, without FMAs
ROW0_FLAGS = ("-DMSDA_GATHER_ROW0",)  # phase 15's measurement builds
NO_SCATTER_FLAGS = ("-DMSDA_NO_SCATTER",)
FP_WARPS8_FLAGS = ("-DFP_WARPS=8",)  # phases 1 and 12: footprint blocks of 8 warps
T1_L2_FLAGS = ("-DT1_L2_GATHER",)  # phases 1 and 14: T1's earlier form, from L1/L2
T1_NO_COPY_FLAGS = ("-DT1_NO_SLICE_COPY",)  # phase 14: T1's pass B without its slice copies
SMEM_BYTES_PER_CLOCK = 128  # an SM's shared memory (H100)
G_LARGE_Q = 256 * 132  # phase 14: T2 at a Q where the output bytes (138 MB f32) dominate
# The small shapes phases 2 and 6 also run B1 and B4 at (tests/test_torch_deform_attn_edges.py
# holds the plain versions against JAX at the same): (name, B, M, level shapes, P)
EDGE_LEVELS = [(6, 9), (3, 5), (2, 3), (1, 2)]
EDGE_CASES = [
    ("L*P=12", 1, 8, EDGE_LEVELS, 3),
    ("L*P=64", 1, 8, EDGE_LEVELS, 16),
    ("L=1", 1, 8, [(7, 5)], 4),
    ("1-wide and 1-tall levels", 1, 8, [(5, 1), (1, 6), (3, 3)], 4),
    ("B=2 M=3", 2, 3, EDGE_LEVELS, 4),
]
EDGE_LQ = 13  # B1's queries at the edge shapes: not a multiple of the 8 warps of a block
CONFIG = "configs/GoMatching_ICDAR15.yaml"
CONFIG_PP = "configs/GoMatching_PP_ICDAR15.yaml"  # GoMatching++ (shared matcher)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch

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


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def value_reads(torch, loc, S, D, shapes=SHAPES, elem_bytes=4):
    """What this run's locations need of value (B, S, M, D): the distinct
    (batch, token, head) rows that an in-range bilinear corner touches, read once
    (D * ``elem_bytes`` bytes each), and the number of corner taps (taps outside the map
    read nothing). loc (B, Lq, M, L, P, 2) normalized; the kernel's x = loc * W - 0.5."""
    B, _, M = loc.shape[:3]
    touched = torch.zeros(B * S * M, dtype=torch.bool, device=loc.device)
    b = torch.arange(B, device=loc.device).view(B, 1, 1, 1)
    m = torch.arange(M, device=loc.device).view(1, 1, M, 1)
    taps, start = 0, 0
    for lvl, (h, w) in enumerate(shapes):
        x0 = torch.floor(loc[:, :, :, lvl, :, 0] * w - 0.5).long()  # (B, Lq, M, P)
        y0 = torch.floor(loc[:, :, :, lvl, :, 1] * h - 0.5).long()
        for dy in (0, 1):
            for dx in (0, 1):
                x, y = x0 + dx, y0 + dy
                ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                row = ((b * S + start + y * w + x) * M + m)[ok]
                touched[row] = True
                taps += row.numel()
        start += h * w
    return int(touched.sum().item()) * D * elem_bytes, taps


def ptxas_report(path, kernels):
    """{name: ptxas's 'Used ...' and spill lines} for each kernel of ``kernels`` (name ->
    a substring of its mangled name) in the build log at ``path``."""
    report = {name: [] for name in kernels}
    cur = None
    for line in path.read_text().splitlines():
        if "Compiling entry function" in line:
            cur = next((n for n, k in kernels.items() if k in line), None)
        elif cur and ("Used" in line or "spill" in line):
            report[cur].append(" ".join(line.replace("ptxas info    :", "").split()))
    return report


def phase_resources(da, dav, _build):
    """What ptxas and the runtime made of the lane-layout kernels (B1, B2, B4, B5, B3, and B1
    and B2 on bf16 value) and of the footprint kernel's three instantiations (B6a-c):
    registers, stack and spills
    from nvcc's report kept beside the library, and registers, local memory and resident
    warps per SM from the CUDA runtime (the footprint kernel's at the dynamic shared memory
    phase 12's footprints take under the shipped budget, and those of the -DFP_WARPS=8
    measurement build under a budget of 0). No lane-layout kernel may keep anything in
    local memory, and B3 at most 64 registers."""
    names = {da.QUERIES: "ms_deform_attn_queries_kernel", da.ENCODER: "ms_deform_attn_encoder_kernel",
             da.ENCODER_BWD: "ms_deform_attn_encoder_bwd_kernel",
             da.MERGED: "ms_deform_attn_merged_kernel",
             da.QUERIES_BWD: "ms_deform_attn_queries_bwd_kernel",
             da.QUERIES_BF16: "ms_deform_attn_queries_bf16_kernel",
             da.ENCODER_BF16: "ms_deform_attn_encoder_bf16_kernel",
             da.MERGED_BF16: "ms_deform_attn_merged_bf16_kernel",
             da.MERGED_TABLE: "ms_deform_attn_merged_table_kernel",
             da.MERGED_TABLE_BF16: "ms_deform_attn_merged_table_bf16_kernel"}
    # the footprint kernel's instantiations by their mangled template arguments
    # (<GEOM, float> is "ILi<GEOM>EfE", <GEOM, __nv_bfloat16> "ILi<GEOM>E13__nv_bfloat16E")
    geoms = ("NATURAL_LOC", "TM_LOC", "TM_OFF_CELLS")
    fp_names = {f"ms_deform_attn_footprint_kernel<{g}, float>":
                f"ms_deform_attn_footprint_kernelILi{i}EfE" for i, g in enumerate(geoms)}
    fp16_names = {f"ms_deform_attn_footprint_kernel<{g}, __nv_bfloat16>":
                  f"ms_deform_attn_footprint_kernelILi{i}E13__nv_bfloat16E"
                  for i, g in enumerate(geoms)}
    report = ptxas_report(_build.build_log("ms_deform_attn.cu"),
                          {**names, **fp_names, **fp16_names})
    info = da.kernel_info()
    for name in names:
        check(report[name], f"{name}: no ptxas report for {names[name]}")
        print(f"[1] {name} ({names[name]}): ptxas: {'; '.join(report[name])}; runtime: "
              f"{info[name]['registers']} registers, {info[name]['local_bytes']} bytes of local "
              f"memory a thread, {info[name]['warps_per_sm']} resident warps per SM")
        check(info[name]["local_bytes"] == 0, f"{name}: {info[name]['local_bytes']} bytes of "
              "local memory a thread (stack or spills)")
    check(info[da.QUERIES_BWD]["registers"] <= 64,
          f"{da.QUERIES_BWD}: {info[da.QUERIES_BWD]['registers']} registers a thread (limit 64)")
    for kernels, elem_bytes in ((fp_names, 4), (fp16_names, 2)):
        fp = dav.vmem_footprints(da.VMEM, SHAPES, P, TILED_HALO, elem_bytes=elem_bytes)
        for (kernel, name), i in zip(kernels.items(), dav.footprint_kernel_info(fp).values()):
            check(report[kernel], f"{kernel}: no ptxas report")
            print(f"[1] {kernel} (for {name.split(' (')[0]}): ptxas: {'; '.join(report[kernel])}; "
                  f"runtime, shipped budget (SMEM_BLOCK_BYTES {dav.SMEM_BLOCK_BYTES}): "
                  f"{fp.smem_bytes} bytes of dynamic shared memory a block ({dav.NBUF} buffers of "
                  f"{fp.fp_bytes}), {i['registers']} registers, {i['local_bytes']} bytes of local "
                  f"memory a thread, {i['warps_per_sm']} resident warps per SM")
            check(i["warps_per_sm"] > 0, f"{kernel}: does not fit an SM")
            check(i["local_bytes"] == 0, f"{kernel}: {i['local_bytes']} bytes of local memory")
    # the -DFP_WARPS=8 measurement build under a budget of 0 (nothing staged), as phase 12
    lib8 = measurement_lib(_build, da, FP_WARPS8_FLAGS)
    log8 = _build.build_log("ms_deform_attn.cu", _build.NVCC_FLAGS + FP_WARPS8_FLAGS)
    report8 = ptxas_report(log8, fp_names)
    with patched(dav, SMEM_BLOCK_BYTES=0):
        dav.footprints.cache_clear()
        fp = dav.vmem_footprints(da.VMEM, SHAPES, P, TILED_HALO)
    dav.footprints.cache_clear()
    for which, kernel in enumerate(fp_names, start=5):
        check(report8[kernel], f"{kernel} (-DFP_WARPS=8): no ptxas report")
        i = lib_kernel_info(lib8, which, fp.smem_bytes)
        print(f"[1] {kernel} of the -DFP_WARPS=8 build: ptxas: {'; '.join(report8[kernel])}; "
              f"runtime, budget 0: {fp.smem_bytes} bytes of dynamic shared memory a block, "
              f"{i['registers']} registers, {i['local_bytes']} bytes of local memory a thread, "
              f"{i['warps_per_sm']} resident warps per SM")
        check(i["warps_per_sm"] > 0, f"{kernel} (-DFP_WARPS=8): does not fit an SM")


def measurement_lib(_build, da, flags):
    """``csrc/ms_deform_attn.cu`` built with ``flags`` added (a measurement build, which the
    wrappers never load), its C functions typed as the wrappers type them."""
    import ctypes

    lib = ctypes.CDLL(str(_build.build("ms_deform_attn.cu", flags=_build.NVCC_FLAGS + flags)))
    for fn, argtypes in da._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def lib_kernel_info(lib, which, smem_bytes):
    """``ms_deform_attn_kernel_info`` of kernel ``which`` of ``lib``, as
    ``deform_attn._kernel_info`` gives it for the wrappers' library."""
    import ctypes

    info = (ctypes.c_int * 3)()
    rc = lib.ms_deform_attn_kernel_info(which, smem_bytes, info)
    check(rc == 0, f"ms_deform_attn_kernel_info({which}): cudaError {rc}")
    return {"registers": info[0], "local_bytes": info[1], "warps_per_sm": info[2]}


def same_bits(torch, name, fn, got):
    """A second call of a kernel gives the same bits."""
    again = fn()
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{name}: a second call gives other bits")


def phase_kernels(torch, da):
    """Kernel vs plain at full width; returns the kernels-line records (sans launches)."""
    S = sum(h * w for h, w in SHAPES)
    g = torch.Generator().manual_seed(0)
    dev = "cuda"
    value = torch.randn(B, S, M, D, generator=g).to(dev)
    records = {}

    # B1: arbitrary locations, some outside [0, 1]
    Lq = NQ * NPTS
    loc = (torch.rand(B, Lq, M, L, P, 2, generator=g) * 1.2 - 0.1).to(dev)
    attn = torch.randn(B, Lq, M, L * P, generator=g).softmax(-1).view(B, Lq, M, L, P).to(dev)
    got = da.ms_deform_attn_queries(value, SHAPES, loc, attn)
    want = da.ms_deform_attn_queries_plain(value, SHAPES, loc, attn)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(math.isfinite(err) and err <= ATOL_KERNEL, f"{da.QUERIES}: max err {err}")
    same_bits(torch, da.QUERIES, lambda: da.ms_deform_attn_queries(value, SHAPES, loc, attn), got)
    ms = cuda_time_ms(lambda: da.ms_deform_attn_queries(value, SHAPES, loc, attn))
    dev_us = device_us(torch, lambda: da.ms_deform_attn_queries(value, SHAPES, loc, attn),
                       "ms_deform_attn_queries_kernel")
    plain_ms = cuda_time_ms(lambda: da.ms_deform_attn_queries_plain(value, SHAPES, loc, attn))
    v_bytes, taps = value_reads(torch, loc, S, D)
    samples = B * Lq * M * L * P
    b_ms, b_by = bound(v_bytes + nbytes(loc, attn, got),
                       samples * (20 + 2 * D) + taps * (2 * D + 1))
    records[da.QUERIES] = dict(
        name=da.QUERIES, route="cuda", source="gomatching_tpu_torch/csrc/ms_deform_attn.cu",
        replaces="gomatching_tpu/ops/deform_attn_dec_vmem.py:54", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, value_mb=v_bytes / 1e6,
        taps=taps, corners=4 * samples, device_us=dev_us,
    )

    # B2: raw offsets of a few cells, some far beyond the map, and logits
    off = torch.randn(B, S, M, L, P, 2, generator=g) * 4.0
    far = torch.rand(B, S, M, L, P, 2, generator=g) < 0.01
    off = torch.where(far, off * 100.0, off).to(dev)
    logits = torch.randn(B, S, M, L * P, generator=g).to(dev)
    got = da.ms_deform_attn_encoder(value, SHAPES, off, logits)
    want = da.ms_deform_attn_encoder_plain(value, SHAPES, off, logits)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(math.isfinite(err) and err <= ATOL_KERNEL, f"{da.ENCODER}: max err {err}")
    same_bits(torch, da.ENCODER, lambda: da.ms_deform_attn_encoder(value, SHAPES, off, logits), got)
    ms = cuda_time_ms(lambda: da.ms_deform_attn_encoder(value, SHAPES, off, logits))
    dev_us = device_us(torch, lambda: da.ms_deform_attn_encoder(value, SHAPES, off, logits),
                       "ms_deform_attn_encoder_kernel")
    plain_ms = cuda_time_ms(lambda: da.ms_deform_attn_encoder_plain(value, SHAPES, off, logits),
                            iters=5, warmup=1)
    wh = torch.tensor([[w, h] for h, w in SHAPES], dtype=torch.float32, device=dev)
    enc_loc = (da.encoder_reference_points(SHAPES, dev)[None, :, None, None, None, :]
               + off / wh[None, None, None, :, None, :])
    v_bytes, taps = value_reads(torch, enc_loc, S, D)
    del enc_loc
    samples = B * S * M * L * P
    b_ms, b_by = bound(v_bytes + nbytes(off, logits, got),
                       samples * (27 + 2 * D) + taps * (2 * D + 1))
    records[da.ENCODER] = dict(
        name=da.ENCODER, route="cuda", source="gomatching_tpu_torch/csrc/ms_deform_attn.cu",
        replaces="gomatching_tpu/ops/deform_attn_vmem.py:246", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, value_mb=v_bytes / 1e6,
        taps=taps, corners=4 * samples, device_us=dev_us,
    )
    for r in records.values():
        print(f"[2] {r['name']}: max|kernel-plain| {r['max_abs_err']:.3e} (atol {ATOL_KERNEL}), "
              f"same bits twice; kernel {r['ms']:.4f} ms a call (device {fmt_us(r['device_us'])}), "
              f"plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['value_mb']:.1f} MB of value rows "
              f"touched of {nbytes(value) / 1e6:.1f} MB) at B={B}; {r['corners'] / 1e6:.2f}M "
              f"corner rows ({r['taps'] / 1e6:.2f}M in the maps): "
              f"{r['corners'] / r['ms'] / 1e6:.1f} G corner rows/s")
    edge_queries(torch, da)
    return records


def edge_queries(torch, da):
    """B1 against its plain version at the EDGE_CASES shapes, locations partly off the
    maps: max |kernel - plain| against ATOL_KERNEL and the same bits on a second call."""
    g = torch.Generator().manual_seed(8)
    for name, b, m, shapes, p in EDGE_CASES:
        S, L = sum(h * w for h, w in shapes), len(shapes)
        value = torch.randn(b, S, m, D, generator=g).cuda()
        loc = (torch.rand(b, EDGE_LQ, m, L, p, 2, generator=g) * 1.3 - 0.15).cuda()
        attn = (torch.randn(b, EDGE_LQ, m, L * p, generator=g).softmax(-1)
                .view(b, EDGE_LQ, m, L, p).cuda())
        before = da.launch_counts[da.QUERIES]
        got = da.ms_deform_attn_queries(value, shapes, loc, attn)
        check(da.launch_counts[da.QUERIES] == before + 1, f"{da.QUERIES} {name}: no launch")
        want = da.ms_deform_attn_queries_plain(value, shapes, loc, attn)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(math.isfinite(err) and err <= ATOL_KERNEL, f"{da.QUERIES} {name}: max err {err}")
        same_bits(torch, f"{da.QUERIES} {name}",
                  lambda: da.ms_deform_attn_queries(value, shapes, loc, attn), got)
        outside = ((loc < 0) | (loc > 1)).any(-1).float().mean().item()
        print(f"[2] {da.QUERIES} at {name} (B={b}, M={m}, levels {shapes}, P={p}, Lq={EDGE_LQ}): "
              f"max|kernel-plain| {err:.3e} (atol {ATOL_KERNEL}), same bits twice; "
              f"{100 * outside:.0f}% of samples outside [0, 1]")


@contextlib.contextmanager
def patched(obj, **attrs):
    """Set attributes of ``obj`` for the duration of the block."""
    saved = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(obj, k, v)


@contextlib.contextmanager
def sampling(model, impl):
    """Run every deformable-attention layer of ``model`` with SAMPLING_IMPL ``impl``
    for the duration of the block."""
    from gomatching_tpu_torch.models.spotter import MSDeformAttn

    attns = [m for m in model.modules() if isinstance(m, MSDeformAttn)]
    saved = [m.sampling_impl for m in attns]
    for m in attns:
        m.sampling_impl = impl
    try:
        yield
    finally:
        for m, v in zip(attns, saved):
            m.sampling_impl = v


def spotter_errors(torch, tag, model, routes):
    """One seeded 1000x1778 frame through the full-depth spotter along each of
    ``routes`` ({name: context manager factory}; the first is the one checked): the
    encoder, then the decoder from the first route's proposals. Prints and checks max
    |first - other| of the encoder memory and of every output at ATOL_PATH."""
    spotter = model.detection_transformer
    g = torch.Generator().manual_seed(1)
    img = (torch.rand(1, 1000, 1778, 3, generator=g) * 4 - 2).cuda()

    def run(route, enc=None, refs=None):
        with routes[route](), torch.no_grad():
            if enc is None:
                feats, pos = model.features(img)
                return spotter.encode(feats, pos, None)
            return spotter.decode(enc, refs)

    first, *others = routes
    enc_k = run(first)
    with torch.no_grad():
        refs = spotter.select_proposals(*spotter.encoder_proposals(enc_k))
    out_k = run(first, enc_k, refs)
    for k, v in out_k.items():
        check(bool(torch.isfinite(v).all()), f"path: non-finite {k}")
    for other in others:
        errs = {"encoder memory": (enc_k["memory"] - run(other)["memory"]).abs().max().item()}
        out_o = run(other, enc_k, refs)
        for k, v in out_k.items():
            errs[k] = (v - out_o[k]).abs().max().item()
        for k, e in errs.items():
            print(f"{tag} spotter {k}: max|{first}-{other}| {e:.3e} (atol {ATOL_PATH})")
            check(math.isfinite(e) and e <= ATOL_PATH, f"path: {k} differs by {e} ({other})")


def phase_path(torch, predictor, da):
    """One frame through the spotter with the kernels and with the plain versions."""
    import gomatching_tpu_torch.models.spotter as spotter_mod

    spotter_errors(torch, "[3]", predictor.model, {
        "kernels": contextlib.nullcontext,
        "plain": lambda: patched(spotter_mod, ms_deform_attn_encoder=da.ms_deform_attn_encoder_plain,
                                 ms_deform_attn_queries=da.ms_deform_attn_queries_plain),
    })


def synthetic_frames():
    """N_FRAMES 720x1280 BGR frames: one random image panning 6 px per frame."""
    base = np.random.RandomState(0).randint(0, 255, (720, 1280, 3), dtype="uint8")
    return [np.roll(base, 6 * t, axis=1) for t in range(N_FRAMES)]


def device_rows(torch, prof):
    """(self device us, count, name) of each kernel and copy, largest first: not the host
    ops launching them, and not user annotations (such as ``Optimizer.step``), which
    repeat their kernels' time."""
    cuda = torch.autograd.DeviceType.CUDA
    return sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == cuda and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)), reverse=True)


def phase_profile(torch, predictor, tag="[5]", shares=()):
    """The main path once more under torch.profiler: device time by kernel and the
    device's busy share of the wall time (kernels run on one stream). ``shares``:
    (label, kernel name prefix) whose share of the device time is printed. Returns the
    profile's ``device_rows`` and the wall time (s)."""
    from torch.profiler import ProfilerActivity, profile

    frames = synthetic_frames()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        predictor.process_video([f.copy() for f in frames])
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = device_rows(torch, prof)
    total_ms = sum(r[0] for r in rows) / 1e3
    if not rows:
        print(f"{tag} profiler: no device time recorded (not measured)")
        return rows, wall
    print(f"{tag} profiled main path: wall {wall * 1e3:.1f} ms for {N_FRAMES} frames, device busy "
          f"{total_ms:.1f} ms ({100 * total_ms / (wall * 1e3):.1f}% of wall; profiler on)")
    for t_us, n, key in rows[:15]:
        print(f"{tag}   {t_us / 1e3:9.3f} ms {100 * t_us / 1e3 / total_ms:5.1f}% x{n:<5d} {key[:90]}")
    for label, prefix in shares:
        us = sum(t_us for t_us, _, key in rows if key.startswith(prefix))
        n = sum(c for _, c, key in rows if key.startswith(prefix))
        print(f"{tag} {label}: {us / 1e3:.3f} ms in {n} launches, "
              f"{100 * us / 1e3 / total_ms:.1f}% of device time")
    return rows, wall


def phase_main(torch, predictor, da, tag, expected):
    """VideoPredictor over synthetic 720p frames; returns the launch counts, which
    must equal ``expected`` ({kernel: launches per spot batch})."""
    import xml.etree.ElementTree as ET

    from gomatching_tpu_torch.eval import annotate
    from gomatching_tpu_torch.evaluation.writer import write_video_results

    frames = synthetic_frames()
    predictor.process_video([f.copy() for f in frames[:2]])  # warm-up, not counted
    torch.cuda.synchronize()
    da.reset_launch_counts()
    tc = {}
    t0 = time.time()
    tracked = predictor.process_video([f.copy() for f in frames], tc)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    counts = dict(da.launch_counts)
    walls = [elapsed]
    for _ in range(N_REPEATS - 1):
        t0 = time.time()
        predictor.process_video([f.copy() for f in frames])
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    fps = sorted(N_FRAMES / w for w in walls)

    n_batches = -(-N_FRAMES // predictor.spot_batch)
    check(len(tracked) == N_FRAMES, f"{len(tracked)} tracked frames")
    n_det = sum(len(f) for f in tracked)
    ids = set()
    for f in tracked:
        check(len(set(f.track_ids.tolist())) == len(f), "duplicate track ids in a frame")
        check(f.bd.shape[1:] == (NPTS, 4) and f.ctrl_points.shape[1] == 2 * NPTS, "shapes")
        for a in (f.boxes, f.scores, f.bd, f.ctrl_points):
            check(bool(np.isfinite(a).all()), "non-finite detections")
        ids.update(f.track_ids.tolist())
    stats = predictor.tracker.asso_stats
    check(stats["short_calls"] > 0, f"the short-term matcher never ran: {stats}")
    with tempfile.TemporaryDirectory() as tmp:
        xml_path = os.path.join(tmp, "res_video_1.xml")
        json_path = os.path.join(tmp, "video_1.json")
        write_video_results(annotate(predictor, tracked), json_path, xml_path)
        root = ET.parse(xml_path).getroot()
        with open(json_path) as fp:
            js = json.load(fp)
        n_obj = sum(len(fr) for fr in root)
        check(root.tag == "Frames" and len(js) == N_FRAMES, "XML/JSON structure")
        check(n_obj == sum(len(v) for v in js.values()), "XML and JSON disagree")
    from gomatching_tpu_torch.data.preprocess import compute_test_size

    th, tw = compute_test_size(720, 1280, predictor.cfg.INPUT.MIN_SIZE_TEST,
                               predictor.cfg.INPUT.MAX_SIZE_TEST)
    print(f"{tag} main path: {N_FRAMES} frames 720x1280 -> {th}x{tw}, {N_REPEATS} runs: "
          f"median {fps[len(fps) // 2]:.3f} frames/s (min {fps[0]:.3f}, max {fps[-1]:.3f}; "
          f"spot batch {predictor.spot_batch}); first run: "
          f"{n_det} detections after short-track removal, {len(ids)} tracks, "
          f"{n_obj} XML objects; matcher calls {stats}")
    print(f"{tag} host wall by stage (s): " + ", ".join(f"{k} {v:.4f}" for k, v in tc.items()))
    print(f"{tag} kernels launched in the main path: {counts}")
    for name in counts:
        want = expected.get(name, 0) * n_batches
        check(counts[name] == want, f"{name}: {counts[name]} launches, expected {want}")
    return counts


def phase_merged(torch, da, dam):
    """B5's table build against its plain version (an exact copy), and B5 against its
    plain version and against the B1 kernel at the full-width encoder (Lq = S) and
    decoder (Lq = NQ * NPTS) shapes, locations partly outside the maps; returns the
    kernels-line records of both (B5 at the encoder shape; sans launches)."""
    S = sum(h * w for h, w in SHAPES)
    g = torch.Generator().manual_seed(7)
    dev = "cuda"
    value = torch.randn(B, S, M, D, generator=g).to(dev)
    wh = torch.tensor([[w, h] for h, w in SHAPES], dtype=torch.float32, device=dev)
    off = torch.randn(B, S, M, L, P, 2, generator=g) * 4.0
    far = torch.rand(B, S, M, L, P, 2, generator=g) < 0.01
    off = torch.where(far, off * 100.0, off).to(dev)
    cases = {
        "encoder": (da.encoder_reference_points(SHAPES, dev)[None, :, None, None, None, :]
                    + off / wh[None, None, None, :, None, :]),
        "decoder": (torch.rand(B, NQ * NPTS, M, L, P, 2, generator=g) * 1.2 - 0.1).to(dev),
    }
    del off, far
    table_bytes = B * M * S * 4 * D * 4
    vbm = value.permute(0, 2, 1, 3)
    table = dam.merged_table(value, SHAPES)
    want = dam.merged_corner_table(vbm, SHAPES)
    torch.cuda.synchronize()
    t_err = (table - want).abs().max().item()
    check(t_err == 0.0, f"{dam.MERGED_TABLE}: differs from the plain table by {t_err}")
    rows = dam._corner_rows(SHAPES, dev).reshape(-1)
    t_ms = cuda_time_ms(lambda: dam.merged_table(value, SHAPES))
    t_plain_ms = cuda_time_ms(lambda: dam.merged_corner_table(vbm, SHAPES))
    t_lib_ms = cuda_time_ms(lambda: vbm.index_select(2, rows))
    # a copy: value read once, the table written once
    t_bound, t_by = bound(nbytes(value) + table_bytes, 0)
    print(f"[9] {dam.MERGED_TABLE}: identical to the plain table; kernel {t_ms:.4f} ms, plain "
          f"{t_plain_ms:.4f} ms, index_select {t_lib_ms:.4f} ms, bound {t_bound:.4f} ms ({t_by}: "
          f"{nbytes(value) / 1e6:.1f} MB read, {table_bytes / 1e6:.1f} MB written) at B={B}")
    records = {dam.MERGED_TABLE: dict(
        name=dam.MERGED_TABLE, route="cuda", source="gomatching_tpu_torch/csrc/ms_deform_attn.cu",
        replaces="gomatching_tpu/ops/deform_attn_pallas.py:89", max_abs_err=t_err, ms=t_ms,
        plain_ms=t_plain_ms, bound_ms=t_bound, bound_by=t_by, library_ms=t_lib_ms,
    )}
    del want, rows
    for case, loc in cases.items():
        Lq = loc.shape[1]
        attn = torch.randn(B, Lq, M, L * P, generator=g).softmax(-1).view(B, Lq, M, L, P).to(dev)
        got = dam.ms_deform_attn_merged(value, SHAPES, loc, attn)
        want = dam.ms_deform_attn_merged_plain(value, SHAPES, loc, attn)
        witness = da.ms_deform_attn_queries(value, SHAPES, loc, attn)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_b1 = (got - witness).abs().max().item()
        check(math.isfinite(err) and err <= ATOL_KERNEL, f"{dam.MERGED} {case}: max err {err}")
        check(math.isfinite(err_b1) and err_b1 <= ATOL_KERNEL,
              f"{dam.MERGED} {case}: differs from B1 by {err_b1}")
        same_bits(torch, dam.MERGED, lambda: dam.ms_deform_attn_merged(value, SHAPES, loc, attn),
                  got)
        del want, witness
        ms = cuda_time_ms(lambda: dam.merged_sample(table, SHAPES, loc, attn))
        both_ms = cuda_time_ms(lambda: dam.ms_deform_attn_merged(value, SHAPES, loc, attn))
        plain_ms = cuda_time_ms(lambda: dam.ms_deform_attn_merged_plain(value, SHAPES, loc, attn),
                                iters=3, warmup=1)
        v_bytes, taps = value_reads(torch, loc, S, D)
        samples = B * Lq * M * L * P
        # the function's bound, as B1's: touched value rows, locations, attention, output
        b_ms, b_by = bound(v_bytes + nbytes(loc, attn, got),
                           samples * (20 + 2 * D) + taps * (2 * D + 1))
        print(f"[9] {dam.MERGED} {case} (Lq={Lq}): max|kernel-plain| {err:.3e}, max|kernel-B1| "
              f"{err_b1:.3e} (atol {ATOL_KERNEL}), same bits twice; kernel {ms:.4f} ms on the "
              f"table ({4 * samples / ms / 1e6:.1f} G corner rows/s), with the "
              f"table build {both_ms:.4f} ms, plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms "
              f"({b_by}: {v_bytes / 1e6:.1f} MB of value rows touched of "
              f"{nbytes(value) / 1e6:.1f} MB; the table's {table_bytes / 1e6:.1f} MB written and "
              f"read are not counted) at B={B}")
        if case == "encoder":
            records[dam.MERGED] = dict(
                name=dam.MERGED, route="cuda", source="gomatching_tpu_torch/csrc/ms_deform_attn.cu",
                replaces="gomatching_tpu/ops/deform_attn_pallas.py:49", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            )
        del got, attn
    return records


def phase_merged_path(torch, predictor, da, dam):
    """One frame through the full-depth spotter under SAMPLING_IMPL 'pallas': B5
    against the plain merged version and against the 'vmem' route (B1/B2) on the same
    weights; the B5 route launches B5 and its table build, nothing else."""
    import gomatching_tpu_torch.models.spotter as spotter_mod

    attns = [m for m in predictor.model.modules() if isinstance(m, spotter_mod.MSDeformAttn)]
    check(attns and all(m.sampling_impl == "pallas" for m in attns), "phase 10: not 'pallas'")
    t = predictor.cfg.MODEL.TRANSFORMER

    @contextlib.contextmanager
    def counted():
        # the encoder and the decoder run in separate blocks: 6 launches each
        da.reset_launch_counts()
        yield
        got = {k: v for k, v in da.launch_counts.items() if v}
        check(set(got) == {da.MERGED, da.MERGED_TABLE} and len(set(got.values())) == 1
              and got[da.MERGED] in (t.ENC_LAYERS, t.DEC_LAYERS),
              f"phase 10: the B5 route launched {got} (B5 and its table, once per layer)")

    spotter_errors(torch, "[10]", predictor.model, {
        "B5": counted,
        "plain": lambda: patched(spotter_mod, ms_deform_attn_merged=dam.ms_deform_attn_merged_plain),
        "vmem": lambda: sampling(predictor.model, "vmem"),
    })


def phase_sampler_ab(torch, predictor, n_pairs=10):
    """The same clip on the same weights with SAMPLING_IMPL 'vmem' (B1/B2) and 'pallas'
    (B5 and its table) in turns (vmem, pallas, pallas, vmem, ...): frames/s of each."""
    frames = synthetic_frames()
    fps = {"vmem": [], "pallas": []}
    wins = 0
    for i in range(n_pairs):
        pair = {}
        for impl in ("vmem", "pallas") if i % 2 == 0 else ("pallas", "vmem"):
            with sampling(predictor.model, impl):
                t0 = time.time()
                predictor.process_video([f.copy() for f in frames])
                torch.cuda.synchronize()
                pair[impl] = N_FRAMES / (time.time() - t0)
            fps[impl].append(pair[impl])
        wins += pair["pallas"] > pair["vmem"]
    print(f"[11] sampler A/B, GoMatching++, {n_pairs} alternating pairs: frames/s " + "; ".join(
        f"{k} median {sorted(v)[len(v) // 2]:.3f} (runs {', '.join(f'{x:.3f}' for x in v)})"
        for k, v in fps.items()) + f"; pallas ahead in {wins} of {n_pairs} pairs")


def footprint_inputs(torch, da, dav, daf):
    """Phase 12's inputs at the full-width encoder shapes (seed 11): value (f32), offsets
    beyond TILED_HALO for >= 5% of samples and beyond the maps for some, logits, and the four
    B6 entries' cases: (name, the entry as a function of value, its plain version as one,
    the locations and attention B1 takes for the same function, the footprints for value
    elements of a given size under the current budget, the locations in the kernel's query
    order, the TPU kernel, the entry's inputs). Returns (value, off, logits, loc, attn,
    share beyond the halo, share outside the maps, cases)."""
    S = sum(h * w for h, w in SHAPES)
    g = torch.Generator().manual_seed(11)
    dev = "cuda"
    value = torch.randn(B, S, M, D, generator=g).to(dev)
    wh = torch.tensor([[w, h] for h, w in SHAPES], dtype=torch.float32, device=dev)
    # offsets of a few cells (beyond the halo for ~1 sample in 6), 1% of them 100x
    off = torch.randn(B, S, M, L, P, 2, generator=g) * 3.0
    far = torch.rand(B, S, M, L, P, 2, generator=g) < 0.01
    off = torch.where(far, off * 100.0, off).to(dev)
    del far
    logits = torch.randn(B, S, M, L * P, generator=g).to(dev)
    attn = logits.softmax(-1).view(B, S, M, L, P)
    loc = (da.encoder_reference_points(SHAPES, dev)[None, :, None, None, None, :]
           + off / wh[None, None, None, :, None, :])
    beyond = (off.abs() > TILED_HALO).any(-1).float().mean().item()
    outside = ((loc < 0) | (loc > 1)).any(-1).float().mean().item()
    check(beyond >= 0.05 and outside > 0, f"phase 12 inputs: {beyond} beyond the halo, "
          f"{outside} outside the maps")
    perm = torch.from_numpy(dav.tile_major_perm(SHAPES)[0].astype(np.int64)).to(dev)
    S_tm = perm.numel()
    locT = loc[:, perm].permute(0, 2, 3, 4, 5, 1).contiguous()
    attnT = attn[:, perm].permute(0, 2, 3, 4, 1).contiguous()
    offT = off[:, perm].permute(0, 3, 5, 2, 4, 1).reshape(B, 2 * L * M * P, S_tm).contiguous()
    attnT3 = attn[:, perm].permute(0, 3, 2, 4, 1).reshape(B, L * M * P, S_tm).contiguous()
    loc3, attn3 = (t.contiguous() for t in dav.v3_locations(SHAPES, offT, attnT3, M))
    h = TILED_HALO
    cases = [
        (da.VMEM, lambda v: dav.ms_deform_attn_encoder_vmem(v, SHAPES, loc, attn, h),
         lambda v: dav.sampler_plain(v, SHAPES, loc, attn),
         (loc, attn), lambda eb=4: dav.vmem_footprints(da.VMEM, SHAPES, P, h, elem_bytes=eb),
         loc, "gomatching_tpu/ops/deform_attn_vmem.py:896", (loc, attn)),
        (da.VMEM_TM, lambda v: dav.ms_deform_attn_encoder_vmem_tm(v, SHAPES, locT, attnT, h),
         lambda v: dav.ms_deform_attn_encoder_vmem_tm_plain(v, SHAPES, locT, attnT),
         (loc, attn), lambda eb=4: dav.vmem_footprints(da.VMEM_TM, SHAPES, P, h, S_tm=S_tm,
                                                       elem_bytes=eb),
         loc[:, perm], "gomatching_tpu/ops/deform_attn_vmem.py:896", (locT, attnT)),
        (da.VMEM_V3, lambda v: dav.ms_deform_attn_encoder_vmem_v3(v, SHAPES, offT, attnT3, h),
         lambda v: dav.ms_deform_attn_encoder_vmem_v3_plain(v, SHAPES, offT, attnT3),
         (loc3, attn3), lambda eb=4: dav.vmem_footprints(da.VMEM_V3, SHAPES, P, h, S_tm=S_tm,
                                                         elem_bytes=eb),
         loc3, "gomatching_tpu/ops/deform_attn_vmem.py:724", (offT, attnT3)),
        (da.FUSED, lambda v: daf.ms_deform_attn_encoder_fused(v, SHAPES, loc, attn, h),
         lambda v: dav.sampler_plain(v, SHAPES, loc, attn),
         (loc, attn), lambda eb=4: daf.fused_footprints(SHAPES, P, h, elem_bytes=eb), loc,
         "gomatching_tpu/ops/deform_attn_fused.py:54", (loc, attn)),
    ]
    return value, off, logits, loc, attn, beyond, outside, cases


def phase_footprint(torch, da, dav, daf, _build):
    """B6a-c at the full-width encoder shapes: each entry against its plain version and
    the B1 kernel, its launch, its direct route and its refusal under autograd, and the
    buffers-against-occupancy trade-off in turns; returns the kernels-line records (sans
    launches)."""
    S = sum(h * w for h, w in SHAPES)
    value, off, logits, loc, attn, beyond, outside, cases = footprint_inputs(torch, da, dav, daf)
    b1_ms = cuda_time_ms(lambda: da.ms_deform_attn_queries(value, SHAPES, loc, attn))
    b2_ms = cuda_time_ms(lambda: da.ms_deform_attn_encoder(value, SHAPES, off, logits))
    # (budget SMEM_BLOCK_BYTES, library, warps a block) of the buffers-against-occupancy
    # trade-off: the shipped build and budget (one block of 16 warps an SM, large buffers);
    # blocks of 8 warps, four an SM, from the -DFP_WARPS=8 measurement build, whose small
    # buffers fit no footprint at these shapes, so under a budget of 0; and the shipped
    # build under a budget of 0 (every pair direct): staging against gathering at the same
    # occupancy
    lib8 = measurement_lib(_build, da, FP_WARPS8_FLAGS)
    configs = {"shipped": (dav.SMEM_BLOCK_BYTES, None, 16), "four blocks": (0, lib8, 8),
               "one block, direct": (0, None, 16)}
    print(f"[12] footprint copies: TMA (one cp.async.bulk.tensor.5d box per staged footprint, "
          f"completion on an mbarrier), {dav.NBUF} buffers a block; (budget SMEM_BLOCK_BYTES, "
          f"warps a block): " + ", ".join(f"{k} ({c[0]}, {c[2]})" for k, c in configs.items()))

    @contextlib.contextmanager
    def config(label):
        cap, lib, _ = configs[label]
        with patched(dav, SMEM_BLOCK_BYTES=cap, **({"load": lambda *_: lib} if lib else {})):
            dav.footprints.cache_clear()
            try:
                yield
            finally:
                dav.footprints.cache_clear()

    records = {}
    for name, entry, plain, (w_loc, w_attn), fp_of, fp_loc, replaces, inputs in cases:
        def call():
            return entry(value)

        before = da.launch_counts[name]
        got = call()
        check(da.launch_counts[name] == before + 1, f"{name}: the kernel did not launch")
        want = plain(value)
        witness = da.ms_deform_attn_queries(value, SHAPES, w_loc, w_attn)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_b1 = (got - witness).abs().max().item()
        check(math.isfinite(err) and err <= ATOL_KERNEL, f"{name}: max err {err}")
        check(math.isfinite(err_b1) and err_b1 <= ATOL_KERNEL, f"{name}: differs from B1 by {err_b1}")
        same_bits(torch, name, call, got)
        del witness
        fps, shares, errs = {}, {}, {}
        for label in configs:
            with config(label):
                fps[label] = fp_of()
                shares[label] = dav.staged_share(fps[label], SHAPES, fp_loc)
                if label != "shipped":
                    errs[label] = (call() - want).abs().max().item()
                    check(math.isfinite(errs[label]) and errs[label] <= ATOL_KERNEL,
                          f"{name} ({label}): max err {errs[label]}")
        del want
        # a pair over the budget reads nothing from shared memory: under the shipped budget,
        # or under the budget of 0 if the shipped one stages every pair with taps
        direct = []
        for label in ("shipped", "one block, direct"):
            fp, share = fps[label], shares[label]
            direct = [pair for pair, (n_smem, n_taps) in share.items()
                      if not fp.pairs[pair[0]][pair[1]][4] and n_taps > 0]
            if direct:
                check(all(share[p][0] == 0 for p in direct),
                      f"{name}: a direct pair read from shared memory ({label} budget)")
                break
        check(direct, f"{name}: no (source, target) pair over the budget on the direct route")
        check(not fps["one block, direct"].boxes.any() and not fps["four blocks"].boxes.any(),
              f"{name}: a budget of 0 stages a footprint")
        try:
            entry(value.detach().requires_grad_(True))
            raised = False
        except RuntimeError as e:
            raised = "no backward" in str(e)
        check(raised, f"{name}: did not raise under autograd")
        # the three configurations in turns (a, b, c, c, b, a)
        runs = {label: [] for label in configs}
        for label in (*configs, *reversed(configs)):
            with config(label):
                runs[label].append(cuda_time_ms(call))
        warps = {label: (lib_kernel_info(lib, 5 + fps[label].layout, fps[label].smem_bytes)
                         if lib else list(dav.footprint_kernel_info(fps[label]).values())[
                             fps[label].layout])["warps_per_sm"]
                 for label, (_, lib, _) in configs.items()}
        ms = sum(runs["shipped"]) / len(runs["shipped"])
        plain_ms = cuda_time_ms(lambda: plain(value), iters=3, warmup=1)
        v_bytes, taps = value_reads(torch, w_loc, S, D)
        samples = w_loc.shape[1] * B * M * L * P
        b_ms, b_by = bound(v_bytes + nbytes(*inputs, got), samples * (20 + 2 * D) + taps * (2 * D + 1))
        records[name] = dict(
            name=name, route="cuda", source="gomatching_tpu_torch/csrc/ms_deform_attn.cu",
            replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
        )

        def staged_pct(label):
            smem, n_taps = (sum(v[k] for v in shares[label].values()) for k in (0, 1))
            return f"{100 * smem / n_taps:.1f}%"

        print(f"[12] {name} (Lq={w_loc.shape[1]}): max|kernel-plain| {err:.3e}, max|kernel-B1| "
              f"{err_b1:.3e} (atol {ATOL_KERNEL}), same bits twice; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); on the same function B1 "
              f"{b1_ms:.4f} ms, B2 {b2_ms:.4f} ms; direct pairs {direct}; raises under autograd; "
              f"at B={B}, halo {TILED_HALO}, {100 * beyond:.1f}% of samples beyond the halo, "
              f"{100 * outside:.2f}% outside the maps")
        for label, (cap, _, block_warps) in configs.items():
            fp = fps[label]
            print(f"[12]   {name} {label} (SMEM_BLOCK_BYTES {cap}): "
                  f"{', '.join(f'{t:.4f}' for t in runs[label])} ms in turns; "
                  f"{block_warps} warps and {fp.smem_bytes} bytes of shared memory a block, "
                  f"{warps[label]} resident "
                  f"warps per SM; {sum(st for row in fp.pairs for *_, st in row)} of "
                  f"{len(SHAPES) ** 2} pairs staged, {staged_pct(label)} of in-map corner taps "
                  f"from shared memory"
                  + (f"; max|kernel-plain| {errs[label]:.3e}" if label in errs else ""))
        del got
    return records


def phase_bench(torch, da, dav):
    """This slice's path: the sampler benchmark's ``main`` over every sampler and two
    tilesets, in f32 (the port's earlier records) and in bf16 (JAX's dtype): in f32 each
    within ATOL_KERNEL of the exact gather, in bf16 each output within one rounding of it
    (``round_excess`` <= 0); each B6 entry launched. Returns the launch counts of the two
    runs, f32 and bf16."""
    from gomatching_tpu_torch.tools import bench_deform_attn as bench

    names = {"gather": "B1", "encoder": "B2", "merged": "B5 with its table", "vmem": "B6a",
             "vmem_tm": "B6a, tile-major", "vmem_v3": "B6b", "fused": "B6c"}
    all_counts = []
    for dtype in ("float32", "bfloat16"):
        torch.cuda.synchronize()
        da.reset_launch_counts()
        res = bench.main(["--batch", str(B), "--halo", str(TILED_HALO), "--tilesets", TILESETS,
                          "--dtype", dtype])
        torch.cuda.synchronize()
        counts = dict(da.launch_counts)
        for r in res["results"]:
            ok = (r["max_abs_err"] <= ATOL_KERNEL if dtype == "float32"
                  else r["round_excess"] <= 0)
            check(math.isfinite(r["max_abs_err"]) and ok,
                  f"phase 13: {r['impl']} {r['tiles']} ({dtype}) differs from the exact gather by "
                  f"{r['max_abs_err']} ({r.get('round_excess')} past one bf16 rounding)")
        entries = (da.VMEM, da.VMEM_TM, da.VMEM_V3, da.FUSED)
        for name in (entries if dtype == "float32" else [dav.BF16_NAMES[n] for n in entries]):
            check(counts[name] > 0, f"phase 13: {name} never launched")
        ms = {}
        for r in res["results"]:
            ms.setdefault(r["impl"], []).append(r["ms"])
        within = (f"within {ATOL_KERNEL} of" if dtype == "float32"
                  else "within one bf16 rounding (2**-8 |exact| + 3e-5) of")
        print(f"[13] sampler benchmark, value {dtype}: {len(res['results'])} runs {within} the "
              f"exact gather; launches {counts}; per encoder call on the same samples (ms; B6 "
              f"per tileset): " + "; ".join(f"{names.get(k, k)} {', '.join(f'{t:.4f}' for t in v)}"
                                            for k, v in ms.items()))
        all_counts.append(counts)
    return tuple(all_counts)


PROFILE_TRIES = 3  # profiles of one measurement before its device time is "not measured"


def marker_rows(torch, fn, marker, n=20):
    """``device_rows`` of the kernels whose name contains ``marker`` over ``n`` calls of
    ``fn`` under torch.profiler, profiled anew (up to PROFILE_TRIES times) while it records
    none of them: a profile sometimes records no device time at all. [] if none recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in device_rows(torch, prof) if marker in r[2]]
        if rows:
            return rows
    return []


def device_us(torch, fn, marker, n=20):
    """Device time per call of ``fn`` (us) summed over the kernels whose name contains
    ``marker``, from torch.profiler over ``n`` calls: what the card spends, without the
    host's launch cost; None when the profiler records no device time."""
    us = sum(t for t, _, _ in marker_rows(torch, fn, marker, n))
    return us / n if us > 0 else None


def fmt_us(us):
    return "not measured" if us is None else f"{us:.2f} us"


def probes_lib(_build, gp, flags=()):
    """``csrc/probes.cu`` built with ``flags`` added (a measurement build, which the
    wrappers never load), typed as the wrappers type it, with ``probes_kernel_info`` and,
    in the ``T1_L2_FLAGS`` build, ``probe_empty``."""
    import ctypes

    lib = ctypes.CDLL(str(_build.build("probes.cu", flags=_build.NVCC_FLAGS + flags)))
    sigs = {**gp._SIGNATURES, "probes_kernel_info": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]}
    if flags == T1_L2_FLAGS:
        sigs["probe_empty"] = [ctypes.c_void_p]
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


# probes_kernel_info's kernels: (index, name, a substring of the mangled name)
PROBE_KERNELS = [
    (0, "T1 pass A: count", "gather_rows_sum_count_kernel"),
    (1, "T1 pass A: scan", "gather_rows_sum_scan_kernel"),
    (2, "T1 pass A: scatter", "gather_rows_sum_scatter_kernel"),
    (3, "T1 pass B, f32 C=32", "gather_rows_sum_slices_kernelIfLi8E"),
    (4, "T1 pass B, f32 C=128 (chunks a row at run time)", "gather_rows_sum_slices_kernelIfLi0E"),
    (5, "T1 pass B, bf16 C=32", "gather_rows_sum_slices_kernelI13__nv_bfloat16Li4E"),
    (6, "T1 last pass", "gather_rows_sum_final_kernel"),
    (7, "T2 f32/f32", "onehot_g_kernelILb0EfE"),
    (8, "T2 bf16/bf16", "onehot_g_kernelILb1E13__nv_bfloat16E"),
    (9, "T2 f32/bf16", "onehot_g_kernelILb0E13__nv_bfloat16E"),
]
# the T1_L2_GATHER build's earlier T1 (its kernels 3-5)
PROBE_KERNELS_L2 = [
    (3, "earlier T1, f32 C=32", "gather_rows_sum_kernelIfLi1E"),
    (4, "earlier T1, f32 C=128", "gather_rows_sum_kernelIfLi4E"),
    (5, "earlier T1, bf16 C=32", "gather_rows_sum_kernelI13__nv_bfloat16Li1E"),
]


def phase_probe_resources(_build, gp):
    """What ptxas and the runtime made of the probe kernels (T1's passes, T2's three
    instantiations) and of the earlier T1 in the measurement build: registers, stack and
    spills from nvcc's report, and registers, local memory and static shared memory a
    block from the CUDA runtime. None may keep anything in local memory."""
    import ctypes

    for flags, kernels in (((), PROBE_KERNELS), (T1_L2_FLAGS, PROBE_KERNELS_L2)):
        lib = probes_lib(_build, gp, flags)
        report = ptxas_report(_build.build_log("probes.cu", _build.NVCC_FLAGS + flags),
                              {name: key for _, name, key in kernels})
        for which, name, key in kernels:
            info = (ctypes.c_int * 3)()
            rc = lib.probes_kernel_info(which, info)
            check(rc == 0, f"probes_kernel_info({which}) {' '.join(flags)}: cudaError {rc}")
            check(report[name], f"{name}: no ptxas report for {key}")
            print(f"[1] {name} ({key}{', ' + ' '.join(flags) if flags else ''}): ptxas: "
                  f"{'; '.join(report[name])}; runtime: {info[0]} registers, {info[1]} bytes of "
                  f"local memory a thread, {info[2]} bytes of static shared memory a block")
            check(info[1] == 0, f"{name}: {info[1]} bytes of local memory a thread")


def device_split(torch, fn, marker, n=20):
    """Device time per call of ``fn`` (us) of each kernel whose name contains ``marker``,
    by kernel (its name up to the argument list), from torch.profiler over ``n`` calls;
    {} when the profiler records no device time."""
    out = {}
    for t, _, key in marker_rows(torch, fn, marker, n):
        name = key.split("(")[0].replace("void ", "")
        out[name] = out.get(name, 0.0) + t / n
    return out


def sm_clock_mhz():
    """The SM clock the card reports as its maximum (MHz)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def phase_probes(torch, gp, og, _build):
    """T1 and T2 against their plain versions at the probe tools' shapes; T1's earlier form
    (the T1_L2_GATHER build) against the shipped one in turns, and both on all-zero
    indices; T2 at G_LARGE_Q; an empty kernel. Returns the kernels-line records (sans
    launches): T1 at (32768, 32, 64) f32, T2 in f32."""
    import ctypes

    from gomatching_tpu_torch.tools import bench_gather, probe_bf16_g

    dev = "cuda"
    rng = np.random.RandomState(5)
    records = {}
    libs = {"earlier": probes_lib(_build, gp, T1_L2_FLAGS), "shipped": probes_lib(_build, gp)}
    no_copy = probes_lib(_build, gp, T1_NO_COPY_FLAGS)
    stream = torch.cuda.current_stream().cuda_stream
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_mhz()
    smem_rate = SMEM_BYTES_PER_CLOCK * n_sms * clock * 1e6  # bytes/s
    empty_us = device_us(torch, lambda: libs["earlier"].probe_empty(stream), "probe_empty", n=100)
    print(f"[14] an empty kernel (one block of 32 threads): device {fmt_us(empty_us)} a launch "
          f"(the launch floor); SM clock {clock:.0f} MHz, {n_sms} SMs: shared memory "
          f"{smem_rate / 1e12:.2f} TB/s at {SMEM_BYTES_PER_CLOCK} bytes a clock an SM")
    for R, C, n, dtype in bench_gather.CASES:
        idx = torch.from_numpy(rng.randint(0, R, (n, R)).astype(np.int32)).to(dev)
        flat = idx.flatten()
        rows_per_slice, n_slices = gp.slice_plan(R, C, 2 if dtype == torch.bfloat16 else 4)
        sizes = (ctypes.c_int64 * 5)()
        check(libs["shipped"].gather_rows_sum_scratch(idx.numel(), n_slices, n_sms, sizes) == 0,
              "gather_rows_sum_scratch refused the plan")
        check(tuple(sizes) == gp.scratch_sizes(idx.numel(), n_slices, n_sms),
              f"{gp.GATHER}: the C scratch sizes {tuple(sizes)} differ from scratch_sizes' "
              f"{gp.scratch_sizes(idx.numel(), n_slices, n_sms)}")
        # integer entries in -3..3 (exact in bf16): every partial sum is an integer far
        # below 2**24, so the kernel, the plain version and the f64 sum agree exactly
        v = torch.from_numpy(rng.randint(-3, 4, (R, C)).astype(np.float32)).to(dtype).to(dev)
        got, want = gp.gather_rows_sum(v, idx).item(), gp.gather_rows_sum_plain(v, idx).item()
        exact = torch.index_select(v.double(), 0, flat).sum().item()
        check(got == want == exact, f"{gp.GATHER} {R}x{C} x{n} {dtype} on integers: kernel "
              f"{got}, plain {want}, exact {exact}")
        v = torch.from_numpy(rng.randn(R, C).astype(np.float32)).to(dtype).to(dev)
        before = gp.launch_counts[gp.GATHER]
        got = gp.gather_rows_sum(v, idx)
        check(gp.launch_counts[gp.GATHER] == before + 1, f"{gp.GATHER}: the kernel did not launch")
        want = gp.gather_rows_sum_plain(v, idx)
        again = gp.gather_rows_sum(v, idx)
        exact = torch.index_select(v.double(), 0, flat).sum().item()
        scale = torch.index_select(v.double().abs(), 0, flat).sum().item()
        err = abs(got.item() - want.item())
        check(math.isfinite(err) and err <= RTOL_GATHER * scale,
              f"{gp.GATHER} {R}x{C} x{n} {dtype}: |kernel - plain| {err} > {RTOL_GATHER} * {scale}")
        check(torch.equal(got, again), f"{gp.GATHER}: two runs differ")
        ms = cuda_time_ms(lambda: gp.gather_rows_sum(v, idx))
        split = device_split(torch, lambda: gp.gather_rows_sum(v, idx), "gather_rows_sum")
        us = sum(split.values()) or None
        device = (f"device {fmt_us(us)}: " + ", ".join(
            f"{k.replace('gather_rows_sum_', '')} {t:.2f}" for k, t in split.items())
            if us else "device not measured")
        plain_ms = cuda_time_ms(lambda: gp.gather_rows_sum_plain(v, idx))
        lib_ms = cuda_time_ms(lambda: bench_gather.library_sum(v, idx))
        select_ms = cuda_time_ms(lambda: torch.index_select(v, 0, flat))  # its first half
        # the table and the indices read once, one float written; the adds in f32
        b_ms, b_by = bound(nbytes(v, idx) + 4, n * R * C)
        rows, gathered = n * R, n * R * C * v.element_size()
        device_rate = f"{gathered / us / 1e3:.1f} GB/s" if us else "not measured"
        smem_ms = gathered / smem_rate * 1e3  # every gathered row read from shared memory
        print(f"[14] {gp.GATHER} R={R} C={C} x{n} {str(dtype)[6:]}: {n_slices} slices of "
              f"{rows_per_slice} rows; exact on integers; randn |kernel-plain| {err:.3e} = "
              f"{err / scale:.2e} of sum|terms| (rtol {RTOL_GATHER:.2e}), kernel-exact "
              f"{abs(got.item() - exact) / scale:.2e}, plain-exact {abs(want.item() - exact) / scale:.2e}, "
              f"same bits twice; kernel {ms:.4f} ms ({device}) -> {rows / ms / 1e3:.0f}M rows/s, "
              f"{gathered / ms / 1e6:.1f} GB/s gathered ({device_rate} of device time); plain "
              f"{plain_ms:.4f} ms, "
              f"index_select+sum {lib_ms:.4f} ms ({rows / lib_ms / 1e3:.0f}M rows/s; index_select "
              f"alone {select_ms:.4f} ms); bound {b_ms:.4f} ms ({b_by}: {nbytes(v, idx) / 1e6:.2f} "
              f"MB), shared-memory bound {smem_ms:.4f} ms ({gathered / 1e6:.1f} MB gathered)")
        if (R, C, n, dtype) == (32768, 32, 64, torch.float32):
            records[gp.GATHER] = dict(
                name=gp.GATHER, route="cuda", source="gomatching_tpu_torch/csrc/probes.cu",
                replaces="tools/bench_pallas_gather.py:49", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            )

        # the earlier form (the measurement build) and the shipped one on the same inputs,
        # in turns (earlier, shipped, shipped, earlier), then both on all-zero indices
        scratch = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
        out = torch.empty(1, dtype=torch.float32, device=dev)

        def raw(lib, i=idx):
            return lib.gather_rows_sum(v.data_ptr(), i.data_ptr(), scratch.data_ptr(),
                                       out.data_ptr(), i.numel(), R, C,
                                       int(dtype == torch.bfloat16), rows_per_slice, n_slices,
                                       n_sms, stream)

        times = {k: [] for k in libs}
        for k in ("earlier", "shipped", "shipped", "earlier"):
            check(raw(libs[k]) == 0, f"{gp.GATHER}: the {k} build refused the launch")
            times[k].append(device_us(torch, lambda: raw(libs[k]), "gather_rows_sum"))
        zeros = torch.zeros_like(idx)
        floor = {k: device_us(torch, lambda: raw(libs[k], zeros), "gather_rows_sum") for k in libs}
        # pass B alone, shipped and without its slice copies, in turns (the copies' cost)
        pass_b = {"shipped": [], "no copies": []}
        for k in ("shipped", "no copies", "no copies", "shipped"):
            lib = libs["shipped"] if k == "shipped" else no_copy
            check(raw(lib) == 0, f"{gp.GATHER}: the {k} build refused the launch")
            pass_b[k].append(device_us(torch, lambda: raw(lib), "gather_rows_sum_slices"))
        print(f"[14] {gp.GATHER} R={R} C={C} x{n} {str(dtype)[6:]} in turns, device us: "
              + "; ".join(f"{k} {', '.join(fmt_us(t) for t in ts)}" for k, ts in times.items())
              + "; all-zero indices (every row the same): "
              + ", ".join(f"{k} {fmt_us(t)}" for k, t in floor.items())
              + "; pass B alone in turns: "
              + "; ".join(f"{k} {', '.join(fmt_us(t) for t in ts)}" for k, ts in pass_b.items()))
        del v, idx, flat, got, want, again, scratch, zeros

    P, FH, FW, Q = probe_bf16_g.P, probe_bf16_g.FH, probe_bf16_g.FW, probe_bf16_g.Q
    for q in (Q, G_LARGE_Q):
        x = torch.from_numpy(rng.uniform(-2, FW + 1, (P, q)).astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.uniform(-2, FH + 1, (P, q)).astype(np.float32)).to(dev)
        a = torch.from_numpy(rng.uniform(0, 1, (P, q)).astype(np.float32)).to(dev)
        for dtype, out_dtype in og.VARIANTS:
            def call():
                return og.onehot_g(x, y, a, FH, FW, dtype, out_dtype)

            before = og.launch_counts[og.ONEHOT]
            got = call()
            check(og.launch_counts[og.ONEHOT] == before + 1, f"{og.ONEHOT}: the kernel did not launch")
            want = og.onehot_g_plain(x, y, a, FH, FW, dtype, out_dtype)
            err = (got.float() - want.float()).abs().max().item()
            differ = int((got != want).sum().item())
            tag = f"{og.ONEHOT} {str(dtype)[6:]} arithmetic, {str(out_dtype)[6:]} out"
            if out_dtype == torch.float32:
                check(math.isfinite(err) and err <= ATOL_G, f"{tag}: max err {err}")
                how = f"max|kernel-plain| {err:.3e} (atol {ATOL_G}), {differ} elements differ"
            else:
                # G >= 0 here, so adjacent bf16 values have adjacent bit patterns
                ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs().max().item()
                check(ulps <= 1, f"{tag}: {differ} elements differ, by up to {ulps} bf16 ulps")
                how = (f"{differ} of {got.numel()} elements differ from plain"
                       + (f" by 1 bf16 ulp (max {err:.3e})" if differ else ""))
            ms = cuda_time_ms(call)
            us = device_us(torch, call, "onehot_g_kernel")
            plain_ms = cuda_time_ms(lambda: og.onehot_g_plain(x, y, a, FH, FW, dtype, out_dtype))
            # G written once, x, y, a read once; 2 P flops per element
            b_ms, b_by = bound(nbytes(got, x, y, a), 2 * P * FH * FW * q)
            print(f"[14] {tag} (P={P}, {FH}x{FW}x{q}): {how}; kernel {ms:.4f} ms per call "
                  f"(device {fmt_us(us)}), plain {plain_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by}: "
                  f"{nbytes(got, x, y, a) / 1e6:.2f} MB); no single PyTorch call computes it")
            if out_dtype == torch.float32 and q == Q:
                records[og.ONEHOT] = dict(
                    name=og.ONEHOT, route="cuda", source="gomatching_tpu_torch/csrc/probes.cu",
                    replaces="tools/probe_bf16_g.py:35", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                )
            del got, want
        del x, y, a
    return records


def phase_probe_tools(torch, gp, og):
    """This slice's path: both probe tools' ``main`` on the card; returns the launch
    counts of that run."""
    from gomatching_tpu_torch.tools import bench_gather, probe_bf16_g

    torch.cuda.synchronize()
    gp.reset_launch_counts()
    og.reset_launch_counts()
    gather = bench_gather.main([])
    probe = probe_bf16_g.main([])
    torch.cuda.synchronize()
    counts = {**gp.launch_counts, **og.launch_counts}
    for r in gather["results"]:
        check(all(math.isfinite(r[k]) for k in ("value", "library_value", "kernel_ms")),
              f"phase 14: bench_gather {r}")
    check(0 < probe["bf16_max_abs_err"] < 0.2 and 0 < probe["mixed_max_abs_err"] <= 2 ** -8,
          f"phase 14: probe_bf16_g errors {probe}")
    for name, c in counts.items():
        check(c > 0, f"phase 14: {name} never launched")
    print(f"[14] probe tools: {len(gather['results'])} gather cases, "
          f"{len(probe['ms'])} G variants; launches {counts}")
    return counts


def in_turns(name, call, libs, builds, what):
    """Time ``call(lib)`` on the two builds in turns (a, b, b, a); print both means."""
    times = {k: [] for k in builds}
    for build in (builds[0], builds[1], builds[1], builds[0]):
        check(call(libs[build]) == 0, f"{name}: the {build} build refused the launch")
        times[build].append(cuda_time_ms(lambda: call(libs[build])))
    real, other = (sum(times[k]) / len(times[k]) for k in builds)
    print(f"[15] {name}: real build {real:.4f} ms, {builds[1]} {other:.4f} ms (in turns: " + ", ".join(
        f"{k} {', '.join(f'{t:.4f}' for t in v)}" for k, v in times.items())
        + f"): {what} {real - other:.4f} ms, {100 * (real - other) / real:.1f}% of the real time")


def phase_gather_floor(torch, da, dam, _build):
    """B1, B2 and B5 from the measurement build in which every gathered row is row 0 of
    its base (an L1 hit) against the real build, on the same inputs and in turns (real,
    row 0, row 0, real): what the memory system adds to each kernel's time; and B4 and B3
    from the build without their dValue atomics against the real build, in turns: what
    the scatter adds to each."""
    import ctypes

    S = sum(h * w for h, w in SHAPES)
    g = torch.Generator().manual_seed(0)
    dev = "cuda"
    value = torch.randn(B, S, M, D, generator=g).to(dev)
    off = (torch.randn(B, S, M, L, P, 2, generator=g) * 4.0).to(dev)
    logits = torch.randn(B, S, M, L * P, generator=g).to(dev)
    wh = torch.tensor([[w, h] for h, w in SHAPES], dtype=torch.float32, device=dev)
    loc = (da.encoder_reference_points(SHAPES, dev)[None, :, None, None, None, :]
           + off / wh[None, None, None, :, None, :]).contiguous()
    attn = logits.softmax(-1).view(B, S, M, L, P).contiguous()
    Lq = NQ * NPTS
    dec_loc = (torch.rand(B, Lq, M, L, P, 2, generator=g) * 1.2 - 0.1).to(dev)
    dec_attn = torch.randn(B, Lq, M, L * P, generator=g).softmax(-1).view(B, Lq, M, L, P).to(dev)
    table = dam.merged_table(value, SHAPES)
    out = torch.empty(B, S, M * D, device=dev)
    flat = (ctypes.c_int * (2 * L))(*[x for hw in SHAPES for x in hw])
    stream = torch.cuda.current_stream().cuda_stream
    libs = {build: measurement_lib(_build, da, flags)
            for build, flags in (("real", ()), ("row 0", ROW0_FLAGS),
                                 ("no scatter", NO_SCATTER_FLAGS))}
    calls = {
        f"{da.QUERIES} at B={B}, Lq={Lq}": lambda lib: lib.ms_deform_attn_queries_fwd(
            value.data_ptr(), dec_loc.data_ptr(), dec_attn.data_ptr(), out.data_ptr(), flat,
            B, S, Lq, M, D, L, P, stream),
        f"{da.QUERIES} at B={B}, Lq={S}": lambda lib: lib.ms_deform_attn_queries_fwd(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(), flat,
            B, S, S, M, D, L, P, stream),
        f"{da.ENCODER} at B={B}, Lq={S}": lambda lib: lib.ms_deform_attn_encoder_fwd(
            value.data_ptr(), off.data_ptr(), logits.data_ptr(), out.data_ptr(), flat,
            B, S, M, D, L, P, stream),
        f"{da.MERGED} at B={B}, Lq={S}": lambda lib: lib.ms_deform_attn_merged_fwd(
            table.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(), flat,
            B, S, S, M, D, L, P, stream),
    }
    for name, call in calls.items():
        in_turns(name, call, libs, ("real", "row 0"),
                 "every gathered row an L1 hit; the memory system adds")
    del value, off, logits, loc, attn, dec_loc, dec_attn, table, out

    # B4 at the pretraining shape, as phase 6 (dValue accumulates over the timed calls)
    S = sum(h * w for h, w in TRAIN_SHAPES)
    flat = (ctypes.c_int * (2 * L))(*[x for hw in TRAIN_SHAPES for x in hw])
    value = torch.randn(1, S, M, D, generator=g).to(dev)
    off = (torch.randn(1, S, M, L, P, 2, generator=g) * 4.0).to(dev)
    logits = torch.randn(1, S, M, L * P, generator=g).to(dev)
    dout = torch.randn(1, S, M * D, generator=g).to(dev)
    grads = [torch.zeros(1, S, M, D, device=dev), torch.empty(1, S, M, L, P, 2, device=dev),
             torch.empty(1, S, M, L * P, device=dev)]
    in_turns(f"{da.ENCODER_BWD} at B=1, Lq={S}", lambda lib: lib.ms_deform_attn_encoder_bwd(
        value.data_ptr(), off.data_ptr(), logits.data_ptr(), dout.data_ptr(),
        *(t.data_ptr() for t in grads), flat, 1, S, M, D, L, P, stream), libs,
        ("real", "no scatter"), "without the dValue atomics; the scatter adds")
    # B3 at the pretraining shape, as phase 6
    Lq = NQ * NPTS
    loc = (torch.rand(1, Lq, M, L, P, 2, generator=g) * 1.2 - 0.1).to(dev)
    attn = torch.randn(1, Lq, M, L * P, generator=g).softmax(-1).view(1, Lq, M, L, P).to(dev)
    dout = torch.randn(1, Lq, M * D, generator=g).to(dev)
    grads = [torch.zeros(1, S, M, D, device=dev), torch.empty(1, Lq, M, L, P, 2, device=dev),
             torch.empty(1, Lq, M, L, P, device=dev)]
    in_turns(f"{da.QUERIES_BWD} at B=1, Lq={Lq}", lambda lib: lib.ms_deform_attn_queries_bwd(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(), dout.data_ptr(),
        *(t.data_ptr() for t in grads), flat, 1, S, Lq, M, D, L, P, stream), libs,
        ("real", "no scatter"), "without the dValue atomics; the scatter adds")


def off_grid(torch, x, margin=1e-3):
    """Move pixel coordinates that lie within ``margin`` of a grid line off it: the
    bilinear derivative jumps there, and two right versions that round x differently
    may take either side."""
    r = torch.round(x)
    f = x - r
    return torch.where(f.abs() < margin, r + torch.where(f < 0, -margin, margin), x)


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_backward(torch, da):
    """Each backward kernel against its plain version at the pretraining shapes;
    returns the kernels-line records (sans launches)."""
    shapes = TRAIN_SHAPES
    S = sum(h * w for h, w in shapes)
    Lq = NQ * NPTS
    g = torch.Generator().manual_seed(2)
    dev = "cuda"
    value = torch.randn(1, S, M, D, generator=g).to(dev)
    records = {}
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)

    # B3: arbitrary locations, some outside [0, 1], none on a grid line
    loc = (torch.rand(1, Lq, M, L, P, 2, generator=g) * 1.2 - 0.1).to(dev)
    loc = (off_grid(torch, loc * wh[:, None, :] - 0.5) + 0.5) / wh[:, None, :]
    attn = torch.randn(1, Lq, M, L * P, generator=g).softmax(-1).view(1, Lq, M, L, P).to(dev)
    dout = torch.randn(1, Lq, M * D, generator=g).to(dev)
    args3 = (value, shapes, loc, attn, dout)

    # B4: raw offsets of a few cells, some far beyond the map, none on a grid line
    # (x = ref * W + off - 0.5 at the sample's level W; ref * W is a multiple of 1/16)
    off = torch.randn(1, S, M, L, P, 2, generator=g) * 4.0
    far = torch.rand(1, S, M, L, P, 2, generator=g) < 0.01
    off = torch.where(far, off * 100.0, off).to(dev)
    ref_px = (da.encoder_reference_points(shapes, dev)[None, :, None, None, None, :]
              * wh[None, None, None, :, None, :])
    off = off_grid(torch, ref_px + off - 0.5) + 0.5 - ref_px
    logits = torch.randn(1, S, M, L * P, generator=g).to(dev)
    dout4 = torch.randn(1, S, M * D, generator=g).to(dev)
    args4 = (value, shapes, off, logits, dout4)
    enc_loc = (ref_px + off) / wh[None, None, None, :, None, :]
    del ref_px

    cases = [
        (da.QUERIES_BWD, da.ms_deform_attn_queries_backward,
         da.ms_deform_attn_queries_plain_backward, args3, loc, Lq, ("value", "loc", "attn"),
         "gomatching_tpu/ops/deform_attn_dec_vmem.py:83", 30),
        (da.ENCODER_BWD, da.ms_deform_attn_encoder_backward,
         da.ms_deform_attn_encoder_plain_backward, args4, enc_loc, S,
         ("value", "offsets", "logits"), "gomatching_tpu/ops/deform_attn_vmem.py:473", 60),
    ]
    for name, kernel, plain, args, sample_loc, n_q, grad_names, replaces, ops_per_sample in cases:
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        errs = {n: rel_err(a, b) for n, a, b in zip(grad_names, got, want)}
        abs_err = max((a - b).abs().max().item() for a, b in zip(got, want))
        for n, e in errs.items():
            check(math.isfinite(e) and e <= RTOL_BWD, f"{name}: d{n} relative error {e}")
        bits_twice(torch, name, grad_names[1:], got, kernel(*args))
        ms = cuda_time_ms(lambda: kernel(*args))
        dev_us = device_us(torch, lambda: kernel(*args), f"{name}_kernel")
        plain_ms = cuda_time_ms(lambda: plain(*args), iters=5, warmup=1)
        v_bytes, taps = value_reads(torch, sample_loc, S, D, shapes)
        samples = n_q * M * L * P
        # bytes: touched value rows read once; dValue (zeroed first) and the other two
        # gradients written once; the per-sample inputs and dOut read once.
        # operations, the fewest the function needs: per in-range corner tap one dot
        # sum_d dOut[d] * v_corner[d] (2D) and the dValue scale-and-add (2D); per sample
        # attn * dOut (D) and the scalars (coordinates, corner weights, softmax), from
        # which the four corner dots give dAttn, dx and dy without further channel work
        b_ms, b_by = bound(v_bytes + nbytes(*args[2:], *got),
                           samples * (ops_per_sample + D) + taps * 4 * D)
        records[name] = dict(
            name=name, route="cuda", source="gomatching_tpu_torch/csrc/ms_deform_attn.cu",
            replaces=replaces, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
        )
        print(f"[6] {name}: max|kernel-plain|/max|plain| "
              + ", ".join(f"d{n} {e:.3e}" for n, e in errs.items())
              + f" (rtol {RTOL_BWD}); max abs {abs_err:.3e}; d{grad_names[1]} and "
              f"d{grad_names[2]} the same bits twice; kernel {ms:.4f} ms a call (device "
              f"{fmt_us(dev_us)}), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {v_bytes / 1e6:.1f} MB of value "
              f"rows touched of {nbytes(value) / 1e6:.1f} MB) at B=1, {n_q} queries")
        del got, want
    edge_queries_backward(torch, da)
    edge_encoder_backward(torch, da)
    return records


def bits_twice(torch, name, names, got, again):
    """B3's dLoc and dAttn, B4's dOffsets and dLogits, are summed in a fixed order: a second
    call gives the same bits (dValue's atomics may reorder its last bits)."""
    torch.cuda.synchronize()
    for n, a, b in zip(names, got[1:], again[1:]):
        check(torch.equal(a, b), f"{name}: d{n} differs on a second call")


def edge_queries_backward(torch, da):
    """B3 against its plain version at the EDGE_CASES shapes with EDGE_LQ queries,
    locations partly off the maps and off grid lines: max |kernel - plain| / max |plain|
    per gradient against RTOL_BWD, and dLoc and dAttn the same bits on a second call."""
    g = torch.Generator().manual_seed(10)
    for name, b, m, shapes, p in EDGE_CASES:
        S, L = sum(h * w for h, w in shapes), len(shapes)
        wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)[:, None, :]
        value = torch.randn(b, S, m, D, generator=g)
        loc = torch.rand(b, EDGE_LQ, m, L, p, 2, generator=g) * 1.3 - 0.15
        loc = (off_grid(torch, loc * wh - 0.5) + 0.5) / wh
        px = loc * wh - 0.5
        outside = ((px <= -1) | (px >= wh)).any(-1).float().mean().item()
        attn = torch.randn(b, EDGE_LQ, m, L * p, generator=g).softmax(-1).view(b, EDGE_LQ, m, L, p)
        dout = torch.randn(b, EDGE_LQ, m * D, generator=g)
        args = [t.cuda() for t in (value, loc, attn, dout)]
        args.insert(1, shapes)
        before = da.launch_counts[da.QUERIES_BWD]
        got = da.ms_deform_attn_queries_backward(*args)
        check(da.launch_counts[da.QUERIES_BWD] == before + 1, f"{da.QUERIES_BWD} {name}: no launch")
        want = da.ms_deform_attn_queries_plain_backward(*args)
        torch.cuda.synchronize()
        errs = {n: rel_err(a, w) for n, a, w in zip(("value", "loc", "attn"), got, want)}
        for n, e in errs.items():
            check(math.isfinite(e) and e <= RTOL_BWD, f"{da.QUERIES_BWD} {name}: d{n} relative "
                  f"error {e}")
        bits_twice(torch, f"{da.QUERIES_BWD} {name}", ("loc", "attn"), got,
                   da.ms_deform_attn_queries_backward(*args))
        print(f"[6] {da.QUERIES_BWD} at {name} (B={b}, M={m}, levels {shapes}, P={p}, "
              f"Lq={EDGE_LQ}): max|kernel-plain|/max|plain| "
              + ", ".join(f"d{n} {e:.3e}" for n, e in errs.items())
              + f" (rtol {RTOL_BWD}); dLoc and dAttn the same bits twice; "
              f"{100 * outside:.0f}% of samples wholly off the map")
    # the wrapper's guard on the card: D != 32 raises before any launch
    before = da.launch_counts[da.QUERIES_BWD]
    args = [torch.zeros(shape, device="cuda") for shape in
            ((1, 6, 2, 16), (1, 3, 2, 1, 2, 2), (1, 3, 2, 1, 2), (1, 3, 32))]
    try:
        da.ms_deform_attn_queries_backward(args[0], [(2, 3)], *args[1:])
        raised = ""
    except ValueError as e:
        raised = str(e)
    check("D == 32" in raised and da.launch_counts[da.QUERIES_BWD] == before,
          f"{da.QUERIES_BWD}: D = 16 on the card did not raise before the launch ({raised!r})")
    print(f"[6] {da.QUERIES_BWD} refuses D = 16 on the card before the launch: {raised}")


def edge_encoder_backward(torch, da):
    """B4 against its plain version at the EDGE_CASES shapes, offsets partly beyond the
    maps and off grid lines: max |kernel - plain| / max |plain| per gradient against
    RTOL_BWD, and dOffsets and dLogits the same bits on a second call."""
    g = torch.Generator().manual_seed(9)
    for name, b, m, shapes, p in EDGE_CASES:
        S, L = sum(h * w for h, w in shapes), len(shapes)
        wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)[None, None, None, :, None, :]
        value = torch.randn(b, S, m, D, generator=g)
        off = torch.randn(b, S, m, L, p, 2, generator=g) * 1.5
        far = torch.rand(b, S, m, L, p, 2, generator=g) < 0.1
        off = torch.where(far, off * 30.0, off)
        ref_px = da.encoder_reference_points(shapes)[None, :, None, None, None, :] * wh
        off = off_grid(torch, ref_px + off - 0.5) + 0.5 - ref_px
        px = ref_px + off - 0.5
        outside = ((px <= -1) | (px >= wh)).any(-1).float().mean().item()
        args = [t.cuda() for t in (value, off, torch.randn(b, S, m, L * p, generator=g),
                                   torch.randn(b, S, m * D, generator=g))]
        args.insert(1, shapes)
        before = da.launch_counts[da.ENCODER_BWD]
        got = da.ms_deform_attn_encoder_backward(*args)
        check(da.launch_counts[da.ENCODER_BWD] == before + 1, f"{da.ENCODER_BWD} {name}: no launch")
        want = da.ms_deform_attn_encoder_plain_backward(*args)
        torch.cuda.synchronize()
        errs = {n: rel_err(a, w) for n, a, w in zip(("value", "offsets", "logits"), got, want)}
        for n, e in errs.items():
            check(math.isfinite(e) and e <= RTOL_BWD, f"{da.ENCODER_BWD} {name}: d{n} relative "
                  f"error {e}")
        bits_twice(torch, f"{da.ENCODER_BWD} {name}", ("offsets", "logits"), got,
                   da.ms_deform_attn_encoder_backward(*args))
        print(f"[6] {da.ENCODER_BWD} at {name} (B={b}, M={m}, levels {shapes}, P={p}): "
              "max|kernel-plain|/max|plain| " + ", ".join(f"d{n} {e:.3e}" for n, e in errs.items())
              + f" (rtol {RTOL_BWD}); dOffsets and dLogits the same bits twice; "
              f"{100 * outside:.0f}% of samples wholly off the map")


def train_cfg(extra=()):
    from gomatching_tpu_torch.config import setup_train_cfg

    return setup_train_cfg(CONFIG, ["MODEL.WEIGHTS", "''", "SEED", "1", *extra])


def random_targets(rng, cfg, n_valid=20):
    t = cfg.MODEL.TRANSFORMER
    G, npts, voc = cfg.TPU.MAX_GT, t.NUM_POINTS, t.VOC_SIZE
    lengths = rng.randint(1, 11, (1, G, 1))
    return {
        "valid": np.arange(G)[None] < n_valid,
        "labels": np.zeros((1, G), np.int32),
        "ctrl_points": rng.rand(1, G, npts, 2).astype(np.float32),
        "bd_points": rng.rand(1, G, npts, 4).astype(np.float32),
        "texts": np.where(np.arange(25)[None, None] < lengths,
                          rng.randint(0, voc - 1, (1, G, 25)), voc).astype(np.int32),
        "beziers": rng.rand(1, G, 4, 2).astype(np.float32),
    }


def sample_cells(torch, da, kind, shapes, a):
    """Per level, the grid cell (floor x, floor y, as int32) of every sample and whether
    the sample is in range, computed in f64 from the sampler's input ``a``: normalized
    locations (decoder) or offsets in cells from each token's centre (encoder)."""
    a = a.double()
    if kind == "encoder":
        wh = torch.tensor([[w, h] for h, w in shapes], dtype=a.dtype, device=a.device)
        a = (da.encoder_reference_points(shapes, a.device).double()[None, :, None, None, None, :]
             + a / wh[None, None, None, :, None, :])
    cells = []
    for lvl, (h, w) in enumerate(shapes):
        x = a[:, :, :, lvl, :, 0] * w - 0.5
        y = a[:, :, :, lvl, :, 1] * h - 0.5
        inside = (x > -1) & (x < w) & (y > -1) & (y < h)
        cells.append((x.floor().int(), y.floor().int(), inside))
    return cells


def phase_train_step(torch, da):
    """One full-width pretraining step with the kernels, with the plain versions, and
    with the plain versions in float64; each backward kernel call of the kernel step
    against the plain backward in f32 and in f64 on the same inputs."""
    import gomatching_tpu_torch.models.spotter as spotter_mod
    from gomatching_tpu_torch.engine.pretrain import SpotterPretrainer
    from gomatching_tpu_torch.models.spotter import MSDeformAttn

    cfg = train_cfg()
    trainer = SpotterPretrainer(cfg, generator=torch.Generator().manual_seed(1))
    # the offset and attention projections start at zero kernels, which puts every
    # encoder sample exactly on a grid line, where the gradient is a subgradient either
    # side may take (not compared); small random kernels move them off
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for mod in trainer.model.modules():
            if isinstance(mod, MSDeformAttn):
                for lin, scale in ((mod.sampling_offsets, 0.05), (mod.attention_weights, 0.1)):
                    lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * scale)
    rng = np.random.RandomState(4)
    image = rng.randn(1, TRAIN_SIZE, TRAIN_SIZE, 3).astype(np.float32)
    imgs, tg = trainer.to_device(image, random_targets(rng, cfg))
    named = dict(trainer.model.named_parameters())
    spotter = trainer.model.detection_transformer
    # what each step's samplers saw (the cell of every sample, and the top-k proposals,
    # a sort that a near-tie could order another way), and every backward kernel call
    # of the kernel step with its inputs and outputs
    seen = {}
    bwd_calls = []

    def watch(tag, kind, fn):
        def sampler(value, shapes, a, b):
            seen[tag]["cells"].append((kind, sample_cells(torch, da, kind, shapes, a.detach())))
            return fn(value, shapes, a, b)
        return sampler

    def watch_bwd(kind, fn):
        def backward(*args):
            out = fn(*args)
            bwd_calls.append((kind, args, out))
            return out
        return backward

    def select(enc_class, enc_coords):
        seen[tag]["topk"] = torch.sort(enc_class, dim=1, descending=True,
                                       stable=True).indices[:, :spotter.num_queries]
        return type(spotter).select_proposals(spotter, enc_class, enc_coords)

    def grads():
        return {n: p.grad.detach().double().clone() for n, p in named.items()
                if p.grad is not None}

    saved = (spotter_mod.ms_deform_attn_encoder, spotter_mod.ms_deform_attn_queries,
             da.ms_deform_attn_encoder_backward, da.ms_deform_attn_queries_backward)
    spotter.select_proposals = select
    results = {}
    try:
        for tag in ("kernels", "plain", "f64"):
            seen[tag] = {"cells": []}
            kernels = tag == "kernels"
            spotter_mod.ms_deform_attn_encoder = watch(tag, "encoder", (
                saved[0] if kernels else da.ms_deform_attn_encoder_plain))
            spotter_mod.ms_deform_attn_queries = watch(tag, "decoder", (
                saved[1] if kernels else da.ms_deform_attn_queries_plain))
            da.ms_deform_attn_encoder_backward = (
                watch_bwd("encoder", saved[2]) if kernels else saved[2])
            da.ms_deform_attn_queries_backward = (
                watch_bwd("decoder", saved[3]) if kernels else saved[3])
            if tag == "kernels":
                da.reset_launch_counts()
                losses, matches = trainer.forward_backward(imgs, tg)
                counts = dict(da.launch_counts)
            elif tag == "plain":
                losses, matches = trainer.forward_backward(imgs, tg)
            else:
                # the same step in float64 at the kernel step's matches (the criterion
                # computes the losses in f32, as the JAX one does)
                model = trainer.model.double()
                tg64 = {k: v.double() if v.is_floating_point() else v for k, v in tg.items()}
                model.zero_grad(set_to_none=True)
                out = model(imgs.double())
                losses = trainer.criterion(out, tg64, num_inst=tg64["valid"].sum().float(),
                                           matches=results["kernels"][1])
                losses["total_loss"] = torch.stack(list(losses.values())).sum()
                losses["total_loss"].backward()
                matches, out = None, None
            results[tag] = ({k: v.item() for k, v in losses.items()}, matches, grads())
    finally:
        (spotter_mod.ms_deform_attn_encoder, spotter_mod.ms_deform_attn_queries,
         da.ms_deform_attn_encoder_backward, da.ms_deform_attn_queries_backward) = saved
        del spotter.select_proposals
    (lk, mk, gk), (lp, mp, gp), (l64, _, g64) = (results[t] for t in ("kernels", "plain", "f64"))

    t = cfg.MODEL.TRANSFORMER
    check(counts == {**{k: 0 for k in counts}, da.ENCODER: t.ENC_LAYERS, da.QUERIES: t.DEC_LAYERS,
                     da.ENCODER_BWD: t.ENC_LAYERS, da.QUERIES_BWD: t.DEC_LAYERS},
          f"train step launches {counts}")
    for k in mk:
        check(torch.equal(mk[k], mp[k]), f"train step: matches {k} differ")
    for tag in ("plain", "f64"):
        check(torch.equal(seen[tag]["topk"], seen["kernels"]["topk"]),
              f"train step: the {tag} step chose other top-k proposals")
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp)
    loss64 = {n: max(abs(ls[k] - l64[k]) / max(abs(l64[k]), 1e-12) for k in l64)
              for n, ls in (("kernels", lk), ("plain", lp))}
    check(set(gk) == set(gp) == set(g64), "train step: different parameters got gradients")
    print(f"[7] pretraining step, kernels vs plain: {len(mk)} matches and the top-"
          f"{spotter.num_queries} proposals identical; losses max rel err {loss_err:.3e} (rtol "
          f"{RTOL_LOSS}); vs the f64 step {loss64['kernels']:.3e} (kernels), "
          f"{loss64['plain']:.3e} (plain); total loss {lk['total_loss']:.4f}")

    # each backward kernel call on the step's own inputs, against the plain backward in
    # f32 and in f64: max |error| / max |f64 gradient|, the worst over the calls
    worst = {}
    for kind, args, got in bwd_calls:
        plain = (da.ms_deform_attn_encoder_plain_backward if kind == "encoder"
                 else da.ms_deform_attn_queries_plain_backward)
        names = ("value", "offsets", "logits") if kind == "encoder" else ("value", "loc", "attn")
        want32 = plain(*args)
        want64 = plain(*(a.double() if torch.is_tensor(a) else a for a in args))
        for name, k_, p_, e_ in zip(names, got, want32, want64):
            scale = e_.abs().max().clamp(min=1e-30)
            ek = ((k_.double() - e_).abs().max() / scale).item()
            ep = ((p_.double() - e_).abs().max() / scale).item()
            w = worst.setdefault((kind, name), [0.0, 0.0, 0.0])
            w[0], w[1] = max(w[0], ek), max(w[1], ep)
            w[2] = max(w[2], ek / max(F64_RATIO * ep, RTOL_BWD))
        del want32, want64
    print("[7]   backward kernel calls of the step vs f64 on their inputs (kernel; plain f32): "
          + "; ".join(f"{kind} d{name} {ek:.2e}; {ep:.2e}"
                      for (kind, name), (ek, ep, _) in worst.items()))
    for (kind, name), (ek, ep, r) in worst.items():
        check(r <= 1.0, f"train step: {kind} d{name} of a backward kernel call is {ek} off the "
              f"f64 gradient, the plain f32 backward {ep} (limit max({F64_RATIO} x plain, "
              f"{RTOL_BWD}))")
    del bwd_calls

    # samples that lie in another grid cell in the kernel step than in the plain step:
    # there the bilinear derivative of each takes another side of a grid line
    crossed = {"encoder": [0, 0], "decoder": [0, 0]}
    for (kind, ck), (_, cp) in zip(seen["kernels"]["cells"], seen["plain"]["cells"]):
        for (xk, yk, ik), (xp, yp, ip) in zip(ck, cp):
            crossed[kind][0] += xk.numel()
            crossed[kind][1] += int((((xk != xp) | (yk != yp)) & (ik | ip)).sum().item())
    print("[7]   samples in another grid cell in the kernel step than in the plain step: "
          + ", ".join(f"{kind} {c} of {n}" for kind, (n, c) in crossed.items()))

    def err(a, b, n, norm):
        if norm == "l2":
            return ((a[n] - b[n]).norm() / b[n].norm().clamp(min=1e-30)).item()
        return ((a[n] - b[n]).abs().max() / b[n].abs().max().clamp(min=1e-30)).item()

    def med(errs):
        return sorted(errs.values())[len(errs) // 2]

    l2 = {n: err(gk, gp, n, "l2") for n in gp}
    mx = {n: err(gk, gp, n, "max") for n in gp}
    for label, errs in (("|dg|_2/|g|_2 kernels vs plain", l2), ("max|dg|/max|g| kernels vs plain", mx),
                        ("max|dg|/max|g| kernels vs f64", {n: err(gk, g64, n, "max") for n in gp}),
                        ("max|dg|/max|g| plain vs f64", {n: err(gp, g64, n, "max") for n in gp})):
        top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
        print(f"[7]   {label}, worst: " + "; ".join(f"{n} {e:.3e}" for n, e in top)
              + f"; median {med(errs):.3e} ({len(errs)} parameters)")
    check(all(math.isfinite(v) for v in lk.values()) and loss_err <= RTOL_LOSS,
          f"train step: losses differ by {loss_err} (relative)")
    for errs, tol in ((l2, RTOL_GRAD), (mx, RTOL_GRAD_MAX)):
        name = max(errs, key=errs.get)
        check(errs[name] <= tol, f"train step: gradient of {name} differs by {errs[name]}")
    del trainer, model


def write_train_dataset(root, n_images=4):
    """n_images random 720x1280 images, each with 8 quadrilateral text boxes."""
    import cv2

    rng = np.random.RandomState(5)
    images, annotations = [], []
    for i in range(n_images):
        fn = f"{i}.jpg"
        cv2.imwrite(os.path.join(root, fn), rng.randint(0, 255, (720, 1280, 3), np.uint8))
        images.append({"id": i + 1, "file_name": fn, "height": 720, "width": 1280})
        for j in range(8):
            x0, y0 = rng.randint(40, 1000), rng.randint(40, 620)
            w, h = rng.randint(60, 240), rng.randint(20, 60)
            annotations.append({
                "id": len(annotations) + 1, "image_id": i + 1, "category_id": 1,
                "poly": [x0, y0, x0 + w, y0 + 3, x0 + w, y0 + h, x0, y0 + h - 3],
                "transcription": "".join(rng.choice(list("abcdefgh0123"), rng.randint(1, 9))),
            })
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "text"}]}, f)
    return root, path


def phase_train(torch, da):
    """The pretraining path through its entry point; returns its launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.data.datasets import register_dataset
    from gomatching_tpu_torch.engine.checkpoint import load_checkpoint
    from gomatching_tpu_torch.engine.pretrain import SpotterPretrainer
    from gomatching_tpu_torch.models.gomatching import build_pretrain_model
    from gomatching_tpu_torch.weights import init_state_dict, load_weights

    with tempfile.TemporaryDirectory() as tmp:
        register_dataset("chip_smoke_pretrain", *write_train_dataset(tmp))
        out_dir = os.path.join(tmp, "out")
        opts = ["DATASETS.TRAIN", "('chip_smoke_pretrain',)", "OUTPUT_DIR", out_dir,
                "INPUT.TRAIN_SIZE", str(TRAIN_SIZE), "SOLVER.CHECKPOINT_PERIOD",
                str(N_TRAIN_STEPS)]
        argv = ["--config-file", CONFIG, "--task", "spotter", "--max-iter", str(N_TRAIN_STEPS),
                "--opts", "MODEL.WEIGHTS", "''", "SEED", "1", *opts]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        da.reset_launch_counts()
        history = train_net.main(argv)
        torch.cuda.synchronize()
        counts = dict(da.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        cfg = train_cfg(opts)
        t = cfg.MODEL.TRANSFORMER
        check(len(history) == N_TRAIN_STEPS, f"{len(history)} steps ran")
        check(all(math.isfinite(h["total_loss"]) for h in history), "non-finite loss")
        layers = {da.ENCODER: t.ENC_LAYERS, da.QUERIES: t.DEC_LAYERS,
                  da.ENCODER_BWD: t.ENC_LAYERS, da.QUERIES_BWD: t.DEC_LAYERS}
        for name in counts:  # B5 and its table: never, whatever SAMPLING_IMPL says
            want = layers.get(name, 0) * N_TRAIN_STEPS
            check(counts[name] == want, f"{name}: {counts[name]} launches, expected {want}")
        ckpt = os.path.join(out_dir, "checkpoints", f"spotter_{N_TRAIN_STEPS:07d}.pth")
        sd = load_checkpoint(ckpt)
        load_weights(build_pretrain_model(cfg), sd)
        init = init_state_dict(cfg, torch.Generator().manual_seed(1), pretrain=True)
        moved = sum(not torch.equal(sd[k], init[k]) for k in init)
        check(moved > 0 and set(sd) == set(init), f"{moved} of {len(init)} tensors moved")
        # the whole iteration: image read, augmentation, resize, targets and the step
        steps = sorted(h["step_s"] * 1e3 for h in history[N_TRAIN_WARMUP:])
        med = steps[len(steps) // 2]
        data = sorted(h["data_s"] * 1e3 for h in history[N_TRAIN_WARMUP:])
        print(f"[8] pretraining CLI: {N_TRAIN_STEPS} steps at {TRAIN_SIZE}x{TRAIN_SIZE}, "
              f"losses {history[0]['total_loss']:.4f} -> {history[-1]['total_loss']:.4f}; "
              f"checkpoint loads back strict, {moved} of {len(init)} tensors moved; "
              f"launches {counts}")
        print(f"[8] steps {N_TRAIN_WARMUP + 1}-{N_TRAIN_STEPS}: median {med:.1f} ms/step "
              f"(min {steps[0]:.1f}, max {steps[-1]:.1f}) from image read to optimizer step, "
              f"{1e3 / med:.3f} images/s; of it the data stage (read, augment, resize, "
              f"targets) median {data[len(data) // 2]:.1f} ms; peak memory "
              f"{peak / 2**30:.2f} GiB")

    # host wall per stage, synchronizing at the stage boundaries, and one step under the
    # profiler: a fresh trainer on one seeded batch
    trainer = SpotterPretrainer(cfg)
    rng = np.random.RandomState(6)
    image = rng.randn(1, TRAIN_SIZE, TRAIN_SIZE, 3).astype(np.float32)
    targets = random_targets(rng, cfg)
    for _ in range(2):
        trainer.step(image, targets)  # warm-up
    trainer.stage_times = {}
    for _ in range(3):
        trainer.step(image, targets)
    st = trainer.stage_times
    total = sum(st.values())
    print("[8] host wall per step by stage (synchronized; ms): " + ", ".join(
        f"{k} {v / 3 * 1e3:.1f}" for k, v in st.items())
        + f"; costs + hungarian {100 * (st['costs'] + st['hungarian']) / total:.1f}% of the "
        "step")
    trainer.stage_times = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.step(image, targets)
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = device_rows(torch, prof)
    if not rows:
        print("[8] profiler: no device time recorded (not measured)")
        return counts
    busy = sum(r[0] for r in rows) / 1e3
    print(f"[8] profiled step: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f}% of wall; profiler on) in "
          f"{sum(r[1] for r in rows)} kernels and copies")
    for t_us, n, key in rows[:15]:
        print(f"[8]   {t_us / 1e3:9.3f} ms {100 * t_us / 1e3 / busy:5.1f}% x{n:<5d} {key[:90]}")
    for label, prefix in (("B3", "ms_deform_attn_queries_bwd_kernel("),
                          ("B4", "ms_deform_attn_encoder_bwd_kernel(")):
        us = sum(t_us for t_us, _, key in rows if key.startswith(prefix))
        n = sum(c for _, c, key in rows if key.startswith(prefix))
        print(f"[8]   {label} ({prefix[:-1]}): {us / 1e3:.3f} ms of device time in the step, "
              f"{n} launches, {100 * us / 1e3 / busy:.2f}% of the step's device time")
    return counts


def write_tracker_dataset(root, n_videos=2, n_frames=TRACK_VIDEO_FRAMES):
    """``n_videos`` synthetic videos of ``n_frames`` 720x1280 frames, each with 8 tracked
    text instances drifting a few pixels a frame over a panning background, and one still
    image with 8 instances (a GEN_IMAGE_MOTION clip), COCO-style with video and instance
    ids."""
    import cv2

    rng = np.random.RandomState(7)
    images, annotations = [], []

    def add(img_id, x0, y0, w, h, inst):
        annotations.append({
            "id": len(annotations) + 1, "image_id": img_id, "category_id": 1,
            "bbox": [x0, y0, w, h], "poly": [x0, y0, x0 + w, y0 + 2, x0 + w, y0 + h, x0, y0 + h - 2],
            "transcription": "".join(rng.choice(list("abcdefgh0123"), rng.randint(1, 9))),
            "instance_id": inst})

    for v in range(n_videos):
        base = rng.randint(0, 255, (720, 1280, 3)).astype(np.uint8)
        boxes = [(rng.randint(60, 900), rng.randint(60, 560), rng.randint(80, 240),
                  rng.randint(24, 60), rng.randint(-6, 7), rng.randint(-3, 4)) for _ in range(8)]
        for f in range(n_frames):
            img_id = 1000 * (v + 1) + f
            fn = f"v{v}_{f}.jpg"
            cv2.imwrite(os.path.join(root, fn), np.roll(base, 4 * f, axis=1))
            images.append({"id": img_id, "file_name": fn, "height": 720, "width": 1280,
                           "video_id": v + 1})
            for k, (x0, y0, w, h, dx, dy) in enumerate(boxes):
                add(img_id, x0 + dx * f, y0 + dy * f, w, h, 100 * (v + 1) + k)
    cv2.imwrite(os.path.join(root, "still.jpg"), rng.randint(0, 255, (720, 1280, 3), np.uint8))
    images.append({"id": 1, "file_name": "still.jpg", "height": 720, "width": 1280})
    for k in range(8):
        add(1, rng.randint(60, 900), rng.randint(60, 560), rng.randint(80, 240),
            rng.randint(24, 60), 900 + k)
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "text"}]}, f)
    return root, path


def tracker_argv(config, out_dir, steps, extra=()):
    return ["--config-file", config, "--task", "tracker", "--max-iter", str(steps), "--opts",
            "MODEL.WEIGHTS", "''", "SEED", "1", "DATASETS.TRAIN", "('chip_smoke_tracker',)",
            "OUTPUT_DIR", out_dir, "SOLVER.CHECKPOINT_PERIOD", str(steps),
            "MODEL.TRANSFORMER.INFERENCE_TH_TRAIN", str(TRACK_THRESH),
            "MODEL.ASSO_HEAD.ASSO_THRESH", str(TRACK_THRESH), *extra]


def phase_tracker(torch, da, tmp):
    """The tracker-training path through its entry point at full width (phase 16), on the
    dataset ``chip_smoke_tracker``, writing under ``tmp``; returns the profiled step's
    record (``phase_tracker_step``)."""
    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.engine.checkpoint import latest_train_state, load_checkpoint
    from gomatching_tpu_torch.models.gomatching import build_model
    from gomatching_tpu_torch.weights import init_state_dict, load_weights

    out_dir = os.path.join(tmp, "out")
    argv = tracker_argv(CONFIG, out_dir, N_TRACK_STEPS)
    cfg = setup_train_cfg(CONFIG, argv[argv.index("--opts") + 1:])
    t = cfg.MODEL.TRANSFORMER
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    da.reset_launch_counts()
    history = train_net.main(argv)
    torch.cuda.synchronize()
    counts = dict(da.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    check(len(history) == N_TRACK_STEPS, f"phase 16: {len(history)} steps ran")
    for i, h in enumerate(history):
        check(all(math.isfinite(h[k]) for k in ("loss_res", "loss_long_asso",
                                                 "loss_short_asso", "total_loss")),
              f"phase 16: non-finite loss at step {i + 1}: {h}")
        check(h["proposals"] > 0 and h["matched"] > 0,
              f"phase 16: step {i + 1} has {h['proposals']} proposals, {h['matched']} "
              "matched to a GT track")
    # the masked encoder and the decoder sample through B1, once per layer per clip
    want = {name: 0 for name in counts}
    want[da.QUERIES] = (t.ENC_LAYERS + t.DEC_LAYERS) * N_TRACK_STEPS
    check(counts == want, f"phase 16: launches {counts}, expected {want}")
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    sd = load_checkpoint(os.path.join(ckpt_dir, f"model_{N_TRACK_STEPS:07d}_rescore.pth"))
    load_weights(build_model(cfg), sd)
    check(latest_train_state(ckpt_dir)[1] == N_TRACK_STEPS, "phase 16: no train state")
    init = train_net.init_rescoring_from_classifier(
        init_state_dict(cfg, torch.Generator().manual_seed(1)))
    moved = {k for k in init if not torch.equal(sd[k], init[k])}
    check(set(sd) == set(init) and moved and all(k.startswith("roi_heads.") for k in moved),
          f"phase 16: {len(moved)} tensors moved, outside roi_heads: "
          f"{sorted(k for k in moved if not k.startswith('roi_heads.'))[:5]}")
    with open(os.path.join(out_dir, "metrics.json")) as f:
        check(json.loads(f.read().splitlines()[-1])["iteration"] == N_TRACK_STEPS,
              "phase 16: metrics.json")
    after = history[N_TRACK_WARMUP:]

    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    print(f"[16] tracker-training CLI ({CONFIG}, seeded random weights, both thresholds "
          f"{TRACK_THRESH}): {N_TRACK_STEPS} iterations, losses "
          f"{history[0]['total_loss']:.4f} -> {history[-1]['total_loss']:.4f}; proposals "
          f"per clip {[h['proposals'] for h in history]}, matched to tracks "
          f"{[h['matched'] for h in history]}; checkpoint loads back strict, "
          f"{len(moved)} tensors moved, all roi_heads; launches {counts}")
    print(f"[16] frames per clip {[h['frames'] for h in history]}, canvases "
          f"{[h['image_hw'] for h in history]}")
    print(f"[16] iterations {N_TRACK_WARMUP + 1}-{N_TRACK_STEPS}: median "
          f"{med(h['step_s'] for h in after) * 1e3:.1f} ms/iter (min "
          f"{min(h['step_s'] for h in after) * 1e3:.1f}, max "
          f"{max(h['step_s'] for h in after) * 1e3:.1f}) from taking the clip to the losses "
          f"after the optimizer step; data stage median {med(h['data_s'] for h in after) * 1e3:.1f}"
          f" ms; by stage (median ms) spot {med(h['phase_t']['spot'] for h in after) * 1e3:.1f}, "
          f"host {med(h['phase_t']['host'] for h in after) * 1e3:.1f}, update "
          f"{med(h['phase_t']['update'] for h in after) * 1e3:.1f}; "
          f"{sum(h['frames'] for h in after) / sum(h['step_s'] for h in after):.3f} frames/s; "
          f"peak memory {peak / 2**30:.2f} GiB")

    # TPU.TRAIN_UPLOAD_UINT8 False: host-normalized frames and, as in JAX, no sizes, so
    # no masks: the encoder takes B2 and the decoder B1
    da.reset_launch_counts()
    history_f32 = train_net.main(tracker_argv(CONFIG, os.path.join(tmp, "out_f32"), 1,
                                              ["TPU.TRAIN_UPLOAD_UINT8", "False"]))
    counts_f32 = dict(da.launch_counts)
    want = {**{name: 0 for name in counts_f32}, da.ENCODER: t.ENC_LAYERS,
            da.QUERIES: t.DEC_LAYERS}
    check(counts_f32 == want and math.isfinite(history_f32[0]["total_loss"]),
          f"phase 16: TRAIN_UPLOAD_UINT8 False launches {counts_f32}, expected {want}")
    print(f"[16] TPU.TRAIN_UPLOAD_UINT8 False (no masks): 1 iteration, loss "
          f"{history_f32[0]['total_loss']:.4f}, B2 {counts_f32[da.ENCODER]} and B1 "
          f"{counts_f32[da.QUERIES]} launches")

    # GoMatching++ (the shared matcher) through the same entry point
    history_pp = train_net.main(tracker_argv(CONFIG_PP, os.path.join(tmp, "out_pp"), 2))
    check(len(history_pp) == 2 and all(math.isfinite(h["total_loss"]) for h in history_pp),
          f"phase 16: GoMatching++ losses {[h['total_loss'] for h in history_pp]}")
    print(f"[16] GoMatching++ ({CONFIG_PP}): 2 iterations, losses "
          f"{[round(h['total_loss'], 4) for h in history_pp]}, "
          f"{[h['step_s'] * 1e3 for h in history_pp]} ms")
    return phase_tracker_step(torch, da, setup_train_cfg(
        CONFIG, argv[argv.index("--opts") + 1:] + ["SEED", str(TRACK_AB_SEED)]))


def phase_tracker_step(torch, da, cfg):
    """One tracker step with the kernels against the same step with the plain samplers,
    one step under the profiler, and a 12-frame 1280x1280 spot's peak memory."""
    import gomatching_tpu_torch.models.spotter as spotter_mod
    from torch.profiler import ProfilerActivity, profile

    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.data.loader import build_train_loader
    from gomatching_tpu_torch.engine.train import Trainer
    from gomatching_tpu_torch.weights import init_state_dict

    sd = train_net.init_rescoring_from_classifier(
        init_state_dict(cfg, torch.Generator().manual_seed(cfg.SEED)))
    sample = next(iter(build_train_loader(cfg)))
    images, frame_hw = train_net.normalize_clip(sample, cfg.MODEL.PIXEL_MEAN,
                                                cfg.MODEL.PIXEL_STD, raw=True)
    targets = train_net.targets_from_sample(sample)
    trainers = {"kernels": Trainer(cfg, sd), "plain": Trainer(cfg, sd)}
    saved = spotter_mod.ms_deform_attn_queries, spotter_mod.ms_deform_attn_encoder
    runs, topk, moments = {}, {}, {}

    def watch(tag, spotter):
        def select(enc_class, enc_coords):
            topk[tag] = torch.sort(enc_class, dim=1, descending=True,
                                   stable=True).indices[:, :spotter.num_queries]
            return type(spotter).select_proposals(spotter, enc_class, enc_coords)
        spotter.select_proposals = select

    try:
        for tag, tr in trainers.items():
            watch(tag, tr.model.detection_transformer)
            if tag == "plain":
                spotter_mod.ms_deform_attn_queries = da.ms_deform_attn_queries_plain
                spotter_mod.ms_deform_attn_encoder = da.ms_deform_attn_encoder_plain
            da.reset_launch_counts()
            spot = tr.spot(images, frame_hw)
            host = tr.host_fields(spot)
            if tag == "kernels":
                counts = dict(da.launch_counts)
                # both thresholds in the widest gap of the middle fused scores, so that the
                # steps' last-bit differences cannot move a proposal across them
                sig = lambda x: 1 / (1 + np.exp(-x.mean(2)[..., 0]))
                fused = np.sort(np.maximum(sig(host["pred_logits"]),
                                           sig(host["re_pred_logits"])).ravel())
                lo, hi = len(fused) * 3 // 10, len(fused) * 7 // 10
                i = lo + int(np.argmax(np.diff(fused[lo:hi + 1])))
                th, gap = float(fused[i] + fused[i + 1]) / 2, float(fused[i + 1] - fused[i])
            tr.train_thresh = tr.asso_thresh = th
            batch = tr.prepare_batch(host, targets)
            metrics = tr.update(batch, spot["query_features"])
            named = dict(tr.model.roi_heads.named_parameters())
            moments[tag] = {k: tr.optimizer.state[p]["exp_avg"].double().clone()
                            for k, p in named.items()}
            runs[tag] = (batch, metrics,
                         {k: v.detach().double().clone()
                          for k, v in tr.model.roi_heads.state_dict().items()},
                         {k: v.detach().double().clone() for k, v in spot.items()
                          if torch.is_tensor(v)})
    finally:
        spotter_mod.ms_deform_attn_queries, spotter_mod.ms_deform_attn_encoder = saved
    t = cfg.MODEL.TRANSFORMER
    check(counts == {**{k: 0 for k in counts}, da.QUERIES: t.ENC_LAYERS + t.DEC_LAYERS},
          f"phase 16 step: launches {counts}")
    (bk, mk, pk, sk), (bp, mp, pp, sp) = runs["kernels"], runs["plain"]
    spot_err = max((sk[k] - sp[k]).abs().max().item() for k in sp)
    print(f"[16] tracker step (SEED {cfg.SEED}), kernels vs plain samplers: top-k proposals "
          f"{'identical' if torch.equal(topk['kernels'], topk['plain']) else 'DIFFERENT'}; "
          f"spot outputs max |diff| {spot_err:.3e}")
    check(torch.equal(topk["kernels"], topk["plain"]),
          "phase 16 step: the plain step chose other top-k proposals")
    for k in bp:
        same = (np.allclose(bk[k], bp[k], rtol=0, atol=ATOL_PATH) if k == "prop_boxes"
                else np.array_equal(bk[k], bp[k]))
        check(same, f"phase 16 step: {k} differs between the kernel and the plain step")
    loss_err = max(abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in mp)
    init = {k: v.double() for k, v in sd.items() if k.startswith("roi_heads.")}
    moved = sum(not torch.equal(pp[k], init["roi_heads." + k].to(pp[k])) for k in pp)
    # AdamW's first moment after one step is 0.1 x the clipped gradient
    grad_err = {k: ((moments["kernels"][k] - m).norm() / m.norm().clamp(min=1e-30)).item()
                for k, m in moments["plain"].items()}
    worst = max(grad_err, key=grad_err.get)
    # the updated head, per tensor against its largest weight (and the step's LR for
    # tensors that start at zero). AdamW's first step moves an entry by lr * g / (|g| +
    # eps), eps 1e-8: where the clipped gradient |g| (10 x the first moment) is below
    # 100 eps, the update turns on g's size and not only its sign, and a gradient that is
    # zero up to rounding (an attention key bias's) takes either sign; those entries are
    # left out. (At the warm-up LR an update is below the float32 spacing of most
    # weights, which rounding moves by one spacing or not at all; the largest update is
    # printed in units of the LR.)
    lr = float(cfg.SOLVER.BASE_LR) * float(cfg.SOLVER.WARMUP_FACTOR)
    param_err, step_max = {}, 0.0
    for k in pp:
        noise = 10 * moments["plain"][k].abs() < 100 * ADAMW_EPS
        scale = max(pp[k].abs().max().item(), lr)
        param_err[k] = ((pk[k] - pp[k]).abs()[~noise].max().item() / scale
                        if (~noise).any() else 0.0)
        step_max = max(step_max,
                       (pk[k] - init["roi_heads." + k].to(pk[k])).abs().max().item() / lr)
    worst_p = max(param_err, key=param_err.get)
    param_err = param_err[worst_p]
    print(f"[16] tracker step on one clip ({len(images)} frames, canvas {images.shape[1:3]}), "
          f"kernels vs plain samplers: proposals "
          f"({int(bk['prop_valid'].sum())} of {bk['prop_valid'].size} at threshold {th:.6f}, in a "
          f"gap of {gap:.2e} between fused scores), rescore matches "
          f"({int(bk['res_match_mask'].sum())}) and association targets "
          f"({int((bk['match_cues'] >= 0).sum())} matched slots) identical; losses max rel err "
          f"{loss_err:.3e} (rtol {RTOL_LOSS}); updated roi_heads max rel err {param_err:.3e} "
          f"({worst_p}; rtol {RTOL_LOSS}, {moved} of {len(pp)} tensors moved, the largest "
          f"update {step_max:.3f} x the LR); clipped gradients (AdamW's "
          f"first moments) |dg|_2/|g|_2 worst {grad_err[worst]:.3e} ({worst}), median "
          f"{sorted(grad_err.values())[len(grad_err) // 2]:.3e}; launches {counts}")
    check(loss_err <= RTOL_LOSS, f"phase 16 step: losses differ by {loss_err}")
    check(param_err <= RTOL_LOSS, f"phase 16 step: roi_heads differ by {param_err} ({worst_p})")
    check(bk["prop_valid"].any() and (bk["match_cues"] >= 0).any(),
          "phase 16 step: no proposals or no matched tracks")

    # one step under the profiler (the kernel trainer, warm)
    tr = trainers["kernels"]
    del trainers["plain"]
    tr.step(images, frame_hw, targets)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        tr.step(images, frame_hw, targets)
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = device_rows(torch, prof)
    step_rec = {"frames": len(images), "wall_ms": wall * 1e3, "busy_ms": None,
                "spot_ms": tr.phase_t["spot"] * 1e3}
    if not rows:
        print("[16] profiler: no device time recorded (not measured)")
    else:
        busy = sum(r[0] for r in rows) / 1e3
        print(f"[16] profiled tracker step ({len(images)} frames): wall {wall * 1e3:.1f} ms, device "
              f"busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of wall; profiler on) in "
              f"{sum(r[1] for r in rows)} kernels and copies; phases (ms) "
              + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in tr.phase_t.items()))
        for t_us, n, key in rows[:12]:
            print(f"[16]   {t_us / 1e3:9.3f} ms {100 * t_us / 1e3 / busy:5.1f}% x{n:<5d} {key[:90]}")
        prefix = "ms_deform_attn_queries_kernel("
        us = sum(t_us for t_us, _, key in rows if key.startswith(prefix))
        n = sum(c for _, c, key in rows if key.startswith(prefix))
        print(f"[16]   B1 ({prefix[:-1]}): {us / 1e3:.3f} ms of device time in the step, {n} "
              f"launches, {100 * us / 1e3 / busy:.2f}% of the step's device time")
        step_rec["busy_ms"] = busy

    # the largest spot a clip can ask for: 2 * TRAIN_LEN frames on a full 1280x1280 canvas
    n = 2 * cfg.INPUT.VIDEO.TRAIN_LEN
    big = np.random.RandomState(8).randint(0, 255, (n, TRAIN_SIZE, TRAIN_SIZE, 3)).astype(np.uint8)
    hw = np.tile(np.asarray([[TRAIN_SIZE - 96, TRAIN_SIZE]], np.float32), (n, 1))
    del prof
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    da.reset_launch_counts()
    t0 = time.time()
    out = tr.spot(big, hw)
    q = out["query_features"]
    check(bool(torch.isfinite(q).all()), "phase 16: 12-frame spot not finite")
    torch.cuda.synchronize()
    print(f"[16] {n}-frame {TRAIN_SIZE}x{TRAIN_SIZE} spot (the last 96 rows padding): "
          f"{(time.time() - t0) * 1e3:.1f} ms with its first call's costs, B1 launches "
          f"{da.launch_counts[da.QUERIES]}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB ({(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} above the model's)")
    check(da.launch_counts[da.QUERIES] == t.ENC_LAYERS + t.DEC_LAYERS, "phase 16: 12-frame spot")
    del out, q, tr, trainers
    return step_rec


# ---------------------------------------------------------------------------
# phases 17-19: the production precision path (bf16 spotter and matcher, I420 wire)
# ---------------------------------------------------------------------------

PROD_OPTS = ["MODEL.PRECISION", "bfloat16", "TPU.UPLOAD_FORMAT", "yuv420"]
TRAIN_PROD_OPTS = ["MODEL.PRECISION", "bfloat16", "TPU.TRAIN_UPLOAD_FORMAT", "yuv420"]
N_PROD_TRACK_STEPS = N_TRACK_STEPS  # phase 19's iterations: phase 16's clips, in bf16
# phase 18: kernels vs plain bf16 samplers through the full-depth bf16 spotter, each output
# within PATH_ULPS bf16 ulps of its largest magnitude. Each of the 12 sampler calls may
# round its output one ulp the other way (phase 17); the encoder memory, the logits and the
# text logits stay within 2 ulps, but the control points refine their own sampling
# locations six times over (ref = sigmoid(delta + inverse_sigmoid(ref)), layer after
# layer), as do the boundary points: 2.70 and 3.62 ulps of their max on an NVIDIA H100 80GB
# HBM3, 700 W
PATH_ULPS = 4
# the device-time classes of phase 18's profile, by kernel name; the first match wins
# (cuDNN's layout transforms around a convolution count as convolution)
KERNEL_CLASSES = [
    ("B1 bf16", lambda k: k.startswith("ms_deform_attn_queries_bf16_kernel(")),
    ("B2 bf16", lambda k: k.startswith("ms_deform_attn_encoder_bf16_kernel(")),
    ("other samplers", lambda k: k.startswith("ms_deform_attn_")),
    ("convolutions", lambda k: any(w in k.lower() for w in (
        "conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "nchwtonhwc", "nhwctonchw"))),
    ("GEMMs", lambda k: any(w in k.lower() for w in ("gemm", "gemv", "cutlass", "nvjet", "xmma"))),
    ("copies", lambda k: k.startswith(("Memcpy", "Memset"))),
    ("elementwise", lambda k: "elementwise" in k),
    ("other (norms, reductions, softmax, sort, gather)", lambda k: True),
]


def bf16_ulp(torch, x):
    """bf16's spacing at |x|, elementwise: 2**(floor(log2 |x|) - 7) (2**-133 at 0)."""
    _, e = torch.frexp(x.float())  # x = m 2**e, 0.5 <= |m| < 1
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, torch.full_like(ulp, 2.0**-133), ulp)


def ulps_apart(torch, got, want):
    """|got - want| in bf16 ulps of the larger magnitude, elementwise (float32)."""
    g, w = got.float(), want.float()
    return (g - w).abs() / bf16_ulp(torch, torch.maximum(g.abs(), w.abs()))


def launch_us(torch, fn, marker, n=20):
    """(device us per launch, launches recorded) of the kernels whose name contains
    ``marker`` over ``n`` calls of ``fn`` under torch.profiler: per launch the profiler
    recorded, so a launch it misses does not lower the time; (None, 0) without device time."""
    rows = marker_rows(torch, fn, marker, n)
    count = sum(c for _, c, _ in rows)
    return (sum(t for t, _, _ in rows) / count if count else None), count


def class_shares(rows):
    """{class: (device us, launches)} of ``device_rows`` by KERNEL_CLASSES."""
    out = {name: [0.0, 0] for name, _ in KERNEL_CLASSES}
    for t_us, n, key in rows:
        name = next(c for c, match in KERNEL_CLASSES if match(key))
        out[name][0] += t_us
        out[name][1] += n
    return out


def check_one_ulp(torch, what, got, want):
    """Every element of a bf16 kernel's output within one bf16 ulp of its plain version's,
    or within ATOL_KERNEL where the value is so near 0 that its ulp is below the f32 sums'
    own reordering noise (the f32 kernels' bound against plain). Returns (max |diff|,
    elements that differ, elements more than an ulp apart, the largest |diff| of those)."""
    ulps = ulps_apart(torch, got, want)
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    n_diff = int((got != want).sum().item())
    n_over = int((ulps > 1).sum().item())
    near0 = diff[ulps > 1].max().item() if n_over else 0.0
    worst = ulps[diff > ATOL_KERNEL].max().item() if (diff > ATOL_KERNEL).any() else 0.0
    check(got.dtype == want.dtype == torch.bfloat16, f"{what}: {got.dtype} against {want.dtype}")
    check(math.isfinite(err) and bool(((ulps <= 1) | (diff <= ATOL_KERNEL)).all()),
          f"{what}: {worst} bf16 ulps from plain where |diff| > {ATOL_KERNEL}")
    return err, n_diff, n_over, near0


def phase_bf16_kernels(torch, da):
    """Phase 17: B1 and B2 on bf16 value against their plain bf16 versions at the main
    path's shapes, every element within one bf16 ulp; times beside the f32 kernels' on the
    same values, in turns; registers and local memory; byte bounds. Returns the kernels-line
    records (sans launches)."""
    S = sum(h * w for h, w in SHAPES)
    g = torch.Generator().manual_seed(17)
    dev = "cuda"
    value32 = torch.randn(B, S, M, D, generator=g).bfloat16().float().to(dev)
    value = value32.bfloat16()
    info = da.kernel_info()
    wh = torch.tensor([[w, h] for h, w in SHAPES], dtype=torch.float32, device=dev)
    cases = []
    for label, Lq in (("decoder", NQ * NPTS), ("encoder", S)):
        loc = (torch.rand(B, Lq, M, L, P, 2, generator=g) * 1.2 - 0.1).to(dev)
        attn = torch.randn(B, Lq, M, L * P, generator=g).softmax(-1).view(B, Lq, M, L, P).to(dev)
        cases.append((da.QUERIES_BF16, da.QUERIES, label, loc, (loc, attn), 20,
                      lambda v, a=loc, b=attn: da.ms_deform_attn_queries(v, SHAPES, a, b),
                      lambda v, a=loc, b=attn: da.ms_deform_attn_queries_plain_bf16(v, SHAPES, a, b)))
    off = torch.randn(B, S, M, L, P, 2, generator=g) * 4.0
    far = torch.rand(B, S, M, L, P, 2, generator=g) < 0.01
    off = torch.where(far, off * 100.0, off).to(dev)
    logits = torch.randn(B, S, M, L * P, generator=g).to(dev)
    enc_loc = (da.encoder_reference_points(SHAPES, dev)[None, :, None, None, None, :]
               + off / wh[None, None, None, :, None, :])
    cases.append((da.ENCODER_BF16, da.ENCODER, "encoder", enc_loc, (off, logits), 27,
                  lambda v: da.ms_deform_attn_encoder(v, SHAPES, off, logits),
                  lambda v: da.ms_deform_attn_encoder_plain_bf16(v, SHAPES, off, logits)))
    records = {}
    for name, name32, label, loc, small, per_sample, call, plain in cases:
        before = da.launch_counts[name]
        got = call(value)
        check(got.dtype == torch.bfloat16 and da.launch_counts[name] == before + 1,
              f"{name} {label}: not launched in bf16")
        want = plain(value)
        torch.cuda.synchronize()
        err, n_diff, n_over, near0 = check_one_ulp(torch, f"{name} {label}", got, want)
        same_bits(torch, name, lambda: call(value), got)
        # in turns with the f32 kernel on the same values: f32, bf16, bf16, f32
        t32a = cuda_time_ms(lambda: call(value32))
        t16a = cuda_time_ms(lambda: call(value))
        t16b = cuda_time_ms(lambda: call(value))
        t32b = cuda_time_ms(lambda: call(value32))
        marker = name + "_kernel("
        dev16, n16 = launch_us(torch, lambda: call(value), marker)
        dev32, n32 = launch_us(torch, lambda: call(value32), name32 + "_kernel(")
        plain_ms = cuda_time_ms(lambda: plain(value), iters=5, warmup=1)
        v_bytes, taps = value_reads(torch, loc, S, D, elem_bytes=2)
        samples = loc.shape[0] * loc.shape[1] * M * L * P
        b_ms, b_by = bound(v_bytes + nbytes(*small, got),
                           samples * (per_sample + 2 * D) + taps * (2 * D + 1))
        v32_bytes, _ = value_reads(torch, loc, S, D)
        b32_ms, _ = bound(v32_bytes + nbytes(*small, got.float()),
                          samples * (per_sample + 2 * D) + taps * (2 * D + 1))
        ms = (t16a + t16b) / 2
        print(f"[17] {name} at the {label} shape (value ({B}, {S}, {M}, {D}) bf16, Lq "
              f"{loc.shape[1]}): within one bf16 ulp of plain ({n_diff} of {got.numel()} "
              f"elements differ, max |diff| {err:.3e}; {n_over} elements more than an ulp apart, "
              f"all within {near0:.2e} <= ATOL_KERNEL of plain), same bits twice; kernel "
              f"{t16a:.4f} / {t16b:.4f} ms a call (device {fmt_us(dev16)} a launch over {n16} "
              f"recorded) against f32's {t32a:.4f} / {t32b:.4f} ms (device {fmt_us(dev32)} over "
              f"{n32}) on the same values in turns; "
              f"plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: {v_bytes / 1e6:.1f} MB of bf16 "
              f"value rows touched) against f32's {b32_ms:.4f} ms; {info[name]['registers']} "
              f"registers, {info[name]['local_bytes']} bytes of local memory a thread")
        if label == "decoder" or name == da.ENCODER_BF16:
            src = ("gomatching_tpu/ops/deform_attn_dec_vmem.py:208" if name == da.QUERIES_BF16
                   else "gomatching_tpu/ops/deform_attn_vmem.py:428")
            records[name] = dict(
                name=name, route="cuda", source="gomatching_tpu_torch/csrc/ms_deform_attn.cu",
                replaces=src, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
    return records


def production_frames(torch, predictor):
    """The first spot batch of the synthetic clip as ``spot_batch_packed`` feeds the model:
    the I420 wire decoded and preprocessed on the card."""
    from gomatching_tpu_torch.data.preprocess import (compute_test_size, decode_i420,
                                                      device_preprocess)

    cfg = predictor.cfg
    frames = np.stack(synthetic_frames()[:predictor.spot_batch])
    wire = predictor.encode_frames(frames)
    check(wire.ndim == 3, "phase 18: the frames did not go as I420")
    hw = compute_test_size(*frames.shape[1:3], cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
    raw = decode_i420(torch.from_numpy(wire).cuda())
    return device_preprocess(raw, hw, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, cfg.INPUT.FORMAT)


def plain_bf16_samplers(da):
    """The bf16 spotter's samplers replaced by their plain bf16 versions, for the block."""
    import gomatching_tpu_torch.models.spotter as spotter_mod

    return patched(spotter_mod, ms_deform_attn_encoder=da.ms_deform_attn_encoder_plain_bf16,
                   ms_deform_attn_queries=da.ms_deform_attn_queries_plain_bf16)


def bf16_spot_vs_plain(torch, predictor, da, plain_samplers=None, tag="[18]"):
    """Phase 18 (and 21): one spot batch through the bf16 spotter with the kernels and with
    the plain bf16 samplers (``plain_samplers()``, default ``plain_bf16_samplers``): the
    encoder memory, then the decoder from the kernels' proposals (so a near-tie in the top-k
    cannot send the two to other queries), every output within PATH_ULPS bf16 ulps of its
    largest magnitude; whether the two top-k agree (reported)."""
    plain_samplers = plain_samplers or (lambda: plain_bf16_samplers(da))
    model = predictor.model
    spotter = model.detection_transformer
    dtype = model.compute_dtype
    imgs = production_frames(torch, predictor)

    def run(plain, enc=None, refs=None):
        with (plain_samplers() if plain else contextlib.nullcontext()), torch.no_grad():
            if enc is None:
                feats, pos = model.features(imgs.to(dtype))
                return spotter.encode(feats, [p.to(dtype) for p in pos], None)
            return spotter.decode(enc, refs)

    enc_k, enc_p = run(False), run(True)
    with torch.no_grad():
        topk = [torch.sort(spotter.encoder_proposals(e)[0], dim=1, descending=True,
                           stable=True).indices[:, :spotter.num_queries] for e in (enc_k, enc_p)]
        refs = spotter.select_proposals(*spotter.encoder_proposals(enc_k))
    out_k, out_p = run(False, enc_k, refs), run(True, enc_k, refs)
    outs = {"encoder memory": (enc_k["memory"], enc_p["memory"]),
            **{k: (v, out_p[k]) for k, v in out_k.items() if torch.is_tensor(v)}}
    over = []
    for k, (a, b) in outs.items():
        check(bool(torch.isfinite(a.float()).all()), f"{tag}: non-finite {k}")
        top = a.float().abs().max()
        err = (a.float() - b.float()).abs().max().item()
        ulp = bf16_ulp(torch, top).item()
        print(f"{tag} bf16 spotter {k} ({a.dtype}): max|kernels-plain| {err:.3e} "
              f"({err / ulp:.2f} bf16 ulps of its max {top.item():.3e}; limit {PATH_ULPS})")
        if not (math.isfinite(err) and err <= PATH_ULPS * ulp):
            over.append(f"{k} by {err / ulp:.2f} ulps")
    check(not over, f"{tag}: kernels and plain differ beyond {PATH_ULPS} ulps: {over}")
    print(f"{tag} top-{spotter.num_queries} proposals of the kernels' and the plain encoder "
          f"memory: {'identical' if torch.equal(*topk) else 'DIFFERENT'} "
          f"({int((topk[0] != topk[1]).sum().item())} of {topk[0].numel()} slots differ)")


def match_iou(a, b):
    """(Na, 4) x (Nb, 4) xyxy IoU."""
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.maximum(rb - lt, 0), -1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def track_agreement(ref_frames, frames, iou=0.5, tight=0.9):
    """(coverage, id consistency over all IoU-matched pairs, over pairs at IoU >= ``tight``,
    pairs), counted as tests/test_production_parity.py's ``track_agreement`` counts them:
    greedy IoU >= ``iou`` matches of the boxes around each detection's control points,
    coverage per frame over the larger count, and the share of pairs whose (ref id, id)
    agrees with the majority one-to-one map."""
    def boxes(det):
        pts = det.ctrl_points.reshape(len(det.ctrl_points), -1, 2)
        if len(pts) == 0:
            return np.zeros((0, 4))
        return np.concatenate([pts.min(1), pts.max(1)], 1).astype(np.float64)

    votes, pairs, cov = {}, [], []
    for rf, pf in zip(ref_frames, frames):
        ra, pa = boxes(rf), boxes(pf)
        if max(len(ra), len(pa)) == 0:
            continue
        m = match_iou(ra, pa)
        used_r, used_p, n = set(), set(), 0
        for i, j in np.dstack(np.unravel_index(np.argsort(-m, axis=None), m.shape))[0]:
            if m[i, j] < iou or i in used_r or j in used_p:
                continue
            used_r.add(i)
            used_p.add(j)
            n += 1
            key = (int(rf.track_ids[i]), int(pf.track_ids[j]))
            votes[key] = votes.get(key, 0) + 1
            pairs.append((key, float(m[i, j])))
        cov.append(n / max(len(ra), len(pa)))
    bij, taken = {}, set()
    for (r, q), _ in sorted(votes.items(), key=lambda kv: -kv[1]):
        if r not in bij and q not in taken:
            bij[r] = q
            taken.add(q)

    def consistency(sel):
        return sum(1 for (r, q), _ in sel if bij.get(r) == q) / max(len(sel), 1)

    return (float(np.mean(cov)) if cov else 0.0, consistency(pairs),
            consistency([kv for kv in pairs if kv[1] >= tight]), len(pairs))


def phase_production(torch, da, ref_tracked):
    """Phase 18: VideoPredictor in the production configuration (MODEL.PRECISION bfloat16,
    TPU.UPLOAD_FORMAT yuv420, the default sampler, the matcher following MODEL.PRECISION)
    on both shipped configs at full width over phase 4's frames: frames/s, device time per
    clip, busy share, peak memory, the device time by class; on ICDAR15 the kernels against
    the plain bf16 samplers, and the clip against phase 4's f32 / RGB run ``ref_tracked``
    (reported). Returns the ICDAR15 run's launch counts."""
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor

    counts = None
    for config in (CONFIG, CONFIG_PP):
        cfg = setup_eval_cfg(config, ["MODEL.WEIGHTS", "''", "MODEL.TRANSFORMER.INFERENCE_TH_TEST",
                                      "0.05", "SEED", "0", *PROD_OPTS])
        predictor = VideoPredictor(cfg)
        check(predictor.model.compute_dtype == torch.bfloat16
              and predictor.assoc_dtype == torch.bfloat16 and predictor.upload_format == "yuv420"
              and cfg.TPU.SAMPLING_IMPL == "vmem", f"phase 18: {config} is not the production path")
        print(f"[18] {config} with {' '.join(PROD_OPTS)} (sampler {cfg.TPU.SAMPLING_IMPL}, "
              f"matcher {predictor.assoc_dtype})")
        t = cfg.MODEL.TRANSFORMER
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run_counts = phase_main(torch, predictor, da, "[18]",
                                {da.ENCODER_BF16: t.ENC_LAYERS, da.QUERIES_BF16: t.DEC_LAYERS})
        peak = torch.cuda.max_memory_allocated()
        rows, wall = phase_profile(torch, predictor, "[18]")
        if rows:
            busy = sum(r[0] for r in rows) / 1e3
            print(f"[18] device time per {N_FRAMES}-frame clip {busy:.1f} ms, busy "
                  f"{100 * busy / (wall * 1e3):.1f}% of the profiled wall; peak memory "
                  f"{peak / 2**30:.2f} GiB over the main path's runs")
            for name, (us, n) in class_shares(rows).items():
                print(f"[18]   {name}: {us / 1e3:.3f} ms in {n} launches, "
                      f"{100 * us / 1e3 / busy:.1f}% of device time")
        if config == CONFIG:
            counts = run_counts
            bf16_spot_vs_plain(torch, predictor, da)
            frames = synthetic_frames()
            prod = predictor.process_video([f.copy() for f in frames])
            with plain_bf16_samplers(da):
                plain = predictor.process_video([f.copy() for f in frames])
            same = sum(np.array_equal(a.track_ids, b.track_ids) for a, b in zip(prod, plain))
            cov, cons, cons_t, n = track_agreement(prod, plain)
            print(f"[18] the clip with the kernels and with the plain bf16 samplers: ids "
                  f"identical in {same} of {len(prod)} frames; coverage {cov:.3f}, id consistency "
                  f"{cons:.3f} (tight {cons_t:.3f}) over {n} matched pairs")
            cov, cons, cons_t, n = track_agreement(ref_tracked, prod)
            print(f"[18] production against phase 4's f32 / RGB run on the same frames "
                  f"(random weights): {sum(len(f) for f in prod)} against "
                  f"{sum(len(f) for f in ref_tracked)} detections, coverage {cov:.3f}, id "
                  f"consistency {cons:.3f} over all {n} IoU-matched pairs, {cons_t:.3f} over "
                  "tight ones")
        del predictor
        torch.cuda.empty_cache()
    return counts


def phase_tracker_production(torch, da, tmp, f32_step):
    """Phase 19: tracker training through ``train_net.main`` in the production configuration
    (MODEL.PRECISION bfloat16, TPU.TRAIN_UPLOAD_FORMAT yuv420) on phase 16's dataset:
    finite losses, B1 on bf16 value alone, only roi_heads moved, an f32 checkpoint that loads
    back strictly, ms/iter and stages; one profiled step against phase 16's ``f32_step``."""
    from torch.profiler import ProfilerActivity, profile

    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.data.loader import build_train_loader
    from gomatching_tpu_torch.engine.checkpoint import load_checkpoint
    from gomatching_tpu_torch.engine.train import Trainer, encode_train_clip
    from gomatching_tpu_torch.models.gomatching import build_model
    from gomatching_tpu_torch.weights import init_state_dict, load_weights

    out_dir = os.path.join(tmp, "out_prod")
    argv = tracker_argv(CONFIG, out_dir, N_PROD_TRACK_STEPS, TRAIN_PROD_OPTS)
    cfg = setup_train_cfg(CONFIG, argv[argv.index("--opts") + 1:])
    t = cfg.MODEL.TRANSFORMER
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    da.reset_launch_counts()
    history = train_net.main(argv)
    torch.cuda.synchronize()
    counts = dict(da.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    check(len(history) == N_PROD_TRACK_STEPS, f"phase 19: {len(history)} steps ran")
    for i, h in enumerate(history):
        check(all(math.isfinite(h[k]) for k in ("loss_res", "loss_long_asso", "loss_short_asso",
                                                 "total_loss")),
              f"phase 19: non-finite loss at step {i + 1}: {h}")
        check(h["proposals"] > 0, f"phase 19: step {i + 1} has no proposals")
    want = {**{name: 0 for name in counts},
            da.QUERIES_BF16: (t.ENC_LAYERS + t.DEC_LAYERS) * N_PROD_TRACK_STEPS}
    check(counts == want, f"phase 19: launches {counts}, expected {want}")
    sd = load_checkpoint(os.path.join(out_dir, "checkpoints",
                                      f"model_{N_PROD_TRACK_STEPS:07d}_rescore.pth"))
    check(all(v.dtype == torch.float32 for v in sd.values()), "phase 19: a bf16 checkpoint tensor")
    load_weights(build_model(cfg), sd)
    init = train_net.init_rescoring_from_classifier(
        init_state_dict(cfg, torch.Generator().manual_seed(1)))
    moved = {k for k in init if not torch.equal(sd[k], init[k])}
    check(set(sd) == set(init) and moved and all(k.startswith("roi_heads.") for k in moved),
          f"phase 19: {len(moved)} tensors moved, outside roi_heads: "
          f"{sorted(k for k in moved if not k.startswith('roi_heads.'))[:5]}")
    after = history[N_TRACK_WARMUP:]  # as phase 16: each new canvas's first step is slow

    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    print(f"[19] tracker-training CLI ({CONFIG}, {' '.join(TRAIN_PROD_OPTS)}): "
          f"{N_PROD_TRACK_STEPS} iterations, losses {[round(h['total_loss'], 4) for h in history]}; "
          f"proposals {[h['proposals'] for h in history]}, matched {[h['matched'] for h in history]};"
          f" launches {counts}; the checkpoint f32 and strict, {len(moved)} tensors moved, all "
          "roi_heads")
    print(f"[19] iterations {N_TRACK_WARMUP + 1}-{N_PROD_TRACK_STEPS}: median "
          f"{med(h['step_s'] for h in after) * 1e3:.1f}"
          f" ms/iter (min {min(h['step_s'] for h in after) * 1e3:.1f}, max "
          f"{max(h['step_s'] for h in after) * 1e3:.1f}); data stage median "
          f"{med(h['data_s'] for h in after) * 1e3:.1f} ms; by stage (median ms) spot "
          f"{med(h['phase_t']['spot'] for h in after) * 1e3:.1f}, host "
          f"{med(h['phase_t']['host'] for h in after) * 1e3:.1f}, update "
          f"{med(h['phase_t']['update'] for h in after) * 1e3:.1f}; frames per clip "
          f"{[h['frames'] for h in history]}; peak memory {peak / 2**30:.2f} GiB")

    # one profiled step on phase 16's profiled clip (its config and seed), on the I420 wire
    scfg = setup_train_cfg(CONFIG, argv[argv.index("--opts") + 1:] + ["SEED", str(TRACK_AB_SEED)])
    sample = next(iter(build_train_loader(scfg)))
    images, frame_hw = train_net.normalize_clip(sample, scfg.MODEL.PIXEL_MEAN,
                                                scfg.MODEL.PIXEL_STD, raw=True)
    wire = encode_train_clip(images, scfg.INPUT.FORMAT)
    check(wire.ndim == 3, "phase 19: the clip did not go as I420")
    targets = train_net.targets_from_sample(sample)
    tr = Trainer(scfg, train_net.init_rescoring_from_classifier(
        init_state_dict(scfg, torch.Generator().manual_seed(scfg.SEED))))
    tr.step(wire, frame_hw, targets)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        tr.step(wire, frame_hw, targets)
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = device_rows(torch, prof)
    if not rows:
        print("[19] profiler: no device time recorded (not measured)")
        return
    busy = sum(r[0] for r in rows) / 1e3
    b1 = sum(t_us for t_us, _, key in rows if key.startswith("ms_deform_attn_queries_bf16_kernel("))
    f32_busy = f32_step["busy_ms"]
    print(f"[19] profiled production step ({len(images)} frames, I420, bf16 spotter): wall "
          f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of "
          f"wall; profiler on), B1 bf16 {b1 / 1e3:.3f} ms; phases (ms) "
          + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in tr.phase_t.items())
          + f"; phase 16's f32 step on the same clip: device busy "
          + ("not measured" if f32_busy is None else f"{f32_busy:.1f} ms")
          + f", spot {f32_step['spot_ms']:.1f} ms ({f32_step['frames']} frames)")
    for name, (us, n) in class_shares(rows).items():
        print(f"[19]   {name}: {us / 1e3:.3f} ms in {n} launches, {100 * us / 1e3 / busy:.1f}%")
    del tr


# ---------------------------------------------------------------------------
# phases 20-21: B5 with its table and B6a-c on bf16 value; GoMatching++ production on 'pallas'
# ---------------------------------------------------------------------------

PALLAS_OPTS = ["TPU.SAMPLING_IMPL", "pallas"]
CONFIG_PP_DS = "configs/GoMatching_PP_DSText.yaml"  # GoMatching++ on DSText (300 queries)
# DSText's test size (MIN_SIZE_TEST 1280) turns the 720x1280 frames into 1280x2276: its
# levels at strides 8-64 and its decoder queries (NUM_QUERIES x NUM_POINTS); phase 21 checks
# that its spotter samples at exactly these shapes
DS_SHAPES = [(160, 285), (80, 143), (40, 72), (20, 36)]
DS_QUERIES = 300 * NPTS
# the detection threshold of phase 21's runs: ICDAR15's 0.05 (phases 11, 18); DSText's
# config has no rescoring head (WITH_RESR False), so its seeded random classifier scores
# stay near its 0.01 prior and none passes 0.05: 0.005 lets detections reach NMS, the
# matchers and the tracker
PP_THRESH = {CONFIG_PP: "0.05", CONFIG_PP_DS: "0.005"}
N_PP_TRACK_STEPS = 2  # phase 21's tracker iterations on 'pallas'


def alternate(fns, n=2):
    """{label: [ms, ...]} of each of ``fns`` ({label: fn}) timed in turns, a b ... b a."""
    runs = {k: [] for k in fns}
    order = list(fns)
    for i in range(n):
        for k in (order if i % 2 == 0 else order[::-1]):
            runs[k].append(cuda_time_ms(fns[k]))
    return runs


def merged_bf16_cases(torch, da, dam, label, shapes, n_queries, seed, info):
    """Phase 20 at one configuration's shapes: B5's table build on bf16 value against its
    plain version (exactly the same bits) and B5 on the bf16 table against its plain bf16
    version (one ulp), at the encoder (Lq = S, reference points plus offsets) and decoder
    (``n_queries``) shapes, locations partly off the maps; each the same bits twice, timed
    beside the f32 kernel on the same values in turns. Returns the kernels-line records."""
    S = sum(h * w for h, w in shapes)
    g = torch.Generator().manual_seed(seed)
    dev = "cuda"
    value32 = torch.randn(B, S, M, D, generator=g).bfloat16().float().to(dev)
    value = value32.bfloat16()
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)
    off = torch.randn(B, S, M, L, P, 2, generator=g) * 4.0
    far = torch.rand(B, S, M, L, P, 2, generator=g) < 0.01
    off = torch.where(far, off * 100.0, off).to(dev)
    cases = {
        "encoder": (da.encoder_reference_points(shapes, dev)[None, :, None, None, None, :]
                    + off / wh[None, None, None, :, None, :]),
        "decoder": (torch.rand(B, n_queries, M, L, P, 2, generator=g) * 1.2 - 0.1).to(dev),
    }
    del off, far
    records = {}

    # the table: a copy of bits
    before = da.launch_counts[da.MERGED_TABLE_BF16]
    table = dam.merged_table(value, shapes)
    check(table.dtype == torch.bfloat16 and da.launch_counts[da.MERGED_TABLE_BF16] == before + 1,
          f"{da.MERGED_TABLE_BF16} {label}: not launched in bf16")
    vbm = value.permute(0, 2, 1, 3)
    want = dam.merged_corner_table(vbm, shapes)
    torch.cuda.synchronize()
    check(torch.equal(table, want), f"{da.MERGED_TABLE_BF16} {label}: differs from the plain table")
    same_bits(torch, da.MERGED_TABLE_BF16, lambda: dam.merged_table(value, shapes), table)
    del want
    runs = alternate({"f32": lambda: dam.merged_table(value32, shapes),
                      "bf16": lambda: dam.merged_table(value, shapes)})
    t_dev, t_n = launch_us(torch, lambda: dam.merged_table(value, shapes),
                           "ms_deform_attn_merged_table_bf16_kernel(")
    t_plain = cuda_time_ms(lambda: dam.merged_corner_table(vbm, shapes), iters=5, warmup=1)
    rows = dam._corner_rows(shapes, dev).reshape(-1)
    t_lib = cuda_time_ms(lambda: vbm.index_select(2, rows))
    del rows
    t_bound, t_by = bound(nbytes(value, table), 0)
    t_ms = sum(runs["bf16"]) / len(runs["bf16"])
    print(f"[20] {da.MERGED_TABLE_BF16} at the {label} shape (value ({B}, {S}, {M}, {D}) bf16, "
          f"table {nbytes(table) / 1e6:.1f} MB): the plain table's bits exactly, same bits twice; "
          f"kernel {', '.join(f'{t:.4f}' for t in runs['bf16'])} ms against f32's "
          f"{', '.join(f'{t:.4f}' for t in runs['f32'])} ms on the same values in turns "
          f"(f32 {nbytes(value32) * 4 / 1e6:.1f} MB table); device {fmt_us(t_dev)} a launch over "
          f"{t_n} recorded; plain {t_plain:.4f} ms; index_select {t_lib:.4f} ms; bound "
          f"{t_bound:.4f} ms ({t_by}: value read once, the table written once); "
          f"{info[da.MERGED_TABLE_BF16]['registers']} registers, "
          f"{info[da.MERGED_TABLE_BF16]['local_bytes']} bytes of local memory a thread")
    records[da.MERGED_TABLE_BF16] = dict(
        name=da.MERGED_TABLE_BF16, route="cuda",
        source="gomatching_tpu_torch/csrc/ms_deform_attn.cu",
        replaces="gomatching_tpu/ops/deform_attn_pallas.py:89", max_abs_err=0.0, ms=t_ms,
        plain_ms=t_plain, bound_ms=t_bound, bound_by=t_by, library_ms=t_lib)
    table32 = dam.merged_table(value32, shapes)

    for case, loc in cases.items():
        Lq = loc.shape[1]
        attn = torch.randn(B, Lq, M, L * P, generator=g).softmax(-1).view(B, Lq, M, L, P).to(dev)
        before = da.launch_counts[da.MERGED_BF16]
        got = dam.ms_deform_attn_merged(value, shapes, loc, attn)
        check(got.dtype == torch.bfloat16 and da.launch_counts[da.MERGED_BF16] == before + 1,
              f"{da.MERGED_BF16} {label} {case}: not launched in bf16")
        want = dam.ms_deform_attn_merged_plain(value, shapes, loc, attn)
        torch.cuda.synchronize()
        err, n_diff, n_over, near0 = check_one_ulp(torch, f"{da.MERGED_BF16} {label} {case}",
                                                   got, want)
        same_bits(torch, da.MERGED_BF16, lambda: dam.ms_deform_attn_merged(value, shapes, loc, attn),
                  got)
        del want
        runs = alternate({"f32": lambda: dam.merged_sample(table32, shapes, loc, attn),
                          "bf16": lambda: dam.merged_sample(table, shapes, loc, attn)})
        dev_us, n_rec = launch_us(torch, lambda: dam.merged_sample(table, shapes, loc, attn),
                                  "ms_deform_attn_merged_bf16_kernel(")
        both_ms = cuda_time_ms(lambda: dam.ms_deform_attn_merged(value, shapes, loc, attn))
        plain_ms = cuda_time_ms(lambda: dam.ms_deform_attn_merged_plain(value, shapes, loc, attn),
                                iters=3, warmup=1)
        v_bytes, taps = value_reads(torch, loc, S, D, shapes=shapes, elem_bytes=2)
        samples = B * Lq * M * L * P
        b_ms, b_by = bound(v_bytes + nbytes(loc, attn, got),
                           samples * (20 + 2 * D) + taps * (2 * D + 1))
        ms = sum(runs["bf16"]) / len(runs["bf16"])
        print(f"[20] {da.MERGED_BF16} {label} {case} (Lq={Lq}): within one bf16 ulp of plain "
              f"({n_diff} of {got.numel()} elements differ, max |diff| {err:.3e}; {n_over} more "
              f"than an ulp apart, all within {near0:.2e} <= ATOL_KERNEL), same bits twice; "
              f"kernel on the table {', '.join(f'{t:.4f}' for t in runs['bf16'])} ms against "
              f"f32's {', '.join(f'{t:.4f}' for t in runs['f32'])} ms in turns (device "
              f"{fmt_us(dev_us)} a launch over {n_rec} recorded); with the table build "
              f"{both_ms:.4f} ms; plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
              f"{v_bytes / 1e6:.1f} MB of bf16 value rows touched); "
              f"{info[da.MERGED_BF16]['registers']} registers, "
              f"{info[da.MERGED_BF16]['local_bytes']} bytes of local memory a thread")
        if case == "encoder":
            records[da.MERGED_BF16] = dict(
                name=da.MERGED_BF16, route="cuda",
                source="gomatching_tpu_torch/csrc/ms_deform_attn.cu",
                replaces="gomatching_tpu/ops/deform_attn_pallas.py:49", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del got, attn
    return records


def phase_bf16_samplers(torch, da, dam, dav, daf):
    """Phase 20: B5 and its table build on bf16 value at the ICDAR15 and DSText shapes, and
    the four B6 entries on bf16 value at phase 12's inputs, each against its plain bf16
    version, the same bits twice, timed beside the f32 kernel on the same values in turns,
    with the staged share of the bf16 footprints beside the f32 ones'. Returns the
    kernels-line records of B5 bf16 and its table (ICDAR15's encoder shape) and of the B6
    entries on bf16."""
    for name in (da.MERGED_BF16, da.MERGED_TABLE_BF16):
        i = da.kernel_info()[name]
        check(i["local_bytes"] == 0, f"{name}: {i['local_bytes']} bytes of local memory")
    info = da.kernel_info()
    records = merged_bf16_cases(torch, da, dam, "ICDAR15", SHAPES, NQ * NPTS, 20, info)
    merged_bf16_cases(torch, da, dam, "DSText", DS_SHAPES, DS_QUERIES, 21, info)
    torch.cuda.empty_cache()

    S = sum(h * w for h, w in SHAPES)
    value, _, _, _, _, beyond, outside, cases = footprint_inputs(torch, da, dav, daf)
    value32 = value.bfloat16().float()
    value = value32.bfloat16()
    for name, entry, plain, (w_loc, w_attn), fp_of, fp_loc, replaces, inputs in cases:
        name16 = dav.BF16_NAMES[name]
        before = da.launch_counts[name16]
        got = entry(value)
        check(got.dtype == torch.bfloat16 and da.launch_counts[name16] == before + 1,
              f"{name16}: not launched in bf16")
        want = plain(value)
        torch.cuda.synchronize()
        err, n_diff, n_over, near0 = check_one_ulp(torch, name16, got, want)
        same_bits(torch, name16, lambda: entry(value), got)
        del want
        runs = alternate({"f32": lambda: entry(value32), "bf16": lambda: entry(value)})
        dev16, n16 = launch_us(torch, lambda: entry(value), "ms_deform_attn_footprint_kernel")
        plain_ms = cuda_time_ms(lambda: plain(value), iters=3, warmup=1)
        v_bytes, taps = value_reads(torch, w_loc, S, D, elem_bytes=2)
        samples = w_loc.shape[1] * B * M * L * P
        b_ms, b_by = bound(v_bytes + nbytes(*inputs, got),
                           samples * (20 + 2 * D) + taps * (2 * D + 1))
        fps = {eb: fp_of(eb) for eb in (4, 2)}
        shares = {}
        for eb, fp in fps.items():
            share = dav.staged_share(fp, SHAPES, fp_loc)
            smem, n_taps = (sum(v[k] for v in share.values()) for k in (0, 1))
            shares[eb] = 100 * smem / n_taps
        i16 = list(dav.footprint_kernel_info(fps[2]).values())[fps[2].layout]
        check(i16["local_bytes"] == 0, f"{name16}: {i16['local_bytes']} bytes of local memory")
        ms = sum(runs["bf16"]) / len(runs["bf16"])
        print(f"[20] {name16} (Lq={w_loc.shape[1]}): within one bf16 ulp of plain ({n_diff} of "
              f"{got.numel()} elements differ, max |diff| {err:.3e}; {n_over} more than an ulp "
              f"apart, all within {near0:.2e} <= ATOL_KERNEL), same bits twice; kernel "
              f"{', '.join(f'{t:.4f}' for t in runs['bf16'])} ms against f32's "
              f"{', '.join(f'{t:.4f}' for t in runs['f32'])} ms on the same values in turns "
              f"(device {fmt_us(dev16)} a launch over {n16} recorded); plain {plain_ms:.4f} ms; "
              f"bound {b_ms:.4f} ms ({b_by}: {v_bytes / 1e6:.1f} MB of bf16 value rows touched); "
              f"staged {shares[2]:.1f}% of in-map corner taps in bf16 ({sum(st for r in fps[2].pairs for *_, st in r)} "
              f"of {len(SHAPES) ** 2} pairs, {fps[2].smem_bytes} bytes of shared memory a block) "
              f"against {shares[4]:.1f}% in f32 ({sum(st for r in fps[4].pairs for *_, st in r)} pairs, "
              f"{fps[4].smem_bytes} bytes); {i16['registers']} registers, {i16['local_bytes']} "
              f"bytes of local memory a thread, {i16['warps_per_sm']} resident warps per SM; "
              f"{100 * beyond:.1f}% of samples beyond the halo, {100 * outside:.2f}% outside the maps")
        records[name16] = dict(
            name=name16, route="cuda", source="gomatching_tpu_torch/csrc/ms_deform_attn.cu",
            replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None)
        del got
    return records


def phase_pallas_production(torch, da, dam):
    """Phase 21, inference: VideoPredictor on GoMatching++ (ICDAR15 and DSText) in the
    production configuration on 'pallas' (MODEL.PRECISION bfloat16, TPU.UPLOAD_FORMAT yuv420)
    at full width over phase 4's frames: B5 bf16 and its table the only samplers, each
    launched ENC_LAYERS + DEC_LAYERS times a spot batch; frames/s, device time per clip, busy
    share, peak memory; one spot batch with the kernels against the plain bf16 merged
    sampler, at the shapes phase 20 ran. Returns the ICDAR15 run's launch counts."""
    import gomatching_tpu_torch.models.spotter as spotter_mod
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor

    counts = None
    for config, shapes, n_queries in ((CONFIG_PP, SHAPES, NQ * NPTS),
                                      (CONFIG_PP_DS, DS_SHAPES, DS_QUERIES)):
        cfg = setup_eval_cfg(config, ["MODEL.WEIGHTS", "''", "MODEL.TRANSFORMER.INFERENCE_TH_TEST",
                                      PP_THRESH[config], "SEED", "0", *PROD_OPTS, *PALLAS_OPTS])
        predictor = VideoPredictor(cfg)
        check(predictor.model.compute_dtype == torch.bfloat16
              and predictor.upload_format == "yuv420" and cfg.TPU.SAMPLING_IMPL == "pallas",
              f"phase 21: {config} is not the production path on 'pallas'")
        print(f"[21] {config} with {' '.join(PROD_OPTS + PALLAS_OPTS)} (matcher "
              f"{predictor.assoc_dtype}, detection threshold {PP_THRESH[config]})")
        t = cfg.MODEL.TRANSFORMER
        layers = t.ENC_LAYERS + t.DEC_LAYERS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run_counts = phase_main(torch, predictor, da, "[21]",
                                {da.MERGED_BF16: layers, da.MERGED_TABLE_BF16: layers})
        peak = torch.cuda.max_memory_allocated()
        rows, wall = phase_profile(torch, predictor, "[21]", shares=[
            ("B5 bf16", "ms_deform_attn_merged_bf16_kernel("),
            ("B5's table build bf16", "ms_deform_attn_merged_table_bf16_kernel(")])
        if rows:
            busy = sum(r[0] for r in rows) / 1e3
            print(f"[21] device time per {N_FRAMES}-frame clip {busy:.1f} ms, busy "
                  f"{100 * busy / (wall * 1e3):.1f}% of the profiled wall; peak memory "
                  f"{peak / 2**30:.2f} GiB over the main path's runs")
        # the kernels against the plain bf16 merged sampler on one spot batch, recording
        # the shapes the spotter's samplers see
        seen = set()
        merged = spotter_mod.ms_deform_attn_merged

        def recording(value, spatial_shapes, loc, attn):
            seen.add((tuple(tuple(int(x) for x in hw) for hw in spatial_shapes), loc.shape[1],
                      value.dtype, loc.dtype, attn.dtype))
            return merged(value, spatial_shapes, loc, attn)

        with patched(spotter_mod, ms_deform_attn_merged=recording):
            bf16_spot_vs_plain(torch, predictor, da, tag="[21]", plain_samplers=lambda: patched(
                spotter_mod, ms_deform_attn_merged=dam.ms_deform_attn_merged_plain))
        S = sum(h * w for h, w in shapes)
        want = {(tuple(shapes), lq, torch.bfloat16, torch.float32, torch.float32)
                for lq in (S, n_queries)}
        check(seen == want, f"phase 21: {config}'s samplers saw {seen}, phase 20 ran {want}")
        print(f"[21] {config}: the spotter's B5 calls sample levels {shapes} with Lq {S} "
              f"(encoder) and {n_queries} (decoder), bf16 value and f32 locations and attention: "
              "phase 20's shapes")
        if config == CONFIG_PP:
            counts = run_counts
        del predictor
        torch.cuda.empty_cache()
    return counts


def phase_pallas_tracker(torch, da, tmp):
    """Phase 21, training: N_PP_TRACK_STEPS tracker iterations of GoMatching++ through
    ``train_net.main`` under 'pallas' with MODEL.PRECISION bfloat16 and
    TPU.TRAIN_UPLOAD_FORMAT yuv420 on phase 16's dataset: finite losses, B5 bf16 and its
    table the only samplers, launched ENC_LAYERS + DEC_LAYERS times a clip, an f32
    checkpoint in which only roi_heads moved."""
    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.engine.checkpoint import load_checkpoint
    from gomatching_tpu_torch.weights import init_state_dict

    out_dir = os.path.join(tmp, "out_pp_pallas")
    argv = tracker_argv(CONFIG_PP, out_dir, N_PP_TRACK_STEPS, TRAIN_PROD_OPTS + PALLAS_OPTS)
    cfg = setup_train_cfg(CONFIG_PP, argv[argv.index("--opts") + 1:])
    t = cfg.MODEL.TRANSFORMER
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    da.reset_launch_counts()
    history = train_net.main(argv)
    torch.cuda.synchronize()
    counts = dict(da.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    check(len(history) == N_PP_TRACK_STEPS, f"phase 21: {len(history)} tracker steps ran")
    for i, h in enumerate(history):
        check(all(math.isfinite(h[k]) for k in ("loss_res", "loss_long_asso", "loss_short_asso",
                                                 "total_loss")),
              f"phase 21: non-finite loss at step {i + 1}: {h}")
        check(h["proposals"] > 0, f"phase 21: step {i + 1} has no proposals")
    layers = (t.ENC_LAYERS + t.DEC_LAYERS) * N_PP_TRACK_STEPS
    want = {**{name: 0 for name in counts}, da.MERGED_BF16: layers, da.MERGED_TABLE_BF16: layers}
    check(counts == want, f"phase 21: tracker launches {counts}, expected {want}")
    sd = load_checkpoint(os.path.join(out_dir, "checkpoints",
                                      f"model_{N_PP_TRACK_STEPS:07d}_rescore.pth"))
    check(all(v.dtype == torch.float32 for v in sd.values()), "phase 21: a bf16 checkpoint tensor")
    init = train_net.init_rescoring_from_classifier(
        init_state_dict(cfg, torch.Generator().manual_seed(1)))
    moved = {k for k in init if not torch.equal(sd[k], init[k])}
    check(set(sd) == set(init) and moved and all(k.startswith("roi_heads.") for k in moved),
          f"phase 21: {len(moved)} tensors moved, outside roi_heads: "
          f"{sorted(k for k in moved if not k.startswith('roi_heads.'))[:5]}")
    print(f"[21] tracker-training CLI ({CONFIG_PP}, {' '.join(TRAIN_PROD_OPTS + PALLAS_OPTS)}): "
          f"{N_PP_TRACK_STEPS} iterations, losses {[round(h['total_loss'], 4) for h in history]}, "
          f"proposals {[h['proposals'] for h in history]}, frames per clip "
          f"{[h['frames'] for h in history]}, {[round(h['step_s'] * 1e3, 1) for h in history]} "
          f"ms/iter; launches {counts}; the checkpoint f32, {len(moved)} tensors moved, all "
          f"roi_heads; peak memory {peak / 2**30:.2f} GiB")


# ---------------------------------------------------------------------------
# phase 22: the other corpora on the card
# ---------------------------------------------------------------------------

# GoMatching (the LST-Matcher) on the three other corpora: (input root's name, class
# directory or '' for a flat tree, videos, detection threshold). The input root carries
# the corpus's name, since eval.list_videos routes on it: DSText and BOVText trees are
# <root>/<Cls>/<video>/<n>.jpg, ArTVideo's <root>/<video>/<n>.jpg. The first video of each
# tree is the warm-up; DSText times N_REPEATS more. DSText and BOVText have no rescoring
# head (WITH_RESR False), so their seeded random classifiers score near the 0.01 prior
# and none passes 0.05 (phase 21): 0.005 lets detections reach NMS, the matchers and the
# tracker; ArTVideo has the head, and takes ICDAR15's 0.05 (phases 4, 18)
CORPORA = {
    "configs/GoMatching_DSText.yaml": ("DSText", "Cls1_Game", 1 + N_REPEATS, "0.005"),
    "configs/GoMatching_BOVText.yaml": ("BOVText", "Cls2_News", 2, "0.005"),
    "configs/GoMatching_ArTVideo.yaml": ("ArTVideo", "", 2, "0.05"),
}
# the protocol modes of each corpus's scorer (gomatching_tpu_torch.tools.eval_tracking)
SCORER_MODES = {
    "DSText": ([], ["--e2e"], ["--det"]),
    "BOVText": (["--bovtext"], ["--bovtext", "--e2e"]),
    "ArTVideo": ([], ["--curve"], ["--e2e"]),
}


def write_char_table(path):
    """A BOVText CUSTOM_DICT (``chn_cls_list`` is not in the repository): 5461 codepoints,
    ASCII letters and digits, then CJK from U+4E00 (no '#', a don't-care mark to the
    protocols)."""
    import pickle

    ascii_ = [ord(c) for c in "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"]
    table = ascii_ + list(range(0x4E00, 0x4E00 + 5461 - len(ascii_)))
    with open(path, "wb") as f:
        pickle.dump(table, f)


def write_corpus_tree(tmp, corpus, cls, n_videos, frames):
    """The frames as JPEGs, one copy a video, in the corpus's layout; returns the input
    root and the video names in the order eval processes them."""
    import cv2

    root = os.path.join(tmp, "videos", corpus)
    names = [f"{cls or corpus}_video_{k}" for k in range(1, n_videos + 1)]
    for name in names:
        vdir = os.path.join(root, cls, name)
        os.makedirs(vdir)
        for i, f in enumerate(frames):
            cv2.imwrite(os.path.join(vdir, f"{i + 1}.jpg"), f)
    return root, names


def artvideo_gt(xml_path, hw):
    """ArTVideo GT JSON from a result XML: each object's points, its mask as a compressed
    COCO RLE (rasterized as the scorer rasterizes the result's polygons), text type
    Curved, and its transcription."""
    import xml.etree.ElementTree as ET

    import cv2

    from gomatching_tpu_torch.evaluation import rle

    root = ET.parse(xml_path).getroot()
    anns = []
    for fr in root:
        for obj in fr:
            pts = [float(v) for p in obj for v in (p.attrib["x"], p.attrib["y"])]
            mask = np.zeros(hw, np.uint8)
            cv2.fillPoly(mask, [np.array(pts, np.float32).astype(np.int32).reshape(-1, 2)], 1)
            seg = rle.encode(mask, compressed=True)
            anns.append({"frame_id": int(fr.attrib["ID"]), "obj_id": int(obj.attrib["ID"]),
                         "point": pts, "text_type": "Curved",
                         "transcription": obj.attrib["Transcription"],
                         "segmentation": dict(seg, counts=seg["counts"].decode("ascii"))})
    return {"frame": [{"height": hw[0], "width": hw[1]} for _ in root], "annotations": anns}


def switch_one_track(objects):
    """``objects``: [(frame, object dict with "ID")] of one video. The track with the
    most frames takes a new id from its middle frame on; returns (track, new id, frame)."""
    frames_of = {}
    for frame, obj in objects:
        frames_of.setdefault(int(obj["ID"]), []).append(frame)
    track = max(sorted(frames_of), key=lambda t: len(frames_of[t]))
    check(len(frames_of[track]) >= 2, "phase 22: no track spans two frames")
    start = sorted(frames_of[track])[len(frames_of[track]) // 2]
    new_id = max(frames_of) + 1000
    for frame, obj in objects:
        if int(obj["ID"]) == track and frame >= start:
            obj["ID"] = str(new_id) if isinstance(obj["ID"], str) else new_id
    return track, new_id, start


def score_corpus(corpus, out_dir, names, tmp, hw=(720, 1280)):
    """Score eval's results for ``names`` with the port's tools.eval_tracking against a GT
    written from those same results, in each protocol mode of the corpus: MOTA = IDF1 =
    1 (hmean 1 under --det); then the results with one track of the first video taking a
    new id from its middle frame on: 1 ID switch. Returns {mode: metrics}."""
    import shutil
    import xml.etree.ElementTree as ET

    from gomatching_tpu_torch.tools import eval_tracking

    preds, jsons = os.path.join(out_dir, "preds"), os.path.join(out_dir, "jsons")
    gt, res, switched = (os.path.join(tmp, f"score_{corpus}", d) for d in ("gt", "res", "sw"))
    for d in (gt, res, switched):
        os.makedirs(d)
    for name in names:
        if corpus == "BOVText":  # <gt>/<Cls>/<video>.json, results <res>/<video>.json
            cls_dir = os.path.join(gt, name.rsplit("_video_", 1)[0])
            os.makedirs(cls_dir, exist_ok=True)
            shutil.copy(os.path.join(jsons, f"{name}.json"), cls_dir)
            shutil.copy(os.path.join(jsons, f"{name}.json"), res)
            with open(os.path.join(jsons, f"{name}.json"), encoding="utf-8") as f:
                js = json.load(f)
            if name == names[0]:
                switch_one_track([(int(fid), o) for fid, objs in js.items() for o in objs])
            with open(os.path.join(switched, f"{name}.json"), "w", encoding="utf-8") as f:
                json.dump(js, f, ensure_ascii=False)
            continue
        xml = os.path.join(preds, f"res_{name}.xml")
        for ext in ("xml", "txt"):
            shutil.copy(os.path.join(preds, f"res_{name}.{ext}"), res)
        if corpus == "ArTVideo":
            with open(os.path.join(gt, f"{name}.json"), "w", encoding="utf-8") as f:
                json.dump(artvideo_gt(xml, hw), f, ensure_ascii=False)
        else:  # ICDAR-style GT: <video>.xml and its track transcriptions <video>.txt
            for ext in ("xml", "txt"):
                shutil.copy(os.path.join(preds, f"res_{name}.{ext}"),
                            os.path.join(gt, f"{name}.{ext}"))
        tree = ET.parse(xml)
        if name == names[0]:
            switch_one_track([(int(fr.attrib["ID"]), obj.attrib) for fr in tree.getroot()
                              for obj in fr])
        tree.write(os.path.join(switched, f"res_{name}.xml"), encoding="utf-8")
    out = {}
    for flags in SCORER_MODES[corpus]:
        mode = " ".join(flags) or "tracking"
        with contextlib.redirect_stdout(sys.stderr):  # the summary tables, beside the log
            m = eval_tracking.main(["--gt", gt, "--res", res, *flags])
        out[mode] = m
        if "--det" in flags:
            check(m["hmean"] == 1.0 and m["num_det"] > 0, f"phase 22: {corpus} {mode} self-score {m}")
        else:
            check(m["MOTA"] == 1.0 and m["IDF1"] == 1.0 and m["IDSW"] == 0,
                  f"phase 22: {corpus} {mode} self-score {m}")
    flags = [f for f in SCORER_MODES[corpus][0] if f != "--e2e"]
    with contextlib.redirect_stdout(sys.stderr):
        m = eval_tracking.main(["--gt", gt, "--res", switched, *flags])
    out["one id switched"] = m
    check(m["IDSW"] == 1 and m["MOTA"] < 1.0, f"phase 22: {corpus} with one track's id "
          f"switched: {m}")
    return out


def phase_corpora(torch, da, tmp, card):
    """Phase 22: the other corpora on the card. ``gomatching_tpu_torch.eval.main`` in the
    production configuration (MODEL.PRECISION bfloat16, TPU.UPLOAD_FORMAT yuv420, the
    default sampler) at full width on GoMatching DSText, BOVText and ArTVideo over JPEG
    trees of phase 4's frames that this phase writes: B2 and B1 on bf16 value launched
    ENC_LAYERS and DEC_LAYERS times a spot batch and no other sampler; frames/s, device
    time per clip, busy share and peak memory; on DSText one spot batch with the kernels
    against the plain bf16 samplers (PATH_ULPS) at its shapes (1280x2276, 300 x 25
    decoder queries); the results scored against themselves and with one id switched;
    ``--show`` on one BOVText video."""
    import xml.etree.ElementTree as ET

    import gomatching_tpu_torch.models.spotter as spotter_mod
    from gomatching_tpu_torch import eval as port_eval
    from gomatching_tpu_torch.data.preprocess import compute_test_size

    write_char_table(os.path.join(tmp, "chn_cls_list"))
    frames = synthetic_frames()
    for config, (corpus, cls, n_videos, thresh) in CORPORA.items():
        root, names = write_corpus_tree(tmp, corpus, cls, n_videos, frames)
        opts = ["MODEL.WEIGHTS", "''", "MODEL.TRANSFORMER.INFERENCE_TH_TEST", thresh,
                "SEED", "0", *PROD_OPTS]
        if corpus == "BOVText":
            opts += ["MODEL.TRANSFORMER.CUSTOM_DICT", os.path.join(tmp, "chn_cls_list")]
        out_dir = os.path.join(tmp, f"eval_{corpus}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        da.reset_launch_counts()
        res = port_eval.main(["--config-file", config, "--input", root, "--output", out_dir,
                              "--opts", *opts])
        torch.cuda.synchronize()
        counts = dict(da.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        predictor = res["predictor"]
        cfg = predictor.cfg
        t = cfg.MODEL.TRANSFORMER
        check(predictor.model.compute_dtype == torch.bfloat16
              and predictor.assoc_dtype == torch.bfloat16 and predictor.upload_format == "yuv420"
              and cfg.TPU.SAMPLING_IMPL == "vmem" and predictor.model.roi_heads.variant == "lst",
              f"phase 22: {config} is not GoMatching's production path")
        check(list(res["videos"]) == names, f"phase 22: eval read {list(res['videos'])}, the "
              f"tree holds {names}")
        n_batches = sum(-(-n // predictor.spot_batch) for n, _ in res["videos"].values())
        want = {**{name: 0 for name in counts}, da.ENCODER_BF16: t.ENC_LAYERS * n_batches,
                da.QUERIES_BF16: t.DEC_LAYERS * n_batches}
        check(counts == want, f"phase 22: {config} launched {counts}, expected {want}")
        fps = sorted(n / s for n, s in list(res["videos"].values())[1:])
        th, tw = compute_test_size(720, 1280, cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
        n_obj = 0
        for name in names:
            xml_root = ET.parse(os.path.join(out_dir, "preds", f"res_{name}.xml")).getroot()
            with open(os.path.join(out_dir, "jsons", f"{name}.json"), encoding="utf-8") as fp:
                js = json.load(fp)
            objs = sum(len(fr) for fr in xml_root)
            check(xml_root.tag == "Frames" and len(js) == N_FRAMES
                  and objs == sum(len(v) for v in js.values()),
                  f"phase 22: {name}'s XML and JSON disagree")
            n_obj += objs
        check(n_obj > 0, f"phase 22: {config} wrote no object")
        texts = [o.attrib["Transcription"] for name in names for fr in ET.parse(
            os.path.join(out_dir, "preds", f"res_{name}.xml")).getroot() for o in fr]
        if corpus == "BOVText":
            cjk = sum(any(ord(c) >= 0x4E00 for c in s) for s in texts)
            check(cjk > 0, "phase 22: no CJK transcription came through the BOVText table")
        print(f"[22] {config} ({corpus}, {len(names)} videos of {N_FRAMES} frames 720x1280 -> "
              f"{th}x{tw}, {t.NUM_QUERIES} queries, VOC_SIZE {t.VOC_SIZE}, WITH_RESR "
              f"{cfg.MODEL.ROI_HEADS.WITH_RESR}) through eval.main with {' '.join(PROD_OPTS)}, "
              f"detection threshold {thresh}: {n_obj} XML objects"
              + (f", {cjk} of {len(texts)} transcriptions with CJK" if corpus == "BOVText" else "")
              + f"; launches {counts} ({n_batches} spot batches)")
        print(f"[22] {config}: {fps[len(fps) // 2]:.3f} frames/s "
              + (f"(median of {len(fps)} timed videos; min {fps[0]:.3f}, max {fps[-1]:.3f}) "
                 if len(fps) > 1 else "(one timed video after a warm-up) ")
              + f"through eval.main with prefetched JPEG decode; peak memory "
              f"{peak / 2**30:.2f} GiB; {card}")
        tc = res["time_cost"]
        waited = tc["total_time"] - sum(v for k, v in tc.items() if k != "total_time")
        print(f"[22] time_cost {tc}; outside the stage buckets (chiefly the wait for "
              f"decoded frames): {waited:.3f} s of {tc['total_time']:.3f}, "
              f"{1e3 * waited / sum(n for n, _ in res['videos'].values()):.1f} ms a frame")
        # the same predictor over the frames in memory (no JPEG decode), as phases 4, 18, 21
        phase_main(torch, predictor, da, "[22]", {da.ENCODER_BF16: t.ENC_LAYERS,
                                                   da.QUERIES_BF16: t.DEC_LAYERS})
        rows, wall = phase_profile(torch, predictor, "[22]", shares=[
            ("B2 bf16", "ms_deform_attn_encoder_bf16_kernel("),
            ("B1 bf16", "ms_deform_attn_queries_bf16_kernel(")])
        if rows:
            busy = sum(r[0] for r in rows) / 1e3
            print(f"[22] {config}: device time per {N_FRAMES}-frame clip {busy:.1f} ms, busy "
                  f"{100 * busy / (wall * 1e3):.1f}% of the profiled wall; {card}")
        if corpus == "DSText":
            seen = set()
            queries, encoder = spotter_mod.ms_deform_attn_queries, spotter_mod.ms_deform_attn_encoder

            def record(fn):
                def call(value, spatial_shapes, loc, attn):
                    seen.add((fn.__name__, tuple(tuple(int(x) for x in hw) for hw in spatial_shapes),
                              loc.shape[1], value.dtype))
                    return fn(value, spatial_shapes, loc, attn)
                return call

            with patched(spotter_mod, ms_deform_attn_queries=record(queries),
                         ms_deform_attn_encoder=record(encoder)):
                bf16_spot_vs_plain(torch, predictor, da, tag="[22]")
            S = sum(h * w for h, w in DS_SHAPES)
            want_seen = {("ms_deform_attn_encoder", tuple(DS_SHAPES), S, torch.bfloat16),
                         ("ms_deform_attn_queries", tuple(DS_SHAPES), DS_QUERIES, torch.bfloat16)}
            check(seen == want_seen, f"phase 22: DSText's samplers saw {seen}, expected {want_seen}")
            print(f"[22] {config}: B2 bf16 samples levels {DS_SHAPES} (S = {S}), B1 bf16 "
                  f"{DS_QUERIES} decoder queries a frame ({DS_QUERIES // (NQ * NPTS)}x ICDAR15's)")
        scores = score_corpus(corpus, out_dir, names, tmp)
        for mode, m in scores.items():
            keys = ("precision", "recall", "hmean") if "hmean" in m else ("MOTA", "IDF1", "IDSW")
            print(f"[22] {corpus} scored by tools.eval_tracking, {mode}: "
                  + ", ".join(f"{k} {m[k]}" for k in keys))
        if corpus == "BOVText":
            show_root, show_names = write_corpus_tree(os.path.join(tmp, "show"), corpus, cls, 1,
                                                      frames)
            show_out = os.path.join(tmp, "show_out")
            port_eval.main(["--config-file", config, "--input", show_root, "--output", show_out,
                            "--show", "--opts", *opts])
            vis = os.path.join(show_out, "vis", show_names[0])
            drawn = sorted(os.listdir(vis), key=lambda x: int(x.split(".")[0]))
            check(drawn == [f"{i + 1}.jpg" for i in range(N_FRAMES)],
                  f"phase 22: --show drew {drawn}")
            with open(os.path.join(show_out, "preds", f"res_{show_names[0]}.xml"), "rb") as f:
                shown = f.read()
            with open(os.path.join(out_dir, "preds", f"res_{names[0]}.xml"), "rb") as f:
                same = f.read() == shown
            print(f"[22] --show on {show_names[0]}: {len(drawn)} frames drawn into vis/; its XML "
                  f"{'the same bytes as' if same else 'DIFFERENT from'} the prefetched run's on "
                  "the same video (the same seeded weights and frames)")
        del predictor, res
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 23-25: the Swin and ViTAEv2 trunks, video pretraining, the freeze policies
# ---------------------------------------------------------------------------

SWIN_OPTS = ["MODEL.BACKBONE.NAME", "build_swin_backbone"]
VITAE_OPTS = ["MODEL.BACKBONE.NAME", "build_vitaev2_backbone"]
# phase 23's runs: (label, trunk options, production configuration); Swin-S for one clip
TRUNK_RUNS = [
    ("Swin-T f32", SWIN_OPTS + ["MODEL.SWIN.TYPE", "tiny"], False),
    ("Swin-T bf16 + I420", SWIN_OPTS + ["MODEL.SWIN.TYPE", "tiny"], True),
    ("Swin-S f32", SWIN_OPTS + ["MODEL.SWIN.TYPE", "small"], False),
    ("ViTAEv2-S f32", VITAE_OPTS, False),
    ("ViTAEv2-S bf16 + I420", VITAE_OPTS, True),
]
DS_TEST_HW = (1280, 2276)  # DSText's test size (configs/GoMatching_DSText.yaml)
VIDEO_OPTS = ["MODEL.META_ARCHITECTURE", "TransformerPureVideoDetector"]
N_VIDEO_STEPS = 3  # phase 24's pretraining steps per trunk
# phase 25: one step's decoupled decay, lr * wd, at WEIGHT_DECAY 1 and no warm-up: 5e-5 of
# the spotter (BASE_LR 5e-5) and 5e-6 of a trainable trunk (BACKBONE_MULTIPLIER 0.1),
# hundreds of f32 ulps; the default 1e-4 with warm-up would move nothing a float can hold
FREEZE_OPTS = ["SOLVER.WEIGHT_DECAY", "1.0", "SOLVER.WARMUP_ITERS", "0",
               "SOLVER.CHECKPOINT_PERIOD", "1"]
DECAY_ULPS = 2  # a decayed entry within 2 f32 ulps of p * (1 - lr * wd)


def profiled_step(torch, fn, tag, shares=()):
    """One call of ``fn`` under torch.profiler: its wall, the device's busy time and share,
    and the device time of each (label, kernel name prefix) of ``shares``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = device_rows(torch, prof)
    if not rows:
        print(f"{tag} profiler: no device time recorded (not measured)")
        return
    busy = sum(r[0] for r in rows) / 1e3
    print(f"{tag} profiled step: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f}% of wall; profiler on)")
    for t_us, n, key in rows[:6]:
        print(f"{tag}   {t_us / 1e3:9.3f} ms {100 * t_us / 1e3 / busy:5.1f}% x{n:<5d} {key[:80]}")
    for label, prefix in shares:
        us = sum(t_us for t_us, _, key in rows if key.startswith(prefix))
        n = sum(c for _, c, key in rows if key.startswith(prefix))
        print(f"{tag}   {label}: {us / 1e3:.3f} ms in {n} launches, "
              f"{100 * us / 1e3 / busy:.1f}% of the step's device time")


def phase_trunks(torch, da):
    """Phase 23: GoMatching ICDAR15 on the Swin-T/S and ViTAEv2-S trunks through
    ``VideoPredictor`` at full width (seeded random weights, threshold 0.05, phase 4's
    frames), in f32 and in the production configuration: the spot with the kernels against
    the plain samplers (ATOL_PATH in f32, PATH_ULPS in bf16), B1 and B2 launched ENC_LAYERS
    and DEC_LAYERS times a spot batch and nothing else, XML/JSON parsed back (``phase_main``),
    device time per clip and peak memory; then one ViTAEv2-S spot batch at DSText's
    1280x2276 and its peak memory."""
    import gomatching_tpu_torch.models.spotter as spotter_mod
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor

    for label, opts, prod in TRUNK_RUNS:
        cfg = setup_eval_cfg(CONFIG, ["MODEL.WEIGHTS", "''", "MODEL.TRANSFORMER.INFERENCE_TH_TEST",
                                      "0.05", "SEED", "0", *opts, *(PROD_OPTS if prod else ())])
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        predictor = VideoPredictor(cfg)
        t = cfg.MODEL.TRANSFORMER
        enc, dec = (da.ENCODER_BF16, da.QUERIES_BF16) if prod else (da.ENCODER, da.QUERIES)
        print(f"[23] {label}: {CONFIG} with {' '.join(opts)}"
              + (f" {' '.join(PROD_OPTS)}" if prod else ""))
        phase_main(torch, predictor, da, "[23]", {enc: t.ENC_LAYERS, dec: t.DEC_LAYERS})
        peak = torch.cuda.max_memory_allocated()
        rows, wall = phase_profile(torch, predictor, "[23]")
        busy = sum(r[0] for r in rows) / 1e3
        print(f"[23] {label}: device time per {N_FRAMES}-frame clip "
              + (f"{busy:.1f} ms, busy {100 * busy / (wall * 1e3):.1f}% of the profiled wall"
                 if rows else "not measured")
              + f"; peak memory {peak / 2**30:.2f} GiB over the main path's runs")
        if prod:
            trunk_bf16_spot_vs_plain(torch, predictor, da, label)
        else:
            spotter_errors(torch, "[23]", predictor.model, {
                "kernels": contextlib.nullcontext,
                "plain": lambda: patched(
                    spotter_mod, ms_deform_attn_encoder=da.ms_deform_attn_encoder_plain,
                    ms_deform_attn_queries=da.ms_deform_attn_queries_plain)})
        if label.startswith("ViTAEv2"):
            vitae_peak(torch, predictor, label)
        del predictor
        torch.cuda.empty_cache()


def trunk_bf16_spot_vs_plain(torch, predictor, da, label):
    """Phase 23's bf16 spot with the kernels against the plain bf16 samplers, as phase 18's
    (the encoder memory, then the decoder from the kernels' proposals), and three more things:
    each of its sampler calls against the plain bf16 sampler on that call's own inputs, every
    element within one bf16 ulp (phase 17's check); the same path with the plain samplers
    whose every output is moved one bf16 ulp at a seeded half of its elements (the drift
    that one rounding of each call's output alone gives this configuration); and each output's
    drift against max(PATH_ULPS, 2 x that one-ulp drift). PATH_ULPS was set on the ResNet-50
    spotter (phase 18); other trunks feed the decoder other features, and its six
    refinements of the sampling points amplify a call's rounding by another factor."""
    import gomatching_tpu_torch.models.spotter as spotter_mod

    model = predictor.model
    spotter = model.detection_transformer
    dtype = model.compute_dtype
    imgs = production_frames(torch, predictor)
    kernels = {"enc": spotter_mod.ms_deform_attn_encoder,
               "dec": spotter_mod.ms_deform_attn_queries}
    plains = {"enc": da.ms_deform_attn_encoder_plain_bf16,
              "dec": da.ms_deform_attn_queries_plain_bf16}
    calls = []
    g = torch.Generator(device="cuda").manual_seed(7)

    def recorded(kind):
        def fn(*args):
            out = kernels[kind](*args)
            calls.append((kind, args, out))
            return out
        return fn

    def nudged(kind):
        def fn(*args):
            out = plains[kind](*args)
            move = torch.rand(out.shape, generator=g, device=out.device) < 0.5
            sign = torch.where(torch.rand(out.shape, generator=g, device=out.device) < 0.5,
                               -1.0, 1.0)
            step = bf16_ulp(torch, out) * sign * move
            return (out.float() + step).to(torch.bfloat16)
        return fn

    def route(name):
        if name == "kernels":
            return patched(spotter_mod, ms_deform_attn_encoder=recorded("enc"),
                           ms_deform_attn_queries=recorded("dec"))
        if name == "plain":
            return patched(spotter_mod, ms_deform_attn_encoder=plains["enc"],
                           ms_deform_attn_queries=plains["dec"])
        return patched(spotter_mod, ms_deform_attn_encoder=nudged("enc"),
                       ms_deform_attn_queries=nudged("dec"))

    def run(name, enc=None, refs=None):
        with route(name), torch.no_grad():
            if enc is None:
                feats, pos = model.features(imgs.to(dtype))
                return spotter.encode(feats, [p.to(dtype) for p in pos], None)
            return spotter.decode(enc, refs)

    enc = {n: run(n) for n in ("kernels", "plain", "nudged")}
    with torch.no_grad():
        refs = spotter.select_proposals(*spotter.encoder_proposals(enc["kernels"]))
        enc_p = spotter.select_proposals(*spotter.encoder_proposals(enc["plain"]))
    # every decoder from the kernels' memory and proposals, as phase 18's
    out = {n: run(n, enc["kernels"], refs) for n in ("kernels", "plain", "nudged")}
    for kind, args, got in calls:
        check_one_ulp(torch, f"[23] {label} {kind} call", got, plains[kind](*args))
    print(f"[23] {label}: each of the spot's {len(calls)} sampler calls within one bf16 ulp of "
          "the plain bf16 sampler on its own inputs")
    over = []
    pairs = {"encoder memory": tuple(enc[n]["memory"] for n in ("kernels", "plain", "nudged")),
             **{k: (v, out["plain"][k], out["nudged"][k]) for k, v in out["kernels"].items()
                if torch.is_tensor(v)}}
    for k, (a, b, c) in pairs.items():
        top = b.float().abs().max()
        ulp = bf16_ulp(torch, top).item()
        drift = (a.float() - b.float()).abs().max().item() / ulp
        noise = (c.float() - b.float()).abs().max().item() / ulp
        limit = max(PATH_ULPS, 2 * noise)
        print(f"[23] {label} bf16 spotter {k}: max|kernels-plain| {drift:.2f} bf16 ulps of its max "
              f"{top.item():.3e}; plain with each call's output moved one ulp {noise:.2f}; limit "
              f"{limit:.2f}")
        if not (math.isfinite(drift) and drift <= limit):
            over.append(f"{k} by {drift:.2f} ulps (limit {limit:.2f})")
    check(not over, f"[23] {label}: kernels and plain differ beyond their limit: {over}")
    print(f"[23] {label}: top-{spotter.num_queries} proposals of the kernels' and the plain "
          f"memory {'identical' if torch.equal(refs, enc_p) else 'DIFFERENT'}")


def vitae_peak(torch, predictor, label):
    """One spot batch (TPU.SPOT_BATCH frames) at DSText's 1280x2276: the peak memory of the
    global attention of ViTAEv2's stage 3 (80 x 143 tokens)."""
    model = predictor.model
    n = predictor.spot_batch
    g = torch.Generator().manual_seed(4)
    imgs = (torch.rand(n, *DS_TEST_HW, 3, generator=g) * 4 - 2).cuda()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    with torch.no_grad():
        out = model.spot(imgs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(out["pred_logits"].float()).all()), f"[23] {label} at DSText: "
          "non-finite logits")
    hw3 = [-(-s // 16) for s in DS_TEST_HW]
    print(f"[23] {label} spot batch of {n} frames at {DS_TEST_HW[0]}x{DS_TEST_HW[1]} (stage 3 "
          f"{hw3[0]}x{hw3[1]} = {hw3[0] * hw3[1]} tokens, global attention): peak memory "
          f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the weights and "
          f"inputs), {wall * 1e3:.1f} ms")
    del out, imgs


def video_step_inputs(torch, cfg):
    """The first clip of the video loader over ``chip_smoke_tracker`` at the config's
    training size, uint8 on its padded canvas with each frame's true size, and its targets."""
    from gomatching_tpu_torch.data.loader import build_train_loader
    from gomatching_tpu_torch.engine.pretrain import build_video_spotter_targets
    from gomatching_tpu_torch.train_net import normalize_clip

    t = cfg.MODEL.TRANSFORMER
    sample = next(iter(build_train_loader(cfg)))
    images, frame_hw = normalize_clip(sample, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, raw=True)
    return images, frame_hw, build_video_spotter_targets(sample, cfg.TPU.MAX_GT, t.NUM_POINTS,
                                                         t.VOC_SIZE)


def phase_video_pretrain(torch, da, tmp):
    """Phase 24: video spotter pretraining (TransformerPureVideoDetector) through
    ``train_net.main`` at INPUT.TRAIN_SIZE 1280 on phase 16's synthetic videos: N_VIDEO_STEPS
    steps with ResNet-50 and with Swin-T (SWIN.DROP_PATH_RATE 0.2), each clip on a padded
    canvas with its frames' true sizes, finite losses, B1 and B3 launched ENC_LAYERS +
    DEC_LAYERS times a step and nothing else, the checkpoints loading back strictly; then one
    step with the kernels against the same step with the plain samplers (ResNet-50; losses,
    matches and top-k, per-parameter gradients at phase 7's tolerances) and B3 at the masked
    encoder's shape (Lq = S) against its plain version and a float64 oracle, with its time
    and bound. Returns B3's record at that shape."""
    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.engine.checkpoint import load_checkpoint
    from gomatching_tpu_torch.models.gomatching import build_pretrain_model
    from gomatching_tpu_torch.weights import load_weights

    base = ["MODEL.WEIGHTS", "''", "SEED", "1", "DATASETS.TRAIN", "('chip_smoke_tracker',)",
            "SOLVER.CHECKPOINT_PERIOD", str(N_VIDEO_STEPS), *VIDEO_OPTS]
    for label, opts in (("ResNet-50", []),
                        ("Swin-T", SWIN_OPTS + ["MODEL.SWIN.DROP_PATH_RATE", "0.2"])):
        out_dir = os.path.join(tmp, f"video_{label}")
        argv = ["--config-file", CONFIG, "--task", "spotter", "--max-iter", str(N_VIDEO_STEPS),
                "--opts", *base, *opts, "OUTPUT_DIR", out_dir]
        cfg = setup_train_cfg(CONFIG, argv[argv.index("--opts") + 1:])
        t = cfg.MODEL.TRANSFORMER
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        da.reset_launch_counts()
        history = train_net.main(argv)
        torch.cuda.synchronize()
        counts = dict(da.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        layers = t.ENC_LAYERS + t.DEC_LAYERS
        want = {**{k: 0 for k in counts}, da.QUERIES: layers * N_VIDEO_STEPS,
                da.QUERIES_BWD: layers * N_VIDEO_STEPS}
        check(counts == want, f"[24] {label}: launches {counts}, expected {want}")
        check(len(history) == N_VIDEO_STEPS
              and all(math.isfinite(h["total_loss"]) for h in history),
              f"[24] {label}: losses {[h['total_loss'] for h in history]}")
        ckpt = os.path.join(out_dir, "checkpoints", f"spotter_{N_VIDEO_STEPS:07d}.pth")
        load_weights(build_pretrain_model(cfg), load_checkpoint(ckpt))
        steps = sorted(h["step_s"] * 1e3 for h in history[1:])
        print(f"[24] video pretraining, {label}: {N_VIDEO_STEPS} steps, frames "
              f"{[h['frames'] for h in history]} on canvases {[h['image_hw'] for h in history]}, "
              f"losses {[round(h['total_loss'], 4) for h in history]}; launches "
              f"{ {k: v for k, v in counts.items() if v} }; checkpoint loads back strict; "
              f"steps 2-{N_VIDEO_STEPS} {', '.join(f'{s:.1f}' for s in steps)} ms (data "
              f"{', '.join(f'{h['data_s'] * 1e3:.1f}' for h in history[1:])} ms); peak memory "
              f"{peak / 2**30:.2f} GiB")
    return video_step_ab(torch, da, setup_train_cfg(CONFIG, base))


def video_step_ab(torch, da, cfg):
    """Phase 24's kernel-vs-plain step and B3 at Lq = S (see ``phase_video_pretrain``)."""
    import gomatching_tpu_torch.models.spotter as spotter_mod
    from gomatching_tpu_torch.engine.pretrain import SpotterPretrainer
    from gomatching_tpu_torch.models.spotter import MSDeformAttn

    trainer = SpotterPretrainer(cfg, generator=torch.Generator().manual_seed(1))
    # small random offset and attention kernels move the samples off the grid lines (phase 7)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for mod in trainer.model.modules():
            if isinstance(mod, MSDeformAttn):
                for lin, scale in ((mod.sampling_offsets, 0.05), (mod.attention_weights, 0.1)):
                    lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * scale)
    images, frame_hw, targets = video_step_inputs(torch, cfg)
    imgs, tg = trainer.to_device(images, targets, frame_hw)
    hw = trainer.image_hw(frame_hw)
    spotter = trainer.model.detection_transformer
    named = dict(trainer.model.named_parameters())
    calls, topk = [], {}
    saved_bwd = da.ms_deform_attn_queries_backward

    def watch_bwd(*args):
        out = saved_bwd(*args)
        calls.append((args, out))
        return out

    def select(enc_class, enc_coords):
        topk[tag] = torch.sort(enc_class, dim=1, descending=True,
                               stable=True).indices[:, :spotter.num_queries]
        return type(spotter).select_proposals(spotter, enc_class, enc_coords)

    spotter.select_proposals = select
    results = {}
    try:
        for tag in ("kernels", "plain"):
            if tag == "kernels":
                da.ms_deform_attn_queries_backward = watch_bwd
                da.reset_launch_counts()
                losses, matches = trainer.forward_backward(imgs, tg, hw)
                counts = dict(da.launch_counts)
                da.ms_deform_attn_queries_backward = saved_bwd
            else:
                with patched(spotter_mod, ms_deform_attn_queries=da.ms_deform_attn_queries_plain):
                    losses, matches = trainer.forward_backward(imgs, tg, hw)
            results[tag] = ({k: v.item() for k, v in losses.items()}, matches,
                            {n: p.grad.detach().double().clone() for n, p in named.items()
                             if p.grad is not None})
    finally:
        da.ms_deform_attn_queries_backward = saved_bwd
        del spotter.select_proposals
    (lk, mk, gk), (lp, mp, gp) = results["kernels"], results["plain"]
    t = cfg.MODEL.TRANSFORMER
    layers = t.ENC_LAYERS + t.DEC_LAYERS
    check(counts == {**{k: 0 for k in counts}, da.QUERIES: layers, da.QUERIES_BWD: layers},
          f"[24] step launches {counts}")
    check(torch.equal(topk["kernels"], topk["plain"]), "[24] the plain step chose other top-k")
    for k in mk:
        check(torch.equal(mk[k], mp[k]), f"[24] matches {k} differ")
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp)
    check(loss_err <= RTOL_LOSS, f"[24] losses differ by {loss_err} (relative)")
    check(set(gk) == set(gp), "[24] different parameters got gradients")
    l2 = {n: ((gk[n] - gp[n]).norm() / gp[n].norm().clamp(min=1e-30)).item() for n in gp}
    mx = {n: ((gk[n] - gp[n]).abs().max() / gp[n].abs().max().clamp(min=1e-30)).item()
          for n in gp}
    modules = {}
    for n in gp:
        top = n.split(".")[0] if not n.startswith("detection_transformer.transformer.") else \
            ".".join(n.split(".")[:4])
        modules.setdefault(top, [0.0, 0.0])
        modules[top][0] += gk[n].norm().item() ** 2
        modules[top][1] += gp[n].norm().item() ** 2
    print(f"[24] masked video step on {tuple(imgs.shape)} (true sizes "
          f"{sorted({tuple(map(int, r)) for r in frame_hw})}), kernels vs plain: {len(mk)} "
          f"matches and the top-{spotter.num_queries} identical, losses max rel err "
          f"{loss_err:.3e} (rtol {RTOL_LOSS}), total {lk['total_loss']:.4f}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    print("[24]   gradient norm per module (kernels / plain): " + "; ".join(
        f"{m} {a ** 0.5:.4e} / {b ** 0.5:.4e}" for m, (a, b) in modules.items()))
    for label, errs, tol in (("|dg|_2/|g|_2", l2, RTOL_GRAD), ("max|dg|/max|g|", mx, RTOL_GRAD_MAX)):
        worst = max(errs, key=errs.get)
        print(f"[24]   {label} kernels vs plain, worst {worst} {errs[worst]:.3e} (limit {tol})")
        check(errs[worst] <= tol, f"[24] gradient of {worst} differs by {errs[worst]}")

    # B3 at the masked encoder's shape: every encoder call of the step (Lq = S) against the
    # plain backward in f32 and in f64 on its own inputs
    S = sum(h * w for h, w in calls[0][0][1])
    enc_calls = [c for c in calls if c[0][2].shape[1] == S]
    check(len(enc_calls) == t.ENC_LAYERS, f"[24] {len(enc_calls)} B3 calls at Lq = S")
    worst = {}
    for args, got in enc_calls:
        want32 = da.ms_deform_attn_queries_plain_backward(*args)
        want64 = da.ms_deform_attn_queries_plain_backward(
            *(a.double() if torch.is_tensor(a) else a for a in args))
        for name, k_, p_, e_ in zip(("value", "loc", "attn"), got, want32, want64):
            scale = e_.abs().max().clamp(min=1e-30)
            ek = ((k_.double() - e_).abs().max() / scale).item()
            ep = ((p_.double() - e_).abs().max() / scale).item()
            ekp = rel_err(k_, p_)
            w = worst.setdefault(name, [0.0, 0.0, 0.0])
            w[0], w[1], w[2] = max(w[0], ek), max(w[1], ep), max(w[2], ekp)
        del want32, want64
    print(f"[24] B3 at the masked encoder's shape (B = {enc_calls[0][0][0].shape[0]}, "
          f"Lq = S = {S}), {len(enc_calls)} calls of the step, max|err|/max|f64| kernel; plain "
          "f32 (and kernel vs plain f32): " + "; ".join(
              f"d{n} {ek:.2e}; {ep:.2e} ({ekp:.2e})" for n, (ek, ep, ekp) in worst.items()))
    for n, (ek, ep, ekp) in worst.items():
        check(ek <= max(F64_RATIO * ep, RTOL_BWD), f"[24] B3 d{n} is {ek} off the f64 "
              f"gradient, plain f32 {ep}")
        if n != "loc":
            check(ekp <= RTOL_BWD, f"[24] B3 d{n} differs from plain by {ekp} (relative)")
    # dLoc jumps where a sample sits on a grid line and the two versions floor its pixel
    # coordinate to other cells: held to RTOL_BWD away from the lines (1e-3 px, f64)
    near, total, loc_err = 0, 0, 0.0
    for args, got in enc_calls:
        want = da.ms_deform_attn_queries_plain_backward(*args)[1]
        shapes, loc = args[1], args[2].double()
        wh = torch.tensor([[w, h] for h, w in shapes], dtype=loc.dtype, device=loc.device)
        px = loc * wh[:, None, :] - 0.5
        on_line = ((px - px.round()).abs() < 1e-3).any(-1, keepdim=True).expand_as(px)
        scale = want.abs().max().clamp(min=1e-30)
        loc_err = max(loc_err, ((got[1] - want).abs()[~on_line].max() / scale).item())
        near += int(on_line[..., 0].sum().item())
        total += on_line[..., 0].numel()
        del want
    print(f"[24] B3 dloc kernel vs plain away from grid lines {loc_err:.2e} (rtol {RTOL_BWD}; "
          f"{near} of {total} samples within 1e-3 px of a line, where the derivative jumps)")
    check(loc_err <= RTOL_BWD, f"[24] B3 dloc differs from plain by {loc_err} off the lines")
    args = enc_calls[-1][0]
    value, shapes, loc, attn, dout = args
    ms = cuda_time_ms(lambda: da.ms_deform_attn_queries_backward(*args))
    dev_us, n_rec = launch_us(torch, lambda: da.ms_deform_attn_queries_backward(*args),
                              f"{da.QUERIES_BWD}_kernel")
    plain_ms = cuda_time_ms(lambda: da.ms_deform_attn_queries_plain_backward(*args), iters=3,
                            warmup=1)
    Bq = value.shape[0]
    v_bytes, taps = value_reads(torch, loc, S, D, shapes)
    samples = Bq * S * M * L * P
    got = enc_calls[-1][1]
    b_ms, b_by = bound(v_bytes + nbytes(loc, attn, dout, *got), samples * (30 + D) + taps * 4 * D)
    torch.cuda.synchronize()
    profiled_step(torch, lambda: trainer.step(images, targets, frame_hw), "[24]",
                  [("B3", "ms_deform_attn_queries_bwd_kernel("),
                   ("B1", "ms_deform_attn_queries_kernel(")])
    print(f"[24] B3 at Lq = S: kernel {ms:.4f} ms a call (device {fmt_us(dev_us)} a launch over "
          f"{n_rec} launches the profiler recorded), plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {v_bytes / 1e6:.1f} MB of value rows "
          f"touched of {nbytes(value) / 1e6:.1f} MB, {taps} in-range taps) at B = {Bq}, "
          f"{Bq * S} queries")
    del trainer, calls, enc_calls


def phase_freeze(torch, da, tmp):
    """Phase 25: two tracker iterations through ``train_net.main`` on phase 16's dataset
    under FREEZE_TYPE '' and under Backbone with MODEL.PRECISION bfloat16, a checkpoint after
    each: every trainable spotter tensor after the first step equals p * (1 - lr * wd) at its
    group's rate (zero gradient behind the detached spot, decoupled decay) within DECAY_ULPS,
    the frozen trunk keeps its f32 originals, roi_heads moved; B1 (f32: the spotter is f32
    under both) launched ENC_LAYERS + DEC_LAYERS times a clip and nothing else;
    ``OUTPUT_DIR/tb`` holds an event file."""
    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.engine.checkpoint import load_checkpoint
    from gomatching_tpu_torch.data.loader import build_train_loader
    from gomatching_tpu_torch.engine.optim import build_schedule
    from gomatching_tpu_torch.engine.train import Trainer, freeze_partition
    from gomatching_tpu_torch.models.gomatching import build_model
    from gomatching_tpu_torch.utils.synthetic import make_targets
    from gomatching_tpu_torch.weights import canonical_key, init_state_dict

    for label, opts in (("FREEZE_TYPE ''", ["MODEL.FREEZE_TYPE", "''"]),
                        ("FREEZE_TYPE Backbone, bf16",
                         ["MODEL.FREEZE_TYPE", "Backbone", "MODEL.PRECISION", "bfloat16"])):
        out_dir = os.path.join(tmp, f"freeze_{len(opts)}")
        argv = tracker_argv(CONFIG, out_dir, 2, [*FREEZE_OPTS, *opts])
        cfg = setup_train_cfg(CONFIG, argv[argv.index("--opts") + 1:])
        t, s = cfg.MODEL.TRANSFORMER, cfg.SOLVER
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        da.reset_launch_counts()
        history = train_net.main(argv)
        torch.cuda.synchronize()
        counts = dict(da.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        want = {**{k: 0 for k in counts}, da.QUERIES: 2 * (t.ENC_LAYERS + t.DEC_LAYERS)}
        check(counts == want, f"[25] {label}: launches {counts}, expected {want}")
        check(all(math.isfinite(h["total_loss"]) for h in history), f"[25] {label}: losses")
        init = train_net.init_rescoring_from_classifier(
            init_state_dict(cfg, torch.Generator().manual_seed(1)))
        ckpt = load_checkpoint(os.path.join(out_dir, "checkpoints", "model_0000001_rescore.pth"))
        lr0 = build_schedule(cfg)(0)
        frozen_trunk = "Backbone" in opts
        trainable = {canonical_key(n) for n in freeze_partition(build_model(cfg),
                                                                cfg.MODEL.FREEZE_TYPE)}
        n_decayed, worst, n_zero = 0, 0.0, 0
        for k, p0 in init.items():
            p1 = ckpt[k]
            check(p1.dtype == p0.dtype, f"[25] {label}: {k} saved as {p1.dtype}")
            if k.startswith("roi_heads."):
                continue
            if canonical_key(k) not in trainable:
                check(torch.equal(p1, p0), f"[25] {label}: the frozen {k} moved")
                continue
            lr = lr0 * (s.BACKBONE_MULTIPLIER if k.startswith("backbone.") else 1.0)
            decayed = p0 * (1 - lr * s.WEIGHT_DECAY)
            ulps = ((p1 - decayed).abs() / (torch.finfo(torch.float32).eps * p0.abs()
                                            ).clamp(min=1e-38)).max().item()
            worst = max(worst, ulps)
            check(ulps <= DECAY_ULPS, f"[25] {label}: {k} is {ulps:.2f} ulps from p*(1-lr*wd)")
            n_decayed += int(not torch.equal(p1, p0))
            n_zero += int(not p0.any())
        moved_head = sum(not torch.equal(ckpt[k], init[k]) for k in init if k.startswith("roi_heads."))
        check(n_decayed > 0 and moved_head > 0, f"[25] {label}: {n_decayed} spotter tensors "
              f"decayed, {moved_head} roi_heads tensors moved")
        # one clip of the loader with synthetic GT, profiled
        trainer = Trainer(cfg, init, device=None)
        images, frame_hw = train_net.normalize_clip(next(iter(build_train_loader(cfg))),
                                                    cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                                                    raw=True)
        targets = make_targets(len(images), t.NUM_POINTS, n_gt=8)
        trainer.step(images, frame_hw, targets)  # warm-up
        profiled_step(torch, lambda: trainer.step(images, frame_hw, targets), f"[25] {label}",
                      [("B1", "ms_deform_attn_queries_kernel("),
                       ("AdamW", "void at::native::(anonymous namespace)::multi_tensor_apply")])
        del trainer
        events = [f for f in os.listdir(os.path.join(out_dir, "tb")) if "tfevents" in f]
        check(events, f"[25] {label}: no tensorboard event file in {out_dir}/tb")
        print(f"[25] tracker training, {label}: 2 iterations, losses "
              f"{[round(h['total_loss'], 4) for h in history]}, "
              f"{[round(h['step_s'] * 1e3, 1) for h in history]} ms; launches "
              f"{ {k: v for k, v in counts.items() if v} }; after step 1 {n_decayed} spotter "
              f"tensors at p * (1 - lr * wd) (lr {lr0:.3e}, wd {s.WEIGHT_DECAY}; worst "
              f"{worst:.2f} ulps; {n_zero} all-zero tensors unchanged), "
              + ("the trunk's f32 originals in the checkpoint, " if frozen_trunk else "")
              + f"{moved_head} roi_heads tensors moved; tensorboard {events[0]}; peak memory "
              f"{peak / 2**30:.2f} GiB")


# ---------------------------------------------------------------------------
# phase 26: data parallel on the card (two gloo ranks on cuda:0)
# ---------------------------------------------------------------------------

DP_RANKS = 2  # ranks of phase 26, both on cuda:0 (NCCL refuses two ranks on one card)
N_DP_STEPS = 3  # tracker iterations of each data-parallel CLI run
DP_SPOT_BATCH = 4  # TPU.SPOT_BATCH of the sharded inference: 2 frames a rank
DP_LOSS_RTOL = 1e-5  # the averaged step against the one-process step_multi
DP_SCORE_ATOL = 1e-4  # sharded against single-process detections (scores)
DP_TIMEOUT_S = 420  # a launch that outlives it fails the phase


def dp_opts(data, extra=()):
    """The opts of a phase-26 tracker run: phase 16's, the dataset by its paths (the
    spawned ranks have no registry entry)."""
    return ["MODEL.WEIGHTS", "''", "SEED", "1", "DATASETS.TRAIN", f"('{data}',)",
            "MODEL.TRANSFORMER.INFERENCE_TH_TRAIN", str(TRACK_THRESH),
            "MODEL.ASSO_HEAD.ASSO_THRESH", str(TRACK_THRESH), *extra]


def dp_clips(torch, cfg, i420):
    """The two clips of a data-parallel step: each rank's first clip of its loader, on the
    common canvas and frame count, with frame sizes and targets (``frame_valid``), on the
    I420 wire when ``i420``."""
    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.data.loader import build_train_loader
    from gomatching_tpu_torch.engine.train import encode_train_clip

    samples = [next(iter(build_train_loader(cfg, r, DP_RANKS))) for r in range(DP_RANKS)]
    t_max = max(len(s.images) for s in samples)
    canvas = tuple(int(max(max(im.shape[i] for im in s.images) for s in samples))
                   for i in (0, 1))
    clips = []
    for s in samples:
        images, hw = train_net.normalize_clip(s, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                                              raw=True, canvas=canvas, pad_t=t_max)
        if i420:
            images = encode_train_clip(images, cfg.INPUT.FORMAT)
        clips.append((images, hw, train_net.targets_from_sample(s, pad_t=t_max)))
    return clips


def dp_rank(jobs, infer_opts, xml_dir):
    """What each rank of phase 26 runs (spawned by ``parallel.launch`` on cuda:0 in a gloo
    group of DP_RANKS): per training job (label, opts of the averaged step, the two clips,
    CLI argv) one ``step_multi`` on its clip from the seeded weights, then N_DP_STEPS
    iterations through ``train_net.main`` (its Trainer recorded, for its final head);
    then the sharded inference of phase 4's frames. Returns this rank's results,
    launch counts and peak memory."""
    import torch
    import torch.distributed as dist

    import gomatching_tpu_torch.engine.train as engine_train
    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.config import setup_eval_cfg, setup_train_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.eval import annotate
    from gomatching_tpu_torch.evaluation.writer import write_video_results
    from gomatching_tpu_torch.ops import deform_attn as da
    from gomatching_tpu_torch.weights import init_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, group = dist.get_rank(), dist.group.WORLD
    out = {"rank": rank, "device": str(torch.device("cuda", torch.cuda.current_device()))}
    for label, opts, clips, argv in jobs:
        cfg = setup_train_cfg(CONFIG, opts)
        sd = train_net.init_rescoring_from_classifier(
            init_state_dict(cfg, torch.Generator().manual_seed(cfg.SEED)))
        tr = engine_train.Trainer(cfg, sd, group=group)
        da.reset_launch_counts()
        metrics = tr.step_multi([clips[rank]])
        step_counts = dict(da.launch_counts)
        head = {k: v.detach().cpu() for k, v in tr.model.roi_heads.state_dict().items()}
        del tr, sd
        torch.cuda.empty_cache()
        made = []
        real = engine_train.Trainer

        class Recorded(real):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

        engine_train.Trainer = Recorded
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            da.reset_launch_counts()
            history = train_net.main(argv)
            torch.cuda.synchronize()
        finally:
            engine_train.Trainer = real
        out[label] = {"step": metrics, "step_counts": step_counts, "head": head,
                      "history": history, "counts": dict(da.launch_counts),
                      "peak": torch.cuda.max_memory_allocated(),
                      "final": {k: v.detach().cpu() for k, v in
                                made[0].model.roi_heads.state_dict().items()}}
        del made
        torch.cuda.empty_cache()

    pred = VideoPredictor(setup_eval_cfg(CONFIG, infer_opts), group=group)
    frames = synthetic_frames()
    pred.process_video([f.copy() for f in frames[:2]])  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    da.reset_launch_counts()
    t0 = time.time()
    tracked = pred.process_video([f.copy() for f in frames])
    torch.cuda.synchronize()
    wall = time.time() - t0
    if rank == 0:
        os.makedirs(xml_dir, exist_ok=True)
        write_video_results(annotate(pred, tracked), os.path.join(xml_dir, "video_1.json"),
                            os.path.join(xml_dir, "res_video_1.xml"))
    out["infer"] = {"wall": wall, "counts": dict(da.launch_counts),
                    "peak": torch.cuda.max_memory_allocated(),
                    "frames": [{k: np.asarray(getattr(f, k)) for k in
                                ("scores", "boxes", "bd", "ctrl_points", "track_ids")}
                               for f in tracked]}
    return out


def dp_reference_step(torch, cfg, clips):
    """The one-process ``step_multi`` over both clips from the seeded weights, its
    thresholds moved into the widest gap of the middle fused scores of the clips' real
    frames (so that last-bit differences cannot move a proposal across them); returns
    the thresholds, the losses, the updated head and AdamW's first moments (float64)."""
    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.engine.train import Trainer
    from gomatching_tpu_torch.weights import init_state_dict

    sd = train_net.init_rescoring_from_classifier(
        init_state_dict(cfg, torch.Generator().manual_seed(cfg.SEED)))
    tr = Trainer(cfg, sd)
    sig = lambda x: 1 / (1 + np.exp(-x.mean(2)[..., 0]))
    fused = []
    for images, hw, tg in clips:
        host = tr.host_fields(tr.spot(images, hw))
        fused.append(np.maximum(sig(host["pred_logits"]),
                                sig(host["re_pred_logits"]))[tg["frame_valid"]].ravel())
    fused = np.sort(np.concatenate(fused))
    lo, hi = len(fused) * 3 // 10, len(fused) * 7 // 10
    i = lo + int(np.argmax(np.diff(fused[lo:hi + 1])))
    th, gap = float(fused[i] + fused[i + 1]) / 2, float(fused[i + 1] - fused[i])
    tr.train_thresh = tr.asso_thresh = th
    metrics = tr.step_multi(clips)
    named = dict(tr.model.roi_heads.named_parameters())
    moments = {k: tr.optimizer.state[p]["exp_avg"].double().cpu() for k, p in named.items()}
    head = {k: v.detach().double().cpu() for k, v in tr.model.roi_heads.state_dict().items()}
    init = {k[len("roi_heads."):]: v.double() for k, v in sd.items()
            if k.startswith("roi_heads.")}
    del tr
    torch.cuda.empty_cache()
    return th, gap, metrics, head, moments, init


def dp_head_err(head, ref, moments, lr):
    """The largest difference of an updated roi_heads tensor from the reference's, per
    tensor against its largest weight (or the LR), entries whose clipped gradient is
    below 100 AdamW eps left out, as phase 16 holds a tracker step."""
    worst, name = 0.0, None
    for k, r in ref.items():
        noise = 10 * moments[k].abs() < 100 * ADAMW_EPS
        if (~noise).any():
            err = (head[k].double() - r).abs()[~noise].max().item() / max(r.abs().max().item(), lr)
            if err > worst:
                worst, name = err, k
    return worst, name


def phase_dp(torch, da, tmp, data, card):
    """Phase 26: data-parallel tracker training and sharded inference over DP_RANKS gloo
    ranks on cuda:0 (``parallel.launch``), each rank a process of its own: per precision
    (f32; bf16 + the I420 wire) the averaged step against the one-process ``step_multi``
    of the same two clips, N_DP_STEPS iterations through ``train_net.main --num-gpus 2``
    (B1 ENC_LAYERS + DEC_LAYERS launches a step on each rank, the ranks' weights the same
    bits, rank 0's checkpoint and metrics alone), then phase 4's frames through the
    sharded ``VideoPredictor`` (TPU.SPOT_BATCH DP_SPOT_BATCH) against the single-process
    one. A rank that fails or hangs fails the phase."""
    from gomatching_tpu_torch.config import setup_eval_cfg, setup_train_cfg
    from gomatching_tpu_torch.engine.checkpoint import load_checkpoint
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.eval import annotate
    from gomatching_tpu_torch.evaluation.writer import write_video_results
    from gomatching_tpu_torch.parallel.launch import launch

    jobs, refs = [], {}
    for label, extra, b1 in (("f32", [], da.QUERIES),
                             ("bf16 + I420", TRAIN_PROD_OPTS, da.QUERIES_BF16)):
        cfg = setup_train_cfg(CONFIG, dp_opts(data, extra))
        clips = dp_clips(torch, cfg, "TPU.TRAIN_UPLOAD_FORMAT" in extra)
        th, gap, metrics, head, moments, init = dp_reference_step(torch, cfg, clips)
        refs[label] = (th, gap, metrics, head, moments, init, b1, cfg, clips)
        step_opts = dp_opts(data, extra) + ["MODEL.TRANSFORMER.INFERENCE_TH_TRAIN", repr(th),
                                            "MODEL.ASSO_HEAD.ASSO_THRESH", repr(th)]
        out_dir = os.path.join(tmp, f"dp_{len(extra)}")
        argv = ["--config-file", CONFIG, "--task", "tracker", "--num-gpus", str(DP_RANKS),
                "--max-iter", str(N_DP_STEPS), "--opts", *dp_opts(data, extra),
                "OUTPUT_DIR", out_dir, "SOLVER.CHECKPOINT_PERIOD", str(N_DP_STEPS)]
        jobs.append((label, step_opts, clips, argv))
    infer_opts = ["MODEL.WEIGHTS", "''", "MODEL.TRANSFORMER.INFERENCE_TH_TEST", "0.05",
                  "SEED", "0", "TPU.SPOT_BATCH", str(DP_SPOT_BATCH)]
    xml_dir = os.path.join(tmp, "dp_xml")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.time()
    ranks = launch(dp_rank, DP_RANKS, dist_url=f"file://{os.path.join(tmp, 'dp_rendezvous')}",
                   args=(jobs, infer_opts, xml_dir), backend="gloo", device="cuda:0",
                   timeout_s=DP_TIMEOUT_S)
    print(f"[26] {DP_RANKS} gloo ranks on {ranks[0]['device']} ({card}): the launch took "
          f"{time.time() - t0:.1f} s")

    for label, (th, gap, ref_metrics, ref_head, moments, init, b1, cfg, clips) in refs.items():
        t = cfg.MODEL.TRANSFORMER
        layers = t.ENC_LAYERS + t.DEC_LAYERS
        lr = float(cfg.SOLVER.BASE_LR) * float(cfg.SOLVER.WARMUP_FACTOR)
        a, b = (r[label] for r in ranks)
        check(a["step"] == b["step"], f"[26] {label}: the ranks' averaged losses differ")
        loss_err = max(abs(a["step"][k] - v) / max(abs(v), 1e-12) for k, v in ref_metrics.items())
        check(all(torch.equal(a["head"][k], b["head"][k]) for k in a["head"]),
              f"[26] {label}: the ranks' heads differ after the averaged step")
        head_err, worst = dp_head_err(a["head"], ref_head, moments, lr)
        moved = sum(not torch.equal(ref_head[k], init[k]) for k in ref_head)
        for r in ranks:
            want = {**{k: 0 for k in r[label]["step_counts"]}, b1: layers}
            check(r[label]["step_counts"] == want,
                  f"[26] {label}: rank {r['rank']} step launches {r[label]['step_counts']}")
        print(f"[26] {label}: the averaged step of {DP_RANKS} ranks (clips of "
              f"{[len(c[2]['gt_ids']) for c in clips]} frames, "
              f"{[int(c[2]['frame_valid'].sum()) for c in clips]} of them real, wire "
              f"{clips[0][0].shape} {clips[0][0].dtype}, true sizes "
              f"{[tuple(c[1][0].tolist()) for c in clips]}, thresholds {th:.6f} in a "
              f"gap of {gap:.2e}) against the one-process step_multi of both clips: losses "
              f"max rel err {loss_err:.3e} (rtol {DP_LOSS_RTOL}), updated roi_heads max rel "
              f"err {head_err:.3e} ({worst}; rtol {RTOL_LOSS}; {moved} of {len(ref_head)} "
              f"tensors moved), the ranks' heads the same bits; launches a rank "
              f"{ {k: v for k, v in a['step_counts'].items() if v} }")
        check(loss_err <= DP_LOSS_RTOL, f"[26] {label}: losses differ by {loss_err}")
        check(head_err <= RTOL_LOSS, f"[26] {label}: roi_heads differ by {head_err} ({worst})")

        # the CLI run: N_DP_STEPS iterations on each rank
        out_dir = next(j[3][j[3].index("OUTPUT_DIR") + 1] for j in jobs if j[0] == label)
        hist = [r[label]["history"] for r in ranks]
        for r, h in zip(ranks, hist):
            check(len(h) == N_DP_STEPS and all(math.isfinite(x["total_loss"]) for x in h),
                  f"[26] {label}: rank {r['rank']} history {[x['total_loss'] for x in h]}")
            want = {**{k: 0 for k in r[label]["counts"]}, b1: layers * N_DP_STEPS}
            check(r[label]["counts"] == want,
                  f"[26] {label}: rank {r['rank']} launches {r[label]['counts']}, expected {want}")
        check([x["total_loss"] for x in hist[0]] == [x["total_loss"] for x in hist[1]],
              f"[26] {label}: the ranks logged other averaged losses")
        check(all(torch.equal(v, b["final"][k]) for k, v in a["final"].items()),
              f"[26] {label}: the ranks' heads differ after {N_DP_STEPS} iterations")
        ckpt_dir = os.path.join(out_dir, "checkpoints")
        check(sorted(os.listdir(ckpt_dir)) == [f"model_{N_DP_STEPS:07d}_rescore.pth",
                                               f"state_{N_DP_STEPS:07d}.pth"],
              f"[26] {label}: checkpoints {sorted(os.listdir(ckpt_dir))}")
        with open(os.path.join(out_dir, "metrics.json")) as f:
            lines = f.read().splitlines()
        check(len(lines) == 1 and json.loads(lines[0])["iteration"] == N_DP_STEPS,
              f"[26] {label}: metrics.json holds {len(lines)} lines (rank 0's one expected)")
        sd = load_checkpoint(os.path.join(ckpt_dir, f"model_{N_DP_STEPS:07d}_rescore.pth"))
        check(all(torch.equal(sd["roi_heads." + k], v) for k, v in a["final"].items()),
              f"[26] {label}: the checkpoint's roi_heads are not rank 0's")
        ranks_s = ", ".join(
            f"rank {r['rank']}: " + ", ".join(
                f"{x['step_s'] * 1e3:.1f}" for x in h) + " ms/iter (data "
            + ", ".join(f"{x['data_s'] * 1e3:.1f}" for x in h) + "; waiting for the other "
            "rank's clip size " + ", ".join(f"{x['wait_s'] * 1e3:.1f}" for x in h)
            + "; all-reduce "
            + ", ".join(f"{x['phase_t']['allreduce'] * 1e3:.1f}" for x in h)
            + f"), peak {r[label]['peak'] / 2**30:.2f} GiB"
            for r, h in zip(ranks, hist))
        print(f"[26] {label}: train_net.main --num-gpus {DP_RANKS}, {N_DP_STEPS} iterations, "
              f"averaged losses {[round(x['total_loss'], 4) for x in hist[0]]}, frames a clip "
              f"{[[x['frames'] for x in h] for h in hist]}, canvases "
              f"{[x['image_hw'] for x in hist[0]]}; {ranks_s}; B1 launches a rank "
              f"{[r[label]['counts'][b1] for r in ranks]}; the ranks' weights the same bits; "
              f"rank 0's checkpoint and one metrics.json line")

    refs.clear()

    # sharded inference against the single-process predictor
    single = VideoPredictor(setup_eval_cfg(CONFIG, infer_opts))
    frames = synthetic_frames()
    single.process_video([f.copy() for f in frames[:2]])
    torch.cuda.synchronize()
    t0 = time.time()
    tracked = single.process_video([f.copy() for f in frames])
    torch.cuda.synchronize()
    wall1 = time.time() - t0
    n_batches = -(-N_FRAMES // DP_SPOT_BATCH)
    for r in ranks:
        inf = r["infer"]
        want = {**{k: 0 for k in inf["counts"]}, da.ENCODER: 6 * n_batches,
                da.QUERIES: 6 * n_batches}
        check(inf["counts"] == want, f"[26] inference: rank {r['rank']} launches {inf['counts']}")
    th = float(single.score_thresh)
    near, score_err, box_err, same = False, 0.0, 0.0, True
    for r in ranks:
        for i, (got, f) in enumerate(zip(r["infer"]["frames"], tracked)):
            if len(got["scores"]) != len(f.scores):
                extra = np.concatenate([got["scores"], f.scores])
                near |= bool((np.abs(extra - th) < DP_SCORE_ATOL).any())
                same = False
                continue
            score_err = max(score_err, float(np.abs(got["scores"] - f.scores).max(initial=0)))
            box_err = max(box_err, float(np.abs(got["boxes"] - f.boxes).max(initial=0)))
            same &= bool(np.array_equal(got["track_ids"], f.track_ids))
    check(same or near, "[26] inference: the sharded run kept other detections or ids, and no "
          f"score lies within {DP_SCORE_ATOL} of the threshold {th}")
    with tempfile.TemporaryDirectory() as d:
        write_video_results(annotate(single, tracked), os.path.join(d, "video_1.json"),
                            os.path.join(d, "res_video_1.xml"))
        with open(os.path.join(d, "res_video_1.xml")) as f1, \
                open(os.path.join(xml_dir, "res_video_1.xml")) as f2:
            xml_same = f1.read() == f2.read()
    check(sorted(os.listdir(xml_dir)) == ["res_video_1.xml", "video_1.json"],
          f"[26] inference: {sorted(os.listdir(xml_dir))}")
    if not near:
        check(score_err <= DP_SCORE_ATOL, f"[26] inference: scores differ by {score_err}")
        check(box_err <= ATOL_PATH * 1280, f"[26] inference: boxes differ by {box_err} px")
        check(xml_same, "[26] inference: the sharded run's XML differs from the single one's")
    walls = [r["infer"]["wall"] for r in ranks]
    print(f"[26] sharded inference ({CONFIG}, TPU.SPOT_BATCH {DP_SPOT_BATCH}, "
          f"{DP_SPOT_BATCH // DP_RANKS} frames a rank a batch) over {N_FRAMES} frames: "
          + ("detections and track ids identical" if same else "detections differ near the "
             "threshold (not compared)")
          + f", scores max |diff| {score_err:.3e} (atol {DP_SCORE_ATOL}), boxes {box_err:.3e} px, "
          f"XML {'identical' if xml_same else 'DIFFERENT'} to the single-process run; "
          f"{N_FRAMES / max(walls):.3f} frames/s on {DP_RANKS} ranks of one card against "
          f"{N_FRAMES / wall1:.3f} in one process; peak "
          + ", ".join(f"rank {r['rank']} {r['infer']['peak'] / 2**30:.2f} GiB" for r in ranks)
          + f"; launches a rank {[r['infer']['counts'][da.ENCODER] for r in ranks]} (B2), "
          f"{[r['infer']['counts'][da.QUERIES] for r in ranks]} (B1)")
    del single
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 27: every checkpoint form MODEL.WEIGHTS reads, and the training throughput tool
# ---------------------------------------------------------------------------


def write_checkpoint_forms(sd, cfg, tmp):
    """``sd`` as a detectron2 ``.pkl`` (protocol 2, latin1-readable, with the model zoo's
    extra keys), as a ``.pth`` whose optimizer state and iteration are numpy, and as the
    port converter's ``.npz``; returns {form: path}."""
    import pickle

    import torch

    from gomatching_tpu_torch.engine.checkpoint import save_params
    from gomatching_tpu_torch.weights import convert

    paths = {form: os.path.join(tmp, f"phase27{form}") for form in (".pkl", ".pth", ".npz")}
    with open(paths[".pkl"], "wb") as f:
        pickle.dump({"model": {k: v.numpy() for k, v in sd.items()},
                     "__author__": "Detectron2 Model Zoo", "matching_heuristics": True}, f,
                    protocol=2)
    torch.save({"model": sd, "iteration": np.int64(30000),
                "optimizer": {"param_groups": [{"lr": np.float64(5e-5)}],
                              "state": {0: {"step": np.float32(30000.0)}}}}, paths[".pth"])
    params, missing, unused = convert(sd, cfg)
    check(not missing, f"phase 27: the converter misses {missing[:5]}")
    save_params(paths[".npz"], params)
    print(f"[27] phase 4's state_dict written as .pkl / .pth / .npz: "
          + ", ".join(f"{os.path.getsize(p) / 2**20:.1f} MiB" for p in paths.values())
          + f" ({len(unused)} alias or buffer keys the .npz leaves out)")
    return paths


def phase_checkpoints(torch, da, cfg, sd, ref_tracked, ref_counts, tmp):
    """Phase 27a: phase 4's seeded state_dict in each checkpoint form loads, through
    ``model_weights`` (``MODEL.WEIGHTS``), to the same tensors bit for bit; phase 4's frames
    through ``VideoPredictor`` from the ``.pkl`` give phase 4's tracked results bit for bit,
    with phase 4's B1 / B2 launches."""
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor, model_weights
    from gomatching_tpu_torch.models.gomatching import build_model
    from gomatching_tpu_torch.weights import load_weights

    t0 = time.time()
    paths = write_checkpoint_forms(sd, cfg, tmp)
    opts = ["MODEL.TRANSFORMER.INFERENCE_TH_TEST", "0.05", "SEED", "0"]
    for form, path in paths.items():
        t1 = time.time()
        model = build_model(cfg)
        load_weights(model, model_weights(setup_eval_cfg(CONFIG, opts + ["MODEL.WEIGHTS", path])))
        got = model.state_dict()
        check(set(got) == set(sd), f"phase 27: {form} gives other keys")
        bad = [k for k in sd if got[k].dtype != sd[k].dtype or not torch.equal(got[k], sd[k])]
        check(not bad, f"phase 27: {form} loads other tensors at {bad[:5]}")
        print(f"[27] {form}: {len(got)} tensors the same bits as phase 4's "
              f"({time.time() - t1:.1f} s to read and load)")
        del model, got
    predictor = VideoPredictor(setup_eval_cfg(CONFIG, opts + ["MODEL.WEIGHTS", paths[".pkl"]]))
    torch.cuda.synchronize()
    da.reset_launch_counts()
    tracked = predictor.process_video(synthetic_frames())
    torch.cuda.synchronize()
    counts = {k: v for k, v in da.launch_counts.items() if v}
    ref_counts = {k: v for k, v in ref_counts.items() if v}
    check(counts == ref_counts, f"phase 27: launches {counts}, phase 4's {ref_counts}")
    check(len(tracked) == len(ref_tracked), "phase 27: frame count")
    fields = ("boxes", "scores", "ctrl_points", "recs", "bd", "track_ids")
    for i, (a, b) in enumerate(zip(tracked, ref_tracked)):
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            check(x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y),
                  f"phase 27: frame {i} {f} differs from phase 4's run")
        check(a.image_hw == b.image_hw, f"phase 27: frame {i} image_hw")
    n_det = sum(len(f) for f in tracked)
    print(f"[27] VideoPredictor from the .pkl over phase 4's {len(tracked)} frames: {n_det} "
          f"detections, {len({int(t) for f in tracked for t in f.track_ids})} tracks, every "
          f"field the same bits as phase 4's run; launches {counts} (phase 4's); "
          f"{time.time() - t0:.1f} s in all")
    del predictor
    torch.cuda.empty_cache()


def phase_bench_train(torch, da, card):
    """Phase 27b: ``tools/bench_train.main`` at its defaults (the tracker step, 4 frames of
    736x736, 8 timed iterations after one untimed), with every proposal passing (thresholds
    0.001), and ``--pretrain --iters 3``: finite losses, B1 (tracker: the masked encoder and
    the decoder) and B1-B4 (pretraining) launched ENC_LAYERS / DEC_LAYERS times a step and
    nothing else."""
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.tools import bench_train

    t = setup_train_cfg(CONFIG, ["MODEL.WEIGHTS", "''"]).MODEL.TRANSFORMER
    layers = t.ENC_LAYERS + t.DEC_LAYERS
    runs = (("defaults", [], {da.QUERIES: layers * 9}),
            ("every proposal passing", ["--opts", "MODEL.TRANSFORMER.INFERENCE_TH_TRAIN",
                                        str(TRACK_THRESH), "MODEL.ASSO_HEAD.ASSO_THRESH",
                                        str(TRACK_THRESH)], {da.QUERIES: layers * 9}),
            ("--pretrain --iters 3", ["--pretrain", "--iters", "3"],
             {da.ENCODER: t.ENC_LAYERS * 4, da.QUERIES: t.DEC_LAYERS * 4,
              da.ENCODER_BWD: t.ENC_LAYERS * 4, da.QUERIES_BWD: t.DEC_LAYERS * 4}))
    for label, argv, want in runs:
        torch.cuda.synchronize()
        da.reset_launch_counts()
        t0 = time.time()
        out = bench_train.main(argv)
        torch.cuda.synchronize()
        counts = {k: v for k, v in da.launch_counts.items() if v}
        (r,) = out.values()
        check(math.isfinite(r["first_loss"]) and math.isfinite(r["loss"]),
              f"phase 27: bench_train {label} losses {r['first_loss']}, {r['loss']}")
        check(counts == want, f"phase 27: bench_train {label} launches {counts}, expected {want}")
        print(f"[27] bench_train {label}: launches {counts} (expected); {time.time() - t0:.1f} s "
              f"of wall; {card}")
    torch.cuda.empty_cache()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    os.chdir(root)
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.ops import _build
    from gomatching_tpu_torch.ops import deform_attn as da
    from gomatching_tpu_torch.ops import deform_attn_fused as daf
    from gomatching_tpu_torch.ops import deform_attn_merged as dam
    from gomatching_tpu_torch.ops import deform_attn_vmem as dav
    from gomatching_tpu_torch.ops import gather_probe as gp
    from gomatching_tpu_torch.ops import onehot_g as og

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)  # as nvidia-smi gives it: name, power limit
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    builds = (("ms_deform_attn.cu", ()), ("probes.cu", ()), ("ms_deform_attn.cu", ROW0_FLAGS),
              ("ms_deform_attn.cu", NO_SCATTER_FLAGS), ("ms_deform_attn.cu", FP_WARPS8_FLAGS),
              ("probes.cu", T1_L2_FLAGS), ("probes.cu", T1_NO_COPY_FLAGS))
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc per build, all at once
        list(pool.map(lambda sf: _build.build(sf[0], flags=_build.NVCC_FLAGS + sf[1]), builds))
    print(f"[1] kernels built in {time.time() - t0:.1f} s ("
          + ", ".join(" ".join((src, *flags)) for src, flags in builds) + " in parallel)")
    phase_resources(da, dav, _build)
    phase_probe_resources(_build, gp)

    records = phase_kernels(torch, da)
    cfg = setup_eval_cfg(CONFIG, ["MODEL.WEIGHTS", "''",
                                  "MODEL.TRANSFORMER.INFERENCE_TH_TEST", "0.05", "SEED", "0"])
    t0 = time.time()
    predictor = VideoPredictor(cfg)
    print(f"[1] VideoPredictor built with seeded random weights in {time.time() - t0:.1f} s")
    phase_path(torch, predictor, da)
    t = cfg.MODEL.TRANSFORMER
    counts = phase_main(torch, predictor, da, "[4]",
                        {da.ENCODER: t.ENC_LAYERS, da.QUERIES: t.DEC_LAYERS})
    phase_profile(torch, predictor, shares=[("B2", "ms_deform_attn_encoder_kernel("),
                                            ("B1", "ms_deform_attn_queries_kernel(")])
    ref_tracked = predictor.process_video(synthetic_frames())  # phases 18 and 27's reference
    ref_sd = {k: v.detach().cpu().clone() for k, v in predictor.model.state_dict().items()}
    del predictor
    bwd_records = phase_backward(torch, da)
    phase_train_step(torch, da)
    train_counts = phase_train(torch, da)

    # GoMatching++ on the corner-merged sampler (B5)
    merged_records = phase_merged(torch, da, dam)
    cfg_pp = setup_eval_cfg(CONFIG_PP, ["MODEL.WEIGHTS", "''", "TPU.SAMPLING_IMPL", "pallas",
                                        "MODEL.TRANSFORMER.INFERENCE_TH_TEST", "0.05", "SEED", "0"])
    predictor = VideoPredictor(cfg_pp)
    check(predictor.model.roi_heads.variant == "shared", "GoMatching++ builds the shared matcher")
    phase_merged_path(torch, predictor, da, dam)
    t = cfg_pp.MODEL.TRANSFORMER
    layers = t.ENC_LAYERS + t.DEC_LAYERS
    pp_counts = phase_main(torch, predictor, da, "[11]", {da.MERGED: layers, da.MERGED_TABLE: layers})
    phase_sampler_ab(torch, predictor)
    phase_profile(torch, predictor, "[11]",
                  shares=[("B5", "ms_deform_attn_merged_kernel("),
                          ("B5's table build", "ms_deform_attn_merged_table_kernel(")])
    del predictor

    # the sampler benchmark on the footprint entries (B6a-c)
    fp_records = phase_footprint(torch, da, dav, daf, _build)
    bench_counts, bench16_counts = phase_bench(torch, da, dav)

    # the probe kernels (T1, T2) behind the port's probe tools
    probe_records = phase_probes(torch, gp, og, _build)
    probe_counts = phase_probe_tools(torch, gp, og)
    phase_gather_floor(torch, da, dam, _build)

    from gomatching_tpu_torch.data.datasets import register_dataset

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        tracker_data = write_tracker_dataset(data_dir)
        register_dataset("chip_smoke_tracker", *tracker_data)
        # GoMatching tracker training (the spotter frozen; its sampling on B1)
        f32_step = phase_tracker(torch, da, tmp)

        # the production precision path: bf16 B1/B2, then inference and tracker training
        bf16_records = phase_bf16_kernels(torch, da)
        prod_counts = phase_production(torch, da, ref_tracked)
        phase_tracker_production(torch, da, tmp, f32_step)

        # the last kernels on bf16 value: B5 with its table and B6a-c, then GoMatching++
        # production on 'pallas'
        bf16_more_records = phase_bf16_samplers(torch, da, dam, dav, daf)
        pallas_counts = phase_pallas_production(torch, da, dam)
        phase_pallas_tracker(torch, da, tmp)

        # the other corpora: GoMatching DSText, BOVText and ArTVideo through eval.main
        phase_corpora(torch, da, tmp, card)

        # the Swin and ViTAEv2 trunks, video pretraining, the other freeze policies
        phase_trunks(torch, da)
        phase_video_pretrain(torch, da, tmp)
        phase_freeze(torch, da, tmp)

        # data parallel: two gloo ranks on this card, training and sharded inference
        phase_dp(torch, da, tmp, "::".join(tracker_data), card)

        # every checkpoint form MODEL.WEIGHTS reads, and the training throughput tool
        phase_checkpoints(torch, da, cfg, ref_sd, ref_tracked, counts, tmp)
        phase_bench_train(torch, da, card)

    kernels = []
    launches = {**{n: counts[n] for n in records}, **{n: train_counts[n] for n in bwd_records},
                **{n: pp_counts[n] for n in merged_records},
                **{n: bench_counts[n] for n in fp_records},
                **{n: probe_counts[n] for n in probe_records},
                **{n: prod_counts[n] for n in bf16_records},
                **{n: (pallas_counts if n in (da.MERGED_BF16, da.MERGED_TABLE_BF16)
                       else bench16_counts)[n] for n in bf16_more_records}}
    for name, rec in [*records.items(), *bwd_records.items(), *merged_records.items(),
                      *fp_records.items(), *probe_records.items(), *bf16_records.items(),
                      *bf16_more_records.items()]:
        # each kernel's launches are those of the path that runs it: inference, the
        # pretraining's for the backwards, the sampler benchmark's for B6a-c (its bf16 run
        # for B6a-c on bf16 value), the probe tools' for T1 and T2, production inference's
        # for B1 and B2 on bf16 value, GoMatching++ production on 'pallas' for B5 and its
        # table on bf16 value
        rec = dict(rec, launches=launches[name])
        kernels.append({k: rec[k] for k in ("name", "route", "source", "replaces", "launches",
                                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
