#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`v2ce_toolbox_tpu_torch`) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-conv [--sets conv,flow,stage2,roofline] TREE [TREE ...]

The second form times the four kernels of the shared conv core (K9 and
K10 per research-model window, K11 over the probe's `quad` and `quad_s2`
layers, K12 over the `wino_pallas` shapes; bf16 and f32), K8 on all 81
taps and `FastFlowNet.cost_volume` at FastFlowNet's five levels, one
16-pair `fastflownet_pair_flow` call, and the copies K7, K15 and K16 on
the device beside `clone()` (`flow_times`), with the timing code of this
file and the package of each checkout TREE, in turns, each in its own
process with its own kernel build: two versions compared on one card
(e.g. parent, change, change, parent), each label's runs and mean against
the first TREE's. K12 is also timed on the device alone (its kernels by
torch.profiler), so a change in the wrapper's host work can be told from
one in the kernels; and the stage-2 set (`stage2_times`): K1 'slope' and
'none' on a 24-frame 260x346 chunk, K2's three main-path calls and its
grid-width call on it, K3's two main-path calls and K5's EventStream
flatten, by events and on the device, and K2w at the probes' shapes
(`window_times`, with torch.profiler's split of its payload call by
activity); and the roofline set
(`roofline_times`): K13 and K14 at k=64 and 256 on the probe grid, on the
device. `--sets` picks some of the four sets (conv, flow, stage2,
roofline; all by default).

Phases, any failure exits non-zero before the result lines:
  1. the card's name and power limit (nvidia-smi);
  2. the build of the CUDA kernels from csrc/ (one nvcc per source, all
     started together, sm_90a), timed;
  3. each kernel against its plain-torch twin on the card, on the inputs
     the stage-2 paths give it for synthetic (24, 2, 10, 260, 346) voxels
     at two densities: K1 gen_compact ('slope' and 'none'), K4 gen_pack
     ('slope' and 'none'), K2 compact_rows (the fused route's calls, the
     chain compaction at grid width P*H*W of the gen_pack route, and every
     call of the bidirectional EventStream route, its one-row side list
     included), K3 merge_sorted_rows (the fused route's calls and the
     per-frame merge of the EventStream route), and K5 append_rows (the
     EventStream flatten). Outputs must be identical. At the dense
     setting: median CUDA-event times of kernel and twin, each call's
     device ms from CUDA-graph replays, and each call's bound (the bytes it
     needs, see bound_ms, at the HBM rate); the nodes of a CUDA graph of
     each K1, K2, K3 and K5 call, the work it enqueues (K2, K3, K5: one kernel
     after the memset of its scratch; K1: at most two kernels after it),
     and the bytes K1's design moves against the voxel grid;
  4. the CLI (`cli.main`), full-width model on seeded random weights, each
     path counted (launch counters reset just before it and read just
     after; every kernel of the path must have moved): center mode on a
     33-frame 260x346 clip (median of N_CLI warm runs), the same with
     --streaming (the batch run's event total), and -t pano on a 33-frame
     260x600 clip (2 strips, the last right-aligned and trimmed to 254 px;
     the 10-bit x field), batch and --streaming. Every npz must hold
     EVENT_DTYPE records inside the frame, time-sorted;
  5. each stage-2 mode (strategies slope, none and random, pooling avg and
     weighted, bidirectional relocation, use_gen_compact=False), counted,
     on a 4-frame 260x346 chunk: the card against the CPU plain path with
     the same draws, byte-identical decoded events, events > 0; then the
     mode's stage-2 ms/chunk on the card at 24 frames;
  6. stage 1 on the card against the CPU: the full-width model on one
     16-frame 64x96 window, finite, within STAGE1_REL_TOL of the CPU
     output relative to its largest value;
  7. stage 2 alone on the dense synthetic voxels: the kernel path on the
     card against the plain path on the CPU with the same draws,
     byte-identical decoded events, and events > 0;
  8. the research stage-1 convs, K9 conv3d_3x3x3 and K10
     fused_up_concat_conv, against their plain twins on the calls one
     16-frame 260x346 window of the full-width research model makes (14 K9
     calls of 7 shapes, 2 K10 calls), in bf16 and f32 (TF32 off), within
     CONV_REL_TOL (by output dtype) of the twin relative to its largest
     output; per shape the
     median CUDA-event ms of kernel, twin and the cuDNN call computing the
     same function (`library_ms`), and the bound (FLOPs at PEAK_FLOPS or
     bytes at the HBM rate, the larger); for K10 in bf16 the live steps of
     the folded weights against the direct conv's multiply-adds, counted
     from the table the kernel's pre-pass filled (`conv3d.record_live`),
     which must equal its plain twin's (`conv3d.live_steps`), and the
     kernel's time on dense weights of the same shape (its table checked
     the same way);
  9. the research configuration end to end (V2cePipeline, bf16,
     RESEARCH), counted: K9 must launch 14 and K10 2 times per window;
     then the product `--bf16` CLI run, counted;
 10. stage 1 of the research model against the product model on the card:
     in f32 within STAGE1_REL_TOL (the phase-6 window and the clip's first
     window), and in bf16 through the bf16 fidelity gate of
     `tests/test_model_rewrites.py:119-163` on the clip's first window
     (max error <= 0.05 scale + 1e-3, BinaryMatch at 0.01 >= 0.995, LDATI
     event count ratio within 0.5% on the same draws, timestamp KS <= 0.02);
 11. the training-data path (`data/mvsec.py`) with the full-width
     FastFlowNet on seeded random weights: (a) K8 correlation against its
     twin on the five pyramid levels of one 16-pair call at 260x346, within
     CORR_REL_TOL, with kernel, twin and bound times (CUDA events around
     one call, and the device alone from CUDA-graph replays), its entry
     with FastFlowNet's 53 taps written into a wider buffer identical to
     the 81-tap kernel's planes (the channels around them untouched) and
     timed on the device, and a torch.profiler breakdown of one pair-flow
     call; (b) FastFlowNet on the
     card against the CPU on 2 pairs (TF32 off), within FLOW_REL_TOL;
     (c) the converter on a synthetic 49-frame 260x346 recording (3
     packets) with the weights from a `.pt` as `--fastflownet_ckpt` loads
     them, counted: K8 must launch 30 times, flows (16, 2, 260, 346) and
     finite, ms per packet and per pair-flow call; (d) EventPackDataset,
     iterate_batches and device_prefetch on the written packets, batch
     shapes and dtypes on the card, and the device voxelizer against the
     numpy one.
 12. the probe harness (`python -m v2ce_toolbox_tpu_torch.tools.perf_probe`)
     and its kernels: (a) against their plain twins on the card at the
     probes' full-width shapes: K11 conv3d_quad on every layer of `quad`
     and `quad_s2` (bf16 and f32, TF32 off) within CONV_REL_TOL, K12
     conv3d_wino4 on the three `wino_pallas` shapes (f32: within
     WINO_REL_TOL of the direct conv summed in f64, and of the twin plus
     the twin's own distance from it; bf16: of the twin; the 'nodot'
     ablation identical), K2w
     compact_rows(algo="window"), K7 layout_barrier and K13-K16
     identical (K2w's calls there, with and without the payload, each one
     kernel after one memset in a CUDA graph of the call, no pad or copy; its
     payload-sector floor logged beside its bound); each with kernel, twin and
     library ms (cuDNN F.conv3d for K11 and K12, clone() for the copies)
     and its bound (K12's from its Winograd FLOPs), the live steps of
     fold_s122's weights against the direct conv for the strided K11
     layers (from the kernel's table, held against the twin's, as in 8),
     and for K2w, K7 and
     K13-K16 the device ms from CUDA-graph replays (for K7, K15 and K16
     also clone()'s, and for K15 and K16 both read + write rates); for each K12 call its device ms from CUDA-graph
     replays, the port's kernels it launches, counted in a CUDA graph of
     the call (bf16: the input transform, the live-step pre-pass and the
     fused kernel, one each; f32: the input transform, the product and the
     output transform), each one's device ms by torch.profiler (a listing
     that lacks one is taken again), and the memory it takes (the allocator's peak
     rise); K13's and K14's device times must rise from k=64 to k=256, and
     at each k the ops that touch data (k/2 an element) over the device
     time must stay under the card's int32 issue rate; the SASS of their
     rounds loop (nvcc and cuobjdump on `csrc/roofline.cu` alone), counted
     by instruction a round, with ptxas's registers; (b)
     the probe CLI with all eight probes, counted: every probe kernel must
     launch, and only `wino_ablate [noinv]` may print FAILED;
 13. the v2 sampler core (geometries whose voxel ids the packed key cannot
     hold), counted, K5 and K2 in its flatten: (a) `driver.chunk_events`
     at 10 fps on 4 frames of the dense voxels for 'slope', 'none',
     'random' and 'avg', the card against the CPU plain path byte for
     byte; then every K5 and K2 call of the 24-frame chunk (12,582,912
     slots) against its plain twin, identical, and each mode's stage-2
     ms and peak memory on that chunk; (b) the ablation samplers (`ops/samplers`: baseline 'random'
     and 'even', pure slope) on 4 frames, card against CPU, byte for
     byte; (c) the center CLI at --fps 10 on the 33-frame clip, and
     --streaming with as many events; (d) the pano CLI on a 33-frame
     260x1024 clip (3 strips, x past 1000), batch and --streaming with
     as many events; (e) V2cePipeline at width 1025 refused (ValueError,
     the wire record's 10-bit x) before the model is built; (f) the port's
     `tools/stage2_eval` over all seven samplers on 2 frames of phase
     11's packets.
 14. training (`train/`, `train.main`): (a) one train step of the
     full-width V2ce3d (base 32, 4 encoders) with PatchDiscriminator2D,
     `train.main`'s default loss stack (pyramid gan ef ef_splitp
     compensation, gan_k 3), on the card and on the CPU from the same
     seeded weights and a (2, 2, 64, 96) batch, TF32 off: each log term
     (loss, d_loss and every component), the BN statistics and SN vectors,
     both nets' gradients (Adam first moments), and their parameters
     against Adam's reach, with the tolerances set out at TRAIN_CMP_SHAPE;
     (b) `python -m
     v2ce_toolbox_tpu_torch.train.main`'s `main` on the card on dummy
     260x346 packets (`data/dummy_data_gen.generate`), batch 4, seq 16,
     TRAIN_STEPS steps of one epoch, the eval with previews and
     `--record_predictions 1`, then a run resumed with `--load_dir` for one
     step: every logged value finite, the checkpoints, the preview and the
     recorder written, the resumed run starting from the saved step; the
     ms of each step (median of the warm ones) and the peak GiB; (c) the
     launch counters over (b), which must all stay 0 (the convs are
     cuDNN's; the kernels line carries each kernel's `training_launches`).
 15. the remaining models and utilities on seeded weights, counted (no
     port kernel may launch; `phase15_launches` in the kernels line): (a)
     V2ce2d (multi, base 32, 4 encoders, BN, SN) card vs CPU on a 16-frame
     64x96 window within STAGE1_REL_TOL, one train-mode forward and
     backward on both (BN statistics and SN vectors within
     TRAIN_STATE_REL_TOL), then (1, 16, 260, 346, 2) -> (1, 16, 260, 346,
     20) on the card, ms a forward and peak GiB, and render_event_frames
     of its output card vs CPU; (b) UNetPlain3D at its default widths (160
     in, 16 out, concat, BN, sigmoid), multi off and on, card vs CPU at
     64x96, then 260x346 on the card; (c) ResNetDiscriminator on (16, 260,
     346, 20), logits card vs CPU; (d) MaxPooling([16, 12]) and
     MaxPoolingX([87, 65, 1], 16) on a synthetic 262,144-node, 4-graph,
     2,097,152-edge event graph, ids, counts, perm, edges and max features
     identical to the CPU's, the float sums within GRAPH_SUM_REL_TOL; (e)
     MVSECSequence.from_arrays over a synthetic 260x346 recording (crop
     256x320, 9 bins, eval and train items), normalize_event_volume_torch
     on the card against its CPU twin and the host normalisation (apart
     only where the f32 and f64 k indices differ), scale_events card vs
     CPU on a 256x256 generator grid, identical; (f) the blurred pair
     gradient on (16, 260, 346, 1) card vs CPU, the gen_phy_att and
     time_voxel_stat_calc tools on two 260x346 packets, from_recarray on
     the card, and the native stream packer against numpy, byte for byte.
 16. data parallelism (`parallel/mesh.py`), each rank a spawned process on
     its card, `run` and `run_streaming` of the center main path on phase
     4's clip (a longer one where more than two GPUs need a window and a
     chunk each) against one rank without a mesh: (a) a world of every
     visible GPU over NCCL; (b) two ranks, NCCL on two GPUs, else gloo
     with both on cuda:0 (NCCL refuses two ranks on one device). Each
     world's npz stream and preview byte-identical to one rank's, rank 0
     alone writing, and every rank's launch counters (reset just before
     each run, read just after; joined to the counted paths as `phase 16
     ...`) showing its own K1, K2 and K3 launches; each rank's frames/s.
     (b) also runs one train step at train.main's defaults on a global
     batch of DP_TRAIN_SHAPE, 2 items a rank, held against one rank's step
     on the whole batch with phase 14's tolerances, and the two ranks'
     states (parameters, BN statistics, SN vectors, Adam moments, the
     discriminator) bit for bit against each other; (c) train.main over
     every visible GPU, 2 steps and the eval on phase 14's packets, each
     rank's ms a step. A rank that fails or outlives DP_WALL_S fails the
     phase.
 17. the probe harness's 24 stage-1 and stage-2 probes (`probes_stage1`,
     `probes_stage2`: the sampler's phases, sorts, the flatten, the fused
     wire path's steps, generation, the strategies, bf16 fidelity, the
     matmul, copy and conv rooflines; the V2ce3d forward per configuration
     and batch, K9 and K10 against cuDNN), each once at its JAX shapes
     through `perf_probe.main` with N_PROBE17_ITERS timed runs a call,
     counted: every kernel the probe names (its `KERNELS`) must launch, no
     line may print FAILED, every number it returns must be finite (None
     only where it prints "not applicable"), and K9's
     `pallas_conv` rel_err (from the f64 sum of the same values) within
     CONV_REL_TOL (TF32 off); each probe's seconds go into the kernels
     line's `probe_seconds`. Then torch.profiler over one fused stage-2
     window (`sample_rows` and `driver._flatten_rows` on the probes'
     voxels): wall and device-busy ms, the top kernels, and the host's
     kernel launches, async copies and stream syncs
     (`fused_window_profile`; not gated).
 18. the stage tools and the v2 core's binned compaction, counted: (a)
     `python -m v2ce_toolbox_tpu_torch.tools.perf_test_stage2` at its
     defaults for 'slope', 'none' and 'random' (each path's kernels must
     launch; joined to the kernels line as "perf_test_stage2 ..."), and one
     of its calls card against CPU, byte for byte; (b) `tools.speed_test`
     at its defaults in f32 and --bf16, its parameter and FLOP counts equal
     to the host's count from shapes (the meta device); (c)
     `sample_events(use_v3=False)` on PT18_FRAMES frames of the tool's
     260x346 voxels at 30 fps, its `compact_dispatch` call replayed with
     the binned route on the card and the CPU, identical, and binned
     against flat timed in turns and profiled (not gated); (d) that
     stream card against CPU, byte for byte, and its ms; (e)
     `tools.vis_stage2`'s streams on the card's draws, card against CPU
     counts, then its `main` (PNGs, or where matplotlib is missing exactly
     a SystemExit naming it). The numbers go into the kernels line's
     `stage_tools`.
 19. the stage-1 rewrites (`rewrites_phase`), counted: (a) the full-width
     V2ce3d on one 16-frame 260x346 window in every variant of
     REWRITE_VARIANTS (decoder_split, out_layout 'cm', conv_impl 'fold',
     'd2', 'd2s', 'wpack', the sub-pixel decoder's 'split', 'wfold' and
     'pfold' forms on all or the last decoders, K10 on the last two)
     within STAGE1_REL_TOL of the base model with the same weights, ms a
     window (median of 3), and in bf16 the pfold decoder alone and with
     K9 on every 3x3x3 conv within phase 10's max-error gate of the f32
     base; K10 and K9 must launch where named; (b) one train step at
     TRAIN_CMP_SHAPE with remat against one without, within phase 14's
     limits, a step of REWRITE_TRAIN with finite gradients within
     TRAIN_GRAD_REL_TOL of the base step's, and each remat setting's peak
     GiB and ms of a warm step at train.main's 4x16x260x346; (c)
     V2cePipeline center on phase 4's clip with
     `ModelConfig(subpixel_decoder=True)` and with the base model: sorted
     EVENT_DTYPE records, event counts within 0.5% of each other,
     frames/s; (d) the nine probes of the rewrites (PROBES19) as phase 17
     runs its own. The numbers go into the kernels line's `rewrites`.
The line before the last is a JSON object of per-kernel results (its
`launches` is the count of the kernel's own path, KERNEL_PATH, and
`launches_by_path` every counted path's count; K9's and K10's times are
sums over one window's calls, in bf16, K11's over the probe's layers in
bf16, K12's over the three `wino_pallas` shapes in bf16); the last is
{"ok": true, "device": {...}}.
"""

import contextlib
import ctypes
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "smoke_out")      # the clips and the CLI outputs
N_TIMED = 15
N_DEVICE = 5                               # profiled calls of a K12 device time
N_CLI = 3
LISTING_TRIES = 3                          # profiler listings of one call at most
STAGE1_REL_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM device memory
# H100 SXM dense peaks: bf16 tensor cores, and f32 on the CUDA cores (the
# f32 convs must not round to TF32)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# K9/K10 against their twins, relative to the twin's largest output, by
# output dtype: f32 sums run in another order (1e-5); a bf16 output may
# land one bf16 ulp away where an f32 sum straddles a rounding boundary
# (8e-3). K9 returns f32 in both models, K10 the compute dtype.
CONV_REL_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# K12, f32 output, relative to the reference's largest output: 1e-5. With
# f32 inputs against the direct conv summed in f64 (the exact sum, rounded
# once): the kernel measured 5.43e-06 at most over the three `wino_pallas`
# shapes on an H100, while its f32 twin, whose C-long products F(4,3)'s
# collapses (AT entries up to 8 on each axis) lift by one ulp, is 1.43e-05
# from it, so against the twin the kernel is held to 1e-5 plus the twin's
# own distance from the exact sum. With bf16 inputs against the twin, whose
# transforms round to bf16 as the kernel's do (measured 5.31e-06 at most).
# A bf16 output as the convs above.
WINO_REL_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
RESEARCH = dict(conv_impl="pallas", subpixel_decoder=True, subpixel_impl="pallas",
                subpixel_blocks=2)
CONV_PER_WINDOW = {"conv3d_3x3x3": 14, "fused_up_concat_conv": 2}
FPS, F, H, W = 30, 24, 260, 346            # the stage-2 chunk of the main path
PANO_W = 600
DEVICE = "cuda"
# the v2 sampler core: a 10 fps bin at 260x346, and a 260x1024 pano stream
# at 30 fps, whose voxel ids the packed key cannot hold
V2_FPS, V2_PANO_W = 10, 1024
V2_MODES = ("slope", "none", "random", "avg")
V2_PATH = ("append_rows", "compact_rows")
# the data path: 16-frame packets of a 49-frame recording, one pair-flow
# call of 16 pairs a direction; K8 against its twin relative to the twin's
# largest output (f32 sums in another order), the card's FastFlowNet
# against the CPU's relative to the largest |flow| (cuDNN and the CPU sum
# the convs in other orders, through five coarse-to-fine levels)
DATA_FRAMES, PAIRS = 49, 16
CORR_REL_TOL, FLOW_REL_TOL = 1e-5, 1e-4
# the probe phase: timed runs a call (fewer than N_TIMED: 17 conv layers in
# two dtypes), the probe CLI's probes and the roofline's op counts
N_PROBE_TIMED = 7
K_LO, K_HI = 64, 256
PROBE_ROWS = (144, 2048 * 89)              # the compaction probes' (rows, keys)
# phase 14, training: the card-vs-CPU step's (B, L, H, W), and train.main's
# run at the main path's 260x346 (40 packets: 32 train, 4 val, 4 test).
# Card against CPU after one step: each log term within TRAIN_LOG_REL_TOL
# of the CPU's; BN statistics and SN vectors within TRAIN_STATE_REL_TOL of
# each tensor's largest element; the Adam first moments (the gradients)
# within TRAIN_GRAD_REL_TOL of each tensor's largest, because two f32 runs
# of a ReLU net part where a pre-activation lies within rounding of 0 (one
# such position in a coarse layer moves its weight gradient by ~2% of the
# largest); every parameter within Adam's reach, 2 lr a step (an element
# whose gradient is at rounding level moves +-lr on either side), and at
# most TRAIN_PARAM_SHARE of the generator's elements moved differently by
# more than 1e-3 lr. The projection biases before a train-mode BN
# (TRAIN_DEAD_BIAS) have a gradient that is zero in exact arithmetic: their
# moments are rounding noise and are not compared.
TRAIN_CMP_SHAPE = (2, 2, 64, 96)
TRAIN_PACKETS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 40, 4, 16, 4
TRAIN_LOG_REL_TOL, TRAIN_STATE_REL_TOL, TRAIN_GRAD_REL_TOL = 1e-4, 1e-4, 1e-1
TRAIN_PARAM_SHARE = 0.01
TRAIN_DEAD_BIAS = "downsample.0.bias"
# phase 16, data parallelism: the two-rank train step's global batch
# (train.main's batch and sequence at 260x346, 2 items a rank), and each
# world's wall limit and collective timeout (s)
DP_TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, H, W)
DP_WALL_S, DP_COLLECTIVE_S = 400, 120
# (b)'s train steps on each rank: result key -> remat
DP_STEPS = {"train": False, "train_remat": True}
# phase 17, the stage-1 and stage-2 probes: timed runs a call, and the
# results a probe may leave None (the JAX option the port does not carry,
# which prints "not applicable")
N_PROBE17_ITERS = 5
PROBE17_NOT_PORTED = {"fused_dec": {("dec3", "fused-k64")}}
# phase 18, the stage tools: the frames of the v2 core's call whose
# compaction runs both routes, and the timed runs of each
PT18_FRAMES, N_PT18_TIMED = 24, 7
# the kernels `tools.perf_test_stage2` launches per strategy: 'none' keeps
# no multi pool and no over-cap row, so it needs no K2 outside the flatten
PT18_KERNELS = {"slope": ("gen_compact", "compact_rows", "merge_sorted_rows"),
                "none": ("gen_compact", "merge_sorted_rows"),
                "random": ("compact_rows", "merge_sorted_rows")}
# phase 19, the stage-1 rewrites: the variants held against the base model
# at full width on one window (`tests/test_model_rewrites.py`'s list, plus
# 'd2s' and 'wpack'), the bf16 ones through phase 10's max-error gate, the
# train step's mixed variant (decoder_split on the first two decoders,
# pfold on the last two, 'fold' on the strided convs), and the nine probes
# of the rewrites
REWRITE_VARIANTS = {
    "split": dict(decoder_split=True),
    "cm": dict(out_layout="cm"),
    "fold": dict(conv_impl="fold"),
    "d2": dict(conv_impl="d2"),
    "all": dict(decoder_split=True, out_layout="cm", conv_impl="fold"),
    "sp-split": dict(subpixel_decoder=True, subpixel_impl="split"),
    "sp-wfold": dict(subpixel_decoder=True, subpixel_impl="wfold"),
    "sp-pfold": dict(subpixel_decoder=True, subpixel_impl="pfold"),
    "sp-pfold-last1": dict(subpixel_decoder=True, subpixel_impl="pfold", subpixel_blocks=1),
    "sp-wfold-last2": dict(subpixel_decoder=True, subpixel_impl="wfold", subpixel_blocks=2),
    "sp-pallas-last2": dict(subpixel_decoder=True, subpixel_impl="pallas", subpixel_blocks=2),
    "d2s": dict(conv_impl="d2s"),
    "wpack": dict(conv_impl="wpack"),
}
REWRITE_BF16 = {"sp-pfold": (dict(subpixel_decoder=True), ()),
                "pallas + sp-pfold": (dict(conv_impl="pallas", subpixel_decoder=True),
                                      ("conv3d_3x3x3",))}
REWRITE_TRAIN = dict(decoder_split=True, conv_impl="fold", subpixel_decoder=True,
                     subpixel_blocks=2)
PROBES19 = ("wpack", "conv2d_decomp", "d2", "model_d2", "model_knockout", "boundary",
            "model_variants", "subpixel_variants", "winograd")
# phase 15, the remaining models and utilities: the V2ce2d and UNetPlain3D
# windows (frames; the card-vs-CPU comparisons run at CMP_HW, the full
# 260x346 forwards on the card alone), the ResNetDiscriminator's batch (one
# V2ce3d window's frames), the event graph (nodes over GRAPHS graphs, 64
# features, 8 edges a node) and the EventGAN recording (frames, crop, bins,
# and the noise events a frame gap that bring each volume to MVSEC-like
# counts of GAN_MIN_NONZEROS and more nonzeros, which the phase gates).
# Card against CPU: the models within STAGE1_REL_TOL of the largest output,
# their train-mode BN statistics and SN vectors within TRAIN_STATE_REL_TOL
# of each tensor's largest; the graph's ids, counts, perm, edges and max
# features identical, its float sums (atomics on the card) within
# GRAPH_SUM_REL_TOL of each tensor's largest; the image gradient within
# GRAD_REL_TOL of its largest (cuDNN may sum the 11-tap blur in another
# order); scale_events and the volume normalisation identical.
M_FRAMES, CMP_HW = 16, (64, 96)
PLAIN_IN, PLAIN_OUT = 160, 16
GRAPH_NODES, GRAPHS, GRAPH_FEATS, GRAPH_DEG = 262144, 4, 64, 8
GRAPH_POOL, GRAPH_POOL_X = [16.0, 12.0], ([87.0, 65.0, 1.0], 16)
GAN_FRAMES, GAN_CROP, GAN_BINS, GAN_NOISE = 25, (256, 320), 9, 150000
GAN_MIN_NONZEROS = 100000
GRAPH_SUM_REL_TOL, GRAD_REL_TOL = 1e-5, 1e-5

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "gen_compact": ("v2ce_toolbox_tpu_torch/csrc/gen_compact.cu",
                    "v2ce_toolbox_tpu/ops/gen_pallas.py:315"),
    "compact_rows": ("v2ce_toolbox_tpu_torch/csrc/compact_rows.cu",
                     "v2ce_toolbox_tpu/ops/compact_pallas.py:226"),
    "merge_sorted_rows": ("v2ce_toolbox_tpu_torch/csrc/merge_rows.cu",
                          "v2ce_toolbox_tpu/ops/compact_pallas.py:492"),
    "gen_pack": ("v2ce_toolbox_tpu_torch/csrc/gen_pack.cu",
                 "v2ce_toolbox_tpu/ops/gen_pallas.py:79"),
    "append_rows": ("v2ce_toolbox_tpu_torch/csrc/merge_rows.cu",
                    "v2ce_toolbox_tpu/ops/compact_pallas.py:361"),
    "conv3d_3x3x3": ("v2ce_toolbox_tpu_torch/csrc/conv3d.cu",
                     "v2ce_toolbox_tpu/ops/conv3d_pallas.py:81"),
    "fused_up_concat_conv": ("v2ce_toolbox_tpu_torch/csrc/decoder_conv.cu",
                             "v2ce_toolbox_tpu/ops/decoder_pallas.py:177"),
    "correlation": ("v2ce_toolbox_tpu_torch/csrc/correlation.cu",
                    "v2ce_toolbox_tpu/ops/correlation.py:43"),
    "compact_rows_window": ("v2ce_toolbox_tpu_torch/csrc/compact_rows.cu",
                            "v2ce_toolbox_tpu/ops/compact_pallas.py:127"),
    "layout_barrier": ("v2ce_toolbox_tpu_torch/csrc/stream_copy.cu",
                       "v2ce_toolbox_tpu/ops/barrier.py:28"),
    "conv3d_quad": ("v2ce_toolbox_tpu_torch/csrc/conv3d_quad.cu",
                    "v2ce_toolbox_tpu/ops/conv3d_quad.py:121"),
    "conv3d_wino4": ("v2ce_toolbox_tpu_torch/csrc/wino4.cu",
                     "v2ce_toolbox_tpu/ops/winograd_pallas.py:98"),
    "op_chain": ("v2ce_toolbox_tpu_torch/csrc/roofline.cu", "tools/perf_probe.py:2510"),
    "op_chain_ilp": ("v2ce_toolbox_tpu_torch/csrc/roofline.cu", "tools/perf_probe.py:2554"),
    "stream_copy": ("v2ce_toolbox_tpu_torch/csrc/stream_copy.cu", "tools/perf_probe.py:2597"),
    "stream_copy_row": ("v2ce_toolbox_tpu_torch/csrc/stream_copy.cu",
                        "tools/perf_probe.py:2626"),
}
PROBE_KERNELS = ("compact_rows_window", "layout_barrier", "conv3d_quad", "conv3d_wino4",
                 "op_chain", "op_chain_ilp", "stream_copy", "stream_copy_row")
# the phase-3 case whose time stands in the kernels line
TIMED_CASE = {"gen_compact": "gen_compact[slope]", "compact_rows": "compact_rows",
              "merge_sorted_rows": "merge_sorted_rows", "gen_pack": "gen_pack[slope]",
              "append_rows": "append_rows", "conv3d_3x3x3": "conv3d_3x3x3[bfloat16]",
              "fused_up_concat_conv": "fused_up_concat_conv[bfloat16]",
              "correlation": "correlation", "compact_rows_window": "compact_rows_window",
              "layout_barrier": "layout_barrier", "conv3d_quad": "conv3d_quad[bfloat16]",
              "conv3d_wino4": "conv3d_wino4[bfloat16]", "op_chain": "op_chain",
              "op_chain_ilp": "op_chain_ilp", "stream_copy": "stream_copy",
              "stream_copy_row": "stream_copy_row"}
CENTER_PATH = ("gen_compact", "compact_rows", "merge_sorted_rows")
RESEARCH_PATH = CENTER_PATH + tuple(CONV_PER_WINDOW)
# kernel -> the counted path whose count stands as its `launches` in the
# kernels line: the center CLI run, or the mode that reaches the kernel
KERNEL_PATH = {"gen_compact": "center CLI", "compact_rows": "center CLI",
               "merge_sorted_rows": "center CLI", "gen_pack": "mode gen_pack",
               "append_rows": "mode bidirectional", "conv3d_3x3x3": "research V2cePipeline",
               "fused_up_concat_conv": "research V2cePipeline", "correlation": "mvsec data",
               **{name: "probe CLI" for name in PROBE_KERNELS}}
# stage-2 mode -> (SamplerConfig overrides, its CLI flags or None where
# v2ce.py has no flag for it, the kernels its path launches)
MODES = {
    "slope": ({}, [], CENTER_PATH),
    "none": (dict(additional_events_strategy="none"), ["--stage2_strategy", "none"],
             CENTER_PATH),
    "random": (dict(additional_events_strategy="random"), ["--stage2_strategy", "random"],
               ("compact_rows", "merge_sorted_rows")),
    "avg": (dict(pooling_type="avg"), ["--stage2_pooling", "avg"],
            ("compact_rows", "merge_sorted_rows")),
    "weighted": (dict(pooling_type="weighted"), ["--stage2_pooling", "weighted"],
                 ("compact_rows", "merge_sorted_rows")),
    "bidirectional": (dict(bidirectional=True), None,
                      ("compact_rows", "merge_sorted_rows", "append_rows")),
    "gen_pack": (dict(use_gen_compact=False), None,
                 ("gen_pack", "compact_rows", "merge_sorted_rows")),
}


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def record_calls(modules, name, calls):
    """Record the (args, kwargs) of every call of `name` in `modules`."""
    originals = [getattr(m, name) for m in modules]

    def wrap(fn):
        def inner(*args, **kwargs):
            calls.append((args, kwargs))
            return fn(*args, **kwargs)
        return inner

    for m, fn in zip(modules, originals):
        setattr(m, name, wrap(fn))
    try:
        yield calls
    finally:
        for m, fn in zip(modules, originals):
            setattr(m, name, fn)


def flat(out):
    """A kernel output tuple, nested payload tuples flattened."""
    res = []
    for o in out:
        res.extend(o if isinstance(o, tuple) else [o])
    return res


def max_abs_err(a, b):
    fa, fb = flat(a), flat(b)
    assert len(fa) == len(fb)
    err = 0
    for x, y in zip(fa, fb):
        if x is None or y is None:               # kx of the 'none' strategy
            assert x is None and y is None
            continue
        assert x.shape == y.shape and x.dtype == y.dtype, (x.shape, y.shape)
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def nbytes(x):
    """Bytes of the tensors in x (nested lists, tuples and dicts)."""
    if hasattr(x, "element_size"):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(nbytes(y) for y in x)
    if isinstance(x, dict):
        return sum(nbytes(y) for y in x.values())
    return 0


def bound_ms(label, args, kwargs, out):
    """Least time of a call at the card's memory rate (its integer and f32
    work is far below the compute bound): the bytes the function needs.
    The generation kernels read every voxel and write their outputs once.
    The row kernels write their outputs once and read a payload word only
    where its key is kept. K2 reads every key, since a row's count of valid
    keys decides where each lands; K3 and K5 take prefix-packed rows, whose
    lengths a search finds, so they need only the kept keys."""
    moved = nbytes(out)
    if label.startswith(("gen_compact", "gen_pack")):
        return (moved + nbytes(args) + nbytes(kwargs)) / HBM_BYTES_PER_S * 1e3
    keys = args[0]
    payloads = args[1] if len(args) > 1 else kwargs.get("payloads", ())
    n_kept = int(out[2].sum())
    moved += nbytes(keys) if label.startswith("compact_rows") else n_kept * keys.element_size()
    moved += sum(n_kept * p.element_size() for p in payloads)
    return moved / HBM_BYTES_PER_S * 1e3


def cuda_ms(fn, torch):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_pair(kernel, plain, torch, n=N_TIMED):
    """Median ms of kernel and plain over n runs, in turns."""
    kernel(), plain()
    torch.cuda.synchronize()
    tk, tp = [], []
    for i in range(n):
        order = [(tp, plain), (tk, kernel)] if i % 2 else [(tk, kernel), (tp, plain)]
        for acc, fn in order:
            acc.append(cuda_ms(fn, torch))
    return statistics.median(tk), statistics.median(tp)


class Counted:
    """Runs a path with every launch counter reset just before it and read
    just after; the kernels of the path must all have moved. Keeps each
    path's own counts."""

    def __init__(self, torch, ops):
        self.torch, self.ops = torch, ops
        self.by_path = {}

    def __call__(self, path, kernels, fn, how=""):
        self.torch.cuda.synchronize()
        self.ops.reset_launches()
        out = fn()
        self.torch.cuda.synchronize()
        counts = self.ops.launch_counts()
        log(f"[launches] {path}{f' ({how})' if how else ''}: {counts}")
        missing = [k for k in kernels if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{path} never launched {missing}")
        self.by_path[path] = counts
        return out


def kernels_phase(torch, np, dev):
    """Phase 3: every kernel against its twin on the stage-2 paths' calls.
    Returns ({case: {ms, plain_ms, bound_ms}}, {kernel: max_abs_err},
    (dense voxels, their fused-route events, their draw, offsets))."""
    from v2ce_toolbox_tpu_torch.config import SamplerConfig
    from v2ce_toolbox_tpu_torch.ops import compact, gen, ldati
    from v2ce_toolbox_tpu_torch.pipeline import driver

    scfg = SamplerConfig()
    offsets = torch.from_numpy((np.arange(F) / FPS * 1e6).astype(np.int32)).to(dev)
    kw1 = dict(fps=FPS, mepv=scfg.max_events_per_voxel, vox_bits=ldati.vox_bits_of(2, H, W),
               cap_bin=scfg.cap_bin)
    kw4 = {k: v for k, v in kw1.items() if k != "cap_bin"}
    results, errs, dense = {}, {name: 0 for name in KERNELS}, None
    for density, scale in [(0.05, 1.5), (0.3, 5.0)]:
        g = torch.Generator(device=dev).manual_seed(1234)
        v = ((torch.rand((F, 2, 10, H, W), generator=g, device=dev) < density)
             * torch.rand((F, 2, 10, H, W), generator=g, device=dev) * scale).contiguous()
        draw = ldati.make_draw(0, 0, dev)
        calls = {"compact_rows": [], "merge_sorted_rows": [], "append_rows": [],
                 "compact_rows[stream]": [], "merge_sorted_rows[stream]": []}
        # the fused slope route of the center CLI: K1, K2, K3
        with record_calls([ldati, driver], "compact_rows", calls["compact_rows"]), \
                record_calls([driver], "merge_sorted_rows", calls["merge_sorted_rows"]):
            events = driver._fetch_chunk_events_fused(v, draw, offsets, F, scfg, FPS,
                                                      width=W)
        # the gen_pack route: K4, then the chain compaction at grid width
        grid = []
        with record_calls([ldati], "compact_rows", grid):
            ldati.sample_rows(v, draw, dataclasses.replace(scfg, use_gen_compact=False))
        calls["compact_rows[grid]"] = [c for c in grid if c[0][0].shape[1] == 2 * H * W]
        # the EventStream route (bidirectional): the grid path's K2 calls and
        # the per-frame K3 merge in sample_events, then K5 on the per-frame
        # buffers and the one-row side-list K2 in the flatten
        with record_calls([ldati, driver], "compact_rows", calls["compact_rows[stream]"]), \
                record_calls([ldati], "merge_sorted_rows", calls["merge_sorted_rows[stream]"]), \
                record_calls([driver], "append_rows", calls["append_rows"]):
            stream = ldati.sample_events(v, draw,
                                         dataclasses.replace(scfg, bidirectional=True))
            driver._fetch_chunk_events(stream, offsets, F, FPS, width=W)
        torch.cuda.synchronize()
        cases = [
            ("gen_compact[slope]", gen.gen_compact, gen.gen_compact_torch, [((v,), kw1)]),
            ("gen_compact[none]", gen.gen_compact, gen.gen_compact_torch,
             [((v,), dict(kw1, strategy="none"))]),
            ("gen_pack[slope]", gen.gen_pack, gen.gen_pack_torch, [((v,), kw4)]),
            ("gen_pack[none]", gen.gen_pack, gen.gen_pack_torch,
             [((v,), dict(kw4, strategy="none"))]),
            ("compact_rows", compact.compact_rows, compact.compact_rows_torch,
             calls["compact_rows"]),
            ("compact_rows[grid]", compact.compact_rows, compact.compact_rows_torch,
             calls["compact_rows[grid]"]),
            ("compact_rows[stream]", compact.compact_rows, compact.compact_rows_torch,
             calls["compact_rows[stream]"]),
            ("merge_sorted_rows", compact.merge_sorted_rows, compact.merge_sorted_rows_torch,
             calls["merge_sorted_rows"]),
            ("merge_sorted_rows[stream]", compact.merge_sorted_rows,
             compact.merge_sorted_rows_torch, calls["merge_sorted_rows[stream]"]),
            ("append_rows", compact.append_rows, compact.append_rows_torch,
             calls["append_rows"]),
        ]
        case_errs = {}
        for label, kernel, plain, cl in cases:
            if not cl:
                raise AssertionError(f"the stage-2 paths made no {label} call")
            case_errs[label] = max(max_abs_err(kernel(*a, **k), plain(*a, **k))
                                   for a, k in cl)
            name = label.split("[")[0]
            errs[name] = max(errs[name], case_errs[label])
        shapes = {label: [(tuple(a[0].shape), k) for a, k in calls[label]] for label in calls}
        log(f"[kernels] density {density} x{scale}: events {len(events)}, "
            f"max_abs_err {case_errs}, calls {shapes}")
        for label, e in case_errs.items():
            if e != 0:
                raise AssertionError(f"{label} differs from its plain twin: {e}")
        if density != 0.3:
            continue
        dense = (v, events, draw, offsets)
        for label, kernel, plain, cl in cases:
            tk = tp = tb = td = 0.0
            for a, k in cl:
                x, y = time_pair(lambda: kernel(*a, **k), lambda: plain(*a, **k), torch)
                d = graph_ms(lambda: kernel(*a, **k), torch)
                b = bound_ms(label, a, k, kernel(*a, **k))
                log(f"[time] {label} {tuple(a[0].shape)} {k}: kernel {x:.4f} ms, "
                    f"device {d:.4f} ms, plain {y:.4f} ms, bound {b:.4f} ms")
                tk, tp, tb, td = tk + x, tp + y, tb + b, td + d
            results[label] = dict(ms=tk, device_ms=td, plain_ms=tp, bound_ms=tb, calls=len(cl))
            log(f"[time] {label} per 24-frame chunk ({len(cl)} calls): kernel {tk:.4f} ms, "
                f"device {td:.4f} ms, plain {tp:.4f} ms, bound {tb:.4f} ms")
        launch_listing(torch, cases, results)
        gen_compact_bytes(v, kw1)
    return results, errs, dense


# CUgraphNodeType (cuda.h) of the nodes a listed call may make
GRAPH_NODE_TYPES = {0: "kernel", 1: "Memcpy", 2: "Memset", 3: "host", 4: "graph", 5: "empty",
                    6: "wait event", 7: "event record", 10: "mem alloc", 11: "mem free"}


class _KernelNodeParams(ctypes.Structure):
    # CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def device_activities(fn, torch):
    """What one fn call puts on the card, read from a CUDA graph of the
    call: each kernel's (mangled) name, "Memset", "Memcpy", or the node's
    type, in the graph's node order. A graph holds every piece of work the
    call enqueues, which torch.profiler's records, dropped now and then late
    in a long process, do not."""
    lib = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(lib.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        name = GRAPH_NODE_TYPES.get(kind.value, f"node type {kind.value}")
        if kind.value == 0:
            par, cname = _KernelNodeParams(), ctypes.c_char_p()
            check(lib.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(par)),
                  "cuGraphKernelNodeGetParams")
            if par.func:
                check(lib.cuFuncGetName(ctypes.byref(cname), ctypes.c_void_p(par.func)),
                      "cuFuncGetName")
            elif par.kern:
                check(lib.cuKernelGetName(ctypes.byref(cname), ctypes.c_void_p(par.kern)),
                      "cuKernelGetName")
            name = cname.value.decode() if cname.value else "unnamed kernel"
        names.append(name)
    del g
    return names


def launch_listing(torch, cases, results):
    """The card's work in each K1, K2, K3 and K5 call of phase 3
    (device_activities): a K2, K3 or K5 call must be one kernel after one
    memset (of its look-back scratch), a K1 call at most two kernels after
    one."""
    limits = {"gen_compact": 2, "compact_rows": 1, "merge_sorted_rows": 1, "append_rows": 1}
    for label, kernel, _, cl in cases:
        name = label.split("[")[0]
        if name not in limits:
            continue
        results[label]["kernel_launches_per_call"] = [
            listed_call(f"{label} {tuple(a[0].shape)}", lambda: kernel(*a, **k), limits[name],
                        torch) for a, k in cl]


def listed_call(label, fn, limit, torch):
    """The number of kernels one fn call launches (device_activities), which
    must be one to `limit` kernels after one memset, with no other kernel,
    memset, copy (a pad before the kernel would be one) or other node."""
    acts = device_activities(fn, torch)
    kernels = [x for x in acts if x not in GRAPH_NODE_TYPES.values()]
    memsets = [x for x in acts if x == "Memset"]
    log(f"[launch listing] {label}: {len(kernels)} kernel(s) {kernels}, {len(memsets)} "
        f"memset(s), {len(acts) - len(kernels) - len(memsets)} other nodes")
    if not (1 <= len(kernels) <= limit and len(memsets) == 1
            and len(acts) == len(kernels) + len(memsets)):
        raise AssertionError(f"{label} made {acts}: not 1 to {limit} kernel(s) after one "
                             "memset")
    return len(kernels)


def sector_floor(keys, pays, out, capp):
    """(ms, bytes) of the least traffic a gather of the kept payload words
    can make, at the card's memory rate: every key read, every 32-byte
    sector of the payload that holds a kept word read whole, and the
    outputs written once. `bound_ms` counts the kept payload words alone."""
    import torch

    valid = keys != 2 ** 31 - 1
    kept = valid & (torch.cumsum(valid, dim=1, dtype=torch.int32) <= capp)
    idx = torch.nonzero(kept.reshape(-1), as_tuple=True)[0]
    moved = nbytes(keys) + nbytes(out)
    for p in pays:
        sectors = torch.unique((p.data_ptr() + 4 * idx) // 32).numel()
        moved += 32 * sectors
    return moved / HBM_BYTES_PER_S * 1e3, moved


def gen_compact_bytes(v, kw):
    """The bytes K1's design moves at the main-path chunk, from its shapes:
    the voxel grid read once, the rows, per-row and per-frame numbers
    written once, and the scratch (zeroed by the memset, then 11 status
    words a tile written and read); printed against the grid, beside the
    launch listing."""
    from v2ce_toolbox_tpu_torch.ops import gen

    bb, p, c, h, w = v.shape
    capp = -(-kw["cap_bin"] // 16384) * 16384
    words = gen.plan(bb, p * h * w, capp)[2]
    moved = {"voxels read": v.numel() * 4, "keys and kx written": 2 * bb * (c - 1) * capp * 4,
             "kept, total, emit, drop": (2 * bb * (c - 1) + 2 * bb) * 4,
             "scratch (memset + status)": 2 * words * 8}
    log("[K1 bytes] " + ", ".join(f"{k} {b / 1e6:.2f} MB" for k, b in moved.items())
        + f": {sum(moved.values()) / 1e6:.2f} MB in all against the "
        f"{v.numel() * 4 / 1e6:.2f} MB voxel grid (read once)")


def graph_ms(fn, torch, reps=10):
    """Median device ms of one fn call, from N_TIMED replays of a CUDA
    graph holding `reps` calls: the wrapper's Python, which a CUDA-event
    time of one call includes, is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return statistics.median(cuda_ms(g.replay, torch) for _ in range(N_TIMED)) / reps


# the port's own CUDA kernels in a kernel's name, demangled or not (in a
# mangled one after the digits of its length, not after "wino4_cu_")
PORT_KERNEL_NAME = r"(?<![A-Za-z_])(wino4_\w+?_kernel|live_steps_kernel|conv_taps_\w+?_kernel)"


def port_launches(fn, torch):
    """({kernel: launches} of the port's own kernels, launches of other
    (PyTorch) kernels, device ms of all of them, {kernel: device ms} of the
    port's) in one fn call, from torch.profiler's records of the card's
    activity; None where the profiler records no kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    own, other, us, own_us = {}, 0, 0.0, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.name.startswith(("Memcpy",
                                                                                     "Memset")):
            continue
        us += ev.device_time_total
        m = re.search(PORT_KERNEL_NAME, ev.name)
        if m:
            own[m.group(1)] = own.get(m.group(1), 0) + 1
            own_us[m.group(1)] = own_us.get(m.group(1), 0.0) + ev.device_time_total
        else:
            other += 1
    return None if not own and not other else (own, other, us / 1e3,
                                                {k: v / 1e3 for k, v in own_us.items()})


def listed_launches(fn, want, label, torch):
    """(own, other, device ms, {kernel: device ms}) of one fn call: the
    port's own kernels it launches and its other kernels, from a graph of
    the call (device_activities), with `own` held to `want` ({kernel:
    launches}); the device times from torch.profiler (port_launches), whose
    listing is taken again, at most LISTING_TRIES times, until it holds
    `want`, as it can drop records (the times are None where it never
    does)."""
    acts = device_activities(fn, torch)
    own, other = {}, 0
    for x in acts:
        m = re.search(PORT_KERNEL_NAME, x)
        if m:
            own[m.group(1)] = own.get(m.group(1), 0) + 1
        elif x not in GRAPH_NODE_TYPES.values():
            other += 1
    if own != want:
        raise AssertionError(f"{label}: launched {own}, expected {want}")
    for attempt in range(1, LISTING_TRIES + 1):
        counts = port_launches(fn, torch)
        if counts and counts[0] == want:
            return own, other, counts[2], counts[3]
    log(f"[launch listing] {label}: device times not measured (torch.profiler held "
        f"{counts and counts[0]} {LISTING_TRIES} times)")
    return own, other, None, None


def peak_scratch(fn, torch):
    """Bytes by which one fn call raises the allocator's peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    del out
    return rise


def time_one(fn, torch, n=N_TIMED):
    """Median ms of fn over n runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(cuda_ms(fn, torch) for _ in range(n))


def conv_bound(flops, moved, dname):
    """(bound ms, what bounds it): the larger of the FLOPs at the card's
    peak for the type and the bytes at the HBM rate."""
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_err(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def conv_kernels_phase(torch, np, dev):
    """Phase 8: K9 and K10 against their twins on the calls of one 16-frame
    260x346 window of the full-width research model, bf16 and f32. Returns
    ({"<kernel>[<dtype>]": per-window sums of ms, plain_ms, library_ms,
    bound_ms and bound_by}, {kernel: max abs err in bf16})."""
    import torch.nn.functional as F

    from v2ce_toolbox_tpu_torch.config import ModelConfig
    from v2ce_toolbox_tpu_torch.models import V2ce3d, layers
    from v2ce_toolbox_tpu_torch.ops import conv3d, decoder
    from v2ce_toolbox_tpu_torch.utils.weights import init_weights

    x = torch.from_numpy(np.random.RandomState(0).randn(1, 16, H, W, 2)
                         .astype(np.float32)).to(dev)
    results, errs, live_info = {}, {}, []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        model = V2ce3d(ModelConfig(compute_dtype=dtype, **RESEARCH))
        init_weights(model, 0)
        model.to(dev).eval()
        k9, k10, k10_in = [], [], []
        with record_calls([layers], "conv3d_3x3x3", k9), \
                record_calls([decoder], "fused_conv_even", k10), \
                record_calls([layers], "fused_up_concat_conv", k10_in), torch.no_grad():
            model(x)
        torch.cuda.synchronize()
        del model
        if len(k9) != CONV_PER_WINDOW["conv3d_3x3x3"] or len(k10) != 2 or len(k10_in) != 2:
            raise AssertionError(f"the research model made {len(k9)} K9 and {len(k10)} K10 "
                                 "calls on one window")
        # K9: the distinct call shapes, each with its count in the window
        shapes = {}
        for a, k in k9:
            key = (tuple(a[0].shape), tuple(a[1].shape))
            shapes.setdefault(key, [a, k, 0])[2] += 1
        cases = [("conv3d_3x3x3", conv3d.conv3d_3x3x3, conv3d._conv3d_3x3x3_torch, a, k, n,
                  None) for a, k, n in shapes.values()]
        # K10: each call with the block's call of fused_up_concat_conv it serves
        cases += [("fused_up_concat_conv", decoder.fused_conv_even,
                   decoder._fused_conv_even_torch, a, k, 1, block_call)
                  for (a, k), block_call in zip(k10, k10_in)]
        for name, kernel, plain, a, k, n, block_call in cases:
            with torch.no_grad():
                got, want = kernel(*a, **k), plain(*a, **k)
                torch.cuda.synchronize()
                rel = rel_err(got, want)
                abs_err = float((got.float() - want.float()).abs().max())
                if name == "conv3d_3x3x3":
                    xin, kin = a
                    flops = 2 * xin.numel() * kin.shape[4] * 27
                    moved = nbytes([xin, kin, got])
                    xl = xin.permute(0, 4, 1, 2, 3)          # channels-last NCDHW
                    wl = kin.permute(4, 3, 0, 1, 2).contiguous()
                    label = f"{tuple(xin.shape)} x {tuple(kin.shape)}"
                else:
                    fa, fkw = block_call
                    coarse, skip, kern = fa[:3]
                    proj = fa[3] if len(fa) > 3 else None
                    b, l, hc, wc, cu = coarse.shape
                    hf, wf, cs = skip.shape[2:]
                    co = kern.shape[4]
                    # the function's work: the direct conv over the fine
                    # concat, and the 1x1 projection when it is fused
                    flops = 2 * b * l * hf * wf * (cu + cs) * co * (27 + (proj is not None))
                    moved = (nbytes([coarse, skip, kern, proj])
                             + b * l * hf * wf * co * got.element_size() * (1 + (proj is not None)))
                    # the library's one call on the materialized concat (made
                    # outside the timing): conv, and the projection as a
                    # centre-tap block of the same weights
                    up = coarse.repeat_interleave(2, 2)[:, :, :hf].repeat_interleave(2, 3)[:, :, :, :wf]
                    xl = torch.cat([up, skip], -1).permute(0, 4, 1, 2, 3).contiguous(
                        memory_format=torch.channels_last_3d)
                    wl = kern.permute(4, 3, 0, 1, 2)
                    if proj is not None:
                        wp = torch.zeros_like(wl)
                        wp[:, :, 1, 1, 1] = proj[0, 0, 0].t()
                        wl = torch.cat([wl, wp], 0)
                    wl = wl.contiguous()
                    if dtype == torch.float32:
                        # the whole fused function (kernel + fold + odd-size
                        # corrections) against the direct conv
                        full = layers.fused_up_concat_conv(*fa, **fkw)
                        full = full[0] if isinstance(full, tuple) else full
                        direct = F.conv3d(xl, wl[:co], padding=1).permute(0, 2, 3, 4, 1)
                    label = (f"coarse {tuple(coarse.shape)} skip {tuple(skip.shape)} Co {co}"
                             f"{' + projection' if proj is not None else ''}")
                    if dtype == torch.float32 and rel_err(full, direct) > STAGE1_REL_TOL:
                        raise AssertionError(f"K10 {label}: the fused conv is "
                                             f"{rel_err(full, direct):.3e} from the direct conv")
                tol = CONV_REL_TOL[str(got.dtype).split(".")[1]]
                if not (torch.isfinite(got.float()).all() and rel <= tol):
                    raise AssertionError(f"{name} {dname} {label}: {rel:.3e} from its twin "
                                         f"(limit {tol:g})")
                tk, tp = time_pair(lambda: kernel(*a, **k), lambda: plain(*a, **k), torch)
                tl = time_one(lambda: F.conv3d(xl, wl, padding=1), torch)
                extra = ""
                if name == "fused_up_concat_conv" and dtype == torch.bfloat16:
                    # the live steps of the folded weights against the direct
                    # conv, and the kernel on dense weights of the same shape
                    xin, kf = a[0], a[1]
                    kd = torch.randn(kf.shape, generator=torch.Generator(device=dev)
                                     .manual_seed(0), device=dev).mul_(0.02).to(kf.dtype)
                    share, dense = [live_share(
                        conv3d, lambda: kernel(xin, kw, *a[2:], **k),
                        kw.reshape(2, 18, kw.shape[4], kw.shape[5]).transpose(2, 3),
                        decoder.FOLD_TILES) for kw in (kf, kd)]
                    direct = 4 * (cu + cs) * co * (27 + (proj is not None))
                    td = time_one(lambda: kernel(xin, kd, *a[2:], **k), torch)
                    live_info.append(dict(live_macs=share[0], dense_macs=share[1],
                                          direct_macs=direct, dense_weights_ms=td,
                                          dense_weights_live_macs=dense[0]))
                    extra = (f"; live steps (the kernel's table, equal to its twin's) "
                             f"{share[0] / direct:.3f} of the direct conv's multiply-adds "
                             f"({share[1] / direct:.3f} dense), dense weights "
                             f"{td:.4f} ms with {dense[0] / direct:.3f} live")
            tb, by = conv_bound(flops, moved, dname)
            log(f"[conv] {name} {dname} {label} x{n}: rel err {rel:.3e} (limit {tol:g}), abs err "
                f"{abs_err:.3e}; kernel {tk:.4f} ms ({flops / tk / 1e9:.1f} TFLOP/s), plain "
                f"{tp:.4f} ms, cuDNN {tl:.4f} ms, bound {tb:.4f} ms ({by}){extra}")
            r = results.setdefault(f"{name}[{dname}]", dict(ms=0.0, plain_ms=0.0,
                                                             library_ms=0.0, bound_ms=0.0,
                                                             t_ops=0.0, t_bytes=0.0))
            r["ms"] += n * tk
            r["plain_ms"] += n * tp
            r["library_ms"] += n * tl
            r["bound_ms"] += n * tb
            r["t_ops" if by == "operations" else "t_bytes"] += n * tb
            if dtype == torch.bfloat16:
                errs[name] = max(errs.get(name, 0.0), abs_err)
        del k9, k10, k10_in, cases, shapes
        torch.cuda.empty_cache()
    for label, r in results.items():
        r["bound_by"] = "operations" if r.pop("t_ops") >= r.pop("t_bytes") else "bytes"
        log(f"[conv] {label} per 16-frame window: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, cuDNN {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    results["fused_up_concat_conv[bfloat16]"]["live_steps"] = live_info
    return results, errs


def live_share(conv3d, run, kt, tiles):
    """(live, dense) multiply-adds per output row of the GEMM core, counted
    as the tensor cores run them (a live step costs BN x BK, padding
    included), from the table the kernel's own pre-pass filled: `run`
    launches one bf16 call, whose table is read back and must equal the
    plain twin's on the weights kt (planes, taps, Co, C) with tiles (BN,
    BK)."""
    import torch

    with conv3d.record_live() as tables:
        run()
    if len(tables) != 1:
        raise AssertionError(f"expected one bf16 conv call, got {len(tables)}")
    got = tables[0].cpu()
    want = conv3d.live_steps(kt, *tiles).cpu()
    if got.shape != want.shape or not torch.equal(got.bool(), want) \
            or int(got.max()) > 1:
        raise AssertionError(f"the kernel's live-step table {tuple(got.shape)} "
                             f"({int(got.sum())} live) differs from its twin's "
                             f"{tuple(want.shape)} ({int(want.sum())} live)")
    bn, bk = tiles
    return int(got.sum()) * bn * bk, got.numel() * bn * bk


def make_clip(path, n, h, w):
    import cv2

    from tools.make_test_video import make_frames

    video = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    for fr in make_frames(n, h, w):
        video.write(cv2.cvtColor(fr, cv2.COLOR_GRAY2BGR))
    video.release()


def check_npz(result, np, w, what, monotone=True, fps=FPS):
    """The npz of a CLI run: EVENT_DTYPE records inside the 260 x w frame of
    the 32 voxel frames, time-sorted, and as many as the run reports.
    'random' (not monotone) draws raw U[0, 1) s offsets past each bin
    start, sorted per bin only."""
    from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE

    ev = np.load(result["event_stream_path"])["event_stream"]
    if ev.dtype != EVENT_DTYPE:
        raise AssertionError(f"{what}: npz dtype {ev.dtype} != {EVENT_DTYPE}")
    t_end = 32 / fps * 1e6 + (0 if monotone else 1e6 + 1e6 / fps / 9 + 2)
    if not (len(ev) == result["num_events"] > 0
            and ev["x"].min() >= 0 and ev["x"].max() < w
            and ev["y"].min() >= 0 and ev["y"].max() < H
            and (not monotone or np.all(np.diff(ev["timestamp"]) >= 0))
            and ev["timestamp"].min() >= 0 and ev["timestamp"].max() < t_end):
        raise AssertionError(f"{what}: events outside the {H}x{w} frame, unsorted or "
                             "missing")
    return ev


def cli_line(result):
    t = result["timings"]
    return (f"stage-1 {t['stage1_s'] / t['windows'] * 1e3:.2f} ms/window "
            f"({t['windows']} windows), stage-2 {t['stage2_s'] / t['chunks'] * 1e3:.2f} "
            f"ms/chunk ({t['chunks']} chunks), events {result['num_events']}, "
            f"{result['num_frames'] / result['wall_time_s']:.2f} frames/s "
            f"({result['num_frames']} frames in {result['wall_time_s']:.3f} s)")


def cli_phase(torch, np, counted, smi):
    """Phase 4: center, center --streaming, pano and pano --streaming."""
    from v2ce_toolbox_tpu_torch import cli

    os.makedirs(OUT, exist_ok=True)
    clip = os.path.join(OUT, "clip.mp4")
    make_clip(clip, 33, H, W)
    common = ["-o", OUT, "-m", os.path.join(OUT, "absent.pt"), "--device", DEVICE,
              "--seed", "0", "--height", str(H), "--width", str(W), "-l", "warning"]
    argv = ["-i", clip, *common]
    cli.main(argv)                                   # warm-up (cuDNN, allocator)
    result = counted("center CLI", CENTER_PATH, lambda: cli.main(argv))
    check_npz(result, np, W, "center")
    # the host shares its cores: report the run with the median wall time
    runs = [result] + [cli.main(argv) for _ in range(N_CLI - 1)]
    if len({r["num_events"] for r in runs}) != 1:
        raise AssertionError("repeated CLI runs gave different event counts")
    result = sorted(runs, key=lambda r: r["wall_time_s"])[N_CLI // 2]
    log(f"[cli] center: {cli_line(result)} [{smi}]")

    streamed = counted("center CLI --streaming", CENTER_PATH,
                       lambda: cli.main(argv + ["--streaming"]))
    check_npz(streamed, np, W, "center --streaming")
    log(f"[cli] center --streaming: {cli_line(streamed)} [{smi}]")
    if streamed["num_events"] != result["num_events"]:
        raise AssertionError(f"--streaming gave {streamed['num_events']} events, the "
                             f"batch run {result['num_events']}")

    pano_clip = os.path.join(OUT, "pano.mp4")
    make_clip(pano_clip, 33, H, PANO_W)
    pargv = ["-i", pano_clip, "-t", "pano", *common]
    cli.main(pargv)                                  # warm-up at the pano width
    pano = {}
    x_need = 512 if PANO_W > 512 else W           # the 10-bit x field, or the last strip
    for label, extra in [("pano", []), ("pano --streaming", ["--streaming"])]:
        res = counted(f"{label} CLI", CENTER_PATH, lambda: cli.main(pargv + extra))
        ev = check_npz(res, np, PANO_W, label)
        if res["voxels_shape"] != (32, H, PANO_W, 20) or int(ev["x"].max()) < x_need:
            raise AssertionError(f"{label}: voxels {res['voxels_shape']}, x up to "
                                 f"{int(ev['x'].max())}: the strips miss the width")
        log(f"[cli] {label} ({H}x{PANO_W}, 2 strips, x up to {int(ev['x'].max())}): "
            f"{cli_line(res)} [{smi}]")
        pano[label] = res["num_events"]
    if len(set(pano.values())) != 1:
        raise AssertionError(f"pano event totals differ: {pano}")


def modes_phase(torch, np, counted, dense, smi):
    """Phase 5: each stage-2 mode, the card against the CPU plain path on 4
    frames, then end to end on the center clip, counted: through its CLI
    flag, or through V2cePipeline with the sampler setting where v2ce.py
    has no flag."""
    from v2ce_toolbox_tpu_torch import cli
    from v2ce_toolbox_tpu_torch.config import PipelineConfig, SamplerConfig
    from v2ce_toolbox_tpu_torch.ops import ldati
    from v2ce_toolbox_tpu_torch.pipeline import driver

    v, _, _, offsets = dense
    v4, off4 = v[:4].contiguous(), offsets[:4]
    draw = ldati.make_draw(1, 0, v.device)
    clip = os.path.join(OUT, "clip.mp4")
    absent = os.path.join(OUT, "absent.pt")

    def cpu_draw(j, shape):
        return draw(j, shape).cpu()

    for mode, (over, flags, kernels) in MODES.items():
        cfg = dataclasses.replace(SamplerConfig(), **over)
        card = driver.chunk_events(v4, draw, off4, 4, cfg, FPS)
        t0 = time.time()
        plain = driver.chunk_events(v4.cpu(), cpu_draw, off4.cpu(), 4, cfg, FPS)
        cpu_s = time.time() - t0
        if len(card) == 0 or card.tobytes() != plain.tobytes():
            raise AssertionError(f"mode {mode}: the card's stage 2 ({len(card)} events) "
                                 f"differs from the CPU plain path ({len(plain)})")
        if flags is not None:
            argv = ["-i", clip, "-o", OUT, "-m", absent, "--device", DEVICE, "--seed", "0",
                    "--height", str(H), "--width", str(W), "-l", "warning", *flags]
            run, how = (lambda: cli.main(argv)), f"cli {' '.join(flags) or '(defaults)'}"
        else:
            pipe = driver.V2cePipeline(PipelineConfig(height=H, width=W, sampler=cfg),
                                       model_path=absent, device=DEVICE, seed=0)
            run = lambda: pipe.run(input_video_path=clip, out_folder=OUT)  # noqa: E731
            how = f"V2cePipeline {over}"
        runs = [counted(f"mode {mode}", kernels, run, how)] + [run() for _ in range(2)]
        for r in runs:
            check_npz(r, np, W, f"mode {mode}", monotone=mode != "random")
        r = sorted(runs, key=lambda r: r["timings"]["stage2_s"])[1]
        log(f"[mode] {mode}: 4-frame chunk card == CPU plain ({len(card)} events, CPU "
            f"{cpu_s:.1f} s); {how}, median of 3: {cli_line(r)} [{smi}]")


def peak_gib(torch, fn):
    """(fn(), the allocator's peak in GiB while it ran)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2 ** 30


def v2_phase(torch, np, counted, dense, smi):
    """Phase 13: the v2 sampler core, which takes the geometries whose voxel
    ids the packed key cannot hold: (a) `driver.chunk_events` at 10 fps on
    4 frames of the dense voxels for V2_MODES, counted (K5 and K2 in the
    flatten), the card against the CPU plain path byte for byte; then on
    the 24-frame chunk every K5 and K2 call (12,582,912 slots) held
    against its plain twin exactly, and the stage-2 ms and peak memory;
    (b) the ablation samplers (baseline 'random' and 'even', pure slope)
    on 4 frames, card against CPU; (c) the center CLI at --fps 10, counted, and --streaming
    with as many events; (d) the pano CLI on a 260x1024 clip, x past 1000,
    batch and --streaming; (e) V2cePipeline at width 1025 refused before
    stage 1 (the wire record); (f) the port's stage2_eval on phase 11's
    packets. Returns {kernel: max_abs_err} of (a)'s 24-frame calls."""
    from v2ce_toolbox_tpu_torch import cli
    from v2ce_toolbox_tpu_torch.config import PipelineConfig, SamplerConfig
    from v2ce_toolbox_tpu_torch.eval.stage2_metrics import SAMPLERS
    from v2ce_toolbox_tpu_torch.events import to_recarrays
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.ops import compact, ldati, samplers
    from v2ce_toolbox_tpu_torch.pipeline import driver
    from v2ce_toolbox_tpu_torch.tools import stage2_eval

    if ldati.supports_rows(2, H, W, fps=V2_FPS) or ldati.supports_rows(2, H, V2_PANO_W, fps=FPS):
        raise AssertionError("the v2 geometries fit the packed key: the phase misses the core")
    v = dense[0]
    v4 = v[:4].contiguous()
    draw = ldati.make_draw(2, 0, v.device)

    def cpu_draw(j, shape):
        return draw(j, shape).cpu()

    def offsets(n):
        return torch.from_numpy((np.arange(n) / V2_FPS * 1e6).astype(np.int32)).to(v.device)

    errs = {name: 0 for name in V2_PATH}
    for mode in V2_MODES:
        cfg = dataclasses.replace(SamplerConfig(), **MODES[mode][0])
        card = counted(f"v2 {mode}", V2_PATH,
                       lambda: driver.chunk_events(v4, draw, offsets(4), 4, cfg, V2_FPS))
        t0 = time.time()
        plain = driver.chunk_events(v4.cpu(), cpu_draw, offsets(4).cpu(), 4, cfg, V2_FPS)
        cpu_s = time.time() - t0
        if len(card) == 0 or card.tobytes() != plain.tobytes():
            raise AssertionError(f"v2 {mode}: the card's stage 2 ({len(card)} events) differs "
                                 f"from the CPU plain path ({len(plain)})")
        # the 24-frame chunk, split: the sampler (synchronised), the flatten
        # alone (K5, deltas, bit packing, K2), and the whole chunk_events
        # route (sampler, flatten, fetch, host decode)
        scfg = dataclasses.replace(cfg, fps=V2_FPS)
        monotone = mode != "random"
        off = offsets(F)
        scap = driver._side_cap(F, scfg.event_capacity, int((F + 1) * 1e6 / V2_FPS) + 2,
                                driver.DELTA_BITS, monotone)
        calls = {name: [] for name in V2_PATH}
        with record_calls([driver], "append_rows", calls["append_rows"]), \
                record_calls([ldati, driver], "compact_rows", calls["compact_rows"]):
            driver.chunk_events(v, draw, off, F, cfg, V2_FPS)             # warm-up
        torch.cuda.synchronize()
        for name, cl in calls.items():
            if not cl:
                raise AssertionError(f"v2 {mode}: the {F}-frame chunk made no {name} call")
            kernel, plain = getattr(compact, name), getattr(compact, name + "_torch")
            e = max(max_abs_err(kernel(*a, **k), plain(*a, **k)) for a, k in cl)
            log(f"[v2] {mode}: {name} on the {F}-frame chunk, calls "
                f"{[(tuple(a[0].shape), k.get('cap')) for a, k in cl]}: max_abs_err {e}")
            if e != 0:
                raise AssertionError(f"v2 {mode}: {name} differs from its plain twin: {e}")
            errs[name] = max(errs[name], e)
        del calls
        t0 = time.perf_counter()
        stream, peak = peak_gib(torch, lambda: ldati.sample_events(v, draw, scfg))
        t1 = time.perf_counter()
        peak_gib(torch, lambda: driver._flatten_chunk_stream(stream, off, F, side_cap=scap))
        t2 = time.perf_counter()
        del stream
        ev, peak_all = peak_gib(torch, lambda: driver.chunk_events(v, draw, off, F, cfg,
                                                                   V2_FPS))
        t3 = time.perf_counter()
        log(f"[v2] {mode}: 4-frame chunk card == CPU plain ({len(card)} events, CPU "
            f"{cpu_s:.1f} s); {F}-frame {H}x{W} chunk at {V2_FPS} fps: {(t3 - t2) * 1e3:.2f} "
            f"ms, {len(ev)} events, peak {peak_all:.2f} GiB; sampler {(t1 - t0) * 1e3:.2f} "
            f"ms (peak {peak:.2f} GiB), flatten {(t2 - t1) * 1e3:.2f} ms [{smi}]")

    for name, fn, kw in [("baseline random", samplers.sample_events_baseline,
                          dict(mode="random")),
                         ("baseline even", samplers.sample_events_baseline, dict(mode="even")),
                         ("pure slope", samplers.sample_events_pure_slope, {})]:
        card, peak = peak_gib(torch, lambda: to_recarrays(fn(v4, draw, **kw)))
        plain = to_recarrays(fn(v4.cpu(), cpu_draw, **kw))
        if (sum(len(r) for r in card) == 0
                or [r.tobytes() for r in card] != [r.tobytes() for r in plain]):
            raise AssertionError(f"sampler {name}: the card differs from the CPU")
        log(f"[v2] sampler {name}: 4 frames card == CPU ({sum(len(r) for r in card)} "
            f"events), peak {peak:.2f} GiB [{smi}]")

    clip = os.path.join(OUT, "clip.mp4")
    common = ["-o", OUT, "-m", os.path.join(OUT, "absent.pt"), "--device", DEVICE,
              "--seed", "0", "--height", str(H), "-l", "warning"]
    argv = ["-i", clip, "--width", str(W), "--fps", str(V2_FPS), *common]
    res, peak = peak_gib(torch, lambda: counted("center CLI --fps 10", V2_PATH,
                                                lambda: cli.main(argv)))
    check_npz(res, np, W, "center --fps 10", fps=V2_FPS)
    log(f"[v2] center CLI --fps {V2_FPS}: {cli_line(res)}, peak {peak:.2f} GiB [{smi}]")
    streamed = cli.main(argv + ["--streaming"])
    check_npz(streamed, np, W, "center --fps 10 --streaming", fps=V2_FPS)
    log(f"[v2] center CLI --fps {V2_FPS} --streaming: {cli_line(streamed)} [{smi}]")
    if streamed["num_events"] != res["num_events"]:
        raise AssertionError(f"--fps 10 --streaming gave {streamed['num_events']} events, "
                             f"the batch run {res['num_events']}")

    pano_clip = os.path.join(OUT, "pano1024.mp4")
    make_clip(pano_clip, 33, H, V2_PANO_W)
    pargv = ["-i", pano_clip, "-t", "pano", "--width", str(W), *common]
    pano = {}
    for label, extra in [("pano 1024", []), ("pano 1024 --streaming", ["--streaming"])]:
        res, peak = peak_gib(torch, lambda: counted(f"{label} CLI", V2_PATH,
                                                    lambda: cli.main(pargv + extra)))
        ev = check_npz(res, np, V2_PANO_W, label)
        if res["voxels_shape"] != (32, H, V2_PANO_W, 20) or int(ev["x"].max()) < V2_PANO_W - 24:
            raise AssertionError(f"{label}: voxels {res['voxels_shape']}, x up to "
                                 f"{int(ev['x'].max())}")
        log(f"[v2] {label} ({H}x{V2_PANO_W}, 3 strips, x up to {int(ev['x'].max())}): "
            f"{cli_line(res)}, peak {peak:.2f} GiB [{smi}]")
        pano[label] = res["num_events"]
    if len(set(pano.values())) != 1:
        raise AssertionError(f"pano 1024 event totals differ: {pano}")

    built = []
    real_init = V2ce3d.__init__

    def recording_init(self, *a, **k):
        built.append(1)
        real_init(self, *a, **k)

    V2ce3d.__init__ = recording_init
    try:
        driver.V2cePipeline(PipelineConfig(height=H, width=1025),
                            model_path=os.path.join(OUT, "absent.pt"), device=DEVICE)
        raise AssertionError("V2cePipeline took a 1025 px stream")
    except ValueError as e:
        if built:
            raise AssertionError("the 1025 px stream was refused after stage 1 began")
        log(f"[v2] V2cePipeline at {H}x1025 refused before stage 1: {e}")
    finally:
        V2ce3d.__init__ = real_init

    pkt_dir = os.path.join(OUT, "packets")
    t0 = time.time()
    table = stage2_eval.main(["--data_dir", pkt_dir, "--max_files", "1",
                              "--max_frames_per_file", "2", "--device", DEVICE,
                              "--samplers", *SAMPLERS])
    rows = table.splitlines()[1:]
    if len(rows) != len(SAMPLERS) or not all(float(r.split(",")[3]) > 0 for r in rows):
        raise AssertionError(f"stage2_eval: {table}")
    log(f"[v2] stage2_eval on 2 frames of {pkt_dir}: {time.time() - t0:.1f} s [{smi}]")
    return errs


def research_phase(torch, np, counted, smi):
    """Phase 9: the research configuration through V2cePipeline on the
    center clip, counted (K9 14 and K10 2 launches per window), then the
    product --bf16 CLI run, counted."""
    from v2ce_toolbox_tpu_torch import cli
    from v2ce_toolbox_tpu_torch.config import ModelConfig, PipelineConfig
    from v2ce_toolbox_tpu_torch.pipeline import driver

    clip = os.path.join(OUT, "clip.mp4")
    absent = os.path.join(OUT, "absent.pt")
    model = ModelConfig(compute_dtype=torch.bfloat16, **RESEARCH)
    pipe = driver.V2cePipeline(PipelineConfig(height=H, width=W, model=model),
                               model_path=absent, device=DEVICE, seed=0)
    run = lambda: pipe.run(input_video_path=clip, out_folder=OUT)  # noqa: E731
    run()                                            # warm-up
    path = "research V2cePipeline"
    runs = [counted(path, RESEARCH_PATH, run, f"bf16, {RESEARCH}")]
    counts, windows = counted.by_path[path], runs[0]["timings"]["windows"]
    for name, per_window in CONV_PER_WINDOW.items():
        if counts[name] != per_window * windows:
            raise AssertionError(f"{path}: {name} launched {counts[name]} times in "
                                 f"{windows} windows, not {per_window} per window")
    runs += [run() for _ in range(N_CLI - 1)]
    for r in runs:
        check_npz(r, np, W, path)
    r = sorted(runs, key=lambda r: r["wall_time_s"])[N_CLI // 2]
    log(f"[research] {path} (bf16), median of {N_CLI}: {cli_line(r)} [{smi}]")

    argv = ["-i", clip, "-o", OUT, "-m", absent, "--device", DEVICE, "--seed", "0",
            "--height", str(H), "--width", str(W), "-l", "warning", "--bf16"]
    cli.main(argv)                                   # warm-up
    runs = [counted("bf16 CLI", CENTER_PATH, lambda: cli.main(argv), "--bf16")]
    runs += [cli.main(argv) for _ in range(N_CLI - 1)]
    for r in runs:
        check_npz(r, np, W, "--bf16")
    if len({r["num_events"] for r in runs}) != 1:
        raise AssertionError("repeated --bf16 runs gave different event counts")
    r = sorted(runs, key=lambda r: r["wall_time_s"])[N_CLI // 2]
    log(f"[research] --bf16 CLI, median of {N_CLI}: {cli_line(r)} [{smi}]")


def research_stage1_phase(torch, np, dev, product, x):
    """Phase 10: the research model against the product model on the card,
    the same weights: f32 within STAGE1_REL_TOL on the phase-6 window and
    the clip's first window; bf16 through the fidelity gate on the clip's
    first window."""
    from v2ce_toolbox_tpu_torch.config import ModelConfig, SamplerConfig
    from v2ce_toolbox_tpu_torch.io.video import VideoReader
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.ops import ldati
    from v2ce_toolbox_tpu_torch.pipeline import driver
    from v2ce_toolbox_tpu_torch.pipeline.infer import make_forward_fn
    from v2ce_toolbox_tpu_torch.pipeline.preprocess import resize_frames

    def research(dtype):
        m = V2ce3d(ModelConfig(compute_dtype=dtype, **RESEARCH))
        m.load_state_dict(product.state_dict())
        return m.to(dev).eval()

    r32, r16 = research(torch.float32), research(torch.bfloat16)
    raw = VideoReader(os.path.join(OUT, "clip.mp4"), color_mode="GRAY") \
        .read_frames_at_indices(range(17))
    frames = torch.from_numpy(resize_frames(raw, H)[None]).to(dev)
    with torch.no_grad():
        for what, inp in [("(1, 16, 64, 96, 2) window", lambda m: m(x)),
                          ("clip window", lambda m: make_forward_fn(m, width=W)(frames))]:
            want, got = inp(product), inp(r32)
            rel = rel_err(got, want)
            log(f"[stage1] research f32 vs product f32, {what}: relative to max |out| "
                f"{rel:.3e} (limit {STAGE1_REL_TOL:g})")
            if not torch.isfinite(got).all() or float(want.abs().max()) == 0 \
                    or rel > STAGE1_REL_TOL:
                raise AssertionError(f"the f32 research model disagrees with the product "
                                     f"model on the {what}")
        y32 = make_forward_fn(product, width=W)(frames)
        y16 = make_forward_fn(r16, width=W)(frames)
    err, scale = float((y16 - y32).abs().max()), float(y32.abs().max())
    match = float(((y32 > 0.01) == (y16 > 0.01)).float().mean())

    def events(y):
        v = y.permute(0, 1, 4, 2, 3).reshape(16, 2, 10, H, W).contiguous()
        offsets = torch.from_numpy((np.arange(16) / FPS * 1e6).astype(np.int32)).to(dev)
        return driver.chunk_events(v, ldati.make_draw(7, 0, dev), offsets, 16,
                                   SamplerConfig(), FPS)

    e32, e16 = events(y32), events(y16)
    ratio = len(e16) / max(len(e32), 1)
    a = np.sort(e32["timestamp"].astype(np.float64))
    b = np.sort(e16["timestamp"].astype(np.float64))
    grid = np.union1d(a, b)
    ks = float(np.abs(np.searchsorted(a, grid, side="right") / max(len(a), 1)
                      - np.searchsorted(b, grid, side="right") / max(len(b), 1)).max())
    log(f"[stage1] research bf16 vs product f32, clip window: max err {err:.4e} (limit "
        f"{0.05 * scale + 1e-3:.4e}), BinaryMatch {match:.6f} (>= 0.995), events "
        f"{len(e16)} / {len(e32)} = {ratio:.6f} (within 0.005 of 1), timestamp KS {ks:.6f} "
        "(<= 0.02)")
    if not (len(e32) > 0 and err <= 0.05 * scale + 1e-3 and match >= 0.995
            and abs(ratio - 1) <= 0.005 and ks <= 0.02):
        raise AssertionError("the bf16 research model fails the bf16 fidelity gate")


def make_recording(np, n, h, w, seed=0, noise=0):
    """A synthetic DAVIS recording of n frames at FPS: the moving test
    pattern, one event per pixel whose intensity changes by more than 8
    levels between two frames (at a random time in the interval, polarity
    the sign of the change), plus `noise` events a gap at uniform random
    pixels, times and polarities (from a generator of their own, so the
    pattern's events do not change), and a 1 kHz IMU. Returns the arrays
    of an MVSEC `davis/left` group."""
    from tools.make_test_video import make_frames

    rng = np.random.RandomState(seed)
    noise_rng = np.random.RandomState(seed + 1)
    images = make_frames(n, h, w, seed)
    image_ts = np.arange(n) / FPS
    rows = []
    for i in range(n - 1):
        diff = images[i + 1].astype(np.int32) - images[i].astype(np.int32)
        ys, xs = np.nonzero(np.abs(diff) > 8)
        t = image_ts[i] + rng.rand(len(ys)) / FPS
        rows.append(np.stack([xs, ys, t, np.sign(diff[ys, xs])], 1))
        if noise:
            rows.append(np.stack([noise_rng.randint(0, w, noise), noise_rng.randint(0, h, noise),
                                  image_ts[i] + noise_rng.rand(noise) / FPS,
                                  noise_rng.choice([-1.0, 1.0], noise)], 1))
    events = np.concatenate(rows)
    events = events[np.argsort(events[:, 2], kind="stable")]
    event_inds = np.searchsorted(events[:, 2], image_ts)
    imu_ts = np.arange(0, image_ts[-1], 1e-3)
    return images, image_ts, event_inds, events, rng.randn(len(imu_ts), 6), imu_ts


def profile_call(torch, fn, smi, label, top=8):
    """torch.profiler over one warm call: wall ms, the device's busy ms (the
    sum of its kernels' and copies' times; the operators that launch them
    are left out, so nothing counts twice), the kernels that take the most
    of it, and the CUDA runtime calls the host made (kernel launches, async
    copies, stream syncs). Returns {wall_ms, busy_ms (None where the
    profiler saw no device activity), the call counts, and top: the
    leading kernels' [name, ms, count]}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    events = prof.key_averages()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("Activity Buffer")]
    calls = {"kernel_launches": "cudaLaunchKernel", "async_copies": "cudaMemcpyAsync",
             "stream_syncs": "cudaStreamSynchronize"}
    out = {"wall_ms": wall, "busy_ms": None, "top": [],
           **{k: sum(e.count for e in events if e.key.startswith(name))
              for k, name in calls.items()}}
    host = "; host: " + ", ".join(f"{k.replace('_', ' ')} {out[k]}" for k in calls)
    if not rows:
        log(f"[profile] {label}: {wall:.2f} ms wall; device time not measured (the "
            f"profiler saw no device activity){host}")
        return out
    busy = out["busy_ms"] = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    log(f"[profile] {label}: {wall:.2f} ms wall, device busy {busy:.2f} ms ({busy / wall:.1%})"
        f"{host} [{smi}]")
    for name, ms, count in rows[:top]:
        log(f"[profile]   {ms:8.3f} ms {ms / busy:6.1%} x{count:<4d} {name[:90]}")
        out["top"].append([name[:90], ms, count])
    return out


def data_phase(torch, np, dev, counted, smi):
    """Phase 11: the training-data path. Returns ({"correlation": per-call
    sums of ms, plain_ms, device_ms, plain_device_ms, bound_ms, bound_by,
    library_ms}, K8's max abs error)."""
    import pickle

    from v2ce_toolbox_tpu_torch.data import mvsec
    from v2ce_toolbox_tpu_torch.data.event_pack_dataset import EventPackDataset
    from v2ce_toolbox_tpu_torch.data.loader import device_prefetch, iterate_batches
    from v2ce_toolbox_tpu_torch.data.voxelize import (gen_discretized_event_volume,
                                                      gen_discretized_event_volume_np)
    from v2ce_toolbox_tpu_torch.models import fastflownet
    from v2ce_toolbox_tpu_torch.models.fastflownet import FastFlowNet, init_fastflownet
    from v2ce_toolbox_tpu_torch.ops import correlation
    from v2ce_toolbox_tpu_torch.utils.weights import load_fastflownet

    n = DATA_FRAMES
    rec = make_recording(np, n, H, W)
    images = rec[0]
    net = FastFlowNet()
    init_fastflownet(net, 0)
    ckpt = os.path.join(OUT, "fastflownet.pt")
    torch.save(net.state_dict(), ckpt)
    sd = load_fastflownet(ckpt)

    # (a) K8 against its twin on the calls of one 16-pair call
    pair_flow = mvsec.fastflownet_pair_flow(sd, device=DEVICE)
    calls = []
    with record_calls([fastflownet], "correlation", calls):
        pair_flow(images[:PAIRS], images[1:PAIRS + 1])
    torch.cuda.synchronize()
    if len(calls) != 5:
        raise AssertionError(f"one FastFlowNet call made {len(calls)} cost volumes, not 5")
    r = dict(ms=0.0, plain_ms=0.0, device_ms=0.0, plain_device_ms=0.0, bound_ms=0.0,
             bound_by="bytes", library_ms=None, taps_device_ms=0.0, levels=[])
    err = 0.0
    t_ops = t_bytes = 0.0
    for a, kw in calls:
        # the model's call keeps FastFlowNet's taps and writes them into its
        # decoder input; the kernel is held and timed on all 81 taps, and
        # its taps entry against those planes bit for bit
        f1, f2 = a[:2]
        k = {key: v for key, v in kw.items() if key not in ("taps", "out")}
        got, want = correlation.correlation(*a, **k), correlation._correlation_torch(*a, **k)
        torch.cuda.synchronize()
        rel = rel_err(got, want)
        err = max(err, float((got - want).abs().max()))
        if not (torch.isfinite(got).all() and rel <= CORR_REL_TOL):
            raise AssertionError(f"correlation {tuple(f1.shape)}: {rel:.3e} from its twin "
                                 f"(limit {CORR_REL_TOL:g})")
        taps = kw.get("taps")
        if taps is None or "out" not in kw:
            raise AssertionError("FastFlowNet's cost volume did not keep its taps in place")
        dec = torch.full((f1.shape[0], len(taps) + 34, *f1.shape[2:]), -7.0, device=f1.device)
        sub = correlation.correlation(*a, **k, taps=taps, out=dec[:, :len(taps)])
        torch.cuda.synchronize()
        if not (torch.equal(sub, got[:, list(taps)]) and bool((dec[:, len(taps):] == -7).all())):
            raise AssertionError(f"correlation {tuple(f1.shape)}: the taps written in place "
                                 "differ from the 81-tap kernel's planes")
        tk, tp = time_pair(lambda: correlation.correlation(*a, **k),
                           lambda: correlation._correlation_torch(*a, **k), torch)
        dk = graph_ms(lambda: correlation.correlation(*a, **k), torch)
        dp = graph_ms(lambda: correlation._correlation_torch(*a, **k), torch, reps=1)
        dt = graph_ms(lambda: correlation.correlation(*a, **k, taps=taps,
                                                      out=dec[:, :len(taps)]), torch)
        r["taps_device_ms"] += dt
        r["levels"].append(dict(shape=list(f1.shape), device_ms=dk, taps_device_ms=dt,
                                plan=correlation.plan(*f1.shape, k.get("max_displacement", 4))))
        # each input read once, the 81 planes written once; a multiply-add
        # per channel, tap and pixel
        flops = 2 * f1.numel() * got.shape[1]
        tb, by = conv_bound(flops, nbytes([f1, f2, got]), "float32")
        t_ops += flops / PEAK_FLOPS["float32"] * 1e3
        t_bytes += nbytes([f1, f2, got]) / HBM_BYTES_PER_S * 1e3
        log(f"[data] correlation {tuple(f1.shape)} -> {tuple(got.shape)}: rel err {rel:.3e} "
            f"(limit {CORR_REL_TOL:g}); the {len(taps)} taps in place identical; kernel "
            f"{tk:.4f} ms ({dk:.4f} on the device; the taps in place {dt:.4f}), plain "
            f"{tp:.4f} ms ({dp:.4f}), bound {tb:.4f} ms ({by})")
        r["ms"] += tk
        r["plain_ms"] += tp
        r["device_ms"] += dk
        r["plain_device_ms"] += dp
        r["bound_ms"] += tb
    r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    log(f"[data] correlation per {PAIRS}-pair call (5 levels): kernel {r['ms']:.4f} ms "
        f"({r['device_ms']:.4f} on the device; the taps in place {r['taps_device_ms']:.4f}), "
        f"plain {r['plain_ms']:.4f} ms "
        f"({r['plain_device_ms']:.4f}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{smi}]")
    del calls
    profile_call(torch, lambda: pair_flow(images[:PAIRS], images[1:PAIRS + 1]), smi,
                 f"pair-flow call ({PAIRS} pairs)")

    # (b) FastFlowNet on the card against the CPU, the same weights
    cpu_flow = mvsec.fastflownet_pair_flow(sd, device="cpu")
    got, want = pair_flow(images[:2], images[1:3]), cpu_flow(images[:2], images[1:3])
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    log(f"[data] FastFlowNet card vs CPU, 2 pairs {H}x{W}: flow up to "
        f"{float(np.abs(want).max()):.4f} px, relative error {rel:.3e} (limit {FLOW_REL_TOL:g})")
    if got.shape != (2, 2, H, W) or not np.isfinite(got).all() or rel > FLOW_REL_TOL:
        raise AssertionError("FastFlowNet on the card disagrees with the CPU")

    # (c) the converter, counted. The GPU machine's Python installation
    # has no h5py, so this drives `convert_mvsec_arrays`, the command
    # line's steps after its h5 read, with the weights loaded from the .pt
    # as `--fastflownet_ckpt` loads them.
    log("[data] h5py is not installed on the card: the h5 reader (convert_mvsec_h5, the "
        "command line) ran only in the CPU tests; this drives convert_mvsec_arrays")
    flow_s = []

    def timed(fn):
        def inner(a, b):
            t0 = time.time()
            out = fn(a, b)                       # numpy out: the card has finished
            flow_s.append(time.time() - t0)
            return out
        return inner

    out_dir = os.path.join(OUT, "packets")
    convert = lambda d: mvsec.convert_mvsec_arrays(  # noqa: E731
        *rec, d, "synth_left", pair_flow_fn=timed(mvsec.fastflownet_pair_flow(sd, device=DEVICE)))
    convert(os.path.join(OUT, "packets_warm"))           # warm-up (cuDNN, allocator)
    flow_s.clear()
    t0 = time.time()
    written = counted("mvsec data", ("correlation",), lambda: convert(out_dir),
                      f"convert_mvsec_arrays, {n} frames {H}x{W}, FastFlowNet from {ckpt}")
    wall = time.time() - t0
    launches = counted.by_path["mvsec data"]["correlation"]
    if written != (n - 1) // 16 or launches != 10 * written:
        raise AssertionError(f"{written} packets and {launches} K8 launches, expected "
                             f"{(n - 1) // 16} and {10 * ((n - 1) // 16)}")
    names = sorted(os.listdir(out_dir))
    for i, name in enumerate(names):
        with open(os.path.join(out_dir, name), "rb") as f:
            pkt = pickle.load(f)
        for key in ("optical_flow", "acc_flow"):
            v = pkt[key]
            if v.shape != (16, 2, H, W) or v.dtype != np.float32 or not np.isfinite(v).all():
                raise AssertionError(f"{name} {key}: {v.shape} {v.dtype}, or not finite")
        if i == 0 and not np.array_equal(pkt["acc_flow"][0], pkt["optical_flow"][0]):
            raise AssertionError("the file's first acc_flow is not its forward flow")
    log(f"[data] {written} packets in {wall:.3f} s: {wall / written * 1e3:.2f} ms a packet, "
        f"{statistics.median(flow_s) * 1e3:.2f} ms a pair-flow call (median of "
        f"{len(flow_s)}, {PAIRS} pairs), K8 {launches} launches [{smi}]")

    # (d) the packets back into batches on the card
    ds = EventPackDataset("train", out_dir)
    t0 = time.time()
    host = list(iterate_batches(ds, 2, num_workers=2))
    t1 = time.time()
    batches = list(device_prefetch(iter(host), device=DEVICE))
    torch.cuda.synchronize()
    load_s, copy_s = t1 - t0, time.time() - t1
    want = {"image_units": (2, 16, H, W, 2), "voxels": (2, 16, H, W, 20), "imu": (2, 16, 6),
            "flows": (2, 16, H, W, 4), "lfr": (2, 16, H, W, 1)}
    b = batches[0] if len(batches) == 1 else {}
    shapes = {k: (tuple(v.shape), str(v.dtype), v.device.type) for k, v in b.items()}
    if (sorted(b) != sorted(want) or any(
            shapes[k] != (want[k], "torch.float32", dev.type) for k in want)
            or not all(torch.isfinite(v).all() for v in b.values())):
        raise AssertionError(f"the dataset's batches: {len(batches)}, {shapes}")
    log(f"[data] EventPackDataset -> iterate_batches: 1 batch of 2 in {load_s * 1e3:.1f} ms "
        f"(host); device_prefetch {copy_s * 1e3:.1f} ms ({nbytes(batches) / 1e6:.1f} MB "
        f"pinned and copied); {shapes}")
    # the device voxelizer against the numpy one on one interval's events
    ev = mvsec._to_structured(rec[3][rec[2][0]:rec[2][1]])
    ref = gen_discretized_event_volume_np(ev, (20, H, W))
    t = lambda f: torch.from_numpy(ev[f].astype(np.int32)).to(dev)  # noqa: E731
    vol = gen_discretized_event_volume(t("timestamp"), t("x"), t("y"), t("polarity"),
                                       torch.ones(len(ev), dtype=torch.bool, device=dev),
                                       (20, H, W)).cpu().numpy()
    # f32 timestamps (the jnp version's arithmetic) against the numpy
    # splat's f64: the JAX package's own bound for the pair, 1e-4
    rel = float(np.abs(vol - ref).max() / np.abs(ref).max())
    log(f"[data] gen_discretized_event_volume on the card, {len(ev)} events: {rel:.3e} "
        f"relative to the numpy splat (limit 1e-4)")
    if rel > 1e-4:
        raise AssertionError("the device voxelizer disagrees with the numpy one")
    return {"correlation": r}, err


class Tee:
    """Writes to stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def sass_mix():
    """{kernel: {"registers": n, "sass_per_round": {opcode: count}}} of the
    op-chain kernels K13 and K14: `csrc/roofline.cu` compiled alone to a
    cubin (the library's flags, ptxas -v) and disassembled with cuobjdump,
    counted by `rounds_mix`."""
    from v2ce_toolbox_tpu_torch.ops import _cuda

    nvcc = _cuda._nvcc()
    src = os.path.join(_cuda._CSRC, "roofline.cu")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "roofline.cubin")
        built = subprocess.run([nvcc, *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-cubin", "-o", cubin,
                                src], capture_output=True, text=True, check=True)
        sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True, check=True).stdout
    with open(src) as fh:
        live = [int(n) for n in re.findall(r"constexpr int kLive1[34] = (\d+)", fh.read())]
    out = rounds_mix(sass, built.stderr, dict(zip(("op_chain", "op_chain_ilp"), live)))
    for name, mix in out.items():
        log(f"[probe] {name} SASS a round ({mix['registers']} registers): "
            + ", ".join(f"{k} {v:g}" for k, v in mix["sass_per_round"].items()))
    return out


def rounds_mix(sass, ptxas_log, live):
    """Per op-chain kernel of `sass` (cuobjdump -sass): the innermost loop
    that holds the rounds' XORs (LOP3 with LUT 0x78), its instructions
    counted by opcode and divided by its rounds (one XOR a chain a round,
    live[kernel] chains), and the registers from `ptxas_log`."""
    regs = dict(re.findall(r"Compiling entry function '(\S+)'.*?Used (\d+) registers",
                           ptxas_log, re.S))
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        mangled = fn.split("\n", 1)[0].strip()
        if "op_chain_kernel" not in mangled:
            continue
        name = "op_chain" if "ILi1E" in mangled else "op_chain_ilp"
        ins = [(int(a, 16), op) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", fn)]
        loops = []
        for a, op in ins:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) < a:
                body = [o for b, o in ins if int(m.group(1), 16) <= b <= a]
                if any(o.startswith("LOP3") and "0x78" in o for o in body):
                    loops.append(body)
        body = min(loops, key=len)
        rounds = sum(1 for o in body if o.startswith("LOP3") and "0x78" in o) / live[name]
        ops = {}
        for o in body:
            op = re.sub(r"^@!?U?P\w+\s+", "", o).split()[0]
            ops[op] = ops.get(op, 0) + 1
        out[name] = {"registers": int(regs.get(mangled, 0)), "sass_loop_rounds": rounds,
                     "sass_per_round": {k: v / rounds for k, v in
                                        sorted(ops.items(), key=lambda kv: -kv[1])}}
    if set(out) != {"op_chain", "op_chain_ilp"}:
        raise AssertionError(f"the rounds loop of K13 and K14 not found in the SASS: {set(out)}")
    return out


def probe_phase(torch, np, dev, counted, smi):
    """Phase 12: the probe harness's kernels against their twins at the
    probes' full-width shapes, then the probe CLI, counted. Returns
    ({case: ms, plain_ms, library_ms, bound_ms, bound_by, ...}, {kernel:
    max abs err}, the stage-2 roofline's measured rates)."""
    import torch.nn.functional as F

    from v2ce_toolbox_tpu_torch.ops import (barrier, compact, conv3d, conv3d_quad, conv3d_wino4,
                                            roofline)
    from v2ce_toolbox_tpu_torch.tools import perf_probe

    n = N_PROBE_TIMED
    results, errs, s122_live, wino_exact, wino_calls = {}, {}, [], [], []

    def add(label, tk, tp, tl, tb, by, **extra):
        r = results.setdefault(label, dict(ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
                                           t_ops=0.0, t_bytes=0.0))
        r["ms"] += tk
        r["plain_ms"] += tp
        if tl is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + tl
        r["bound_ms"] += tb
        r["t_ops" if by == "operations" else "t_bytes"] += tb
        r.update(extra)

    def check_conv(name, label, got, want, dname, slack=0.0):
        rel = rel_err(got, want)
        tol = (WINO_REL_TOL if name == "conv3d_wino4" else CONV_REL_TOL)[
            str(got.dtype).split(".")[1]] + slack
        abs_err = float((got.float() - want.float()).abs().max())
        if not (torch.isfinite(got.float()).all() and got.shape == want.shape and rel <= tol):
            raise AssertionError(f"{name} {dname} {label}: {rel:.3e} from its twin "
                                 f"(limit {tol:g})")
        if dname == "bfloat16":
            errs[name] = max(errs.get(name, 0.0), abs_err)
        return rel, tol

    # (a) K11 on every layer of `quad` (stride 1) and `quad_s2` (stride 1,2,2)
    layers = ([(lay, False) for lay in perf_probe.QUAD_LAYERS]
              + [(lay, True) for lay in perf_probe.QUAD_S2_LAYERS])
    for (name, h, w, cin, cout), strided in layers:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            g = torch.Generator(device=dev).manual_seed(cin * cout)
            x = torch.rand((1, 16, h, w, cin), generator=g, device=dev).to(dtype)
            k = (torch.rand((3, 3, 3, cin, cout), generator=g, device=dev) * 0.01).to(dtype)
            if strided:
                kernel = lambda: conv3d_quad.conv3d_quad_s122(x, k)  # noqa: E731
                plain = lambda: conv3d_quad._quad_core_torch(*conv3d_quad.fold_s122(x, k))  # noqa: E731
                stride, ho, wo = (1, 2, 2), -(-h // 2), -(-w // 2)
            else:
                kernel = lambda: conv3d_quad.conv3d_quad(x, k)  # noqa: E731
                plain = lambda: conv3d_quad._quad_core_torch(  # noqa: E731
                    F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)), k)
                stride, ho, wo = 1, h, w
            with torch.no_grad():
                got = kernel()
                rel, tol = check_conv("conv3d_quad", name, got, plain(), dname)
                xl, wl = x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2).contiguous()
                flops = 2 * 16 * ho * wo * cin * cout * 27
                tb, by = conv_bound(flops, nbytes([x, k, got]), dname)
                tk, tp = time_pair(kernel, plain, torch, n)
                tl = time_one(lambda: F.conv3d(xl, wl, stride=stride, padding=1), torch, n)
            extra = ""
            if strided and dtype == torch.bfloat16:
                # the live steps of fold_s122's weights against the direct conv
                k4 = conv3d_quad.fold_s122(x[:, :1, :2, :2], k)[1]
                kt = k4.permute(0, 1, 2, 4, 3).reshape(1, 12, cout, 4 * cin)
                share = live_share(conv3d, kernel, kt, conv3d.gemm_tiles(4 * cin, cout))
                direct = 27 * cin * cout
                s122_live.append(dict(layer=name, live_macs=share[0], dense_macs=share[1],
                                      direct_macs=direct))
                extra = (f"; live steps (the kernel's table, equal to its twin's) "
                         f"{share[0] / direct:.3f} of the direct conv's multiply-adds "
                         f"({share[1] / direct:.3f} dense)")
            log(f"[probe] conv3d_quad {dname} {name} (1, 16, {h}, {w}, {cin}) -> {cout}"
                f"{' stride (1,2,2)' if strided else ''}: rel err {rel:.3e} (limit {tol:g}); "
                f"kernel {tk:.4f} ms ({flops / tk / 1e9:.1f} TFLOP/s), plain {tp:.4f} ms, "
                f"cuDNN {tl:.4f} ms, bound {tb:.4f} ms ({by}){extra}")
            add(f"conv3d_quad[{dname}]", tk, tp, tl, tb, by)
            del x, k, got, xl, wl
    results["conv3d_quad[bfloat16]"]["live_steps_s122"] = s122_live
    torch.cuda.empty_cache()

    # K12 on the three `wino_pallas` shapes; 'nodot' identical to the twin;
    # in f32 also against the direct conv summed in f64 (the exact sum,
    # rounded once), within the same bound
    for name, xshape, cout in perf_probe.WINO_SHAPES:
        cin = xshape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            g = torch.Generator(device=dev).manual_seed(cin * cout)
            x = (torch.rand(xshape, generator=g, device=dev) - 0.5).to(dtype)
            k = (torch.rand((3, 3, 3, cin, cout), generator=g, device=dev) * 0.05).to(dtype)
            kernel = lambda: conv3d_wino4.conv3d_wino4(x, k)  # noqa: E731
            plain = lambda: conv3d_wino4._conv3d_wino4_torch(x, k)  # noqa: E731
            with torch.no_grad():
                got = kernel()
                twin64 = 0.0
                if dtype == torch.float32:
                    exact = F.conv3d(x.double().permute(0, 4, 1, 2, 3),
                                     k.double().permute(4, 3, 0, 1, 2), padding=1)
                    exact = exact.permute(0, 2, 3, 4, 1)
                    rel64 = float((got.double() - exact).abs().max() / exact.abs().max())
                    twin64 = float((plain().double() - exact).abs().max() / exact.abs().max())
                    wino_exact.append(dict(shape=name, kernel=rel64, twin=twin64))
                    tol64 = WINO_REL_TOL["float32"]
                    log(f"[probe] conv3d_wino4 float32 {name}: kernel {rel64:.3e}, twin "
                        f"{twin64:.3e} from the f64 direct conv (limit {tol64:g})")
                    if not rel64 <= tol64:
                        raise AssertionError(f"conv3d_wino4 float32 {name}: {rel64:.3e} from "
                                             f"the f64 direct conv (limit {tol64:g})")
                    del exact
                rel, tol = check_conv("conv3d_wino4", name, got, plain(), dname, twin64)
                same = torch.equal(conv3d_wino4.conv3d_wino4(x, k, ablate="nodot"),
                                   conv3d_wino4._conv3d_wino4_torch(x, k, ablate="nodot"))
                if not same:
                    raise AssertionError(f"conv3d_wino4 {dname} {name}: 'nodot' differs from "
                                         "its twin")
                xl, wl = x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2).contiguous()
                # the TPU kernel's own cost: the direct conv's FLOPs x 36 / 144
                flops = 2 * int(np.prod(xshape[:4])) * cin * cout * 27 * 36 // 144
                tb, by = conv_bound(flops, nbytes([x, k, got]), dname)
                tk, tp = time_pair(kernel, plain, torch, n)
                tl = time_one(lambda: F.conv3d(xl, wl, padding=1), torch, n)
                # the device alone: replays of a CUDA graph of the call; the
                # kernels one call launches; the memory it takes
                dk = graph_ms(kernel, torch, reps=2)
                want = ({"wino4_input_bf16_kernel": 1, "wino4_fused_kernel": 1,
                         "live_steps_kernel": 1}
                        if dtype == torch.bfloat16 else
                        {"wino4_input_kernel": 1, "conv_taps_f32_kernel": 1,
                         "wino4_output_kernel": 1})
                counts = listed_launches(kernel, want, f"conv3d_wino4 {dname} {name}", torch)
                scratch = peak_scratch(kernel, torch)
            own, other, _, own_ms = counts
            how = ("launches a call (device ms): " + ", ".join(
                f"{k_} {c_} ({'-' if own_ms is None else f'{own_ms[k_]:.4f}'})"
                for k_, c_ in sorted(own.items())) + f" (+ {other} PyTorch kernels around it)")
            log(f"[probe] conv3d_wino4 {dname} {name} {xshape} -> {cout}: rel err {rel:.3e} "
                f"(limit {tol:g}), 'nodot' identical; kernel {tk:.4f} ms ({dk:.4f} on the device), "
                f"plain {tp:.4f} ms, cuDNN {tl:.4f} ms, bound {tb:.4f} ms ({by}, "
                f"{flops / 1e9:.1f} Winograd GFLOP); {how}; peak scratch {scratch / 1e6:.1f} MB "
                f"with the {nbytes(got) / 1e6:.1f} MB output [{smi}]")
            add(f"conv3d_wino4[{dname}]", tk, tp, tl, tb, by)
            r12 = results[f"conv3d_wino4[{dname}]"]
            r12["device_ms"] = r12.get("device_ms", 0.0) + dk
            wino_calls.append(dict(shape=name, dtype=dname, ms=tk, device_ms=dk,
                                   launches=own, other_launches=other,
                                   kernel_device_ms=own_ms, peak_bytes=scratch))
            del x, k, got, xl, wl
    results["conv3d_wino4[bfloat16]"]["f32_rel_err_vs_f64"] = wino_exact
    results["conv3d_wino4[bfloat16]"]["calls"] = wino_calls
    torch.cuda.empty_cache()

    def add_exact(name, label, kernel, plain, library, bound, by="bytes", note="", **extra):
        """An integer or copy kernel: identical to its twin; CUDA-event ms of
        kernel, twin and library call, and the device ms of the kernel and
        the library call from CUDA-graph replays (these kernels take less
        time than the wrapper's Python); `note` ends the log line. Returns
        the kernel's device ms."""
        got, want = kernel(), plain()
        err = max_abs_err(got if isinstance(got, tuple) else (got,),
                          want if isinstance(want, tuple) else (want,))
        if err != 0:
            raise AssertionError(f"{name} {label} differs from its plain twin: {err}")
        errs[name] = 0
        tk, tp = time_pair(kernel, plain, torch, n)
        tl = time_one(library, torch, n) if library is not None else None
        dk = graph_ms(kernel, torch)
        dl = graph_ms(library, torch) if library is not None else None
        log(f"[probe] {name} {label}: identical; kernel {tk:.4f} ms ({dk:.4f} on the device), "
            f"plain {tp:.4f} ms, library {'-' if tl is None else f'{tl:.4f} ms'}"
            f"{'' if dl is None else f' ({dl:.4f} on the device)'}, bound {bound:.4f} ms ({by})"
            + note)
        if dl is not None:
            extra["library_device_ms"] = dl
        add(name, tk, tp, tl, bound, by, device_ms=dk, **extra)
        return dk

    # K2w at the chain-compaction shape of `compact_algo`, with the payload;
    # each of its calls here, and probe_compact's without a payload, one
    # kernel after one memset (no pad or copy)
    rng = np.random.RandomState(0)   # K13-K16's inputs below come after these
    keys, pays = probe_rows(np, 0.1, True, rng)
    kk, pp = torch.from_numpy(keys).to(dev), torch.from_numpy(pays).to(dev)
    r, nn = keys.shape
    kw = dict(cap=1 << 14, chunk=16384)
    out = compact.compact_rows(kk, [pp], algo="window", **kw)
    floor_ms, floor_bytes = sector_floor(kk, [pp], out, kw["cap"])
    per_call = [listed_call(f"compact_rows_window ({r}, {nn}) -> {kw['cap']} +pay",
                            lambda: compact.compact_rows(kk, [pp], algo="window", **kw), 1,
                            torch),
                listed_call(f"compact_rows_window ({r}, {nn}) -> 65536",
                            lambda: compact.compact_rows(kk, algo="window", cap=1 << 16,
                                                         chunk=8192), 1, torch)]
    add_exact("compact_rows_window", f"({r}, {nn}) cap {kw['cap']} chunk {kw['chunk']}",
              lambda: compact.compact_rows(kk, [pp], algo="window", **kw),
              lambda: compact.compact_rows_torch(kk, [pp], **kw), None,
              bound_ms("compact_rows", (kk, [pp]), kw, out),
              note=f", payload-sector floor {floor_ms:.4f} ms ({floor_bytes / 1e6:.1f} MB)",
              sector_floor_ms=floor_ms, kernel_launches_per_call=per_call)
    del kk, pp, out

    # K7 on the window's voxels
    vox = torch.rand((1, 16, H, W, 20), device=dev)
    add_exact("layout_barrier", f"{tuple(vox.shape)} f32", lambda: barrier.layout_barrier(vox),
              lambda: barrier._layout_barrier_torch(vox), vox.clone,
              2 * nbytes(vox) / HBM_BYTES_PER_S * 1e3)
    del vox

    # K13-K16 at the roofline's grid: (144, 11, 128, 128) int32. The op
    # chains' bound counts the ops that touch data, an XOR and an add a round
    # and chain (k/2 an element: the rolls are a change of position and the
    # lane test a constant of it), at the card's int32 issue rate; the gate
    # holds the same count against the same rate at each k (no kernel issues
    # them faster) and wants the time to rise with k. The slope between the
    # two k is printed, not gated: at k=64 the reads bound the time. The JAX
    # probe's el-op rate (k an element, the TPU's four vector ops a round)
    # is printed beside it
    sc, n_chunks = 16384 // 128, -(-(2 * H * W) // 16384)
    xr = torch.from_numpy(rng.randint(0, 1 << 30, (144, n_chunks, sc, 128))
                          .astype(np.int32)).to(dev)
    total_el = xr.numel()
    issue = perf_probe.int32_issue_rate(dev)
    rates = {}
    for name, fn, plain in [("op_chain", roofline.op_chain, roofline._op_chain_torch),
                            ("op_chain_ilp", roofline.op_chain_ilp,
                             roofline._op_chain_ilp_torch)]:
        ts = {}
        for kk_ in (K_LO, K_HI):
            t_ops = kk_ // 2 * total_el / issue * 1e3
            t_bytes = (nbytes(xr) + total_el // n_chunks * 4) / HBM_BYTES_PER_S * 1e3
            bound, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
            if kk_ == K_HI:
                ts[kk_] = add_exact(name, f"k={kk_}", lambda: fn(xr, kk_), lambda: plain(xr, kk_),
                                    None, bound, by, k=kk_)
            else:
                got = fn(xr, kk_)
                if not torch.equal(got, plain(xr, kk_)):
                    raise AssertionError(f"{name} k={kk_} differs from its plain twin")
                ts[kk_] = graph_ms(lambda: fn(xr, kk_), torch)
                log(f"[probe] {name} k={kk_}: identical; {ts[kk_]:.4f} ms on the device, bound "
                    f"{bound:.4f} ms ({by})")
        rate = (K_HI - K_LO) * total_el / ((ts[K_HI] - ts[K_LO]) / 1e3)
        data = {k: k // 2 * total_el / (t / 1e3) for k, t in ts.items()}
        rates[name] = rate
        results[name].update(k_lo_device_ms=ts[K_LO], el_ops_per_s=rate,
                             data_ops_per_s=data[K_HI], data_ops_per_s_k_lo=data[K_LO],
                             data_ops_slope_per_s=rate / 2, issue_ops_per_s=issue)
        log(f"[probe] {name}: on the device k={K_LO} {ts[K_LO]:.4f} ms, k={K_HI} "
            f"{ts[K_HI]:.4f} ms -> {rate / 1e12:.3f} T el-ops/s (JAX count); data ops (k/2 an "
            f"element) {data[K_HI] / 1e12:.3f} T/s at k={K_HI} ({data[K_HI] / issue:.1%} of the "
            f"int32 issue rate {issue / 1e12:.2f} T/s), {data[K_LO] / issue:.1%} at k={K_LO}, "
            f"{rate / 2 / issue:.1%} from the slope [{smi}]")
        if not (ts[K_HI] > ts[K_LO] and max(data.values()) < issue):
            raise AssertionError(f"{name}: the time does not rise with k, or the data ops "
                                 f"run faster than the card's int32 issue rate ({ts}, "
                                 f"{max(data.values()):.3e} > {issue:.3e} ops/s)")
    for name, mix in sass_mix().items():
        results[name].update(mix)
    copy_bound = 2 * nbytes(xr) / HBM_BYTES_PER_S * 1e3
    for name, fn in [("stream_copy", roofline.stream_copy),
                     ("stream_copy_row", roofline.stream_copy_row)]:
        tk = add_exact(name, f"{tuple(xr.shape)} int32", lambda: fn(xr),
                       lambda: roofline._stream_copy_torch(xr), xr.clone, copy_bound)
        rates[name] = 2 * nbytes(xr) / (tk / 1e3)
        clone_rate = 2 * nbytes(xr) / (results[name]["library_device_ms"] / 1e3)
        results[name].update(bytes_per_s=rates[name], library_bytes_per_s=clone_rate)
        log(f"[probe] {name}: {rates[name] / 1e9:.1f} GB/s read + write on the device, "
            f"{rates[name] / HBM_BYTES_PER_S:.1%} of the nominal 3.35 TB/s; clone() "
            f"{clone_rate / 1e9:.1f} GB/s, the kernel's time {clone_rate / rates[name]:.3f}x "
            f"clone()'s [{smi}]")
    del xr
    torch.cuda.empty_cache()
    for r in results.values():
        r["bound_by"] = "operations" if r.pop("t_ops") >= r.pop("t_bytes") else "bytes"

    # (b) the probe CLI, all eight probes, counted
    probes = list(perf_probe.KERNEL_PROBES)
    tee = Tee(sys.stdout)
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        probe_out = counted("probe CLI", PROBE_KERNELS + ("compact_rows", "gen_pack"),
                            lambda: perf_probe.main(probes),
                            f"python -m v2ce_toolbox_tpu_torch.tools.perf_probe "
                            f"{' '.join(probes)}")
    text = "".join(tee.parts)
    failed = [ln.split(":")[0] for ln in text.splitlines() if "FAILED" in ln]
    if failed != ["wino4 bf16 [noinv]", "wino4 f32 [noinv]"]:
        raise AssertionError(f"the probe CLI printed FAILED for {failed}, not only for "
                             "wino_ablate [noinv]")
    roof = probe_out["stage2_roofline"]
    log(f"[probe] the probe CLI ran in {time.time() - t0:.1f} s; FAILED only for {failed}; "
        f"stage2_roofline: serial {roof['op_rate'] / 1e12:.3f} T el-ops/s, 4 chains "
        f"{roof['ilp_rate'] / 1e12:.3f}, stream copy {roof['stream_rate'] / 1e9:.1f} GB/s "
        f"(64 KB blocks), {roof['row_rate'] / 1e9:.1f} GB/s (704 KB blocks) [{smi}]")
    return results, errs, {"phase 12": rates, "probe CLI": {k: roof[k] for k in (
        "op_rate", "ilp_rate", "stream_rate", "row_rate")}}


def _probe_numbers(res, key=()):
    """(key path, value) of every leaf of a probe's result (nested dicts)."""
    for k, v in res.items():
        if isinstance(v, dict):
            yield from _probe_numbers(v, key + (k,))
        else:
            yield key + (k,), v


def _run_probes(torch, np, counted, names):
    """Each probe of `names` once at its JAX shapes through
    `perf_probe.main`, counted: the kernels its module's KERNELS names must
    launch; no line may print FAILED; every number it returns must be
    finite (None only where PROBE17_NOT_PORTED allows it). Returns
    ({probe: result}, {probe: seconds})."""
    from v2ce_toolbox_tpu_torch.tools import perf_probe, probes_stage1, probes_stage2

    kernels = {**probes_stage2.KERNELS, **probes_stage1.KERNELS}
    results, seconds = {}, {}
    iters, perf_probe.N_ITERS = perf_probe.N_ITERS, N_PROBE17_ITERS
    try:
        for name in names:
            tee = Tee(sys.stdout)
            t0 = time.time()
            with contextlib.redirect_stdout(tee):
                out = counted(f"probe {name}", kernels[name],
                              lambda name=name: perf_probe.main([name]),
                              f"python -m v2ce_toolbox_tpu_torch.tools.perf_probe {name}")
            seconds[name] = time.time() - t0
            torch.cuda.empty_cache()
            failed = [ln for ln in "".join(tee.parts).splitlines() if "FAILED" in ln]
            if failed:
                raise AssertionError(f"probe {name} printed FAILED: {failed}")
            res = results[name] = out[name]
            allowed = PROBE17_NOT_PORTED.get(name, set())
            bad = [(k, v) for k, v in _probe_numbers(res)
                   if not (v is None and k[-1] in allowed)
                   and not (isinstance(v, (int, float)) and np.isfinite(v))]
            if bad:
                raise AssertionError(f"probe {name} returned non-finite numbers: {bad}")
    finally:
        perf_probe.N_ITERS = iters
    return results, seconds


def probes_phase(torch, np, counted, smi):
    """Phase 17: the 24 stage-1 and stage-2 probes of the probe harness
    (`probes_stage1`, `probes_stage2`), each once at its JAX shapes through
    `perf_probe.main`, counted: every kernel the probe names must launch;
    no line may print FAILED; every number it returns must be finite (None
    only where the probe prints "not applicable"); K9's
    rel_err in `pallas_conv` (from the conv of the same values summed in
    f64, relative to its largest output, as phase 12 holds K12's f32 route)
    within CONV_REL_TOL of its output dtype (f32 in both input dtypes; TF32
    off). Returns ({probe: result}, {probe: seconds})."""
    from v2ce_toolbox_tpu_torch.tools import probes_stage1, probes_stage2

    t_phase = time.time()
    results, seconds = _run_probes(torch, np, counted, [
        name for name in {**probes_stage2.KERNELS, **probes_stage1.KERNELS}
        if name not in PROBES19])
    tol = CONV_REL_TOL["float32"]                 # K9's output is f32 in both dtypes
    rel = {f"{shape} {dt}": r["rel_err"] for (shape, dt), r in results["pallas_conv"].items()}
    log("[probes] pallas_conv K9 rel_err from the conv of the same values summed in f64: "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + f" (limit {tol:g})")
    if len(rel) != 2 * len(probes_stage1.PALLAS_CONV_SHAPES) or max(rel.values()) > tol:
        raise AssertionError(f"pallas_conv: K9 rel_err past {tol:g} or a shape missing: {rel}")
    # where a window's stage-2 time goes: torch.profiler over one fused
    # window (`fused_phases`' last step, the whole `driver._flatten_rows`)
    from v2ce_toolbox_tpu_torch.config import SamplerConfig
    from v2ce_toolbox_tpu_torch.ops.ldati import make_draw

    dev = torch.device(DEVICE)
    v = probes_stage2.voxels(dev)
    window = probes_stage2.fused_phase_steps(v, make_draw(0, 0, dev), SamplerConfig(),
                                             probes_stage2.offsets(v.shape[0], dev))
    results["fused window profile"] = profile_call(
        torch, window["+ merge + side"], smi, "fused window (sample_rows + _flatten_rows, "
        f"{tuple(v.shape)})")
    del v, window
    torch.cuda.empty_cache()
    log(f"[probes] phase 17 in {time.time() - t_phase:.1f} s; per probe (s): "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + f" [{smi}]")
    return results, seconds


def _train_rel(a, b):
    """max |a - b| over the largest |b| (0 where both are all zero)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    top = float(b.abs().max()) if b.numel() else 0.0
    err = float((a - b).abs().max()) if b.numel() else 0.0
    return err / top if top else err


def train_step_phase(torch, np, dev, smi):
    """Phase 14 (a): one train step of the full-width V2ce3d with
    PatchDiscriminator2D, `train.main`'s default loss stack and gan_k, on
    the card and on the CPU from the same weights and batch
    (TRAIN_CMP_SHAPE; TF32 off). Returns the worst error of each group."""
    import copy

    from v2ce_toolbox_tpu_torch.config import ModelConfig, TrainConfig
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.train import gan, state as tstate, step as tstep
    from v2ce_toolbox_tpu_torch.train.main import build_parser

    args = build_parser().parse_args([])
    cfg = TrainConfig(loss="+".join(args.loss), lr=args.lr, weight_decay=args.weight_decay,
                      lr_scheduler=args.lr_scheduler)
    b, l, h, w = TRAIN_CMP_SHAPE
    rng = np.random.RandomState(0)
    batch = {"image_units": rng.randn(b, l, h, w, 2).astype(np.float32),
             "voxels": (rng.rand(b, l, h, w, 20) * 3
                        * (rng.rand(b, l, h, w, 20) < 0.2)).astype(np.float32)}
    model, disc = V2ce3d(ModelConfig()), gan.make_discriminator(args.gan_3d_conv)
    tstate.create_train_state(model, cfg, disc=disc, seed=0)          # seeded weights
    runs = {}
    for where in ("cpu", dev):
        m, d = copy.deepcopy(model).to(where), copy.deepcopy(disc).to(where)
        st = tstate.create_train_state(m, cfg, disc=d, init=False)
        step = tstep.make_train_step(m, cfg, disc=d, gan_k=args.gan_k)
        t0 = time.perf_counter()
        st, logs = step(st, {k: torch.from_numpy(v).to(where) for k, v in batch.items()})
        if where != "cpu":
            torch.cuda.synchronize()
        runs[str(where)] = (st, {k: float(v) for k, v in logs.items()},
                            time.perf_counter() - t0)
    (cs, clogs, cpu_s), (gs, glogs, card_s) = runs["cpu"], runs[str(dev)]
    errs, apart, moved = _step_errors(cs, clogs, gs, glogs, cfg, args.gan_k)
    share = apart / moved
    limits = TRAIN_LIMITS
    log(f"[train] one step, card vs CPU, full-width V2ce3d + PatchDiscriminator2D, batch "
        f"{TRAIN_CMP_SHAPE}, loss {cfg.loss}, gan_k {args.gan_k}: "
        + ", ".join(f"{k} {v:.3e} (limit {limits[k]:g})" for k, v in errs.items())
        + f"; generator elements moved apart by > 1e-3 lr: {apart} of {moved} ({share:.3%}, "
        f"limit {TRAIN_PARAM_SHARE:.0%}); loss card {glogs['loss']:.6f} CPU "
        f"{clogs['loss']:.6f}; step card {card_s:.2f} s, CPU {cpu_s:.2f} s [{smi}]")
    bad = [k for k, v in errs.items() if not v <= limits[k]]
    if (bad or not share <= TRAIN_PARAM_SHARE
            or not all(np.isfinite(v) for v in list(clogs.values()) + list(glogs.values()))):
        raise AssertionError(f"the card's train step disagrees with the CPU's: {bad}, "
                             f"share {share}")
    return errs


# phase 14's limits on one train step against another, by group
TRAIN_LIMITS = {"logs": TRAIN_LOG_REL_TOL, "BN statistics": TRAIN_STATE_REL_TOL,
                "SN vectors": TRAIN_STATE_REL_TOL, "generator Adam m1": TRAIN_GRAD_REL_TOL,
                "discriminator Adam m1": TRAIN_GRAD_REL_TOL,
                "generator params / (2 lr)": 1 + 1e-3, "discriminator params / (2 lr)": 1 + 1e-3}


def _step_errors(cs, clogs, gs, glogs, cfg, gan_k):
    """Train state gs after one step against cs (the reference), in phase
    14's groups (TRAIN_LIMITS): the largest error of each group, and the
    generator's elements moved apart by more than 1e-3 lr, of all moved."""
    errs = {"logs": max(abs(glogs[k] - v) / max(abs(v), 1e-30) for k, v in clogs.items())}
    csd, gsd = cs.model.state_dict(), gs.model.state_dict()
    for k, v in csd.items():
        if "running_" in k or k.endswith(("weight_u", "weight_v")):
            group = "BN statistics" if "running_" in k else "SN vectors"
            errs[group] = max(errs.get(group, 0.0), _train_rel(gsd[k], v))
    # parameters, in units of each net's lr times its updates, and the
    # generator's share of elements moved differently by more than 1e-3 lr
    disc_lr = cs.disc_opt.param_groups[0]["lr"]
    moved = apart = 0
    for net, c, g, reach in (("generator", cs.model, gs.model, cfg.lr),
                             ("discriminator", cs.disc, gs.disc, gan_k * disc_lr)):
        for (name, cp), gp in zip(c.named_parameters(), g.parameters()):
            d = (gp.detach().cpu() - cp.detach().cpu()).abs()
            errs[f"{net} params / (2 lr)"] = max(errs.get(f"{net} params / (2 lr)", 0.0),
                                                 float(d.max()) / (2 * reach))
            if net == "generator" and cp.requires_grad:
                apart += int((d > 1e-3 * cfg.lr).sum())
                moved += d.numel()
            if cp.requires_grad and TRAIN_DEAD_BIAS not in name:
                opt_c, opt_g = (cs.opt, gs.opt) if net == "generator" else (cs.disc_opt,
                                                                            gs.disc_opt)
                errs[f"{net} Adam m1"] = max(errs.get(f"{net} Adam m1", 0.0),
                                             _train_rel(opt_g.state[gp]["exp_avg"],
                                                        opt_c.state[cp]["exp_avg"]))
    return errs, apart, moved


def train_run_phase(torch, np, counted, smi):
    """Phase 14 (b), (c): `train.main` on the card at 260x346, batch
    TRAIN_BATCH, seq TRAIN_SEQ, counted (no port kernel may launch):
    TRAIN_STEPS steps of one epoch, the eval with previews and one recorded
    batch, then a run resumed from its checkpoints for one step. Every
    logged value finite, the checkpoints, preview and recorder written, the
    resumed run starting from the saved step. Returns its numbers."""
    import shutil

    from v2ce_toolbox_tpu_torch.data.dummy_data_gen import generate
    from v2ce_toolbox_tpu_torch.train import main as train_main

    data, logs = os.path.join(OUT, "train_packets"), os.path.join(OUT, "train_logs")
    for d in (data, logs):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.time()
    generate(data, num_packets=TRAIN_PACKETS, height=H, width=W)
    gen_s = time.time() - t0
    common = ["--data_dir", data, "--log_dir", logs, "--batch_size", str(TRAIN_BATCH),
              "--seq_len", str(TRAIN_SEQ), "--max_epochs", "1", "--log_frequency", "1",
              "--device", DEVICE, "--devices", "1"]

    def run():
        first = train_main.main(common + ["--exp_name", "full", "--record_predictions", "1",
                                          "--max_steps_per_epoch", str(TRAIN_STEPS)])
        resumed = train_main.main(common + [
            "--exp_name", "resumed", "--max_steps_per_epoch", "1", "--dump_previews", "false",
            "--load_dir", os.path.join(first["work_dir"], "checkpoints")])
        return first, resumed

    torch.cuda.empty_cache()
    t0 = time.time()
    (first, resumed), peak = peak_gib(torch, lambda: counted("training", (), run))
    wall = time.time() - t0
    launched = {k: c for k, c in counted.by_path["training"].items() if c}
    if launched:
        raise AssertionError(f"training launched port kernels: {launched}")

    def lines(work, kind):
        with open(os.path.join(work, "metrics.jsonl")) as f:
            return [x[kind] for x in map(json.loads, f) if kind in x]

    work = first["work_dir"]
    train, evals = lines(work, "train"), lines(work, "eval")
    ckpts = sorted(os.listdir(os.path.join(work, "checkpoints")))
    saved = torch.load(os.path.join(work, "checkpoints", "last"), map_location="cpu",
                       weights_only=True)["step"]
    rtrain = lines(resumed["work_dir"], "train")
    vals = [v for x in train + evals + rtrain for v in x.values()]
    ok = (len(train) == TRAIN_STEPS and len(evals) == 1 and all(np.isfinite(vals))
          and ckpts == ["best-epoch=0", "last"] and saved == TRAIN_STEPS
          and os.path.getsize(os.path.join(work, "previews", "epoch0.png")) > 0
          and os.path.exists(os.path.join(work, "recorder", "val-e0-b0.pkl"))
          and rtrain[0]["global_step"] == TRAIN_STEPS + 1 and resumed["state"].step
          == TRAIN_STEPS + 1)
    steps_ms = [s * 1e3 for s in first["step_s"]]
    warm = statistics.median(steps_ms[1:])
    losses = ", ".join(f"{x['loss']:.4f}" for x in train)
    log(f"[train] train.main on the card, {H}x{W}, batch {TRAIN_BATCH}, seq {TRAIN_SEQ}, "
        f"default loss stack (gan_k 3): steps {', '.join(f'{t:.1f}' for t in steps_ms)} ms, "
        f"median warm {warm:.1f} ms a step; resumed from step {saved}, its step "
        f"{resumed['step_s'][0] * 1e3:.1f} ms; peak {peak:.2f} GiB; losses {losses}, "
        f"resumed {rtrain[0]['loss']:.4f}; "
        f"eval BinaryMatchF1_sum_c {evals[0]['BinaryMatchF1_sum_c']:.4f}; "
        f"{TRAIN_PACKETS} packets made in {gen_s:.1f} s; both runs {wall:.1f} s (TF32 off) "
        f"[{smi}]")
    if not ok:
        raise AssertionError(f"train.main on the card: train lines {train}, evals {evals}, "
                             f"checkpoints {ckpts} (step {saved}), resumed {rtrain}")
    return {"step_ms": steps_ms, "median_warm_ms": warm, "peak_gib": peak}


def _card_vs_cpu(torch, model, x, dev):
    """model on the CPU and a copy on the card (eval, no grad) on x: the
    outputs (a list for the multi models), and the largest error over the
    largest |output|."""
    import copy

    with torch.no_grad():
        ref = model.eval()(x)
        got = copy.deepcopy(model).to(dev)(x.to(dev))
    refs, gots = (ref, got) if isinstance(ref, list) else ([ref], [got])
    rel = max(_train_rel(g, r) for g, r in zip(gots, refs))
    if not all(torch.isfinite(g).all() for g in gots) or float(refs[-1].abs().max()) == 0:
        raise AssertionError("a model's output on the card is not finite, or the CPU's is 0")
    return gots, rel


def _timed_forward(torch, model, x, n=3):
    """ms of a warm eval forward on the card (median of n) and the peak GiB."""
    with torch.no_grad():
        out, peak = peak_gib(torch, lambda: model(x))
        ms = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(ms), peak


def models_2d_phase(torch, np, dev, smi):
    """Phase 15 (a)-(c): V2ce2d, UNetPlain3D and ResNetDiscriminator at
    full width on seeded weights."""
    import copy

    from v2ce_toolbox_tpu_torch.models import ResNetDiscriminator, UNetPlain3D, V2ce2d
    from v2ce_toolbox_tpu_torch.pipeline.render import render_event_frames
    from v2ce_toolbox_tpu_torch.utils.weights import init_weights

    rng = np.random.RandomState(15)
    h, w = CMP_HW
    out = {}
    # (a) V2ce2d: card vs CPU at CMP_HW (eval), one train-mode forward and
    # backward on both (BN statistics, SN vectors), then the full window
    t0 = time.time()
    model = V2ce2d()
    init_weights(model, 0)
    x = torch.from_numpy(rng.randn(1, M_FRAMES, h, w, 2).astype(np.float32))
    (got,), rel = _card_vs_cpu(torch, model, x, dev)
    state = {}
    for where in ("cpu", dev):
        m = copy.deepcopy(model).to(where).train()
        m(x.to(where)).square().mean().backward()
        state[str(where)] = m.state_dict()
    errs = {"BN statistics": 0.0, "SN vectors": 0.0}
    for k, v in state["cpu"].items():
        if "running_" in k or k.endswith(("weight_u", "weight_v")):
            group = "BN statistics" if "running_" in k else "SN vectors"
            errs[group] = max(errs[group], _train_rel(state[str(dev)][k], v))
    gen = torch.Generator(dev).manual_seed(15)
    full = torch.randn(1, M_FRAMES, H, W, 2, device=dev, generator=gen)
    card = model.to(dev).eval()
    y, ms, peak = _timed_forward(torch, card, full)
    # the card's and the CPU's bin sums may round apart: a level at most
    frames = render_event_frames(y[0].clamp(min=0)).astype(np.int16)
    frames_cpu = render_event_frames(y[0].clamp(min=0).cpu()).astype(np.int16)
    render_levels = int(np.abs(frames - frames_cpu).max())
    log(f"[models] V2ce2d (multi, base 32, 4 encoders, BN, SN): card vs CPU at "
        f"{tuple(x.shape)} {rel:.3e} of the largest |output| (limit {STAGE1_REL_TOL:g}); "
        f"train-mode forward+backward card vs CPU: BN statistics {errs['BN statistics']:.3e}, "
        f"SN vectors {errs['SN vectors']:.3e} (limit {TRAIN_STATE_REL_TOL:g}); "
        f"{tuple(full.shape)} -> {tuple(y.shape)}: {ms:.2f} ms a forward, peak {peak:.2f} GiB; "
        f"render_event_frames {frames.shape} card vs CPU: {render_levels} uint8 levels apart "
        f"at most (limit 1) "
        f"({time.time() - t0:.1f} s) [{smi}]")
    if (rel > STAGE1_REL_TOL or max(errs.values()) > TRAIN_STATE_REL_TOL
            or tuple(y.shape) != (1, M_FRAMES, H, W, 20) or not torch.isfinite(y).all()
            or render_levels > 1 or got.shape != (1, M_FRAMES, h, w, 20)):
        raise AssertionError("V2ce2d on the card disagrees with the CPU")
    out["V2ce2d"] = {"ms": ms, "peak_gib": peak}
    del card, y, full
    torch.cuda.empty_cache()

    # (b) UNetPlain3D at its default widths, multi off and on
    for multi in (False, True):
        t0 = time.time()
        model = UNetPlain3D(PLAIN_IN, PLAIN_OUT, skip_type="concat", activation="sigmoid",
                            norm="BN", multi=multi)
        init_weights(model, 1)
        x = torch.from_numpy(rng.rand(1, M_FRAMES, h, w, PLAIN_IN).astype(np.float32))
        gots, rel = _card_vs_cpu(torch, model, x, dev)
        full = torch.rand(1, M_FRAMES, H, W, PLAIN_IN, device=dev, generator=gen)
        y, ms, peak = _timed_forward(torch, model.to(dev).eval(), full)
        y = y if multi else [y]
        log(f"[models] UNetPlain3D ({PLAIN_IN} in, {PLAIN_OUT} out, base 32, 4 encoders, "
            f"concat, BN, sigmoid, multi {multi}): card vs CPU at {tuple(x.shape)} {rel:.3e} "
            f"of the largest |output| (limit {STAGE1_REL_TOL:g}); {tuple(full.shape)} -> "
            f"{[tuple(t.shape) for t in y]}: {ms:.2f} ms a forward, peak {peak:.2f} GiB "
            f"({time.time() - t0:.1f} s) [{smi}]")
        if (rel > STAGE1_REL_TOL or len(y) != (4 if multi else 1)
                or tuple(y[-1].shape) != (1, M_FRAMES, H, W, PLAIN_OUT)
                or not all(torch.isfinite(t).all() for t in y)
                or not 0 <= float(y[-1].min()) <= float(y[-1].max()) <= 1):
            raise AssertionError(f"UNetPlain3D (multi {multi}) on the card disagrees with the CPU")
        out[f"UNetPlain3D multi={multi}"] = {"ms": ms, "peak_gib": peak}
        del model, y, full
        torch.cuda.empty_cache()

    # (c) ResNetDiscriminator on one V2ce3d window's frames
    t0 = time.time()
    model = ResNetDiscriminator()
    init_weights(model, 2)
    x = torch.from_numpy(rng.rand(M_FRAMES, H, W, 20).astype(np.float32) * 2)
    (got,), rel = _card_vs_cpu(torch, model, x, dev)
    _, ms, peak = _timed_forward(torch, model.to(dev).eval(), x.to(dev))
    log(f"[models] ResNetDiscriminator on {tuple(x.shape)} -> {tuple(got.shape)} logits: card "
        f"vs CPU {rel:.3e} of the largest |logit| (limit {STAGE1_REL_TOL:g}); {ms:.2f} ms a "
        f"forward, peak {peak:.2f} GiB ({time.time() - t0:.1f} s) [{smi}]")
    if rel > STAGE1_REL_TOL or tuple(got.shape) != (M_FRAMES, 2):
        raise AssertionError("ResNetDiscriminator on the card disagrees with the CPU")
    out["ResNetDiscriminator"] = {"ms": ms, "peak_gib": peak}
    return out


def event_graph(torch, np, rng):
    """A synthetic event graph: GRAPH_NODES nodes over GRAPHS graphs, pos =
    (x in [0, W), y in [0, H), t in [0, 1)), GRAPH_FEATS features, and
    GRAPH_DEG edges a node to the nodes that follow it in x order within
    its graph, each edge with 2 attributes."""
    n = GRAPH_NODES
    batch = np.repeat(np.arange(GRAPHS), n // GRAPHS).astype(np.int32)
    pos = np.stack([rng.rand(n) * W, rng.rand(n) * H, rng.rand(n)], 1).astype(np.float32)
    order = np.lexsort((pos[:, 0], batch))            # by graph, then x
    per = n // GRAPHS
    src = np.repeat(order, GRAPH_DEG)
    within = np.argsort(order) % per                  # each node's rank in its graph
    nxt = (np.repeat(within, GRAPH_DEG) + np.tile(np.arange(1, GRAPH_DEG + 1), n)) % per
    dst = order[np.repeat(batch, GRAPH_DEG) * per + nxt]
    ei = np.stack([src, dst]).astype(np.int32)
    x = rng.randn(n, GRAPH_FEATS).astype(np.float32)
    attr = rng.randn(ei.shape[1], 2).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, pos, batch, ei, attr)]


def graph_phase(torch, np, dev, smi):
    """Phase 15 (d): MaxPooling then MaxPoolingX on the synthetic event
    graph, the card against the CPU."""
    from v2ce_toolbox_tpu_torch.models.graph_pool import (MaxPooling, MaxPoolingX,
                                                          consecutive_cluster, voxel_grid)

    t0 = time.time()
    inputs = event_graph(torch, np, np.random.RandomState(16))

    def run(where):
        x, pos, batch, ei, attr = (t.to(where) for t in inputs)
        if where != "cpu":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        relabel = consecutive_cluster(voxel_grid(pos[:, :2], GRAPH_POOL, batch=batch))
        pooled = MaxPooling(GRAPH_POOL)(x, pos, batch=batch, edge_index=ei, edge_attr=attr)
        x_o, pos_o, b_o, _, _, k, _ = pooled
        valid = torch.arange(x.shape[0], device=x.device) < k
        size, cells = GRAPH_POOL_X
        px = MaxPoolingX(size, cells)(x_o, pos_o, b_o, num_graphs=GRAPHS, valid=valid)
        if where != "cpu":
            torch.cuda.synchronize()
        return [t.cpu() for t in pooled + (px,) + relabel], (time.perf_counter() - t1) * 1e3

    (cpu, cpu_ms), (card, _) = run("cpu"), run(dev)
    card, card_ms = run(dev)                                      # warm
    names = ("x", "pos", "batch", "edge_index", "edge_attr", "k", "n_edges", "x pooled",
             "ids", "clusters", "perm")
    exact = [n for i, n in enumerate(names) if i not in (1, 4)
             and not torch.equal(card[i], cpu[i])]
    sums = {n: _train_rel(card[i], cpu[i]) for i, n in enumerate(names) if i in (1, 4)}
    k, n_e = int(cpu[5]), int(cpu[6])
    log(f"[models] graph pooling: {GRAPH_NODES} nodes over {GRAPHS} graphs, {GRAPH_FEATS} "
        f"features, {inputs[3].shape[1]} edges; MaxPooling({GRAPH_POOL}) -> {k} clusters, "
        f"{n_e} edges; MaxPoolingX{GRAPH_POOL_X} -> {tuple(card[7].shape)}; card vs CPU: ids, "
        f"counts, perm, pooled batch, edges and max features identical: {not exact}; pos mean "
        f"{sums['pos']:.3e}, edge_attr {sums['edge_attr']:.3e} of the largest (limit "
        f"{GRAPH_SUM_REL_TOL:g}); warm card {card_ms:.2f} ms, CPU {cpu_ms:.1f} ms "
        f"({time.time() - t0:.1f} s) [{smi}]")
    if (exact or max(sums.values()) > GRAPH_SUM_REL_TOL or not 0 < k < GRAPH_NODES
            or not 0 < n_e < inputs[3].shape[1] or float(card[7].abs().max()) == 0):
        raise AssertionError(f"graph pooling on the card disagrees with the CPU: {exact}, {sums}")
    return {"card_ms": card_ms}


def eventgan_utils_phase(torch, np, dev, smi):
    """Phase 15 (e), (f): the EventGAN data on a synthetic 260x346
    recording, scale_events, the image gradient, the physical attention
    and the two packet tools, from_recarray and the native packer."""
    import io
    import pickle
    import shutil

    from v2ce_toolbox_tpu_torch import events
    from v2ce_toolbox_tpu_torch.data import eventgan
    from v2ce_toolbox_tpu_torch.data.dummy_data_gen import generate
    from v2ce_toolbox_tpu_torch.io import native
    from v2ce_toolbox_tpu_torch.tools import gen_phy_att, time_voxel_stat_calc
    from v2ce_toolbox_tpu_torch.utils.image_derivative import (
        get_batch_double_blurred_image_gradient)

    t0 = time.time()
    images, image_ts, inds, ev = make_recording(np, GAN_FRAMES, H, W, noise=GAN_NOISE)[:4]
    cfg = eventgan.EventGANDataConfig(image_size=GAN_CROP, start_time=0.0,
                                      n_time_bins=GAN_BINS, normalize_events=False)
    vols, shapes = [], set()
    for train in (False, True):
        seq = eventgan.MVSECSequence.from_arrays(cfg, images, image_ts, inds, ev, train=train)
        for i in range(0, len(seq), 4):
            item = seq[i]
            vols.append(item["event_volume"])
            shapes.add((item["prev_image"].shape, item["next_image"].shape,
                        item["event_volume"].shape))
    same, twin, edge, nonzeros = 0, 0, 0, []
    for v in vols:
        card = eventgan.normalize_event_volume_torch(torch.from_numpy(v).to(dev)).cpu()
        host = eventgan.normalize_event_volume(v.copy())
        cpu = eventgan.normalize_event_volume_torch(torch.from_numpy(v))
        n = int((v != 0).sum())
        nonzeros.append(n)
        # the host's k indices are f64, the twin's f32: at an n where they
        # truncate apart the two pick other order statistics
        apart = any(int(np.float32(np.float32(q) * np.float32(n))) != int(q * n)
                    for q in (0.02, 0.98))
        edge += apart
        twin += torch.equal(card, cpu)
        same += apart or card.numpy().tobytes() == host.tobytes()
    gen = np.random.RandomState(17).uniform(-1, 1, (4, GAN_CROP[0], GAN_CROP[0], 2, 4))
    gen = torch.from_numpy(gen.astype(np.float32))
    vs = (GAN_CROP[0], GAN_CROP[0], GAN_BINS)
    scaled_card = eventgan.scale_events(gen.to(dev), vs).cpu()
    scaled_equal = torch.equal(scaled_card, eventgan.scale_events(gen, vs))
    log(f"[models] EventGAN: MVSECSequence.from_arrays over a {GAN_FRAMES}-frame {H}x{W} "
        f"recording ({len(ev)} events, {GAN_NOISE} of them noise a gap), crop {GAN_CROP}, "
        f"{GAN_BINS} bins, {len(vols)} eval and train items, shapes {sorted(shapes)}, "
        f"{min(nonzeros)}-{max(nonzeros)} nonzeros a volume; normalize_event_volume_torch "
        f"card == CPU twin "
        f"on {twin} of {len(vols)}, == host on {same - edge} of {len(vols) - edge} ({edge} at "
        f"an f32/f64 k boundary); scale_events {tuple(gen.shape)} -> "
        f"{tuple(scaled_card.shape)} card == CPU: {scaled_equal} ({time.time() - t0:.1f} s)")
    if (twin != len(vols) or same != len(vols) or not scaled_equal or len(shapes) != 1
            or min(nonzeros) < GAN_MIN_NONZEROS
            or shapes != {((1, *GAN_CROP), (1, *GAN_CROP), (2 * GAN_BINS, *GAN_CROP))}):
        raise AssertionError("the EventGAN data on the card disagrees with the host")

    t0 = time.time()
    rng = np.random.RandomState(18)
    a, b = (torch.from_numpy(rng.rand(M_FRAMES, H, W, 1).astype(np.float32))
            for _ in range(2))
    grad_cpu = get_batch_double_blurred_image_gradient(a, b)
    grad_card = get_batch_double_blurred_image_gradient(a.to(dev), b.to(dev)).cpu()
    grad_rel = _train_rel(grad_card, grad_cpu)
    work = os.path.join(OUT, "phase15_packets")
    shutil.rmtree(work, ignore_errors=True)
    generate(work, num_packets=2, height=H, width=W)
    tools_out = []
    for tool, argv in ((gen_phy_att, ["--data_dir", work]),
                       (time_voxel_stat_calc, ["--data_dir", work, "--max_files", "2"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tool.main(argv)
        tools_out.append(buf.getvalue().strip().replace("\n", " | "))
    with open(os.path.join(work, sorted(os.listdir(work))[0]), "rb") as f:
        att = pickle.load(f)["physical_att"]
    shutil.rmtree(work, ignore_errors=True)
    rec = np.zeros(1000, events.EVENT_DTYPE)
    rec["timestamp"] = np.arange(1000)
    stream = events.from_recarray(rec, 4096)
    soa = [np.random.RandomState(19).randint(0, 30000, (16, 4096)).astype(np.int32)]
    soa[0].sort(axis=1)
    soa += [np.random.RandomState(20).randint(0, lim, (16, 4096)).astype(dt)
            for lim, dt in ((W, np.int16), (H, np.int16), (2, np.int8))]
    counts = np.random.RandomState(21).randint(0, 4096, 16).astype(np.int32)
    offs = (np.arange(16) * 33333).astype(np.int64)
    packed = native.pack_event_stream(*soa, counts, offs)
    packed_np = native._pack_event_stream_np(*soa, counts, offs,
                                             np.empty(int(counts.sum()), rec.dtype))
    log(f"[models] get_batch_double_blurred_image_gradient {tuple(a.shape)}: card vs CPU "
        f"{grad_rel:.3e} of the largest (limit {GRAD_REL_TOL:g}); gen_phy_att and "
        f"time_voxel_stat_calc on 2 {H}x{W} packets: {tools_out}, physical_att "
        f"{att.shape} in [{att.min():.3f}, {att.max():.3f}]; from_recarray on "
        f"{stream.t_us.device}; pack_event_stream native {native.native_available()} == numpy "
        f"on {len(packed)} events: {packed.tobytes() == packed_np.tobytes()}, first_inversion "
        f"{native.first_inversion(packed) if len(packed) else -1} ({time.time() - t0:.1f} s)")
    if (grad_rel > GRAD_REL_TOL or att.shape != (16, -(-H // 8), -(-W // 8))
            or not np.isfinite(att).all() or stream.t_us.device.type != torch.device(DEVICE).type
            or packed.tobytes() != packed_np.tobytes() or len(packed) != int(counts.sum())
            or native.first_inversion(packed) != -1):
        raise AssertionError("the utilities on the card disagree with the CPU or the host")


def models_phase(torch, np, dev, counted, smi):
    """Phase 15: the remaining models and utilities, counted (no port
    kernel may launch: they run on cuDNN convs, torch.sort and
    scatter_reduce). Returns each model's ms and peak GiB."""
    def run():
        out = models_2d_phase(torch, np, dev, smi)
        out["graph pooling"] = graph_phase(torch, np, dev, smi)
        eventgan_utils_phase(torch, np, dev, smi)
        return out

    torch.cuda.empty_cache()
    t0 = time.time()
    out = counted("phase 15", (), run)
    launched = {k: c for k, c in counted.by_path["phase 15"].items() if c}
    log(f"[models] phase 15 in {time.time() - t0:.1f} s; port kernels launched: "
        f"{launched or 'none'}")
    if launched:
        raise AssertionError(f"phase 15 launched port kernels: {launched}")
    return out


def _dp_snapshot(torch, st, logs):
    """A train state on the host: logs, the generator's state_dict and
    Adam first moments by name, the discriminator's parameters and
    moments."""
    def m1(module, opt):
        return {n: opt.state[p]["exp_avg"].detach().cpu() for n, p in module.named_parameters()
                if p.requires_grad}

    return {"logs": {k: float(v) for k, v in logs.items()},
            "model": {k: v.detach().cpu() for k, v in st.model.state_dict().items()},
            "m1": m1(st.model, st.opt),
            "disc": {k: v.detach().cpu() for k, v in st.disc.state_dict().items()},
            "disc_m1": m1(st.disc, st.disc_opt)}


def _dp_digest(snap):
    """One sha256 over every tensor of a snapshot but its logs, in key order."""
    import hashlib

    h = hashlib.sha256()
    for part in ("model", "m1", "disc", "disc_m1"):
        for k in sorted(snap[part]):
            h.update(k.encode() + snap[part][k].contiguous().numpy().tobytes())
    return h.hexdigest()


def _dp_step_errors(got, ref, lr, disc_reach):
    """Phase 14's comparison of two train steps from one state (logs, BN
    statistics, SN vectors, Adam first moments, parameters in units of
    each net's reach, the generator's share of elements moved apart by
    more than 1e-3 lr), on snapshots."""
    errs = {"logs": max(abs(got["logs"][k] - v) / max(abs(v), 1e-30)
                        for k, v in ref["logs"].items())}
    for k, v in ref["model"].items():
        if "running_" in k or k.endswith(("weight_u", "weight_v")):
            group = "BN statistics" if "running_" in k else "SN vectors"
            errs[group] = max(errs.get(group, 0.0), _train_rel(got["model"][k], v))
    moved = apart = 0
    for net, sd, m1, reach in (("generator", "model", "m1", lr),
                               ("discriminator", "disc", "disc_m1", disc_reach)):
        for name in ref[m1]:
            d = (got[sd][name].double() - ref[sd][name].double()).abs()
            key = f"{net} params / (2 lr)"
            errs[key] = max(errs.get(key, 0.0), float(d.max()) / (2 * reach))
            if net == "generator":
                apart += int((d > 1e-3 * lr).sum())
                moved += d.numel()
            if TRAIN_DEAD_BIAS not in name:
                key = f"{net} Adam m1"
                errs[key] = max(errs.get(key, 0.0), _train_rel(got[m1][name], ref[m1][name]))
    errs["generator share apart"] = apart / moved
    return errs


DP_LIMITS = {"logs": TRAIN_LOG_REL_TOL, "BN statistics": TRAIN_STATE_REL_TOL,
             "SN vectors": TRAIN_STATE_REL_TOL, "generator Adam m1": TRAIN_GRAD_REL_TOL,
             "discriminator Adam m1": TRAIN_GRAD_REL_TOL, "generator params / (2 lr)": 1 + 1e-3,
             "discriminator params / (2 lr)": 1 + 1e-3,
             "generator share apart": TRAIN_PARAM_SHARE}


def _dp_train_setup(torch, np, shape, remat=False):
    """train.main's defaults: the full-width V2ce3d (with `remat`),
    PatchDiscriminator2D, the default loss stack and gan_k, and a seeded
    global batch of `shape` (B, L, H, W) on the host."""
    from v2ce_toolbox_tpu_torch.config import ModelConfig, TrainConfig
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.train import gan
    from v2ce_toolbox_tpu_torch.train.main import build_parser

    args = build_parser().parse_args([])
    cfg = TrainConfig(loss="+".join(args.loss), lr=args.lr, weight_decay=args.weight_decay,
                      lr_scheduler=args.lr_scheduler)
    b, l, h, w = shape
    rng = np.random.RandomState(1)
    batch = {"image_units": rng.randn(b, l, h, w, 2).astype(np.float32),
             "voxels": (rng.rand(b, l, h, w, 20) * 3
                        * (rng.rand(b, l, h, w, 20) < 0.2)).astype(np.float32)}
    return (args, cfg, V2ce3d(ModelConfig(remat=remat)), gan.make_discriminator(args.gan_3d_conv),
            batch)


def _dp_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dp_train_step(torch, np, dev, mesh, shape, remat=False):
    """One train step at train.main's defaults on `dev`, seeded weights,
    alone (mesh None, the whole batch) or as a rank of `mesh` (its block).
    Returns the snapshot and the step's ms."""
    from v2ce_toolbox_tpu_torch.parallel.mesh import shard_batch
    from v2ce_toolbox_tpu_torch.train import state as tstate, step as tstep

    args, cfg, model, disc, batch = _dp_train_setup(torch, np, shape, remat)
    st = tstate.create_train_state(model, cfg, disc=disc, seed=0, mesh=mesh)
    model.to(dev)
    disc.to(dev)
    step = tstep.make_train_step(model, cfg, disc=disc, gan_k=args.gan_k, mesh=mesh)
    local = {k: torch.from_numpy(v).to(dev) for k, v in shard_batch(batch, mesh).items()}
    _dp_sync(torch, dev)
    t0 = time.perf_counter()
    st, logs = step(st, local)
    _dp_sync(torch, dev)
    return _dp_snapshot(torch, st, logs), (time.perf_counter() - t0) * 1e3


def dp_rank(mesh, clip, hw, out, ref_path, shape):
    """One rank of phase 16: `run` and `run_streaming` of the main path at
    `hw` (H, W) on the clip (the launch counters reset just before each and
    read just after), then, with `ref_path`, one train step on its block of
    a global batch of `shape`, and one with remat (the recompute runs the
    global-batch BN all_reduce again, in the backward), each held against
    the one-rank step without remat saved there."""
    import numpy as np
    import torch

    from v2ce_toolbox_tpu_torch import ops
    from v2ce_toolbox_tpu_torch.config import PipelineConfig
    from v2ce_toolbox_tpu_torch.pipeline.driver import V2cePipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    pipe = V2cePipeline(PipelineConfig(height=hw[0], width=hw[1]), model_path=None, seed=0,
                        mesh=mesh)
    res = {"device": str(dev), "backend": mesh.backend}
    for mode in ("run", "streaming"):
        fn = pipe.run if mode == "run" else pipe.run_streaming
        _dp_sync(torch, dev)
        ops.reset_launches()
        r = fn(input_video_path=clip, out_folder=os.path.join(out, mode))
        _dp_sync(torch, dev)
        res[mode] = dict(r, launches=ops.launch_counts())
    if ref_path is not None:
        del pipe
        ref = torch.load(ref_path, weights_only=True)
        for key, remat in DP_STEPS.items():
            snap, ms = _dp_train_step(torch, np, dev, mesh, shape, remat)
            res[key] = {"ms": ms, "digest": _dp_digest(snap), "loss": snap["logs"]["loss"],
                        "errs": _dp_step_errors(snap, ref, ref["lr"], ref["disc_reach"])}
            del snap
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return res


def _dp_world(torch, np, label, devices, clip, out, want, counted, smi, ref_path=None):
    """Phase 16's world on `devices`: each rank's npz stream and preview
    against one rank's (`want`), its own K1/K2/K3 launches (joined to the
    counted paths), frames/s; returns each rank's result."""
    from v2ce_toolbox_tpu_torch.parallel import mesh as pmesh

    t0 = time.time()
    ranks = pmesh.launch(dp_rank, len(devices), args=(clip, (H, W), out, ref_path,
                                                      DP_TRAIN_SHAPE),
                         devices=devices, timeout_s=DP_WALL_S,
                         collective_timeout_s=DP_COLLECTIVE_S)
    lead = ranks[0]
    log(f"[dp] {label}: {len(devices)} rank(s) on {', '.join(map(str, devices))}, backend "
        f"{lead['backend']}, world {time.time() - t0:.1f} s [{smi}]")
    for mode in ("run", "streaming"):
        ev = np.load(lead[mode]["event_stream_path"])["event_stream"]
        with open(lead[mode]["event_frame_video"], "rb") as f:
            preview = f.read()
        if ev.tobytes() != want[mode][0] or preview != want[mode][1]:
            raise AssertionError(f"{label} {mode}: the stream or the preview differs from "
                                 "one rank's")
        for r, res in enumerate(ranks):
            path = f"phase 16 {label} rank {r} {mode}"
            counted.by_path[path] = res[mode]["launches"]
            missing = [k for k in CENTER_PATH if res[mode]["launches"][k] <= 0]
            if missing or (r and "event_stream_path" in res[mode]):
                raise AssertionError(f"{path}: never launched {missing}, or wrote files")
            t, wall = res[mode]["timings"], res[mode]["wall_time_s"]
            launched = ", ".join(f"{k} {res[mode]['launches'][k]}" for k in CENTER_PATH)
            log(f"[dp] {label} rank {r} {mode}: {t['windows']} stage-1 windows, "
                f"{t['chunks']} stage-2 chunks, {wall:.3f} s, the clip's "
                f"{lead[mode]['num_frames']} frames over it {lead[mode]['num_frames'] / wall:.2f} "
                f"frames/s (the first run of a fresh process), launches: {launched} [{smi}]")
        log(f"[dp] {label} {mode}: {len(ev)} events, byte-identical to one rank's, preview "
            f"identical ({len(preview)} bytes)")
    return ranks


def data_parallel_phase(torch, np, counted, smi):
    """Phase 16: data parallelism over ranks (`parallel/mesh.py`), each rank
    a spawned process on its card: (a) a world of every visible GPU (NCCL)
    runs `run` and `run_streaming` on the 260x346 clip; (b) two ranks
    (NCCL on two GPUs, gloo on one) do the same and one train step at
    train.main's defaults on a global batch of DP_TRAIN_SHAPE, without and
    with remat, each held against one rank's step without remat (phase
    14's tolerances) and across the ranks (one state, bit for bit); (c) train.main over every visible GPU for 2 steps
    and an eval on phase 14's packets."""
    import shutil

    from v2ce_toolbox_tpu_torch.config import PipelineConfig
    from v2ce_toolbox_tpu_torch.pipeline.driver import V2cePipeline
    from v2ce_toolbox_tpu_torch.train import main as train_main

    t_phase = time.time()
    gpus = torch.cuda.device_count()

    def cards(n):
        """n ranks' devices: the GPUs in turn (a CPU rehearsal: the CPU)."""
        return [torch.device(DEVICE, r % gpus) if DEVICE == "cuda" else torch.device(DEVICE)
                for r in range(n)]

    dev = cards(1)[0]
    out = os.path.join(OUT, "dp")
    shutil.rmtree(out, ignore_errors=True)
    # every rank of (a) needs a 16-frame stage-1 window and a stage-2 chunk of F
    frames = max(33, F * (gpus - 1) + 2)
    clip = os.path.join(OUT, "clip.mp4")
    if frames > 33:
        clip = os.path.join(out, "clip.mp4")
        os.makedirs(out, exist_ok=True)
        make_clip(clip, frames, H, W)
    pipe = V2cePipeline(PipelineConfig(height=H, width=W), model_path=None, seed=0, device=dev)
    want = {}
    for mode in ("run", "streaming"):
        fn = pipe.run if mode == "run" else pipe.run_streaming
        r = fn(input_video_path=clip, out_folder=os.path.join(out, "one", mode))
        with open(r["event_frame_video"], "rb") as f:
            want[mode] = (np.load(r["event_stream_path"])["event_stream"].tobytes(), f.read())
        log(f"[dp] one rank, no mesh, {mode}: {r['num_events']} events, "
            f"{r['num_frames'] / r['wall_time_s']:.2f} frames/s [{smi}]")
    del pipe
    torch.cuda.empty_cache()

    # (a) every visible GPU
    _dp_world(torch, np, "(a) every GPU", cards(gpus), clip, os.path.join(out, "a"), want, counted,
              smi)

    # (b) two ranks, with the train step against one rank's
    from v2ce_toolbox_tpu_torch.train.gan import make_disc_optimizer
    from v2ce_toolbox_tpu_torch.train.main import build_parser

    snap, ms = _dp_train_step(torch, np, dev, None, DP_TRAIN_SHAPE)
    args = build_parser().parse_args([])
    disc_lr = make_disc_optimizer([torch.zeros(1, requires_grad=True)]).defaults["lr"]
    ref_path = os.path.join(out, "one_rank_step.pt")
    torch.save(dict(snap, lr=float(args.lr), disc_reach=args.gan_k * disc_lr), ref_path)
    del snap
    torch.cuda.empty_cache()
    log(f"[dp] one rank, no mesh: one train step, batch {DP_TRAIN_SHAPE}, {ms:.1f} ms "
        f"(first step of the model in this process) [{smi}]")
    two = cards(2)
    if gpus < 2:
        log("[dp] (b) one GPU: NCCL refuses two ranks on one device, so gloo; two ranks on "
            "one card share it, and their times measure no scaling")
    ranks = _dp_world(torch, np, "(b) two ranks", two, clip, os.path.join(out, "b"), want,
                      counted, smi, ref_path)
    for key, remat in DP_STEPS.items():
        what = "with remat" if remat else "without remat (the first in the process)"
        for r, res in enumerate(ranks):
            errs = res[key]["errs"]
            log(f"[dp] (b) rank {r}: one train step {what}, {DP_TRAIN_SHAPE[0] // 2} items, "
                f"{res[key]['ms']:.1f} ms, loss {res[key]['loss']:.6f}; against one rank "
                "without remat: "
                + ", ".join(f"{k} {v:.3e} (limit {DP_LIMITS[k]:g})" for k, v in errs.items())
                + f" [{smi}]")
            bad = [k for k, v in errs.items() if not v <= DP_LIMITS[k]]
            if bad:
                raise AssertionError(f"(b) rank {r}'s train step {what} disagrees with one "
                                     f"rank's: {bad}")
        if len({res[key]["digest"] for res in ranks}) != 1:
            raise AssertionError(f"(b) {what}: the ranks' parameters, moments or statistics "
                                 "differ")
        log(f"[dp] (b) {what}: both ranks hold one state (parameters, BN statistics, SN "
            "vectors, Adam moments, discriminator), bit for bit")

    # (c) train.main over every visible GPU
    if gpus < 2:
        log("[dp] (c) one GPU: train.main --devices 1 takes no mesh and runs as in phase 14; "
            "its spawned world over cards (launch over NCCL, the loader's rank blocks, the "
            "recorder's gather, the checkpoint barrier) is not run on this host")
    data = os.path.join(OUT, "train_packets")
    logs = os.path.join(out, "train_logs")
    res = train_main.main(["--data_dir", data, "--log_dir", logs, "--batch_size",
                           str(TRAIN_BATCH), "--seq_len", str(TRAIN_SEQ), "--max_epochs", "1",
                           "--log_frequency", "1", "--device", DEVICE, "--devices", str(gpus),
                           "--max_steps_per_epoch", "2", "--exp_name", "dp",
                           "--dump_previews", "false"])
    with open(os.path.join(res["work_dir"], "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    train = [x["train"] for x in lines if "train" in x]
    vals = [v for x in lines for part in x.values() for v in part.values()]
    per_rank = [r["step_s"] for r in res.get("ranks", [res])]
    log(f"[dp] (c) train.main over {gpus} GPU(s), batch {TRAIN_BATCH}: "
        + "; ".join(f"rank {r} steps {', '.join(f'{t * 1e3:.1f}' for t in s)} ms"
                    for r, s in enumerate(per_rank))
        + f"; losses {', '.join(f'{x['loss']:.4f}' for x in train)} [{smi}]")
    if len(train) != 2 or not all(np.isfinite(vals)):
        raise AssertionError(f"(c) train.main over {gpus} GPU(s): {lines}")
    shutil.rmtree(data, ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)
    log(f"[dp] phase 16 in {time.time() - t_phase:.1f} s")


def stage_tools_phase(torch, np, counted, smi):
    """Phase 18: the stage tools and the v2 core's binned route. (a)
    `tools.perf_test_stage2` at its defaults per strategy, counted
    (PT18_KERNELS), and one of its calls ('slope', 10
    frames) card against CPU with the same draws; (b) `tools.speed_test` at
    its defaults in f32 and bf16, counted, its parameter and FLOP counts
    against the host's count from shapes; (c) `sample_events(use_v3=False)`
    on PT18_FRAMES frames of the tool's voxels at 260x346, 30 fps, 'slope',
    its `compact_dispatch` call recorded on the card and the CPU and
    replayed with the binned route: binned identical card against CPU,
    binned and flat timed in turns and each profiled (a finding, not a
    gate); (d) that
    `sample_events(use_v3=False)` stream card against CPU, byte for byte,
    and its ms; (e) `tools.vis_stage2`'s streams on the card against the
    CPU's counts, counted, then its `main`: PNGs where matplotlib is
    installed, else exactly a SystemExit naming matplotlib. Returns the
    phase's numbers for the kernels line."""
    from v2ce_toolbox_tpu_torch.config import ModelConfig, SamplerConfig
    from v2ce_toolbox_tpu_torch.events import to_recarrays
    from v2ce_toolbox_tpu_torch.ops import ldati
    from v2ce_toolbox_tpu_torch.tools import perf_test_stage2, speed_test, vis_stage2

    t_phase = time.time()
    dev = torch.device(DEVICE)
    out, marks = {}, [("start", t_phase)]

    def mark(part):
        marks.append((part, time.time()))

    def cpu_of(draw):
        return lambda j, shape: draw(j, shape).cpu()

    # (a) the stage-2 tool per strategy, then one call card against CPU
    for strategy, kernels in PT18_KERNELS.items():
        res = counted(f"perf_test_stage2 {strategy}", kernels,
                      lambda: perf_test_stage2.main(["--strategy", strategy,
                                                     "--device", DEVICE]),
                      f"python -m v2ce_toolbox_tpu_torch.tools.perf_test_stage2 "
                      f"--strategy {strategy}")
        if not (res["events_per_call"] > 0 and np.isfinite(res["ms_per_frame"])):
            raise AssertionError(f"perf_test_stage2 {strategy}: {res}")
        out[f"perf_test_stage2 {strategy}"] = res
        log(f"[tools] perf_test_stage2 {strategy}: {res['ms_per_frame']:.4f} ms/frame, "
            f"{res['events_per_s'] / 1e6:.2f} M events/s, {res['events_per_frame']:.0f} "
            f"events/frame [{smi}]")
    y = torch.from_numpy(perf_test_stage2.voxels(10, H, W, 0.1))
    draw = ldati.make_draw(0, 0, dev)
    t0 = time.time()
    card = to_recarrays(ldati.sample_events(y.to(dev), draw, SamplerConfig()))
    plain = to_recarrays(ldati.sample_events(y, cpu_of(draw), SamplerConfig()))
    if (sum(len(r) for r in card) == 0
            or [r.tobytes() for r in card] != [r.tobytes() for r in plain]):
        raise AssertionError("perf_test_stage2's call: the card differs from the CPU")
    log(f"[tools] perf_test_stage2's 'slope' call, 10 frames: card == CPU "
        f"({sum(len(r) for r in card)} events, {time.time() - t0:.1f} s)")
    mark("a")

    # (b) the stage-1 tool in f32 and bf16, its counts against the host's
    for label, flags, dtype in [("f32", [], torch.float32),
                                ("bf16", ["--bf16"], torch.bfloat16)]:
        res = counted(f"speed_test {label}", (),
                      lambda: speed_test.main(["--device", DEVICE, *flags]),
                      f"python -m v2ce_toolbox_tpu_torch.tools.speed_test {' '.join(flags)}")
        shape = res["shape"]
        want = speed_test.counts(ModelConfig(compute_dtype=dtype), shape)
        if (res["params"], res["flops"]) != want or not np.isfinite(res["ms"]):
            raise AssertionError(f"speed_test {label}: {res} against the host's {want}")
        out[f"speed_test {label}"] = res
        log(f"[tools] speed_test {label} {shape}: {res['params']} params, {res['flops']} "
            f"FLOPs (the host's count), {res['ms']:.2f} ms a forward, "
            f"{res['tflops_per_s']:.2f} TFLOP/s [{smi}]")
        torch.cuda.empty_cache()
    mark("b")

    # (c) the binned route against the flat one, on the v2 core's call
    cfg = SamplerConfig()
    v = torch.from_numpy(perf_test_stage2.voxels(PT18_FRAMES, H, W, 0.1))
    draw = ldati.make_draw(18, 0, dev)
    streams, calls = {}, {}
    for where, vv, dd in [("card", v.to(dev), draw), ("cpu", v, cpu_of(draw))]:
        cl = []
        with record_calls([ldati], "compact_dispatch", cl):
            streams[where] = ldati.sample_events(vv, dd, cfg, use_v3=False)
        if len(cl) != 1:
            raise AssertionError(f"sample_events(use_v3=False) made {len(cl)} "
                                 "compact_dispatch calls")
        calls[where] = cl[0]

    def route(where, binned):
        a, k = calls[where]
        return ldati.compact_dispatch(*a, **dict(k, use_binned_compaction=binned))

    binned = {where: route(where, True) for where in calls}
    flat = route("card", False)
    if any(not torch.equal(x.cpu(), z) for x, z in zip(binned["card"], binned["cpu"])):
        raise AssertionError("the binned compaction on the card differs from the CPU")
    tb, tf = time_pair(lambda: route("card", True), lambda: route("card", False), torch,
                       n=N_PT18_TIMED)
    nb, nf = int(binned["card"][2].sum()), int(flat[2].sum())
    out["compact_dispatch"] = dict(binned_ms=tb, flat_ms=tf, binned_events=nb,
                                   flat_events=nf, frames=PT18_FRAMES)
    for label, binned_route in [("binned", True), ("flat", False)]:
        out["compact_dispatch"][f"{label}_profile"] = profile_call(
            torch, lambda: route("card", binned_route), smi,
            f"compact_dispatch {label}, {PT18_FRAMES} frames")
    log(f"[tools] compact_dispatch, {PT18_FRAMES} frames {H}x{W} at {FPS} fps 'slope': binned "
        f"card == CPU ({nb} events, dropped {int(binned['card'][3].sum())}); binned "
        f"{tb:.4f} ms, flat {tf:.4f} ms ({nf} events, dropped {int(flat[3].sum())}), "
        f"binned/flat {tb / tf:.3f} [{smi}]")
    del binned, flat, calls
    mark("c")

    # (d) the use_v3=False stream, card against CPU, and its time
    card, plain = to_recarrays(streams["card"]), to_recarrays(streams["cpu"])
    if (sum(len(r) for r in card) == 0
            or [r.tobytes() for r in card] != [r.tobytes() for r in plain]):
        raise AssertionError("sample_events(use_v3=False): the card differs from the CPU")
    vd = v.to(dev)
    ms = statistics.median(cuda_ms(lambda: ldati.sample_events(vd, draw, cfg, use_v3=False),
                                   torch) for _ in range(N_PT18_TIMED))
    out["sample_events use_v3=False"] = dict(ms=ms, events=sum(len(r) for r in card),
                                             frames=PT18_FRAMES)
    log(f"[tools] sample_events(use_v3=False), {PT18_FRAMES} frames: card == CPU "
        f"({sum(len(r) for r in card)} events), {ms:.2f} ms [{smi}]")
    del streams, vd
    torch.cuda.empty_cache()
    mark("d")

    # (e) the samplers side by side, then the plots or the named exit
    draw = ldati.make_draw(0, 0, dev)
    got = counted("vis_stage2", (), lambda: vis_stage2.sampler_streams(DEVICE, draw=draw),
                  "tools.vis_stage2.sampler_streams")
    want = vis_stage2.sampler_streams("cpu", draw=cpu_of(draw))
    counts = {name: len(s) for name, s in got.items()}
    if counts != {name: len(s) for name, s in want.items()} or min(counts.values()) == 0:
        raise AssertionError(f"vis_stage2: card {counts}, CPU "
                             f"{ {name: len(s) for name, s in want.items()} }")
    same = [name for name in got if got[name].tobytes() == want[name].tobytes()]
    log(f"[tools] vis_stage2 streams, the card's draws: card == CPU counts {counts}; "
        f"byte-identical: {same}")
    plots = os.path.join(OUT, "vis_stage2")
    try:
        vis_stage2.main(["-o", plots, "--device", DEVICE])
        pngs = sorted(os.listdir(plots))
        if len(pngs) != len(counts) + 1:
            raise AssertionError(f"vis_stage2 wrote {pngs}")
        log(f"[tools] vis_stage2 main wrote {pngs}")
    except SystemExit as e:
        if "matplotlib" not in str(e.code) or e.code in (0, None):
            raise AssertionError(f"vis_stage2 main exited with {e.code!r}") from e
        log(f"[tools] vis_stage2 main without matplotlib: SystemExit({e.code!r})")
    mark("e")
    out["seconds"] = time.time() - t_phase
    out["part_seconds"] = {p: t - marks[i][1] for i, (p, t) in enumerate(marks[1:])}
    log(f"[tools] phase 18 in {out['seconds']:.1f} s, by part {out['part_seconds']} [{smi}]")
    return out


def rewrites_phase(torch, np, counted, smi):
    """Phase 19: the stage-1 rewrites (TF32 off, seeded `init_weights(0)`).
    (a) Each variant of REWRITE_VARIANTS of the full-width V2ce3d on one
    16-frame 260x346 window, counted, within STAGE1_REL_TOL of the base
    model with the same weights ('cm' transposed back), ms a window
    (median of 3); the K10 variant must launch K10. In bf16, REWRITE_BF16
    within phase 10's max-error gate of the f32 base; K9 must launch in the
    'pallas' one. (b) One train step at phase 14's TRAIN_CMP_SHAPE with
    remat and without, within phase 14's limits of each other (logs, BN
    statistics, SN vectors, Adam first moments, parameters); the
    REWRITE_TRAIN step's first moments finite and within
    TRAIN_GRAD_REL_TOL of the base step's; then each remat setting's peak
    GiB and ms of a warm step at train.main's shape. (c) V2cePipeline
    center on phase 4's clip with the pfold sub-pixel decoder and with the
    base model, counted: sorted EVENT_DTYPE records, the event counts
    within 0.5% of each other. (d) The nine probes of PROBES19 as phase 17
    runs its own. Returns the phase's numbers."""
    import copy

    from v2ce_toolbox_tpu_torch.config import ModelConfig, PipelineConfig, TrainConfig
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.pipeline import driver
    from v2ce_toolbox_tpu_torch.train import gan, state as tstate, step as tstep
    from v2ce_toolbox_tpu_torch.train.main import build_parser
    from v2ce_toolbox_tpu_torch.utils.weights import init_weights

    dev = torch.device(DEVICE)
    t_phase = time.time()
    marks = [("start", t_phase)]
    out = {}

    # (a) the variants at full width
    base = V2ce3d(ModelConfig())
    init_weights(base, 0)
    weights = base.state_dict()
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 16, H, W, 2)
                         .astype(np.float32)).to(dev)

    def forward(kw, dtype=torch.float32):
        m = V2ce3d(ModelConfig(compute_dtype=dtype, **kw))
        m.load_state_dict(weights)
        y, ms, _ = _timed_forward(torch, m.to(dev).eval(), x)
        return (y.permute(0, 1, 3, 4, 2) if kw.get("out_layout") == "cm" else y), ms

    y0, ms0 = forward({})
    scale = float(y0.abs().max())
    ms_window, rel = {"base": ms0}, {}
    for name, kw in REWRITE_VARIANTS.items():
        kern = ("fused_up_concat_conv",) if kw.get("subpixel_impl") == "pallas" else ()
        y, ms_window[name] = counted(f"phase 19 {name}", kern, lambda kw=kw: forward(kw),
                                     f"f32, {kw}")
        rel[name] = float((y - y0).abs().max()) / scale
        if y.shape != y0.shape or not torch.isfinite(y).all() or rel[name] > STAGE1_REL_TOL:
            raise AssertionError(f"rewrite {name}: {rel[name]:.3e} from the base model "
                                 f"(limit {STAGE1_REL_TOL:g}), shape {tuple(y.shape)}")
    limit = 0.05 * scale + 1e-3
    for name, (kw, kern) in REWRITE_BF16.items():
        y, ms_window[f"bf16 {name}"] = counted(f"phase 19 bf16 {name}", kern,
                                               lambda kw=kw: forward(kw, torch.bfloat16),
                                               f"bf16, {kw}")
        err = rel[f"bf16 {name}"] = float((y.float() - y0).abs().max())
        if not (torch.isfinite(y).all() and err <= limit):
            raise AssertionError(f"bf16 {name}: max error {err:.4e} against the f32 base "
                                 f"(limit {limit:.4e})")
    log(f"[rewrites] (a) full-width V2ce3d, (1, 16, {H}, {W}, 2), f32 base "
        f"{ms0:.2f} ms/window; each f32 variant's ms/window and max error over the base's "
        f"largest output (limit {STAGE1_REL_TOL:g}): "
        + ", ".join(f"{k} {ms_window[k]:.2f} ms {rel[k]:.3e}" for k in REWRITE_VARIANTS)
        + f"; bf16 ms/window and max error (limit 0.05 scale + 1e-3 = {limit:.4e}): "
        + ", ".join(f"{k} {ms_window[k]:.2f} ms {rel[k]:.3e}" for k in rel
                    if k.startswith("bf16")) + f" [{smi}]")
    out.update(ms_window=ms_window, error=rel)
    del base, x, y0, y
    torch.cuda.empty_cache()
    marks.append(("variants", time.time()))

    # (b) remat, and the mixed variant's step
    args = build_parser().parse_args([])
    cfg = TrainConfig(loss="+".join(args.loss), lr=args.lr, weight_decay=args.weight_decay,
                      lr_scheduler=args.lr_scheduler)
    model0, disc0 = V2ce3d(ModelConfig()), gan.make_discriminator(args.gan_3d_conv)
    tstate.create_train_state(model0, cfg, disc=disc0, seed=0)        # seeded weights
    weights = model0.state_dict()

    def one_step(kw, batch, steps=1):
        m = V2ce3d(ModelConfig(**kw))
        m.load_state_dict(weights)
        m, d = m.to(dev), copy.deepcopy(disc0).to(dev)
        st = tstate.create_train_state(m, cfg, disc=d, init=False)
        step = tstep.make_train_step(m, cfg, disc=d, gan_k=args.gan_k)
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (st, logs), peak = peak_gib(torch, lambda: step(st, batch))
            ms = (time.perf_counter() - t0) * 1e3
        return st, {k: float(v) for k, v in logs.items()}, ms, peak

    b, l, h, w = TRAIN_CMP_SHAPE
    rng = np.random.RandomState(0)
    batch = {"image_units": rng.randn(b, l, h, w, 2).astype(np.float32),
             "voxels": (rng.rand(b, l, h, w, 20) * 3
                        * (rng.rand(b, l, h, w, 20) < 0.2)).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    ref = one_step({}, batch)
    got = one_step(dict(remat=True), batch)
    errs, apart, moved = _step_errors(ref[0], ref[1], got[0], got[1], cfg, args.gan_k)
    bad = [k for k, v in errs.items() if not v <= TRAIN_LIMITS[k]]
    log(f"[rewrites] (b) one train step, remat against no remat, batch {TRAIN_CMP_SHAPE}: "
        + ", ".join(f"{k} {v:.3e} (limit {TRAIN_LIMITS[k]:g})" for k, v in errs.items())
        + f"; generator elements moved apart by > 1e-3 lr: {apart} of {moved}; loss "
        f"{got[1]['loss']:.6f} / {ref[1]['loss']:.6f}")
    if bad or apart / moved > TRAIN_PARAM_SHARE:
        raise AssertionError(f"remat's train step disagrees with the plain step: {bad}")
    mixed = one_step(REWRITE_TRAIN, batch)
    m1 = 0.0
    for (name, p), q in zip(ref[0].model.named_parameters(), mixed[0].model.parameters()):
        if p.requires_grad and TRAIN_DEAD_BIAS not in name:
            g_ref, g_mix = ref[0].opt.state[p]["exp_avg"], mixed[0].opt.state[q]["exp_avg"]
            if not torch.isfinite(g_mix).all():
                raise AssertionError(f"{REWRITE_TRAIN}: non-finite gradient of {name}")
            m1 = max(m1, _train_rel(g_mix, g_ref))
    log(f"[rewrites] (b) one train step of {REWRITE_TRAIN} against the base step: generator "
        f"Adam m1 {m1:.3e} (limit {TRAIN_GRAD_REL_TOL:g}), loss {mixed[1]['loss']:.6f} / "
        f"{ref[1]['loss']:.6f}")
    if not m1 <= TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"{REWRITE_TRAIN}: gradients {m1:.3e} from the base step's")
    del ref, got, mixed, batch
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(0)
    full = (TRAIN_BATCH, TRAIN_SEQ, H, W)
    batch = {"image_units": torch.randn(*full, 2, generator=g, device=dev),
             "voxels": torch.rand(*full, 20, generator=g, device=dev) * 3
             * (torch.rand(*full, 20, generator=g, device=dev) < 0.2)}
    step_ms, step_gib = {}, {}
    for remat in (False, True):
        _, logs, step_ms[remat], step_gib[remat] = one_step(dict(remat=remat), batch, steps=2)
        torch.cuda.empty_cache()
        if not all(np.isfinite(v) for v in logs.values()):
            raise AssertionError(f"remat={remat}: non-finite logs at {full}")
    log(f"[rewrites] (b) a warm train step at train.main's {full}: remat off "
        f"{step_ms[False]:.1f} ms, peak {step_gib[False]:.2f} GiB; remat on "
        f"{step_ms[True]:.1f} ms, peak {step_gib[True]:.2f} GiB [{smi}]")
    out.update(step_ms={str(k): v for k, v in step_ms.items()},
               step_peak_gib={str(k): v for k, v in step_gib.items()}, remat_errors=errs,
               mixed_step_m1=m1)
    del batch, model0, disc0
    torch.cuda.empty_cache()
    marks.append(("train steps", time.time()))

    # (c) the pipeline with the sub-pixel decoder
    clip, absent = os.path.join(OUT, "clip.mp4"), os.path.join(OUT, "absent.pt")
    runs = {}
    for label, mcfg in (("base", ModelConfig()), ("sp-pfold", ModelConfig(subpixel_decoder=True))):
        pipe = driver.V2cePipeline(PipelineConfig(height=H, width=W, model=mcfg),
                                   model_path=absent, device=DEVICE, seed=0)
        run = lambda: pipe.run(input_video_path=clip, out_folder=OUT)  # noqa: E731
        run()                                        # warm-up
        runs[label] = counted(f"phase 19 V2cePipeline {label}", CENTER_PATH, run)
        check_npz(runs[label], np, W, f"V2cePipeline {label}")
    ratio = runs["sp-pfold"]["num_events"] / runs["base"]["num_events"]
    log(f"[rewrites] (c) V2cePipeline center, ModelConfig(subpixel_decoder=True): "
        f"{cli_line(runs['sp-pfold'])}; base: {cli_line(runs['base'])}; event count ratio "
        f"{ratio:.6f} (within 0.005 of 1) [{smi}]")
    if abs(ratio - 1) > 0.005:
        raise AssertionError(f"the sub-pixel pipeline's event count is {ratio:.6f} of the base's")
    out["pipeline"] = {k: {"frames_per_s": r["num_frames"] / r["wall_time_s"],
                           "events": r["num_events"]} for k, r in runs.items()}
    marks.append(("pipeline", time.time()))

    # (d) the nine probes
    _, out["probe_seconds"] = _run_probes(torch, np, counted, PROBES19)
    marks.append(("probes", time.time()))
    out["part_seconds"] = {k: marks[i + 1][1] - marks[i][1] for i, (k, _) in
                           enumerate(marks[1:])}
    out["seconds"] = time.time() - t_phase
    log(f"[rewrites] phase 19 in {out['seconds']:.1f} s, by part {out['part_seconds']}; "
        f"probes (s): {out['probe_seconds']} [{smi}]")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    t_start = time.time()
    sys.path.insert(0, ROOT)
    import numpy as np

    from v2ce_toolbox_tpu_torch import ops
    from v2ce_toolbox_tpu_torch.config import ModelConfig, SamplerConfig
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.ops import _cuda
    from v2ce_toolbox_tpu_torch.pipeline import driver
    from v2ce_toolbox_tpu_torch.utils.weights import init_weights

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build
    t0 = time.time()
    lib_path = _cuda.build(verbose=True)
    _cuda.lib()
    log(f"[build] {os.path.relpath(lib_path, ROOT)} in {time.time() - t0:.1f} s "
        f"(nvcc {_cuda.build_seconds if _cuda.build_seconds is not None else 'cached'})")

    # 3. kernels against their plain twins at the main-path shapes
    results, errs, dense = kernels_phase(torch, np, dev)
    dense_v, dense_events, dense_draw, offsets = dense

    # 8. (first, while the card holds nothing else) K9 and K10 against their
    # twins at the research model's calls
    conv_results, conv_errs = conv_kernels_phase(torch, np, dev)
    results.update(conv_results)
    errs.update(conv_errs)

    # 4. the CLI paths, counted
    counted = Counted(torch, ops)
    cli_phase(torch, np, counted, smi)

    # 5. the other stage-2 modes, counted
    modes_phase(torch, np, counted, dense, smi)

    # 9. the research configuration and --bf16, counted
    research_phase(torch, np, counted, smi)

    # 11. the training-data path, counted
    data_results, errs["correlation"] = data_phase(torch, np, dev, counted, smi)
    results.update(data_results)

    # 13. the v2 sampler core, the ablation samplers and stage2_eval, counted
    for name, e in v2_phase(torch, np, counted, dense, smi).items():
        errs[name] = max(errs[name], e)

    # 12. the probe harness and its kernels, counted
    probe_results, probe_errs, roofline_rates = probe_phase(torch, np, dev, counted, smi)
    results.update(probe_results)
    errs.update(probe_errs)
    for name in KERNELS:
        if counted.by_path[KERNEL_PATH[name]][name] <= 0:
            raise AssertionError(f"{KERNEL_PATH[name]} never launched {name}")

    # 14. training: one step card vs CPU, then train.main at 260x346, counted
    train_step_phase(torch, np, dev, smi)
    train_run_phase(torch, np, counted, smi)

    # 15. the remaining models and utilities at full width, counted
    models_phase(torch, np, dev, counted, smi)

    # 16. data parallelism over ranks, each rank counted
    data_parallel_phase(torch, np, counted, smi)

    # 17. the stage-1 and stage-2 probes, each counted
    probe17, probe17_seconds = probes_phase(torch, np, counted, smi)

    # 18. the stage tools and the binned v2 compaction, counted
    stage_tools = stage_tools_phase(torch, np, counted, smi)

    # 19. the stage-1 rewrites, counted
    rewrites = rewrites_phase(torch, np, counted, smi)

    # 6. stage 1 on the card against the CPU: the full-width model, seeded
    # weights, one 16-frame window of 64x96 (TF32 off; cuDNN and the CPU
    # sum the conv products in other orders)
    model = V2ce3d(ModelConfig())
    init_weights(model, 0)
    model.eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 16, 64, 96, 2)
                         .astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        got = model.to(dev)(x.to(dev)).cpu()
    rel = float((got - ref).abs().max() / ref.abs().max())
    log(f"[stage1] card vs CPU, (1, 16, 64, 96, 2) -> {tuple(got.shape)}: max abs err "
        f"{float((got - ref).abs().max()):.3e}, relative to max |out| {rel:.3e} "
        f"(limit {STAGE1_REL_TOL:g})")
    if (got.shape != (1, 16, 64, 96, 20) or not torch.isfinite(got).all()
            or float(ref.abs().max()) == 0 or rel > STAGE1_REL_TOL):
        raise AssertionError("stage 1 on the card disagrees with the CPU")

    # 10. the research model against the product model on the card
    research_stage1_phase(torch, np, dev, model, x.to(dev))

    # 7. stage 2 alone: kernel path (card) against the plain path (CPU)
    t0 = time.time()
    plain = driver._fetch_chunk_events_fused(
        dense_v.cpu(), lambda j, shape: dense_draw(j, shape).cpu(), offsets.cpu(), F,
        SamplerConfig(), FPS, width=W)
    log(f"[stage2] card {len(dense_events)} events, CPU plain {len(plain)} events "
        f"({time.time() - t0:.1f} s)")
    if len(dense_events) == 0 or dense_events.tobytes() != plain.tobytes():
        raise AssertionError("stage 2 on the card differs from the plain path")

    kernels = []
    for name, (src, rep) in KERNELS.items():
        r = results[TIMED_CASE[name]]
        path = KERNEL_PATH[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": counted.by_path[path][name], "launches_path": path,
                        "launches_by_path": {p: c[name] for p, c in counted.by_path.items()
                                             if c[name]},
                        "training_launches": counted.by_path["training"][name],
                        "phase15_launches": counted.by_path["phase 15"][name],
                        "max_abs_err": errs[name],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r.get("bound_by", "bytes"),
                        "library_ms": r.get("library_ms"),
                        **{k: r[k] for k in ("device_ms", "plain_device_ms", "k",
                                             "k_lo_device_ms", "el_ops_per_s",
                                             "data_ops_per_s", "data_ops_per_s_k_lo",
                                             "data_ops_slope_per_s", "issue_ops_per_s",
                                             "registers", "sass_loop_rounds",
                                             "sass_per_round", "bytes_per_s",
                                             "live_steps", "live_steps_s122",
                                             "f32_rel_err_vs_f64", "calls",
                                             "library_device_ms", "library_bytes_per_s",
                                             "taps_device_ms", "levels",
                                             "kernel_launches_per_call",
                                             "sector_floor_ms") if k in r}})
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "stage2_roofline": roofline_rates,
                      "probe_seconds": probe17_seconds,
                      "fused_window_profile": probe17["fused window profile"],
                      "stage_tools": stage_tools, "rewrites": rewrites, "card": smi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


COMPARE_SETS = ("conv", "flow", "stage2", "roofline")


def conv_times(torch, np, dev, n=N_TIMED, sets=COMPARE_SETS):
    """CUDA-event ms (median of n) of the four conv kernels' wrappers of
    whichever `v2ce_toolbox_tpu_torch` is imported, in bf16 and f32 (f32
    output for K9, K11 and K12, the compute dtype for K10, as the model and
    the probes call them): K9 and K10 summed over the calls of one 16-frame
    260x346 window of the full-width research model, K11 over the probe's
    13 `quad` and 4 `quad_s2` layers (and `fold_s122[<dtype>]`, the
    strided wrapper's fold alone over those 4), K12 over the 3
    `wino_pallas` shapes, and those K12 calls on the device alone
    (`conv3d_wino4[<dtype>] device`: the kernels of a call by
    torch.profiler, median of N_DEVICE); before them `stage2_times` and
    `flow_times` and `roofline_times`. `sets` picks among the stage-2
    ("stage2"), flow ("flow"), roofline ("roofline") and conv ("conv")
    timings. Only the wrappers' public signatures are
    used, so any version of the package can be timed. Returns {label:
    ms}."""
    from v2ce_toolbox_tpu_torch.config import ModelConfig
    from v2ce_toolbox_tpu_torch.models import V2ce3d, layers
    from v2ce_toolbox_tpu_torch.ops import conv3d, conv3d_quad, conv3d_wino4, decoder
    from v2ce_toolbox_tpu_torch.tools import perf_probe
    from v2ce_toolbox_tpu_torch.utils.weights import init_weights

    times = {}
    if "stage2" in sets:
        times.update(stage2_times(torch, np, dev, n))
    if "flow" in sets:
        times.update(flow_times(torch, np, dev, n))
    if "roofline" in sets:
        times.update(roofline_times(torch, np, dev))
    if "conv" not in sets:
        return times

    def add(label, fn):
        with torch.no_grad():
            times[label] = times.get(label, 0.0) + time_one(fn, torch, n)

    x = torch.from_numpy(np.random.RandomState(0).randn(1, 16, H, W, 2)
                         .astype(np.float32)).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        model = V2ce3d(ModelConfig(compute_dtype=dtype, **RESEARCH))
        init_weights(model, 0)
        model.to(dev).eval()
        k9, k10 = [], []
        with record_calls([layers], "conv3d_3x3x3", k9), \
                record_calls([decoder], "fused_conv_even", k10), torch.no_grad():
            model(x)
        del model
        for a, k in k9:
            add(f"conv3d_3x3x3[{dname}]", lambda: conv3d.conv3d_3x3x3(*a, **k))
        for a, k in k10:
            add(f"fused_up_concat_conv[{dname}]", lambda: decoder.fused_conv_even(*a, **k))
        del k9, k10
        for (name, h, w, cin, cout), strided in (
                [(lay, False) for lay in perf_probe.QUAD_LAYERS]
                + [(lay, True) for lay in perf_probe.QUAD_S2_LAYERS]):
            g = torch.Generator(device=dev).manual_seed(cin * cout)
            xq = torch.rand((1, 16, h, w, cin), generator=g, device=dev).to(dtype)
            kq = (torch.rand((3, 3, 3, cin, cout), generator=g, device=dev) * 0.01).to(dtype)
            fn = conv3d_quad.conv3d_quad_s122 if strided else conv3d_quad.conv3d_quad
            add(f"conv3d_quad{'_s122' if strided else ''}[{dname}]", lambda: fn(xq, kq))
            if strided:
                # the wrapper's phase fold alone, part of the time above
                add(f"fold_s122[{dname}]", lambda: conv3d_quad.fold_s122(xq, kq))
            del xq, kq
        for name, xshape, cout in perf_probe.WINO_SHAPES:
            g = torch.Generator(device=dev).manual_seed(xshape[-1] * cout)
            xw = (torch.rand(xshape, generator=g, device=dev) - 0.5).to(dtype)
            kw = (torch.rand((3, 3, 3, xshape[-1], cout), generator=g, device=dev)
                  * 0.05).to(dtype)
            add(f"conv3d_wino4[{dname}]", lambda: conv3d_wino4.conv3d_wino4(xw, kw))
            # the same calls on the device alone: every kernel a call
            # launches, by the profiler (the median of N_DEVICE calls)
            with torch.no_grad():
                dev_ms = [port_launches(lambda: conv3d_wino4.conv3d_wino4(xw, kw), torch)
                          for _ in range(N_DEVICE)]
            if None not in dev_ms:
                label = f"conv3d_wino4[{dname}] device"
                times[label] = times.get(label, 0.0) + statistics.median(d[2] for d in dev_ms)
            del xw, kw
        torch.cuda.empty_cache()
    return times


def stage2_times(torch, np, dev, n=N_TIMED):
    """For `--compare-conv`, through the wrappers and the stage-2 functions
    every version of the package has: on phase 3's dense (24, 2, 10, 260,
    346) voxels, K1 'slope' and 'none' (`gen_compact[<strategy>]`), K2's
    three main-path calls of the fused route (`compact_rows[main i:
    ...]`, summed in `compact_rows[main path]`) and its grid-width call,
    K3's two main-path calls of the fused route (`merge_sorted_rows[main i:
    ...]`, summed in `merge_sorted_rows[main path]`) and K5's flatten of the
    EventStream route (`append_rows[...]`), each by CUDA events (median of
    n) and on the device by graph replays (`... device`). Returns {label:
    ms}."""
    from v2ce_toolbox_tpu_torch.config import SamplerConfig
    from v2ce_toolbox_tpu_torch.ops import compact, gen, ldati
    from v2ce_toolbox_tpu_torch.pipeline import driver

    scfg = SamplerConfig()
    g = torch.Generator(device=dev).manual_seed(1234)
    v = ((torch.rand((F, 2, 10, H, W), generator=g, device=dev) < 0.3)
         * torch.rand((F, 2, 10, H, W), generator=g, device=dev) * 5.0).contiguous()
    offsets = torch.from_numpy((np.arange(F) / FPS * 1e6).astype(np.int32)).to(dev)
    draw = ldati.make_draw(0, 0, dev)
    main, grid, merges, appends = [], [], [], []
    with record_calls([ldati, driver], "compact_rows", main), \
            record_calls([driver], "merge_sorted_rows", merges):
        driver._fetch_chunk_events_fused(v, draw, offsets, F, scfg, FPS, width=W)
    with record_calls([ldati], "compact_rows", grid):
        ldati.sample_rows(v, draw, dataclasses.replace(scfg, use_gen_compact=False))
    grid = [c for c in grid if c[0][0].shape[1] == 2 * H * W]
    with record_calls([driver], "append_rows", appends):
        stream = ldati.sample_events(v, draw, dataclasses.replace(scfg, bidirectional=True))
        driver._fetch_chunk_events(stream, offsets, F, FPS, width=W)
    if len(main) != 3 or len(grid) != 1 or len(merges) != 2 or len(appends) != 1:
        raise AssertionError(f"expected 3 main-path and 1 grid K2 calls, 2 K3 and 1 K5 calls, "
                             f"got {len(main)}, {len(grid)}, {len(merges)}, {len(appends)}")
    kw1 = dict(fps=FPS, mepv=scfg.max_events_per_voxel, vox_bits=ldati.vox_bits_of(2, H, W),
               cap_bin=scfg.cap_bin)
    times = {}

    def add(label, fn):
        times[label] = time_one(fn, torch, n)
        times[f"{label} device"] = graph_ms(fn, torch)

    def shape(a, k, cap):
        r, width = a[0].shape
        return f"{r}x{width}->{cap}{'+pay' if len(a) > 1 and a[1] else ''}"

    for strategy in ("slope", "none"):
        add(f"gen_compact[{strategy}]", lambda: gen.gen_compact(v, strategy=strategy, **kw1))
    labels = []
    for i, (a, k) in enumerate(main + grid):
        label = (f"compact_rows[{'main ' + str(i) if i < 3 else 'grid'}: "
                 f"{shape(a, k, k['cap'])}]")
        add(label, lambda: compact.compact_rows(*a, **k))
        labels.append(label)
    merge_labels = []
    for i, (a, k) in enumerate(merges):
        label = f"merge_sorted_rows[main {i}: {shape(a, k, k['cap'])}]"
        add(label, lambda: compact.merge_sorted_rows(*a, **k))
        merge_labels.append(label)
    for a, k in appends:
        add(f"append_rows[stream: {shape(a, k, k['cap'])}]",
            lambda: compact.append_rows(*a, **k))
    for suffix in ("", " device"):
        times[f"compact_rows[main path]{suffix}"] = sum(times[x + suffix] for x in labels[:3])
        times[f"merge_sorted_rows[main path]{suffix}"] = sum(times[x + suffix]
                                                             for x in merge_labels)
    del v, main, grid, merges, appends, stream
    torch.cuda.empty_cache()
    times.update(window_times(torch, np, dev, n))
    return times


def probe_rows(np, density, payload, rng=None):
    """The probes' chain-compaction rows (`perf_probe.probe_compact_algo`):
    144 x 182,272 int32 keys, valid with probability `density`, and with
    `payload` the slope payload (non-zero where a key is valid), drawn from
    `rng` (a RandomState seeded 0 where it is None)."""
    from v2ce_toolbox_tpu_torch.ops import compact

    rng = np.random.RandomState(0) if rng is None else rng
    r, nn = PROBE_ROWS
    keys = np.where(rng.rand(r, nn) < density, rng.randint(0, 1 << 30, (r, nn)),
                    compact.INVALID).astype(np.int32)
    if not payload:
        return keys, None
    pays = np.where(keys != compact.INVALID, rng.randint(1, 1 << 20, (r, nn)), 0)
    return keys, pays.astype(np.int32)


def window_times(torch, np, dev, n=N_TIMED):
    """For `--compare-conv --sets stage2`: K2w, compact_rows(algo="window"),
    at the probes' shapes, by CUDA events (median of n) and on the device
    by graph replays (`... device`): with the payload at cap 16,384, chunk
    16,384 (`compact_rows_window[probe: ...]`), and without it at cap
    65,536, chunks 8,192 and 16,384, densities 0.1 and 0.3 (`probe_compact`'s
    calls). Then torch.profiler's split of the payload call's device time
    by activity (`compact_rows_window[split: <kernel or memset>]`, the
    median of N_DEVICE profiled calls), so that a pad or copy before the
    compaction shows apart. Returns {label: ms}."""
    from torch.profiler import ProfilerActivity, profile

    from v2ce_toolbox_tpu_torch.ops import compact

    times = {}
    keys, pays = probe_rows(np, 0.1, True)
    kk, pp = torch.from_numpy(keys).to(dev), torch.from_numpy(pays).to(dev)
    r, nn = keys.shape

    def call():
        return compact.compact_rows(kk, [pp], cap=1 << 14, chunk=16384, algo="window")

    label = f"compact_rows_window[probe: {r}x{nn}->16384+pay]"
    times[label] = time_one(call, torch, n)
    times[f"{label} device"] = graph_ms(call, torch)
    split = {}
    for _ in range(N_DEVICE):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        per = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                name = re.sub(r"\(anonymous namespace\)::|void |<.*|\(.*", "", ev.name)[:48]
                per[name] = per.get(name, 0.0) + ev.device_time_total / 1e3
        for name, ms in per.items():
            split.setdefault(name, []).append(ms)
    for name, ms in split.items():
        times[f"compact_rows_window[split: {name}]"] = statistics.median(ms)
    del kk, pp, keys, pays
    for density in (0.1, 0.3):
        keys, _ = probe_rows(np, density, False)
        kk = torch.from_numpy(keys).to(dev)
        for chunk in (8192, 16384):
            def call(chunk=chunk):
                return compact.compact_rows(kk, cap=1 << 16, chunk=chunk, algo="window")

            label = f"compact_rows_window[probe d={density} chunk {chunk}: ->65536]"
            times[label] = time_one(call, torch, n)
            times[f"{label} device"] = graph_ms(call, torch)
        del kk, keys
    torch.cuda.empty_cache()
    return times


# FastFlowNet's five cost-volume levels for 260x346 frames padded to
# 320x384, 16 pairs a call: (N, C, H, W)
FLOW_LEVELS = ((PAIRS, 32, 80, 96), (PAIRS, 64, 40, 48), (PAIRS, 64, 20, 24),
               (PAIRS, 64, 10, 12), (PAIRS, 64, 5, 6))


def flow_times(torch, np, dev, n=N_TIMED):
    """For `--compare-conv`, through public signatures only (so the parent's
    package runs them too): K8 on all 81 taps at each of FastFlowNet's five
    levels (`correlation[<H>x<W>]`, CUDA events, median of n; `... device`
    from CUDA-graph replays) and summed over them; `FastFlowNet.cost_volume`
    (the taps FastFlowNet keeps) the same way; one 16-pair
    `fastflownet_pair_flow` call on uint8 frames (its own clock: the call
    returns numpy), and its kernels' device time by torch.profiler; K7,
    K15 and K16 on the device by graph replays, each
    beside `clone()` of the same input. Returns {label: ms}."""
    from v2ce_toolbox_tpu_torch.data import mvsec
    from v2ce_toolbox_tpu_torch.models.fastflownet import FastFlowNet, init_fastflownet
    from v2ce_toolbox_tpu_torch.ops import barrier, correlation, roofline

    times = {}

    def add(label, ms):
        times[label] = times.get(label, 0.0) + ms

    net = FastFlowNet()
    init_fastflownet(net, 0)
    net.to(dev).eval()
    with torch.no_grad():
        for shape in FLOW_LEVELS:
            g = torch.Generator(device=dev).manual_seed(shape[1] * shape[2])
            f1 = torch.randn(shape, generator=g, device=dev)
            f2 = torch.randn(shape, generator=g, device=dev)
            lvl = f"{shape[2]}x{shape[3]}"
            for name, fn in (("correlation", lambda: correlation.correlation(f1, f2, 4)),
                             ("cost_volume", lambda: net.cost_volume(f1, f2))):
                t, d = time_one(fn, torch, n), graph_ms(fn, torch)
                add(f"{name}[{lvl}]", t)
                add(f"{name}[{lvl}] device", d)
                add(f"{name}[5 levels]", t)
                add(f"{name}[5 levels] device", d)
            del f1, f2
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (PAIRS + 1, H, W)).astype(np.uint8)
    pair_flow = mvsec.fastflownet_pair_flow(None, seed=0, device=DEVICE)
    pair_flow(frames[:-1], frames[1:])                   # warm-up (cuDNN, allocator)
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        pair_flow(frames[:-1], frames[1:])               # numpy out: the card has finished
        walls.append((time.perf_counter() - t0) * 1e3)
    times[f"fastflownet_pair_flow[{PAIRS} pairs]"] = statistics.median(walls)
    # its kernels on the device alone (torch.profiler, median of N_DEVICE
    # calls): the host's share of the call varies from run to run
    prof = [port_launches(lambda: pair_flow(frames[:-1], frames[1:]), torch)
            for _ in range(N_DEVICE)]
    if None not in prof:
        times[f"fastflownet_pair_flow[{PAIRS} pairs] device"] = statistics.median(
            d[2] for d in prof)
    vox = torch.rand((1, 16, H, W, 20), device=dev)
    xr = torch.from_numpy(rng.randint(0, 1 << 30, (144, -(-(2 * H * W) // 16384), 128, 128))
                          .astype(np.int32)).to(dev)
    for label, fn, x in (("layout_barrier", barrier.layout_barrier, vox),
                         ("stream_copy", roofline.stream_copy, xr),
                         ("stream_copy_row", roofline.stream_copy_row, xr)):
        times[f"{label} device"] = graph_ms(lambda: fn(x), torch)
        times[f"{label} clone device"] = graph_ms(x.clone, torch)
    del vox, xr
    torch.cuda.empty_cache()
    return times


def roofline_times(torch, np, dev):
    """For `--compare-conv`: K13 op_chain and K14 op_chain_ilp at the
    roofline's grid (144 rows of 11 chunks of 128 x 128 int32) and k = K_LO
    and K_HI, on the device (CUDA-graph replays). Returns {label: ms}."""
    from v2ce_toolbox_tpu_torch.ops import roofline

    rng = np.random.RandomState(0)
    xr = torch.from_numpy(rng.randint(0, 1 << 30, (144, -(-(2 * H * W) // 16384), 128, 128))
                          .astype(np.int32)).to(dev)
    times = {}
    for name, fn in (("op_chain", roofline.op_chain), ("op_chain_ilp", roofline.op_chain_ilp)):
        for k in (K_LO, K_HI):
            times[f"{name}[k={k}] device"] = graph_ms(lambda: fn(xr, k), torch)
    del xr
    torch.cuda.empty_cache()
    return times


# run in each TREE: the timing code of this file, the package of the TREE
COMPARE_CONV = """
import importlib.util, json, sys, torch, numpy
spec = importlib.util.spec_from_file_location("chip_smoke_timing", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import v2ce_toolbox_tpu_torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
times = smoke.conv_times(torch, numpy, torch.device("cuda"), sets=sys.argv[2].split(","))
print("RESULT " + json.dumps({"package": v2ce_toolbox_tpu_torch.__file__, "ms": times}))
"""


def compare_conv(trees, sets=COMPARE_SETS):
    """conv_times of each TREE's package and kernels, in turns, one process
    each (each builds the TREE's csrc/); then each kernel's change against
    the first tree (the mean of the runs of each tree)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", COMPARE_CONV, os.path.abspath(__file__),
                               ",".join(sets)], cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"the conv timings of {tree} failed:\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.split("RESULT ", 1)[1])
        runs.append((tree, res["ms"]))
        log(f"[compare-conv] {tree} ({res['package']}): " + ", ".join(
            f"{label} {ms:.4f} ms" for label, ms in sorted(res["ms"].items())) + f" [{smi}]")
    base = os.path.realpath(trees[0])

    def report(label, value):
        # a label that only some trees have (a kernel's name in a profiler
        # split) is reported for those
        by_tree = {}
        for tree, ms in runs:
            with contextlib.suppress(KeyError):
                v = value(ms)
                by_tree.setdefault(os.path.realpath(tree), []).append(v)
        means = {t: statistics.mean(v) for t, v in by_tree.items()}
        log(f"[compare-conv] {label}: " + ", ".join(
            f"{os.path.relpath(t, ROOT)} {m:.4f} ms ("
            + (f"{m / means[base] - 1:+.1%}; " if base in means else "")
            + f"runs {', '.join(f'{x:.4f}' for x in by_tree[t])})" for t, m in means.items()))

    for label in sorted({label for _, ms in runs for label in ms}):
        report(label, lambda ms: ms[label])
    for d in ("bfloat16", "float32") if "conv" in sets else ():
        # the strided K11 layers without their wrapper's fold: the core's share
        report(f"conv3d_quad_s122[{d}] less fold_s122",
               lambda ms: ms[f"conv3d_quad_s122[{d}]"] - ms[f"fold_s122[{d}]"])
    print(json.dumps({"compare_conv": [{"tree": t, "ms": ms} for t, ms in runs], "card": smi}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--compare-conv"]:
        if sys.argv[2:3] == ["--sets"]:
            compare_conv(sys.argv[4:], tuple(sys.argv[3].split(",")))
        else:
            compare_conv(sys.argv[2:])
    else:
        main()
