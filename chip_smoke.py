#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (yolo_for_turbines_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  env     torch / CUDA versions and the card's name and power limit;
  build   nvcc build of csrc/*.cu (sm_90a) into the git-ignored _build/;
  k1      fused greedy NMS against its plain torch version: K = 256 at B in
          {1, 8, 128}, K = 100 and 1024 (one launch), K = 1500 and 2048 (two
          launches, bits in device memory), center and top-left boxes; every
          box invalid; one class in long suppression chains; a NaN box: keep
          masks must be equal; CUDA-event times at K = 256 for B = 1, 8 and
          128 (wrapper included, and the launches alone replayed as a CUDA
          graph) and at K = 2048;
  k2      fused residual block (wgmma + TMA) against its plain torch version
          in bf16 at the geometries the wrapper takes (C = 512, W <= 32;
          leaky and mish, B = 2) and at the timed 26x26x512 stage for B = 8
          and 128; the wrapper must refuse the other Darknet-53 geometries;
          times of the 26x26x512 stage at B = 8 and 128, with the K-major
          weights given (the model's way) and made by the wrapper, beside its
          bound and the cuDNN layer path; HGMMA and UTMALDG instructions of the built
          kernel counted in cuobjdump's SASS (both must be present);
  k3      pairwise IoU against its plain torch version, K in {1, 255, 256,
          1000, 1001, 4096} (16-byte and scalar stores), center and top-left
          boxes: matrices must be equal bit for bit; CUDA-event times at
          K = 256 and 4096 for both formats;
  k4      fused int8 residual block (s8 wgmma + TMA) against its plain torch
          version at the geometries the wrapper takes (C = 512, W <= 32,
          down to 1x1; leaky and mish): leaky codes must be equal, mish codes at most 1
          apart on under 1% of elements; the wrapper must refuse the other
          Darknet-53 geometries; times of the 26x26x512 stage at B = 8 and
          128 (leaky codes equal there too) beside its bound and the int8
          layer path (im2col + torch._int_mm + epilogue); IGMMA and UTMALDG
          instructions of the built kernel counted in cuobjdump's SASS (both
          must be present);
  k5      a folded conv's epilogue (bias, activation, residual add in one
          pass, in place) against its plain torch version at every width
          the models give it (B = 2; leaky, mish and identity, with and
          without a skip; the heads' odd widths; sizes that leave a scalar
          tail; views misaligned by one element): leaky and identity equal
          bit for bit, mish at most one bf16 step apart on under 1% of
          elements; CUDA-event times at B = 128 of 416x416x32, 208x208x64,
          52x52x256 with a skip and 13x13x255 (each launch on a tensor
          outside L2) beside their byte bounds, the plain version and the
          aten composition it replaced; its result stored into a channel
          slice of a concat buffer (the slice only, and the slice and y) at
          the concat parts of YOLOv7 at 640px and YOLOv4 at 608px, B = 64:
          bit for bit as the in-place launch, within phase k5's gate of the
          plain version, every other channel of the buffer untouched, and
          CUDA-event times beside the in-place launch's;
  k6      an int8 conv's epilogue (dequant, bias, activation, residual add
          and requant in one pass, i32 in, s8 out) against the aten
          composition it replaced at every width the models give it (B = 2;
          leaky and mish; with and without a residual and a second branch;
          sizes that leave a scalar tail; views misaligned by one element):
          codes equal bit for bit; CUDA-event times at B = 128 of
          416x416x32, 208x208x64 with a residual, 52x52x256 and 13x13x1024
          beside their byte bounds and the composition; alone, with the env
          and build lines: python3 -c "import chip_smoke; chip_smoke.k6_alone()";
  k7      an s8 conv as an implicit GEMM (i32 out) against the plain version
          it replaced (im2col copy and torch._int_mm) at every Darknet-53
          product geometry at 416px, B = 128, through the router: sums equal
          bit for bit, one launch each; CUDA-event times beside each
          geometry's bound (operations at the s8 peak or bytes) and the
          plain version's, and their sums per forward; IGMMA and UTMALDG
          instructions of the built kernel counted in cuobjdump's SASS
          (both must be present); alone, with the env and build lines:
          python3 -c "import chip_smoke; chip_smoke.k7_alone()";
  k8      the max pools of the folded bf16 forward against the aten
          composition they replaced (the pools, and the concat after SPP's):
          SPP's pyramid (13, 9, 5, 1) at 19x19x512 and SPPCSPC's (1, 5, 9, 13)
          at 20x20x512, YOLOv7's five MP 2x2 pools at 640px, at B = 2 with
          NaN and -inf planted and at B = 64: equal by value, NaN in the
          same places; CUDA-event times at B = 64 (each launch on an input
          outside L2) beside the byte bound and aten's time; registers,
          stack and local memory of each K8 kernel (cuobjdump -res-usage);
          planes beyond a band of shared memory (86x86, 160x160, 40x558),
          tiny's stride-1 2x2 pool, and inputs the wrappers refuse (NCHW, 12
          channels, off 16 bytes, a channel slice) through the router, which
          launches K8 for each, at B = 2: equal by value in the input's layout;
          K8 launches per YOLOv4 predict_batch at 608px (1; YOLOv7's 6 are
          phase yolov7's), and a YOLOv7 forward with every pool on aten
          (pool_wins patched) against the unpatched one in the same
          process: heads equal; YOLOv4's 110 K5 launches per predict_batch,
          its heads and boxes with the concats written in place against
          the same predictor's with torch.cat (concat_wins patched): bit
          for bit, and K5's share of the concat bytes at least 0.9; alone,
          with the env and build lines:
          python3 -c "import chip_smoke; chip_smoke.k8_alone()";
  k10     the single-image letterbox on the card (K10) bit for bit against
          its plain version (Pillow's integer passes) at the stream cell's
          three frame sizes and odd geometries (12 MP, portrait, a side of
          3, upsamples, an unchanged frame); per stream size the kernel
          alone (CUDA events), the frame's upload and K10 through a
          pageable .to (the predictor's way) and a pinned staging buffer, and
          the host letterbox it replaced (PIL, pad, / 255, the float
          canvas's upload), each to a synchronise; a 2-class mish Darknet-53
          predictor's requests: one K10 launch each, each size's tables made
          once, and each size's request with K10 against the same request
          on the host letterbox; alone, with the env and build lines:
          python3 -c "import chip_smoke; chip_smoke.k10_alone()";
  rtdetr  RT-DETR-R50's kernel paths: K5's ReLU and its add-first order
          (a bottleneck's shortcut joins before its ReLU) bit for bit
          against the plain version at every width phase k5 checks and at
          misaligned views, timed at ResNet-50-vd's stage outputs at 640px,
          B = 64; K8's 3x3 stride-2 pad-1 pool (the stem's) against aten by
          value with NaN and -inf planted (320x320x64, odd sides, a width
          padded to 8), timed at 320x320x64, B = 64, beside aten's; then the
          rtdetr cell's driver at 640px and B = 8 (its seeded weights folded
          by the program): 85 K5, 1 K8, 0 K1 launches and 1,382,400
          deformable samples per predict_batch, rows (8, 300, 6), and the
          cell's four numbers against the reference; K9 (the deformable
          sampling core) against its plain version at 8,400 tokens, 300
          queries, B = 2 and 64 (within one bf16 rounding), timed at B = 64
          beside the plain version, a bf16-grid grid_sample and its byte
          bound, its registers; 6 K9 launches per predict_batch; alone:
          python3 -c "import chip_smoke; chip_smoke.rtdetr_alone()";
  main    the 80-class Darknet-53 at 416px from seeded random weights, bf16:
          predict_images, predict_image, predict_batch at B = 8 and 128;
          K5 exactly 59 times per predict_batch at B = 8 and 128;
          K1 and K2 must launch, outputs must be finite and well shaped,
          and raw heads must agree with an f32 CPU forward of the same weights;
  yolov7  YOLOv7 at 640px from seeded folded weights, bf16, B = 8: 92 K5,
          6 K8 and 0 K2 launches per predict_batch, K1 at the end; the raw
          heads against the f32 CPU forward printed; its heads and boxes
          with the concats written in place against the same predictor's
          with torch.cat (concat_wins patched): bit for bit, and K5's share
          of the concat bytes at least 0.9; phases k5, k8 and yolov7 alone:
          python3 -c "import chip_smoke; chip_smoke.concat_alone()";
  main_f32  the same model with compute_dtype=float32 (TF32 off),
          predict_batch at B = 2: K2 and K5 are bf16 only, so they must not
          launch (the stage takes the cuDNN layer path, every conv its
          separate epilogue ops) while K1 must, and the raw heads
          must agree with the f32 CPU forward;
  main_int8  the same model quantized (int8 PTQ, calibrated on 8 seeded
          images) and served through the same entry points: K1 and K4 must
          launch (K5 never), K6 exactly 53 and K7 55 times per predict_batch
          at B = 8 and 128, outputs must be finite and well shaped, and against the
          port's int8 CPU forward of the same qparams the s8 trunk codes
          each head reads must agree and the raw heads must agree (cosine);
          a predictor built for 608px, quantized the same way and fed the
          416px batch must launch K4 too and give the same trunk codes;
  eval    the trainable 80-class Darknet-53 at 416px (seeded init, seeded BN
          scale and bias, running statistics from a train-mode pass over
          seeded noise, then jittered; objectness rows scaled so that scores
          spread around 0.5), 32 seeded noise images with 1 to 8 random
          boxes each, encoded by assign_targets: the fused eval step in
          float32 at B = 2, with TF32 turned on around it so that the step's
          own switch must turn it off, against the port's f32 CPU step (loss
          terms, accuracy counts, survivors; the TF32 heads' distance from
          the f32 heads is printed beside); the step in bf16 autocast at
          B = 8 (heads against the f32 card heads, loss terms finite); K1
          must launch at least once per eval step; device mAP equal to host
          calc_map over the 32 images (the survivors, and the survivors with
          jittered copies of the ground truth); the ground-truth replay
          exactly 1.0; fold() served by Predictor.from_folded: K2 8 and K1 1
          launches per bf16 predict_batch at B = 8, float32 folded heads
          against the trainable module's; eval-step images/s at B = 8 and
          32, evaluate_map_device's wall time over the 32 images,
          calc_map_device_batched at I = 1000, K = 256, G = 128, C = 80, and
          host calc_map over the 32 images;
  train   the 2-class Darknet-53 with mish that train() builds (seeded init):
          one float32 train step on the card (TF32 on around it, so the
          step's own switch must turn it off) against the port's float32 CPU
          step from the same weights at B = 2, 416px (loss terms, every
          parameter's update, running statistics; beside them the loss
          terms with TF32 left on and in float64); 20 bf16 autocast steps of
          the Trainer at B = 32 on one fixed batch at 416 and at 608px after
          prewarm (finite, the loss falling; step time, images/s, peak
          memory; at 416 the torch.profiler idle share of one step); the
          trained state through a checkpoint and back, bit for bit; train()
          for 10 epochs of 2 steps (10 of warmup to lr 2e-4) on 96 seeded
          synthetic JPEGs (B = 32):
          the loader's host time per batch, the last epoch's train loss
          below the first's, K1 launched at epoch 9's fused
          eval at least once per val batch (K2 never), the metrics JSONL
          with train, val and mAP rows, its checkpoint back on the card bit
          for bit, and that state's epoch-9 eval with device mAP equal to
          host calc_map.
  families  CSPDarknet-53 and YOLOv3-tiny at full width, 416px: the
          80-class CSPDarknet-53 from a seeded trainable model with
          calibrated BN statistics, folded, served in bf16 (predict_images,
          predict_image, predict_batch at B = 8 and 128; raw heads in bf16
          and in float32 against the f32 CPU forward, with cuDNN pinned,
          and each concat swapped alone as the control) and in int8
          (calibrated on 8 seeded images, B = 128; s8 trunk codes and heads
          against the int8 CPU forward, main_int8's gates); the 80-class
          tiny written by export_darknet_weights from a seeded trainable
          model with calibrated BN statistics (8,858,734 floats, the
          official file's count), served by load_predictor in bf16 at B =
          1, 8 and 128 and in int8 at B = 128, with the same gates; K1
          exactly once and K2 and K4 never per predict_batch of either
          family. The 2-class mish CSPDarknet-53 trained: the f32 card step
          against the CPU step at B = 2 (train's gates, loss terms 5e-5;
          the terms with TF32 on must read above that),
          20 bf16 Trainer steps at B = 32 (ms, images/s, peak memory, the
          torch.profiler summary of one step), a fused eval step
          (K1 once), its checkpoint served by load_predictor_from_checkpoint
          with the detections of Predictor.from_folded on its fold(); one
          bf16 tiny train step and eval step at B = 32 (losses finite, K1
          once).
  deploy  the 80-class Darknet-53 with phase eval's weights, written as a
          darknet file by the port, 416px: tools.export writes a bf16 and
          an int8 bundle (8 seeded calibration JPEGs), each with exported
          programs at B = 8 and 128; load_predictor_bundle serves them at B
          = 8 and 128, bit for bit as load_predictor (and quantize) in this
          process, with K1 once and K2 (bf16) or K4 (int8) 8 times per
          predict_batch; ExportedPredictor on the card launches no kernel,
          its masks equal and boxes within EXPORT_BOX_ATOL of the live
          predictor's on the plain layer path (bf16: fuse_resblocks=False
          and each conv's epilogue on separate ops;
          int8: as loaded, K4's codes being the layer path's); .pt2 sizes
          against the weights; images/s of both; tools.demo on one JPEG:
          K1 exactly once, the PNG at the image's size, its count equal to
          predict_image's;
  hpo     tools.anchors on the train phase's synthetic labels (the same 96
          seeded JPEGs), then tune_model over make_hpo_train_fn (the 2-class
          mish Darknet-53 at 416px, B = 32, no multi-scale, those anchors):
          4 trials in order (grace 1, max 4 epochs, 2 brackets), each
          trial's epochs equal to its bracket's rung budgets, K1 at least
          once per val batch per rung, best_config.json read back by
          load_config; then 2 trials in 2 spawned workers, both on the card;
          wall time per trial and per search.
  parallel  DP and SP (parallel/). World size 1 over NCCL in this process:
          the DP Predictor (80-class Darknet-53, 416px) bit for bit as the
          plain one with cuDNN pinned, bf16 at B = 8 and 128 and int8 at
          128, K1 once and K2 / K4 8 times per call; the DP train step of
          the 2-class mish model (synced BN, global loss counts, the
          gradient all-reduce) against the plain step: float32 at B = 8
          within the train phase's gates, float64 at B = 2 (updates within
          1e-8), and the bf16 steps at B = 32 timed in turns beside the
          plain step's. Two gloo ranks spawned on the one card: DP at B =
          16, each rank's 8 rows bit for bit as the single-process predictor
          on the same images, K1 once and K2 8 times per rank; SP with
          n_space = 2 of the float32 and bf16 folded model at 832px (every
          scale sharded) and 416px (the deepest grids gathered): heads
          against the single-process f32 forward (f32 1e-4, bf16
          HEAD_RTOL), the SP predictor, its int8 form (calibrated on 8
          seeded images, halos of s8 codes) against the plain int8 layer
          path on the same qparams (cosine per raw head), no kernel
          launched, the SP forward's ms. Then the peak memory of bf16 predict_batch at B = 1
          for 416 to 3328px and B = 8 at 1664px.
  converge  R1 of tools/convergence.py, the JAX package's Darknet-53
          convergence recipe: train() of the 2-class mish Darknet-53 from
          its seeded init at lr 1e-3 (5% warmup, then cosine), 550 steps of
          B = 32 with mosaic at 416px over 416 seeded synthetic JPEGs split
          85 / 15: no stop on the NaN guard, every step taken, the best val
          mAP@0.5 at or above CONVERGE_MAP_BAR, K1 at least once per val
          batch of every 10th epoch's fused eval (K2 and K4 never); its best
          checkpoint evaluated again by the Trainer (device mAP equal to
          host calc_map), then served by load_predictor_from_checkpoint on
          the val split: host mAP@0.5 of predict_batch's detections in bf16
          (within SERVED_MAP_TOL of the Trainer's) and in int8 after
          Predictor.quantize on 8 train images (finite, printed beside),
          K1 once and K2 (bf16) or K4 (int8) 8 times per call, survivors
          per image; the mAP trajectory, losses by epoch, train()'s wall
          seconds and the loader's host seconds per batch.
  finetune  the fine-tune and high-resolution path of tools/convergence.py
          (R3F's frozen import on R4's set), the 2-class mish Darknet-53 at
          full width: 96 seeded 1280x960 small-defect JPEGs, k-means anchors
          checked to reach target assignment, a seeded backbone.conv.74
          written through the darknet format; two epochs of a Trainer with
          it imported frozen (frozen parameters out of SGD and bit for bit,
          every other one moved); train() with it frozen, multi-scale
          buckets, B = 32, 20 steps at TRAIN_LR (the frozen count that of
          JAX's mask, FROZEN_CONV74; the checkpoint's frozen parameters
          equal to the file's; losses finite; K1 at epoch 9's fused eval);
          the checkpoint resumed by train(load_checkpoint=True) at 832px,
          B = 8, for 10 steps (step and schedule restored, the lr of every
          resumed step the restored schedule's, printed); the checkpoint
          evaluated at 416, 608 and 832 (evaluate_map_device equal to host
          calc_map, K1 once per eval step); served by
          load_predictor_from_checkpoint at 416 in bf16 (K1 1, K2 8 per
          call) and int8 (K1 1, K4 8) and at 608 in bf16 (K1 1, K2 0): the
          served bf16 mAP within SERVED_MAP_TOL of the trainer's at the same
          size, the bf16 heads within HEAD_RTOL of a float32 predictor's
          (the serving gate, which R1's trained weights meet at 0.0135).
The main phases also count K3's launches (no serving path calls it).
Then the kernel table as one JSON line (each kernel's time beside its
bound from this run's inputs: bytes over 3.35 TB/s or operations over the
peak of their type, whichever is larger; the published H100 SXM
figures), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises (non-zero exit).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
K = 256
N_CAND = 10647  # candidates per image at 416px: 3 * (13^2 + 26^2 + 52^2)
# (H = W, C, blocks) of the Darknet-53 residual stages at 416px
GEOMETRIES = ((208, 64, 1), (104, 128, 2), (52, 256, 8), (26, 512, 8), (13, 1024, 4))
# (H, W, blocks) K2 and K4 are checked at, all with C = 512: the 16x16 to
# 32x32 range the routers send them (320-512px inputs) and a non-square tile
# edge
K2_GEOMETRIES = ((16, 16, 2), (20, 20, 2), (26, 26, 8), (32, 32, 2), (13, 29, 2))
# K4 besides at the ends of what its wrapper takes (1 <= W <= 32, any H)
K4_GEOMETRIES = K2_GEOMETRIES + ((1, 1, 1), (40, 3, 1), (9, 7, 1), (50, 31, 1))
# Published peak rates of one H100 SXM at 700 W, for bounds
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12
# K2 tolerance: max |kernel - plain| <= K2_TOL * max |plain|. Both round mid
# and each block's output to bf16 (2^-8 relative spacing) after f32 sums taken
# in different orders, so single elements may differ by one bf16 step and the
# difference propagates through up to 8 chained blocks; 2^-5 allows a few
# steps at the top of the range while an indexing fault gives O(1) errors.
K2_TOL = 2.0 ** -5
# Raw-head tolerance of the bf16 card forward against the f32 CPU forward:
# relative RMS error per head. About 75 layers each round activations to bf16
# (2^-9 relative), which compounds to a few percent at the heads.
HEAD_RTOL = 0.05
# Raw-head tolerance of the f32 card forward (TF32 off) against the f32 CPU
# forward: relative RMS error per head. Both sum each conv in f32 in another
# order; measured 1.5e-8 to 1.9e-8 on an H100 (the heads of seeded random
# weights are mostly bias), gated at 1e-6 to leave room for another cuDNN's
# choice of algorithm. A stage in bf16 gives 2e-3.
HEAD_RTOL_F32 = 1e-6
# K4 with mish: the kernel's tanhf/log1pf/expf may differ from torch's CUDA
# mish by an ulp, which moves a requant code at a .5 tie. With leaky_relu
# the codes must be equal.
K4_MISH_MAX_CODES = 1
K4_MISH_MAX_FRAC = 0.01
# K5 (the folded conv's epilogue) against its plain version, which runs the
# same f32 operations and rounds once: leaky, silu (torch's CUDA silu,
# x / (1 + expf(-x))) and identity equal bit for bit;
# with mish the kernel's tanhf/log1pf/expf may differ from torch's CUDA mish
# by an ulp, which moves the bf16 result by at most one step at a tie.
K5_MISH_MAX_FRAC = 0.01
# K5 launches per bf16 Darknet-53 predict_batch at 416px: every folded conv
# outside the 26x26x512 stage, which K2 runs
K5_PER_CALL = 59
# K5's timed shapes at B = 128: (H = W, C, activation, skip) of Darknet-53's
# stem conv at 416px, its first downsample, a 52x52 residual block's 3x3
# (the block's input added) and the 13x13 head's 1x1, and a 160x160x128
# SiLU conv of YOLOv7 at 640px (its second ELAN's widest)
K5_TIMED = ((416, 32, "leaky_relu", False), (208, 64, "leaky_relu", False),
            (52, 256, "leaky_relu", True), (13, 255, "identity", False),
            (160, 128, "silu", False))
# K5 checked besides at B = 2: every width the models give it, the heads'
# odd ones, widths whose channel period passes a block's 256 threads, and
# sizes that leave a scalar tail (B * H * W * C % 8 != 0)
K5_CHECKED = ((5, 7, 32), (3, 3, 64), (4, 6, 128), (13, 13, 256), (26, 26, 512),
              (13, 13, 1024), (13, 13, 255), (5, 7, 255), (3, 5, 21), (2, 3, 3), (3, 3, 1),
              (2, 2, 2056), (3, 1, 1023))
# K5 launches per bf16 YOLOv7 predict_batch at 640px: every one of its 92
# folded convs (89 under SiLU, the heads' three 1x1s identity)
K5_PER_CALL_YOLOV7 = 92
# and per bf16 YOLOv4 predict_batch at 608px: its 110 folded convs
K5_PER_CALL_YOLOV4 = 110
# K5's result stored into a concat buffer's channel slice, B = 64: (H = W,
# C, the slice's channel offset, the buffer's channels, activation, keep y)
# of YOLOv7's concat parts at 640px (the first ELAN's c4 and its kept b, an
# ELAN-H's kept c2, an MP's pool branch) and YOLOv4's at 608px (CSP stage
# 1's split1 and stage 5's transition under mish, a lateral 1x1 and a
# join's stride-2 conv under leaky)
K5_SLICES = ((160, 64, 0, 256, "silu", False), (160, 64, 128, 256, "silu", True),
             (40, 128, 256, 1024, "silu", True), (80, 128, 128, 256, "silu", False),
             (304, 64, 64, 128, "mish", False), (19, 512, 0, 1024, "mish", False),
             (76, 128, 0, 256, "leaky_relu", False), (19, 512, 0, 1024, "leaky_relu", False))
# the least share of a YOLOv4 or YOLOv7 predict_batch's concat bytes that K5
# stores in place (the rest: routes and upsampled halves copied in)
CONCAT_IN_PLACE_SHARE = 0.9
# K6 launches per int8 Darknet-53 predict_batch at 416px (any B): every int8
# conv outside K4's 26x26x512 stage and the heads (bf16)
K6_PER_CALL = 53
# K7 launches per int8 Darknet-53 predict_batch at 416px (any B): the
# products of K6's 53 convs, two of which read a concat as two products
K7_PER_CALL = 55
# K7's geometries, every product of Darknet-53 at 416px outside K4's stage:
# (H = W, Cin, Cout, kernel, stride, products per forward); the stem's Cin 3
# goes through its im2col copy, then K7 as a 1x1 over the copy's rows
K7_GEOMETRIES = ((416, 3, 32, 3, 1, 1), (416, 32, 64, 3, 2, 1), (208, 64, 32, 1, 1, 1),
                 (208, 32, 64, 3, 1, 1), (208, 64, 128, 3, 2, 1), (104, 128, 64, 1, 1, 2),
                 (104, 64, 128, 3, 1, 2), (104, 128, 256, 3, 2, 1), (52, 256, 128, 1, 1, 10),
                 (52, 128, 256, 3, 1, 10), (52, 128, 128, 1, 1, 1), (52, 256, 512, 3, 2, 1),
                 (26, 512, 1024, 3, 2, 1), (26, 256, 256, 1, 1, 1), (26, 512, 256, 1, 1, 3),
                 (26, 256, 512, 3, 1, 2), (26, 256, 128, 1, 1, 1), (13, 1024, 512, 1, 1, 7),
                 (13, 512, 1024, 3, 1, 6), (13, 512, 256, 1, 1, 1))
# K8's pyramids, B = 64: (side, C, windows) of YOLOv4's SPP at 608px and
# YOLOv7's SPPCSPC at 640px
K8_PYRAMIDS = ((19, 512, (13, 9, 5, 1)), (20, 512, (1, 5, 9, 13)))
# K8's 2x2 pools, B = 64: (side, C) of YOLOv7's five MP inputs at 640px
K8_MP = ((160, 256), (80, 512), (40, 1024), (80, 128), (40, 256))
# K8 launches per bf16 predict_batch: YOLOv4's SPP; YOLOv7's SPPCSPC and MP
K8_PER_CALL = {"yolov4": 1, "yolov7": 6}
# K8 checked besides at B = 2: (H, W, C, windows) of pyramids over planes
# in bands of rows, and (side, C) of tiny's stride-1 2x2 pool at 416px
K8_BANDED = ((86, 86, 64, (13, 9, 5, 1)), (160, 160, 8, (1, 5, 9, 13)),
             (40, 558, 16, (13, 9, 5, 1)))
K8_STRIDE1 = ((13, 512),)
# K5 launches per bf16 RT-DETR-R50 predict_batch (any size): the backbone's
# 55 folded convs (stem 3, bottlenecks 48, shortcuts 4), the encoder's 27,
# the decoder's 3 input projections
K5_PER_CALL_RTDETR = 85
# K5's add-first order and ReLU, timed at B = 64: (H = W, C) of ResNet-50-vd's
# stage outputs at 640px (a bottleneck's last conv, its shortcut added
# before the ReLU)
K5_FIRST_TIMED = ((160, 256), (80, 512), (40, 1024), (20, 2048))
# K8's 3x3 stride-2 pad-1 pool: (H, W, C) checked at B = 2 with NaN and -inf
# planted (the stem's input at 640px, odd sides, a width padded to 8) and
# timed at B = 64 (the first)
K8_STEM = ((320, 320, 64), (7, 9, 8), (5, 5, 21), (1, 1, 16))
# K6's timed shapes, Darknet-53 at 416px, B = 128: (H = W, C, residual) of
# the stem conv, a 208x208 residual block's 3x3 (the block's input added),
# a 52x52 1x1 and the 13x13 neck's 3x3
K6_TIMED = ((416, 32, False), (208, 64, True), (52, 256, False), (13, 1024, False))
# K6 checked besides at B = 2: every width the models give it, widths whose
# channel period passes a block's 256 threads, and sizes that leave a scalar
# tail (B * H * W * C % 16 != 0)
K6_CHECKED = ((5, 7, 32), (3, 3, 64), (4, 6, 128), (13, 13, 256), (26, 26, 512),
              (13, 13, 1024), (3, 5, 48), (2, 3, 3), (3, 1, 1023), (2, 2, 2056))
# int8 card forward against the port's int8 CPU forward from the same
# qparams. The trunk runs the same integer products and the same f32
# epilogue ops in the same order on both (K4 equals its plain version), so
# the s8 codes each head reads should be equal; a requant code flipped at a
# .5 tie would spread through the layers after it, so the bound is on the
# share of differing codes. A wrong kernel, im2col or padding moves most
# codes. The heads, mostly bias on random weights, run bf16 on the card and
# f32 on the CPU: cosine per raw head.
INT8_TRUNK_MAX_FRAC = 1e-3
INT8_HEAD_COS = 0.999
# eval phase. The trainable model's BN statistics are calibrated so that
# every layer carries signal (random statistics would leave each head a
# constant plus noise, where rounding decides scores and counts). Rounding
# then accumulates through the ~75 normalized layers.
EVAL_IMAGES = 32
# Loss terms of the f32 card step (TF32 off) against the f32 CPU step,
# relative per term: 8.1e-6 at most, in obj_loss, which averages over only
# 48 object cells (an H100).
EVAL_LOSS_RTOL = 1e-5
# f32 heads, relative RMS per head: the port and the JAX package differ by up
# to 1.3e-5 in the mini model's eval heads on the CPU
# (tests/test_torch_trainable.py), and the folded f32 heads on the card by
# 1.5e-5 to 3.1e-5 from the trainable module's (an H100).
EVAL_HEAD_RTOL = 1e-4
# bf16 heads against the f32 heads, relative RMS per head: 0.10-0.17
# (autocast) and 0.11-0.20 (folded) in the mini model on the CPU, against
# about 1.4 for unrelated heads (the serving gate HEAD_RTOL holds only for
# heads that are mostly bias).
EVAL_BF16_HEAD_RTOL = 0.3
# Survivor boxes of the f32 card step against the CPU step: decoded from
# heads held at EVAL_HEAD_RTOL, so |card - cpu| <= 1e-4 |cpu| + 1e-5.
EVAL_BOX_RTOL, EVAL_BOX_ATOL = 1e-4, 1e-5
EVAL_MAP_TOL = 1e-5
# Objectness logits have mean OBJECTNESS_MEAN and standard deviation
# OBJECTNESS_STD on the calibration images: a few dozen candidates per
# image pass the 0.5 threshold, and few logits lie where the card's and
# the CPU's rounding could flip a count.
OBJECTNESS_MEAN, OBJECTNESS_STD = -4.0, 1.5
# train phase: the 2-class Darknet-53 with mish that train() builds.
# f32 step on the card (TF32 off by the step's own switch) against the
# port's f32 CPU step at B = 2, 416px, from the same weights (an H100): loss
# terms, relative per term, measured 3.6e-6 (obj_loss); each parameter
# leaf's update (new - old), relative RMS, worst leaf 1.55e-4 (a BN scale of
# the 13x13 stage; 3.7e-5 over all parameters); running statistics, worst
# leaf 3.5e-6
TRAIN_LOSS_RTOL = 1e-5
TRAIN_UPDATE_RTOL = 5e-4
TRAIN_STATS_RTOL = 1e-5
# bf16 autocast steps on one fixed batch of B = 32 at 416 and 608px: the
# mean loss of the last 5 of TRAIN_STEPS steps below that of the first 5
TRAIN_STEPS = 20
# train(): TRAIN_IMAGES seeded synthetic JPEGs (640x480), split 85 / 15,
# B = 32, max_num_steps = 20 (half of them warmup): 2 steps per epoch for 10
# epochs, and the fused eval (K1) at epoch 9. Peak lr TRAIN_LR, the lr that
# the default recipe (1e-3, warmup 1% of 10,000 steps) reaches at its 20th
# step. From scratch, 10 warmup steps are too few for 1e-3: this run then
# spikes (tools/train_stability.py, an H100: the largest epoch train loss
# after the first 39.0, 11.6, 47.8 and 15.1 at 1e-3; 11.3-14.6 at 2e-4, the
# last epoch at 5.0-6.0 below the first's 12.6-13.7), and one run of this
# script stopped on train()'s NaN guard. That is the warmup's doing, not the
# port's: with the JAX recipe's 27 warmup steps of 550 the port trains at
# 1e-3 to the JAX run's mAP (phase converge; PERF.md)
TRAIN_IMAGES = 96
TRAIN_LR = 2e-4
ROOT = Path(__file__).resolve().parent
TRAIN_DIR = ROOT / "_smoke"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 100):
    """Microseconds per call of ``fn`` after a warm-up: on the host (the
    Python call until it returns, its launches queued, not awaited) and
    on the wall clock until the card has finished them all."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6, (time.perf_counter() - t0) / calls * 1e6


def ab_ms(kernel_fn, plain_fn, iters: int, plain_iters: int):
    """Times in turns (plain, kernel, kernel, plain) within one process."""
    p1 = cuda_ms(plain_fn, plain_iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, plain_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def nms_inputs(batch: int, gen: torch.Generator, dev, k: int = K, classes: int = 3):
    from yolo_for_turbines_tpu_torch.ops.nms import _top_k_candidates

    boxes = torch.zeros(batch, N_CAND, 6)
    boxes[..., 0:2] = torch.rand(batch, N_CAND, 2, generator=gen) * 0.6 + 0.2
    boxes[..., 2:4] = torch.rand(batch, N_CAND, 2, generator=gen) * 0.35 + 0.05
    # distinct scores: a permutation of evenly spaced values
    boxes[..., 4] = torch.randperm(batch * N_CAND, generator=gen).reshape(
        batch, N_CAND).float() / (batch * N_CAND)
    boxes[..., 5] = torch.randint(0, classes, (batch, N_CAND), generator=gen).float()
    return _top_k_candidates(boxes.to(dev), 0.3, k)


def phase_k1(dev, gen):
    from yolo_for_turbines_tpu_torch.ops.kernels import nms_kernel as nk

    out = {"phase": "k1", "kernel": "greedy_nms", "K": K, "N": N_CAND, "checks": []}

    def check(cand, valid, fmt, what):
        before = nk.launches
        got = nk.greedy_nms(cand, valid, 0.45, fmt)
        torch.cuda.synchronize()
        want = nk.greedy_nms_reference(cand, valid, 0.45, fmt)
        b, k = valid.shape
        out["checks"].append({**what, "B": b, "K": k, "format": fmt, "valid": int(valid.sum()),
                              "kept": int(got.sum()), "mismatches": int((got != want).sum()),
                              "cuda_launches": nk.launches - before})
        if out["checks"][-1]["mismatches"]:
            emit(out)
            raise AssertionError(f"K1 keep mask differs from plain: {out['checks'][-1]}")
        return got

    for batch in (1, 8, 128):
        cand, valid = nms_inputs(batch, gen, dev)
        got = check(cand, valid, "center", {"case": "serving"})
        ms, plain_ms = ab_ms(
            lambda: nk.greedy_nms(cand, valid, 0.45),
            lambda: nk.greedy_nms_reference(cand, valid, 0.45),
            iters=50, plain_iters=3,
        )
        out[f"B{batch}_ms"], out[f"B{batch}_plain_ms"] = ms, plain_ms
        out[f"B{batch}_bound_ms"], out[f"B{batch}_bound_by"] = nms_bound(cand, valid, got)
        # the card's share of that time: 20 calls replayed as one CUDA graph,
        # with no host work between the launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(20):
                nk.greedy_nms(cand, valid, 0.45)
        out[f"B{batch}_device_ms"] = cuda_ms(graph.replay, 10) / 20
    # K off a multiple of 32, at the one-launch limit, and past it (two
    # launches, the bits in device memory), in both box formats
    for k, batch in ((100, 3), (1024, 2), (1500, 2), (2048, 2)):
        cand, valid = nms_inputs(batch, gen, dev, k=k)
        for fmt in ("center", "top_left"):
            check(cand, valid, fmt, {"case": "sizes"})
        if k == 2048:
            nan = cand.clone()
            nan[0, 7, 3] = float("nan")
            nan[1, 1500, 0] = float("inf")
            check(nan, valid, "center", {"case": "nan_box"})
            out["K2048_B2_ms"], out["K2048_B2_plain_ms"] = ab_ms(
                lambda: nk.greedy_nms(cand, valid, 0.45),
                lambda: nk.greedy_nms_reference(cand, valid, 0.45),
                iters=20, plain_iters=2,
            )
    cand, valid = nms_inputs(4, gen, dev)
    check(cand, torch.zeros_like(valid), "center", {"case": "all_invalid"})
    # one class, heavily overlapping: long chains in which cleared boxes
    # must clear nothing
    for k in (K, 2048):
        chain, chain_valid = nms_inputs(2, gen, dev, k=k, classes=1)
        chain[..., 0:2] = 0.5 + 0.2 * (chain[..., 0:2] - 0.5)
        chain[..., 2:4] = 0.3 + 0.1 * chain[..., 2:4]
        check(chain, chain_valid, "center", {"case": "one_class_chains"})
    nan = cand.clone()
    nan[0, 3, 2] = float("nan")
    nan[1, 0, 0] = float("nan")
    nan[2, 200, 5] = float("nan")
    nan[3, 40, 1] = float("inf")
    check(nan, valid, "center", {"case": "nan_box"})
    emit(out)
    return {"max_abs_err": 0.0, "ms": out["B128_ms"], "plain_ms": out["B128_plain_ms"],
            "bound_ms": out["B128_bound_ms"], "bound_by": out["B128_bound_by"],
            "library_ms": None}


def bound_of(nbytes: float, ops: float, peak: float):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nms_bound(cand, valid, keep):
    """K1: reads the candidates and validity, writes the keep mask; each kept
    box i is tested against the K - 1 - i boxes after it (about 20 f32
    operations per IoU test), as this run's keep masks say."""
    b, k = valid.shape
    nbytes = cand.numel() * 4 + valid.numel() + keep.numel()
    after = torch.arange(k - 1, -1, -1, device=keep.device)
    tests = float((keep.to(after.dtype) * after).sum())
    return bound_of(nbytes, 20.0 * tests, F32_FLOPS)


def stage_inputs(batch, hw, c, n, gen, dev):
    """Seeded bf16 operands of an n-block stage; hw is H = W or (H, W)."""
    h, w = (hw, hw) if isinstance(hw, int) else hw
    ch = c // 2
    x = torch.randn(batch, h, w, c, generator=gen).to(dev, torch.bfloat16)
    w1 = (torch.randn(n, c, ch, generator=gen) / c ** 0.5).to(dev, torch.bfloat16)
    b1 = (0.1 * torch.randn(n, ch, generator=gen)).to(dev)
    w2 = (0.5 * torch.randn(n, 3, 3, ch, c, generator=gen) / (9 * ch) ** 0.5).to(
        dev, torch.bfloat16)
    b2 = (0.1 * torch.randn(n, c, generator=gen)).to(dev)
    return x, w1, b1, w2, b2


def layer_path(x, w1, b1, w2, b2, activation):
    """The model's unfused bf16 path for the same stage (cuDNN convs,
    channels_last), for scale beside the two times."""
    import torch.nn.functional as F

    from yolo_for_turbines_tpu_torch.models.blocks import get_activation

    act = get_activation(activation)
    x = x.permute(0, 3, 1, 2)
    for i in range(w1.shape[0]):
        wa = w1[i].t()[:, :, None, None].contiguous(memory_format=torch.channels_last)
        wb = w2[i].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        y = act(F.conv2d(x, wa, b1[i].to(x.dtype)))
        y = act(F.conv2d(y, wb, b2[i].to(x.dtype), padding=1))
        x = x + y
    return x


def stage_bound(x, w1, w2, peak):
    """A residual stage of n blocks: 2 * positions * (C * C/2 + 9 * C/2 * C)
    operations per block; x read and the output written once, each block's
    weights and biases read once."""
    b, h, w, c = x.shape
    n, ch = w1.shape[0], c // 2
    ops = 2.0 * b * h * w * (c * ch + 9 * ch * c) * n
    nbytes = 2 * x.numel() * x.element_size() + (w1.numel() + w2.numel()) * w1.element_size() \
        + n * (ch + c) * 4
    return bound_of(nbytes, ops, peak)


def sass_counts(fragment: str, ops):
    """Counts of each SASS opcode in `ops` in the built library's kernel whose
    name contains `fragment` (cuobjdump -sass)."""
    from yolo_for_turbines_tpu_torch.ops import kernels

    cuobjdump = str(Path(kernels._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(kernels.LIBRARY)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {op: 0 for op in ops}, ""
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1]
        elif fragment in name:
            for op in ops:
                counts[op] += f" {op}" in line
    return counts


def phase_k2(dev, gen):
    from yolo_for_turbines_tpu_torch.ops.kernels import resblock_kernel as rk

    out = {"phase": "k2", "kernel": "fused_residual_stage", "tol_rel_to_max": K2_TOL,
           "checks": []}
    out["sass"] = sass_counts("resblock_wgmma_kernel", ("HGMMA", "UTMALDG"))
    if not all(out["sass"].values()):
        emit(out)
        raise AssertionError(f"K2 is not built on wgmma and TMA: {out['sass']}")
    worst = 0.0

    def check(args, activation, what):
        nonlocal worst
        got = rk.fused_residual_stage(*args, activation=activation)
        torch.cuda.synchronize()
        want = rk.fused_residual_stage_reference(*args, activation=activation)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        out["checks"].append({**what, "act": activation, "max_abs_err": err, "ref_max": scale})
        worst = max(worst, err)
        if not err <= K2_TOL * scale:
            emit(out)
            raise AssertionError(f"K2 differs from plain: {out['checks'][-1]}")

    for activation in ("leaky_relu", "mish"):
        for h, w, n in K2_GEOMETRIES:
            batch = 8 if (h, w) == (26, 26) else 2
            check(stage_inputs(batch, (h, w), 512, n, gen, dev), activation,
                  {"h": h, "w": w, "c": 512, "n": n, "B": batch})
    # the wrapper takes nothing else: no fallback for the other stages
    for hw, c, _ in GEOMETRIES:
        if c != 512:
            try:
                rk.fused_residual_stage(*stage_inputs(1, hw, c, 1, gen, dev))
            except ValueError:
                continue
            raise AssertionError(f"K2 took the geometry {hw}x{hw}x{c}")
    for batch in (8, 128):
        args = stage_inputs(batch, 26, 512, 8, gen, dev)
        # the K-major weight copies, made once as ResidualStage.kmajor makes them
        kmajor = rk.kmajor_weights(args[1], args[3])
        if batch == 128:  # the timed shape is held against the plain version too
            check(args, "leaky_relu", {"h": 26, "w": 26, "c": 512, "n": 8, "B": batch})
        given = rk.fused_residual_stage(*args, activation="leaky_relu", kmajor=kmajor)
        require(torch.equal(given, rk.fused_residual_stage(*args, activation="leaky_relu")),
                "K2 with K-major weights given differs from K2 making them itself")
        ms, plain_ms = ab_ms(
            lambda: rk.fused_residual_stage(*args, activation="leaky_relu", kmajor=kmajor),
            lambda: rk.fused_residual_stage_reference(*args, activation="leaky_relu"),
            iters=10, plain_iters=3,
        )
        key = f"26x26x512_B{batch}"
        out[f"{key}_ms"] = ms
        out[f"{key}_plain_ms"] = plain_ms
        # the wrapper transposing the weights itself on every call
        out[f"{key}_wrapper_kmajor_ms"] = cuda_ms(
            lambda: rk.fused_residual_stage(*args, activation="leaky_relu"), 10)
        out[f"{key}_bf16_layers_ms"] = cuda_ms(lambda: layer_path(*args, "leaky_relu"), 10)
        out[f"{key}_bound_ms"], out[f"{key}_bound_by"] = stage_bound(args[0], args[1], args[3],
                                                                     BF16_FLOPS)
        out[f"{key}_share_of_bound"] = out[f"{key}_bound_ms"] / ms
    emit(out)
    return {"max_abs_err": worst, "ms": out["26x26x512_B128_ms"],
            "plain_ms": out["26x26x512_B128_plain_ms"],
            "bound_ms": out["26x26x512_B128_bound_ms"],
            "bound_by": out["26x26x512_B128_bound_by"], "library_ms": None}


def phase_k3(dev, gen):
    from yolo_for_turbines_tpu_torch.ops.kernels import iou_kernel as ik
    from yolo_for_turbines_tpu_torch.ops.kernels.nms_kernel import _top_left

    out = {"phase": "k3", "kernel": "pairwise_iou", "checks": []}
    worst = 0.0
    for k in (1, 255, 256, 1000, 1001, 4096):
        boxes = torch.cat([torch.rand(k, 2, generator=gen) * 0.8 + 0.1,
                           torch.rand(k, 2, generator=gen) * 0.38 + 0.02], dim=1).to(dev)
        for fmt in ("center", "top_left"):
            got = ik.pairwise_iou(boxes, fmt)
            torch.cuda.synchronize()
            want = ik.pairwise_iou_reference(_top_left(boxes, fmt))
            err = (got - want).abs().max().item()
            out["checks"].append({"K": k, "format": fmt, "vector_stores": ik.vector_stores(k),
                                  "mismatches": int((got != want).sum()), "max_abs_err": err})
            worst = max(worst, err)
            if out["checks"][-1]["mismatches"]:
                emit(out)
                raise AssertionError(f"K3 differs from plain: {out['checks'][-1]}")
        if k in (256, 4096):
            ms, plain_ms = ab_ms(
                lambda: ik.pairwise_iou(boxes, "center"),
                lambda: ik.pairwise_iou_reference(_top_left(boxes, "center")),
                iters=50, plain_iters=10,
            )
            out[f"K{k}_ms"], out[f"K{k}_plain_ms"] = ms, plain_ms
            out[f"K{k}_top_left_ms"] = cuda_ms(lambda: ik.pairwise_iou(boxes, "top_left"), 50)
        if k == 4096:
            # a NaN and an infinite box take the kernel's exact min / max path
            odd = boxes.clone()
            odd[5, 2] = float("nan")
            odd[77, 0] = float("inf")
            got = ik.pairwise_iou(odd, "center")
            want = ik.pairwise_iou_reference(_top_left(odd, "center"))
            same = (got == want) | (got.isnan() & want.isnan())
            out["K4096_nonfinite_mismatches"] = int((~same).sum())
            require(bool(same.all()), "K3 differs from plain on non-finite boxes")
    # K = 4096: the boxes read once, the K x K f32 matrix written once, about
    # 15 f32 operations per pair
    out["K4096_bound_ms"], out["K4096_bound_by"] = bound_of(
        4096 * 4 * 4 + 4096 * 4096 * 4, 15.0 * 4096 * 4096, F32_FLOPS)
    out["K4096_share_of_bound"] = out["K4096_bound_ms"] / out["K4096_ms"]
    emit(out)
    return {"max_abs_err": worst, "ms": out["K4096_ms"], "plain_ms": out["K4096_plain_ms"],
            "bound_ms": out["K4096_bound_ms"], "bound_by": out["K4096_bound_by"],
            "library_ms": None}


def int8_stage_inputs(rng, batch, hw, c, n, dev):
    """Random s8 activations, weights quantized with ``_wq`` and seeded
    scales, as tests/test_resblock_int8_kernel.py builds them; hw is H = W or
    (H, W)."""
    from yolo_for_turbines_tpu_torch.models.quantize import _wq

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    blocks = []
    for _ in range(n):
        w1q, s1 = _wq(rng.normal(0, 0.5, (1, 1, c, c // 2)))
        w2q, s2 = _wq(rng.normal(0, 0.2, (3, 3, c // 2, c)))
        blocks.append({"w1q": w1q.to(dev), "s1": s1.to(dev), "b1": f32(rng.normal(0, 0.1, c // 2)),
                       "w2q": w2q.to(dev), "s2": s2.to(dev), "b2": f32(rng.normal(0, 0.1, c))})
    h, w = (hw, hw) if isinstance(hw, int) else hw
    xq = torch.from_numpy(rng.integers(-127, 128, (batch, h, w, c), dtype=np.int8)).to(dev)
    s1 = [f32(v) for v in rng.uniform(0.01, 0.05, n)]
    s2 = [f32(v) for v in rng.uniform(0.01, 0.05, n)]
    return xq, blocks, f32(0.021), s1, s2


def phase_k4(dev, rng):
    from yolo_for_turbines_tpu_torch.models import quantize as tq
    from yolo_for_turbines_tpu_torch.ops.kernels import resblock_int8_kernel as rk

    out = {"phase": "k4", "kernel": "fused_residual_stage_int8",
           "mish_max_codes": K4_MISH_MAX_CODES, "mish_max_frac": K4_MISH_MAX_FRAC,
           "checks": []}
    out["sass"] = sass_counts("resblock_int8_wgmma_kernel", ("IGMMA", "UTMALDG"))
    if not all(out["sass"].values()):
        emit(out)
        raise AssertionError(f"K4 is not built on integer wgmma and TMA: {out['sass']}")
    worst = 0
    for activation in ("leaky_relu", "mish"):
        for h, w, n in K4_GEOMETRIES:
            batch = 8 if (h, w) == (26, 26) else 2
            xq, blocks, s_x, s1, s2 = int8_stage_inputs(rng, batch, (h, w), 512, n, dev)
            ops = rk.pack_int8_stage(blocks, s_x, s1, s2)
            got = rk.fused_residual_stage_int8(xq, *ops, activation=activation)
            torch.cuda.synchronize()
            want = rk.fused_residual_stage_int8_reference(xq, *ops, activation=activation)
            diff = (got.int() - want.int()).abs()
            codes, frac = int(diff.max()), float((diff != 0).float().mean())
            out["checks"].append({"act": activation, "h": h, "w": w, "c": 512, "n": n,
                                  "B": batch, "max_codes": codes, "frac_differing": frac})
            worst = max(worst, codes)
            ok = codes == 0 if activation == "leaky_relu" else (
                codes <= K4_MISH_MAX_CODES and frac < K4_MISH_MAX_FRAC)
            if not ok:
                emit(out)
                raise AssertionError(f"K4 differs from plain: {out['checks'][-1]}")
    # the wrapper takes nothing else: no fallback for the other stages
    for hw, c, _ in GEOMETRIES:
        if c != 512:
            xq, blocks, s_x, s1, s2 = int8_stage_inputs(rng, 1, hw, c, 1, dev)
            try:
                rk.fused_residual_stage_int8(xq, *rk.pack_int8_stage(blocks, s_x, s1, s2))
            except ValueError:
                continue
            raise AssertionError(f"K4 took the geometry {hw}x{hw}x{c}")
    for batch in (8, 128):
        xq, blocks, s_x, s1, s2 = int8_stage_inputs(rng, batch, 26, 512, 8, dev)
        ops = rk.pack_int8_stage(blocks, s_x, s1, s2)
        layers = tq.pack_int8_blocks(blocks, s_x, s1, s2, use_residual=True)
        # the K-major weight copies, made once as pack_int8 makes them
        kmajor = rk.kmajor_weights(ops[0], ops[4])
        # the timed shape is held against the plain version too (leaky)
        got = rk.fused_residual_stage_int8(xq, *ops, kmajor=kmajor)
        mismatches = int((got != rk.fused_residual_stage_int8_reference(xq, *ops)).sum())
        out[f"26x26x512_B{batch}_leaky_mismatches"] = mismatches
        if mismatches:
            emit(out)
            raise AssertionError(f"K4 differs from plain at the timed shape, B={batch}")
        ms, plain_ms = ab_ms(
            lambda: rk.fused_residual_stage_int8(xq, *ops, kmajor=kmajor),
            lambda: rk.fused_residual_stage_int8_reference(xq, *ops),
            iters=10, plain_iters=3,
        )
        out[f"26x26x512_B{batch}_ms"] = ms
        out[f"26x26x512_B{batch}_plain_ms"] = plain_ms
        out[f"26x26x512_B{batch}_bound_ms"], out[f"26x26x512_B{batch}_bound_by"] = stage_bound(
            xq, ops[0], ops[4], INT8_OPS)
        out[f"26x26x512_B{batch}_share_of_bound"] = out[f"26x26x512_B{batch}_bound_ms"] / ms
        out[f"26x26x512_B{batch}_int8_layers_ms"] = cuda_ms(
            lambda: tq.residual_blocks_int8(xq, layers), 10)
        # the layer path divides by the scales where the kernel multiplies
        # by their reciprocals: codes may differ at ties (not gated)
        diff = got != tq.residual_blocks_int8(xq, layers)
        out[f"26x26x512_B{batch}_layers_vs_kernel_frac_differing"] = float(diff.float().mean())
        if batch == 8:  # the same for the first block alone
            one = rk.fused_residual_stage_int8(xq, *(t[:1] for t in ops))
            diff = (one.int() - tq.residual_blocks_int8(xq, layers[:1]).int()).abs()
            out["26x26x512_B8_one_block_layers_vs_kernel"] = {
                "frac_differing": float((diff != 0).float().mean()), "max_codes": int(diff.max())}
    emit(out)
    return {"max_abs_err": float(worst), "ms": out["26x26x512_B128_ms"],
            "plain_ms": out["26x26x512_B128_plain_ms"],
            "bound_ms": out["26x26x512_B128_bound_ms"],
            "bound_by": out["26x26x512_B128_bound_by"], "library_ms": None}


def k5_inputs(b, h, w, c, gen, dev, with_skip):
    def nhwc(scale):
        t = torch.randn((b, h, w, c), generator=gen, device=dev) * scale
        return t.to(torch.bfloat16).permute(0, 3, 1, 2)  # NCHW, stored channels_last

    bias = (torch.randn(c, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    return nhwc(1.0), bias, nhwc(1.0) if with_skip else None


def k5_check(y, bias, activation, skip, what, out):
    from yolo_for_turbines_tpu_torch.ops.kernels import epilogue_kernel as ek

    got = ek.conv_epilogue(y.clone(memory_format=torch.channels_last), bias, activation, skip)
    torch.cuda.synchronize()
    want = ek.conv_epilogue_reference(y, bias, activation, skip)
    # the bit patterns of finite bf16 values of one sign are consecutive
    # integers: their difference counts bf16 steps
    a, b = got.view(torch.int16).int(), want.view(torch.int16).int()
    differing, steps = int((a != b).sum()), int((a - b).abs().max())
    out["checks"].append({"case": what, "activation": activation, "skip": skip is not None,
                          "differing": differing, "max_bf16_steps": steps})
    exact = activation != "mish"
    if differing if exact else (steps > 1 or differing > K5_MISH_MAX_FRAC * got.numel()):
        emit(out)
        raise AssertionError(f"K5 differs from plain: {out['checks'][-1]}")


def k5_slice(ek, gen, dev, hw, c, offset, pitch, activation, keep, out):
    """K5 at B = 64 with its result stored into channels [offset, offset +
    C) of a (B, pitch, H, W) channels_last buffer (and into y with
    ``keep``): equal bit for bit to the in-place launch, within phase k5's
    gate of the plain version, the buffer's other channels untouched
    (a sentinel planted there); CUDA-event times of the three ways, each
    launch on a tensor outside L2."""
    y, bias, _ = k5_inputs(64, hw, hw, c, gen, dev, False)
    what = f"64x{hw}x{hw}x{c} into [{offset}, {offset + c}) of {pitch}" + (", keep" if keep
                                                                           else "")
    k5_check(y, bias, activation, None, what, out)
    want = ek.conv_epilogue(y.clone(memory_format=torch.channels_last), bias, activation)
    buf = torch.full((64, pitch, hw, hw), -3.0, dtype=torch.bfloat16, device=dev)
    buf = buf.contiguous(memory_format=torch.channels_last)
    dest = buf[:, offset:offset + c]
    got_y = y.clone(memory_format=torch.channels_last)
    ek.conv_epilogue(got_y, bias, activation, out=dest, keep=keep)
    torch.cuda.synchronize()
    rest = torch.cat([buf[:, :offset], buf[:, offset + c:]], dim=1)
    ok = (torch.equal(dest.view(torch.int16), want.view(torch.int16))
          and bool((rest == -3.0).all())
          and torch.equal(got_y.view(torch.int16), (want if keep else y).view(torch.int16)))
    row = {"case": what, "activation": activation, "equal_to_in_place": ok}
    if not ok:
        emit({**out, "slices": [row]})
        raise AssertionError(f"K5's slice output differs from its in-place result: {what}")
    del rest, want
    nbytes = y.numel() * 2 * (3 if keep else 2)
    copies = [y.clone(memory_format=torch.channels_last)
              for _ in range(max(1, -(-int(150e6) // (y.numel() * 2))))]
    turn = iter(range(1 << 30))

    def in_place():
        ek.conv_epilogue(copies[next(turn) % len(copies)], bias, activation)

    def sliced():
        ek.conv_epilogue(copies[next(turn) % len(copies)], bias, activation, out=dest, keep=keep)

    iters = max(10, min(100, int(2e9 // nbytes)))
    row["ms"], row["in_place_ms"] = ab_ms(sliced, in_place, iters, iters)
    row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    del y, buf, dest, got_y, copies
    torch.cuda.empty_cache()
    return row


def phase_k5(dev):
    """K5 against its plain version at every width the models give it (the
    three activations, identity, with and without a skip; a misaligned view
    takes the one-element variant), then its time at B = 128 shapes
    beside its byte bound, the plain version and the composition of aten
    ops it replaced (the conv's bias add, the activation, ``skip + y``)."""
    from yolo_for_turbines_tpu_torch.ops.kernels import epilogue_kernel as ek

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    out = {"phase": "k5", "kernel": "conv_epilogue", "checks": []}
    ek.launches = 0
    for h, w, c in K5_CHECKED:
        for activation in ("leaky_relu", "mish", "identity", "silu"):
            for with_skip in (False, True):
                y, bias, skip = k5_inputs(2, h, w, c, gen, dev, with_skip)
                k5_check(y, bias, activation, skip, f"2x{h}x{w}x{c}", out)
    # 16-byte vectors need y and skip 16-byte aligned: views one element
    # into their storage take the one-element variant
    n = 2 * 13 * 13 * 64
    for which in ("y", "skip"):
        y, bias, skip = k5_inputs(2, 13, 13, 64, gen, dev, True)
        base = torch.empty(n + 8, dtype=torch.bfloat16, device=dev)
        view = base[1:n + 1].view(2, 13, 13, 64).permute(0, 3, 1, 2)
        view.copy_(y if which == "y" else skip)
        args = (view, bias, skip) if which == "y" else (y, bias, view)
        k5_check(args[0], args[1], "leaky_relu", args[2], f"{which} misaligned", out)
    out["check_launches"] = ek.launches

    def composition(y, bias, activation, skip):
        y = y.add_(bias[:, None, None])  # what F.conv2d's cuDNN path does
        if activation == "leaky_relu":
            y = torch.nn.functional.leaky_relu(y, 0.1)
        elif activation == "silu":
            y = torch.nn.functional.silu(y)
        return y if skip is None else skip + y

    rows = []
    for hw, c, activation, with_skip in K5_TIMED:
        y, bias, skip = k5_inputs(128, hw, hw, c, gen, dev, with_skip)
        k5_check(y, bias, activation, skip, f"128x{hw}x{hw}x{c}", out)
        nbytes = y.numel() * 2 * (3 if with_skip else 2) + c * 2
        # copies enough to outrun the 50 MB L2: each launch finds its
        # tensor cold, as after a conv that wrote more than L2 holds
        copies = [y.clone(memory_format=torch.channels_last)
                  for _ in range(max(1, -(-int(150e6) // nbytes)))]
        turn = iter(range(1 << 30))

        def kernel():
            ek.conv_epilogue(copies[next(turn) % len(copies)], bias, activation, skip)

        def comp():
            composition(copies[next(turn) % len(copies)], bias, activation, skip)

        iters = max(10, min(200, int(2e9 // nbytes)))
        ms, plain_ms = ab_ms(kernel, lambda: ek.conv_epilogue_reference(y, bias, activation, skip),
                             iters=iters, plain_iters=max(3, iters // 10))
        bound_ms, bound_by = bound_of(nbytes, 0.0, BF16_FLOPS)
        name = f"{hw}x{hw}x{c}" + ("_skip" if with_skip else "")
        row = {"shape": name, "B": 128, "activation": activation, "ms": ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
               "gb_per_s": nbytes / ms / 1e6, "plain_ms": plain_ms,
               "composition_ms": cuda_ms(comp, iters), "copies": len(copies)}
        out[name] = row
        rows.append(row)
        del y, skip, copies
        torch.cuda.empty_cache()
    out["slices"] = [k5_slice(ek, gen, dev, *geometry, out) for geometry in K5_SLICES]
    emit(out)
    worst = min(rows, key=lambda r: r["share_of_bound"])
    return {"ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
            "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
            "library_ms": None, "timed": rows, "least_share_of_bound": worst["share_of_bound"]}


def k6_inputs(b, h, w, c, gen, dev, residual, branch):
    """An int8 conv's i32 output and epilogue operands in the ranges the
    int8 path gives them (y32 * d up to about 13, so codes reach the clamp)."""
    shape = (b, h, w, c)

    def i32():
        return torch.randint(-(1 << 17), 1 << 17, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    d = torch.rand(c, generator=gen, device=dev) * 1e-4
    bias = torch.randn(c, generator=gen, device=dev)
    s_out = torch.tensor(0.05, device=dev)
    res = (torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8),
           torch.tensor(0.03, device=dev)) if residual else None
    extra = (i32(), torch.rand(c, generator=gen, device=dev) * 1e-4) if branch else None
    return i32(), d, bias, s_out, res, extra


def k6_check(ops, activation, what, out, q=None):
    from yolo_for_turbines_tpu_torch.ops.kernels import int8_epilogue_kernel as ik

    y32, d, bias, s_out, res, extra = ops
    got = ik.int8_epilogue(y32, d, bias, s_out, activation, res, extra, out=q)
    torch.cuda.synchronize()
    want = ik.int8_epilogue_reference(y32, d, bias, s_out, activation, res, extra)
    diff = (got.int() - want.int()).abs()
    out["checks"].append({"case": what, "activation": activation, "residual": res is not None,
                          "branch": extra is not None, "differing": int((diff != 0).sum()),
                          "max_codes": int(diff.max())})
    if out["checks"][-1]["differing"]:
        emit(out)
        raise AssertionError(f"K6 differs from the composition: {out['checks'][-1]}")


def misaligned(t):
    """``t``'s values in a view one element into a larger buffer."""
    base = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    return base[1:t.numel() + 1].view(t.shape).copy_(t)


def phase_k6(dev):
    """K6 against the aten composition it replaced, which runs the same f32
    operations in the same order, at every width the models give it (both
    activations, with and without a residual and a second branch; a
    misaligned view takes the one-element variant), then its time at
    Darknet-53's B = 128 shapes beside its byte bound and the composition."""
    from yolo_for_turbines_tpu_torch.ops.kernels import int8_epilogue_kernel as ik

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    out = {"phase": "k6", "kernel": "int8_epilogue", "checks": []}
    ik.launches = 0
    for h, w, c in K6_CHECKED:
        for activation in ("leaky_relu", "mish"):
            for residual in (False, True):
                for branch in (False, True):
                    ops = k6_inputs(2, h, w, c, gen, dev, residual, branch)
                    k6_check(ops, activation, f"2x{h}x{w}x{c}", out)
    # 16-byte vectors need every operand 16-byte aligned: views one element
    # into their storage take the one-element variant
    for which in ("y32", "residual", "branch", "out"):
        y32, d, bias, s_out, (rq, rs), (yb, db) = k6_inputs(2, 13, 13, 64, gen, dev, True, True)
        y32 = misaligned(y32) if which == "y32" else y32
        rq = misaligned(rq) if which == "residual" else rq
        yb = misaligned(yb) if which == "branch" else yb
        q = torch.zeros(y32.shape, dtype=torch.int8, device=dev)
        q = misaligned(q) if which == "out" else q
        k6_check((y32, d, bias, s_out, (rq, rs), (yb, db)), "leaky_relu", f"{which} misaligned",
                 out, q)
    out["check_launches"] = ik.launches

    rows = []
    for hw, c, residual in K6_TIMED:
        ops = k6_inputs(128, hw, hw, c, gen, dev, residual, False)
        k6_check(ops, "leaky_relu", f"128x{hw}x{hw}x{c}", out)
        y32, d, bias, s_out, res, _ = ops
        nbytes = y32.numel() * (4 + 1 + (1 if residual else 0)) + 2 * c * 4
        # copies enough to outrun the 50 MB L2: each launch finds its input
        # cold, as after the int_mm that wrote it
        copies = [y32.clone() for _ in range(max(1, -(-int(150e6) // (y32.numel() * 4))))]
        q = torch.empty(y32.shape, dtype=torch.int8, device=dev)
        turn = iter(range(1 << 30))

        def kernel():
            ik.int8_epilogue(copies[next(turn) % len(copies)], d, bias, s_out, "leaky_relu",
                             res, out=q)

        def comp():
            ik.int8_epilogue_reference(copies[next(turn) % len(copies)], d, bias, s_out,
                                       "leaky_relu", res)

        iters = max(10, min(200, int(2e9 // nbytes)))
        ms, comp_ms = ab_ms(kernel, comp, iters=iters, plain_iters=max(3, iters // 10))
        bound_ms, bound_by = bound_of(nbytes, 0.0, INT8_OPS)
        name = f"{hw}x{hw}x{c}" + ("_residual" if residual else "")
        row = {"shape": name, "B": 128, "activation": "leaky_relu", "ms": ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
               "gb_per_s": nbytes / ms / 1e6, "composition_ms": comp_ms,
               "copies": len(copies)}
        out[name] = row
        rows.append(row)
        del ops, y32, res, copies, q
        torch.cuda.empty_cache()
    emit(out)
    worst = min(rows, key=lambda r: r["share_of_bound"])
    return {"ms": rows[0]["ms"], "plain_ms": rows[0]["composition_ms"],
            "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
            "library_ms": None, "timed": rows, "least_share_of_bound": worst["share_of_bound"]}


def phase_k7(dev):
    """K7 against the plain version it replaced (the im2col copy and
    ``int_mm``) at every Darknet-53 product geometry at B = 128, through the
    router ``models/quantize.py::_conv_i8`` takes: i32 sums equal bit for bit,
    then each geometry's time beside its bound (the larger of its
    operations at the s8 peak and its bytes: s8 input, weights, i32 output)
    and the plain version's, in turns; the sums per forward; IGMMA and
    UTMALDG instructions of the built kernel counted in cuobjdump's SASS.
    Then at B = 1, where the launches are short, each geometry's host time
    per ``_conv_i8`` call beside its device time, K7's route and the plain
    version's."""
    from yolo_for_turbines_tpu_torch.models import quantize as tq
    from yolo_for_turbines_tpu_torch.ops.kernels import int8_conv_kernel as ck

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    out = {"phase": "k7", "kernel": "int8_conv", "timed": []}
    out["sass"] = sass_counts("conv_int8_wgmma_kernel", ("IGMMA", "UTMALDG"))
    require(all(out["sass"].values()), f"K7's SASS lacks IGMMA or UTMALDG: {out['sass']}")
    ck.launches = 0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for side, cin, cout, kernel, stride, per_forward in K7_GEOMETRIES:
        xq = torch.randint(-127, 128, (128, side, side, cin), generator=gen, device=dev,
                           dtype=torch.int8)
        wmat = tq._wmat(torch.randint(-127, 128, (kernel, kernel, cin, cout), generator=gen,
                                      device=dev, dtype=torch.int8))
        wk = ck.kmajor(wmat, cin, kernel)
        pad = kernel // 2
        before = ck.launches
        got = tq._conv_i8(xq, wmat, kernel, stride, pad, wk=wk)
        want = ck.int8_conv_reference(xq, wmat, kernel, stride, pad)
        torch.cuda.synchronize()
        name = f"{side}x{side}x{cin}->{cout} k{kernel}s{stride}"
        differing = int((got != want).sum())
        if differing or ck.launches != before + 1:
            emit(out)
            raise AssertionError(f"K7 at {name}: {differing} sums differ, "
                                 f"{ck.launches - before} launches")
        ho = got.shape[1]
        ops = 2.0 * 128 * ho * ho * kernel * kernel * cin * cout
        nbytes = xq.numel() + wmat.numel() + got.numel() * 4
        ms, plain_ms = ab_ms(lambda: tq._conv_i8(xq, wmat, kernel, stride, pad, wk=wk),
                             lambda: ck.int8_conv_reference(xq, wmat, kernel, stride, pad),
                             iters=20, plain_iters=5)
        bound_ms, bound_by = bound_of(nbytes, ops, INT8_OPS)
        row = {"geometry": name, "B": 128, "per_forward": per_forward, "ms": ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
               "plain_ms": plain_ms}
        out["timed"].append(row)
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
            totals[key] += per_forward * v
        del xq, wmat, wk, got, want
        torch.cuda.empty_cache()
    out["per_forward"] = totals
    out["B1"], host = [], {"host_us": 0.0, "wall_us": 0.0, "device_us": 0.0,
                           "plain_host_us": 0.0, "plain_device_us": 0.0}
    for side, cin, cout, kernel, stride, per_forward in K7_GEOMETRIES:
        xq = torch.randint(-127, 128, (1, side, side, cin), generator=gen, device=dev,
                           dtype=torch.int8)
        wmat = tq._wmat(torch.randint(-127, 128, (kernel, kernel, cin, cout), generator=gen,
                                      device=dev, dtype=torch.int8))
        wk = ck.kmajor(wmat, cin, kernel)
        pad = kernel // 2

        def k7():
            return tq._conv_i8(xq, wmat, kernel, stride, pad, wk=wk)

        def plain():
            return tq._conv_i8(xq, wmat, kernel, stride, pad, portable=True)

        row = {"geometry": f"{side}x{side}x{cin}->{cout} k{kernel}s{stride}", "B": 1}
        row["host_us"], row["wall_us"] = host_us(k7)
        row["device_us"] = cuda_ms(k7, 50) * 1e3
        try:
            row["plain_host_us"], _ = host_us(plain)
            row["plain_device_us"] = cuda_ms(plain, 50) * 1e3
        except RuntimeError as e:  # cuBLAS's int8 product refuses some small products
            row["plain_host_us"] = row["plain_device_us"] = None
            row["plain_error"] = str(e).splitlines()[0][:120]
        out["B1"].append(row)
        for key in host:
            if row[key] is not None:
                host[key] += per_forward * row[key]
    out["B1_per_forward"] = host
    emit(out)
    worst = min(out["timed"], key=lambda r: r["share_of_bound"])
    return {"ms": totals["ms"], "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
            "bound_by": "bytes and operations, per geometry", "library_ms": None,
            "timed": out["timed"], "least_share_of_bound": worst["share_of_bound"]}


def same_values(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal as values: NaN in the same places, every other element equal."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return (a.shape == b.shape and torch.equal(na, nb)
            and bool((a.masked_fill(na, 0) == b.masked_fill(nb, 0)).all()))


def res_usage(fragment: str) -> dict:
    """Registers, stack and local bytes of each kernel of the built library
    whose name contains ``fragment`` (cuobjdump -res-usage)."""
    from yolo_for_turbines_tpu_torch.ops import kernels

    cuobjdump = str(Path(kernels._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-res-usage", str(kernels.LIBRARY)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    found, name = {}, ""
    for line in text.splitlines():
        if "Function" in line:
            name = line.split("Function", 1)[1].strip(" :")
        elif "REG:" in line and fragment in name:
            fields = dict(f.split(":", 1) for f in line.split() if ":" in f)
            found[name] = {k: fields.get(k) for k in ("REG", "STACK", "SHARED", "LOCAL")}
    return found


def k8_planted(x: torch.Tensor, gen) -> torch.Tensor:
    """NaN at a few cells, -inf over one whole channel and a 3x3 patch."""
    x = x.clone()
    b, c, h, w = x.shape
    for _ in range(4):
        i = [int(torch.randint(n, (1,), generator=gen)) for n in (b, c, h, w)]
        x[i[0], i[1], i[2], i[3]] = float("nan")
    x[:, c - 1] = float("-inf")
    x[:, 0, :3, :3] = float("-inf")
    return x


def k8_model(family: str, dev):
    """YOLOv4 at 608px or YOLOv7 at 640px (80 classes, seeded folded
    weights) as a bf16 predictor, and its input size."""
    from yolo_for_turbines_tpu_torch import config as cfg
    from yolo_for_turbines_tpu_torch.config import ModelConfig
    from yolo_for_turbines_tpu_torch.inference import Predictor
    from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy
    from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan, init_plan

    activation, size, anchors = {"yolov4": ("mish", 608, cfg.YOLOV4_ANCHORS),
                                 "yolov7": ("silu", 640, cfg.YOLOV7_ANCHORS)}[family]
    model_cfg = ModelConfig(backbone=family, activation=activation,
                            strides=cfg.strides_for(family))
    plan = build_plan(model_cfg)
    tree = init_plan(plan, torch.Generator().manual_seed(SEED + 8))
    return Predictor(folded_from_numpy(plan, tree, model_cfg), device=dev, anchors=anchors,
                     image_size=size), size


def concat_check(pred, x, out) -> None:
    """``pred``'s heads and ``predict_batch`` boxes with the concats written
    in place against the same predictor's with ``torch.cat``
    (``blocks.concat_wins`` patched to refuse; the forward is otherwise the
    same launches): bit for bit; and K5's share of one forward's concat
    bytes (``profiling.concat_in_place_bytes`` against the copies'
    ``concat_bytes``), gated at CONCAT_IN_PLACE_SHARE."""
    from yolo_for_turbines_tpu_torch.models import blocks
    from yolo_for_turbines_tpu_torch.utils import profiling

    with torch.inference_mode():
        copied, stored = profiling.concat_bytes, profiling.concat_in_place_bytes
        heads = pred.model(x)
        copied = profiling.concat_bytes - copied
        stored = profiling.concat_in_place_bytes - stored
        kept, mask = pred.predict_batch(x)
        wins = blocks.concat_wins
        blocks.concat_wins = lambda t, act, folded: False
        try:
            before = profiling.concat_in_place_bytes
            cat_heads = pred.model(x)
            cat_kept, cat_mask = pred.predict_batch(x)
            require(profiling.concat_in_place_bytes == before,
                    "K5 stored into a concat with concat_wins patched")
        finally:
            blocks.concat_wins = wins
    torch.cuda.synchronize()
    equal = (all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                 for a, b in zip(heads, cat_heads))
             and torch.equal(kept, cat_kept) and torch.equal(mask, cat_mask))
    share = stored / (stored + copied)
    out["concat"] = {"heads_and_boxes_equal_to_torch_cat": equal, "in_place_share": share,
                     "copied_mb": copied / 1e6, "stored_in_place_mb": stored / 1e6,
                     "B": int(x.shape[0])}
    emit(out)
    require(equal, "heads or boxes differ between the in-place concats and torch.cat")
    require(share >= CONCAT_IN_PLACE_SHARE,
            f"K5 stores {share:.3f} of the concat bytes, below {CONCAT_IN_PLACE_SHARE}")


def phase_k8(dev):
    """K8 against the aten composition it replaced, by value, at the
    geometries the YOLOv4 and YOLOv7 cells run (B = 2 with NaN and -inf
    planted, and B = 64); its times at B = 64 beside the byte bound and
    aten's; its registers and spills; its launches per predict_batch; a
    YOLOv7 forward on aten's pools against K8's, heads equal."""
    from yolo_for_turbines_tpu_torch.models import blocks
    from yolo_for_turbines_tpu_torch.ops.kernels import epilogue_kernel as ek
    from yolo_for_turbines_tpu_torch.ops.kernels import maxpool_kernel as mk

    gen = torch.Generator().manual_seed(SEED + 8)
    out = {"phase": "k8", "kernel": "maxpool", "checks": [], "timed": []}
    out["res_usage"] = res_usage("maxpool")

    def nhwc(b, c, side):
        x = torch.randn((b, c, side, side), generator=gen).to(torch.bfloat16)
        return x.to(dev).contiguous(memory_format=torch.channels_last)

    cases = [(f"pyramid {side}x{side}x{c} {windows}", side, c,
              lambda x, w=windows: mk.maxpool_pyramid(x, w),
              lambda x, w=windows: mk.maxpool_pyramid_reference(x, w),
              len(windows)) for side, c, windows in K8_PYRAMIDS]
    cases += [(f"2x2 {side}x{side}x{c}", side, c, mk.maxpool2x2, mk.maxpool2x2_reference,
               0.25) for side, c in K8_MP]
    mk.launches = 0
    for name, side, c, kernel, aten, _ in cases:
        for b in (2, 64):
            x = nhwc(b, c, side)
            if b == 2:
                x = k8_planted(x, gen)
            ok = same_values(kernel(x), aten(x))
            torch.cuda.synchronize()
            out["checks"].append({"case": name, "B": b, "equal_by_value": ok})
            if not ok:
                emit(out)
                raise AssertionError(f"K8 differs from aten at {name}, B = {b}")
    for h, w, c, windows in K8_BANDED:
        x = k8_planted(torch.randn((2, c, h, w), generator=gen).to(torch.bfloat16).to(dev)
                       .contiguous(memory_format=torch.channels_last), gen)
        ok = same_values(mk.maxpool_pyramid(x, windows), mk.maxpool_pyramid_reference(x, windows))
        out["checks"].append({"case": f"pyramid {h}x{w}x{c} {windows} in bands", "B": 2,
                              "equal_by_value": ok})
        require(ok, f"K8 differs from aten at {h}x{w}x{c} in bands")
    for side, c in K8_STRIDE1:
        x = k8_planted(nhwc(2, c, side), gen)
        ok = same_values(mk.maxpool2x2(x, 1), mk.maxpool2x2_reference(x, 1))
        out["checks"].append({"case": f"2x2 stride 1 {side}x{side}x{c}", "B": 2,
                              "equal_by_value": ok})
        require(ok, f"K8 differs from aten at stride 1, {side}x{side}x{c}")
    x = k8_planted(nhwc(2, 64, 20), gen)
    base = torch.empty(x.numel() + 8, dtype=torch.bfloat16, device=dev)
    off = base[4 : 4 + x.numel()].view(2, 20, 20, 64).permute(0, 3, 1, 2)
    off.copy_(x)
    refused = {"nchw": x.contiguous(), "12 channels": k8_planted(nhwc(2, 12, 20), gen),
               "off 16 bytes": off, "channel slice": x[:, 8:48]}
    for name, t in refused.items():
        before = mk.launches
        got = blocks.maxpool_pyramid(t, (13, 9, 5, 1))
        down = blocks.maxpool2d(t, 2, 2)
        nchw = t.is_contiguous() and not t.is_contiguous(memory_format=torch.channels_last)
        ok = (mk.launches == before + 2
              and same_values(got, mk.maxpool_pyramid_reference(t, (13, 9, 5, 1)))
              and same_values(down, mk.maxpool2x2_reference(t))
              and all(y.is_contiguous() if nchw
                      else y.is_contiguous(memory_format=torch.channels_last)
                      for y in (got, down)))
        out["checks"].append({"case": f"router, {name}", "B": 2, "equal_by_value": ok})
        require(ok, f"the router's K8 route differs from aten for {name}")
    out["check_launches"] = mk.launches
    for name, side, c, kernel, aten, written in cases:
        x = nhwc(64, c, side)
        nbytes = x.numel() * 2 * (1 + written)
        # inputs enough to outrun the 50 MB L2: each launch reads its plane
        # cold, as after the conv that wrote it and the ones between
        copies = [x.clone(memory_format=torch.channels_last)
                  for _ in range(max(1, -(-int(150e6) // (x.numel() * 2))))]
        turn = iter(range(1 << 30))
        ms, aten_ms = ab_ms(lambda: kernel(copies[next(turn) % len(copies)]),
                            lambda: aten(copies[next(turn) % len(copies)]),
                            iters=50, plain_iters=10)
        bound_ms, bound_by = bound_of(nbytes, 0.0, BF16_FLOPS)
        out["timed"].append({"shape": name, "B": 64, "ms": ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                             "gb_per_s": nbytes / ms / 1e6, "library_ms": aten_ms,
                             "copies": len(copies)})
        del x, copies
        torch.cuda.empty_cache()
    per_call, heads_equal = {}, None
    for family in ("yolov4", "yolov7"):
        pred, size = k8_model(family, dev)
        x = torch.from_numpy(np.random.default_rng(SEED + 8).uniform(
            size=(8, size, size, 3)).astype(np.float32)).to(dev)
        mk.launches = ek.launches = 0
        kept, _ = pred.predict_batch(x)
        torch.cuda.synchronize()
        per_call[family] = mk.launches
        require(bool(torch.isfinite(kept).all()), f"{family} boxes not finite")
        if family == "yolov4":
            out["yolov4_conv_epilogue_launches_per_predict_batch"] = ek.launches
            require(ek.launches == K5_PER_CALL_YOLOV4, f"YOLOv4 launches K5 {ek.launches} "
                                                       f"times per predict_batch")
            concat_check(pred, x, {"phase": "k8", "model": "yolov4, 608px, bf16"})
        if family == "yolov7":
            with torch.inference_mode():
                heads = pred.model(x)
                wins = blocks.pool_wins
                blocks.pool_wins = lambda t: False
                try:
                    before = mk.launches
                    aten_heads = pred.model(x)
                    require(mk.launches == before, "K8 launched with pool_wins patched")
                finally:
                    blocks.pool_wins = wins
            torch.cuda.synchronize()
            heads_equal = all(same_values(a, b) for a, b in zip(heads, aten_heads))
        del pred, x
        torch.cuda.empty_cache()
    out["launches_per_predict_batch"] = per_call
    out["yolov7_heads_equal_with_aten_pools"] = heads_equal
    emit(out)
    require(per_call == K8_PER_CALL, f"K8 launches per predict_batch {per_call}, not "
                                     f"{K8_PER_CALL}")
    require(heads_equal, "YOLOv7's heads differ with aten's pools")
    require(len(out["res_usage"]) == 3 and all(
        r["STACK"] == "0" and r["LOCAL"] == "0" for r in out["res_usage"].values()),
        f"K8's kernels spill or are missing: {out['res_usage']}")
    first = out["timed"][0]
    worst = min(out["timed"], key=lambda r: r["share_of_bound"])
    return {"ms": first["ms"], "plain_ms": first["library_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "timed": out["timed"], "least_share_of_bound": worst["share_of_bound"],
            "per_call": per_call}


def phase_rtdetr(dev):
    """RT-DETR-R50's new kernel paths and the model on the card: K5's ReLU
    and add-first order against its plain version, bit for bit, at every
    width K5 is checked at (misaligned views too) and timed at ResNet-50-vd's
    stage outputs at B = 64; K8's 3x3 stride-2 pool against aten by value
    (NaN and -inf planted; odd sides; a width padded to 8) and timed at the
    stem's 320x320x64 at B = 64; then the cell's driver at 640px and B = 8
    (its seeded, calibrated weights, folded by the program): K5, K8, K1
    launches and deformable samples per ``predict_batch``, and the cell's
    four numbers against the reference, each within the cell's limit."""
    import perfbench.drivers.offline_rtdetr as drv
    from perfbench.manifest import Bench
    from yolo_for_turbines_tpu_torch.ops.kernels import epilogue_kernel as ek
    from yolo_for_turbines_tpu_torch.ops.kernels import maxpool_kernel as mk
    from yolo_for_turbines_tpu_torch.ops.kernels import nms_kernel
    from yolo_for_turbines_tpu_torch.utils import profiling

    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    out = {"phase": "rtdetr", "checks": [], "timed": []}

    def k5_first(y, bias, skip, what):
        got = ek.conv_epilogue(y.clone(memory_format=torch.channels_last), bias, "relu", skip,
                               add_first=True)
        want = ek.conv_epilogue_reference(y, bias, "relu", skip, add_first=True)
        ok = torch.equal(got.view(torch.int16), want.view(torch.int16))
        out["checks"].append({"case": f"K5 relu add-first {what}", "bit_for_bit": ok})
        if not ok:
            emit(out)
            raise AssertionError(f"K5's add-first ReLU differs from plain at {what}")

    for h, w, c in K5_CHECKED:
        for with_skip in (False, True):
            y, bias, skip = k5_inputs(2, h, w, c, gen, dev, with_skip)
            k5_first(y, bias, skip, f"2x{h}x{w}x{c} skip {with_skip}")
            got = ek.conv_epilogue(y.clone(memory_format=torch.channels_last), bias, "relu", skip)
            ok = torch.equal(got.view(torch.int16),
                             ek.conv_epilogue_reference(y, bias, "relu", skip).view(torch.int16))
            out["checks"].append({"case": f"K5 relu 2x{h}x{w}x{c} skip {with_skip}",
                                  "bit_for_bit": ok})
            require(ok, f"K5's ReLU differs from plain at 2x{h}x{w}x{c}")
    n = 2 * 13 * 13 * 64
    for which in ("y", "skip"):
        y, bias, skip = k5_inputs(2, 13, 13, 64, gen, dev, True)
        base = torch.empty(n + 8, dtype=torch.bfloat16, device=dev)
        view = base[1:n + 1].view(2, 13, 13, 64).permute(0, 3, 1, 2)
        view.copy_(y if which == "y" else skip)
        k5_first(*((view, bias, skip) if which == "y" else (y, bias, view)), f"{which} misaligned")
    for hw, c in K5_FIRST_TIMED:
        y, bias, skip = k5_inputs(64, hw, hw, c, gen, dev, True)
        nbytes = y.numel() * 2 * 3 + c * 2
        copies = [y.clone(memory_format=torch.channels_last)
                  for _ in range(max(1, -(-int(150e6) // nbytes)))]
        turn = iter(range(1 << 30))
        ms = cuda_ms(lambda: ek.conv_epilogue(copies[next(turn) % len(copies)], bias, "relu",
                                              skip, add_first=True), 50)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out["timed"].append({"kernel": "K5 relu add-first", "shape": f"64x{hw}x{hw}x{c}",
                             "ms": ms, "bound_ms": bound_ms, "share_of_bound": bound_ms / ms})
        del y, skip, copies
    torch.cuda.empty_cache()

    cpu = torch.Generator().manual_seed(SEED + 26)
    mk.launches = 0
    for h, w, c in K8_STEM:
        for b in (2, 64) if (h, w) == (320, 320) else (2,):
            x = torch.randn((b, c, h, w), generator=cpu).to(torch.bfloat16).to(dev)
            x = x.contiguous(memory_format=torch.channels_last)
            if b == 2:
                x = k8_planted(x, cpu)
            ok = same_values(mk.apply_maxpool3x3s2(x), mk.maxpool3x3s2_reference(x))
            out["checks"].append({"case": f"K8 3x3s2 {b}x{h}x{w}x{c}", "equal_by_value": ok})
            if not ok:
                emit(out)
                raise AssertionError(f"K8's 3x3 stride-2 pool differs from aten at {h}x{w}x{c}")
    x = torch.randn((64, 64, 320, 320), device=dev, generator=gen).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    ms = cuda_ms(lambda: mk.maxpool3x3s2(x), 50)
    aten_ms = cuda_ms(lambda: mk.maxpool3x3s2_reference(x), 20)
    bound_ms = x.numel() * 2 * 1.25 / HBM_BYTES_PER_S * 1e3
    out["timed"].append({"kernel": "K8 3x3s2", "shape": "64x320x320x64", "ms": ms,
                         "aten_ms": aten_ms, "bound_ms": bound_ms,
                         "share_of_bound": bound_ms / ms})
    del x
    torch.cuda.empty_cache()

    # K9 against its plain version (bf16 values cast to float32 beside the
    # float32 grid) at the cell's shapes, and against bf16 values sampled at
    # a bf16 grid (grid_sample's one dtype, the other way round); the
    # kernel's time at B = 64 beside the plain version's and its byte bound
    from yolo_for_turbines_tpu_torch.ops.kernels import deform_kernel as dk

    shapes = [(80, 80), (40, 40), (20, 20)]
    for b in (2, 64):
        value = torch.randn((b, 8400, 256), device=dev, generator=gen).to(torch.bfloat16)
        loc = torch.rand((b, 300, 8, 3, 4, 2), device=dev, generator=gen) * 1.2 - 0.1
        weights = torch.softmax(torch.randn((b, 300, 8, 12), device=dev, generator=gen), -1)
        got = dk.deform_attention(value, shapes, loc, weights).float()
        want = dk.deform_attention_reference(value, shapes, loc, weights)
        err = float((got - want).norm() / want.norm())
        worst = float(((got - want).abs() / (want.abs() + 1e-3)).max())
        ok = bool(((got - want).abs() <= 2.0 ** -8 * want.abs() + 1e-5).all())
        out["checks"].append({"case": f"K9 {b}x8400x256, 300 queries", "rel_rms": err,
                              "worst_rel": worst, "within_a_bf16_rounding": ok})
        if not ok:
            emit(out)
            raise AssertionError(f"K9 differs from its plain version at B = {b}: {err}")

    def bf16_grid():
        grids = (2 * loc - 1).to(torch.bfloat16).permute(0, 2, 3, 1, 4, 5).reshape(
            512, 3, 300, 4, 2)
        sampled, at = [], 0
        for lvl, (h, w) in enumerate(shapes):
            v = value[:, at : at + h * w].view(64, h, w, 8, 32).permute(0, 3, 1, 2, 4)
            v = v.reshape(512, h, w, 32).permute(0, 3, 1, 2)
            sampled.append(torch.nn.functional.grid_sample(
                v, grids[:, lvl], mode="bilinear", padding_mode="zeros", align_corners=False))
            at += h * w
        w_ = weights.to(torch.bfloat16).permute(0, 2, 1, 3).reshape(512, 1, 300, 12)
        return (torch.stack(sampled, -2).flatten(-2) * w_).sum(-1)

    bf16_out = bf16_grid().view(64, 256, 300).permute(0, 2, 1).float()
    nbytes = value.numel() * 2 + loc.numel() * 4 + weights.numel() * 4 + 64 * 300 * 256 * 2
    k9_ms = cuda_ms(lambda: dk.deform_attention(value, shapes, loc, weights), 50)
    plain_ms = cuda_ms(lambda: dk.deform_attention_reference(value, shapes, loc, weights), 20)
    out["k9_per_layer_B64"] = {
        "ms": k9_ms, "plain_ms": plain_ms, "bf16_grid_ms": cuda_ms(bf16_grid, 20),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "share_of_bound": nbytes / HBM_BYTES_PER_S * 1e3 / k9_ms,
        "bf16_grid_rel_rms_from_plain": float((bf16_out - want).norm() / want.norm())}
    out["res_usage_k9"] = res_usage("deform")
    del value, loc, weights, got, want, bf16_out
    torch.cuda.empty_cache()

    bench = Bench.load(ROOT / "BENCHMARK.json")
    cell = bench.cell("rtdetr-coco640-offline-bf16")
    mix = {**bench.mix(cell), "batch": 8, "pool": 1, "check_batches": 1, "check_within": 1}
    t0 = time.perf_counter()
    driver = drv.Driver(bench.config(cell), mix, 2**31 + 26, dev)
    out["setup_s"] = time.perf_counter() - t0
    per_call = []
    for i in range(2):
        ek.launches = mk.launches = nms_kernel.launches = dk.launches = 0
        profiling.deform_samples = 0
        driver.step(i)
        torch.cuda.synchronize()
        per_call.append({"conv_epilogue": ek.launches, "maxpool": mk.launches,
                         "greedy_nms": nms_kernel.launches, "deform_attention": dk.launches,
                         "deform_samples": profiling.deform_samples})
    out["launches_per_predict_batch"] = per_call
    kept, mask = driver.outputs[0]
    out["rows"], out["kept_rows_per_image"] = list(kept.shape), float(mask.float().sum(1).mean())
    driver.release()
    out["cell_checks_B8"] = driver.check()
    emit(out)
    want_samples = 8 * 300 * 8 * 3 * 4 * 6
    require(kept.shape == (8, 300, 6) and mask.shape == (8, 300)
            and bool(torch.isfinite(kept).all()), "RT-DETR rows misshapen or not finite")
    require(all(c["conv_epilogue"] == K5_PER_CALL_RTDETR and c["maxpool"] == 1
                and c["greedy_nms"] == 0 and c["deform_attention"] == 6
                and c["deform_samples"] == want_samples for c in per_call),
            f"RT-DETR launches per predict_batch {per_call}: K5 not {K5_PER_CALL_RTDETR}, "
            f"K8 not 1, K9 not 6, K1 launched, or samples not {want_samples}")
    for name, limit in bench.limits(cell).items():
        value = out["cell_checks_B8"][name]
        require(value is not None and value <= limit,
                f"RT-DETR's {name} at B = 8 is {value}, above the cell's limit {limit}")
    return per_call[0]


K10_SIZES = ((640, 480), (1280, 960), (1920, 1080))  # (w, h): the stream cell's frames
K10_GEOMETRIES = K10_SIZES + ((4000, 3000), (731, 1289), (417, 3), (3, 417), (100, 80), (1, 1),
                              (416, 312), (5000, 7), (33, 2000))


def median_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``fn`` over ``reps`` calls, each ended by
    a synchronise (after two untimed calls)."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_k10(dev):
    """K10, the single-image letterbox on the card: bit for bit against the
    plain version (Pillow's integer passes, held to Pillow itself on the
    CPU) at the stream cell's sizes and odd geometries; then per stream
    size the kernel alone, the frame's upload and K10 (a pageable ``.to``,
    the predictor's way, and pinned staging), and the host letterbox it
    replaced (PIL, pad, / 255, the float canvas's upload); and a Darknet-53
    predictor's requests with K10 against the same requests on the host
    letterbox, one K10 launch a request."""
    from yolo_for_turbines_tpu_torch.config import ModelConfig
    from yolo_for_turbines_tpu_torch.data.augment import pad_center, resize_longest
    from yolo_for_turbines_tpu_torch.inference import Predictor
    from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy
    from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan, init_plan
    from yolo_for_turbines_tpu_torch.ops.kernels import letterbox_kernel as lk

    out = {"phase": "k10", "gpu": gpu_line()}
    rng = np.random.default_rng(SEED)
    tables = lk.LetterboxTables(dev)
    for w, h in K10_GEOMETRIES:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = lk.letterbox(torch.from_numpy(img).to(dev), 416, tables)
        want = lk.letterbox_reference(img, 416)
        require(np.array_equal(got[0].cpu().numpy().view(np.uint32), want.view(np.uint32)),
                f"K10 differs from the plain letterbox at {w}x{h}")
    out["bit_for_bit"] = len(K10_GEOMETRIES)
    staging = torch.empty(1920 * 1080 * 3, dtype=torch.uint8, pin_memory=True)

    def upload(img):
        """The other choice: the frame copied into a pinned staging buffer,
        then to the device without waiting (for timing only: the host loop
        of ``host_us`` may overwrite the buffer under a copy)."""
        host = staging[: img.size]
        np.copyto(host.numpy().reshape(img.shape), img)
        return host.to(dev, non_blocking=True).view(img.shape)

    for w, h in K10_SIZES:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        on_dev = torch.from_numpy(img).to(dev)
        p = tables.get(h, w, 416)

        def host():
            x = resize_longest(img, 416)
            x, _, _ = pad_center(x, 416, 416)
            return torch.from_numpy((x.astype(np.float32) / 255.0)[None]).to(dev)

        row = {"kernel_ms": cuda_ms(lambda: lk.letterbox(on_dev, 416, tables), 200),
               "kernel_host_us": host_us(lambda: lk.letterbox(on_dev, 416, tables), 200)[0],
               "band_rows": p.band_rows, "tile_cols": p.tile_cols, "smem": p.smem}
        turns = {"host": [], "pinned": [], "pageable": []}
        for name in ("host", "pinned", "pageable", "pageable", "pinned", "host"):
            fn = {"host": host,
                  "pinned": lambda: lk.letterbox(upload(img), 416, tables),
                  "pageable": lambda: lk.letterbox(torch.from_numpy(img).to(dev), 416,
                                                   tables)}[name]
            turns[name].append(median_ms(fn, 30))
        for name, ms in turns.items():
            row[f"{name}_ms"] = sum(ms) / len(ms)
        # the upload alone, to the copy's end, and the host's time until it
        # returns
        row["pinned_upload_ms"] = median_ms(lambda: upload(img), 30)
        row["pageable_upload_ms"] = median_ms(lambda: torch.from_numpy(img).to(dev), 30)
        row["pinned_upload_host_us"] = host_us(lambda: upload(img), 30)[0]
        row["pageable_upload_host_us"] = host_us(lambda: torch.from_numpy(img).to(dev), 30)[0]
        row["upload_mb"] = img.nbytes / 1e6
        out[f"{w}x{h}"] = row
    # the stream cell's model: 2 classes under mish
    model_cfg = ModelConfig(num_classes=2, activation="mish")
    plan = build_plan(model_cfg)
    tree = init_plan(plan, torch.Generator().manual_seed(SEED))
    pred = Predictor(folded_from_numpy(plan, tree, model_cfg), device=dev, max_boxes=K)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for w, h in K10_SIZES]
    before = lk.launches
    for img in frames:
        pred.predict_image(img)
    require(lk.launches == before + len(frames),
            f"{lk.launches - before} K10 launches for {len(frames)} requests")
    require(pred._tables.builds == len(frames), "a frame size's tables were made twice")
    # each size's request through K10 and through the host letterbox (no
    # tables: the CPU's path), in turns
    ways = {"k10": pred._tables, "pil": None}
    for (w, h), img in zip(K10_SIZES, frames):
        row = out[f"{w}x{h}"]
        times = {name: [] for name in ways}
        for name in ("k10", "pil", "pil", "k10"):
            pred._tables = ways[name]
            times[name].append(median_ms(lambda: pred.predict_image(img), 20))
        for name, ms in times.items():
            row[f"request_{name}_ms"] = sum(ms) / len(ms)
    emit(out)
    return out


def k10_alone() -> None:
    """The env and build lines, then phase k10, on the first card."""
    from yolo_for_turbines_tpu_torch.ops import kernels

    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "gpu": gpu_line()})
    kernels.load_library()
    emit({"phase": "build", "nvcc_seconds": kernels.build_seconds})
    phase_k10(torch.device("cuda", 0))


def rtdetr_alone() -> None:
    """The env and build lines, then phase rtdetr, on the first card, TF32
    off as in ``main``."""
    from yolo_for_turbines_tpu_torch.ops import kernels

    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "gpu": gpu_line()})
    kernels.load_library()
    emit({"phase": "build", "nvcc_seconds": kernels.build_seconds})
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_rtdetr(torch.device("cuda", 0))


def concat_alone() -> None:
    """The env and build lines, then phases k5, k8 and yolov7 (K5's slice
    output and the concats written in place), on the first card."""
    from yolo_for_turbines_tpu_torch.ops import kernels

    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "gpu": gpu_line()})
    kernels.load_library()
    emit({"phase": "build", "nvcc_seconds": kernels.build_seconds})
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase_k5(dev)
    phase_k8(dev)
    phase_yolov7(dev)


def k8_alone() -> None:
    """The env and build lines, then phase k8, on the first card."""
    from yolo_for_turbines_tpu_torch.ops import kernels

    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "gpu": gpu_line()})
    kernels.load_library()
    emit({"phase": "build", "nvcc_seconds": kernels.build_seconds})
    phase_k8(torch.device("cuda", 0))


def k7_alone() -> None:
    """The env and build lines, then phase k7, on the first card."""
    from yolo_for_turbines_tpu_torch.ops import kernels

    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "gpu": gpu_line()})
    kernels.load_library()
    emit({"phase": "build", "nvcc_seconds": kernels.build_seconds})
    phase_k7(torch.device("cuda", 0))


def k6_alone() -> None:
    """The env and build lines, then phase k6, on the first card."""
    from yolo_for_turbines_tpu_torch.ops import kernels

    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "gpu": gpu_line()})
    kernels.load_library()
    emit({"phase": "build", "nvcc_seconds": kernels.build_seconds})
    phase_k6(torch.device("cuda", 0))


def full_model():
    from yolo_for_turbines_tpu_torch.config import ModelConfig
    from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan, init_plan

    model_cfg = ModelConfig()  # 80 classes, Darknet-53, leaky
    plan = build_plan(model_cfg)
    return model_cfg, plan, init_plan(plan, torch.Generator().manual_seed(SEED))


def serving_inputs(dev):
    rng = np.random.default_rng(SEED)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((480, 640), (300, 500), (416, 416), (720, 400))]
    batches = {b: torch.from_numpy(rng.uniform(size=(b, 416, 416, 3)).astype(np.float32)).to(dev)
               for b in (8, 128)}
    return images, batches


def drive(pred, images, batches, out) -> None:
    """The user's entry points: predict_images, predict_image, predict_batch
    at each batch size (timed); checks shapes and finiteness."""
    results = pred.predict_images(images)
    single = pred.predict_image(images[0])
    for b, x in batches.items():
        kept, mask = pred.predict_batch(x)
        torch.cuda.synchronize()
        require(kept.shape == (b, K, 6) and mask.shape == (b, K),
                f"predict_batch shapes {tuple(kept.shape)} {tuple(mask.shape)}")
        require(mask.dtype == torch.bool and bool(torch.isfinite(kept).all()),
                "predict_batch mask not bool or boxes not finite")
        iters = 20 if b == 8 else 5
        t0 = time.perf_counter()
        for _ in range(iters):
            pred.predict_batch(x)
        torch.cuda.synchronize()
        out[f"B{b}_images_per_s"] = b * iters / (time.perf_counter() - t0)
    require(len(results) == len(images), "predict_images lost images")
    for boxes in results + [single]:
        for row in boxes:
            require(len(row) == 6 and all(np.isfinite(row)), f"bad box row {row}")
    out["boxes_per_image"] = [len(r) for r in results]


def phase_main(dev):
    from yolo_for_turbines_tpu_torch.inference import Predictor
    from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy
    from yolo_for_turbines_tpu_torch.ops.kernels import (
        epilogue_kernel,
        iou_kernel,
        nms_kernel,
        resblock_kernel,
    )

    model_cfg, plan, tree = full_model()
    pred = Predictor(folded_from_numpy(plan, tree, model_cfg), device=dev)
    images, batches = serving_inputs(dev)
    out = {"phase": "main", "model": "darknet53 yolov3, 80 classes, 416px, bf16"}
    # K5 once per folded conv outside K2's stage: 36 of the backbone's 52,
    # 8 single neck convs and 5 at each of the 3 "S" entries (a block
    # without a residual, a 1x1, the head's 3x3 and 1x1)
    per_call = {}
    for b, x in batches.items():
        epilogue_kernel.launches = 0
        pred.predict_batch(x)
        per_call[b] = epilogue_kernel.launches
    out["conv_epilogue_launches_per_predict_batch"] = per_call
    require(all(n == K5_PER_CALL for n in per_call.values()),
            f"K5 launches per bf16 predict_batch {per_call}, not {K5_PER_CALL}")

    nms_kernel.launches = 0
    resblock_kernel.launches = 0
    iou_kernel.launches = 0
    drive(pred, images, batches, out)
    launches = {"greedy_nms": nms_kernel.launches,
                "fused_residual_stage": resblock_kernel.launches}
    out["launches"] = launches
    # no serving path calls K3 (as in the JAX package): counted, not gated
    out["pairwise_iou_launches"] = iou_kernel.launches
    if not all(launches.values()):
        emit(out)
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    # raw heads of one image: bf16 on the card vs f32 on the CPU, same weights
    x1 = batches[8][:1]
    with torch.inference_mode():
        dev_heads = pred.model(x1)
        cpu_model = folded_from_numpy(plan, tree, model_cfg).eval()
        cpu_heads = cpu_model(x1.cpu())
    errs = []
    for d, c in zip(dev_heads, cpu_heads):
        d = d.float().cpu()
        require(d.shape == c.shape and bool(torch.isfinite(d).all()),
                "raw heads of the card not finite or misshapen")
        errs.append(((d - c).norm() / c.norm()).item())
    out["head_rel_rms_err"] = errs
    out["head_max_abs_err"] = max((d.float().cpu() - c).abs().max().item()
                                  for d, c in zip(dev_heads, cpu_heads))
    emit(out)
    if not max(errs) <= HEAD_RTOL:
        raise AssertionError(f"raw heads differ from the f32 CPU forward: {errs}")
    return (launches, out["pairwise_iou_launches"],
            {k: v for k, v in out.items() if k.endswith("_images_per_s")}, (x1, cpu_heads))


def phase_yolov7(dev):
    """YOLOv7 at 640px (80 classes, seeded folded weights) served in bf16:
    K5 once per conv in each ``predict_batch`` (92), K8 once per pool
    pyramid or MP pool (6), K1 at the end, no K2; its concats written in
    place give the heads and boxes of ``torch.cat`` bit for bit, K5 storing
    at least CONCAT_IN_PLACE_SHARE of their bytes (``concat_check``).
    The raw heads of one image against the f32 forward on the CPU are
    printed, not gated: the cell (``perfbench``) holds YOLOv7 to its
    reference on calibrated weights."""
    from yolo_for_turbines_tpu_torch import config as cfg
    from yolo_for_turbines_tpu_torch.config import ModelConfig
    from yolo_for_turbines_tpu_torch.inference import Predictor
    from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy
    from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan, init_plan
    from yolo_for_turbines_tpu_torch.ops.kernels import (
        epilogue_kernel,
        maxpool_kernel,
        nms_kernel,
        resblock_kernel,
    )

    model_cfg = ModelConfig(backbone="yolov7", activation="silu",
                            strides=cfg.strides_for("yolov7"))
    plan = build_plan(model_cfg)
    tree = init_plan(plan, torch.Generator().manual_seed(SEED + 7))
    pred = Predictor(folded_from_numpy(plan, tree, model_cfg), device=dev,
                     anchors=cfg.YOLOV7_ANCHORS, image_size=640)
    x = torch.from_numpy(np.random.default_rng(SEED + 7).uniform(
        size=(8, 640, 640, 3)).astype(np.float32)).to(dev)
    out = {"phase": "yolov7", "model": "yolov7 deploy form, 80 classes, 640px, bf16"}
    per_call = []
    for _ in range(2):
        epilogue_kernel.launches = nms_kernel.launches = resblock_kernel.launches = 0
        maxpool_kernel.launches = 0
        kept, mask = pred.predict_batch(x)
        torch.cuda.synchronize()
        per_call.append({"conv_epilogue": epilogue_kernel.launches,
                         "maxpool": maxpool_kernel.launches,
                         "greedy_nms": nms_kernel.launches,
                         "fused_residual_stage": resblock_kernel.launches})
    out["launches_per_predict_batch"] = per_call
    require(kept.shape == (8, K, 6) and bool(torch.isfinite(kept).all()),
            "YOLOv7 predict_batch boxes misshapen or not finite")
    with torch.inference_mode():
        dev_heads = pred.model(x[:1])
        cpu_heads = folded_from_numpy(plan, tree, model_cfg).eval()(x[:1].cpu())
    errs = [float((d.float().cpu() - c).norm() / c.norm()) for d, c in zip(dev_heads, cpu_heads)]
    out["head_rel_rms_err"] = errs
    emit(out)
    concat_check(pred, x, {"phase": "yolov7", "model": out["model"]})
    require(all(c["conv_epilogue"] == K5_PER_CALL_YOLOV7 and c["greedy_nms"] >= 1
                and c["maxpool"] == K8_PER_CALL["yolov7"]
                and c["fused_residual_stage"] == 0 for c in per_call),
            f"YOLOv7 launches per bf16 predict_batch {per_call}: K5 not "
            f"{K5_PER_CALL_YOLOV7}, K8 not {K8_PER_CALL['yolov7']}, no K1, or K2")
    return per_call[0]["conv_epilogue"], per_call[0]["maxpool"]


def phase_main_f32(dev, x1, cpu_heads):
    """The float32 predictor on the card: K2 takes bf16 only, so its router
    must leave the 26x26x512 stage on the layer path."""
    from yolo_for_turbines_tpu_torch.inference import Predictor
    from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy
    from yolo_for_turbines_tpu_torch.ops.kernels import (
        epilogue_kernel,
        iou_kernel,
        nms_kernel,
        resblock_kernel,
    )

    model_cfg, plan, tree = full_model()
    pred = Predictor(folded_from_numpy(plan, tree, model_cfg), device=dev,
                     compute_dtype=torch.float32)
    out = {"phase": "main_f32", "model": "darknet53 yolov3, 80 classes, 416px, float32 (TF32 off)",
           "tol_rel_rms": HEAD_RTOL_F32}
    x = torch.from_numpy(
        np.random.default_rng(SEED + 2).uniform(size=(2, 416, 416, 3)).astype(np.float32)).to(dev)
    nms_kernel.launches = 0
    resblock_kernel.launches = 0
    iou_kernel.launches = 0
    epilogue_kernel.launches = 0
    kept, mask = pred.predict_batch(x)
    torch.cuda.synchronize()
    launches = {"greedy_nms": nms_kernel.launches,
                "fused_residual_stage": resblock_kernel.launches,
                "pairwise_iou": iou_kernel.launches,
                "conv_epilogue": epilogue_kernel.launches}
    out["launches"] = launches
    require(kept.shape == (2, K, 6) and mask.shape == (2, K) and mask.dtype == torch.bool
            and bool(torch.isfinite(kept).all()), "float32 predict_batch misshapen or not finite")
    dev_heads = pred.raw_heads(x1)
    errs = [((d.float().cpu() - c).norm() / c.norm()).item() for d, c in zip(dev_heads, cpu_heads)]
    out["head_rel_rms_err"] = errs
    emit(out)
    if launches["fused_residual_stage"] or launches["conv_epilogue"] or not launches["greedy_nms"]:
        raise AssertionError(f"float32 path: K2 and K5 must not launch and K1 must: {launches}")
    if not max(errs) <= HEAD_RTOL_F32:
        raise AssertionError(f"float32 raw heads differ from the f32 CPU forward: {errs}")
    return launches


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def phase_main_int8(dev, bf16_rates):
    from yolo_for_turbines_tpu_torch.inference import Predictor
    from yolo_for_turbines_tpu_torch.models.convert import qparams_from_numpy
    from yolo_for_turbines_tpu_torch.models.quantize import apply_inference_int8
    from yolo_for_turbines_tpu_torch.ops.kernels import (
        epilogue_kernel,
        int8_conv_kernel,
        int8_epilogue_kernel,
        iou_kernel,
        nms_kernel,
        resblock_int8_kernel,
        resblock_kernel,
    )

    model_cfg, plan, tree = full_model()
    pred = Predictor.from_folded(model_cfg, tree, device=dev)
    images, batches = serving_inputs(dev)
    calib = np.random.default_rng(SEED + 1).uniform(size=(8, 416, 416, 3)).astype(np.float32)
    out = {"phase": "main_int8", "model": "darknet53 yolov3, 80 classes, 416px, int8 PTQ "
           "(bf16 heads)", "calibration_images": len(calib)}
    x1 = batches[8][:1]
    bf16_heads = pred.raw_heads(x1)
    t0 = time.perf_counter()
    pred.quantize(calib)
    torch.cuda.synchronize()
    out["quantize_s"] = time.perf_counter() - t0

    nms_kernel.launches = 0
    resblock_int8_kernel.launches = 0
    resblock_kernel.launches = 0
    iou_kernel.launches = 0
    epilogue_kernel.launches = 0
    drive(pred, images, batches, out)
    launches = {"greedy_nms": nms_kernel.launches,
                "fused_residual_stage_int8": resblock_int8_kernel.launches}
    out["launches"] = launches
    out["bf16_fused_residual_stage_launches"] = resblock_kernel.launches
    out["conv_epilogue_launches"] = epilogue_kernel.launches
    out["pairwise_iou_launches"] = iou_kernel.launches
    out["bf16_images_per_s"] = bf16_rates
    if not all(launches.values()) or resblock_kernel.launches or epilogue_kernel.launches:
        emit(out)
        raise AssertionError(f"the int8 path did not run its kernels: {out['launches']}, "
                             f"bf16 stage launches {resblock_kernel.launches}, "
                             f"K5 launches {epilogue_kernel.launches}")
    per_call = []
    for b in (8, 128):
        int8_epilogue_kernel.launches = int8_conv_kernel.launches = 0
        pred.predict_batch(batches[b])
        per_call.append((int8_epilogue_kernel.launches, int8_conv_kernel.launches))
    out["int8_epilogue_launches_per_predict_batch"] = [k6 for k6, _ in per_call]
    out["int8_conv_launches_per_predict_batch"] = [k7 for _, k7 in per_call]
    if per_call != [(K6_PER_CALL, K7_PER_CALL)] * 2:
        emit(out)
        raise AssertionError(f"K6 and K7 launched {per_call} times per predict_batch at B = 8 "
                             f"and 128, not {K6_PER_CALL} and {K7_PER_CALL}")

    # one image through the int8 forward on the card and the port's int8
    # CPU forward from the same qparams (f32 heads): the s8 trunk codes
    # each head reads, then the raw heads
    kw = {"activation": model_cfg.activation, "raw_heads": True}
    dev_trunk, cpu_trunk = [], []
    with torch.inference_mode():
        dev_heads = apply_inference_int8(plan, pred._qparams, x1, compute_dtype=pred.compute_dtype,
                                         packed=pred._packed, head_inputs=dev_trunk, **kw)
        cpu_heads = apply_inference_int8(
            plan, qparams_from_numpy(plan, pred._qparams, "cpu"), x1.cpu(),
            compute_dtype=torch.float32, head_inputs=cpu_trunk, **kw)
    codes = []
    for d_in, c_in in zip(dev_trunk, cpu_trunk):
        for d, c in zip(d_in, c_in):
            diff = (d.cpu().int() - c.int()).abs()
            codes.append({"shape": list(c.shape), "max_codes": int(diff.max()),
                          "frac_differing": float((diff != 0).float().mean())})
    out["trunk_codes_card_vs_cpu_int8"] = codes
    cos = []
    for d, c in zip(dev_heads, cpu_heads):
        d = d.float().cpu()
        require(d.shape == c.shape and bool(torch.isfinite(d).all()),
                "int8 raw heads of the card not finite or misshapen")
        cos.append(cosine(d, c))
    out["head_cos_card_vs_cpu_int8"] = cos
    # a property of PTQ on random weights, not of the port: not gated
    out["head_cos_int8_vs_bf16"] = [cosine(a.float(), b.float())
                                    for a, b in zip(dev_heads, bf16_heads)]
    # a predictor built for 608px, quantized the same way, fed the 416px
    # B=8 batch: the stage is routed on the call's shape, so K4 launches
    # (8 blocks) and the trunk codes are those of the 416px predictor
    pred608 = Predictor.from_folded(model_cfg, tree, device=dev, image_size=608).quantize(calib)
    x8 = batches[8]
    trunk608, trunk416, k4_launches = [], [], []
    with torch.inference_mode():
        for p, sink in ((pred608, trunk608), (pred, trunk416)):
            resblock_int8_kernel.launches = 0
            apply_inference_int8(plan, p._qparams, x8, compute_dtype=p.compute_dtype,
                                 packed=p._packed, head_inputs=sink, **kw)
            k4_launches.append(resblock_int8_kernel.launches)
    out["built_608_fed_416"] = {
        "k4_launches_per_call": k4_launches[0],
        "k4_launches_per_call_built_416": k4_launches[1],
        "trunk_code_mismatches": sum(int((a != b).sum()) for ta, tb in zip(trunk608, trunk416)
                                     for a, b in zip(ta, tb))}
    kept608, mask608 = pred608.predict_batch(x8)
    kept416, mask416 = pred.predict_batch(x8)
    out["built_608_fed_416"]["predict_batch_equal"] = bool(
        torch.equal(kept608, kept416) and torch.equal(mask608, mask416))
    emit(out)
    if out["built_608_fed_416"] != {"k4_launches_per_call": 8, "k4_launches_per_call_built_416": 8,
                                    "trunk_code_mismatches": 0, "predict_batch_equal": True}:
        raise AssertionError(f"a 608px-built int8 predictor fed 416px: {out['built_608_fed_416']}")
    require(len(codes) == 3, f"expected one trunk tensor per head, got {len(codes)}")
    if not max(c["frac_differing"] for c in codes) <= INT8_TRUNK_MAX_FRAC:
        raise AssertionError(f"int8 trunk codes differ from the int8 CPU forward: {codes}")
    if not min(cos) > INT8_HEAD_COS:
        raise AssertionError(f"int8 raw heads differ from the int8 CPU forward: {cos}")
    return launches, out["pairwise_iou_launches"]


def eval_model(dev, model_cfg, size: int):
    """The trainable full-width model on the card, f32: seeded init; BN
    scale U(0.5, 1.5) and bias N(0, 0.2); running statistics from one
    train-mode pass over 8 seeded noise images (momentum None: the average
    of one batch is that batch), then mean + N(0, 0.1) * std and
    var * U(0.7, 1.4); each anchor's objectness row of each head's last 1x1
    scaled and shifted so that its eval-mode logits on those images have
    mean OBJECTNESS_MEAN and standard deviation OBJECTNESS_STD.

    The same recipe, drawn from numpy and with mean 0, makes the CPU tests'
    weights in ``tests/torch_eval_weights.py::eval_weights``: keep the two
    in step (this file imports nothing of the tests, whose helpers import
    the JAX package)."""
    import torch.nn as nn

    from yolo_for_turbines_tpu_torch.models.yolov3 import TrainableHead, YOLOv3

    gen = torch.Generator().manual_seed(SEED + 3)
    model = YOLOv3(model_cfg, generator=gen)
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.weight.copy_(torch.rand(bn.num_features, generator=gen) + 0.5)
            bn.bias.copy_(0.2 * torch.randn(bn.num_features, generator=gen))
            bn.reset_running_stats()
            bn.momentum = None
        model = model.to(dev, memory_format=torch.channels_last)
        x = torch.rand(8, size, size, 3, generator=gen).to(dev)
        model.train()(x)
        for bn in bns:
            bn.momentum = 0.1
            std = bn.running_var.sqrt()
            bn.running_mean.add_(0.1 * torch.randn(bn.num_features, generator=gen).to(dev) * std)
            bn.running_var.mul_((0.7 + 0.7 * torch.rand(bn.num_features, generator=gen)).to(dev))
        heads = model.eval()(x)
        c5 = model_cfg.num_classes + 5
        for head, y in zip((m for m in model.layers if isinstance(m, TrainableHead)), heads):
            conv = head.conv2.conv
            for a in range(y.shape[1]):
                row = a * c5 + 4
                free = y[:, a, ..., 4] - conv.bias[row]
                gain = OBJECTNESS_STD / free.std()
                conv.weight[row] *= gain
                conv.bias[row] = OBJECTNESS_MEAN - gain * free.mean()
    return model


def eval_batches(dev, classes: int, size: int):
    """EVAL_IMAGES seeded noise images with 1 to 8 random boxes each,
    encoded by assign_targets; batches of 8 on the card."""
    from yolo_for_turbines_tpu_torch import config as cfg
    from yolo_for_turbines_tpu_torch.data.dataset import assign_targets

    rng = np.random.default_rng(SEED + 4)
    anchors = cfg.anchors_array(cfg.ANCHORS).reshape(-1, 2)
    images = rng.uniform(size=(EVAL_IMAGES, size, size, 3)).astype(np.float32)
    per_image = []
    for _ in range(EVAL_IMAGES):
        boxes = [[*rng.uniform(0.05, 0.95, 2), *rng.uniform(0.03, 0.6, 2),
                  int(rng.integers(classes))] for _ in range(int(rng.integers(1, 9)))]
        per_image.append(assign_targets(boxes, anchors, cfg.grid_sizes_for(size)))
    targets = [np.stack([t[i] for t in per_image]) for i in range(3)]
    x = torch.from_numpy(images).to(dev)
    t = [torch.from_numpy(a).to(dev) for a in targets]
    return x, t


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm())


def sorted_rows(rows: torch.Tensor) -> torch.Tensor:
    """Rows by descending score (column 4)."""
    return rows[torch.argsort(-rows[:, 4], stable=True)]


@contextlib.contextmanager
def tf32_on():
    """TF32 on for cuDNN convs and cuBLAS matmuls, restored afterwards: a
    float32 path must turn it off itself."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def phase_eval(dev):
    """The eval path of the 80-class Darknet-53 at 416px."""
    import copy

    from yolo_for_turbines_tpu_torch import config as cfg
    from yolo_for_turbines_tpu_torch.inference import Predictor
    from yolo_for_turbines_tpu_torch.models.blocks import full_f32
    from yolo_for_turbines_tpu_torch.ops import map as map_ops
    from yolo_for_turbines_tpu_torch.ops.kernels import iou_kernel, nms_kernel, resblock_kernel
    from yolo_for_turbines_tpu_torch.train import evaluate as ev

    model_cfg, size = cfg.ModelConfig(), 416
    out = {"phase": "eval", "model": f"{model_cfg.backbone} yolov3, {model_cfg.num_classes} "
           f"classes, {size}px, trainable (conv + BN)", "images": EVAL_IMAGES, "loss_rtol": EVAL_LOSS_RTOL,
           "head_rtol": EVAL_HEAD_RTOL, "bf16_head_rtol": EVAL_BF16_HEAD_RTOL,
           "box_rtol": EVAL_BOX_RTOL, "box_atol": EVAL_BOX_ATOL}
    t0 = time.perf_counter()
    model = eval_model(dev, model_cfg, size)
    classes = model_cfg.num_classes
    x, targets = eval_batches(dev, classes, size)
    loader = [(x[i:i + 8], [t[i:i + 8] for t in targets]) for i in range(0, EVAL_IMAGES, 8)]
    out["setup_s"] = time.perf_counter() - t0

    # float32 on the card against the port's f32 CPU step, B=2. TF32 is on
    # around the card's f32 forwards (main() turns it off for the process),
    # so the gates hold the eval path's own switch (models/blocks.py::full_f32)
    x2, t2 = x[:2], [t[:2] for t in targets]
    with tf32_on():
        card = ev.make_fused_eval_step(model, compute_dtype=torch.float32)(x2, t2, cfg.ANCHORS)
        with torch.no_grad():
            with full_f32():
                heads_f32 = model.eval()(x[:8])
            # what the switch guards against: the same heads in TF32
            heads_tf32 = model(x[:8])
    cpu_model = copy.deepcopy(model).to("cpu", memory_format=torch.contiguous_format)
    t0 = time.perf_counter()
    host = ev.make_fused_eval_step(cpu_model, compute_dtype=torch.float32)(
        x2.cpu(), [t.cpu() for t in t2], cfg.ANCHORS)
    out["cpu_step_B2_s"] = time.perf_counter() - t0
    (m_d, c_d, kept_d, mask_d, _), (m_h, c_h, kept_h, mask_h, _) = card, host
    out["loss_terms_card"] = {k: float(v) for k, v in m_d.items()}
    out["loss_rel_err"] = {k: abs(float(m_d[k]) - float(m_h[k])) / abs(float(m_h[k])) for k in m_h}
    out["counts_card"], out["counts_cpu"] = c_d.tolist(), c_h.tolist()
    box_err, survivors = 0.0, []
    masks_equal = bool(torch.equal(mask_d.cpu().sum(1), mask_h.sum(1)))
    for b in range(2):
        got, want = sorted_rows(kept_d[b][mask_d[b]].cpu()), sorted_rows(kept_h[b][mask_h[b]])
        survivors.append(len(want))
        if got.shape != want.shape:
            masks_equal = False
            continue
        excess = (got - want).abs() - EVAL_BOX_RTOL * want.abs()
        box_err = max(box_err, float(excess.max()))
    out["survivors_B2"], out["survivor_counts_equal"] = survivors, masks_equal
    out["survivor_max_excess_over_rtol"] = box_err
    out["tf32_head_rel_rms"] = [rel_rms(h, w) for h, w in zip(heads_tf32, heads_f32)]
    with torch.no_grad(), torch.autocast(dev.type, dtype=torch.bfloat16):
        heads_bf16 = model(x[:8])
    out["bf16_head_rel_rms"] = [rel_rms(h, w) for h, w in zip(heads_bf16, heads_f32)]
    del cpu_model, host

    # the eval path: the fused step over the 32 images in bf16 autocast
    # (B = 8), then evaluate_map_device over the same batches
    step = ev.make_fused_eval_step(model)
    nms_kernel.launches = 0
    resblock_kernel.launches = 0
    iou_kernel.launches = 0
    results = [step(*batch, cfg.ANCHORS) for batch in loader]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_map = ev.evaluate_map_device(loader, model, cfg.ANCHORS, classes)
    out["evaluate_map_device_s"] = time.perf_counter() - t0
    launches = {"greedy_nms": nms_kernel.launches,
                "fused_residual_stage": resblock_kernel.launches,
                "pairwise_iou": iou_kernel.launches}
    out["launches"], out["eval_steps"] = launches, 2 * len(loader)
    out["evaluate_map_device"] = dev_map
    out["bf16_loss_terms_B8"] = [{k: float(v) for k, v in r[0].items()} for r in results]

    # device mAP against host calc_map on the same rows, all 32 images
    kept = torch.cat([r[2] for r in results])
    mask = torch.cat([r[3] for r in results])
    true = torch.cat([r[4] for r in results])
    true_ok = true[..., 4] > cfg.CONF_THRESHOLD
    p_rows, t_rows, _ = ev.rows_from_eval_step(kept, mask, true, 0, cfg.CONF_THRESHOLD)
    t0 = time.perf_counter()
    host_map = map_ops.calc_map(p_rows, t_rows, num_classes=classes)
    out["host_calc_map_s"] = time.perf_counter() - t0
    dev_map_rows = float(map_ops.calc_map_device_batched(kept, mask, true, true_ok,
                                                         num_classes=classes))
    # the same with jittered copies of the ground truth among the survivors,
    # so that matches happen and the AP is neither 0 nor 1
    gen = torch.Generator().manual_seed(SEED + 5)
    g = true.shape[1]
    jitter = true.clone()
    jitter[..., :4] += 0.02 * (torch.rand(jitter[..., :4].shape, generator=gen).to(dev) - 0.5)
    jitter[..., 4] = torch.rand(jitter[..., 4].shape, generator=gen).to(dev)
    mixed = torch.cat([kept[:, : kept.shape[1] - g], jitter], dim=1)
    mixed_ok = torch.cat([mask[:, : kept.shape[1] - g], true_ok], dim=1)
    mp_rows, _, _ = ev.rows_from_eval_step(mixed, mixed_ok, true, 0, cfg.CONF_THRESHOLD)
    mixed_host = map_ops.calc_map(mp_rows, t_rows, num_classes=classes)
    mixed_dev = float(map_ops.calc_map_device_batched(mixed, mixed_ok, true, true_ok,
                                                      num_classes=classes))
    replay = float(map_ops.calc_map_device_batched(true, true_ok, true, true_ok,
                                                   num_classes=classes))
    out["map"] = {"device": dev_map_rows, "host": host_map, "mixed_device": mixed_dev,
                  "mixed_host": mixed_host, "gt_replay": replay,
                  "gt_boxes": int(true_ok.sum()), "survivors": int(mask.sum())}

    # times: the eval step at B = 8 and 32 (bf16), device mAP at I = 1000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        for batch in loader:
            step(*batch, cfg.ANCHORS)
    torch.cuda.synchronize()
    out["eval_step_B8_images_per_s"] = 2 * EVAL_IMAGES / (time.perf_counter() - t0)
    step(x, targets, cfg.ANCHORS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(x, targets, cfg.ANCHORS)
    torch.cuda.synchronize()
    out["eval_step_B32_images_per_s"] = 3 * EVAL_IMAGES / (time.perf_counter() - t0)
    dgen = torch.Generator(device=dev).manual_seed(SEED + 6)
    n_img, k, g, c = 1000, K, 128, 80

    def rows(n):
        r = torch.rand(n_img, n, 6, generator=dgen, device=dev)
        r[..., 2:4] = 0.05 + 0.3 * r[..., 2:4]
        r[..., 5] = torch.randint(0, c, (n_img, n), generator=dgen, device=dev).float()
        return r

    preds, gts = rows(k), rows(g)
    pv = torch.rand(n_img, k, generator=dgen, device=dev) < 0.5
    gv = torch.rand(n_img, g, generator=dgen, device=dev) < 0.3
    big = float(map_ops.calc_map_device_batched(preds, pv, gts, gv, num_classes=c))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        float(map_ops.calc_map_device_batched(preds, pv, gts, gv, num_classes=c))
    out["calc_map_device_batched_I1000_K256_G128_C80_s"] = (time.perf_counter() - t0) / 2
    out["calc_map_device_batched_I1000_value"] = big

    # fold() served: bf16 with K2 and K1, and f32 heads against the module's
    folded = model.fold()
    pred = Predictor.from_folded(model_cfg, folded, device=dev)
    nms_kernel.launches = 0
    resblock_kernel.launches = 0
    kept8, mask8 = pred.predict_batch(x[:8])
    torch.cuda.synchronize()
    fold_launches = {"greedy_nms": nms_kernel.launches,
                     "fused_residual_stage": resblock_kernel.launches}
    out["fold_launches_B8"] = fold_launches
    pred32 = Predictor.from_folded(model_cfg, folded, device=dev, compute_dtype=torch.float32)
    raw = pred32.raw_heads(x[:8])
    out["fold_f32_head_rel_rms"] = [
        rel_rms(r.reshape(h.shape[0], h.shape[2], h.shape[3], h.shape[1], h.shape[4])
                .permute(0, 3, 1, 2, 4), h) for r, h in zip(raw, heads_f32)]
    emit(out)

    require(max(out["loss_rel_err"].values()) <= EVAL_LOSS_RTOL,
            f"f32 card loss terms differ from the CPU step: {out['loss_rel_err']}")
    require(out["counts_card"] == out["counts_cpu"], "f32 card accuracy counts differ from CPU")
    require(masks_equal and box_err <= EVAL_BOX_ATOL,
            "f32 card survivors differ from the CPU step")
    require(max(out["bf16_head_rel_rms"]) <= EVAL_BF16_HEAD_RTOL,
            f"bf16 eval heads off the f32 heads: {out['bf16_head_rel_rms']}")
    require(all(np.isfinite(v) for r in out["bf16_loss_terms_B8"] for v in r.values()),
            "bf16 eval loss terms not finite")
    require(launches["greedy_nms"] >= out["eval_steps"] and launches["fused_residual_stage"] == 0,
            f"eval path launches {launches}: K1 once per step, no K2")
    require(abs(dev_map_rows - host_map) <= EVAL_MAP_TOL
            and abs(mixed_dev - mixed_host) <= EVAL_MAP_TOL,
            f"device mAP differs from host calc_map: {out['map']}")
    require(0.0 < mixed_host < 1.0, f"mixed rows give a trivial mAP: {out['map']}")
    require(replay == 1.0, f"ground-truth replay scored {replay}")
    require(fold_launches == {"greedy_nms": 1, "fused_residual_stage": 8},
            f"fold() served: launches {fold_launches}")
    require(mask8.shape == (8, K) and bool(torch.isfinite(kept8).all()),
            "fold() served: predict_batch misshapen or not finite")
    require(max(out["fold_f32_head_rel_rms"]) <= EVAL_HEAD_RTOL,
            f"folded f32 heads off the trainable module's: {out['fold_f32_head_rel_rms']}")
    return launches, fold_launches


def leaf_rel_rms(got: dict, want: dict):
    """(worst relative RMS over the leaves of two name -> tensor dicts, its
    leaf)."""
    worst = (0.0, "")
    for k, w in want.items():
        err = rel_rms(got[k], w) if float(w.double().norm()) > 0 else float(got[k].abs().max())
        worst = max(worst, (err, k))
    return worst


def train_f32_check(dev, model_cfg, out, loss_rtol=TRAIN_LOSS_RTOL):
    """One float32 train step on the card (TF32 on around it: the step must
    turn it off) against the port's float32 CPU step from the same weights,
    B = 2, 416px. Beside it, the loss terms of the same train-mode forward
    on the card with TF32 left on (the control: what the loss gate must
    see) and in float64 (how far each f32 step is from exact)."""
    import copy

    from yolo_for_turbines_tpu_torch import config as cfg
    from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3
    from yolo_for_turbines_tpu_torch.tools.profile_serving import train_batch
    from yolo_for_turbines_tpu_torch.train import steps
    from yolo_for_turbines_tpu_torch.train.loss import total_yolo_loss

    tc = cfg.TrainConfig(lr=1e-2, warmup_enabled=False, compute_dtype="float32")
    base = YOLOv3(model_cfg, generator=torch.Generator().manual_seed(SEED + 7))
    anchors = torch.from_numpy(cfg.scaled_anchors_array(cfg.TURBINE_ANCHORS, 416))
    x, targets = train_batch(2, 416, "cpu", seed=SEED + 8)
    before = {k: v.clone() for k, v in base.state_dict().items()}
    def forward_terms(dtype, ctx):
        probe = copy.deepcopy(base).to(dev, dtype, memory_format=torch.channels_last).train()
        with torch.no_grad(), ctx:
            total, comps = total_yolo_loss(probe(x.to(dev, dtype)),
                                           tuple(t.to(dev, dtype) for t in targets),
                                           anchors.to(dev, dtype))
        return {**{k: float(v) for k, v in comps.items()}, "loss": float(total)}

    tf32_terms = forward_terms(torch.float32, tf32_on())
    f64_terms = forward_terms(torch.float64, contextlib.nullcontext())
    results = {}
    for where in ("card", "cpu"):
        model = copy.deepcopy(base)
        if where == "card":
            model = model.to(dev, memory_format=torch.channels_last)
        state = steps.create_train_state(model, tc)
        step = steps.make_train_step(tc)
        t0 = time.perf_counter()
        with tf32_on() if where == "card" else contextlib.nullcontext():
            m = step(state, x.to(model_dev(model)), tuple(t.to(model_dev(model)) for t in targets),
                     anchors.to(model_dev(model)))
            if where == "card":
                torch.cuda.synchronize()
        out[f"f32_step_{where}_s"] = time.perf_counter() - t0
        results[where] = ({k: float(v) for k, v in m.items()},
                          {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (m_d, s_d), (m_h, s_h) = results["card"], results["cpu"]
    params = {n for n, _ in base.named_parameters()}
    upd = {k: (v.double() - before[k].double()) for k, v in s_d.items() if k in params}
    upd_h = {k: (v.double() - before[k].double()) for k, v in s_h.items() if k in params}
    stats = {k: v for k, v in s_d.items() if k.endswith(("running_mean", "running_var"))}
    out["f32_loss_terms_card"] = m_d
    out["f32_loss_rel_err"] = {k: abs(m_d[k] - m_h[k]) / abs(m_h[k]) for k in m_h}
    out["f32_update_rel_rms_worst"] = leaf_rel_rms(upd, upd_h)
    out["f32_update_rel_rms_all"] = rel_rms(torch.cat([v.flatten() for v in upd.values()]),
                                            torch.cat([upd_h[k].flatten() for k in upd]))
    out["f32_stats_rel_rms_worst"] = leaf_rel_rms(stats, {k: s_h[k] for k in stats})
    def rel(got, want):
        return {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}

    out["tf32_control_loss_rel_err"] = rel(tf32_terms, m_h)
    out["f64_witness_loss_rel_err"] = {"card_f32": rel(m_d, f64_terms),
                                       "cpu_f32": rel(m_h, f64_terms)}
    return (max(out["f32_loss_rel_err"].values()) <= loss_rtol
            and out["f32_update_rel_rms_worst"][0] <= TRAIN_UPDATE_RTOL
            and out["f32_stats_rel_rms_worst"][0] <= TRAIN_STATS_RTOL
            and min(float(v.abs().max()) for v in upd.values()) > 0)


def model_dev(model) -> torch.device:
    return next(model.parameters()).device


def checkpoint_round_trip(state, path, fresh) -> bool:
    """``state`` saved to ``path`` (unless it is already there) and loaded
    into ``fresh``'s on the card: module, optimizer, step and hyper equal
    bit for bit."""
    from yolo_for_turbines_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    if state is not None:
        save_checkpoint(state, path)
    want = torch.load(path, weights_only=True)
    got = load_checkpoint(fresh.state, path).snapshot()
    opt_w, opt_g = want["optimizer"]["state"], got["optimizer"]["state"]
    return (got["step"] == want["step"] and got["hyper"] == want["hyper"]
            and got["model"].keys() == want["model"].keys()
            and all(torch.equal(got["model"][k], v) for k, v in want["model"].items())
            and opt_g.keys() == opt_w.keys()
            and all(torch.equal(opt_g[i]["momentum_buffer"], s["momentum_buffer"])
                    for i, s in opt_w.items()))


def train_bf16_steps(dev, size: int, out):
    """TRAIN_STEPS bf16 autocast steps of the Trainer at B = 32 on one fixed
    batch, after prewarm of that bucket: step time, images/s, peak memory,
    and whether the loss fell. At 416px also the profile of one step and the
    trained state's checkpoint round trip."""
    from yolo_for_turbines_tpu_torch import config as cfg
    from yolo_for_turbines_tpu_torch.tools.profile_serving import profile_train_step, train_batch
    from yolo_for_turbines_tpu_torch.train.trainer import Trainer

    batch = 32
    trainer = Trainer(cfg.TrainConfig(batch_size=batch, warmup_enabled=False), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.prewarm(sizes=(size,))
    out[f"prewarm_{size}_s"] = time.perf_counter() - t0
    x, targets = train_batch(batch, size, dev, seed=SEED + 9)
    anchors = trainer._anchors(size)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(trainer.train_step(trainer.state, x, targets, anchors)["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    losses = torch.stack(losses).tolist()
    out[f"bf16_B32_{size}"] = {
        "step_ms": ms, "images_per_s": batch * 1e3 / ms,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_mean_first5": float(np.mean(losses[:5])), "loss_mean_last5": float(np.mean(losses[-5:]))}
    r = out[f"bf16_B32_{size}"]
    ok = all(np.isfinite(losses)) and r["loss_mean_last5"] < r["loss_mean_first5"]
    if size == 416:
        summary, _ = profile_train_step(trainer, x, targets, iters=3, warmup=2, top=8)
        out["profile_bf16_B32_416"] = summary
        TRAIN_DIR.mkdir(parents=True, exist_ok=True)
        fresh = Trainer(cfg.TrainConfig(batch_size=batch, warmup_enabled=False), device=dev)
        out["trained_checkpoint_bit_for_bit"] = checkpoint_round_trip(
            trainer.state, TRAIN_DIR / "steps.ckpt", fresh)
        ok = ok and out["trained_checkpoint_bit_for_bit"] and trainer.state.step == TRAIN_STEPS
    return ok


def phase_train(dev):
    """The training path of the 2-class Darknet-53 (mish) at full width."""
    import shutil

    from yolo_for_turbines_tpu_torch import config as cfg
    from yolo_for_turbines_tpu_torch.data.loader import get_loaders
    from yolo_for_turbines_tpu_torch.data.splits import create_csv_files
    from yolo_for_turbines_tpu_torch.data.synthetic import generate_synthetic_dataset
    from yolo_for_turbines_tpu_torch.ops.kernels import iou_kernel, nms_kernel, resblock_kernel
    from yolo_for_turbines_tpu_torch.train.checkpoint import load_checkpoint
    from yolo_for_turbines_tpu_torch.train.trainer import Trainer, train

    model_cfg = cfg.ModelConfig(num_classes=cfg.NUM_TURBINE_CLASSES, activation="mish")
    out = {"phase": "train", "model": "darknet53 yolov3, 2 classes, mish, trainable",
           "loss_rtol": TRAIN_LOSS_RTOL, "update_rtol": TRAIN_UPDATE_RTOL,
           "stats_rtol": TRAIN_STATS_RTOL}
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    try:
        ok = {"f32_card_vs_cpu": train_f32_check(dev, model_cfg, out)}
        for size in (416, 608):
            ok[f"bf16_{size}"] = train_bf16_steps(dev, size, out)
            torch.cuda.empty_cache()

        # train() on a seeded synthetic set: 10 epochs of 2 steps, epoch 9's
        # fused eval launching K1
        t0 = time.perf_counter()
        root = generate_synthetic_dataset(TRAIN_DIR / "data", num_images=TRAIN_IMAGES, seed=SEED)
        create_csv_files(root / "images", root / "labels", root, {"train": 0.85, "val": 0.15},
                         image_ext=".jpg")
        out["synthetic_set_s"] = time.perf_counter() - t0
        folders = {"image_folder": root / "images", "annotation_folder": root / "labels"}
        # the default warmup (1% of the steps) is 1 step of 20, and from
        # scratch at the peak lr the loss can diverge by the third step;
        # 10 steps ramp the lr to TRAIN_LR
        tc = cfg.TrainConfig(batch_size=32, max_num_steps=20, warmup=0.5, lr=TRAIN_LR)
        train_loader, val_loader, _ = get_loaders(root, batch_size=32, anchors=cfg.TURBINE_ANCHORS,
                                                  num_workers=8, **folders)
        # the loader's host time per batch (decode + C++ augment + collate),
        # over two passes after a first that starts its threads
        sum(1 for _ in train_loader)
        t0 = time.perf_counter()
        n = sum(1 for _ in range(2) for _ in train_loader)
        out["loader_s_per_batch"] = (time.perf_counter() - t0) / n
        out["val_batches"] = len(val_loader)

        maps = []
        nms_kernel.launches = resblock_kernel.launches = iou_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best = train(tc, root, TRAIN_DIR / "models", "smoke", early_stop=5, device=dev,
                     report_callback=maps.append, **folders)
        torch.cuda.synchronize()
        out["train_10_epochs_s"] = time.perf_counter() - t0
        launches = {"greedy_nms": nms_kernel.launches,
                    "fused_residual_stage": resblock_kernel.launches,
                    "pairwise_iou": iou_kernel.launches}
        out["launches"], out["best_map"], out["reported_maps"] = launches, best, maps
        ok["k1_once_per_val_batch"] = (launches["greedy_nms"] >= len(val_loader) and len(maps) == 1
                                       and launches["fused_residual_stage"] == 0)

        rows = [json.loads(line) for line in
                open(TRAIN_DIR / "models" / "YOLOv3_Turbine_Detection_smoke_metrics.jsonl")]
        count = {k: sum(k in r for r in rows) for k in ("lr", "train_loss", "val_loss", "mAP")}
        out["metrics_rows"] = count
        # eval-mode BN reads running statistics that 2 steps an epoch leave
        # behind the weights: the val loss may overflow (not gated)
        out["val_loss_by_epoch"] = [r["val_loss"] if np.isfinite(r["val_loss"]) else "nan"
                                    for r in rows if "val_loss" in r]
        train_losses = [r["train_loss"] for r in rows if "train_loss" in r]
        out["train_loss_by_epoch"] = train_losses
        ok["metrics_rows"] = count == {"lr": 20, "train_loss": 10, "val_loss": 10, "mAP": 1} and all(
            np.isfinite(train_losses))
        ok["train_loss_falls"] = train_losses[-1] < train_losses[0]

        # the checkpoint back on the card, bit for bit
        ckpt = TRAIN_DIR / "models" / "best_model_smoke.ckpt"
        back = Trainer(tc, device=dev)
        ok["checkpoint_bit_for_bit"] = checkpoint_round_trip(None, ckpt, back)
        out["checkpoint_step"] = back.state.step

        # epoch 9's eval of the loaded state: device mAP against host calc_map
        logs = []

        class Rows:
            def log(self, d):
                logs.append(dict(d))

        dev_map = back.val_one_epoch(val_loader, 9, Rows())[1]
        host = Trainer(dataclasses.replace(tc, device_eval=False), device=dev)
        load_checkpoint(host.state, ckpt)
        host_map = host.val_one_epoch(val_loader, 9, Rows())[1]
        out["map_device"], out["map_host"] = dev_map, host_map
        ok["device_map_equals_host"] = abs(dev_map - host_map) <= EVAL_MAP_TOL
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    out["ok"] = ok
    emit(out)
    require(all(ok.values()), f"train phase failed: {ok}")
    return launches


# families phase: CSPDarknet-53 and YOLOv3-tiny at 80 classes, 416px
TINY_FLOATS = 8_858_734  # floats of the official yolov3-tiny.weights (80 classes)
# Both families serve weights with calibrated BN statistics (eval_model), so
# that the trunk reaches the heads: with init_plan's weights the CSP heads
# are their biases. bf16 rounding then grows with depth through the
# normalized layers. Per head, relative RMS against the f32 CPU forward of
# the same tree, cuDNN pinned (an H100):
# - bf16: tiny (13 layers) 0.0403 and 0.0347, under HEAD_RTOL; CSP (92
#   layers) 0.41-0.47. CSP's bf16 gate sits between that and its control:
#   one CSP stage's or upsample's concat swapped reads 0.91-0.99 in its
#   worst head (tiny's one concat: 0.96).
# - float32 (TF32 off): CSP 5.8e-5 to 1.1e-4, tiny 4.7e-6 and 5.8e-6, where
#   the same controls read 0.9: the gate that sees a fault in the card's
#   forward of the families.
CSP_BF16_HEAD_RTOL = 0.65
FAMILY_F32_HEAD_RTOL = 1e-3
# The CSP f32 card step against the CPU step: train's gates, but loss terms
# 5e-5. Measured 1.12e-5 in class_loss, most of it the CPU's own rounding:
# against a float64 forward on the card the card's f32 terms are off by
# 4.5e-6 at most, the CPU's by 9.9e-6. The control, the same forward with
# TF32 left on, reads 1.8e-2 to 2.2e-2 in its worst term (obj_loss;
# no_obj_loss, a mean over every cell, moves 4.4e-5 to 5.1e-5; it varies
# between calls). Its worst update (1.6e-4) and
# statistics (3.5e-6) keep Darknet-53's gates (an H100).
CSP_TRAIN_LOSS_RTOL = 5e-5
FAMILIES_DIR = TRAIN_DIR / "families"
FAMILIES_SIZE = 416


def kernel_counts():
    """K1 to K4 launch counts so far."""
    from yolo_for_turbines_tpu_torch.ops.kernels import (
        iou_kernel,
        nms_kernel,
        resblock_int8_kernel,
        resblock_kernel,
    )

    return {"greedy_nms": nms_kernel.launches, "fused_residual_stage": resblock_kernel.launches,
            "fused_residual_stage_int8": resblock_int8_kernel.launches,
            "pairwise_iou": iou_kernel.launches}


def zero_counts() -> None:
    from yolo_for_turbines_tpu_torch.ops.kernels import (
        iou_kernel,
        nms_kernel,
        resblock_int8_kernel,
        resblock_kernel,
    )

    for k in (nms_kernel, resblock_kernel, resblock_int8_kernel, iou_kernel):
        k.launches = 0


def family_path(pred, images, batches, out):
    """One family's serving path: the launches of one predict_batch (K1
    once, K2 and K4 never: no CSP or tiny stage is routed to them, as in the
    JAX package), then the user's entry points timed by ``drive``."""
    x = next(iter(batches.values()))
    zero_counts()
    pred.predict_batch(x)
    torch.cuda.synchronize()
    out["launches_per_predict_batch"] = kernel_counts()
    zero_counts()
    drive(pred, images, batches, out)
    out["launches"] = kernel_counts()
    return out["launches_per_predict_batch"] == {"greedy_nms": 1, "fused_residual_stage": 0,
                                                  "fused_residual_stage_int8": 0,
                                                  "pairwise_iou": 0}


@contextlib.contextmanager
def pinned_cudnn():
    """cuDNN's heuristic, deterministic algorithms, restored afterwards: a
    gate's reading must not follow what benchmark mode (which the Trainer
    turns on for the process) picked in this run."""
    saved = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved


@contextlib.contextmanager
def fresh_cudnn():
    """cuDNN as a fresh process has it (heuristic choices, benchmark and
    deterministic modes off), restored afterwards."""
    saved = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark = torch.backends.cudnn.deterministic = False
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved


@contextlib.contextmanager
def plain_epilogues():
    """Every folded conv on its separate ops (the conv's bias add, the
    activation, ``skip + y``), as a program traced on the CPU runs them,
    restored afterwards: the router told that K5 takes nothing."""
    from yolo_for_turbines_tpu_torch.models import blocks

    saved = blocks.epilogue_wins
    blocks.epilogue_wins = lambda x, act, skip=None: False
    try:
        yield
    finally:
        blocks.epilogue_wins = saved


def swapped_concat(plan, tree, at: int):
    """``tree`` as a model reads it whose concat at plan entry ``at`` takes
    its two inputs the other way round: a CSP ``fuse`` [shortcut,
    transition], the layer after an upsample [route, upsampled]. The head
    gates' control: what one concat-order fault reads."""
    import copy

    from yolo_for_turbines_tpu_torch.models.cspdarknet import PlanCSP

    out = copy.deepcopy(tree)
    entry = plan[at]
    if isinstance(entry, PlanCSP):  # two halves of branch_ch
        p, shift = out[at]["fuse"], entry.branch_ch
    else:  # an upsample: the next layer reads [upsampled, route]
        p = out[at + 1].get("conv") or out[at + 1]["conv1"]
        shift = entry.in_ch - np.asarray(p["w"]).shape[2]
    # HWIO: input channel i takes the weights of channel i - shift
    p["w"] = np.roll(np.asarray(p["w"]), shift, axis=2)
    return out


def heads_gate(pred, tree, x1, out, bf16_rtol) -> bool:
    """The raw heads of the bf16 predictor ``pred`` and of a float32 one
    from the same folded tree, on the card with cuDNN pinned, against the
    f32 CPU forward: relative RMS per head, at most ``bf16_rtol`` and
    FAMILY_F32_HEAD_RTOL. The control: each concat of the plan swapped
    alone (CPU) must read above ``bf16_rtol`` in some head, or the gates
    could not see it."""
    from yolo_for_turbines_tpu_torch.inference import Predictor
    from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy
    from yolo_for_turbines_tpu_torch.models.cspdarknet import PlanCSP
    from yolo_for_turbines_tpu_torch.models.yolov3 import PlanUpsample

    model_cfg, plan = pred.model.cfg, pred.model.plan
    f32 = Predictor.from_folded(model_cfg, tree, device=pred.device, image_size=pred.image_size,
                                compute_dtype=torch.float32)

    def cpu(t):
        return folded_from_numpy(plan, t, model_cfg).eval()(x1.cpu())

    with torch.inference_mode():
        with pinned_cudnn():
            dev_heads, f32_heads = pred.raw_heads(x1), f32.raw_heads(x1)
        want = cpu(tree)
        controls = {i: cpu(swapped_concat(plan, tree, i)) for i, e in enumerate(plan)
                    if isinstance(e, (PlanCSP, PlanUpsample))}
    out["head_rtol"], out["f32_head_rtol"] = bf16_rtol, FAMILY_F32_HEAD_RTOL
    out["head_rel_rms_err"] = [rel_rms(d.float(), c) for d, c in zip(dev_heads, want)]
    out["f32_head_rel_rms_err"] = [rel_rms(d, c) for d, c in zip(f32_heads, want)]
    out["control_swapped_concat_worst_head"] = {
        f"{i}:{type(plan[i]).__name__}": max(rel_rms(c, w) for c, w in zip(heads, want))
        for i, heads in controls.items()}
    return (all(bool(torch.isfinite(d).all()) for d in dev_heads)
            and max(out["head_rel_rms_err"]) <= bf16_rtol
            and max(out["f32_head_rel_rms_err"]) <= FAMILY_F32_HEAD_RTOL
            and min(out["control_swapped_concat_worst_head"].values()) > bf16_rtol)


def int8_gate(pred, plan, x1, out) -> bool:
    """The int8 forward on the card against the port's int8 CPU forward of
    the same qparams: the s8 trunk codes each head reads (main_int8's gate)
    and the raw heads (cosine)."""
    from yolo_for_turbines_tpu_torch.models.convert import qparams_from_numpy
    from yolo_for_turbines_tpu_torch.models.quantize import apply_inference_int8

    kw = {"activation": pred.model.cfg.activation, "raw_heads": True}
    dev_trunk, cpu_trunk = [], []
    with torch.inference_mode():
        dev_heads = apply_inference_int8(plan, pred._qparams, x1, compute_dtype=pred.compute_dtype,
                                         packed=pred._packed, head_inputs=dev_trunk, **kw)
        cpu_heads = apply_inference_int8(plan, qparams_from_numpy(plan, pred._qparams, "cpu"),
                                         x1.cpu(), compute_dtype=torch.float32,
                                         head_inputs=cpu_trunk, **kw)
    out["trunk_codes_frac_differing"] = [
        float((d.cpu() != c).float().mean()) for dt, ct in zip(dev_trunk, cpu_trunk)
        for d, c in zip(dt, ct)]
    out["head_cos_card_vs_cpu_int8"] = [cosine(d.float().cpu(), c)
                                        for d, c in zip(dev_heads, cpu_heads)]
    return (len(dev_trunk) == len(pred.model.strides)
            and max(out["trunk_codes_frac_differing"]) <= INT8_TRUNK_MAX_FRAC
            and min(out["head_cos_card_vs_cpu_int8"]) > INT8_HEAD_COS)


def family_inputs(dev, sizes):
    rng = np.random.default_rng(SEED + 20)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((480, 640), (300, 500), (416, 416), (720, 400))]
    n = FAMILIES_SIZE
    batches = {b: torch.from_numpy(rng.uniform(size=(b, n, n, 3)).astype(np.float32)).to(dev)
               for b in sizes}
    calib = rng.uniform(size=(8, n, n, 3)).astype(np.float32)
    return images, batches, calib


def families_csp_serving(dev, ok):
    """CSPDarknet-53, 80 classes, a seeded trainable model with calibrated
    BN statistics, folded: bf16 at B = 8 and 128, int8 at B = 128."""
    from yolo_for_turbines_tpu_torch.config import ModelConfig
    from yolo_for_turbines_tpu_torch.inference import Predictor
    from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan

    model_cfg = ModelConfig(backbone="cspdarknet53")
    plan = build_plan(model_cfg)
    # calibrated BN statistics, as tiny's (see the head gates' readings)
    trainable = eval_model(dev, model_cfg, FAMILIES_SIZE)
    tree = trainable.eval().fold()
    del trainable
    images, batches, calib = family_inputs(dev, (8, 128))
    x1 = batches[8][:1]
    out = {"phase": "families", "model": f"cspdarknet53 yolov3, 80 classes, {FAMILIES_SIZE}px, bf16"}
    pred = Predictor.from_folded(model_cfg, tree, device=dev, image_size=FAMILIES_SIZE)
    ok["csp_bf16_launches"] = family_path(pred, images, batches, out)
    ok["csp_heads"] = heads_gate(pred, tree, x1, out, CSP_BF16_HEAD_RTOL)
    emit(out)
    out8 = {"phase": "families", "model": f"cspdarknet53 yolov3, 80 classes, {FAMILIES_SIZE}px, "
            "int8 PTQ (bf16 heads)", "calibration_images": len(calib)}
    pred.quantize(calib)
    ok["csp_int8_launches"] = family_path(pred, images, {128: batches[128]}, out8)
    ok["csp_int8_vs_cpu"] = int8_gate(pred, plan, x1, out8)
    emit(out8)
    return {"families_csp_bf16": out["launches"], "families_csp_int8": out8["launches"]}


def families_tiny_serving(dev, ok):
    """YOLOv3-tiny, 80 classes: a darknet file written by the port from a
    seeded trainable model with calibrated BN statistics, served by
    load_predictor in bf16 at B = 1, 8 and 128 and in int8 at B = 128."""
    from yolo_for_turbines_tpu_torch import config as cfg
    from yolo_for_turbines_tpu_torch.inference import load_predictor
    from yolo_for_turbines_tpu_torch.models.convert import trainable_to_numpy
    from yolo_for_turbines_tpu_torch.models.darknet_weights import export_darknet_weights

    model_cfg = cfg.ModelConfig(backbone="yolov3_tiny", strides=(32, 16))
    trainable = eval_model(dev, model_cfg, FAMILIES_SIZE)
    path = FAMILIES_DIR / "yolov3-tiny.weights"
    path.parent.mkdir(parents=True, exist_ok=True)
    export_darknet_weights(trainable.plan, *trainable_to_numpy(trainable), str(path))
    floats = (path.stat().st_size - 20) // 4
    pred = load_predictor(path, backbone="yolov3_tiny", anchors=cfg.TINY_ANCHORS,
                          image_size=FAMILIES_SIZE, device=dev)
    images, batches, calib = family_inputs(dev, (1, 8, 128))
    x1 = batches[8][:1]
    out = {"phase": "families", "model": f"yolov3_tiny, 80 classes, {FAMILIES_SIZE}px, bf16, "
           "load_predictor of a port-written darknet file", "weight_file_floats": floats,
           "candidates_per_image": 3 * ((FAMILIES_SIZE // 32) ** 2 + (FAMILIES_SIZE // 16) ** 2)}
    ok["tiny_file_floats"] = floats == TINY_FLOATS
    ok["tiny_bf16_launches"] = family_path(pred, images, batches, out)
    ok["tiny_heads"] = heads_gate(pred, pred._folded_input, x1, out, HEAD_RTOL)
    emit(out)
    out8 = {"phase": "families", "model": f"yolov3_tiny, 80 classes, {FAMILIES_SIZE}px, int8 PTQ "
            "(bf16 heads)", "calibration_images": len(calib)}
    pred.quantize(calib)
    ok["tiny_int8_launches"] = family_path(pred, images, {128: batches[128]}, out8)
    ok["tiny_int8_vs_cpu"] = int8_gate(pred, pred.model.plan, x1, out8)
    emit(out8)
    return {"families_tiny_bf16": out["launches"], "families_tiny_int8": out8["launches"]}


def families_training(dev, ok):
    """CSPDarknet-53, 2 classes, mish: the f32 card step against the CPU
    step, bf16 Trainer steps at B = 32 (times, peak memory, the profile of
    one step), a fused eval
    step, the trained state's checkpoint served by
    load_predictor_from_checkpoint; one bf16 tiny train step and eval step."""
    import copy

    from yolo_for_turbines_tpu_torch import config as cfg
    from yolo_for_turbines_tpu_torch.inference import Predictor, load_predictor_from_checkpoint
    from yolo_for_turbines_tpu_torch.tools.profile_serving import profile_train_step, train_batch
    from yolo_for_turbines_tpu_torch.train.checkpoint import save_checkpoint
    from yolo_for_turbines_tpu_torch.train.evaluate import make_fused_eval_step
    from yolo_for_turbines_tpu_torch.train.trainer import Trainer

    csp_cfg = cfg.ModelConfig(num_classes=cfg.NUM_TURBINE_CLASSES, activation="mish",
                              backbone="cspdarknet53")
    out = {"phase": "families", "model": "cspdarknet53 yolov3, 2 classes, mish, trainable; "
           "yolov3_tiny, 2 classes, mish",
           "loss_rtol": CSP_TRAIN_LOSS_RTOL, "update_rtol": TRAIN_UPDATE_RTOL,
           "stats_rtol": TRAIN_STATS_RTOL}
    ok["csp_f32_card_vs_cpu"] = train_f32_check(dev, csp_cfg, out, CSP_TRAIN_LOSS_RTOL)
    ok["csp_tf32_control_above_loss_gate"] = (max(out["tf32_control_loss_rel_err"].values())
                                              > CSP_TRAIN_LOSS_RTOL)

    batch, size = 32, FAMILIES_SIZE
    # lr 1e-4, no warmup, 20 steps on one batch. At the default 1e-3 the
    # loss ended at NaN in one of six runs of this script, which also failed
    # the checkpoint-predictor equality on NaN weights; 5e-4 is the JAX
    # package's stable CSP rate with warmup (benchmarks/RESULTS.md:800-823).
    # tools/train_stability.py (--what steps --backbone cspdarknet53, 5
    # processes, an H100; cuDNN's algorithms vary between processes), the
    # largest loss after step 5: at 5e-4 6.9-7.7, at 2.5e-4 5.8-6.1 and
    # 22.2 in one, at 1e-4 6.2-6.9
    tc = cfg.TrainConfig(batch_size=batch, warmup_enabled=False, lr=1e-4)
    trainer = Trainer(tc, csp_cfg, device=dev)
    t0 = time.perf_counter()
    trainer.prewarm(sizes=(size,))
    out[f"prewarm_{size}_s"] = time.perf_counter() - t0
    x, targets = train_batch(batch, size, dev, seed=SEED + 22)
    anchors = trainer._anchors(size)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(trainer.train_step(trainer.state, x, targets, anchors)["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    losses = torch.stack(losses).tolist()
    out[f"bf16_B32_{size}"] = {"step_ms": ms, "images_per_s": batch * 1e3 / ms,
                           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "loss_first": losses[0], "loss_last": losses[-1]}
    ok["csp_bf16_steps_finite"] = all(np.isfinite(losses))
    out["profile_bf16_B32"], _ = profile_train_step(trainer, x, targets, iters=3, warmup=2, top=8)

    # one fused eval step (bf16): K1 once
    zero_counts()
    make_fused_eval_step(trainer.model)(x[:8], [t[:8] for t in targets], cfg.TURBINE_ANCHORS)
    torch.cuda.synchronize()
    out["eval_step_launches"] = kernel_counts()

    # the trained state through a checkpoint, served
    ckpt = FAMILIES_DIR / "csp.ckpt"
    save_checkpoint(trainer.state, ckpt)
    zero_counts()
    loaded = load_predictor_from_checkpoint(ckpt, backbone="cspdarknet53", image_size=size,
                                            device=dev)
    # folded on the CPU, as the loader folds
    host = copy.deepcopy(trainer.model).to("cpu", memory_format=torch.contiguous_format)
    want = Predictor.from_folded(csp_cfg, host.eval().fold(), device=dev, image_size=size,
                                 anchors=cfg.TURBINE_ANCHORS)
    (kl, ml), (kw, mw) = loaded.predict_batch(x[:8]), want.predict_batch(x[:8])
    torch.cuda.synchronize()
    out["checkpoint_predictor_launches"] = kernel_counts()
    out["checkpoint_predictor_survivors"] = int(ml.sum())
    ok["csp_checkpoint_predictor_equal"] = bool(torch.equal(kl, kw) and torch.equal(ml, mw))
    del trainer, loaded, want, host
    torch.cuda.empty_cache()

    # tiny: one bf16 train step and one eval step at B = 32
    tiny_cfg = cfg.ModelConfig(num_classes=cfg.NUM_TURBINE_CLASSES, activation="mish",
                               backbone="yolov3_tiny", strides=(32, 16))
    tiny = Trainer(tc, tiny_cfg, anchors=cfg.TINY_ANCHORS, device=dev)
    x, targets = train_batch(batch, size, dev, strides=(32, 16), seed=SEED + 23,
                             anchors=cfg.TINY_ANCHORS)
    metrics = tiny.train_step(tiny.state, x, targets, tiny._anchors(size))
    out["tiny_bf16_B32_losses"] = {k: float(v) for k, v in metrics.items()}
    ok["tiny_bf16_step_finite"] = all(np.isfinite(list(out["tiny_bf16_B32_losses"].values())))
    zero_counts()
    make_fused_eval_step(tiny.model)(x, targets, cfg.TINY_ANCHORS)
    torch.cuda.synchronize()
    out["tiny_eval_step_launches"] = kernel_counts()
    one_k1 = {"greedy_nms": 1, "fused_residual_stage": 0, "fused_residual_stage_int8": 0,
              "pairwise_iou": 0}
    ok["eval_steps_launch_k1_once"] = (out["eval_step_launches"] == one_k1
                                       and out["tiny_eval_step_launches"] == one_k1)
    emit(out)
    return {"families_csp_eval": out["eval_step_launches"],
            "families_csp_checkpoint_predictors": out["checkpoint_predictor_launches"],
            "families_tiny_eval": out["tiny_eval_step_launches"]}


def phase_families(dev):
    """CSPDarknet-53 and YOLOv3-tiny served, evaluated and trained at full
    width. Returns the launch counts of each path (K1, K2, K4)."""
    import shutil

    ok = {}
    shutil.rmtree(FAMILIES_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        paths = {**families_csp_serving(dev, ok), **families_tiny_serving(dev, ok)}
        paths.update(families_training(dev, ok))
    finally:
        shutil.rmtree(FAMILIES_DIR, ignore_errors=True)
    emit({"phase": "families", "ok": ok, "seconds": time.perf_counter() - t0})
    require(all(ok.values()), f"families phase failed: {ok}")
    return paths


# deploy phase: the bundle writer, the export CLI, the live and the exported
# predictor, the demo. The 80-class Darknet-53 of phase eval's weights
# (eval_model) as a darknet file written by the port, 416px.
DEPLOY_DIR = TRAIN_DIR / "deploy"
DEPLOY_BATCHES = (8, 128)
DEPLOY_CALIB_IMAGES = 8
# The exported program (the plain layer path, the plain NMS sweep) against
# the live predictor of the same bundle built with fuse_resblocks=False and
# run with its convs' epilogues on separate ops (plain_epilogues: the same
# layer path, K1 for the sweep): keep masks equal and boxes within
# EXPORT_BOX_ATOL. Both read bit for bit equal, bf16 and int8, at B = 8 and
# 128 (an H100): the same aten ops on the same weights, memory formats and
# cuDNN choices. The exported program against the live predictor with its
# kernels is printed beside it, not gated: K2 sums in another order, K5
# rounds once where the separate ops round up to three times, and
# K4's epilogue multiplies by reciprocal scales where the layer path
# divides, which moves a requant code at a .5 tie (0.4-0.9% of keep-mask
# entries differ at B = 128).
EXPORT_BOX_ATOL = 0.0
# an exported program holds the program, not the weights: its file is at
# most this share of the bundle's folded.npz
EXPORT_MAX_WEIGHT_SHARE = 0.05


def images_per_s(fn, x, iters: int) -> float:
    fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    torch.cuda.synchronize()
    return x.shape[0] * iters / (time.perf_counter() - t0)


def served_paths(live, ref, exported, control, batches, out):
    """One bundle's serving: the live predictor loaded from it against the
    predictor built in this process (``ref``), bit for bit, with its
    launches per ``predict_batch``; each exported program (no launch,
    outputs on the card) against ``control``; images/s of both. Returns
    the checks and the launches per call of the live and the exported
    predictor."""
    ok = {}
    launches, export_launches = [], []
    for b, x in batches.items():
        with pinned_cudnn():
            zero_counts()
            kl, ml = live.predict_batch(x)
            torch.cuda.synchronize()
            launches.append(kernel_counts())
            kr, mr = ref.predict_batch(x)
            ok[f"B{b}_live_equals_in_process"] = bool(torch.equal(kl, kr) and torch.equal(ml, mr))
            with plain_epilogues():
                kc, mc = control.predict_batch(x)
            zero_counts()
            ke, me = exported[b].predict_batch(x)
            torch.cuda.synchronize()
            export_launches.append(kernel_counts())
        ok[f"B{b}_export_on_card"] = ke.is_cuda and me.is_cuda
        ok[f"B{b}_export_masks_equal"] = bool(torch.equal(me, mc))
        err = float((ke - kc).abs().max())
        out[f"B{b}_export_box_max_abs_diff"] = err
        out[f"B{b}_export_bit_equal"] = bool(torch.equal(ke, kc) and torch.equal(me, mc))
        ok[f"B{b}_export_boxes"] = err <= EXPORT_BOX_ATOL
        # beside it, not gated: against the live predictor with its kernels
        out[f"B{b}_export_vs_live_masks_equal_share"] = float((me == ml).float().mean())
        out[f"B{b}_survivors"] = int(ml.sum())
        iters = 20 if b == 8 else 5
        out[f"B{b}_live_images_per_s"] = images_per_s(live.predict_batch, x, iters)
        out[f"B{b}_export_images_per_s"] = images_per_s(exported[b].predict_batch, x, iters)
    out["launches_per_predict_batch"] = launches
    out["export_launches_per_predict_batch"] = export_launches
    return ok, launches, export_launches


def calibration_images(folder: Path):
    from PIL import Image

    rng = np.random.default_rng(SEED + 30)
    folder.mkdir(parents=True, exist_ok=True)
    for i in range(DEPLOY_CALIB_IMAGES):
        Image.fromarray(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)).save(
            folder / f"calib_{i:03d}.jpg")
    return sorted(folder.iterdir())


def run_export_clis(args_by_kind) -> dict:
    """``python -m yolo_for_turbines_tpu_torch.tools.export`` once per
    argument list, all at once, each in a process of its own; their output
    goes to stderr. Returns each call's wall time; a failed call raises."""
    procs = {kind: subprocess.Popen(
        [sys.executable, "-m", "yolo_for_turbines_tpu_torch.tools.export", *args],
        cwd=Path(__file__).resolve().parent, stdout=sys.stderr, stderr=sys.stderr)
        for kind, args in args_by_kind.items()}
    t0, seconds = time.perf_counter(), {}
    try:
        while len(seconds) < len(procs):
            for kind, p in procs.items():
                if kind not in seconds and p.poll() is not None:
                    seconds[kind] = time.perf_counter() - t0
            time.sleep(0.2)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = {kind: p.returncode for kind, p in procs.items()}
    require(not any(codes.values()), f"tools.export failed: {codes}")
    return {f"{kind}_export_cli_s": v for kind, v in seconds.items()}


def phase_deploy(dev):
    """The deployment path: tools.export writes a bf16 and an int8 bundle
    (with exported programs at B = 8 and 128), load_predictor_bundle and
    ExportedPredictor serve them, tools.demo draws one image."""
    import contextlib as cl
    import io
    import re
    import shutil

    from PIL import Image

    from yolo_for_turbines_tpu_torch import config as cfg
    from yolo_for_turbines_tpu_torch import inference
    from yolo_for_turbines_tpu_torch.models.convert import trainable_to_numpy
    from yolo_for_turbines_tpu_torch.models.darknet_weights import export_darknet_weights
    from yolo_for_turbines_tpu_torch.serving import ExportedPredictor, load_predictor_bundle
    from yolo_for_turbines_tpu_torch.tools import demo

    model_cfg = cfg.ModelConfig()
    ok, paths = {}, {}
    t_phase = time.perf_counter()
    shutil.rmtree(DEPLOY_DIR, ignore_errors=True)
    try:
        trainable = eval_model(dev, model_cfg, 416)
        weights = DEPLOY_DIR / "yolov3.weights"
        weights.parent.mkdir(parents=True, exist_ok=True)
        export_darknet_weights(trainable.plan, *trainable_to_numpy(trainable), str(weights))
        del trainable
        calib_paths = calibration_images(DEPLOY_DIR / "calib")
        _, batches = serving_inputs(dev)
        export_args = [a for b in DEPLOY_BATCHES for a in ("--export-batch", str(b))]
        out = {"phase": "deploy", "model": "darknet53 yolov3, 80 classes, 416px, phase eval's "
               "weights as a darknet file", "gpu": gpu_line(), "export_box_atol": EXPORT_BOX_ATOL}
        # tools.export as a user runs it, the two bundles in two processes at once
        bundles = {kind: DEPLOY_DIR / f"bundle_{kind}" for kind in ("bf16", "int8")}
        calib_args = {"bf16": [], "int8": ["--quantize-calib-dir", str(calib_paths[0].parent)]}
        out.update(run_export_clis(
            {kind: ["--weights", str(weights), "--out", str(bundle), *export_args,
                    *calib_args[kind]] for kind, bundle in bundles.items()}))
        for kind, bundle in bundles.items():
            # the same predictor built in this process; the int8 one
            # calibrated with cuDNN as a fresh process has it
            ref = inference.load_predictor(weights, device=dev)
            if kind == "int8":
                imgs = [np.asarray(Image.open(p).convert("RGB")) for p in calib_paths]
                with fresh_cudnn():
                    ref.quantize(inference._letterbox_batch(imgs, ref.image_size, 0))
            t0 = time.perf_counter()
            live = load_predictor_bundle(bundle, dev)
            out[f"{kind}_bundle_load_s"] = time.perf_counter() - t0
            # the export's comparison: the live predictor of the same bundle
            # on the plain layer path (fuse_resblocks=False: no K2, and no
            # K4 operands packed); K1 still launches, bit-identical to the
            # plain sweep
            control = inference.Predictor.from_folded(
                dataclasses.replace(live.model.cfg, fuse_resblocks=False), live._folded_input,
                device=dev)
            if kind == "int8":
                control.set_qparams(live._qparams)
            t0 = time.perf_counter()
            exported = {b: ExportedPredictor(bundle, f"serve_b{b}_s416.pt2", device=dev)
                        for b in DEPLOY_BATCHES}
            out[f"{kind}_export_load_s"] = time.perf_counter() - t0
            weight_bytes = (bundle / "folded.npz").stat().st_size
            sizes = {p.name: p.stat().st_size for p in sorted((bundle / "exports").iterdir())}
            out[f"{kind}_pt2_bytes"], out[f"{kind}_folded_npz_bytes"] = sizes, weight_bytes
            ok[f"{kind}_pt2_holds_no_weights"] = max(sizes.values()) <= (
                EXPORT_MAX_WEIGHT_SHARE * weight_bytes)
            sub = {}
            checks, launches, export_launches = served_paths(live, ref, exported, control,
                                                             batches, sub)
            out[kind] = sub
            ok.update({f"{kind}_{k}": v for k, v in checks.items()})
            want = {"greedy_nms": 1, "fused_residual_stage": 8 if kind == "bf16" else 0,
                    "fused_residual_stage_int8": 8 if kind == "int8" else 0, "pairwise_iou": 0}
            ok[f"{kind}_launches"] = all(c == want for c in launches)
            ok[f"{kind}_export_launches_none"] = all(not any(c.values()) for c in export_launches)
            name = "deploy" if kind == "bf16" else "deploy_int8"
            paths[name] = {k: sum(c[k] for c in launches) for k in want}
            paths.setdefault("deploy_export", {k: 0 for k in want})
            for c in export_launches:
                for k in want:
                    paths["deploy_export"][k] += c[k]
            del live, ref, control, exported
            torch.cuda.empty_cache()

        # the demo CLI on one image: K1 exactly once, the PNG at the image's
        # size, the printed count equal to predict_image's
        image_path, png = calib_paths[0], DEPLOY_DIR / "demo.png"
        text = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with cl.redirect_stdout(text):
            demo.run_cli(["--weights", str(weights), "--image", str(image_path), "--out", str(png)])
        torch.cuda.synchronize()
        out["demo_s"] = time.perf_counter() - t0
        paths["demo"] = kernel_counts()
        printed = int(re.search(r"\((\d+) detections\)", text.getvalue()).group(1))
        image = np.array(Image.open(image_path).convert("RGB"), dtype=np.uint8)
        want_count = len(inference.load_predictor(weights, device=dev).predict_image(image))
        out["demo"] = {"launches": paths["demo"], "detections": printed,
                       "predict_image_detections": want_count,
                       "png_size": list(Image.open(png).size)}
        # predict_image is a bf16 predict_batch at B = 1: K1 once, K2 8 times
        ok["demo_k1_once"] = paths["demo"] == {"greedy_nms": 1, "fused_residual_stage": 8,
                                               "fused_residual_stage_int8": 0, "pairwise_iou": 0}
        ok["demo_png_size"] = Image.open(png).size == (image.shape[1], image.shape[0])
        ok["demo_count"] = printed == want_count
    finally:
        shutil.rmtree(DEPLOY_DIR, ignore_errors=True)
    out["ok"], out["seconds"] = ok, time.perf_counter() - t_phase
    emit(out)
    require(all(ok.values()), f"deploy phase failed: {ok}")
    return paths


# hpo phase: ASHA over the 2-class mish Darknet-53 that train() builds, at
# 416px without multi-scale, on the train phase's synthetic set (the same
# seed), with the anchors tools.anchors computes from its labels
HPO_DIR = TRAIN_DIR / "hpo"
HPO_LRS = (1e-4, 2e-4, 3e-4, 5e-4)


class CardTrainFn:
    """The HPO train function, recording after every rung the trial's
    config, epochs, device, card, process, K1 launches so far and wall time
    into ``log_dir`` (one JSON line per rung and process: the spawned
    workers' resume state never reaches the parent)."""

    def __init__(self, inner, log_dir):
        self.inner, self.log_dir = inner, str(log_dir)

    def __call__(self, config, num_epochs, resume_state):
        import os

        from yolo_for_turbines_tpu_torch.ops.kernels import nms_kernel

        t0 = time.perf_counter()
        score, state = self.inner(config, num_epochs, resume_state)
        trainer, epoch = state[0], state[3]
        dev = next(trainer.model.parameters()).device
        row = {"lr": config["lr"], "epochs": epoch, "added": num_epochs, "score": score,
               "device": str(dev), "card": torch.cuda.get_device_name(dev) if dev.type == "cuda"
               else None, "pid": os.getpid(), "k1_launches": nms_kernel.launches,
               "seconds": time.perf_counter() - t0}
        with open(Path(self.log_dir) / f"rungs_{os.getpid()}.jsonl", "a") as f:
            f.write(json.dumps(row) + "\n")
        return score, state


def phase_hpo(dev):
    """tools.anchors on the synthetic labels, then tune_model over
    make_hpo_train_fn: 4 trials in order (grace 1, max 4 epochs, 2
    brackets), then 2 trials in 2 spawned workers."""
    import shutil

    from yolo_for_turbines_tpu_torch import config as cfg
    from yolo_for_turbines_tpu_torch.data.loader import get_loaders
    from yolo_for_turbines_tpu_torch.data.splits import create_csv_files
    from yolo_for_turbines_tpu_torch.data.synthetic import generate_synthetic_dataset
    from yolo_for_turbines_tpu_torch.tools import anchors as anchors_cli
    from yolo_for_turbines_tpu_torch.train.hpo import (
        ASHAScheduler,
        GridSearch,
        load_config,
        tune_model,
    )
    from yolo_for_turbines_tpu_torch.train.trainer import make_hpo_train_fn

    ok = {}
    out = {"phase": "hpo", "model": "darknet53 yolov3, 2 classes, mish, trainable, 416px"}
    t_phase = time.perf_counter()
    shutil.rmtree(HPO_DIR, ignore_errors=True)
    try:
        root = generate_synthetic_dataset(HPO_DIR / "data", num_images=TRAIN_IMAGES, seed=SEED)
        create_csv_files(root / "images", root / "labels", root, {"train": 0.85, "val": 0.15},
                         image_ext=".jpg")
        anchors_json = HPO_DIR / "anchors.json"
        with contextlib.redirect_stdout(sys.stderr):
            anchors_cli.main(["--labels", str(root / "labels"), "--out", str(anchors_json)])
        payload = json.loads(anchors_json.read_text())
        anchors = np.asarray(payload["anchors"], np.float32)
        out["anchors"], out["anchors_mean_iou"] = payload["anchors"], payload["mean_iou"]
        ok["anchors_shape"] = anchors.shape == (3, 3, 2) and bool(np.isfinite(anchors).all())
        folders = {"image_folder": root / "images", "annotation_folder": root / "labels"}
        # the default warmup (1% of 10,000 steps) keeps the lr of these few
        # steps far below its peak: no trial diverges from scratch
        space = {"lr": GridSearch(HPO_LRS), "batch_size": 32, "multi_scale": False,
                 "image_size": 416, "max_num_steps": 10_000}
        val_batches = len(get_loaders(root, batch_size=32, anchors=anchors, num_workers=1,
                                      **folders)[1])
        out["val_batches"] = val_batches

        # in order, in this process
        logs = HPO_DIR / "logs"
        logs.mkdir(parents=True)
        fn = CardTrainFn(make_hpo_train_fn(root, HPO_DIR / "search", anchors=anchors,
                                           num_workers=8, device=dev, **folders), logs)
        sched = ASHAScheduler(grace_period=1, reduction_factor=2, brackets=2, max_t=4)
        zero_counts()
        t0 = time.perf_counter()
        best = tune_model(fn, space, num_samples=4, model_folder_path=HPO_DIR / "search",
                          grace_period=1, max_epochs=4, brackets=2, seed=SEED)
        torch.cuda.synchronize()
        out["search_s"] = time.perf_counter() - t0
        launches = kernel_counts()
        rows = [json.loads(line) for p in sorted(logs.iterdir()) for line in open(p)]
        per_trial = {}
        for r in rows:
            per_trial.setdefault(r["lr"], []).append(r)
        # trial i has HPO_LRS[i] (the grid's order) and bracket i % 2: its
        # epochs after each rung are that bracket's budgets, in order
        budgets = {}
        for i, lr in enumerate(HPO_LRS):
            ran = [r["epochs"] for r in per_trial.get(lr, [])]
            want = [sched.rung_budget(i % 2, r) for r in range(len(ran))]
            budgets[str(lr)] = {"epochs": ran, "budgets": want,
                                "seconds": sum(r["seconds"] for r in per_trial.get(lr, []))}
            ok[f"trial_{i}_epochs_are_rung_budgets"] = bool(ran) and ran == want
        rungs = len(rows)
        out["trials"], out["rungs"], out["launches"] = budgets, rungs, launches
        out["best"] = best
        ok["k1_per_val_batch_per_rung"] = (launches["greedy_nms"] >= val_batches * rungs
                                           and launches["fused_residual_stage"] == 0)
        ok["best_config_reads_back"] = load_config(HPO_DIR / "search",
                                                   "best_config.json") == best["config"]
        ok["trials_on_the_card"] = all(r["device"].startswith("cuda") for r in rows)

        # two trials in two spawned workers
        wlogs = HPO_DIR / "worker_logs"
        wlogs.mkdir(parents=True)
        wfn = CardTrainFn(make_hpo_train_fn(root, HPO_DIR / "workers", anchors=anchors,
                                            num_workers=4, device="cuda", **folders), wlogs)
        t0 = time.perf_counter()
        wbest = tune_model(wfn, {**space, "lr": GridSearch(HPO_LRS[:2])}, num_samples=2,
                           model_folder_path=HPO_DIR / "workers", grace_period=1, max_epochs=2,
                           brackets=2, seed=SEED, max_concurrent=2)
        out["workers_search_s"] = time.perf_counter() - t0
        wrows = [json.loads(line) for p in sorted(wlogs.iterdir()) for line in open(p)]
        out["workers"] = [{k: r[k] for k in ("lr", "epochs", "device", "card", "pid", "seconds",
                                             "k1_launches")} for r in wrows]
        ok["two_workers"] = len({r["pid"] for r in wrows}) == 2
        ok["workers_on_the_card"] = all(
            r["device"].startswith("cuda") and r["card"] == torch.cuda.get_device_name(0)
            and r["k1_launches"] >= val_batches for r in wrows)
        ok["workers_best_reads_back"] = load_config(HPO_DIR / "workers",
                                                    "best_config.json") == wbest["config"]
    finally:
        shutil.rmtree(HPO_DIR, ignore_errors=True)
    out["ok"], out["seconds"] = ok, time.perf_counter() - t_phase
    emit(out)
    require(all(ok.values()), f"hpo phase failed: {ok}")
    return {"hpo": launches}


PARALLEL_DIR = TRAIN_DIR / "parallel"
# two gloo ranks on the one card: DP serves B = PAR_DP_BATCH, half per rank;
# SP shards the rows of one image 2-way at each of PAR_SP_SIZES (832px: 26
# rows at the deepest grid, so every scale stays sharded; 416px: 13 rows,
# so the deepest grids are gathered)
PAR_DP_BATCH = 16
PAR_SP_SIZES = (832, 416)
# SP heads against the single-process forward, relative RMS per head, f32
# (TF32 off): the halo'd convs sum the same terms as the unsharded ones, in
# cuDNN's order for another input height
PAR_SP_HEAD_RTOL_F32 = 1e-4
# (B, px) of the bf16 predict_batch peak-memory sweep
PAR_MEMORY_POINTS = ((1, 416), (1, 832), (1, 1664), (1, 3328), (8, 1664))
# the DP train step at world size 1 against the plain step, float64 on the
# card: the updates' relative distance over all parameters (an exact
# gradient reads float64 rounding)
PAR_F64_UPDATE_RTOL = 1e-8
PAR_RANK_DEADLINE_S = 420


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def update_distance(after: dict, want: dict, before: dict) -> float:
    """Relative distance of two updates (new - old) over every parameter."""
    keys = [k for k in want if k in before]
    got = torch.cat([(after[k].double() - before[k].double()).flatten() for k in keys])
    ref = torch.cat([(want[k].double() - before[k].double()).flatten() for k in keys])
    return float((got - ref).norm() / ref.norm())


def dp_train_step_checks(dev, mesh, out) -> dict:
    """The DP train step at world size 1 (synced BN, global loss counts,
    the gradient all-reduce over NCCL) against the plain step from the same
    weights: float32 at B = 8 within the train phase's gates, float64 at B
    = 2 within PAR_F64_UPDATE_RTOL, and the bf16 steps at B = 32 timed in
    turns (plain, DP, DP, plain)."""
    import copy

    from yolo_for_turbines_tpu_torch import config as cfg
    from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3
    from yolo_for_turbines_tpu_torch.tools.profile_serving import train_batch
    from yolo_for_turbines_tpu_torch.train import steps

    ok = {}
    base = YOLOv3(cfg.ModelConfig(num_classes=2, activation="mish"),
                  generator=torch.Generator().manual_seed(SEED + 7))
    anchors = torch.from_numpy(cfg.scaled_anchors_array(cfg.TURBINE_ANCHORS, 416)).to(dev)
    before = {k: v.clone() for k, v in base.state_dict().items()}
    params = {n for n, _ in base.named_parameters()}

    def one(dtype, batch, step_mesh):
        model = copy.deepcopy(base).to(dev, dtype, memory_format=torch.channels_last)
        tc = cfg.TrainConfig(lr=1e-2, warmup_enabled=False, compute_dtype="float32")
        state = steps.create_train_state(model, tc)
        x, targets = train_batch(batch, 416, dev, seed=SEED + 8)
        with tf32_on():  # the step must turn it off
            m = steps.make_train_step(tc, step_mesh)(state, x.to(dtype), targets, anchors)
        return ({k: float(v) for k, v in m.items()},
                {k: v.detach().cpu() for k, v in model.state_dict().items()})

    with pinned_cudnn():
        (m_p, s_p), (m_d, s_d) = one(torch.float32, 8, None), one(torch.float32, 8, mesh)
        out["f32_B8_loss_rel_err"] = {k: abs(m_d[k] - m_p[k]) / abs(m_p[k]) for k in m_p}
        upd = {k: s_d[k].double() - before[k].double() for k in params}
        upd_p = {k: s_p[k].double() - before[k].double() for k in params}
        out["f32_B8_update_rel_rms_worst"] = leaf_rel_rms(upd, upd_p)
        stats = {k: v for k, v in s_d.items() if k.endswith(("running_mean", "running_var"))}
        out["f32_B8_stats_rel_rms_worst"] = leaf_rel_rms(stats, {k: s_p[k] for k in stats})
        ok["dp_f32_step_as_plain"] = (max(out["f32_B8_loss_rel_err"].values()) <= TRAIN_LOSS_RTOL
                                      and out["f32_B8_update_rel_rms_worst"][0] <= TRAIN_UPDATE_RTOL
                                      and out["f32_B8_stats_rel_rms_worst"][0] <= TRAIN_STATS_RTOL)
        (_, s64_p), (_, s64_d) = one(torch.float64, 2, None), one(torch.float64, 2, mesh)
        out["f64_B2_update_distance"] = update_distance(
            {k: s64_d[k] for k in params}, {k: s64_p[k] for k in params}, before)
        ok["dp_f64_step_as_plain"] = out["f64_B2_update_distance"] <= PAR_F64_UPDATE_RTOL

    # bf16 autocast at B = 32: time of the DP wrapper at world size 1
    tc = cfg.TrainConfig(lr=1e-4, warmup_enabled=False)
    x, targets = train_batch(32, 416, dev, seed=SEED + 9)
    runs = {}
    for name, step_mesh in (("plain", None), ("dp", mesh)):
        model = copy.deepcopy(base).to(dev, memory_format=torch.channels_last)
        state = steps.create_train_state(model, tc)
        step = steps.make_train_step(tc, step_mesh)
        runs[name] = (state, step)
        for _ in range(3):  # warm up
            step(state, x, targets, anchors)

    def timed(name):
        state, step = runs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [step(state, x, targets, anchors)["loss"] for _ in range(10)]
        torch.cuda.synchronize()
        ok[f"bf16_{name}_losses_finite"] = bool(torch.isfinite(torch.stack(losses)).all())
        return (time.perf_counter() - t0) * 1e3 / 10

    p1, d1, d2, p2 = timed("plain"), timed("dp"), timed("dp"), timed("plain")
    out["bf16_B32_step_ms"] = {"plain": [p1, p2], "dp_world1": [d1, d2]}
    return ok


def parallel_world_one(dev, out) -> dict:
    """World size 1 over NCCL in this process: the DP predictor (bf16 at B
    = 8 and 128, int8 at 128) bit for bit as the plain one, K1 once and K2
    or K4 8 times per call; the DP train step."""
    import torch.distributed as dist

    from yolo_for_turbines_tpu_torch.inference import Predictor
    from yolo_for_turbines_tpu_torch.parallel.mesh import create_mesh

    ok = {}
    launches = {k: 0 for k in kernel_counts()}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1)
    try:
        mesh = create_mesh(device=dev)
        out["backend"] = dist.get_backend(mesh.group)
        model_cfg, _, tree = full_model()
        _, batches = serving_inputs(dev)
        calib = np.random.default_rng(SEED + 1).uniform(size=(8, 416, 416, 3)).astype(np.float32)
        with pinned_cudnn():
            plain = Predictor.from_folded(model_cfg, tree, device=dev)
            dp = Predictor.from_folded(model_cfg, tree, mesh=mesh)
            for kind in ("bf16", "int8"):
                if kind == "int8":
                    plain.quantize(calib)
                    dp.quantize(calib)
                for b, x in batches.items():
                    if kind == "int8" and b != 128:
                        continue
                    want = plain.predict_batch(x)
                    zero_counts()
                    got = dp.predict_batch(x)
                    torch.cuda.synchronize()
                    counts = kernel_counts()
                    for k, v in counts.items():
                        launches[k] += v
                    fused = "fused_residual_stage" + ("_int8" if kind == "int8" else "")
                    out[f"{kind}_B{b}_launches"] = counts
                    ok[f"dp_{kind}_B{b}_bit_for_bit"] = (torch.equal(got[0], want[0])
                                                         and torch.equal(got[1], want[1]))
                    ok[f"dp_{kind}_B{b}_launches"] = (counts["greedy_nms"] == 1
                                                      and counts[fused] == 8)
        del plain, dp
        torch.cuda.empty_cache()
        ok.update(dp_train_step_checks(dev, mesh, out))
    finally:
        dist.destroy_process_group()
    return ok, launches


def parallel_rank(rank: int, world: int, port: int, device: str, results) -> None:
    """One of two gloo ranks on the one card (spawned): the DP predictor
    at B = PAR_DP_BATCH, its rows bit for bit as the single-process
    predictor's on the same images, with its kernel launches; the SP
    forward and predictor at PAR_SP_SIZES (no kernel may launch)."""
    import datetime

    import torch.distributed as dist

    try:
        from yolo_for_turbines_tpu_torch.inference import Predictor
        from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy
        from yolo_for_turbines_tpu_torch.ops import kernels
        from yolo_for_turbines_tpu_torch.parallel.mesh import create_mesh
        from yolo_for_turbines_tpu_torch.parallel.spatial import (
            Layout,
            create_spatial_mesh,
            spatial_image_sharding,
        )

        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kernels.load_library()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=180))
        res = {"rank": rank, "ok": {}}
        model_cfg, plan, tree = full_model()
        rng = np.random.default_rng(SEED + 21)
        x = torch.from_numpy(rng.uniform(size=(PAR_DP_BATCH, 416, 416, 3)).astype(np.float32))
        mine = slice(rank * PAR_DP_BATCH // world, (rank + 1) * PAR_DP_BATCH // world)
        with pinned_cudnn():
            mesh = create_mesh(device=dev)
            plain = Predictor.from_folded(model_cfg, tree, device=dev)
            dp = Predictor.from_folded(model_cfg, tree, mesh=mesh)
            want = plain.predict_batch(x[mine].to(dev))
            zero_counts()
            got = dp.predict_batch(x.to(dev))
            torch.cuda.synchronize()
            res["dp_launches"] = kernel_counts()
            res["ok"]["dp_whole_batch_on_every_rank"] = tuple(got[0].shape) == (PAR_DP_BATCH, K, 6)
            res["ok"]["dp_rows_bit_for_bit"] = (torch.equal(got[0][mine], want[0])
                                               and torch.equal(got[1][mine], want[1]))
            res["ok"]["dp_launches"] = (res["dp_launches"]["greedy_nms"] == 1
                                        and res["dp_launches"]["fused_residual_stage"] == 8)
            del plain, dp

            sp_mesh = create_spatial_mesh(n_space=world, device=dev)
            layout = Layout(sp_mesh)
            f32 = folded_from_numpy(plan, tree, model_cfg).to(
                dev, memory_format=torch.channels_last).eval()
            bf16 = folded_from_numpy(plan, tree, model_cfg).to(
                dev, torch.bfloat16, memory_format=torch.channels_last).eval()
            bf16.fuse_resblocks = False
            sp_pred = Predictor.from_folded(model_cfg, tree, mesh=sp_mesh,
                                            compute_dtype=torch.float32)
            # int8 under SP (the layer path with halos of s8 codes) against
            # the plain int8 layer path on the same qparams
            calib = np.random.default_rng(SEED + 1).uniform(
                size=(8, 416, 416, 3)).astype(np.float32)
            sp8 = Predictor.from_folded(model_cfg, tree, mesh=sp_mesh)
            sp8.quantize(calib)
            ref8 = Predictor.from_folded(dataclasses.replace(model_cfg, fuse_resblocks=False),
                                         tree, device=dev)
            ref8.set_qparams(sp8._qparams)
            res["sp"], res["sp_launches"] = {}, {k: 0 for k in kernel_counts()}
            for size in PAR_SP_SIZES:
                img = torch.from_numpy(rng.uniform(size=(1, size, size, 3)).astype(np.float32))
                shard = spatial_image_sharding(sp_mesh).place(img)
                r = {}
                with torch.inference_mode():
                    ref = f32(img.to(dev))
                    ref_int8 = ref8.raw_heads(img)
                    zero_counts()
                    heads = f32(shard, layout=layout)
                    heads16 = bf16(shard, layout=layout)
                    kept, mask = sp_pred.predict_batch(img)
                    heads8 = sp8.raw_heads(img)
                    kept8, _ = sp8.predict_batch(img)
                    torch.cuda.synchronize()
                    for k, v in kernel_counts().items():
                        res["sp_launches"][k] += v
                    r["f32_head_rel_rms"] = [rel_rms(h.float().cpu(), g.float().cpu())
                                             for h, g in zip(heads, ref)]
                    r["bf16_head_rel_rms"] = [rel_rms(h.float().cpu(), g.float().cpu())
                                              for h, g in zip(heads16, ref)]
                    r["int8_head_cos"] = [cosine(h.float().cpu(), g.float().cpu())
                                          for h, g in zip(heads8, ref_int8)]
                    r["int8_forward_ms"] = cuda_ms(lambda: sp8.raw_heads(img), 3)
                    r["f32_forward_ms"] = cuda_ms(lambda: f32(shard, layout=layout), 3)
                    r["bf16_forward_ms"] = cuda_ms(lambda: bf16(shard, layout=layout), 3)
                    r["plain_f32_forward_ms"] = cuda_ms(lambda: f32(img.to(dev)), 3)
                res["ok"][f"sp_{size}_f32_heads"] = max(r["f32_head_rel_rms"]) <= PAR_SP_HEAD_RTOL_F32
                res["ok"][f"sp_{size}_bf16_heads"] = max(r["bf16_head_rel_rms"]) <= HEAD_RTOL
                res["ok"][f"sp_{size}_predictor"] = (tuple(kept.shape) == (1, K, 6)
                                                     and bool(torch.isfinite(kept).all())
                                                     and mask.dtype == torch.bool)
                res["ok"][f"sp_{size}_int8"] = (min(r["int8_head_cos"]) >= INT8_HEAD_COS
                                                and tuple(kept8.shape) == (1, K, 6)
                                                and bool(torch.isfinite(kept8).all()))
                res["sp"][size] = r
            res["ok"]["sp_no_kernel"] = not any(res["sp_launches"].values())
        dist.destroy_process_group()
        results.put(res)
    except BaseException:
        import traceback

        results.put({"rank": rank, "error": traceback.format_exc()})


def parallel_two_ranks(out, device: str) -> tuple:
    """Spawn the two gloo ranks and collect their results; a rank that
    fails, or no result within PAR_RANK_DEADLINE_S, fails the phase."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=parallel_rank, args=(r, 2, port, device, results))
             for r in range(2)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + PAR_RANK_DEADLINE_S
    try:
        while len(got) < 2:
            try:
                r = results.get(timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"parallel ranks gave {len(got)} of 2 results in "
                                     f"{PAR_RANK_DEADLINE_S} s") from None
            if "error" in r:
                raise AssertionError(f"parallel rank {r['rank']} failed:\n{r['error']}")
            got[r["rank"]] = r
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    ok = {f"rank{r}_{k}": v for r in got for k, v in got[r]["ok"].items()}
    out["ranks"] = {r: {k: got[r][k] for k in ("dp_launches", "sp_launches", "sp")}
                    for r in got}
    dp = {k: sum(got[r]["dp_launches"][k] for r in got) for k in got[0]["dp_launches"]}
    sp = {k: sum(got[r]["sp_launches"][k] for r in got) for k in got[0]["sp_launches"]}
    return ok, dp, sp


def memory_sweep(dev, out) -> None:
    """Peak device memory of one bf16 predict_batch of the plain predictor
    at PAR_MEMORY_POINTS (B, px): where one card runs out, and SP becomes
    necessary, is extrapolated from these points."""
    from yolo_for_turbines_tpu_torch.inference import Predictor

    model_cfg, _, tree = full_model()
    pred = Predictor.from_folded(model_cfg, tree, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out["memory"] = {}
    for b, size in PAR_MEMORY_POINTS:
        x = torch.rand(b, size, size, 3, device=dev, generator=gen)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pred.predict_batch(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out["memory"][f"B{b}_{size}px"] = {"peak_gb": peak / 1e9,
                                           "above_resident_gb": (peak - resident) / 1e9}
        del x


def phase_parallel(dev):
    """DP and SP (parallel/): world size 1 over NCCL in this process, then
    two gloo ranks on the one card, then the memory sweep."""
    out = {"phase": "parallel", "model": "darknet53 yolov3, 80 classes (serving), 2 classes "
           "mish (train step)"}
    t_phase = time.perf_counter()
    ok, world1 = parallel_world_one(dev, out)
    t0 = time.perf_counter()
    ranks_ok, dp, sp = parallel_two_ranks(out, str(dev))
    out["two_ranks_s"] = time.perf_counter() - t0
    ok.update(ranks_ok)
    memory_sweep(dev, out)
    out["ok"], out["seconds"] = ok, time.perf_counter() - t_phase
    emit(out)
    require(all(ok.values()), f"parallel phase failed: {ok}")
    return {"parallel_dp": {k: world1[k] + dp[k] for k in dp}, "parallel_sp": sp}


# converge phase: R1 of tools/convergence.py, the JAX package's Darknet-53
# convergence recipe (lr 1e-3, 5% warmup then cosine, 550 steps, mosaic at
# 416px, B = 32, the 416-image synthetic set split 85 / 15), one seed in
# full, then its best checkpoint served. The JAX run reached a best val
# mAP@0.5 of 0.949; the port's three seeds 0.933-0.948 on an H100, where
# the served bf16 mAP read 0.0001-0.0048 off the trainer's
CONVERGE_DIR = TRAIN_DIR / "converge"
CONVERGE_SEED = 0
CONVERGE_MAP_BAR = 0.85
SERVED_MAP_TOL = 0.03


def phase_converge(dev):
    """R1 trained from scratch through train(), then served by
    load_predictor_from_checkpoint in bf16 and int8 on the val split."""
    import shutil

    from yolo_for_turbines_tpu_torch.tools import convergence as conv

    recipe = conv.R1
    out = {"phase": "converge", "recipe": dataclasses.asdict(recipe), "seed": CONVERGE_SEED,
           "map_bar": CONVERGE_MAP_BAR, "served_map_tol": SERVED_MAP_TOL}
    shutil.rmtree(CONVERGE_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        root = conv.make_set(CONVERGE_DIR / "data", recipe.num_images)
        out["synthetic_set_s"] = time.perf_counter() - t0
        maps = []
        zero_counts()
        run = conv.run_recipe(recipe, CONVERGE_SEED, root, CONVERGE_DIR / "models", dev,
                              report_callback=maps.append)
        torch.cuda.synchronize()
        train_launches = kernel_counts()
        serve = conv.serve_checkpoint(Path(run["checkpoint"]), root, recipe, dev)
        launches = kernel_counts()
    finally:
        shutil.rmtree(CONVERGE_DIR, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    out.update(run=run, train_launches=train_launches, serve=serve, launches=launches)
    bf16, int8 = serve["served_bf16"], serve["served_int8"]
    out["served_map_bf16"], out["served_map_int8"] = bf16["map"], int8["map"]
    evals = len(run["train_loss_by_epoch"]) // 10
    ok = {
        "no_nan_stop": not run["nan_stop"],
        "all_steps": run["steps"] == recipe.max_num_steps,
        "best_map_at_bar": run["best_map"] >= CONVERGE_MAP_BAR,
        "k1_per_val_batch_of_every_10th_epoch": (
            evals > 0 and len(maps) == len(run["map_trajectory"]) == evals
            and train_launches["greedy_nms"] >= evals * serve["val_batches"]
            and train_launches["fused_residual_stage"] == 0
            and train_launches["fused_residual_stage_int8"] == 0),
        "device_map_equals_host": abs(serve["trainer_map_device"]
                                      - serve["trainer_map_host"]) <= EVAL_MAP_TOL,
        "served_bf16_near_trainer": abs(bf16["map"] - serve["trainer_map_device"])
        <= SERVED_MAP_TOL,
        "int8_map_finite": bool(np.isfinite(int8["map"])),
        "served_launches": (
            bf16["launches_per_call"] == {"greedy_nms": 1, "fused_residual_stage": 8,
                                          "fused_residual_stage_int8": 0}
            and int8["launches_per_call"] == {"greedy_nms": 1, "fused_residual_stage": 0,
                                              "fused_residual_stage_int8": 8}
            and bf16["calls"] == int8["calls"] == serve["val_batches"] > 0),
    }
    out["ok"] = ok
    emit(out)
    require(all(ok.values()), f"converge phase failed: {ok}")
    return launches



# finetune phase: tools/convergence.py's fine-tune and high-resolution path
# at full width (the 2-class mish Darknet-53 train() builds), cut in depth:
# 96 images of R4's 1280x960 small-defect set, k-means anchors, a seeded
# backbone.conv.74 imported frozen, FINETUNE_STEPS steps of train() at
# B = 32 with multi-scale buckets (one new bucket per batch: 2 batches an
# epoch never reach the default's 10), at TRAIN_LR with half of them warmup
# as in phase train; the checkpoint resumed at 832px, B = 8, for
# FINETUNE_RESUME_STEPS steps (one epoch), evaluated at 416, 608 and 832
# and served at 416 (bf16 and int8) and 608 (bf16)
FINETUNE_DIR = TRAIN_DIR / "finetune"
FINETUNE_IMAGES = 96
FINETUNE_STEPS = 20
FINETUNE_RESUME_STEPS = 10
FINETUNE_SEED = 0


def frozen_step_check(dev, recipe, tc, root, anchors, weights_path) -> dict:
    """Two epochs (4 steps: the first at 1e-6 of the lr moves nothing) of a
    Trainer built as train() builds it, with the file imported frozen: on
    the live module every frozen parameter keeps the file's value bit for
    bit and every other one moves."""
    from yolo_for_turbines_tpu_torch.data.loader import get_loaders
    from yolo_for_turbines_tpu_torch.models.darknet_weights import load_darknet_into
    from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3
    from yolo_for_turbines_tpu_torch.tools import convergence as conv
    from yolo_for_turbines_tpu_torch.train.trainer import Trainer

    model_cfg = recipe.model_config()
    start = YOLOv3(model_cfg, generator=torch.Generator().manual_seed(tc.seed))
    frozen, _ = load_darknet_into(str(weights_path), start, freeze=True)
    trainer = Trainer(tc, model_cfg, anchors=anchors, weights_path=weights_path, device=dev)
    train_loader, _, train_ds = get_loaders(
        root, batch_size=tc.batch_size, anchors=anchors, num_workers=conv.NUM_WORKERS,
        mosaic=tc.mosaic, cache_images=tc.cache_images, image_size=tc.image_size,
        **conv.folders(root))

    class Rows:
        def log(self, d):
            pass

    for _ in range(2):
        trainer.train_one_epoch(train_ds, train_loader, Rows())
    live = {n: p.detach().cpu() for n, p in trainer.model.named_parameters()}
    before = dict(start.named_parameters())
    frozen_set = set(frozen)
    return {"frozen_count": len(frozen), "parameters": len(live), "steps": trainer.state.step,
            "optimizer_params": sum(len(g["params"])
                                    for g in trainer.state.optimizer.param_groups),
            "frozen_changed": [n for n in frozen if not torch.equal(live[n], before[n])],
            "unfrozen_unmoved": [n for n in live
                                 if n not in frozen_set and torch.equal(live[n], before[n])],
            "frozen_requiring_grad": [n for n, p in trainer.model.named_parameters()
                                      if n in frozen_set and p.requires_grad]}


def phase_finetune(dev):
    """The fine-tune and high-resolution path of tools/convergence.py on the
    card (module docstring)."""
    import shutil

    from yolo_for_turbines_tpu_torch.tools import convergence as conv

    recipe = dataclasses.replace(conv.R3F, name="finetune", num_images=FINETUNE_IMAGES,
                                 hires=True, eval_sizes=conv.R4.eval_sizes,
                                 finetune=conv.R4.finetune)
    overrides = dict(lr=TRAIN_LR, max_num_steps=FINETUNE_STEPS, warmup=0.5,
                     num_batch_to_resize=1)
    out = {"phase": "finetune", "recipe": recipe.name, "seed": FINETUNE_SEED,
           "overrides": overrides, "served_map_tol": SERVED_MAP_TOL,
           "head_rtol": HEAD_RTOL}
    shutil.rmtree(FINETUNE_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    ok = {}
    try:
        t0 = time.perf_counter()
        root = conv.make_set(FINETUNE_DIR / "data", recipe.num_images, hires=True)
        out["synthetic_set_s"] = time.perf_counter() - t0
        anchors, out["anchors"] = conv.run_anchors(recipe, root)
        weights_path = conv.write_backbone(root / conv.BACKBONE_FILE, recipe.model_config())
        tc = recipe.train_config(seed=FINETUNE_SEED, **overrides)
        out["live"] = live = frozen_step_check(dev, recipe, tc, root, anchors, weights_path)
        torch.cuda.empty_cache()

        maps = []
        models = FINETUNE_DIR / "models"
        zero_counts()
        run = conv.run_recipe(recipe, FINETUNE_SEED, root, models, dev,
                              report_callback=maps.append, anchors=anchors, **overrides)
        torch.cuda.synchronize()
        train_launches = kernel_counts()
        ckpt = Path(run["checkpoint"])
        # resumed at 832, B = 8, frozen as the base was
        zero_counts()
        ft = conv.run_finetune(recipe, FINETUNE_SEED, root, models, ckpt,
                               run["checkpoint_step"], FINETUNE_RESUME_STEPS, dev, anchors,
                               weights_path=weights_path, load_weights=True,
                               freeze_backbone=True)
        torch.cuda.synchronize()
        ft_launches = kernel_counts()
        torch.cuda.empty_cache()
        zero_counts()
        by_size = conv.map_by_size(ckpt, root, recipe, anchors, dev, recipe.eval_sizes)
        eval_launches = kernel_counts()
        zero_counts()
        serve416 = conv.serve_checkpoint(ckpt, root, recipe, dev, anchors=anchors,
                                         image_size=416, **overrides)
        serve608 = conv.serve_checkpoint(ckpt, root, recipe, dev, anchors=anchors,
                                         image_size=608, int8=False, **overrides)
        serve_launches = kernel_counts()
    finally:
        shutil.rmtree(FINETUNE_DIR, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    out.update(run=run, finetune=ft, map_by_size=by_size, serve_416=serve416,
               serve_608=serve608, train_launches=train_launches, ft_launches=ft_launches,
               eval_launches=eval_launches, serve_launches=serve_launches)
    out["first_resumed_lr"] = ft["first_resumed_lr"]
    frozen = run.get("frozen", {})
    ok["anchors_reach_assignment"] = (
        out["anchors"].get("anchor_assignment_diverges_from_default") is True
        and out["anchors"].get("anchor_assignment_spot_checks") == conv.ANCHOR_CHECK_FILES)
    ok["frozen_count_is_jax_mask"] = (live["frozen_count"] == frozen.get("frozen_count")
                                      == conv.FROZEN_CONV74)
    ok["frozen_out_of_sgd"] = (live["optimizer_params"]
                               == live["parameters"] - conv.FROZEN_CONV74
                               and not live["frozen_requiring_grad"])
    ok["live_frozen_bitwise_unfrozen_moved"] = (live["steps"] > 0
                                                and not live["frozen_changed"]
                                                and not live["unfrozen_unmoved"])
    ok["checkpoint_frozen_bitwise"] = frozen.get("frozen_bitwise_unchanged") is True
    ok["losses_finite"] = (not run["nan_stop"] and run["steps"] == FINETUNE_STEPS
                           and all(isinstance(v, float) and np.isfinite(v)
                                   for v in run["train_loss_by_epoch"]))
    ok["k1_at_the_fused_eval"] = (len(maps) == 1 and train_launches["greedy_nms"] >= 1
                                  and train_launches["fused_residual_stage"] == 0
                                  and train_launches["fused_residual_stage_int8"] == 0)
    ok["resumed_step_and_hyper"] = (
        ft["restored_step"] == run["checkpoint_step"]
        and ft["steps"] == FINETUNE_RESUME_STEPS
        and ft["lr_by_step_is_restored_schedule"] is True
        and ft.get("saved_hyper_is_restored") is True
        and not ft["nan_stop"])
    ok["device_map_equals_host_by_size"] = all(
        abs(v["device_map"] - v["host_map"]) <= EVAL_MAP_TOL for v in by_size.values())
    ok["k1_once_per_eval_step"] = (
        all(v["k1_launches"] == 2 * v["val_batches"] for v in by_size.values())
        and eval_launches["fused_residual_stage"] == eval_launches["fused_residual_stage_int8"]
        == 0)
    bf16, int8, bf16_608 = (serve416["served_bf16"], serve416["served_int8"],
                            serve608["served_bf16"])
    ok["served_launches"] = (
        bf16["launches_per_call"] == {"greedy_nms": 1, "fused_residual_stage": 8,
                                      "fused_residual_stage_int8": 0}
        and int8["launches_per_call"] == {"greedy_nms": 1, "fused_residual_stage": 0,
                                          "fused_residual_stage_int8": 8}
        and bf16_608["launches_per_call"] == {"greedy_nms": 1, "fused_residual_stage": 0,
                                              "fused_residual_stage_int8": 0})
    ok["served_bf16_near_trainer"] = all(
        abs(s["served_bf16"]["map"] - s["trainer_map_device"]) <= SERVED_MAP_TOL
        and abs(s["trainer_map_device"] - s["trainer_map_host"]) <= EVAL_MAP_TOL
        for s in (serve416, serve608))
    ok["bf16_heads_near_f32"] = all(s["heads_vs_f32"] <= HEAD_RTOL
                                    for s in (serve416, serve608))
    ok["int8_map_finite"] = bool(np.isfinite(int8["map"]))
    out["ok"] = ok
    emit(out)
    require(all(ok.values()), f"finetune phase failed: {ok}")
    return {k: train_launches[k] + ft_launches[k] + eval_launches[k] + serve_launches[k]
            for k in train_launches}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    from yolo_for_turbines_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "gpu": gpu,
          "device_count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    kernels.load_library()
    emit({"phase": "build", "nvcc_seconds": kernels.build_seconds,
          "load_seconds": time.perf_counter() - t0, "library": str(kernels.LIBRARY)})

    # the plain versions are exact f32 references: no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    k1 = phase_k1(dev, gen)
    k2 = phase_k2(dev, gen)
    k3 = phase_k3(dev, gen)
    k4 = phase_k4(dev, np.random.default_rng(SEED))
    k5 = phase_k5(dev)
    k6 = phase_k6(dev)
    k7 = phase_k7(dev)
    k8 = phase_k8(dev)
    launches, iou_main, bf16_rates, (x1, cpu_heads) = phase_main(dev)
    k5_yolov7, k8_yolov7 = phase_yolov7(dev)
    rtdetr = phase_rtdetr(dev)
    phase_k10(dev)
    launches_f32 = phase_main_f32(dev, x1, cpu_heads)
    launches_int8, iou_int8 = phase_main_int8(dev, bf16_rates)
    launches_eval, launches_fold = phase_eval(dev)
    launches_train = phase_train(dev)
    families = phase_families(dev)
    deploy = phase_deploy(dev)
    families.update(phase_hpo(dev))
    par = phase_parallel(dev)
    launches_conv = phase_converge(dev)
    launches_ft = phase_finetune(dev)
    nms_by_path = {"main": launches["greedy_nms"], "main_f32": launches_f32["greedy_nms"],
                   "main_int8": launches_int8["greedy_nms"], "eval": launches_eval["greedy_nms"],
                   "eval_fold": launches_fold["greedy_nms"], "train": launches_train["greedy_nms"],
                   **{k: v["greedy_nms"] for k, v in families.items()},
                   **{k: v["greedy_nms"] for k, v in deploy.items()},
                   **{k: v["greedy_nms"] for k, v in par.items()},
                   "converge": launches_conv["greedy_nms"],
                   "finetune": launches_ft["greedy_nms"]}
    iou_by_path = {"main": iou_main, "main_f32": launches_f32["pairwise_iou"],
                   "main_int8": iou_int8, "eval": launches_eval["pairwise_iou"],
                   "train": launches_train["pairwise_iou"],
                   **{k: v["pairwise_iou"] for k, v in families.items()},
                   **{k: v["pairwise_iou"] for k, v in deploy.items()},
                   **{k: v["pairwise_iou"] for k, v in par.items()},
                   "converge": launches_conv["pairwise_iou"],
                   "finetune": launches_ft["pairwise_iou"]}

    emit({"kernels": [
        {"name": "greedy_nms", "route": "cuda",
         "source": "yolo_for_turbines_tpu_torch/csrc/nms.cu",
         "replaces": "yolo_for_turbines_tpu/ops/pallas/nms_kernel.py:78",
         "launches": sum(nms_by_path.values()), "launches_by_path": nms_by_path, **k1},
        {"name": "fused_residual_stage", "route": "cuda",
         "source": "yolo_for_turbines_tpu_torch/csrc/resblock.cu",
         "replaces": "yolo_for_turbines_tpu/ops/pallas/resblock_kernel.py:100",
         "launches": launches["fused_residual_stage"],
         "launches_by_path": {"main": launches["fused_residual_stage"],
                              "main_f32": launches_f32["fused_residual_stage"],
                              "eval": launches_eval["fused_residual_stage"],
                              "eval_fold": launches_fold["fused_residual_stage"],
                              "train": launches_train["fused_residual_stage"],
                              **{k: v["fused_residual_stage"] for k, v in families.items()},
                              "deploy": deploy["deploy"]["fused_residual_stage"],
                              "demo": deploy["demo"]["fused_residual_stage"],
                              "deploy_export": deploy["deploy_export"]["fused_residual_stage"],
                              **{k: v["fused_residual_stage"] for k, v in par.items()},
                              "converge": launches_conv["fused_residual_stage"],
                              "finetune": launches_ft["fused_residual_stage"]},
         **k2},
        # no serving path calls K3, in the port as in the JAX package
        {"name": "pairwise_iou", "route": "cuda",
         "source": "yolo_for_turbines_tpu_torch/csrc/iou.cu",
         "replaces": "yolo_for_turbines_tpu/ops/pallas/iou_kernel.py:49",
         "launches": sum(iou_by_path.values()), "launches_by_path": iou_by_path,
         "on_a_serving_path": False, **k3},
        {"name": "fused_residual_stage_int8", "route": "cuda",
         "source": "yolo_for_turbines_tpu_torch/csrc/resblock_int8.cu",
         "replaces": "yolo_for_turbines_tpu/ops/pallas/resblock_int8_kernel.py:95",
         "launches": launches_int8["fused_residual_stage_int8"],
         "launches_by_path": {"main_int8": launches_int8["fused_residual_stage_int8"],
                              **{k: v["fused_residual_stage_int8"] for k, v in families.items()},
                              "deploy_int8": deploy["deploy_int8"]["fused_residual_stage_int8"],
                              "deploy_export":
                                  deploy["deploy_export"]["fused_residual_stage_int8"],
                              **{k: v["fused_residual_stage_int8"] for k, v in par.items()},
                              "converge": launches_conv["fused_residual_stage_int8"],
                              "finetune": launches_ft["fused_residual_stage_int8"]},
         **k4},
        # replaces no TPU kernel: XLA fused the epilogue into its conv
        {"name": "conv_epilogue", "route": "cuda",
         "source": "yolo_for_turbines_tpu_torch/csrc/epilogue.cu", "replaces": None,
         "launches_by_path": {"main_per_predict_batch": K5_PER_CALL,
                              "main_f32": launches_f32["conv_epilogue"],
                              "yolov7_per_predict_batch": k5_yolov7,
                              "rtdetr_per_predict_batch": rtdetr["conv_epilogue"]},
         **k5},
        # replaces no TPU kernel: XLA fused the int8 epilogue into its conv
        {"name": "int8_epilogue", "route": "cuda",
         "source": "yolo_for_turbines_tpu_torch/csrc/epilogue.cu", "replaces": None,
         "launches_by_path": {"main_int8_per_predict_batch": K6_PER_CALL},
         **k6},
        # replaces no TPU kernel: XLA ran the int8 convs as int32 convolutions
        {"name": "int8_conv", "route": "cuda",
         "source": "yolo_for_turbines_tpu_torch/csrc/conv_int8.cu", "replaces": None,
         "launches_by_path": {"main_int8_per_predict_batch": K7_PER_CALL},
         **k7},
        # replaces no TPU kernel: XLA fused the JAX package's reduce_window
        # pools with their neighbours
        {"name": "maxpool", "route": "cuda",
         "source": "yolo_for_turbines_tpu_torch/csrc/maxpool.cu", "replaces": None,
         "launches_by_path": {"yolov4_per_predict_batch": k8.pop("per_call")["yolov4"],
                              "yolov7_per_predict_batch": k8_yolov7,
                              "rtdetr_per_predict_batch": rtdetr["maxpool"]},
         **k8},
        # replaces no TPU kernel: the JAX package has no deformable attention
        {"name": "deform_attention", "route": "cuda",
         "source": "yolo_for_turbines_tpu_torch/csrc/deform.cu", "replaces": None,
         "launches_by_path": {"rtdetr_per_predict_batch": rtdetr["deform_attention"]}},
    ]})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
