#!/usr/bin/env python3
"""Drive the pcseg_tpu_torch port on one CUDA card and check it.

    python3 chip_smoke.py

1. Builds the CUDA kernels from pcseg_tpu_torch/csrc/ (nvcc, sm_90a, one
   process per source, all at once), then prints ptxas's registers, shared
   memory and spills of the tensor-core libraries (pointnet_wgmma.cu, row
   16; pointnet_chain.cu, rows 15 and 17; resample.cu, rows 4, 6, 7 and
   5; conv3d_dgrad.cu, rows 1, 2 and 3) and the HGMMA (wgmma) or HMMA
   (mma.sync) instructions in each of their tensor-core kernels' SASS
   (cuobjdump), failing if one has none.
2. Holds each conv kernel against its plain PyTorch version at every
   shape the voxel serving path launches (batch 8, 64^3 grid, widths
   16/32/64), and times kernel, plain version and one cuDNN call of the
   same convolution (a yardstick only: the port never calls it); the
   tensor-core kernels (the 3^3 conv, conv3d_dgrad.cu; the down and up
   blocks, resample.cu) also by device time, their cuDNN calls too, and
   two calls on the same inputs held bit for bit; every launch asserts
   the route it took; and one shape each off the 3^3 conv's and the up
   block's tensor-core routes (B8 8^3 x 32 with accum; B2 8^3 x 256 ->
   16^3 x 128), which keep conv3d_block.cu's CUDA-core kernels.
3. Serves the voxel U-Net at full width (64^3, w16, 3 levels, 4 classes,
   bf16, scatter voxelize, gather devoxelize, seeded random weights)
   through Predictor.predict_batch (16 events, 4000-8192 points: two
   forwards of 8 at bucket 8192) and Predictor.predict (one 1000-point
   event, bucket 1024). Checks that every kernel launched 13 / 2 / 2 times
   per forward and that the logits are finite and match the same model
   run through the plain versions on the card.
4. Holds each PointNet training kernel (fused_block, the global pool
   block, the classifier + CE, dropout), forward and backward, against
   its plain version at every shape one train step at B64 x 2048 points
   launches, and times kernel, plain version, bound and one bf16
   torch.matmul of the same product (a yardstick only); fused_block
   (seg1's shape with its row bias, on the split backward, and conv4's,
   on the one-sweep backward) at B63 x 1000 rows (batch boundaries inside
   the 128-row tiles, a partial last tile: N = 63,000) and the global
   pool block at 1000 rows a batch row; conv1 at input_dim 20 (K
   chunks), the logits layer and the classifier + CE at 40 classes (the
   wide tiles): the widths past the bench's that the JAX fused chain
   trains. Rows 15-17 print each kernel's device time beside the op's
   CUDA-event time, and row 15 its sums over the 8 launches of a step.
5. One whole fused PointNetSeg train step (full width, 4 classes,
   dropout 0.3, seeded random weights) with the kernels and with the
   plain versions, from the same state and seeds: loss, gradients and
   new batch_stats; the same at 40 classes and at input_dim 20, whose
   launch counts (8 + 8 fused_block, 1 + 1 fused_seg4_ce) show rows 15
   and 17 took those widths.
6. Trains PointNetSeg through api.fit on synthetic events (bucket 2048,
   batch 64, 4 train steps and one eval batch per epoch, 2 epochs), with
   bn_stats="fused" and "exact", and "fused" at 40 classes and at
   input_dim 20: launch counts per step, finite losses, ms per step,
   points/s, peak memory.
7. Holds each voxel U-Net backward kernel (the 3^3 dgrad and wgrad, the
   down and up backward, the trilinear scatter of the devoxelize VJP)
   against its plain version at every shape one B8 x 8192 train step at
   64^3/w16/L3 launches, and times kernel, plain version, bound and one
   PyTorch call of the same function (cuDNN's convolution_backward;
   yardsticks only); the trilinear scatter by device time (its binning,
   tile and long-tile kernels summed) beside its CUDA-event op time, with
   f32 and with the bf16 output the step runs, two calls held bit for bit
   and the bf16 output held to the f32 sums rounded once, against
   torch.zeros + index_add_ (the same function from scratch) and
   index_add_ alone; the tensor-core kernels (the 3^3 dgrad
   and wgrad, conv3d_dgrad.cu, by variant and level; the down and up
   backward, resample.cu, by shape) also by device time, their cuDNN
   calls too, and two calls held bit for bit; and the 3^3 dgrad and
   wgrad and the down backward at one shape each off their tensor-core
   routes (8^3 x 32, the 8^3 level of a grid-32 model; a width-64
   U-Net's 16^3 x 128 -> 8^3 x 256 down block), which keep the CUDA-core
   kernels of conv3d_block.cu: held the same way, with the tensor-core
   launch counts unmoved.
8. One whole voxel U-Net train step (seeded random weights, one batch of
   synthetic events) with the kernels (each kernel of the path launched
   as often as in a step of api.fit), with the plain versions, and in f32
   on the plain core: loss and gradients; and the kernel step again from
   the same weights and batch, whose loss difference is the run-to-run
   floor the float atomics left on the path leave.
9. Trains the voxel U-Net through api.fit (bucket 8192, batch 8, 3 train
   steps and one eval batch per epoch, 2 epochs): launch counts per step,
   finite losses, ms per step, points/s, peak memory; then serves the
   best checkpoint through Predictor on the card.
10. Holds each kernel of the voxel U-Net's default configuration (every
   impl left at "auto": the one-hot voxelize_contract and trilinear_gather
   and the fused head with its backward) against its plain version at the
   shapes of a B8 x 8192, 64^3 batch, with edge cases (points on the box
   faces, an all-masked row, a voxel hit by many points), and times
   kernel, plain version, bound and one PyTorch call of the same function
   (index_add_, grid_sample, bf16 matmuls; yardsticks only); the gather
   and voxelizer by device time (the voxelizer's yardstick torch.zeros +
   index_add_, the same function from scratch, beside index_add_ alone;
   the voxelizer held to one kernel a call, its table's zeros included),
   also at the sparse model's call site (tile-major ids of phase 13's
   track events, C1 2) and on ids uniform over the grid (C1 3);
   the trilinear scatter again on this batch,
   as phase 7 holds and times it, and the gather and the scatter at 33,
   40, 64 and 121 channels on a 32^3 grid (two calls bit for bit). The
   head also at the widths its repair opened (20 and 40 classes at 32^3
   x 16, C 128 -> 8 classes), both directions' two calls bit for bit.
11. Serves the default configuration as phase 3 serves the scatter/gather
   one: launch counts per forward, logits against the plain versions.
12. One default-configuration train step with the kernels, with the plain
   versions and in f32, held as phase 8; then api.fit with no impl
   override and Predictor on its checkpoint, held as phase 9.
12b. Serves VoxelUNet3d(20 and 40 classes, 32^3, width 16, 3 levels,
   bf16), which the JAX package routes through its fused grid2 head,
   through Predictor and trains each one step: the launches of rows 8, 9,
   10, 11 and 13, logits to LOGITS_REL and the loss to DEFAULT_LOSS_REL of
   the plain versions (at 40 classes the devoxelize runs past 32
   channels).
13. Holds the sparse family's two kernels (the raw block conv and the
   fused conv-bias + LayerNorm + ReLU + mask) against their plain versions
   at every serving shape of the JAX package's sparse bench configuration
   (SparseVoxelNet R64, width 64, depth 4, 2 levels, tile 8, tile
   capacities (64, 32), bf16, on B8 x 8192 track events) and at width 16
   in f32, and times kernel, plain version, bound and one PyTorch call of
   the same function (cuDNN's conv3d on the materialized halo,
   F.layer_norm; yardsticks only). Every bf16 t = 8 conv there takes the
   tensor-core route (its "_mma" launch count moves, one launch each) and
   two calls give the same bits.
14. Serves that model (seeded random weights) through Predictor as phase 3
   serves the voxel U-Net: 8 / 10 / 1 block_conv / bias_ln_relu_mask /
   voxelize_contract launches per forward (the 8 convs on the tensor-core
   route), no dropped tile, logits against the plain versions.
15. Holds the sparse family's training kernels (the LN backward, the block
   conv's dgrad and wgrad, rowcol_scatter) against their plain versions at
   every shape one B8 x 8192 train step of that configuration launches,
   and every kernel of the family, forward and backward, at the shapes its
   repair opened (LN at 256 and 24 channels, the conv at widths 8 and 24
   and at tile 16), and the conv's tensor-core routes at a partial K
   chunk and 96 outputs; the route of every conv launch and two calls bit
   for bit as in phase 13; times kernel, plain version, bound and one
   PyTorch call of the same function (cuDNN's convolution_backward on the
   materialized halo, native_layer_norm_backward, index_add_; yardsticks
   only). The LN backward also in f32 at level 0, each case's route
   (vector where C is a multiple of 8 up to 256) and two calls bit for
   bit.
16. One whole sparse train step (forward, loss, backward, Adam) with the
   kernels, with the plain versions and in f32: loss, every gradient and
   every Adam update.
17. Trains that model through api.fit (bucket 8192, batch 8, 3 train steps
   and one eval batch per epoch, 2 epochs, track events): launch counts
   per step (8 / 7 / 8 / 10 / 10 / 1 / 1 block_conv / dgrad / wgrad / LN /
   LN backward / voxelize_contract / rowcol_scatter; the convs all on the
   tensor-core routes, the LN backwards on the vector route), finite
   losses, no
   dropped tile, ms per step, points/s, peak memory; then serves the best
   checkpoint through Predictor on the card.
18. Holds the two kernels that no entry point reaches, in the JAX package
   as here (row 14, the segment scatter of point rows by voxel id, and row
   19, the BN-apply + ReLU + first-max global pool with its write-only
   backward), against their plain versions: the pool at the PointNet
   global layer's B64 x 2048 x 1024 bf16, the JAX test's B4 x 256 x 64 f32
   and with all-negative channels, tied rows, 1000 rows a group and 20
   channels (g, idx and every gradient bit for bit); the scatter at B8 x
   8192 x 4 into 64^3 and 2048 points into 16^3, with spill ids, a segment
   hit by every point of an event and ids outside the grid (no write
   outside the output). Times kernel, plain version, bound and one PyTorch
   call (torch.max over the activations, the reduction alone, and its
   backward value_selecting_reduction_backward; index_add_).
19. Serves PointNetSeg at full width (4 classes, seeded random weights
   and running statistics) through Predictor, folded in f32 (the
   default), folded in bf16 and unfolded: predict_batch on 16 events of
   4,000-8,192 points and predict on one 1,000-point event; finite logits
   on the card, folded f32 against unfolded, bf16 against f32 (its
   argmax agreement reported),
   an event alone against the same event in the batch, no kernel
   launched (the JAX package runs this path on XLA matmuls too); then the
   same weights as a reference best_model.pth through
   Predictor.from_checkpoint and inference_example, identical logits.
20. The voxel U-Net's 128^3 remat configuration (BASELINE config 3,
   experiments/bench_128_step.py: 4 classes, width 16, 3 levels, bf16,
   remat, every impl "auto", which at 128^3 is the scatter voxelizer, the
   gather devoxelize and the plain head1x1) on B1 x 16,384 points: (a)
   one train step with the kernels against the plain versions and f32,
   held as phase 8, and against the same kernel step without remat (held
   to phase 8's limits, the cause of any difference named: the levels
   whose convs run off the tensor-core route, and the scatter
   voxelizer's atomics), launches by row (rows 1, 4 and 6 twice the
   no-remat count, rows 2, 3, 5, 7 and 11 the same), the memory the step
   keeps after its forward and its peak, with remat and without, and
   each row's device ms in one profiled remat step beside its bound;
   (b) api.fit for 2 epochs of 3 steps with the metrics log and the
   profiler trace (the stages "voxelize", "core", "head", "devoxelize"
   and the kernels in it), and a fresh 1-epoch run resumed from its
   'latest' checkpoint for epoch 2, both epoch-2 train losses printed;
   (c) api.evaluate of the best checkpoint against that epoch's
   validation pass, and Predictor serving it; every path's launches held
   to the step's and the forward's counts. Then one 256^3 remat step
   (experiments/bench_256_step.py, B1 x 32,768) through the kernels:
   finite loss and gradients, launches by row, peak memory, and its loss
   and conv-kernel gradients against the plain versions.
21. The data on disk: (a) `python -m pcseg_tpu_torch.cli synth` writes
   10,000 events (the size of the reference's train_xyze_1e4.h5; the
   CLI's defaults, 100-2,000 points, 4 classes) with the port's HDF5
   writer, and the port's reader returns every event bit for bit as
   generated (write and read events/s); (b) `cli train` trains
   PointNetSeg at full width (fused, bf16, batch 64, 2 epochs of 125
   steps and 32 val batches, prefetch depth 2) from those files: rows
   15-17's launches a step held to phase 6's, finite losses; one train
   epoch of the prefetched device batches against the inline ones
   (torch.equal), the native packer's batches against numpy's byte for
   byte with its call counts, and one train epoch timed (then one
   profiled: idle share) at prefetch depth 0 and 2, packer on and off;
   (c) `cli eval` of the best checkpoint equal to its epoch's validation
   pass, `cli infer` of event 0 equal to Predictor.predict; (d) `cli
   train` of the default voxel U-Net (64^3/w16/L3 bf16, batch 8, bucket
   8192) for one epoch from a 512-event file, its launches a step and a
   forward held to phase 12's.
22. Prints the kernels as one JSON line, the card's name and power limit,
   and as the last line {"ok": true, "device": {...}}.

Exits non-zero, without the last line, when there is no CUDA device or
any phase fails.

    python3 chip_smoke.py --step-spread N

builds the kernels, repeats only the whole-step comparisons of phases 8,
12 and 16 N times, and prints each loss reading (phases 8 and 12 also
kernels against kernels) as one JSON line: the spread their loss limits
are set from. It holds nothing and prints no result.

    python3 chip_smoke.py --r128

builds the kernels and runs only phase 20, printing its readings as one
JSON line; no result line.

    python3 chip_smoke.py --files

builds the kernels and runs only phase 21, printing its readings as one
JSON line; no result line.

    python3 chip_smoke.py --pointnet

builds the kernels, prints phase 1's wgmma report and runs only phase 4's
PointNet cases of rows 15-17 (held as in phase 4, with each op's kernels
by device time and row 15's sums over a step), as one JSON line; no
result line.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12         # f32 outside the tensor cores
SOURCE = "pcseg_tpu_torch/csrc/conv3d_block.cu"
REPLACES = {
    "conv3x3_gn_act": "pcseg_tpu/ops/pallas/conv3d_block.py:429",
    "down2x_gn_act": "pcseg_tpu/ops/pallas/conv3d_block.py:1318",
    "up2x_gn_act": "pcseg_tpu/ops/pallas/conv3d_block.py:1403",
}
PER_FORWARD = {"conv3x3_gn_act": 13, "down2x_gn_act": 2, "up2x_gn_act": 2,
               "conv3x3_mma": 13, "down2x_mma": 2, "up2x_mma": 2}
# rows 4, 6, 7 and 5's kernels: the gathered GEMMs
RESAMPLE_SOURCE = "pcseg_tpu_torch/csrc/resample.cu"
# rows 1 and 2's implicit GEMM
DGRAD_SOURCE = "pcseg_tpu_torch/csrc/conv3d_dgrad.cu"
# the serving rows' sources: the tensor-core kernels their main shapes take
FWD_SOURCES = {"conv3x3_gn_act": DGRAD_SOURCE,
               "down2x_gn_act": RESAMPLE_SOURCE,
               "up2x_gn_act": RESAMPLE_SOURCE}
# the tensor-core kernels (rows 1, 4, 6, 7, 5, 2, 3) by the op key they
# count under and their own launch key
MMA_KEY = {"conv3x3_gn_act": "conv3x3_mma", "down2x_gn_act": "down2x_mma",
           "up2x_gn_act": "up2x_mma", "up2x_bwd": "up2x_bwd_mma",
           "down2x_bwd": "down2x_bwd_mma",
           "conv3x3_dgrad": "conv3x3_dgrad_mma",
           "conv3x3_wgrad": "conv3x3_wgrad_mma"}
# the default configuration (voxelize_impl / devox_impl "auto" -> the
# one-hot forms at 64^3) adds the voxelizer, the fused head and the gather
DEFAULT_PER_FORWARD = dict(PER_FORWARD, voxelize_contract=1, head_grid2=1,
                           trilinear_gather=1)
# tolerances, kernel vs plain version on identical inputs:
# y is bf16 from f32 sums taken in another order, so an element may round
# to the neighbouring bf16 value: |dy| <= 2^-7 |y| + 1e-4 max|y|.
Y_RTOL, Y_ATOL_REL = 2.0 ** -7, 1e-4
# stats are f32 sums of 10^5-10^6 terms in another order (and, off the
# tensor-core routes, with atomics): |ds| <= 1e-3 of the largest |s| of
# its (batch, sum|sumsq) row.
STATS_TOL = 1e-3
# end-to-end logits: a one-ulp bf16 flip (2^-8 relative) in an early
# layer's y propagates through the 17 layers after it, so the logits are
# held to a few bf16 ulps of their own scale, |d| <= 4 * 2^-8 * max|ref|,
# and the argmax may change only at near-ties (>= 99.9% agreement).
LOGITS_REL, ARGMAX_AGREE = 4 * 2.0 ** -8, 0.999

# PointNetSeg training: pcseg_tpu/bench.py's step, B64 x 2048 points,
# 4 classes, dropout 0.3, bf16
PN_SOURCE = "pcseg_tpu_torch/csrc/pointnet_fused.cu"
CHAIN_SOURCE = "pcseg_tpu_torch/csrc/pointnet_chain.cu"
PN_SOURCES = {"fused_block": CHAIN_SOURCE,
              "fused_global_pool_block": "pcseg_tpu_torch/csrc/"
                                         "pointnet_wgmma.cu",
              "fused_seg4_ce": CHAIN_SOURCE, "dropout": PN_SOURCE}
PN_REPLACES = {
    "fused_block": "pcseg_tpu/ops/pallas/fused_block.py:239",
    "fused_global_pool_block": "pcseg_tpu/ops/pallas/fused_global.py:176",
    "fused_seg4_ce": "pcseg_tpu/ops/pallas/fused_ce.py:264",
    "dropout": "pcseg_tpu/ops/pallas/dropout.py:52",
}
PN_B, PN_M, PN_CLASSES, PN_DROP = 64, 2048, 4, 0.3
# (layer, cin, cout, normalize + relu prologue, dropout, row bias) of every
# fused_block launch of one step; conv2 and conv3 share a shape
PN_BLOCKS = [
    ("conv1", 4, 64, False, 0.0, False),
    ("conv2/conv3", 64, 64, True, 0.0, False),
    ("conv4", 64, 128, True, 0.0, False),
    ("conv5", 128, 1024, True, 0.0, False),
    ("seg1", 64, 512, True, 0.0, True),
    ("seg2", 512, 256, True, PN_DROP, False),
    ("seg3", 256, 128, True, PN_DROP, False),
]
# wrapper launches per train step on the main path (api.fit)
PN_FUSED_PER_STEP = {
    "fused_block": 8, "fused_block_bwd": 8,
    "fused_global_pool_block": 1, "fused_global_pool_block_bwd": 1,
    "fused_seg4_ce": 1, "fused_seg4_ce_bwd": 1, "dropout": 0,
}
PN_EXACT_PER_STEP = dict({k: 0 for k in PN_FUSED_PER_STEP}, dropout=4)
# (classes, input_dim) past the bench's that the JAX fused chain trains
# and the card's kernels take since Queue C's repair: the classifier + CE
# and the logits layer past 32 classes, conv1 past 16 input features
PN_WIDTHS = [(40, 4), (4, 20)]
# f32 outputs that are sums over the N = 131,072 rows (stats, dW, db, the
# gamma/beta-like sums, num/den) take the same terms in another order and
# with atomics: |d| <= 1e-3 of the largest |ref| of the tensor. bf16
# outputs (y, dx, the pool's best) use Y_RTOL / Y_ATOL_REL above.
PN_SUM_TOL = 1e-3
# the pool's winning rows: a near-tie of two bf16 values may break the
# other way when one of them rounded differently (>= 99 % agreement); the
# CE's correct count likewise at near-tied logits (<= 1e-4 N rows)
PN_IDX_AGREE, PN_CORRECT_REL = 0.99, 1e-4
# whole step, kernels vs plain versions: the same rounding points, f32
# sums in another order; a flipped bf16 value travels through the chain
# and the train-mode BN backward amplifies it, so the fused chain's
# gradients sit up to ~40 % (L2) away from the same step in f32 whichever
# version runs it (tests/test_torch_pointnet.py shows the same of the JAX
# chain). Loss: 2^-8 relative; batch_stats: 2^-7 of max|ref| (two bf16
# ulps); each gradient: ||g_kernel - g_plain|| <= 3 ||g_plain - g_f32||,
# with g_f32 the plain layers in f32 with the chain's semantics (single-
# pass stats over all rows, the same dropout masks), except the biases
# of layers that a train-mode BN follows, whose gradient is 0 up to
# rounding (reported, not held).
PN_LOSS_REL, PN_BN_REL, PN_GRAD_RATIO = 2.0 ** -8, 2.0 ** -7, 3.0
PN_ZERO_GRAD = {f"{n}.bias" for n in ("conv1", "conv2", "conv3", "conv4",
                                      "conv5", "global_feat", "seg_conv1",
                                      "seg_conv2", "seg_conv3")}


# the tensor-core kernels by source, with their SASS opcode: wgmma (rows
# 16 and 15, row 21's forms at 64 and 128 outputs and its 64 x 64 wgrad)
# or mma.sync (rows 1, 2, 4, 5, 6 and 7, row 21's other forms)
WGMMA_SOURCES = {
    "pointnet_wgmma": [("HGMMA", ("gp_wgmma_fwd_kernel", "gp_wgmma_dx_kernel",
                                  "gp_wgmma_dw_kernel"))],
    "pointnet_chain": [("HGMMA", ("chain_wgmma_fwd_kernel",
                                  "chain_wgmma_bwd_kernel",
                                  "chain_wgmma_dx_kernel",
                                  "chain_wgmma_dw_kernel"))],
    "resample": [("HMMA", ("down2x_mma_kernel", "up2x_mma_kernel",
                           "up2x_bwd_mma_kernel", "down2x_bwd_mma_kernel"))],
    "conv3d_dgrad": [("HMMA", ("conv3x3_mma_kernel", "dgrad_mma_kernel",
                               "wgrad_mma_kernel"))],
    "block_conv": [("HGMMA", ("block_conv_wgmma_kernel",
                              "block_dgrad_wgmma_kernel",
                              "block_wgrad_wgmma_kernel")),
                   ("HMMA", ("block_conv_mma_kernel",
                             "block_dgrad_mma_kernel",
                             "block_wgrad_mma_kernel"))],
}


def wgmma_report() -> dict:
    """Phase 1's look at the tensor-core libraries: ptxas's registers,
    shared memory and spills of each kernel of each source (-Xptxas -v on
    a cubin of the same source and flags) and, where cuobjdump is present,
    the HGMMA / HMMA instructions in each tensor-core kernel's SASS; fails
    if one has none."""
    import shutil
    from pathlib import Path

    from pcseg_tpu_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    tool = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    out = {}
    for name, specs in WGMMA_SOURCES.items():
        src = _build._CSRC / f"{name}.cu"
        if not src.is_file():  # a checkout from before the source existed
            print(f"  {name}.cu: not in this checkout", flush=True)
            continue
        cubin = _build.BUILD_DIR / f"{name}.cubin"
        proc = subprocess.run([_build._nvcc(), *flags, "-cubin", "-Xptxas",
                               "-v", "-o", str(cubin), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc -cubin {name} failed:\n{proc.stdout}"
                               f"{proc.stderr}")
        lines = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                 if "ptxas" in ln]
        print(f"  {name}.cu:", flush=True)
        for ln in lines:
            print(f"    {ln}", flush=True)
        if not Path(tool).is_file():
            print("  cuobjdump not found: HGMMA / HMMA count not taken",
                  flush=True)
            out[name] = {"ptxas": lines, "hgmma": None}
            continue
        sass = subprocess.run([tool, "-sass", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout
        hgmma = {}
        for opcode, kernels in specs:
            found = dict.fromkeys(kernels, 0)
            current = None
            for ln in sass.splitlines():
                m = re.search(r"Function : (\S+)", ln)
                if m:
                    current = next((k for k in kernels if k in m.group(1)),
                                   None)
                elif current and re.search(rf"\b{opcode}\b", ln):
                    found[current] += 1
            print(f"  {opcode} instructions in {name}'s SASS: "
                  f"{json.dumps(found)}", flush=True)
            if not all(found.values()):
                raise AssertionError(f"a tensor-core kernel of {name} has no "
                                     f"{opcode}: {found}")
            hgmma.update(found)
        out[name] = {"ptxas": lines, "hgmma": hgmma}
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases():
    """(kernel, label, b, r, cin, cout, kwargs) at every shape the
    serving path launches."""
    cases = []
    for r, c in ((64, 16), (32, 32), (16, 64)):
        cases.append(("conv3x3_gn_act", "act", 8, r, c, c, {}))
        cases.append(("conv3x3_gn_act", "act+accum", 8, r, c, c,
                      {"accum": True}))
    cases.append(("conv3x3_gn_act", "stem", 8, 64, 16, 16,
                  {"activate": False}))
    cases.append(("conv3x3_gn_act", "no-stats", 8, 64, 16, 16,
                  {"want_stats": False}))
    cases.append(("conv3x3_gn_act", "no-stats", 8, 32, 32, 32,
                  {"want_stats": False}))
    cases.append(("down2x_gn_act", "act", 8, 64, 16, 32, {}))
    cases.append(("down2x_gn_act", "act", 8, 32, 32, 64, {}))
    cases.append(("up2x_gn_act", "act", 8, 16, 64, 32, {}))
    cases.append(("up2x_gn_act", "act", 8, 32, 32, 16, {}))
    # off the tensor-core routes (ops/conv3d_block.py _conv_route,
    # _mma_route): W = 8, and a width-64 U-Net's C = 128 with its coarse
    # 256
    cases.append(("conv3x3_gn_act", "act+accum off-route", 8, 8, 32, 32,
                  {"accum": True, "off_route": True}))
    cases.append(("up2x_gn_act", "act off-route", 2, 8, 256, 128,
                  {"off_route": True}))
    return cases


def run_case(kernel, label, b, r, cin, cout, kw, gen):
    import torch
    import torch.nn.functional as F

    from pcseg_tpu_torch.ops import conv3d_block as cb

    dev = "cuda"
    k = 3 if kernel == "conv3x3_gn_act" else 2
    x = torch.randn((b, r, r, r, cin), generator=gen, device=dev).to(
        torch.bfloat16)
    bound = (6.0 / (k ** 3 * cin)) ** 0.5
    w = (torch.rand((k, k, k, cin, cout), generator=gen, device=dev) * 2
         - 1) * bound
    bias = torch.randn((cout,), generator=gen, device=dev) * 0.1
    scale = torch.rand((b, cin), generator=gen, device=dev) * 0.6 + 0.7
    shift = torch.randn((b, cin), generator=gen, device=dev) * 0.3
    activate = kw.get("activate", True)
    want_stats = kw.get("want_stats", True)
    accum = None
    ro = {"conv3x3_gn_act": r, "down2x_gn_act": r // 2,
          "up2x_gn_act": 2 * r}[kernel]
    if kw.get("accum"):
        accum = torch.randn((b, ro, ro, ro, cout), generator=gen,
                            device=dev).to(torch.bfloat16)

    if kernel == "conv3x3_gn_act":
        def run():
            return cb.conv3x3_gn_act_cuda(x, w, bias, scale, shift, accum,
                                          activate=activate,
                                          want_stats=want_stats)

        def plain():
            return cb.conv3x3_gn_act_plain(
                x, w, bias, scale, shift, accum, activate=activate,
                want_stats=want_stats)

        wl = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2)

        def library():
            return F.conv3d(x.permute(0, 4, 1, 2, 3), wl, padding=1)
        taps = 27
    elif kernel == "down2x_gn_act":
        def run():
            return cb.down2x_gn_act_cuda(x, w, bias, scale, shift)

        def plain():
            return cb.down2x_gn_act_plain(x, w, bias, scale, shift)

        wl = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2)

        def library():
            return F.conv3d(x.permute(0, 4, 1, 2, 3), wl, stride=2)
        taps = 8
    else:
        def run():
            return cb.up2x_gn_act_cuda(x, w, bias, scale, shift)

        def plain():
            return cb.up2x_gn_act_plain(x, w, bias, scale, shift)

        wl = w.to(torch.bfloat16).flip(0, 1, 2).permute(3, 4, 0, 1, 2)

        def library():
            return F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), wl, stride=2)
        taps = 1

    off_route = bool(kw.get("off_route"))
    before = launch_counts()
    y_k, st_k = run()
    torch.cuda.synchronize()
    _route_taken(kernel, before, off_route)
    y_p, st_p = plain()
    yk, yp = y_k.float(), y_p.float()
    if y_k.shape != y_p.shape or not torch.isfinite(yk).all():
        raise AssertionError(f"{kernel} {label}: bad output shape or values")
    dy = (yk - yp).abs()
    y_err = float(dy.max())
    ymax = float(yp.abs().max())
    y_ok = bool((dy <= Y_RTOL * yp.abs() + Y_ATOL_REL * ymax).all())
    st_err = 0.0
    st_ok = True
    if want_stats:
        denom = st_p.abs().amax(dim=2, keepdim=True).clamp(min=1e-30)
        rel = ((st_k - st_p).abs() / denom)
        st_err = float(rel.max())
        st_ok = st_err <= STATS_TOL
    elif st_k is not None:
        raise AssertionError(f"{kernel} {label}: stats returned unasked")

    ms = time_ms(run)
    plain_ms = time_ms(plain)
    library_ms = time_ms(library)
    mma = {}
    if not off_route:
        mma = _mma_report(run, library, (y_k, st_k))
    nbytes = (x.numel() * 2 + w.numel() * 2 + cout * 4 + y_k.numel() * 2
              + (2 * b * cin * 4 if activate else 0)
              + (accum.numel() * 2 if accum is not None else 0)
              + (2 * b * cout * 4 if want_stats else 0))
    flops = 2 * y_k.numel() * cin * taps
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    res = {
        "name": kernel, "case": label,
        "shape": f"B{b} {r}^3x{cin}->{ro}^3x{cout}",
        "max_abs_err": y_err, "max_rel_err": y_err / max(ymax, 1e-30),
        "stats_rel_err": st_err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops, **mma,
    }
    ok = y_ok and st_ok
    print(f"  {'ok ' if ok else 'BAD'} {kernel:15s} {res['shape']:22s} "
          f"{label:10s} y max|err| {y_err:.3e} (rel {res['max_rel_err']:.2e})"
          f"  stats rel {st_err:.2e}  kernel {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  cuDNN {library_ms:.4f} ms  bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']})", flush=True)
    if mma:
        _print_mma(res)
    if not ok:
        raise AssertionError(
            f"{kernel} {label} {res['shape']}: kernel disagrees with its "
            f"plain version (y err {y_err}, stats rel err {st_err})")
    return res


def _mma_report(run, library, first) -> dict:
    """Rows 1-7 (csrc/resample.cu, csrc/conv3d_dgrad.cu): the
    op's kernels and the library call by device time, and whether a
    second call on the same inputs gives the same bits as ``first``
    (raises if not: their sums take a fixed order)."""
    import torch

    again = run()
    torch.cuda.synchronize()
    same = all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(first, again))
    if not same:
        raise AssertionError("two calls on the same inputs differ")
    return {"device_ms": device_ms(run),
            "library_device_ms": device_ms(library),
            "repeat_bit_identical": same}


def _print_mma(res):
    print(f"      device: kernel {res['device_ms']:.4f} ms, library "
          f"{res['library_device_ms']:.4f} ms, bound {res['bound_ms']:.4f} "
          f"ms; a second call bit-identical: {res['repeat_bit_identical']}",
          flush=True)


def _count_modules():
    from pcseg_tpu_torch.ops import block_conv as bc
    from pcseg_tpu_torch.ops import block_sparse as bsp
    from pcseg_tpu_torch.ops import conv3d_block as cb
    from pcseg_tpu_torch.ops import dropout as dr
    from pcseg_tpu_torch.ops import fused_block as fb
    from pcseg_tpu_torch.ops import fused_ce as fc
    from pcseg_tpu_torch.ops import fused_global as fg
    from pcseg_tpu_torch.ops import fused_ln as fl
    from pcseg_tpu_torch.ops import fused_pool as fp
    from pcseg_tpu_torch.ops import voxel as vx
    from pcseg_tpu_torch.ops import voxel_scatter as vs

    return cb, vx, bc, fl, bsp, fb, fg, fc, dr, fp, vs


def launch_counts() -> dict:
    """The launch counts of every kernel wrapper of the port."""
    return {k: v for m in _count_modules() for k, v in m.LAUNCHES.items()}


def reset_counts() -> None:
    for m in _count_modules():
        m.reset_launches()


def serve(card: str, default: bool = False):
    """Phase 3 (the scatter/gather forms) or, with ``default``, phase 11
    (every impl at its default)."""
    import numpy as np
    import torch

    from pcseg_tpu_torch.data.batching import pad_events
    from pcseg_tpu_torch.data.synthetic import synthetic_events
    from pcseg_tpu_torch.infer import Predictor
    from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d

    forms = {} if default else dict(conv_impl="fused",
                                    voxelize_impl="scatter",
                                    devox_impl="gather")
    model = VoxelUNet3d(
        num_classes=4, grid_size=64, width=16, levels=3,
        compute_dtype="bfloat16", generator=torch.Generator().manual_seed(0),
        **forms)
    per_forward = DEFAULT_PER_FORWARD if default else PER_FORWARD
    pred = Predictor(model.state_dict(), 4, model=model)
    events = [p for p, _ in synthetic_events(
        16, min_points=4000, max_points=8192, seed=0)]
    single = next(iter(synthetic_events(
        1, min_points=1000, max_points=1000, seed=1)))[0]
    n_batch_pts = sum(e.shape[0] for e in events)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    preds = pred.predict_batch(events, batch_size=8)
    t1 = time.perf_counter()
    p_single = pred.predict(single)
    t2 = time.perf_counter()
    launches = launch_counts()
    forwards = 3
    expected = {k: per_forward.get(k, 0) * forwards for k in launches}
    print(f"  main path: {forwards} forwards, launches "
          f"{ {k: v for k, v in launches.items() if v} } (expected "
          f"{ {k: v for k, v in expected.items() if v} }, none of the "
          f"others)", flush=True)
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    if [p.shape[0] for p in preds] != [e.shape[0] for e in events] or \
            p_single.shape != (single.shape[0],):
        raise AssertionError("prediction shapes do not match the events")
    first = {"batch_ms": (t1 - t0) * 1e3, "single_ms": (t2 - t1) * 1e3}

    reps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_batch(events, batch_size=8)
        t1 = time.perf_counter()
        pred.predict(single)
        t2 = time.perf_counter()
        reps.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
    batch_ms = sorted(r[0] for r in reps)[1]
    single_ms = sorted(r[1] for r in reps)[1]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # kernels vs plain versions through the whole model, one batch of 8
    pts, _, msk = pad_events(
        [(e, np.zeros(e.shape[0], np.int64)) for e in events[:8]], 8192,
        batch_size=8)
    points = torch.from_numpy(pts).cuda()
    mask = torch.from_numpy(msk).cuda()
    out_k = model(points, mask)
    out_p = model(points, mask, plain=True)
    if out_k.shape != (8, 8192, 4) or not torch.isfinite(out_k).all():
        raise AssertionError(f"logits: shape {tuple(out_k.shape)} or "
                             "non-finite values")
    d = (out_k - out_p).abs()
    err = float(d.max())
    scale = float(out_p.abs().max())
    agree = float((out_k.argmax(-1) == out_p.argmax(-1))[mask].float()
                  .mean())
    ok = err <= LOGITS_REL * scale and agree >= ARGMAX_AGREE
    print(f"  logits kernels vs plain on the card: max|err| {err:.4e} "
          f"(max|logit| {scale:.3f}; tol {LOGITS_REL * scale:.4f}), argmax "
          f"agreement {agree:.6f} (tol {ARGMAX_AGREE})", flush=True)
    if not ok:
        raise AssertionError(f"logits disagree with the plain model: max "
                             f"err {err}, argmax agreement {agree}")
    if default:
        # the same weights and points through the scatter/gather forms: the
        # default forms' extra bf16 roundings (reported, not held)
        sg = VoxelUNet3d(
            num_classes=4, grid_size=64, width=16, levels=3,
            compute_dtype="bfloat16", voxelize_impl="scatter",
            devox_impl="gather").cuda()
        sg.load_state_dict(model.state_dict())
        out_sg = sg(points, mask)
        vs_sg = {"max_abs_err": float((out_k - out_sg).abs().max()),
                 "argmax_agreement": float(
                     (out_k.argmax(-1) == out_sg.argmax(-1))[mask].float()
                     .mean())}
        print(f"  default vs scatter/gather forms, same weights: max|d| "
              f"{vs_sg['max_abs_err']:.4e}, argmax agreement "
              f"{vs_sg['argmax_agreement']:.6f}", flush=True)
    res = {
        "forms": model.resolve_forms(),
        "vs_scatter_gather": vs_sg if default else None,
        "first_call": first,
        "predict_batch_16_ms": batch_ms,
        "ms_per_event_batched": batch_ms / len(events),
        "points_per_s_batched": n_batch_pts / (batch_ms / 1e3),
        "predict_1000pt_ms": single_ms,
        "peak_mem_gib": peak_gib,
        "logits_max_abs_err": err,
        "argmax_agreement": agree,
        "card": card,
    }
    print(f"  serving {res['forms']} [{card}]: predict_batch(16 events, "
          f"{n_batch_pts} pts) "
          f"{batch_ms:.2f} ms = {res['ms_per_event_batched']:.2f} ms/event, "
          f"{res['points_per_s_batched']:.4e} points/s; predict(1000 pts) "
          f"{single_ms:.2f} ms; first calls {first['batch_ms']:.2f} / "
          f"{first['single_ms']:.2f} ms; peak {peak_gib:.3f} GiB",
          flush=True)
    return launches, res


# ---------------------------------------------------------------------------
# PointNetSeg training (slice 2)
# ---------------------------------------------------------------------------

def _bound(nbytes: float, flops: float, rate: float = BF16_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _bf16_check(got, ref, atol_rel=Y_ATOL_REL):
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    ok = bool((d <= Y_RTOL * r.abs() + atol_rel * r.abs().max()).all())
    return float(d.max()), ok


def _sum_check(got, ref):
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    return err, err <= PN_SUM_TOL * scale + 1e-12


def _held(label, checks):
    """checks: name -> (max abs err, ok). Raises on any failure."""
    bad = [k for k, (_, ok) in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version in {bad}: {checks}")
    return max(e for e, _ in checks.values())


def _bn_vectors(gen, c):
    import torch

    mu = torch.randn(c, generator=gen, device="cuda") * 0.2
    inv = torch.rand(c, generator=gen, device="cuda") + 0.5
    gamma = torch.randn(c, generator=gen, device="cuda")
    beta = torch.randn(c, generator=gen, device="cuda") * 0.2
    return [mu, inv, gamma, beta]


def _dense(gen, cin, cout):
    import torch

    bound = cin ** -0.5
    w = (torch.rand((cin, cout), generator=gen, device="cuda") * 2 - 1) * bound
    b = (torch.rand(cout, generator=gen, device="cuda") * 2 - 1) * bound
    return w, b


def _report(res):
    print(f"  ok  {res['name']:24s} {res['case']:12s} {res['shape']:22s} "
          f"max|err| {res['max_abs_err']:.3e}  fwd kernel {res['ms']:.4f} / "
          f"plain {res['plain_ms']:.4f} / matmul "
          f"{res['library_ms'] if res['library_ms'] is None else round(res['library_ms'], 4)}"
          f" / bound {res['bound_ms']:.4f} ms ({res['bound_by']}); bwd "
          f"kernel {res['bwd_ms']:.4f} / plain {res['bwd_plain_ms']:.4f} / "
          f"bound {res['bwd_bound_ms']:.4f} ms", flush=True)
    return res


def pn_block_case(layer, cin, cout, normalize, drop, row_bias, gen, b=PN_B,
                  m=PN_M):
    """Row 15 at one layer's shape (b batch rows of m points) against its
    plain version, forward and backward; times the op, its plain version,
    one bf16 product (the forward's x @ wq; the backward's pair) and each
    kernel of the op by device time."""
    import torch

    from pcseg_tpu_torch.ops import fused_block as fb

    n = b * m
    x = torch.randn((n, cin), generator=gen, device="cuda").to(torch.bfloat16)
    bn = _bn_vectors(gen, cin) if normalize else [None] * 4
    w, bias = _dense(gen, cin, cout)
    rb = (torch.randn((b, cout), generator=gen, device="cuda")
          if row_bias else None)
    rpb = m if row_bias else 0
    fwd = (x, *bn, w, bias, rb, 987, normalize, drop, True, rpb,
           torch.bfloat16)
    yk, s1k, s2k = fb.fused_block_fwd_cuda(*fwd)
    torch.cuda.synchronize()
    yp, s1p, s2p = fb.fused_block_fwd_plain(*fwd)
    checks = {"y": _bf16_check(yk, yp), "s1": _sum_check(s1k, s1p),
              "s2": _sum_check(s2k, s2p)}
    dy = torch.randn((n, cout), generator=gen, device="cuda").to(
        torch.bfloat16)
    ds1 = torch.randn(cout, generator=gen, device="cuda") * 1e-2
    ds2 = torch.randn(cout, generator=gen, device="cuda") * 1e-3
    bwd = (x, *bn, w, yk, dy, ds1, ds2, 987, normalize, drop, rpb, row_bias)
    gk = fb.fused_block_bwd_cuda(*bwd)
    torch.cuda.synchronize()
    gp = fb.fused_block_bwd_plain(*bwd)
    checks["dx"] = _bf16_check(gk[0], gp[0])
    for name, a, r in zip(("dw", "db", "dgamma", "dbeta", "drow_bias"),
                          gk[1:], gp[1:]):
        if r is not None:
            checks[name] = _sum_check(a, r)
    err = _held(f"fused_block {layer}", checks)

    wq = w.to(torch.bfloat16)
    res = {
        "name": "fused_block", "case": layer,
        "shape": f"B{b} M{m} {cin}->{cout}", "max_abs_err": err,
        "ms": time_ms(lambda: fb.fused_block_fwd_cuda(*fwd)),
        "plain_ms": time_ms(lambda: fb.fused_block_fwd_plain(*fwd)),
        "library_ms": time_ms(lambda: x @ wq),
        "bwd_ms": time_ms(lambda: fb.fused_block_bwd_cuda(*bwd)),
        "bwd_plain_ms": time_ms(lambda: fb.fused_block_bwd_plain(*bwd)),
        "bwd_library_ms": time_ms(lambda: (dy @ wq.t(), x.t() @ dy)),
        "device_ms": kernels_device_ms(lambda: fb.fused_block_fwd_cuda(*fwd)),
        "bwd_device_ms": kernels_device_ms(
            lambda: fb.fused_block_bwd_cuda(*bwd)),
    }
    vec = 4 * cin * 4 if normalize else 0
    io = n * cin * 2 + cin * cout * 2 + cout * 4 + vec
    fwd_bytes = io + n * cout * 2 + 2 * cout * 4 + (
        b * cout * 4 if row_bias else 0)
    bwd_bytes = io + 2 * n * cout * 2 + n * cin * 2 + cin * cout * 4 + (
        2 * cin * 4 if normalize else 0) + (b * cout * 4 if row_bias else 0)
    res["bound_ms"], res["bound_by"] = _bound(fwd_bytes, 2 * n * cin * cout)
    res["bwd_bound_ms"], res["bwd_bound_by"] = _bound(bwd_bytes,
                                                      4 * n * cin * cout)
    _report(res)
    _device_report(res)
    return res


def _device_report(res):
    print(f"      device ms by kernel (op: fwd {res['ms']:.4f}, bwd "
          f"{res['bwd_ms']:.4f}): fwd {json.dumps(res['device_ms'])}; bwd "
          f"{json.dumps(res['bwd_device_ms'])}", flush=True)


def pn_step_sums(pn_cases):
    """Row 15's 8 launches of one train step (conv2 and conv3 share a
    case), summed: op ms, bound and one bf16 product, forward and
    backward."""
    times = {"conv2/conv3": 2}
    sums = {}
    for key in ("ms", "bound_ms", "library_ms", "bwd_ms", "bwd_bound_ms",
                "bwd_library_ms"):
        sums[key] = sum(c[key] * times.get(c["case"], 1) for c in pn_cases
                        if c["name"] == "fused_block"
                        and c["case"] in {blk[0] for blk in PN_BLOCKS})
    print(f"  row 15, the 8 launches of one step: fwd {sums['ms']:.4f} ms "
          f"(bound {sums['bound_ms']:.4f}, x @ wq {sums['library_ms']:.4f}); "
          f"bwd {sums['bwd_ms']:.4f} ms (bound {sums['bwd_bound_ms']:.4f}, "
          f"product pairs {sums['bwd_library_ms']:.4f})", flush=True)
    return sums


def kernels_device_ms(fn, iters: int = 10) -> dict:
    """Device ms per call of each kernel that one call of ``fn`` launches
    (torch.profiler over ``iters`` warm calls, profiled again while
    launches go unrecorded), by short kernel name."""
    from pcseg_tpu_torch.profile_serving import profile_calls

    out: dict = {}
    for full, ms in profile_calls(fn, iters).items():
        name = re.sub(r"^void |\(anonymous namespace\)::", "",
                      full).split("(")[0]
        out[name] = out.get(name, 0.0) + ms
    return out


def pn_global_case(gen, b=PN_B, m=PN_M, label="global_feat"):
    """Row 16 (the wgmma kernels of pointnet_wgmma.cu) against its plain
    version at b batch rows of m points, 1024 -> 1024; the main path's
    shape also times each kernel by device time."""
    import torch

    from pcseg_tpu_torch.ops import fused_global as fg

    n, cin, cout = b * m, 1024, 1024
    x = torch.randn((n, cin), generator=gen, device="cuda").to(torch.bfloat16)
    bn = _bn_vectors(gen, cin)
    w, bias = _dense(gen, cin, cout)
    sign = torch.sign(torch.randn(cout, generator=gen, device="cuda"))
    sign[::97] = 0.0                  # gamma_global == 0: row 0 must win
    fwd = (x, *bn, w, bias, sign, m)
    k = fg.global_pool_fwd_cuda(*fwd)
    torch.cuda.synchronize()
    p = fg.global_pool_fwd_plain(*fwd)
    agree = float((k[4] == p[4]).float().mean())
    checks = {"y": _bf16_check(k[0], p[0]), "s1": _sum_check(k[1], p[1]),
              "s2": _sum_check(k[2], p[2]), "best": _bf16_check(k[3], p[3]),
              "idx": (1.0 - agree, agree >= PN_IDX_AGREE),
              "idx_ties": (0.0, bool((k[4][:, ::97] == 0).all()))}
    ds1 = torch.randn(cout, generator=gen, device="cuda") * 1e-2
    ds2 = torch.randn(cout, generator=gen, device="cuda") * 1e-3
    pval = torch.randn((b, cout), generator=gen, device="cuda")
    # the backward from the kernel's y and winners on both sides
    bwd = (x, *bn, w, k[0], ds1, ds2, pval, k[4], m)
    gk = fg.global_pool_bwd_cuda(*bwd)
    torch.cuda.synchronize()
    gp = fg.global_pool_bwd_plain(*bwd)
    checks["dx"] = _bf16_check(gk[0], gp[0])
    for name, a, r in zip(("dw", "db", "dgamma", "dbeta"), gk[1:], gp[1:]):
        checks[name] = _sum_check(a, r)
    err = _held(f"fused_global_pool_block {label}", checks)
    wq = w.to(torch.bfloat16)
    dyb = k[0]
    res = {
        "name": "fused_global_pool_block", "case": label,
        "shape": f"B{b} M{m} {cin}->{cout}", "max_abs_err": err,
        "idx_agreement": agree,
        "ms": time_ms(lambda: fg.global_pool_fwd_cuda(*fwd)),
        "plain_ms": time_ms(lambda: fg.global_pool_fwd_plain(*fwd)),
        "library_ms": time_ms(lambda: x @ wq),
        "bwd_ms": time_ms(lambda: fg.global_pool_bwd_cuda(*bwd)),
        "bwd_plain_ms": time_ms(lambda: fg.global_pool_bwd_plain(*bwd)),
        "bwd_library_ms": time_ms(lambda: (dyb @ wq.t(), x.t() @ dyb)),
    }
    if label == "global_feat":  # the main path's shape: each kernel's time
        res["device_ms"] = kernels_device_ms(
            lambda: fg.global_pool_fwd_cuda(*fwd))
        res["bwd_device_ms"] = kernels_device_ms(
            lambda: fg.global_pool_bwd_cuda(*bwd))
        print(f"  row 16 device ms by kernel (CUDA-event ms of the op: fwd "
              f"{res['ms']:.4f}, bwd {res['bwd_ms']:.4f}): fwd "
              f"{json.dumps(res['device_ms'])}; bwd "
              f"{json.dumps(res['bwd_device_ms'])}", flush=True)
    io = n * cin * 2 + cin * cout * 2 + cout * 8 + 4 * cin * 4
    res["bound_ms"], res["bound_by"] = _bound(
        io + n * cout * 2 + 2 * cout * 4 + b * cout * 8,
        2 * n * cin * cout)
    res["bwd_bound_ms"], res["bwd_bound_by"] = _bound(
        io + n * cout * 2 + b * cout * 8 + n * cin * 2 + cin * cout * 4,
        4 * n * cin * cout)
    return _report(res)


def pn_ce_case(gen, c=PN_CLASSES, label="seg4+CE"):
    import torch

    from pcseg_tpu_torch.ops import fused_ce as fc

    n, cin = PN_B * PN_M, 128
    x = torch.randn((n, cin), generator=gen, device="cuda").to(torch.bfloat16)
    bn = _bn_vectors(gen, cin)
    w, b = _dense(gen, cin, c)
    labels = torch.randint(-1, c, (n,), generator=gen, device="cuda")
    cw = torch.rand(c, generator=gen, device="cuda") + 0.5
    args = (x, *bn, w, b, labels, cw)
    k = fc.seg4_ce_fwd_cuda(*args)
    torch.cuda.synchronize()
    p = fc.seg4_ce_fwd_plain(*args)
    dcor = abs(float(k[2]) - float(p[2]))
    checks = {
        "num": (abs(float(k[0] - p[0])),
                abs(float(k[0] - p[0])) <= PN_SUM_TOL * abs(float(p[0]))),
        "den": (abs(float(k[1] - p[1])),
                abs(float(k[1] - p[1])) <= PN_SUM_TOL * abs(float(p[1]))),
        "correct": (dcor, dcor <= PN_CORRECT_REL * n),
    }
    ct = torch.ones((), device="cuda")
    gk = fc.seg4_ce_bwd_cuda(*args, ct)
    torch.cuda.synchronize()
    gp = fc.seg4_ce_bwd_plain(*args, ct)
    # dlogits come from expf on the card and torch.exp in the plain
    # version, so a few of the 2^19 bf16 dlogits round the other way; dx
    # sums C of them, so one flip moves dx by up to a bf16 ulp of a
    # dlogit's term, which can exceed one ulp of a small dx: dx is held
    # to 2^-7 |ref| + 2^-7 max|ref|
    checks["dx"] = _bf16_check(gk[0], gp[0], atol_rel=2.0 ** -7)
    for name, a, r in zip(("dw", "db", "dgamma", "dbeta"), gk[1:], gp[1:]):
        checks[name] = _sum_check(a, r)
    err = _held("fused_seg4_ce", checks)
    wq = w.to(torch.bfloat16)
    dl = torch.randn((n, c), generator=gen, device="cuda").to(torch.bfloat16)
    res = {
        "name": "fused_seg4_ce", "case": label,
        "shape": f"N{n} {cin}->{c}", "max_abs_err": err,
        "ms": time_ms(lambda: fc.seg4_ce_fwd_cuda(*args)),
        "plain_ms": time_ms(lambda: fc.seg4_ce_fwd_plain(*args)),
        "library_ms": time_ms(lambda: x @ wq),
        "bwd_ms": time_ms(lambda: fc.seg4_ce_bwd_cuda(*args, ct)),
        "bwd_plain_ms": time_ms(lambda: fc.seg4_ce_bwd_plain(*args, ct)),
        # the backward's two products, dlogits W^T and x^T dlogits, on a
        # bf16 (N, C) cotangent, as the other rows' yardstick
        "bwd_library_ms": time_ms(lambda: (dl @ wq.t(), x.t() @ dl)),
        "device_ms": kernels_device_ms(lambda: fc.seg4_ce_fwd_cuda(*args)),
        "bwd_device_ms": kernels_device_ms(
            lambda: fc.seg4_ce_bwd_cuda(*args, ct)),
    }
    io = n * cin * 2 + n * 8 + cin * c * 2 + 2 * c * 4 + 4 * cin * 4
    res["bound_ms"], res["bound_by"] = _bound(io + 3 * 4, 2 * n * cin * c)
    res["bwd_bound_ms"], res["bwd_bound_by"] = _bound(
        io + n * cin * 2 + cin * c * 4, 4 * n * cin * c)
    _report(res)
    _device_report(res)
    return res


def pn_training_cases(gen, dropout=True):
    """Phase 4: rows 15-17 at every shape of a B64 x 2048 train step, row
    15 also at B63 x 1000 rows (N = 63,000, not a multiple of 128: a
    partial last tile, whose rows TMA fills with zeros) at seg1's shape
    with its row bias (batch boundaries inside the row tiles; the split
    backward) and at conv4's (the one-sweep backward), row 16 at
    1000 rows a batch row; then dropout (row 18). Returns the cases and
    row 15's sums over the 8 launches of a step."""
    cases = [pn_block_case(*blk, gen) for blk in PN_BLOCKS]
    cases.append(pn_block_case("seg1 ragged M1000", 64, 512, True, 0.0, True,
                               gen, b=63, m=1000))
    cases.append(pn_block_case("conv4 ragged M1000", 64, 128, True, 0.0,
                               False, gen, b=63, m=1000))
    sums = pn_step_sums(cases)
    # the widths past the bench's that the JAX fused chain trains (Queue
    # C's repair): conv1 at input_dim 20 (K chunks), the logits layer and
    # the classifier + CE at 40 classes (the wide tiles)
    for classes, input_dim in PN_WIDTHS:
        if input_dim != 4:
            cases.append(pn_block_case(f"conv1 input_dim {input_dim}",
                                       input_dim, 64, False, 0.0, False, gen))
        if classes != PN_CLASSES:
            cases.append(pn_block_case(f"logits {classes}", 128, classes,
                                       True, 0.0, False, gen))
    cases += [pn_global_case(gen),
              pn_global_case(gen, 64, 1000, "ragged M1000"),
              pn_ce_case(gen)]
    cases += [pn_ce_case(gen, classes, f"seg4+CE {classes}")
              for classes, _ in PN_WIDTHS if classes != PN_CLASSES]
    if dropout:
        cases += [pn_dropout_case(c, gen) for c in (512, 256)]
    return cases, sums


def pn_dropout_case(c, gen):
    import torch

    from pcseg_tpu_torch.ops import dropout as dr

    # the exact path drops the f32 outputs of seg1 (512) and seg2 (256)
    x = torch.randn((PN_B, PN_M, c), generator=gen, device="cuda")
    k = dr._dropout_cuda(x, 4321, PN_DROP)
    torch.cuda.synchronize()
    p = dr.dropout_plain(x, 4321, PN_DROP)
    keep = float((k != 0).float().mean())
    err = float((k - p).abs().max())
    _held(f"dropout {c}", {
        "y (exact)": (err, bool(torch.equal(k, p))),
        "keep_share": (abs(keep - (1 - PN_DROP)),
                       abs(keep - (1 - PN_DROP)) < 0.01)})
    ms = time_ms(lambda: dr._dropout_cuda(x, 4321, PN_DROP))
    res = {
        "name": "dropout", "case": f"seg{1 if c == 512 else 2} out",
        "shape": f"B{PN_B} M{PN_M} C{c} f32", "max_abs_err": err,
        "keep_share": keep, "ms": ms,
        "plain_ms": time_ms(lambda: dr.dropout_plain(x, 4321, PN_DROP)),
        "library_ms": None,
        # the backward is the same kernel on the cotangent
        "bwd_ms": ms, "bwd_plain_ms": None,
    }
    res["bound_ms"], res["bound_by"] = _bound(2 * x.numel() * 4, 0)
    res["bwd_bound_ms"] = res["bound_ms"]
    print(f"  ok  dropout {res['shape']:22s} exact match, keep share "
          f"{keep:.5f}  kernel {ms:.4f} / plain {res['plain_ms']:.4f} / "
          f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})", flush=True)
    return res


def pn_events(n, seed, classes=PN_CLASSES, input_dim=4):
    """n synthetic events of 1100-2048 points with ``classes`` classes;
    past 4 input features, seeded normal features appended to each
    point."""
    import numpy as np

    from pcseg_tpu_torch.data.synthetic import synthetic_events

    rng = np.random.default_rng(seed)
    events = []
    for pts, lab in synthetic_events(n, num_classes=classes, min_points=1100,
                                     max_points=PN_M, seed=seed):
        extra = rng.normal(size=(pts.shape[0], input_dim - pts.shape[1]))
        events.append((np.concatenate([pts, extra.astype(np.float32)], 1),
                       lab))
    return events


def pn_batch(seed: int, classes=PN_CLASSES, input_dim=4):
    """One B64 x 2048 batch of synthetic events (1100-2048 points)."""
    import numpy as np

    from pcseg_tpu_torch.data.batching import pad_events
    from pcseg_tpu_torch.data.class_stats import scan_classes

    events = pn_events(PN_B, seed, classes, input_dim)
    cw = scan_classes(events).weights
    return (pad_events(events, PN_M, batch_size=PN_B, feature_dim=input_dim),
            np.asarray(cw))


def pn_step_compare(card, classes=PN_CLASSES, input_dim=4):
    """One fused train step with the kernels and with the plain versions,
    from the same weights, batch and dropout seeds, and the same step in
    f32 on plain layers as the yardstick of the chain's own rounding; at
    the bench's widths or at ``classes`` / ``input_dim`` (PN_WIDTHS),
    where the launch counts of one step show rows 15 and 17 took them."""
    import torch

    from pcseg_tpu_torch.models.pointnet import PointNetSeg, pointnet_apply
    from pcseg_tpu_torch.ops import fused_block as fb
    from pcseg_tpu_torch.ops import fused_ce as fc
    from pcseg_tpu_torch.ops.losses import cross_entropy_sums

    (pts, labels, _), cw = pn_batch(5, classes, input_dim)
    points = torch.from_numpy(pts).cuda()
    labels = torch.from_numpy(labels).cuda()
    cw = torch.from_numpy(cw).cuda()
    model = PointNetSeg(classes, input_dim=input_dim, dropout=PN_DROP,
                        bn_stats="fused", compute_dtype="bfloat16",
                        generator=torch.Generator().manual_seed(0)).cuda()
    seeds = (11, 22)

    def step(plain):
        model.zero_grad(set_to_none=True)
        (num, den, cor), new_bn = model.fused_train_loss(
            points, labels, cw, seeds=seeds, plain=plain)
        loss = num / den
        loss.backward()
        return loss.detach(), new_bn

    def step_f32():
        model.zero_grad(set_to_none=True)
        logits, _ = pointnet_apply(
            model.params(), model.batch_stats(), points, train=True,
            seeds=seeds, dropout_rate=PN_DROP, compute_dtype=torch.float32,
            fast_bn_stats=True, plain=True)
        num, den = cross_entropy_sums(logits, labels, cw)
        (num / den).backward()
        return (num / den).detach()

    def grads():
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    fb.reset_launches()
    fc.reset_launches()
    lk, bnk = step(False)
    gk = grads()
    launches = dict(fb.LAUNCHES, **fc.LAUNCHES)
    want = {k: PN_FUSED_PER_STEP[k] for k in launches}
    if launches != want:
        raise AssertionError(f"fused train step at {classes} classes, "
                             f"input_dim {input_dim}: launches {launches} "
                             f"!= {want}")
    lp, bnp = step(True)
    gp = grads()
    lf = step_f32()
    gf = grads()
    torch.cuda.synchronize()
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    rel = {n: float((gk[n] - gp[n]).norm() / gp[n].norm()) for n in gp}
    own = {n: float((gp[n] - gf[n]).norm() / gf[n].norm()) for n in gp}
    ratio = {n: rel[n] * float(gp[n].norm())
             / max(own[n] * float(gf[n].norm()), 1e-30)
             for n in gp if n not in PN_ZERO_GRAD}
    bn_rel = max(float((bnk[b][s] - bnp[b][s]).abs().max()
                       / bnp[b][s].abs().max()) for b in bnp for s in bnp[b])
    zero_scale = max(float(gp[n].norm() / gp[n.replace("bias", "kernel")]
                           .norm()) for n in PN_ZERO_GRAD)
    worst = max(ratio, key=ratio.get)
    ok = (loss_rel <= PN_LOSS_REL and ratio[worst] <= PN_GRAD_RATIO
          and bn_rel <= PN_BN_REL and all(torch.isfinite(g).all()
                                          for g in gk.values()))
    ms_k = time_ms(lambda: step(False), iters=3)
    ms_p = time_ms(lambda: step(True), iters=3)
    ms_f = time_ms(step_f32, iters=3)
    held = [n for n in ratio]
    res = {"loss_kernels": float(lk), "loss_plain": float(lp),
           "loss_f32": float(lf), "loss_rel_err": loss_rel,
           "grad_rel_err_kernels_vs_plain": rel,
           "grad_rel_err_plain_vs_f32": own, "grad_ratio": ratio,
           "grad_ratio_max": ratio[worst], "grad_worst": worst,
           "grad_rel_err_max_held": max(rel[n] for n in held),
           "grad_rel_err_plain_vs_f32_max_held": max(own[n] for n in held),
           "zero_grad_bias_norm_rel": zero_scale, "batch_stats_rel_err":
           bn_rel, "fwd_bwd_ms_kernels": ms_k, "fwd_bwd_ms_plain": ms_p,
           "fwd_bwd_ms_f32_plain_layers": ms_f, "classes": classes,
           "input_dim": input_dim, "launches": launches, "card": card}
    print(f"  {classes} classes, input_dim {input_dim}, launches "
          f"{launches}: loss kernels {float(lk):.6f} plain {float(lp):.6f} (rel "
          f"{loss_rel:.2e}, tol {PN_LOSS_REL:.2e}), f32 {float(lf):.6f}; "
          f"gradients kernels vs plain <= {res['grad_rel_err_max_held']:.3e}"
          f" (rel L2), plain vs f32 <= "
          f"{res['grad_rel_err_plain_vs_f32_max_held']:.3e}; worst ratio "
          f"{ratio[worst]:.3f} at {worst} (tol {PN_GRAD_RATIO}); "
          f"batch_stats rel {bn_rel:.2e} (tol {PN_BN_REL:.2e}); the 9 "
          f"zero-gradient biases at <= {zero_scale:.1e} of their kernel's "
          f"gradient; fwd+bwd {ms_k:.2f} ms with kernels, {ms_p:.2f} ms "
          f"plain, {ms_f:.2f} ms f32 plain layers [{card}]", flush=True)
    if not ok:
        raise AssertionError(f"fused train step: kernels disagree with the "
                             f"plain versions: {res}")
    return res


def pn_fit(card, bn_stats, events, classes=PN_CLASSES, input_dim=4):
    """The main path: api.fit on the card (at the bench's widths, or at
    ``classes`` / ``input_dim``). Returns (launches, result)."""
    import math

    import torch

    from pcseg_tpu_torch import api
    from pcseg_tpu_torch.ops import dropout as dr
    from pcseg_tpu_torch.ops import fused_block as fb
    from pcseg_tpu_torch.ops import fused_ce as fc
    from pcseg_tpu_torch.ops import fused_global as fg

    mods = (fb, fg, fc, dr)
    overrides = [f"model.bn_stats={bn_stats}", "model.compute_dtype=bfloat16",
                 f"model.num_classes={classes}",
                 f"model.input_dim={input_dim}",
                 f"data.batch_size={PN_B}", f"data.buckets={PN_M}",
                 "train.num_epochs=2", "train.log_every_steps=0",
                 "train.checkpoint_dir=build/chip_smoke_ckpt"]
    torch.cuda.reset_peak_memory_stats()
    for m in mods:
        m.reset_launches()
    res = api.fit(events, overrides=overrides, log=lambda _: None)
    torch.cuda.synchronize()
    launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = sum(h["train_steps"] for h in res.history)
    per_step = PN_FUSED_PER_STEP if bn_stats == "fused" else PN_EXACT_PER_STEP
    expected = {k: v * steps for k, v in per_step.items()}
    if launches != expected:
        raise AssertionError(f"fit {bn_stats} ({classes} classes, input_dim "
                             f"{input_dim}): launch counts {launches} != "
                             f"{expected}")
    losses = [h[k] for h in res.history for k in ("train_loss", "val_loss")]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"fit {bn_stats}: non-finite loss {losses}")
    warm = res.history[-1]
    ms_step = warm["train_seconds"] * 1e3 / warm["train_steps"]
    out = {
        "bn_stats": bn_stats, "classes": classes, "input_dim": input_dim,
        "steps": steps, "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "train_loss": [h["train_loss"] for h in res.history],
        "val_loss": [h["val_loss"] for h in res.history],
        "first_epoch_train_ms_per_step":
            res.history[0]["train_seconds"] * 1e3 / res.history[0][
                "train_steps"],
        "ms_per_step": ms_step,
        "points_per_s": PN_B * PN_M / (ms_step / 1e3),
        "epoch_seconds": [h["seconds"] for h in res.history],
        "peak_mem_gib": peak, "card": card,
    }
    print(f"  fit bn_stats={bn_stats}, {classes} classes, input_dim "
          f"{input_dim} [{card}]: {steps} train steps at "
          f"B{PN_B} x {PN_M}, launches per step "
          f"{ {k: v for k, v in out['launches_per_step'].items() if v} }; "
          f"train loss {out['train_loss']}, val loss {out['val_loss']}; "
          f"{ms_step:.2f} ms/step (epoch 2; epoch 1 "
          f"{out['first_epoch_train_ms_per_step']:.2f}), "
          f"{out['points_per_s']:.4e} points/s; peak {peak:.3f} GiB",
          flush=True)
    return launches, out


# ---------------------------------------------------------------------------
# voxel U-Net training (slice 3)
# ---------------------------------------------------------------------------

# pcseg_tpu/bench.py's voxel step (VOX_* at :124): B8 x 8192 points, 64^3
# grid, width 16, 3 levels, 4 classes, bf16; scatter voxelize and gather
# devoxelize (the f32-exact forms, as served in phase 3)
VOX_B, VOX_M, VOX_R, VOX_W, VOX_CLASSES = 8, 8192, 64, 16, 4
TRI_SOURCE = "pcseg_tpu_torch/csrc/onehot_contract.cu"
VOX_REPLACES = {
    "conv3x3_dgrad": "pcseg_tpu/ops/pallas/conv3d_block.py:546",
    "conv3x3_wgrad": "pcseg_tpu/ops/pallas/conv3d_block.py:648",
    "down2x_bwd": "pcseg_tpu/ops/pallas/conv3d_block.py:1353",
    "up2x_bwd": "pcseg_tpu/ops/pallas/conv3d_block.py:1439",
    "trilinear_scatter": "pcseg_tpu/ops/pallas/onehot_contract.py:245",
}
# wrapper launches per train step on the main path, as the JAX structure
# has them: 13 3^3 convs, of which the stem (input = data) runs no dgrad;
# levels-1 down and up blocks; one devoxelize backward
VOX_PER_STEP = dict(PER_FORWARD, conv3x3_dgrad=12, conv3x3_wgrad=13,
                    down2x_bwd=2, up2x_bwd=2, trilinear_scatter=1,
                    up2x_bwd_mma=2, down2x_bwd_mma=2, conv3x3_dgrad_mma=12,
                    conv3x3_wgrad_mma=13)
# the voxel backward rows' sources
VOX_SOURCES = {"conv3x3_dgrad": DGRAD_SOURCE, "conv3x3_wgrad": DGRAD_SOURCE,
               "down2x_bwd": RESAMPLE_SOURCE, "up2x_bwd": RESAMPLE_SOURCE,
               "trilinear_scatter": TRI_SOURCE}
# the default configuration's step adds the one-hot forward kernels and
# the fused head forward and backward
DEFAULT_PER_STEP = dict(VOX_PER_STEP, voxelize_contract=1, head_grid2=1,
                        trilinear_gather=1, head_grid2_bwd=1)
# whole step, kernels vs plain versions: the loss to VOX_LOSS_REL
# relative; the conv kernels' gradient vector at cosine >= 0.998; each
# gradient's relative L2 within 3x the plain bf16 chain's own distance from
# the same step in f32 (the train-mode GroupNorm backward amplifies
# one-ulp bf16 flips, as the BN backward does in phase 5), except the conv
# biases that a GroupNorm follows, whose gradient is 0 up to rounding
# (reported, not held). The voxel forward's conv kernels sum in a fixed
# order (rows 1, 4 and 6 since PR 12), so the loss moves only with the
# scatter voxelizer's index_add_ (float atomics, in the kernel step and the
# plain one alike): over 20 readings of --step-spread 20 on an H100 80GB
# HBM3 at 700 W, kernels vs plain 5.965e-5 (16) or 2.932e-5 (4), the same
# kernel step twice 0 (15) or 3.03e-5 (5); held to 3x the largest
# kernels-vs-plain reading, as phases 12 and 16 are (3.7e-4 before, from
# the forward's stats atomics)
VOX_LOSS_REL, VOX_KERNEL_COS, VOX_GRAD_RATIO = 1.8e-4, 0.998, 3.0
# the default configuration's logits are bf16 (the fused head's grid2), so
# a one-ulp flip of a voxel logit moves the loss: 1.242e-4 relative in
# each of 20 readings on the same card, the kernel step twice identical in
# all 20 (its voxelize_contract atomics did not move it), held to 3x the
# largest (7.5e-4 before)
DEFAULT_LOSS_REL = 3.8e-4


def vox_bwd_cases():
    """(kernel, label, r, cin, cout, kwargs) at every shape the backward
    of one train step launches: the 3^3 blocks at each level (the accum
    and stats-free y1 halves of the decoder at levels 0 and 1, the stem at
    level 0), the two down and the two up blocks; then the 3^3 dgrad and
    wgrad and the down backward at one shape each off their tensor-core
    routes."""
    cases = [("conv3x3", "act", r, c, c, {})
             for r, c in ((64, 16), (32, 32), (16, 64))]
    for r, c in ((64, 16), (32, 32)):
        cases.append(("conv3x3", "accum", r, c, c, {"accum": True}))
        cases.append(("conv3x3", "y1 no-stats", r, c, c, {"stats": False}))
    cases.append(("conv3x3", "stem", 64, 16, 16, {"activate": False}))
    cases += [("down2x_bwd", "act", 64, 16, 32, {}),
              ("down2x_bwd", "act", 32, 32, 64, {}),
              ("up2x_bwd", "act", 16, 64, 32, {}),
              ("up2x_bwd", "act", 32, 32, 16, {})]
    # off the tensor-core routes (ops/conv3d_block.py _conv_route,
    # _mma_route): W = 8, and C = 128 with its coarse 256
    cases += [("conv3x3", "accum off-route", 8, 32, 32,
               {"accum": True, "off_route": True}),
              ("down2x_bwd", "act off-route", 16, 128, 256,
               {"off_route": True})]
    return cases


def _route_taken(name, before, off_route):
    """Asserts that the launch just made took the tensor-core kernel of
    op ``name`` (its MMA_KEY count moved) or, ``off_route``, the CUDA-core
    one (it did not); ``before`` are the counts before the launch."""
    after = launch_counts()
    mma = after[MMA_KEY[name]] - before[MMA_KEY[name]]
    if after[name] - before[name] != 1 or mma != (0 if off_route else 1):
        raise AssertionError(
            f"{name}: {mma} tensor-core launches of 1, expected "
            f"{0 if off_route else 1}")


def _vox_inputs(gen, r, cin, cout, k):
    import torch

    b = VOX_B
    x = torch.randn((b, r, r, r, cin), generator=gen, device="cuda").to(
        torch.bfloat16)
    bound = (6.0 / (k ** 3 * cin)) ** 0.5
    w = (torch.rand((k, k, k, cin, cout), generator=gen, device="cuda") * 2
         - 1) * bound
    bias = torch.randn((cout,), generator=gen, device="cuda") * 0.1
    scale = torch.rand((b, cin), generator=gen, device="cuda") * 0.6 + 0.7
    shift = torch.randn((b, cin), generator=gen, device="cuda") * 0.3
    return x, w, bias, scale, shift


def _vox_cotangents(gen, shape):
    import torch

    gy = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    gstats = torch.stack([
        torch.randn((shape[0], shape[-1]), generator=gen, device="cuda")
        * 1e-2,
        torch.randn((shape[0], shape[-1]), generator=gen, device="cuda")
        * 1e-3], dim=1)
    return gy, gstats


def _ncdhw(t):
    return t.permute(0, 4, 1, 2, 3)


def _library_bwd(gy, x, wl, stride, padding, transposed, mask):
    """One cuDNN convolution_backward of the same bf16 conv (NDHWC views
    as channels-last NCDHW)."""
    import torch

    return torch.ops.aten.convolution_backward(
        _ncdhw(gy), _ncdhw(x), wl, [wl.shape[1] if transposed else
                                    wl.shape[0]],
        [stride] * 3, [padding] * 3, [1] * 3, transposed, [0] * 3, 1, mask)


def _vox_report(res):
    lib = res["library_ms"]
    print(f"  ok  {res['name']:18s} {res['case']:12s} {res['shape']:24s} "
          f"max|err| {res['max_abs_err']:.3e}  kernel {res['ms']:.4f} / "
          f"plain {res['plain_ms']:.4f} / library "
          f"{'-' if lib is None else f'{lib:.4f}'} / bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']})"
          + (f"; wrapper {res['wrapper_ms']:.4f} ms" if "wrapper_ms" in res
             else "")
          + "".join(f"; {k[:-3].replace('_', ' ')} {res[k]:.4f} ms"
                    for k in ("device_ms", "library_device_ms", "kernel_ms",
                              "index_add_alone_ms") if k in res)
          + (f"; {res['route']}" if "route" in res else ""), flush=True)
    return res


def vox_conv3x3_case(label, r, cin, cout, kw, gen):
    """dgrad and wgrad of one 3^3 block at one shape: two result rows
    (the stem, whose input is data, launches no dgrad: one row). Each
    launch asserts its route: the tensor-core kernels on the route, the
    CUDA-core ones (conv_kernel, wgrad_kernel<kConv3>) off it."""
    import torch

    from pcseg_tpu_torch.ops import conv3d_block as cb

    x, w, bias, scale, shift = _vox_inputs(gen, r, cin, cout, 3)
    activate = kw.get("activate", True)
    y, _ = cb.conv3x3_gn_act_cuda(x, w, bias, scale, shift,
                                  activate=activate)
    gy, gstats = _vox_cotangents(gen, y.shape)
    if not kw.get("stats", True):
        y = gstats = None
    want_gadj = bool(kw.get("accum"))
    wl = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2)
    n = VOX_B * r ** 3
    flops = 2 * n * 27 * cin * cout
    cot = n * cout * 2 * (1 if y is None else 2) + (
        0 if gstats is None else VOX_B * 2 * cout * 4)
    vec = 2 * VOX_B * cin * 4 if activate else 0
    shape = f"B{VOX_B} {r}^3 {cin}->{cout}"
    rows = []
    off_route = bool(kw.get("off_route"))
    if activate:
        dargs = (gy, y, gstats, x, w, scale, shift, activate, want_gadj)
        before = launch_counts()
        dk = cb.conv3x3_dgrad_cuda(*dargs)
        torch.cuda.synchronize()
        _route_taken("conv3x3_dgrad", before, off_route)
        dp = cb.conv3x3_dgrad_plain(*dargs)
        checks = {"dx": _bf16_check(dk[0], dp[0]),
                  "dscale/dshift": _sum_check(dk[1], dp[1])}
        if want_gadj:
            checks["g'"] = (float((dk[2].float() - dp[2].float()).abs()
                                  .max()), bool(torch.equal(dk[2], dp[2])))

        def library():
            return _library_bwd(gy, x, wl, 1, 1, False, [True, False, False])

        res = {
            "name": "conv3x3_dgrad", "case": label, "shape": shape,
            "max_abs_err": _held(f"conv3x3_dgrad {label} {shape}", checks),
            "ms": time_ms(lambda: cb.conv3x3_dgrad_cuda(*dargs)),
            "plain_ms": time_ms(lambda: cb.conv3x3_dgrad_plain(*dargs),
                                iters=3),
            "library_ms": time_ms(library),
        }
        if not off_route:
            res.update(_mma_report(lambda: cb.conv3x3_dgrad_cuda(*dargs),
                                   library, dk))
        nbytes = (cot + n * cin * 2 * 2 + 27 * cin * cout * 2 + vec
                  + 2 * VOX_B * cin * 4 + (n * cout * 2 if want_gadj else 0))
        res["bound_ms"], res["bound_by"] = _bound(nbytes, flops)
        rows.append(_vox_report(res))
        if not off_route:
            _print_mma(res)
    wargs = (x, scale, shift, gy, y, gstats, activate)
    before = launch_counts()
    wk = cb.conv3x3_wgrad_cuda(*wargs)
    torch.cuda.synchronize()
    _route_taken("conv3x3_wgrad", before, off_route)
    wp = cb.conv3x3_wgrad_plain(*wargs)
    checks = {"dW": _sum_check(wk[0], wp[0]), "dbias": _sum_check(wk[1],
                                                                 wp[1])}

    def library():
        return _library_bwd(gy, x, wl, 1, 1, False, [False, True, True])

    res = {
        "name": "conv3x3_wgrad", "case": label, "shape": shape,
        "max_abs_err": _held(f"conv3x3_wgrad {label} {shape}", checks),
        "ms": time_ms(lambda: cb.conv3x3_wgrad_cuda(*wargs)),
        "plain_ms": time_ms(lambda: cb.conv3x3_wgrad_plain(*wargs), iters=3),
        "library_ms": time_ms(library),
    }
    if not off_route:
        res.update(_mma_report(lambda: cb.conv3x3_wgrad_cuda(*wargs),
                               library, wk))
    nbytes = cot + n * cin * 2 + vec + 27 * cin * cout * 4 + cout * 4
    res["bound_ms"], res["bound_by"] = _bound(nbytes, flops)
    rows.append(_vox_report(res))
    if not off_route:
        _print_mma(res)
    return rows


def vox_resample_case(name, label, r, cin, cout, kw, gen):
    import torch

    from pcseg_tpu_torch.ops import conv3d_block as cb

    up = name == "up2x_bwd"
    mma = not kw.get("off_route")
    x, w, bias, scale, shift = _vox_inputs(gen, r, cin, cout, 2)
    fwd = cb.up2x_gn_act_cuda if up else cb.down2x_gn_act_cuda
    y, _ = fwd(x, w, bias, scale, shift)
    gy, gstats = _vox_cotangents(gen, y.shape)
    args = (x, w, scale, shift, gy, y, gstats)
    kern = getattr(cb, f"{name}_cuda")
    plain = getattr(cb, f"{name}_plain")
    before = launch_counts()
    gk = kern(*args)
    torch.cuda.synchronize()
    _route_taken(name, before, not mma)
    gp = plain(*args)
    checks = {"dx": _bf16_check(gk[0], gp[0])}
    for k, a, b in zip(("dscale/dshift", "dW", "dbias"), gk[1:], gp[1:]):
        checks[k] = _sum_check(a, b)
    ro = 2 * r if up else r // 2
    shape = f"B{VOX_B} {r}^3x{cin}->{ro}^3x{cout}"
    if up:
        wl = w.to(torch.bfloat16).flip(0, 1, 2).permute(3, 4, 0, 1, 2)
    else:
        wl = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2)
    def library():
        return _library_bwd(gy, x, wl, 2, 0, up, [True, True, True])

    res = {
        "name": name, "case": label, "shape": shape,
        "max_abs_err": _held(f"{name} {label} {shape}", checks),
        "ms": time_ms(lambda: kern(*args)),
        "plain_ms": time_ms(lambda: plain(*args), iters=3),
        "library_ms": time_ms(library),
    }
    if mma:
        res.update(_mma_report(lambda: kern(*args), library, gk))
    n_in, n_out = VOX_B * r ** 3, VOX_B * ro ** 3
    nbytes = (n_in * cin * 2 * 2 + n_out * cout * 2 * 2 + 8 * cin * cout * 2
              + 4 * VOX_B * cin * 4 + VOX_B * 2 * cout * 4
              + 2 * VOX_B * cin * 4 + 8 * cin * cout * 4 + cout * 4)
    # dgrad and wgrad: each one product over the 8 taps of every pair
    flops = 2 * 2 * max(n_in, n_out) * cin * cout
    res["bound_ms"], res["bound_by"] = _bound(nbytes, flops)
    _vox_report(res)
    if mma:
        _print_mma(res)
    return res


def tri_scatter_case(label, u, go):
    """Row 11 (the devoxelize backward's trilinear scatter) on one batch:
    the kernels against the plain version (f32 sums to PN_SUM_TOL of the
    largest), two calls bit for bit, the bf16 output the f32 sums rounded
    once, no gradient for an all-masked row; device time (all of the op's
    kernels: binning, tiles, long tiles) beside the op's CUDA-event time,
    f32 and bf16 output; yardsticks: torch.zeros + index_add_ of the
    precomputed tap rows (the same function from scratch) and index_add_
    alone into a grid zeroed once outside the timing."""
    import torch

    from pcseg_tpu_torch.ops import voxel as vx

    b, m, r, c = VOX_B, VOX_M, VOX_R, VOX_CLASSES
    k = vx.trilinear_scatter(u, go, r)
    again = vx.trilinear_scatter(u, go, r)
    half = vx.trilinear_scatter(u, go, r, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    p = vx.trilinear_scatter_plain(u, go, r)
    masked = ~(go != 0).any(-1).any(-1)
    checks = {"dgrid": _sum_check(k, p),
              "two calls": (float((k - again).abs().max()),
                            torch.equal(k, again)),
              "bf16 out": (float((half.float() - k).abs().max()),
                           torch.equal(half, k.to(torch.bfloat16))),
              "masked rows": (float(k[masked].abs().max())
                              if masked.any() else 0.0,
                              not k[masked].any())}
    err = _held(f"trilinear_scatter {label}", checks)
    rows, vals = vx.trilinear_scatter_taps(u, go, r)
    rows, vals = rows.reshape(-1), vals.reshape(-1, c)
    zeroed = torch.zeros((b * r ** 3, c), device="cuda")

    def from_scratch():
        return torch.zeros((b * r ** 3, c), device="cuda").index_add_(
            0, rows, vals)

    def op(dtype=torch.float32):
        return lambda: vx.trilinear_scatter(u, go, r, out_dtype=dtype)

    res = {
        "name": "trilinear_scatter", "case": label,
        "shape": f"B{b} M{m} R{r} C{c}", "max_abs_err": err,
        "ms": device_ms(op()), "op_ms": time_ms(op()),
        "bf16_ms": device_ms(op(torch.bfloat16)),
        "bf16_op_ms": time_ms(op(torch.bfloat16)),
        "plain_ms": time_ms(lambda: vx.trilinear_scatter_plain(u, go, r),
                            iters=3),
        "library": "torch.zeros + index_add_",
        "library_ms": device_ms(from_scratch),
        "library_op_ms": time_ms(from_scratch),
        "index_add_alone_ms": device_ms(
            lambda: zeroed.index_add_(0, rows, vals)),
        "index_add_alone_op_ms": time_ms(
            lambda: zeroed.index_add_(0, rows, vals)),
        "wrapper_ms": time_ms(op()),
    }
    # read u and go once, write the grid once (f32; bf16 beside it); 8 taps
    # x C products of each real point
    n_real = int((go != 0).any(-1).sum())
    points = b * m * 3 * 4 + b * m * c * 4
    res["bound_ms"], res["bound_by"] = _bound(
        points + b * r ** 3 * c * 4, 2 * 8 * c * n_real)
    res["bf16_bound_ms"] = _bound(points + b * r ** 3 * c * 2,
                                  2 * 8 * c * n_real)[0]
    print(f"      {label}: device f32 {res['ms']:.4f} / bf16 "
          f"{res['bf16_ms']:.4f} ms (op {res['op_ms']:.4f} / "
          f"{res['bf16_op_ms']:.4f}); zeros + index_add_ "
          f"{res['library_ms']:.4f}, index_add_ alone "
          f"{res['index_add_alone_ms']:.4f}; bounds {res['bound_ms']:.4f} / "
          f"{res['bf16_bound_ms']:.4f}", flush=True)
    return _vox_report(res)


def vox_scatter_case(gen):
    """Row 11 at the step's shape, points uniform over the grid, 3/4 of
    them real."""
    import torch

    b, m, r, c = VOX_B, VOX_M, VOX_R, VOX_CLASSES
    u = torch.rand((b, m, 3), generator=gen, device="cuda") * r - 0.5
    valid = torch.rand((b, m), generator=gen, device="cuda") < 0.75
    go = torch.randn((b, m, c), generator=gen, device="cuda") * 1e-3
    return tri_scatter_case("devox bwd", u, torch.where(valid[..., None], go,
                                                    0.0))


def default_scatter_case(points, mask, gen):
    """Row 11 on phase [10]'s default batch: track events, 2,000 points
    of event 0 on one spot, points on the box faces, an all-masked row."""
    import torch

    from pcseg_tpu_torch.ops import voxel as vx

    _, _, lo, scale = vx.voxel_rows(points, mask, VOX_R)
    u = vx.trilinear_u(points, mask, lo, scale)
    go = torch.randn((VOX_B, VOX_M, VOX_CLASSES), generator=gen,
                     device="cuda") * 1e-3
    return tri_scatter_case("devox bwd, default batch", u,
                        torch.where(mask[..., None], go, 0.0))


def vox_model(dtype="bfloat16", impl="fused", default=False):
    """The phase 8 model (scatter/gather forms, conv ``impl``) or, with
    ``default``, the default configuration (every impl at "auto")."""
    import torch

    from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d

    forms = {} if default else dict(conv_impl=impl, voxelize_impl="scatter",
                                    devox_impl="gather")
    return VoxelUNet3d(
        num_classes=VOX_CLASSES, grid_size=VOX_R, width=VOX_W, levels=3,
        compute_dtype=dtype, generator=torch.Generator().manual_seed(0),
        **forms).cuda()


def vox_step_compare(card, default=False, hold=True):
    """One voxel train step with the kernels and with the plain versions,
    from the same weights and batch, and the same step in f32 on the plain
    core as the yardstick of the bf16 chain's own rounding (phase 8, or
    phase 12 with ``default``); ``hold=False`` reports without failing."""
    import numpy as np
    import torch

    from pcseg_tpu_torch.data.batching import pad_events
    from pcseg_tpu_torch.data.class_stats import scan_classes
    from pcseg_tpu_torch.data.synthetic import synthetic_events
    from pcseg_tpu_torch.ops.losses import cross_entropy_sums

    events = list(synthetic_events(VOX_B, min_points=4000, max_points=VOX_M,
                                   seed=5))
    cw = torch.from_numpy(np.asarray(scan_classes(events).weights)).cuda()
    pts, labels, masks = (torch.from_numpy(a).cuda() for a in pad_events(
        events, VOX_M, batch_size=VOX_B))
    model = vox_model(default=default)
    model32 = vox_model("float32", "xla", default=default)
    model32.load_state_dict(model.state_dict())
    forms = {"bf16": model.resolve_forms(), "f32": model32.resolve_forms()}

    def step(m, plain):
        m.zero_grad(set_to_none=True)
        logits, _ = m.apply(pts, train=True, mask=masks, plain=plain)
        num, den = cross_entropy_sums(logits, labels, cw)
        (num / den).backward()
        return (num / den).detach()

    def grads(m):
        return {n: p.grad.clone() for n, p in m.named_parameters()}

    reset_counts()
    lk = step(model, False)
    gk = grads(model)
    torch.cuda.synchronize()
    # the kernel step went through every kernel of the path, as often as
    # a step of api.fit does
    launches = launch_counts()
    per_step = DEFAULT_PER_STEP if default else VOX_PER_STEP
    if launches != {k: per_step.get(k, 0) for k in launches}:
        raise AssertionError(f"voxel train step: launch counts {launches} "
                             f"!= {per_step}")
    # the same kernel step again: the run-to-run floor of the float
    # atomics left on the path (the scatter voxelizer's index_add_),
    # beside the kernels-vs-plain reading
    lk2 = step(model, False)
    gk2 = grads(model)
    lp = step(model, True)
    gp = grads(model)
    lf = step(model32, True)
    gf = grads(model32)
    torch.cuda.synchronize()
    loss_tol = DEFAULT_LOSS_REL if default else VOX_LOSS_REL
    ok, held, zero = _step_readings(lk, gk, lp, gp, lf, gf, loss_tol)
    loss_rel_kk = abs(float(lk2) - float(lk)) / abs(float(lk))
    rel_kk = max(float((gk2[n] - gk[n]).norm() / gk[n].norm()) for n in gk
                 if n not in zero)
    ms_k = time_ms(lambda: step(model, False), iters=3)
    ms_p = time_ms(lambda: step(model, True), iters=3)
    ms_f = time_ms(lambda: step(model32, True), iters=3)
    res = {"forms": forms, **held, "loss_kernels_again": float(lk2),
           "loss_rel_kernels_vs_kernels": loss_rel_kk,
           "grad_rel_err_kernels_vs_kernels_max_held": rel_kk,
           "fwd_bwd_ms_kernels": ms_k, "fwd_bwd_ms_plain": ms_p,
           "fwd_bwd_ms_f32_plain_core": ms_f,
           "launches": {k: v for k, v in launches.items() if v},
           "card": card}
    print(f"  forms {forms}: kernel step launches {res['launches']}",
          flush=True)
    print(f"  forms {forms}: {_readings_line(held)}, "
          f"kernels again {float(lk2):.6f} (rel {loss_rel_kk:.2e}; "
          f"gradients <= {rel_kk:.3e}); fwd+bwd "
          f"{ms_k:.2f} ms with kernels, {ms_p:.2f} ms plain, {ms_f:.2f} ms "
          f"f32 plain core [{card}]", flush=True)
    if hold and not ok:
        raise AssertionError(f"voxel train step: kernels disagree with the "
                             f"plain versions: {res}")
    return res


def _step_readings(lk, gk, lp, gp, lf, gf, loss_tol):
    """Phase 8's readings of a kernel step (loss lk, gradients gk) against
    the same step through the plain versions (lp, gp) and in f32 on the
    plain core (lf, gf): (held, readings, the names of the conv biases
    that a GroupNorm follows, whose gradient is 0 up to rounding)."""
    import torch

    zero = {n for n in gp if n.endswith(".bias") and not n.startswith(
        "head") and n.replace(".bias", ".kernel") in gp}
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    rel = {n: float((gk[n] - gp[n]).norm() / gp[n].norm()) for n in gp}
    own = {n: float((gp[n] - gf[n]).norm() / gf[n].norm()) for n in gp}
    ratio = {n: float((gk[n] - gp[n]).norm())
             / max(float((gp[n] - gf[n]).norm()), 1e-30)
             for n in gp if n not in zero}
    kern = [n for n in gp if n.endswith(".kernel")]
    kk = torch.cat([gk[n].flatten() for n in kern])
    kp = torch.cat([gp[n].flatten() for n in kern])
    kcos = float(kk @ kp / (kk.norm() * kp.norm()))
    worst = max(ratio, key=ratio.get)
    ok = (loss_rel <= loss_tol and kcos >= VOX_KERNEL_COS
          and ratio[worst] <= VOX_GRAD_RATIO
          and all(torch.isfinite(g).all() for g in gk.values()))
    return ok, {
        "loss_kernels": float(lk), "loss_plain": float(lp),
        "loss_f32": float(lf), "loss_rel_err": loss_rel,
        "loss_tol": loss_tol, "kernel_grad_cosine": kcos,
        "grad_rel_err_kernels_vs_plain": rel,
        "grad_rel_err_plain_vs_f32": own, "grad_ratio": ratio,
        "grad_ratio_max": ratio[worst], "grad_worst": worst,
        "grad_rel_err_max_held": max(rel[n] for n in ratio),
        "grad_rel_err_plain_vs_f32_max_held": max(own[n] for n in ratio),
        "zero_grad_bias_rel_err_max": max(rel[n] for n in zero),
    }, zero


def _readings_line(r) -> str:
    return (f"loss kernels {r['loss_kernels']:.6f} plain "
            f"{r['loss_plain']:.6f} (rel {r['loss_rel_err']:.2e}, tol "
            f"{r['loss_tol']:.2e}), f32 {r['loss_f32']:.6f}; conv-kernel "
            f"gradient cosine {r['kernel_grad_cosine']:.6f} (tol "
            f"{VOX_KERNEL_COS}); gradients kernels vs plain <= "
            f"{r['grad_rel_err_max_held']:.3e} (rel L2), plain vs f32 <= "
            f"{r['grad_rel_err_plain_vs_f32_max_held']:.3e}; worst ratio "
            f"{r['grad_ratio_max']:.3f} at {r['grad_worst']} (tol "
            f"{VOX_GRAD_RATIO})")


def vox_fit(card, default=False):
    """The main path: api.fit on the voxel family, then Predictor on its
    best checkpoint (phase 9 with the scatter/gather forms, or phase 12
    with ``default``: no impl override). Returns (fit launches, serving
    launches, result)."""
    import math

    import numpy as np
    import torch

    from pcseg_tpu_torch import api
    from pcseg_tpu_torch.data.synthetic import synthetic_events
    from pcseg_tpu_torch.infer import Predictor

    # 30 events: 24 train (3 batches of 8), 6 val (one eval batch)
    events = list(synthetic_events(30, min_points=4000, max_points=VOX_M,
                                   seed=3))
    if default:
        overrides = ["model.name=voxel_unet3d", "model.compute_dtype=bfloat16",
                     f"data.batch_size={VOX_B}", f"data.buckets={VOX_M}",
                     "train.checkpoint_dir=build/chip_smoke_ckpt_default"]
        per_step, per_forward = DEFAULT_PER_STEP, DEFAULT_PER_FORWARD
    else:
        overrides = [
            "model.name=voxel_unet3d", f"model.num_classes={VOX_CLASSES}",
            f"model.grid_size={VOX_R}", f"model.unet_width={VOX_W}",
            "model.levels=3", "model.compute_dtype=bfloat16",
            "model.impl=fused", "model.voxelize_impl=scatter",
            "model.devox_impl=gather", f"data.batch_size={VOX_B}",
            f"data.buckets={VOX_M}",
            "train.checkpoint_dir=build/chip_smoke_ckpt_voxel"]
        per_step, per_forward = VOX_PER_STEP, PER_FORWARD
    overrides += ["train.num_epochs=2", "train.log_every_steps=0"]

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = api.fit(events, overrides=overrides, log=lambda _: None)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = sum(h["train_steps"] for h in res.history)
    evals = len(res.history)          # one eval batch per epoch
    expected = {k: per_step.get(k, 0) * steps + per_forward.get(k, 0) * evals
                for k in launches}
    if launches != expected:
        raise AssertionError(f"voxel fit: launch counts {launches} != "
                             f"{expected} ({steps} train steps, {evals} "
                             "eval batches)")
    losses = [h[k] for h in res.history for k in ("train_loss", "val_loss")]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"voxel fit: non-finite loss {losses}")
    warm = res.history[-1]
    ms_step = warm["train_seconds"] * 1e3 / warm["train_steps"]

    # the best checkpoint, served on the card
    reset_counts()
    pred = Predictor.from_checkpoint(res.checkpoint_path)
    served = [p for p, _ in events[:VOX_B]]
    preds = pred.predict_batch(served, batch_size=VOX_B)
    logits = pred.logits(served[0])
    torch.cuda.synchronize()
    serve_launches = launch_counts()
    want = {k: per_forward.get(k, 0) * 2 for k in serve_launches}
    if serve_launches != want:
        raise AssertionError(f"serving the checkpoint: launch counts "
                             f"{serve_launches} != {want}")
    if [p.shape[0] for p in preds] != [e.shape[0] for e in served] or \
            not np.isfinite(logits).all():
        raise AssertionError("serving the checkpoint: bad predictions")
    out = {
        "forms": pred.model.resolve_forms(),
        "steps": steps, "eval_batches": evals, "launches": launches,
        "launches_per_step": {k: (v - per_forward.get(k, 0) * evals) / steps
                              for k, v in launches.items() if v},
        "train_loss": [h["train_loss"] for h in res.history],
        "val_loss": [h["val_loss"] for h in res.history],
        "first_epoch_train_ms_per_step":
            res.history[0]["train_seconds"] * 1e3 / res.history[0][
                "train_steps"],
        "ms_per_step": ms_step,
        "points_per_s": VOX_B * VOX_M / (ms_step / 1e3),
        "epoch_seconds": [h["seconds"] for h in res.history],
        "peak_mem_gib": peak, "serve_launches": serve_launches,
        "served_events": len(preds), "card": card,
    }
    print(f"  fit voxel_unet3d {out['forms']} [{card}]: {steps} train steps "
          f"at B{VOX_B} x "
          f"{VOX_M}, launches per step {out['launches_per_step']}; train "
          f"loss {out['train_loss']}, val loss {out['val_loss']}; "
          f"{ms_step:.2f} ms/step (epoch 2; epoch 1 "
          f"{out['first_epoch_train_ms_per_step']:.2f}), "
          f"{out['points_per_s']:.4e} points/s; peak {peak:.3f} GiB; best "
          f"checkpoint served {len(preds)} events", flush=True)
    return launches, serve_launches, out


# ---------------------------------------------------------------------------
# the voxel U-Net's default configuration
# ---------------------------------------------------------------------------

DEFAULT_REPLACES = {
    "voxelize_contract": "pcseg_tpu/ops/pallas/onehot_contract.py:191",
    "trilinear_gather": "pcseg_tpu/ops/pallas/onehot_contract.py:376",
    "head_grid2": "pcseg_tpu/ops/pallas/conv3d_block.py:1543",
    "head_grid2_bwd": "pcseg_tpu/ops/pallas/conv3d_block.py:1583",
}
# kernel vs plain version on identical inputs: the voxel counts exactly;
# the voxel sums (bf16 values added in f32 in atomic order) and the gather
# (its <= 8 taps in the plain version's order) to 1e-5 of the largest
# |ref|; the head's bf16 y and dx as Y_RTOL / Y_ATOL_REL, its f32 sums over
# the 2.1 M voxels as PN_SUM_TOL
ONEHOT_TOL = 1e-5


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call of ``fn``: its CUDA kernels summed by
    torch.profiler over ``iters`` warm calls. Phase 10's calls are short
    enough that CUDA events around back-to-back calls time the host's
    launch rate instead (reported beside it as ``wrapper_ms``); profiled
    again while launches go unrecorded. A profile that keeps no kernel
    time at all (late in a run, torch.max's reduction in phase 18 read 0)
    gives way to CUDA events around the calls."""
    from pcseg_tpu_torch.profile_serving import profile_calls

    ms = sum(profile_calls(fn, iters).values())
    return ms if ms > 1e-4 else time_ms(fn, iters)


def _onehot_check(got, ref):
    err = float((got - ref).abs().max())
    return err, err <= ONEHOT_TOL * float(ref.abs().max())


def default_batch():
    """The B8 x 8192 batch of the default path (7 synthetic events of
    4,000-8,192 points and an all-masked last row), with 2,000 points of
    event 0 on one spot (a voxel hit by many points); each event's
    extreme points lie on the faces of its box."""
    import torch

    from pcseg_tpu_torch.data.batching import pad_events
    from pcseg_tpu_torch.data.synthetic import synthetic_events

    events = list(synthetic_events(VOX_B - 1, min_points=4000,
                                   max_points=VOX_M, seed=7))
    pts, _, mask = pad_events(events, VOX_M, batch_size=VOX_B)
    pts[0, 1:2001, :3] = pts[0, 0, :3]
    return torch.from_numpy(pts).cuda(), torch.from_numpy(mask).cuda()


def one_kernel_a_call(fn, key, iters: int = 10, attempts: int = 3):
    """(0, ok): ``iters`` warm calls of ``fn`` launch no device kernel or
    memset whose name lacks ``key``, and at most ``iters`` of those, at
    least one recorded (torch.profiler; late in a long process it drops
    launches, so a profile that recorded none is taken again; copies,
    which another thread of the process may issue meanwhile, are not
    counted)."""
    from pcseg_tpu_torch.profile_serving import device_profile

    for _ in range(attempts):
        res, _ = device_profile(lambda: [fn() for _ in range(iters)])
        got = {k["name"]: k["calls"] for k in res["kernels"]
               if not k["name"].startswith("Memcpy")}
        if got:
            break
    n = sum(got.values())
    print(f"  kernels of {iters} calls: {got}", flush=True)
    return 0.0, 0 < n <= iters and all(key in name for name in got)


def voxelize_site_case(flat, ext, r, case, edges=None):
    """Row 10 on one call site's ids and rows, int64 as the callers pass
    them: kernel vs plain version (counts exact, sums to ONEHOT_TOL,
    nothing for the all-masked row when there is one, one kernel a call:
    no zero fill, no id cast), whether two calls give the same bits
    (float atomics: reported, not held), and its times: the op (one
    launch) by device time, the plain version, torch.zeros + index_add_
    (the same function from scratch) and index_add_ alone; ``edges``:
    further (err, ok) checks."""
    import torch

    from pcseg_tpu_torch.ops import voxel as vx

    b, m, c1 = ext.shape
    r3 = r ** 3
    k = vx.voxelize_contract(flat, ext, r)
    torch.cuda.synchronize()
    p = vx.voxelize_contract_plain(flat, ext, r)
    hot = int(p[..., -1].max())
    dcnt = float((k[..., -1] - p[..., -1]).abs().max())
    checks = {"sums": _onehot_check(k, p), "counts": (dcnt, dcnt == 0.0),
              "one kernel": one_kernel_a_call(
                  lambda: vx.voxelize_contract(flat, ext, r),
                  "voxelize_contract_kernel"),
              **(edges or {})}
    if bool(flat[-1].eq(r3).all()):     # an all-masked row: nothing
        checks["dummy row"] = (float(k[-1].abs().max()), not k[-1].any())
    err = _held(f"voxelize_contract {case}", checks)
    rows = (flat + torch.arange(b, device="cuda")[:, None] * (r3 + 1)
            ).reshape(-1)
    vals = ext.to(torch.bfloat16).float().reshape(-1, c1)
    out = torch.zeros((b * (r3 + 1), c1), device="cuda")
    n_real = int((flat < r3).sum())

    def kernel():
        return vx.voxelize_contract(flat, ext, r)

    def from_scratch():
        return torch.zeros((b * (r3 + 1), c1), device="cuda").index_add_(
            0, rows, vals)

    res = {
        "name": "voxelize_contract", "case": case,
        "shape": f"B{b} M{m} -> {r}^3x{c1}", "max_abs_err": err,
        "hot_voxel_points": hot,
        "ms": device_ms(kernel),
        # the one launch: the op's device time
        "kernel_ms": kernel_ms(kernel, ("voxelize_contract_kernel",)),
        # float atomics: two calls may differ in their last bits
        "two_calls_identical": bool(torch.equal(k, kernel())),
        "wrapper_ms": time_ms(kernel),
        "plain_ms": device_ms(
            lambda: vx.voxelize_contract_plain(flat, ext, r)),
        # the same function from scratch: torch.zeros of the grid, then
        # one index_add_ of the bf16-rounded rows at the same ids
        "library_ms": device_ms(from_scratch),
        # index_add_ alone, into a grid zeroed once outside the timing
        "index_add_alone_ms": device_ms(lambda: out.index_add_(0, rows,
                                                               vals)),
    }
    # ids (as passed) and rows read once, the f32 grid written once; C1
    # adds a point
    res["bound_ms"], res["bound_by"] = _bound(
        b * m * flat.element_size() + b * m * c1 * 4 + b * r3 * c1 * 4,
        n_real * c1, F32_FLOP_PER_S)
    return _vox_report(res)


def default_voxelize_case(points, mask):
    """Row 10 at the default voxel model's call site (ops/voxel.py
    voxelize): the B8 x 8192 default batch at 64^3, C1 3, with points on
    the box faces, a voxel hit by 2,000 points and an all-masked row."""
    import torch

    from pcseg_tpu_torch.ops import voxel as vx

    r = VOX_R
    flat, ext, _, _ = vx.voxel_rows(points, mask, r)
    zyx = (flat // (r * r), flat // r % r, flat % r)
    faces = int((mask & torch.stack([(a == 0) | (a == r - 1) for a in zyx])
                 .any(0)).sum())
    hot = int((flat[0] == flat[0, 0]).sum())
    res = voxelize_site_case(flat, ext, r, "voxelize", {
        "edge cases": (0.0, faces > 0 and hot >= 2000
                       and bool(flat[-1].eq(r ** 3).all()))})
    res["points_on_faces"] = faces
    return res


def sparse_voxelize_case():
    """Row 10 at the sparse model's call site (ops/block_sparse.py
    block_sparse_voxelize): tile-major ids of phase 13's B8 x 8192 track
    events at R64 in tiles of 8^3, C1 2 (the feature and the count)."""
    import torch

    from pcseg_tpu_torch.data.synthetic import track_events
    from pcseg_tpu_torch.ops import voxel as vx

    r, t = SP_R, SP_T
    pts = torch.from_numpy(track_events(SP_B, SP_M, 0)).cuda()
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device="cuda")
    flat, _, _ = vx.voxel_indices(pts[..., :3].float(), mask, r)
    i, j, k = flat // (r * r), (flat // r) % r, flat % r
    nt = r // t
    tid = ((i // t) * nt + (j // t)) * nt + (k // t)
    intra = ((i % t) * t + (j % t)) * t + (k % t)
    blocked = torch.where(flat >= r ** 3, r ** 3, tid * t ** 3 + intra)
    ext = torch.cat([pts[..., 3:].float(),
                     torch.ones_like(pts[..., :1].float())], -1)
    return voxelize_site_case(blocked, ext, r, "voxelize sparse")


def uniform_voxelize_case():
    """Row 10 on ids uniform over the 64^3 grid, 3/4 of B8 x 8192 points
    real, C1 3 (a feature, occupancy and count): no voxel holds many
    points, so the table's write sets the time."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    r = VOX_R
    real = torch.rand((VOX_B, VOX_M), generator=gen, device="cuda") < 0.75
    ids = torch.randint(0, r ** 3, (VOX_B, VOX_M), generator=gen,
                        device="cuda")
    rows = torch.cat([torch.rand((VOX_B, VOX_M, 1), generator=gen,
                                 device="cuda"),
                      torch.ones((VOX_B, VOX_M, 2), device="cuda")], -1)
    return voxelize_site_case(torch.where(real, ids, r ** 3),
                              torch.where(real[..., None], rows, 0.0), r,
                              "voxelize uniform")


# rows 11 and 13 past 32 channels: the class counts the matmul devoxelize
# takes at 32^3 reach 121 (R^3 (NC + 1) <= 4e6); each on the default batch
# at 32^3, bf16 grid cotangent as the step writes it, held as at C4 and
# two calls bit for bit
WIDE_DEVOX_C = (33, 40, 64, 121)


def wide_devox_cases(points, mask, gen):
    """Rows 13 and 11 at B8 x 8192, 32^3, C in WIDE_DEVOX_C."""
    import torch

    from pcseg_tpu_torch.ops import voxel as vx

    b, m, r = VOX_B, VOX_M, 32
    _, _, lo, scale = vx.voxel_rows(points, mask, r)
    u = vx.trilinear_u(points, mask, lo, scale)
    out = []
    for c in WIDE_DEVOX_C:
        g2 = torch.randn((b, r * r, r * c), generator=gen,
                         device="cuda").to(torch.bfloat16)
        k = vx.trilinear_gather(u, mask, g2)
        torch.cuda.synchronize()
        err = _held(f"trilinear_gather C{c}", {
            "out": _onehot_check(k, vx.trilinear_gather_plain(u, mask, g2)),
            "masked rows": (float(k[~mask].abs().max()), not k[~mask].any()),
            "two calls identical": (0.0, bool(torch.equal(
                k, vx.trilinear_gather(u, mask, g2))))})
        out.append({"name": "trilinear_gather", "shape":
                    f"B{b} M{m} R{r} C{c}", "max_abs_err": err,
                    "ms": device_ms(lambda: vx.trilinear_gather(u, mask,
                                                                g2))})
        go = torch.where(mask[..., None], torch.randn(
            (b, m, c), generator=gen, device="cuda"), 0.0)
        ks = vx.trilinear_scatter(u, go, r, out_dtype=torch.bfloat16)
        k32 = vx.trilinear_scatter(u, go, r)
        torch.cuda.synchronize()
        ps = vx.trilinear_scatter_plain(u, go, r)
        err = _held(f"trilinear_scatter C{c}", {
            "f32 sums": _sum_check(k32, ps),
            "bf16 out": _bf16_check(ks, ps.to(torch.bfloat16)),
            "bf16 is the f32 sums rounded once": (0.0, bool(torch.equal(
                ks, k32.to(torch.bfloat16)))),
            "two calls identical": (0.0, bool(torch.equal(
                k32, vx.trilinear_scatter(u, go, r))))})
        out.append({"name": "trilinear_scatter", "shape":
                    f"B{b} M{m} R{r} C{c} bf16", "max_abs_err": err,
                    "ms": device_ms(lambda: vx.trilinear_scatter(
                        u, go, r, out_dtype=torch.bfloat16))})
        print(f"  rows 13 / 11 at C{c}: {out[-2]['ms']:.4f} / "
              f"{out[-1]['ms']:.4f} ms", flush=True)
    return out


def default_gather_case(points, mask, gen):
    import torch
    import torch.nn.functional as F

    from pcseg_tpu_torch.ops import voxel as vx

    b, m, r, c = VOX_B, VOX_M, VOX_R, VOX_CLASSES
    _, _, lo, scale = vx.voxel_rows(points, mask, r)
    u = vx.trilinear_u(points, mask, lo, scale)
    g2 = torch.randn((b, r * r, r * c), generator=gen, device="cuda").to(
        torch.bfloat16)
    k = vx.trilinear_gather(u, mask, g2)
    torch.cuda.synchronize()
    p = vx.trilinear_gather_plain(u, mask, g2)
    checks = {"out": _onehot_check(k, p),
              "masked rows": (float(k[~mask].abs().max()),
                              not k[~mask].any())}
    err = _held("trilinear_gather", checks)
    # the yardstick: grid_sample of the same clipped trilinear function in
    # f32 (border padding clamps u to [0, R-1], as the per-tap clip does)
    grid5 = g2.float().reshape(b, r, r, r, c).permute(0, 4, 1, 2, 3)
    grid5 = grid5.contiguous()
    coords = ((2 * u + 1) / r - 1).flip(-1).reshape(b, 1, 1, m, 3)

    def library():
        return F.grid_sample(grid5, coords, mode="bilinear",
                             padding_mode="border", align_corners=False)

    lib = library().reshape(b, c, m).transpose(1, 2)
    lib_err = float((torch.where(mask[..., None], lib, 0.0)
                     - vx.trilinear_gather_plain(u, mask, g2, False))
                    .abs().max())
    # the grid rows this data touches, each read once
    zi, _, xs, _ = vx._tri_taps(u, r, lambda t: t)
    base = torch.arange(b, device="cuda")[:, None] * r ** 3
    touched = torch.cat([(base + z * r + x)[mask] for z in zi for x in xs])
    n_rows = int(torch.unique(touched).numel())
    n_real = int(mask.sum())
    res = {
        "name": "trilinear_gather", "case": "devox fwd",
        "shape": f"B{b} M{m} R{r} C{c}", "max_abs_err": err,
        "library_max_abs_err_vs_f32_plain": lib_err, "grid_rows_read": n_rows,
        "ms": device_ms(lambda: vx.trilinear_gather(u, mask, g2)),
        "wrapper_ms": time_ms(lambda: vx.trilinear_gather(u, mask, g2)),
        "plain_ms": device_ms(lambda: vx.trilinear_gather_plain(u, mask, g2)),
        "library_ms": device_ms(library),
    }
    # u, mask and the touched bf16 grid rows read once, out written once;
    # a multiply and an add per tap and channel of every real point
    res["bound_ms"], res["bound_by"] = _bound(
        b * m * 3 * 4 + b * m + n_rows * c * 2 + b * m * c * 4,
        2 * 8 * c * n_real, F32_FLOP_PER_S)
    return _vox_report(res)


# the head at widths the JAX package's fused head takes beyond the
# bench's: 20 and 40 classes at 32^3 x 16 (the VoxelUNet3d models of phase
# 12b) and C 128 -> 8 classes, B8 each, held as the 64^3 case
HEAD_WIDTHS = ((32, 16, 20), (32, 16, 40), (32, 128, 8))


def default_head_cases(gen):
    """The fused head forward and backward at 64^3 x 16 -> 4: two rows."""
    return _head_cases(gen, VOX_R, VOX_W, VOX_CLASSES)


def head_width_cases(gen):
    """The head at HEAD_WIDTHS: two rows each."""
    return [row for r, c, nc in HEAD_WIDTHS
            for row in _head_cases(gen, r, c, nc)]


def _head_cases(gen, r, c, nc):
    """The fused head forward and backward at B8 r^3 x c -> nc against
    their plain versions, the backward's two calls bit for bit."""
    import torch

    from pcseg_tpu_torch.ops import conv3d_block as cb

    x, w, bias, scale, shift = _vox_inputs(gen, r, c, nc, 1)
    n = x.numel() // c
    shape = f"B{VOX_B} {r}^3x{c}->{nc}"
    fwd = (x, w, bias, scale, shift)
    yk = cb.head_grid2_cuda(*fwd)
    torch.cuda.synchronize()
    err = _held("head_grid2", {
        "y": _bf16_check(yk, cb.head_grid2_plain(*fwd)),
        # the tensor-core sums' order is fixed by the shapes
        "two calls identical": (0.0, bool(torch.equal(
            yk, cb.head_grid2_cuda(*fwd))))})
    gy = torch.randn(yk.shape, generator=gen, device="cuda").to(torch.bfloat16)
    bwd = (x, gy, w, scale, shift)
    gk = cb.head_grid2_bwd_cuda(*bwd)
    torch.cuda.synchronize()
    gp = cb.head_grid2_bwd_plain(*bwd)
    checks = {"dx": _bf16_check(gk[0], gp[0])}
    for name, a, ref in zip(("dscale/dshift", "dW", "dbias"), gk[1:],
                            gp[1:]):
        checks[name] = _sum_check(a, ref)
    # fixed-order sums, no float atomics: two calls give the same bits
    checks["two calls identical"] = (0.0, all(
        torch.equal(a, b) for a, b in zip(gk, cb.head_grid2_bwd_cuda(*bwd))))
    bwd_err = _held("head_grid2_bwd", checks)
    a = cb.act(x, scale, shift).reshape(n, c)
    wq = w.reshape(c, nc).to(torch.bfloat16)
    g = gy.reshape(n, nc)
    vec = c * nc * 4 + 2 * VOX_B * c * 4
    fwd_res = {
        "name": "head_grid2", "case": "head", "shape": shape,
        "max_abs_err": err,
        "ms": device_ms(lambda: cb.head_grid2_cuda(*fwd)),
        "wrapper_ms": time_ms(lambda: cb.head_grid2_cuda(*fwd)),
        "plain_ms": device_ms(lambda: cb.head_grid2_plain(*fwd)),
        # the activated grid by the head's weights, one bf16 matmul
        "library_ms": device_ms(lambda: a @ wq),
    }
    fwd_res["bound_ms"], fwd_res["bound_by"] = _bound(
        n * c * 2 + n * nc * 2 + vec + nc * 4, 2 * n * c * nc)
    bwd_res = {
        "name": "head_grid2_bwd", "case": "head bwd", "shape": shape,
        "max_abs_err": bwd_err,
        # its two kernels: the tile kernel and the fixed-order sums
        "ms": device_ms(lambda: cb.head_grid2_bwd_cuda(*bwd)),
        "wrapper_ms": time_ms(lambda: cb.head_grid2_bwd_cuda(*bwd)),
        "plain_ms": device_ms(lambda: cb.head_grid2_bwd_plain(*bwd)),
        # its two products, dY W^T and X^T dY, in bf16
        "library_ms": device_ms(lambda: (g @ wq.t(), a.t() @ g)),
    }
    bwd_res["bound_ms"], bwd_res["bound_by"] = _bound(
        n * c * 2 * 2 + n * nc * 2 + vec + 2 * VOX_B * c * 4 + c * nc * 4
        + nc * 4, 4 * n * c * nc)
    return [_vox_report(fwd_res), _vox_report(bwd_res)]


# phase 12b: U-Nets whose fused head has 20 and 40 classes. The JAX
# package routes VoxelUNet3d(20 or 40 classes, 32^3, width 16, 3 levels,
# bf16) through fused_head_grid2, as R^3 (NC + 1) <= 4e6 gives the matmul
# devoxelize (pcseg_tpu/ops/voxel.py resolve_devoxelize_impl); at 40
# classes its gather and scatter run past 32 channels
WIDE_CLASSES, WIDE_R = (20, 40), 32
# the launches of one served forward and of one train step of such a
# model: rows 10, 13 and 8, and rows 9 and 11 in the step
WIDE_SERVED = {"head_grid2": 1, "voxelize_contract": 1,
               "trilinear_gather": 1, "head_grid2_bwd": 0,
               "trilinear_scatter": 0}
WIDE_STEPPED = {"head_grid2": 1, "voxelize_contract": 1,
                "trilinear_gather": 1, "head_grid2_bwd": 1,
                "trilinear_scatter": 1}


def wide_head_phase(card, classes):
    """Phase 12b: the ``classes``-class 32^3 U-Net served by Predictor and
    trained one step through its fused grid2 head on the card, each
    against the plain versions: logits to LOGITS_REL, the loss to
    DEFAULT_LOSS_REL, finite gradients; the launches of each run counted
    from 0."""
    import numpy as np
    import torch

    from pcseg_tpu_torch.data.batching import pad_events
    from pcseg_tpu_torch.data.synthetic import synthetic_events
    from pcseg_tpu_torch.infer import Predictor
    from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d
    from pcseg_tpu_torch.ops.losses import cross_entropy_sums

    model = VoxelUNet3d(
        num_classes=classes, grid_size=WIDE_R, width=VOX_W, levels=3,
        compute_dtype="bfloat16",
        generator=torch.Generator().manual_seed(0)).cuda()
    forms = model.resolve_forms()
    if forms["head"] != "grid2":
        raise AssertionError(f"{classes}-class U-Net: forms {forms}, not "
                             f"the fused grid2 head")
    events = [p for p, _ in synthetic_events(
        VOX_B, min_points=4000, max_points=VOX_M, seed=6)]
    pred = Predictor(model.state_dict(), classes, model=model)
    reset_counts()
    preds = pred.predict_batch(events, batch_size=VOX_B)
    torch.cuda.synchronize()
    served = launch_counts()
    if any(served[k] != v for k, v in WIDE_SERVED.items()):
        raise AssertionError(f"{classes}-class serving launches {served}")
    if [p.shape[0] for p in preds] != [e.shape[0] for e in events]:
        raise AssertionError(f"{classes}-class predictions do not match the "
                             f"events")

    rng = np.random.default_rng(6)
    pts, labels, masks = (torch.from_numpy(a).cuda() for a in pad_events(
        [(e, rng.integers(0, classes, e.shape[0])) for e in events],
        VOX_M, batch_size=VOX_B))
    out_k = model(pts, masks)
    out_p = model(pts, masks, plain=True)
    err = float((out_k - out_p).abs().max())
    scale = float(out_p.abs().max())
    if out_k.shape != (VOX_B, VOX_M, classes) or not bool(
            torch.isfinite(out_k).all()) or err > LOGITS_REL * scale:
        raise AssertionError(f"{classes}-class logits: shape "
                             f"{tuple(out_k.shape)}, max|err| {err} vs "
                             f"max|logit| {scale}")
    cw = torch.ones(classes, device="cuda")

    def step(plain):
        model.zero_grad(set_to_none=True)
        logits, _ = model.apply(pts, train=True, mask=masks, plain=plain)
        num, den = cross_entropy_sums(logits, labels, cw)
        (num / den).backward()
        return float((num / den).detach()), {
            n: q.grad.clone() for n, q in model.named_parameters()}

    reset_counts()
    lk, gk = step(False)
    torch.cuda.synchronize()
    stepped = launch_counts()
    if any(stepped[k] != v for k, v in WIDE_STEPPED.items()):
        raise AssertionError(f"{classes}-class train step launches "
                             f"{stepped}")
    lp, gp = step(True)
    loss_rel = abs(lk - lp) / abs(lp)
    rel = {n: float((gk[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30))
           for n in gp}
    finite = all(bool(torch.isfinite(g).all()) for g in gk.values())
    res = {"model": f"VoxelUNet3d({classes}, grid_size={WIDE_R}, "
                    f"width={VOX_W}, levels=3, bf16)", "forms": forms,
           "logits_max_abs_err": err, "max_abs_logit": scale,
           "loss_kernels": lk, "loss_plain": lp, "loss_rel_err": loss_rel,
           "loss_tol": DEFAULT_LOSS_REL,
           "head_grad_rel_err": {n: rel[n] for n in rel
                                 if n.startswith("head")},
           "grad_rel_err_max": max(rel.values()),
           "serving_launches": {k: v for k, v in served.items() if v},
           "step_launches": {k: v for k, v in stepped.items() if v},
           "card": card}
    print(f"  {classes}-class 32^3 U-Net [{card}]: served {len(preds)} events "
          f"(logits max|err| {err:.3e}, max|logit| {scale:.3f}); train "
          f"step loss kernels {lk:.6f} plain {lp:.6f} (rel {loss_rel:.2e}, "
          f"tol {DEFAULT_LOSS_REL:.2e}); gradients rel <= "
          f"{res['grad_rel_err_max']:.3e}; launches {res['step_launches']}",
          flush=True)
    if loss_rel > DEFAULT_LOSS_REL or not finite:
        raise AssertionError(f"{classes}-class train step disagrees with "
                             f"the plain versions: {res}")
    return served, stepped, res


# ---------------------------------------------------------------------------
# the sparse family: serving the block-sparse SparseVoxelNet (slice 5)
# ---------------------------------------------------------------------------

# pcseg_tpu/bench.py:210-214's sparse configuration: R64, width 64, depth
# 4, 2 levels, tile 8, tile capacities (64, 32), bf16, 4 classes, on
# B8 x 8192 track events (bench.py:176-191)
SP_R, SP_W, SP_T, SP_CAPS, SP_B, SP_M = 64, 64, 8, (64, 32), 8, 8192
SP_SOURCES = {"block_conv": "pcseg_tpu_torch/csrc/block_conv.cu",
              "bias_ln_relu_mask": "pcseg_tpu_torch/csrc/fused_ln.cu"}
SP_REPLACES = {"block_conv": "pcseg_tpu/ops/pallas/block_conv.py:382",
               "bias_ln_relu_mask": "pcseg_tpu/ops/pallas/fused_ln.py:178"}
# wrapper launches per serving forward: depth 3^3 convs a level, the stem
# included, all on the tensor-core route (bf16, t = 8, widths 64 and 128);
# an LN after each, after the down conv and after the up conv
SP_PER_FORWARD = {"block_conv": 8, "block_conv_mma": 8,
                  "bias_ln_relu_mask": 10, "voxelize_contract": 1}
# kernel vs plain version on identical inputs: both sum in f32 and round
# once, in another order; bf16 outputs as Y_RTOL / Y_ATOL_REL, f32 outputs
# to 1e-5 of the largest |ref|
SP_F32_TOL = 1e-5


def sparse_levels(cap0=SP_CAPS[0], t=SP_T):
    """The tiles of the bench batch (B8 x 8192 track events, seed 0) at
    level 0 (tile edge ``t``, capacity ``cap0``) and level 1, as the
    serving forward builds them."""
    import torch

    from pcseg_tpu_torch.data.synthetic import track_events
    from pcseg_tpu_torch.ops.block_sparse import (
        block_pool,
        block_sparse_voxelize,
    )

    pts = torch.from_numpy(track_events(SP_B, SP_M, 0)).cuda()
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device="cuda")
    bs, _, _ = block_sparse_voxelize(pts, mask, SP_R, cap0, t, plain=True)
    return bs, block_pool(bs, SP_CAPS[1])[0]


def _sp_check(got, ref):
    import torch

    if got.dtype == torch.bfloat16:
        return _bf16_check(got, ref)
    err = float((got - ref).abs().max())
    return err, err <= SP_F32_TOL * float(ref.abs().max())


def sparse_cases(gen):
    """Phase 13: both kernels at every serving shape of the bench
    configuration, and an f32 case at width 16 (the factory default)."""
    import torch

    bf = torch.bfloat16
    bs, bsc = sparse_levels()
    cases = [sp_conv_case("fwd", bs, "stem", 2, SP_W, bf, gen),
             sp_conv_case("fwd", bs, "level 0", SP_W, SP_W, bf, gen),
             sp_conv_case("fwd", bsc, "level 1", 2 * SP_W, 2 * SP_W, bf,
                          gen),
             sp_ln_case("fwd", bs.active, "level 0", SP_W, bf, gen),
             sp_ln_case("fwd", bsc.active, "level 1", 2 * SP_W, bf, gen)]
    bs128, _ = sparse_levels(cap0=128)
    f32 = torch.float32
    cases += [sp_conv_case("fwd", bs128, "f32 w16", 16, 16, f32, gen),
              sp_ln_case("fwd", bs128.active, "f32 w16", 16, f32, gen)]
    return cases


def sparse_serve(card):
    """Phase 14: Predictor on the full-width sparse model: launches per
    forward, dropped tiles, logits against the plain versions, times."""
    import warnings

    import numpy as np
    import torch

    from pcseg_tpu_torch.data.batching import pad_events
    from pcseg_tpu_torch.data.synthetic import track_events
    from pcseg_tpu_torch.infer import Predictor
    from pcseg_tpu_torch.ops.block_sparse import block_sparse_voxelize
    from pcseg_tpu_torch.profile_serving import sparse_model

    model = sparse_model()
    pred = Predictor(model.state_dict(), 4, model=model,
                     strict_capacity=True)
    rng = np.random.default_rng(0)
    events = [track_events(1, int(m), rng)[0]
              for m in rng.integers(4000, SP_M + 1, 16)]
    single = track_events(1, 1000, 1)[0]
    n_batch_pts = sum(e.shape[0] for e in events)

    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # no capacity overflow
        reset_counts()
        t0 = time.perf_counter()
        preds = pred.predict_batch(events, batch_size=SP_B)
        t1 = time.perf_counter()
        p_single = pred.predict(single)
        t2 = time.perf_counter()
        launches = launch_counts()
    forwards = 3
    expected = {k: SP_PER_FORWARD.get(k, 0) * forwards for k in launches}
    print(f"  main path: {forwards} forwards, launches "
          f"{ {k: v for k, v in launches.items() if v} } (expected "
          f"{ {k: v for k, v in expected.items() if v} }, none of the "
          f"others)", flush=True)
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    if [p.shape[0] for p in preds] != [e.shape[0] for e in events] or \
            p_single.shape != (single.shape[0],):
        raise AssertionError("prediction shapes do not match the events")
    first = {"batch_ms": (t1 - t0) * 1e3, "single_ms": (t2 - t1) * 1e3}

    reps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_batch(events, batch_size=SP_B)
        t1 = time.perf_counter()
        pred.predict(single)
        t2 = time.perf_counter()
        reps.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
    batch_ms = sorted(r[0] for r in reps)[1]
    single_ms = sorted(r[1] for r in reps)[1]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # kernels vs plain versions through the whole model, one batch of 8
    pts, _, msk = pad_events(
        [(e, np.zeros(e.shape[0], np.int64)) for e in events[:SP_B]], SP_M,
        batch_size=SP_B)
    points = torch.from_numpy(pts).cuda()
    mask = torch.from_numpy(msk).cuda()
    out_k, dropped = model(points, mask, return_overflow=True)
    out_p = model(points, mask, plain=True)
    if out_k.shape != (SP_B, SP_M, 4) or not torch.isfinite(out_k).all() \
            or out_k[~mask].any():
        raise AssertionError(f"logits: shape {tuple(out_k.shape)}, "
                             "non-finite values or nonzero masked rows")
    if dropped.any():
        raise AssertionError(f"dropped tiles {dropped.tolist()}")
    d = (out_k - out_p).abs()
    err = float(d.max())
    scale = float(out_p.abs().max())
    agree = float((out_k.argmax(-1) == out_p.argmax(-1))[mask].float()
                  .mean())
    print(f"  logits kernels vs plain on the card: max|err| {err:.4e} "
          f"(max|logit| {scale:.3f}; tol {LOGITS_REL * scale:.4f}), argmax "
          f"agreement {agree:.6f} (tol {ARGMAX_AGREE}); dropped tiles "
          f"{dropped.tolist()}", flush=True)
    if not (err <= LOGITS_REL * scale and agree >= ARGMAX_AGREE):
        raise AssertionError(f"logits disagree with the plain model: max "
                             f"err {err}, argmax agreement {agree}")
    bs, _, _ = block_sparse_voxelize(points, mask, SP_R, SP_CAPS[0], SP_T,
                                     plain=True)
    res = {
        "model": "SparseVoxelNet R64/w64/d4/L2 t8 caps (64, 32) bf16",
        "first_call": first,
        "predict_batch_16_ms": batch_ms,
        "ms_per_event_batched": batch_ms / len(events),
        "points_per_s_batched": n_batch_pts / (batch_ms / 1e3),
        "predict_1000pt_ms": single_ms,
        "peak_mem_gib": peak_gib,
        "logits_max_abs_err": err,
        "argmax_agreement": agree,
        "dropped_tiles": int(dropped.sum()),
        "occupied_tiles_level0": bs.tile_mask.sum(1).tolist(),
        "active_voxels": bs.active.reshape(SP_B, -1).sum(1).tolist(),
        "card": card,
    }
    print(f"  serving the sparse U-Net [{card}]: predict_batch(16 events, "
          f"{n_batch_pts} pts) {batch_ms:.2f} ms = "
          f"{res['ms_per_event_batched']:.2f} ms/event, "
          f"{res['points_per_s_batched']:.4e} points/s; predict(1000 pts) "
          f"{single_ms:.2f} ms; first calls {first['batch_ms']:.2f} / "
          f"{first['single_ms']:.2f} ms; peak {peak_gib:.3f} GiB; tiles a "
          f"level-0 event {res['occupied_tiles_level0']}", flush=True)
    return launches, res


# ---------------------------------------------------------------------------
# the sparse family's training (slice 6)
# ---------------------------------------------------------------------------

SP_BWD_REPLACES = {
    "bias_ln_relu_mask_bwd": "pcseg_tpu/ops/pallas/fused_ln.py:198",
    "block_conv_dgrad": "pcseg_tpu/ops/pallas/block_conv.py:657",
    "block_conv_wgrad": "pcseg_tpu/ops/pallas/block_conv.py:555",
    "rowcol_scatter": "pcseg_tpu/ops/pallas/onehot_contract.py:309",
}
SP_BWD_SOURCES = {
    "bias_ln_relu_mask_bwd": SP_SOURCES["bias_ln_relu_mask"],
    "block_conv_dgrad": SP_SOURCES["block_conv"],
    "block_conv_wgrad": SP_SOURCES["block_conv"],
    "rowcol_scatter": TRI_SOURCE,
}
# wrapper launches per train step of the bench configuration: the forward's
# (SP_PER_FORWARD), a dgrad for each conv but the stem (whose input is
# data), a wgrad for each conv, an LN backward for each LN, and one readout
# backward
SP_PER_STEP = dict(SP_PER_FORWARD, block_conv_dgrad=7, block_conv_wgrad=8,
                   block_conv_dgrad_mma=7, block_conv_wgrad_mma=8,
                   bias_ln_relu_mask_bwd=10, bias_ln_relu_mask_bwd_vec=10,
                   rowcol_scatter=1)
# kernel vs plain version on identical inputs, for the long f32 sums (the
# wgrad over ~10^5 voxels, the LN's column sums over ~10^5 rows, the
# scatter's cells): both take the same terms in another order, so within
# 1e-5 of the sum of the terms' magnitudes, plus one bf16 rounding (2^-8
# |ref|) where the sum is rounded to bf16
SP_SUM_TOL = 1e-5
# whole sparse step, kernels vs plain versions (phase 16): the loss to
# SP_LOSS_REL relative, 3x the largest --step-spread reading (4.69e-6 in
# each of three runs on one H100: the sparse path's kernels sum in a fixed
# order, only the voxelizer's and the scatter's atomics move); each
# gradient's relative L2, and each parameter's Adam update's, within
# VOX_GRAD_RATIO of the plain bf16 chain's own distance from the same
# step in f32 (read: 0.193 and 0.699); the conv kernels' gradient vector
# at cosine >= VOX_KERNEL_COS
SP_LOSS_REL = 1.4e-5


def _sp_sum_check(got, ref, mag, bf16):
    g, r = got.float(), ref.float()
    tol = SP_SUM_TOL * mag.float() + (2.0 ** -8 * r.abs() if bf16 else 0.0)
    d = (g - r).abs()
    return float(d.max()), bool((d <= tol).all())


def kernel_ms(fn, keys, iters: int = 10) -> float:
    """Device time of the kernels of one call of ``fn`` whose names hold
    one of ``keys`` (torch.profiler over ``iters`` warm calls, profiled
    again while launches go unrecorded)."""
    from pcseg_tpu_torch.profile_serving import profile_calls

    return sum(ms for name, ms in profile_calls(fn, iters).items()
               if any(key in name for key in keys))


def _sp_route(kind, t, cin, cout, dtype):
    """True where csrc/block_conv.cu's rule (block_route) sends a launch to
    its tensor-core kernels: bf16 at t = 8 with an output width that is a
    multiple of 32, up to 128 for the forward and the dgrad, whose input
    width must also be a multiple of 8."""
    import torch

    n = cin if kind == "dgrad" else cout
    if dtype != torch.bfloat16 or t != 8 or n % 32:
        return False
    return kind == "wgrad" or (n <= 128 and (kind == "fwd" or cout % 8 == 0))


def sp_conv_case(kind, bs, label, cin, cout, dtype, gen):
    """``kind`` "fwd", "dgrad" or "wgrad" of the raw block conv on the
    tiles ``bs``: kernel vs plain version, the route its launch took (the
    tensor-core one where ``_sp_route`` says so), two calls bit for bit,
    times (CUDA events around back-to-back calls, and device time), bound
    and the cuDNN call of the same conv on the materialized halo
    (``convolution`` or ``convolution_backward`` for the input or weight
    gradient)."""
    import torch
    import torch.nn.functional as F

    from pcseg_tpu_torch.ops import block_conv as bc
    from pcseg_tpu_torch.ops.block_sparse import neighbor_slots

    t = bs.tile
    t3 = t ** 3
    b, nt = bs.tile_mask.shape
    real = bs.tile_mask
    slots = neighbor_slots(bs)
    x = torch.randn((b, nt, t3, cin), generator=gen, device="cuda")
    x = torch.where(real[..., None, None], x, 0.0).to(dtype)
    gy = torch.randn((b, nt, t3, cout), generator=gen, device="cuda")
    gy = torch.where(real[..., None, None], gy, 0.0).to(dtype)
    bound = (6.0 / (27 * cin)) ** 0.5
    w2 = ((torch.rand((27 * cin, cout), generator=gen, device="cuda") * 2
           - 1) * bound).to(dtype)
    bf16 = dtype == torch.bfloat16
    if kind == "fwd":
        run = (lambda: bc.block_conv_fwd(x, slots, w2))
        plain = (lambda: bc.block_conv_plain(x, slots, w2))
        name, n_out = "block_conv", x.numel() // cin * cout
    elif kind == "dgrad":
        run = (lambda: bc.block_conv_dgrad(gy, slots, w2))
        plain = (lambda: bc.block_conv_dgrad_plain(gy, slots, w2))
        name, n_out = "block_conv_dgrad", x.numel()
    else:
        run = (lambda: bc.block_conv_wgrad(x, slots, gy))
        plain = (lambda: bc.block_conv_wgrad_plain(x, slots, gy))
        name, n_out = "block_conv_wgrad", w2.numel()
    mma = _sp_route(kind, t, cin, cout, dtype)
    before = dict(bc.LAUNCHES)
    k = run()
    torch.cuda.synchronize()
    took = bc.LAUNCHES[f"{name}_mma"] - before[f"{name}_mma"]
    if bc.LAUNCHES[name] - before[name] != 1 or took != int(mma):
        raise AssertionError(f"{name} {label}: {took} tensor-core launches "
                             f"of 1, expected {int(mma)}")
    repeat = bool(torch.equal(k, run()))
    p = plain()
    if kind == "wgrad":
        ref = bc.block_conv_wgrad_plain(x, slots, gy, torch.float32)
        mag = bc.block_conv_wgrad_plain(x.abs(), slots, gy.abs(),
                                        torch.float32)
        checks = {"dW": _sp_sum_check(k, ref, mag, bf16)}
    else:
        checks = {"out": _sp_check(k, p),
                  "padding rows": (float(k[~real].float().abs().max()),
                                   not k[~real].any())}
    checks["two calls identical"] = (0.0, repeat)
    err = _held(name, checks)
    # the yardstick: cuDNN on the materialized (B*NT, Cin, t+2, t+2, t+2)
    # halo, every tile
    halo = bc.gather_halo_slots(x.reshape(b, nt, t, t, t, cin), slots)
    halo = halo.reshape(b * nt, t + 2, t + 2, t + 2, cin).permute(
        0, 4, 1, 2, 3).contiguous()
    wl = w2.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2).contiguous()
    go = gy.reshape(b * nt, t, t, t, cout).permute(0, 4, 1, 2, 3)
    go = go.contiguous()
    if kind == "fwd":
        def library():
            return F.conv3d(halo, wl)
    else:
        mask = [kind == "dgrad", kind == "wgrad", False]

        def library():
            return torch.ops.aten.convolution_backward(
                go, halo, wl, None, [1, 1, 1], [0, 0, 0], [1, 1, 1], False,
                [0, 0, 0], 1, mask)
    n_real = int(real.sum())
    es = x.element_size()
    res = {
        "name": name, "case": label,
        "shape": f"B{b} NT{nt} t{t} {cin}->{cout} {str(dtype)[6:]}",
        "max_abs_err": err, "real_tiles": n_real,
        "route": "tensor cores" if mma else "CUDA cores",
        "ms": time_ms(run), "device_ms": device_ms(run),
        "plain_ms": time_ms(plain), "library_ms": time_ms(library),
        "library_device_ms": device_ms(library),
    }
    # inputs read once (features or cotangent, slots, weights), the output
    # written once; the 27-tap products of every voxel of every real tile
    ins = (x.numel() if kind != "dgrad" else 0) + (
        gy.numel() if kind != "fwd" else 0) + (
        w2.numel() if kind != "wgrad" else 0)
    res["bound_ms"], res["bound_by"] = _bound(
        ins * es + slots.numel() * 4 + n_out * es,
        2 * 27 * cin * cout * t3 * n_real,
        BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S)
    return _vox_report(res)


def sp_ln_case(kind, active, label, c, dtype, gen):
    """``kind`` "fwd" or "bwd" of bias_ln_relu_mask on rows with the
    ``active`` mask: kernel vs plain version, device times, bound and one
    LayerNorm call of PyTorch (``F.layer_norm`` / ``native_layer_norm_
    backward``)."""
    import torch
    import torch.nn.functional as F

    from pcseg_tpu_torch.ops import fused_ln as fl

    active = active.reshape(-1)
    n = active.numel()
    x = (torch.randn((n, c), generator=gen, device="cuda") * 2).to(dtype)
    pre = torch.randn((c,), generator=gen, device="cuda") * 0.1
    scale = torch.rand((c,), generator=gen, device="cuda") + 0.5
    bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
    g = torch.randn((n, c), generator=gen, device="cuda").to(dtype)
    w, bb = scale.to(dtype), bias.to(dtype)
    es = x.element_size()
    if kind == "fwd":
        args = (x, pre, scale, bias, active, 1e-5, dtype)
        k = fl.bias_ln_relu_mask_fwd(*args)
        torch.cuda.synchronize()
        p = fl.bias_ln_relu_mask_plain(*args)
        checks = {"out": _sp_check(k, p),
                  "inactive rows": (float(k[~active].float().abs().max()),
                                    not k[~active].any())}
        name, keys = "bias_ln_relu_mask", ("bias_ln_relu_mask_kernel",)

        def run():
            return fl.bias_ln_relu_mask_fwd(*args)

        def plain():
            return fl.bias_ln_relu_mask_plain(*args)

        def library():
            return F.layer_norm(x, (c,), w, bb, 1e-5)
        nbytes, flops = 2 * n * c * es + n + 3 * c * 4, 8 * n * c
    else:
        args = (x, pre, scale, bias, active, g, 1e-5)
        vec = fl.LAUNCHES["bias_ln_relu_mask_bwd_vec"]
        k = fl.bias_ln_relu_mask_bwd(*args)
        torch.cuda.synchronize()
        vec = fl.LAUNCHES["bias_ln_relu_mask_bwd_vec"] - vec
        again = fl.bias_ln_relu_mask_bwd(*args)
        p = fl.bias_ln_relu_mask_bwd_plain(*args)
        xf = x.float() + pre
        mean = xf.mean(-1, keepdim=True)
        xh = (xf - mean) * torch.rsqrt(
            (xf * xf).mean(-1, keepdim=True) - mean * mean + 1e-5)
        dz = torch.where(active[:, None] & (xh * scale + bias > 0),
                         g.float(), 0.0)
        mags = (p[0].float().abs().sum(0), (dz * xh).abs().sum(0),
                dz.abs().sum(0))
        checks = {"dx": _sp_check(k[0], p[0]),
                  "inactive rows": (float(k[0][~active].float().abs().max()),
                                    not k[0][~active].any())}
        for i, nm in enumerate(("dpre_bias", "dscale", "dbias")):
            checks[nm] = _sp_sum_check(k[i + 1], p[i + 1], mags[i], False)
        # fixed-order sums: two calls give the same bits; C a multiple of
        # 8 up to 256 takes the vector route
        checks["two calls identical"] = (0.0, all(
            torch.equal(a, b) for a, b in zip(k, again)))
        checks["route"] = (0.0, vec == int(c % 8 == 0 and c <= 256))
        name = "bias_ln_relu_mask_bwd"
        keys = ("bias_ln_relu_mask_bwd", "ln_bwd_vec_kernel", "column_sum")
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [c], w, bb,
                                                            1e-5)

        def run():
            return fl.bias_ln_relu_mask_bwd(*args)

        def plain():
            return fl.bias_ln_relu_mask_bwd_plain(*args)

        def library():
            return torch.ops.aten.native_layer_norm_backward(
                g, x, [c], lmean, lrstd, w, bb, [True, True, True])
        # x and g read once, dx written once, the mask and three vectors
        # read, three column sums written
        nbytes = 3 * n * c * es + n + 6 * c * 4
        flops = 30 * n * c
    err = _held(name, checks)
    res = {
        "name": name, "case": label, "shape": f"{n}x{c} {str(dtype)[6:]}",
        "max_abs_err": err, "active_rows": int(active.sum()),
        "ms": kernel_ms(run, keys), "wrapper_ms": time_ms(run),
        "plain_ms": device_ms(plain), "library_ms": device_ms(library),
    }
    if kind == "bwd":
        res["route"] = "vector" if vec else "strided"
    res["bound_ms"], res["bound_by"] = _bound(nbytes, flops, F32_FLOP_PER_S)
    return _vox_report(res)


def sp_rowcol_case(gen):
    """rowcol_scatter at the bench batch's readout: (8, 8192, 4) point
    cotangents into the (8, 64, 512 * 4) f32 table of the level-0 tiles."""
    import torch

    from pcseg_tpu_torch.data.synthetic import track_events
    from pcseg_tpu_torch.ops import block_sparse as bsp

    pts = torch.from_numpy(track_events(SP_B, SP_M, 0)).cuda()
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device="cuda")
    bs = bsp.block_sparse_voxelize(pts, mask, SP_R, SP_CAPS[0], SP_T,
                                   plain=True)[0]
    slot, intra = bsp.point_cells(bs, pts, mask)
    nt, t3 = bs.tile_mask.shape[1], SP_T ** 3
    vals = torch.randn((SP_B, SP_M, 4), generator=gen, device="cuda")
    vals[:, -100:] = 0.0                   # masked points' cotangents
    k = bsp.rowcol_scatter(slot, intra, vals, nt, t3)
    torch.cuda.synchronize()
    p = bsp.rowcol_scatter_plain(slot, intra, vals, nt, t3)
    mag = bsp.rowcol_scatter_plain(slot, intra, vals.abs(), nt, t3)
    err = _held("rowcol_scatter", {"out": _sp_sum_check(k, p, mag, False)})
    # the yardstick: one index_add_ of the bf16-rounded rows into the table
    idx = torch.where(slot < nt, slot * t3 + intra, nt * t3)
    idx = (idx + torch.arange(SP_B, device="cuda")[:, None]
           * (nt * t3 + 1)).reshape(-1)
    vb = vals.to(torch.bfloat16).float().reshape(-1, 4)
    tab = torch.zeros((SP_B * (nt * t3 + 1), 4), device="cuda")
    res = {
        "name": "rowcol_scatter", "case": "readout bwd",
        "shape": f"B{SP_B} M{SP_M} C4 -> NT{nt} x {t3}", "max_abs_err": err,
        "ms": kernel_ms(lambda: bsp.rowcol_scatter(slot, intra, vals, nt,
                                                   t3),
                        ("rowcol_scatter",)),
        "wrapper_ms": time_ms(lambda: bsp.rowcol_scatter(slot, intra, vals,
                                                         nt, t3)),
        "plain_ms": device_ms(lambda: bsp.rowcol_scatter_plain(
            slot, intra, vals, nt, t3)),
        "library_ms": device_ms(lambda: tab.index_add_(0, idx, vb)),
    }
    # rows, cols and values read once, the f32 table written once
    res["bound_ms"], res["bound_by"] = _bound(
        slot.numel() * 8 + vals.numel() * 4 + p.numel() * 4, vals.numel(),
        F32_FLOP_PER_S)
    return _vox_report(res)


def sparse_bwd_cases(gen):
    """Phase 15: the new kernels at every training shape of the bench
    configuration, and every kernel of the family, forward and backward,
    at the shapes the repair opened."""
    import torch

    bf = torch.bfloat16
    bs, bsc = sparse_levels()
    cases = [sp_ln_case("bwd", bs.active, "level 0", SP_W, bf, gen),
             sp_ln_case("bwd", bsc.active, "level 1", 2 * SP_W, bf, gen),
             sp_ln_case("bwd", bs.active, "level 0 f32", SP_W,
                        torch.float32, gen),
             sp_conv_case("dgrad", bs, "level 0", SP_W, SP_W, bf, gen),
             sp_conv_case("dgrad", bsc, "level 1", 2 * SP_W, 2 * SP_W, bf,
                          gen),
             sp_conv_case("wgrad", bs, "stem", 2, SP_W, bf, gen),
             sp_conv_case("wgrad", bs, "level 0", SP_W, SP_W, bf, gen),
             sp_conv_case("wgrad", bsc, "level 1", 2 * SP_W, 2 * SP_W, bf,
                          gen),
             sp_rowcol_case(gen)]
    # repaired shapes: LN at 256 and 24 channels, the conv at widths 8 and
    # 24 and at tile 16 (R64: a 4^3 tile grid, capacity 16)
    bs16, _ = sparse_levels(cap0=16, t=16)
    for kind in ("fwd", "bwd"):
        cases.append(sp_ln_case(kind, bsc.active, "repaired C256", 256, bf,
                                gen))
        cases.append(sp_ln_case(kind, bs.active, "repaired C24", 24, bf,
                                gen))
    for label, tiles, cin, cout in (("repaired w8", bs, 8, 8),
                                    ("repaired w24", bs, 24, 24),
                                    ("repaired t16", bs16, 16, 16)):
        for kind in ("fwd", "dgrad", "wgrad"):
            cases.append(sp_conv_case(kind, tiles, label, cin, cout, bf,
                                      gen))
    for label, tiles, cout in (("repaired stem w24", bs, 24),
                               ("repaired stem t16", bs16, 16)):
        for kind in ("fwd", "wgrad"):
            cases.append(sp_conv_case(kind, tiles, label, 2, cout, bf, gen))
    # the tensor-core routes at a partial K chunk (48 = 32 + 16 input
    # channels) and an output width of 96 (6 n8 tiles a warp); the dgrad's
    # 48 outputs stay on the CUDA cores
    for kind in ("fwd", "dgrad", "wgrad"):
        cases.append(sp_conv_case(kind, bs, "partial chunks", 48, 96, bf,
                                  gen))
    return cases


def sparse_step_compare(card, hold=True):
    """Phase 16: one sparse train step (forward, loss, backward, Adam) of
    the bench configuration with the kernels and with the plain versions,
    from the same weights, optimizer state and batch, and the same step in
    f32 through the plain versions as the yardstick of the bf16 chain's own
    rounding; ``hold=False`` reports without failing."""
    import numpy as np
    import torch

    from pcseg_tpu_torch.data.batching import pad_events
    from pcseg_tpu_torch.models.sparse_unet import SparseVoxelNet
    from pcseg_tpu_torch.ops.losses import cross_entropy_sums
    from pcseg_tpu_torch.profile_serving import sparse_model
    from pcseg_tpu_torch.profile_training import sparse_batch
    from pcseg_tpu_torch.train.optim import make_optimizer

    pts, labels, masks = (torch.from_numpy(a).cuda() for a in pad_events(
        sparse_batch(SP_B, SP_M), SP_M, batch_size=SP_B))
    cw = torch.ones(4, device="cuda")
    model = sparse_model().cuda()
    kw = {k: getattr(model, k) for k in (
        "num_classes", "grid_size", "width", "depth", "levels", "tile",
        "max_tiles", "max_tiles_schedule")}
    model32 = SparseVoxelNet(**kw, compute_dtype="float32").cuda()
    model32.load_state_dict(model.state_dict())
    start = {n: p.detach().clone() for n, p in model.named_parameters()}

    def step(m, plain, lr=1e-3):
        """loss, gradients and Adam updates of one step from ``start``"""
        with torch.no_grad():
            for n, p in m.named_parameters():
                p.copy_(start[n])
        opt = make_optimizer(m.parameters())
        opt.zero_grad(set_to_none=True)
        logits, aux = m.apply(pts, train=True, mask=masks, plain=plain)
        num, den = cross_entropy_sums(logits, labels, cw)
        loss = num / den
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        grads = {n: p.grad.clone() for n, p in m.named_parameters()}
        upd = {n: p.detach() - start[n] for n, p in m.named_parameters()}
        return (float(loss.detach()), grads, upd,
                int(aux["__overflow__"].sum()))

    lk, gk, uk, dropped = step(model, False)
    lp, gp, up, _ = step(model, True)
    lf, gf, uf, _ = step(model32, True)
    torch.cuda.synchronize()

    def rel(a, b):
        return {n: float((a[n] - b[n]).norm())
                / max(float(b[n].norm()), 1e-30) for n in b}

    def ratio(a, b, f):
        # the yardstick ||b - f|| is floored at the f32 resolution of b
        # (2^-23 ||b||): Adam's first update saturates at +-lr where |g|
        # >> eps, so the plain bf16 and the f32 steps can give a
        # parameter (head.bias) the same bits, and a one-ulp difference of
        # the kernel step there would read as an unbounded ratio
        return {n: float((a[n] - b[n]).norm())
                / max(float((b[n] - f[n]).norm()),
                      2.0 ** -23 * float(b[n].norm()), 1e-30) for n in b}

    loss_rel = abs(lk - lp) / abs(lp)
    g_ratio, u_ratio = ratio(gk, gp, gf), ratio(uk, up, uf)
    kern = [n for n in gp if n.endswith(".kernel")]
    kk = torch.cat([gk[n].flatten() for n in kern])
    kp = torch.cat([gp[n].flatten() for n in kern])
    kcos = float(kk @ kp / (kk.norm() * kp.norm()))
    gw, uw = max(g_ratio, key=g_ratio.get), max(u_ratio, key=u_ratio.get)
    ok = (loss_rel <= SP_LOSS_REL and kcos >= VOX_KERNEL_COS
          and g_ratio[gw] <= VOX_GRAD_RATIO and u_ratio[uw] <= VOX_GRAD_RATIO
          and dropped == 0 and np.isfinite(lk)
          and all(torch.isfinite(g).all() for g in gk.values()))
    ms_k = time_ms(lambda: step(model, False), iters=3)
    ms_p = time_ms(lambda: step(model, True), iters=3)
    res = {"loss_kernels": lk, "loss_plain": lp, "loss_f32": lf,
           "loss_rel_err": loss_rel, "loss_tol": SP_LOSS_REL,
           "kernel_grad_cosine": kcos, "dropped": dropped,
           "grad_rel_err_kernels_vs_plain": rel(gk, gp),
           "grad_rel_err_plain_vs_f32": rel(gp, gf), "grad_ratio": g_ratio,
           "grad_ratio_max": g_ratio[gw], "grad_worst": gw,
           "update_rel_err_kernels_vs_plain": rel(uk, up),
           "update_ratio": u_ratio, "update_ratio_max": u_ratio[uw],
           "update_worst": uw, "step_ms_kernels": ms_k,
           "step_ms_plain": ms_p, "card": card}
    print(f"  sparse step: loss kernels {lk:.6f} plain {lp:.6f} (rel "
          f"{loss_rel:.2e}, tol {SP_LOSS_REL:.1e}), f32 {lf:.6f}; conv-kernel "
          f"gradient cosine {kcos:.6f} (tol {VOX_KERNEL_COS}); gradient "
          f"ratio <= {g_ratio[gw]:.3f} at {gw}, Adam update ratio <= "
          f"{u_ratio[uw]:.3f} at {uw} (tol {VOX_GRAD_RATIO}); dropped "
          f"{dropped}; step {ms_k:.2f} ms with kernels, {ms_p:.2f} ms plain "
          f"[{card}]", flush=True)
    if hold and not ok:
        raise AssertionError(f"sparse train step: kernels disagree with the "
                             f"plain versions: {res}")
    return res


def sparse_fit(card):
    """Phase 17, the main path: api.fit on the sparse bench configuration
    (2 epochs of 3 train steps and one eval batch on track events of
    4,000-8,192 points, labels drawn by numpy), then Predictor on its best
    checkpoint. Returns (fit launches, serving launches, result)."""
    import math

    import numpy as np
    import torch

    from pcseg_tpu_torch import api
    from pcseg_tpu_torch.data.synthetic import track_events
    from pcseg_tpu_torch.infer import Predictor

    rng = np.random.default_rng(7)
    # 30 events: 24 train (3 batches of 8), 6 val (one eval batch)
    events = []
    for m in rng.integers(4000, SP_M + 1, 30):
        p = track_events(1, int(m), rng)[0]
        events.append((p, rng.integers(0, 4, p.shape[0])))
    overrides = [
        "model.name=sparse_voxelnet", "model.num_classes=4",
        f"model.grid_size={SP_R}", f"model.unet_width={SP_W}",
        "model.depth=4", "model.levels=2", "model.impl=block",
        f"model.tile={SP_T}", f"model.max_tiles={SP_CAPS[0]}",
        "model.max_tiles_schedule=" + ",".join(map(str, SP_CAPS)),
        "model.compute_dtype=bfloat16", "model.strict_capacity=true",
        f"data.batch_size={SP_B}", f"data.buckets={SP_M}",
        "train.checkpoint_dir=build/chip_smoke_ckpt_sparse",
        "train.num_epochs=2", "train.log_every_steps=0"]

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = api.fit(events, overrides=overrides, log=lambda _: None)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = sum(h["train_steps"] for h in res.history)
    evals = len(res.history)          # one eval batch per epoch
    expected = {k: SP_PER_STEP.get(k, 0) * steps
                + SP_PER_FORWARD.get(k, 0) * evals for k in launches}
    if launches != expected:
        raise AssertionError(f"sparse fit: launch counts {launches} != "
                             f"{expected} ({steps} train steps, {evals} "
                             "eval batches)")
    losses = [h[k] for h in res.history for k in ("train_loss", "val_loss")]
    dropped = [h[k] for h in res.history
               for k in ("dropped_train", "dropped_val")]
    if not all(math.isfinite(v) for v in losses) or any(dropped):
        raise AssertionError(f"sparse fit: losses {losses}, dropped tiles "
                             f"{dropped}")
    warm = res.history[-1]
    ms_step = warm["train_seconds"] * 1e3 / warm["train_steps"]

    # the best checkpoint, served on the card
    reset_counts()
    pred = Predictor.from_checkpoint(res.checkpoint_path)
    served = [p for p, _ in events[:SP_B]]
    preds = pred.predict_batch(served, batch_size=SP_B)
    logits = pred.logits(served[0])
    torch.cuda.synchronize()
    serve_launches = launch_counts()
    want = {k: SP_PER_FORWARD.get(k, 0) * 2 for k in serve_launches}
    if serve_launches != want:
        raise AssertionError(f"serving the sparse checkpoint: launch counts "
                             f"{serve_launches} != {want}")
    if [p.shape[0] for p in preds] != [e.shape[0] for e in served] or \
            not np.isfinite(logits).all():
        raise AssertionError("serving the sparse checkpoint: bad "
                             "predictions")
    out = {
        "model": "SparseVoxelNet R64/w64/d4/L2 t8 caps (64, 32) bf16",
        "steps": steps, "eval_batches": evals, "launches": launches,
        "launches_per_step": {k: (v - SP_PER_FORWARD.get(k, 0) * evals)
                              / steps for k, v in launches.items() if v},
        "train_loss": [h["train_loss"] for h in res.history],
        "val_loss": [h["val_loss"] for h in res.history],
        "dropped": dropped,
        "first_epoch_train_ms_per_step":
            res.history[0]["train_seconds"] * 1e3 / res.history[0][
                "train_steps"],
        "ms_per_step": ms_step,
        "points_per_s": SP_B * SP_M / (ms_step / 1e3),
        "epoch_seconds": [h["seconds"] for h in res.history],
        "peak_mem_gib": peak, "serve_launches": serve_launches,
        "served_events": len(preds), "card": card,
    }
    print(f"  fit sparse_voxelnet [{card}]: {steps} train steps at B{SP_B} x "
          f"{SP_M}, launches per step {out['launches_per_step']}; train loss "
          f"{out['train_loss']}, val loss {out['val_loss']}; dropped tiles "
          f"{dropped}; {ms_step:.2f} ms/step (epoch 2; epoch 1 "
          f"{out['first_epoch_train_ms_per_step']:.2f}), "
          f"{out['points_per_s']:.4e} points/s; peak {peak:.3f} GiB; best "
          f"checkpoint served {len(preds)} events", flush=True)
    return launches, serve_launches, out


# ---------------------------------------------------------------------------
# rows 14 and 19, reached only by tests, and PointNetSeg serving (slice 7)
# ---------------------------------------------------------------------------

TEST_ONLY_REPLACES = {
    "fused_global_pool": "pcseg_tpu/ops/pallas/fused_pool.py:107",
    "segment_scatter": "pcseg_tpu/ops/pallas/voxel_scatter.py:67"}
TEST_ONLY_SOURCES = {"fused_global_pool": PN_SOURCE,
                     "segment_scatter": TRI_SOURCE}
# kernel vs plain version on identical inputs: the pool rounds z at the
# plain version's points and its max is exact, so g, idx and every
# gradient are held bit for bit; the scatter's float atomics add in
# another order than index_add_: each sum within 1e-5 of the sum of its
# terms' magnitudes
SCATTER_TOL = 1e-5
# PointNetSeg serving (phase 19): folded f32 against the unfolded model,
# the same function up to reassociation, 1e-4 of max |logit|. Folded bf16
# against folded f32 is another computation: bf16 rounds the inputs
# (coordinates up to ~80, so 2^-9 relative), every layer's weights and
# every activation; held to 2^-6 of max |logit| (four bf16 ulps of
# scale). Its argmax agreement with f32 is reported, not held: with
# seeded random weights the logits are small and near-tied, and bf16
# breaks some of those ties the other way. Padding invariance, an event alone against the
# same event in a padded batch (another matrix shape, so another
# summation order): 1e-5 of max |logit| in f32, one bf16 ulp of scale
# (2^-7) in bf16
PN_SERVE_FOLD_TOL = 1e-4
PN_SERVE_BF16_TOL = 2.0 ** -6
PN_SERVE_PAD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def pool_case(label, b, rpb, c, dtype, gen, ties=False, negative=False):
    """Row 19: fused_global_pool forward and backward, kernel vs plain on
    identical inputs; ``ties``: row 4 of every group holds each channel's
    max and rows 5-8 repeat it (the first must win); ``negative``: every
    third channel has beta -100 (pools to 0 with row 0, no gradient)."""
    import torch

    from pcseg_tpu_torch.ops import fused_pool as fp

    y = torch.randn((b, rpb, c), generator=gen, device="cuda")
    if ties:
        y[:, 4] += 20.0
        y[:, 5:9] = y[:, 4:5]
    y = y.reshape(b * rpb, c).to(dtype)
    mu, inv, gamma, beta = _bn_vectors(gen, c)
    if ties:
        gamma = gamma.abs() + 0.1
    if negative:
        beta[::3] = -100.0
    args = (y, mu, inv, gamma, beta)
    dg = torch.randn((b, c), generator=gen, device="cuda")

    g_k, idx_k = fp.fused_pool_fwd_cuda(*args, rpb)
    g_p, idx_p = fp.fused_pool_fwd_plain(*args, rpb)

    def vjp(plain):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        fp.fused_global_pool(*leaves, rpb, plain=plain).backward(dg)
        return [t.grad for t in leaves]

    grads_k, grads_p = vjp(False), vjp(True)
    torch.cuda.synchronize()

    def exact(a, b):
        return float((a.float() - b.float()).abs().max()), bool(
            torch.equal(a, b))

    checks = {"g": exact(g_k, g_p), "idx": exact(idx_k, idx_p)}
    for name, gk, gp in zip(("dy", "dmu", "dinv", "dgamma", "dbeta"),
                            grads_k, grads_p):
        checks[name] = exact(gk, gp)
    if negative:
        checks["negative channels pool to 0 at row 0"] = (0.0, bool(
            (g_k[:, ::3] == 0).all() and (idx_k[:, ::3] == 0).all()
            and (grads_k[0][:, ::3] == 0).all()))
    if ties:
        others = [k for k in range(c) if k % 3 or not negative]
        checks["ties go to the first row"] = (0.0, bool(
            (idx_k[:, others] == 4).all()))
    err = _held(f"fused_global_pool {label}", checks)

    n, esize = b * rpb, y.element_size()
    val = torch.randn((b, c), generator=gen, device="cuda")
    y3 = y.view(b, rpb, c)
    # the backward of torch.max(dim=1): val at each winner row, zeros
    # elsewhere, the same function as the write-only dy pass
    lib_val, lib_idx = val.to(dtype), idx_k.long()
    lib_bwd = torch.ops.aten.value_selecting_reduction_backward
    if not torch.equal(
            lib_bwd(lib_val, 1, lib_idx, (b, rpb, c), False).view(n, c),
            fp.fused_pool_bwd_plain(idx_k, val, n, dtype)):
        raise AssertionError(f"fused_global_pool {label}: the backward's "
                             f"library yardstick computes another function")
    res = {
        "name": "fused_global_pool", "case": label,
        "shape": f"B{b} x {rpb} x {c} {str(dtype).split('.')[-1]}",
        "max_abs_err": err,
        "ms": kernel_ms(lambda: fp.fused_pool_fwd_cuda(*args, rpb),
                        ("pool_",)),
        "wrapper_ms": time_ms(lambda: fp.fused_pool_fwd_cuda(*args, rpb)),
        "plain_ms": device_ms(lambda: fp.fused_pool_fwd_plain(*args, rpb)),
        "library": "torch.max(dim=1) over the (B, M, C) activations, the "
                   "reduction alone",
        "library_ms": device_ms(lambda: torch.max(y3, dim=1)),
        "bwd_ms": kernel_ms(lambda: fp.fused_pool_bwd_cuda(idx_k, val, n,
                                                           dtype),
                            ("pool_bwd",)),
        "bwd_wrapper_ms": time_ms(lambda: fp.fused_pool_bwd_cuda(
            idx_k, val, n, dtype)),
        "bwd_plain_ms": device_ms(lambda: fp.fused_pool_bwd_plain(
            idx_k, val, n, dtype)),
        "bwd_library": "value_selecting_reduction_backward, the backward "
                       "of torch.max(dim=1)",
        "bwd_library_ms": device_ms(lambda: lib_bwd(
            lib_val, 1, lib_idx, (b, rpb, c), False)),
    }
    # forward: y and the four (C,) vectors read once, g and idx written
    # once; six f32 operations an element (sub, mul, mul, add, relu,
    # compare). backward: idx and val read once, dy written once
    res["bound_ms"], res["bound_by"] = _bound(
        n * c * esize + 4 * c * 4 + 2 * b * c * 4, 6 * n * c,
        F32_FLOP_PER_S)
    res["bwd_bound_ms"], res["bwd_bound_by"] = _bound(
        2 * b * c * 4 + n * c * esize, n * c, F32_FLOP_PER_S)
    print(f"  ok  fused_global_pool {label:14s} {res['shape']:24s} exact "
          f"(g, idx, dy, dmu, dinv, dgamma, dbeta); fwd kernel "
          f"{res['ms']:.4f} (wrapper {res['wrapper_ms']:.4f}) / plain "
          f"{res['plain_ms']:.4f} / torch.max {res['library_ms']:.4f} / "
          f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}); bwd kernel "
          f"{res['bwd_ms']:.4f} (wrapper {res['bwd_wrapper_ms']:.4f}) / "
          f"plain {res['bwd_plain_ms']:.4f} / max backward "
          f"{res['bwd_library_ms']:.4f} / bound "
          f"{res['bwd_bound_ms']:.4f} ms", flush=True)
    return res


def scatter_case(label, b, m, r, c, gen, hot=False, bad=False):
    """Row 14: segment_scatter kernel vs plain on identical inputs, the
    last eighth of every event's points masked (spill id, zero rows);
    ``hot``: every point of event 0 in one segment; ``bad``: ids beyond
    the spill row and negative ids in event 1, and the entry called into
    a buffer with guard zones around the output."""
    import torch

    from pcseg_tpu_torch.ops import voxel_scatter as vs
    from pcseg_tpu_torch.ops._build import load_library, stream_of

    nseg = r ** 3
    ids = torch.randint(0, nseg, (b, m), generator=gen, device="cuda",
                        dtype=torch.int32)
    feats = torch.randn((b, m, c), generator=gen, device="cuda")
    ids[:, -m // 8:] = nseg
    feats[:, -m // 8:] = 0.0
    if hot:
        ids[0] = 7
    if bad:
        ids[1, ::4] = nseg + 5
        ids[1, 1::4] = -1
        ids[1, 2::4] = 2 ** 31 - 1
    got = vs.segment_scatter(ids, feats, nseg)
    ref = vs.segment_scatter_plain(ids, feats, nseg)
    mag = vs.segment_scatter_plain(ids, feats.abs(), nseg)
    torch.cuda.synchronize()
    d = (got - ref).abs()
    checks = {"sums": (float(d.max()),
                       bool((d <= SCATTER_TOL * mag).all()))}
    if bad:
        guard = 1 << 16
        buf = torch.zeros(b * nseg * c + 2 * guard, device="cuda")
        out = buf[guard:guard + b * nseg * c]
        rc = load_library("onehot_contract").pcseg_segment_scatter(
            ids.data_ptr(), feats.data_ptr(), out.data_ptr(), b, m, nseg, c,
            stream_of(feats))
        torch.cuda.synchronize()
        checks["no write outside the output"] = (0.0, rc == 0 and bool(
            (buf[:guard] == 0).all() and (buf[-guard:] == 0).all()))
    err = _held(f"segment_scatter {label}", checks)

    # the yardstick: one index_add_ of the same rows into a table with a
    # spill row per event
    gid = torch.where((ids >= 0) & (ids < nseg), ids.long(), nseg)
    gid = (gid + torch.arange(b, device="cuda")[:, None] * (nseg + 1))
    gid = gid.reshape(-1)
    rows = feats.reshape(-1, c)
    tab = torch.zeros((b * (nseg + 1), c), device="cuda")
    res = {
        "name": "segment_scatter", "case": label,
        "shape": f"B{b} M{m} C{c} -> R{r}^3", "max_abs_err": err,
        # the wrapper's device time: the zero fill of the output and the
        # scatter kernel
        "ms": device_ms(lambda: vs.segment_scatter(ids, feats, nseg)),
        "kernel_only_ms": kernel_ms(lambda: vs.segment_scatter(
            ids, feats, nseg), ("segment_scatter",)),
        "wrapper_ms": time_ms(lambda: vs.segment_scatter(ids, feats, nseg)),
        "plain_ms": device_ms(lambda: vs.segment_scatter_plain(
            ids, feats, nseg)),
        "library": "index_add_ of the rows into a table with spill rows",
        "library_ms": device_ms(lambda: tab.index_add_(0, gid, rows)),
    }
    # ids and rows read once, the f32 grid written once; one add a value
    res["bound_ms"], res["bound_by"] = _bound(
        ids.numel() * 4 + feats.numel() * 4 + b * nseg * c * 4,
        feats.numel(), F32_FLOP_PER_S)
    print(f"  ok  segment_scatter {label:14s} {res['shape']:22s} max|err| "
          f"{err:.3e}; kernel {res['ms']:.4f} (scatter alone "
          f"{res['kernel_only_ms']:.4f}, wrapper {res['wrapper_ms']:.4f}) / "
          f"plain {res['plain_ms']:.4f} / index_add_ "
          f"{res['library_ms']:.4f} / bound {res['bound_ms']:.4f} ms "
          f"({res['bound_by']})", flush=True)
    return res


def test_only_cases(gen):
    """Phase 18: rows 14 and 19 against their plain versions; returns
    (cases, the wrappers' launches in this phase)."""
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    reset_counts()
    cases = [pool_case("pointnet global", PN_B, PN_M, 1024, bf, gen),
             pool_case("jax test", 4, 256, 64, f32, gen),
             pool_case("beta -100", 8, 2048, 1024, bf, gen, negative=True),
             pool_case("ties", 4, 512, 64, bf, gen, ties=True,
                       negative=True),
             pool_case("rows 1000", 8, 1000, 1024, bf, gen),
             pool_case("C 20", 4, 1000, 20, bf, gen),
             scatter_case("voxel R64", VOX_B, VOX_M, VOX_R, 4, gen),
             scatter_case("jax doc R16", VOX_B, 2048, 16, 4, gen),
             scatter_case("hot segment", VOX_B, VOX_M, VOX_R, 4, gen,
                          hot=True),
             scatter_case("bad ids", VOX_B, 2048, 16, 4, gen, bad=True)]
    return cases, launch_counts()


def pointnet_serve(card):
    """Phase 19, the main path of slice 7: PointNetSeg at full width (4
    classes, seeded random weights and running statistics) served by
    Predictor folded in f32 (the default), folded in bf16 and unfolded:
    predict_batch on 16 synthetic events of 4,000-8,192 points (batch 8,
    bucket 8192) and predict on one 1,000-point event (bucket 1024); then
    the same weights written as a reference best_model.pth and served
    through Predictor.from_checkpoint and inference_example. Returns (the
    wrappers' launches while serving, result)."""
    import os

    import numpy as np
    import torch

    from pcseg_tpu_torch.ckpt.torch_import import export_torch_state_dict
    from pcseg_tpu_torch.data.batching import pad_events
    from pcseg_tpu_torch.data.synthetic import synthetic_events
    from pcseg_tpu_torch.infer import Predictor, inference_example
    from pcseg_tpu_torch.profile_serving import (
        POINTNET_MODES,
        pointnet_model,
        pointnet_predictor,
    )

    model = pointnet_model()
    events = [p for p, _ in synthetic_events(
        16, min_points=4000, max_points=8192, seed=0)]
    single, single_labels = next(iter(synthetic_events(
        1, min_points=1000, max_points=1000, seed=1)))
    n_batch_pts = sum(e.shape[0] for e in events)
    pts, _, msk = pad_events(
        [(e, np.zeros(e.shape[0], np.int64)) for e in events[:8]], 8192,
        batch_size=8)
    points = torch.from_numpy(pts).cuda()
    mask = torch.from_numpy(msk).cuda()

    modes, logits, launches = {}, {}, {}
    for mode in POINTNET_MODES:
        pred = pointnet_predictor(mode, model)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        preds = pred.predict_batch(events, batch_size=8)
        t1 = time.perf_counter()
        one = pred.logits(single)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        for k, v in launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        if [p.shape[0] for p in preds] != [e.shape[0] for e in events] or \
                one.shape != (single.shape[0], 4) or \
                not np.isfinite(one).all():
            raise AssertionError(f"PointNet serving {mode}: bad predictions")
        first = {"batch_ms": (t1 - t0) * 1e3, "single_ms": (t2 - t1) * 1e3}
        reps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.predict_batch(events, batch_size=8)
            t1 = time.perf_counter()
            pred.predict(single)
            t2 = time.perf_counter()
            reps.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
        batch_ms = sorted(r[0] for r in reps)[1]
        single_ms = sorted(r[1] for r in reps)[1]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out = pred.device_forward(points, mask)
        if not out.is_cuda or out.shape != (8, 8192, 4) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"PointNet serving {mode}: logits of shape "
                                 f"{tuple(out.shape)} on {out.device}")
        # padding invariance: event 0 alone against its row in the batch
        alone = torch.from_numpy(pred.logits(events[0])).cuda()
        n0 = events[0].shape[0]
        pad_err = float((alone - out[0, :n0]).abs().max())
        pad_tol = PN_SERVE_PAD_TOL[POINTNET_MODES[mode][1]] * float(
            out[0, :n0].abs().max())
        if pad_err > pad_tol:
            raise AssertionError(f"PointNet serving {mode}: event 0 alone "
                                 f"vs in the batch {pad_err} > {pad_tol}")
        logits[mode] = out
        modes[mode] = {
            "fold": POINTNET_MODES[mode][0], "dtype": POINTNET_MODES[mode][1],
            "first_call": first, "predict_batch_16_ms": batch_ms,
            "ms_per_event_batched": batch_ms / len(events),
            "points_per_s_batched": n_batch_pts / (batch_ms / 1e3),
            "predict_1000pt_ms": single_ms, "peak_mem_gib": peak,
            "padding_max_abs_err": pad_err, "card": card}
        print(f"  serving PointNetSeg {mode} [{card}]: predict_batch(16 "
              f"events, {n_batch_pts} pts) {batch_ms:.2f} ms = "
              f"{batch_ms / len(events):.2f} ms/event, "
              f"{modes[mode]['points_per_s_batched']:.4e} points/s; "
              f"predict(1000 pts) {single_ms:.2f} ms; first calls "
              f"{first['batch_ms']:.2f} / {first['single_ms']:.2f} ms; peak "
              f"{peak:.3f} GiB; padding max|d| {pad_err:.3e}", flush=True)
    if any(launches.values()):
        raise AssertionError(f"PointNet serving launched kernels: "
                             f"{ {k: v for k, v in launches.items() if v} }")

    f32, unf = logits["folded_f32"][mask], logits["unfolded"][mask]
    bf16 = logits["folded_bf16"][mask]
    scale = float(unf.abs().max())
    fold_err = float((f32 - unf).abs().max())
    bf16_err = float((bf16 - f32).abs().max())
    agree = float((bf16.argmax(-1) == f32.argmax(-1)).float().mean())
    res_cmp = {"fold_max_abs_err": fold_err, "max_abs_logit": scale,
               "bf16_max_abs_err": bf16_err, "bf16_argmax_agreement": agree}
    print(f"  folded f32 vs unfolded: max|d| {fold_err:.4e} (max|logit| "
          f"{scale:.4f}, tol {PN_SERVE_FOLD_TOL * scale:.4e}); bf16 vs f32: "
          f"max|d| {bf16_err:.4e} (tol {PN_SERVE_BF16_TOL * scale:.4e}), "
          f"argmax agreement {agree:.6f} (reported, not held)", flush=True)
    if fold_err > PN_SERVE_FOLD_TOL * scale or \
            bf16_err > PN_SERVE_BF16_TOL * scale:
        raise AssertionError(f"PointNet serving: folded f32 vs unfolded or "
                             f"bf16 vs f32 out of tolerance: {res_cmp}")

    # the same weights as the reference's best_model.pth (pcs.py:373-382,
    # a DataParallel state_dict under "module.")
    sd = export_torch_state_dict({"params": model.params(),
                                  "batch_stats": model.batch_stats()})
    path = os.path.join("build", "chip_smoke_pth", "best_model.pth")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"epoch": 1,
                "model_state_dict": {f"module.{k}": torch.from_numpy(v)
                                     for k, v in sd.items()},
                "optimizer_state_dict": {}, "train_loss": 0.0,
                "val_loss": 0.0, "f1_class2": 0.0,
                "f1_per_class": [0.0] * 4, "num_classes": 4}, path)
    reset_counts()
    from_pth = Predictor.from_checkpoint(path)
    got = from_pth.logits(single)
    ref = pointnet_predictor("folded_f32", model).logits(single)
    demo = inference_example(path, [(single, single_labels)], 0,
                             log=lambda _: None)
    torch.cuda.synchronize()
    for k, v in launch_counts().items():
        launches[k] = launches.get(k, 0) + v
    if not np.array_equal(got, ref) or not np.array_equal(
            demo, ref.argmax(-1)):
        raise AssertionError(f"best_model.pth round trip: logits differ by "
                             f"{float(np.abs(got - ref).max())}")
    if any(launches.values()):
        raise AssertionError(f"PointNet serving launched kernels: "
                             f"{ {k: v for k, v in launches.items() if v} }")
    print(f"  best_model.pth (keys under module.) through "
          f"Predictor.from_checkpoint and inference_example: identical "
          f"logits ({got.shape[0]} points)", flush=True)
    return launches, {"modes": modes, **res_cmp,
                      "pth_identical_logits": True, "card": card}


# ---------------------------------------------------------------------------
# phase 20: the voxel U-Net's 128^3 remat configuration through training
# around the step, and one 256^3 remat step
# ---------------------------------------------------------------------------

# BASELINE config 3 (experiments/bench_128_step.py): VoxelUNet3d(4 classes,
# 128^3, width 16, 3 levels, bf16, remat) on B1 x 16,384 points, every impl
# "auto" (at 128^3 the scatter voxelizer, the gather devoxelize and the
# plain head1x1 with f32 logits); the single-chip leg of config 4
# (experiments/bench_256_step.py): 256^3 on B1 x 32,768
R128, R128_M, R256, R256_M = 128, 16384, 256, 32768
# the rows of the path by the op key each wrapper counts under; remat runs
# the forward rows twice a step
R128_ROWS = {1: "conv3x3_gn_act", 2: "conv3x3_dgrad", 3: "conv3x3_wgrad",
             4: "down2x_gn_act", 5: "down2x_bwd", 6: "up2x_gn_act",
             7: "up2x_bwd", 11: "trilinear_scatter"}
R128_FWD_ROWS = (1, 4, 6)
# api.evaluate on the best checkpoint against that epoch's validation
# pass: the same weights and batch, but the scatter voxelizer's index_add_
# and the level-0 convs off the tensor-core route (W = 128: conv_kernel's
# and wgrad_kernel's float atomics) sum in atomic order, so a bf16 value
# may round the other way: the loss to VOX_LOSS_REL (the kernels-vs-plain
# limit of phase 8) and the accuracy to 0.1 percentage points (the argmax
# flips only at near-ties, ARGMAX_AGREE)
R128_EVAL_ACC_POINTS = 0.1
R128_CKPT = "build/chip_smoke_ckpt_128"
R128_TRACE = "build/chip_smoke_trace_128"


def _row_of_kernel(name: str):
    """The table row (1-7, 11) a kernel of the 128^3 step belongs to, from
    its name as torch.profiler reports it; "sums" for fixed_sum_kernel,
    the partial-sum kernel that rows 1-7's tensor-core forms share; None
    for PyTorch's own kernels."""
    for key, row in (("conv3x3_mma_kernel", 1), ("dgrad_mma_kernel", 2),
                     ("wgrad_mma_kernel", 3), ("down2x_bwd_mma_kernel", 5),
                     ("down2x_mma_kernel", 4), ("up2x_bwd_mma_kernel", 7),
                     ("up2x_mma_kernel", 6), ("trilinear_scatter", 11),
                     ("fixed_sum_kernel", "sums")):
        if key in name:
            return row
    # conv3d_block.cu's CUDA-core kernels: conv_kernel<K, S, P, BWD>
    # (3^3: rows 1 / 2; k2 s2: the down forward 4 / the up's dgrad 7),
    # up_kernel<BWD> (6 / the down's dgrad 5), wgrad_kernel<MODE>
    m = re.search(r"conv_kernel<(\d), \d, \d, (true|false)>", name)
    if m:
        return {("3", "false"): 1, ("3", "true"): 2, ("2", "false"): 4,
                ("2", "true"): 7}[m.groups()]
    m = re.search(r"up_kernel<(true|false)>", name)
    if m:
        return 5 if m.group(1) == "true" else 6
    m = re.search(r"wgrad_kernel<(\d)>", name)
    if m:
        return {"0": 3, "1": 5, "2": 7}[m.group(1)]
    return None


def unet_step_bounds(r, w, levels, m, nc, n_real, remat) -> dict:
    """Row -> (launches, bound ms summed over them) of one train step of
    the fused core with the scatter/gather forms and head1x1, batch 1:
    each launch reads its inputs once and writes its outputs once (bf16
    grids, f32 row 11 output), its products at the dense bf16 peak."""
    rs = [r >> i for i in range(levels)]
    cs = [w << i for i in range(levels)]
    rows = {k: [0, 0.0] for k in R128_ROWS}
    fwd = 2 if remat else 1

    def add(row, nbytes, flops, times=1):
        for _ in range(times):
            rows[row][0] += 1
            rows[row][1] += _bound(nbytes, flops)[0]

    def conv(lv, accum=False, stats=True, dgrad=True, gadj=False):
        v, c = rs[lv] ** 3, cs[lv]
        t, wb, fl = v * c * 2, 27 * c * c * 2, 2 * v * 27 * c * c
        # x in, y out (+ accum in); gy, y, x in, dx (+ g') out; x, gy, y
        # in, dW out
        add(1, 2 * t + (t if accum else 0) + wb, fl, fwd)
        if dgrad:
            add(2, (3 if stats else 2) * t + t + wb + (t if gadj else 0), fl)
        add(3, (3 if stats else 2) * t + 27 * c * c * 4, fl)

    def resample(lv, up):
        lo, hi = (lv + 1, lv) if up else (lv, lv + 1)
        t_in = rs[lo] ** 3 * cs[lo] * 2
        t_out = rs[hi] ** 3 * cs[hi] * 2
        fl = 2 * max(rs[lo] ** 3, rs[hi] ** 3) * cs[lv] * cs[lv + 1]
        wb = 8 * cs[lv] * cs[lv + 1] * 2
        add(6 if up else 4, t_in + t_out + wb, fl, fwd)
        add(7 if up else 5, 2 * t_in + 2 * t_out + wb, 2 * fl)

    conv(0, dgrad=False)                      # stem
    for i in range(levels):
        conv(i)
        conv(i)
        if i < levels - 1:
            resample(i, up=False)
    for i in range(levels - 2, -1, -1):
        resample(i, up=True)
        conv(i, stats=False)                  # dec_a on the up input
        conv(i, accum=True, gadj=True)        # dec_a on the skip, + accum
        conv(i)                               # dec_b
    add(11, m * 3 * 4 + m * nc * 4 + r ** 3 * nc * 4, 2 * 8 * nc * n_real)
    return {k: tuple(v) for k, v in rows.items()}


def _remat_model(r, remat, dtype="bfloat16", impl="auto"):
    import torch

    from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d

    return VoxelUNet3d(
        num_classes=VOX_CLASSES, grid_size=r, width=VOX_W, levels=3,
        compute_dtype=dtype, conv_impl=impl, remat=remat,
        generator=torch.Generator().manual_seed(0)).cuda()


def _remat_batch(r, m, seed):
    import numpy as np
    import torch

    from pcseg_tpu_torch.data.batching import pad_events
    from pcseg_tpu_torch.data.class_stats import scan_classes
    from pcseg_tpu_torch.data.synthetic import synthetic_events

    events = list(synthetic_events(1, min_points=3 * m // 4, max_points=m,
                                   seed=seed))
    cw = torch.from_numpy(np.asarray(scan_classes(events).weights)).cuda()
    pts, labels, masks = (torch.from_numpy(a).cuda() for a in pad_events(
        events, m, batch_size=1))
    return pts, labels, masks, cw


def _measured_step(model, batch, plain=False):
    """One train step's loss, gradients and launches, and its memory: the
    bytes allocated after the forward (what the step keeps for the
    backward) and the step's peak, both above what was allocated before
    it, in GiB."""
    import torch

    from pcseg_tpu_torch.ops.losses import cross_entropy_sums

    pts, labels, masks, cw = batch
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    logits, _ = model.apply(pts, train=True, mask=masks, plain=plain)
    num, den = cross_entropy_sums(logits, labels, cw)
    loss = num / den
    kept = torch.cuda.memory_allocated() - base
    loss.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss.detach(), grads, launch_counts(), {
        "after_forward_gib": kept / 2 ** 30,
        "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}


def _rows(launches) -> dict:
    return {row: launches[key] for row, key in R128_ROWS.items()}


def _off_route_levels(r, w, levels):
    """The levels whose 3^3 convs ops/conv3d_block.py ``_conv_route``
    leaves to conv3d_block.cu's CUDA-core kernels (float atomics in the
    stats and dW)."""
    from pcseg_tpu_torch.ops import conv3d_block as cb

    out = []
    for i in range(levels):
        ri, ci = r >> i, w << i
        if not cb._conv_route(ci, ci, (1, ri, ri, ri, ci)):
            out.append(f"level {i}: {ri}^3 x {ci}")
    return out


def r128_step(card):
    """(a): one 128^3 remat train step with the kernels against the plain
    versions (phase 8's checks), against the same kernel step without
    remat, launches by row, memory, device ms by row and bounds."""
    import torch

    from pcseg_tpu_torch.profile_serving import device_profile

    batch = _remat_batch(R128, R128_M, 20)
    model = _remat_model(R128, True)
    forms = model.resolve_forms()
    want = {"conv": "fused", "voxelize": "scatter", "devoxelize": "gather",
            "head": "1x1"}
    if forms != want:
        raise AssertionError(f"128^3 forms {forms} != {want}")
    kept = _remat_model(R128, False)
    kept.load_state_dict(model.state_dict())
    f32 = _remat_model(R128, False, "float32", "xla")
    f32.load_state_dict(model.state_dict())

    lr, gr, launch_r, mem_r = _measured_step(model, batch)
    ln, gn, launch_n, mem_n = _measured_step(kept, batch)
    lp, gp, launch_p, _ = _measured_step(model, batch, plain=True)
    lf, gf, _, _ = _measured_step(f32, batch, plain=True)
    if any(launch_p.values()):
        raise AssertionError(f"128^3 plain step launched kernels: "
                             f"{launch_p}")
    # no kernel of the path fell back: every op of the step launched, the
    # forward rows twice with remat
    per_step = {k: VOX_PER_STEP[k] for k in R128_ROWS.values()}
    got_n = {k: launch_n[k] for k in per_step}
    want_r = {k: v * (2 if row in R128_FWD_ROWS else 1)
              for (row, k), v in zip(R128_ROWS.items(), per_step.values())}
    got_r = {k: launch_r[k] for k in per_step}
    if got_n != per_step or got_r != want_r:
        raise AssertionError(f"128^3 launches: no remat {got_n} != "
                             f"{per_step}, remat {got_r} != {want_r}")
    ok, held, _ = _step_readings(lr, gr, lp, gp, lf, gf, VOX_LOSS_REL)
    ok_n, held_n, _ = _step_readings(lr, gr, ln, gn, lf, gf, VOX_LOSS_REL)
    identical = {n: bool(torch.equal(gr[n], gn[n])) for n in gr}
    off_route = _off_route_levels(R128, VOX_W, 3)
    cause = ("" if all(identical.values()) and float(lr) == float(ln) else
             "each step voxelizes anew with the scatter voxelizer's "
             "index_add_ (atomic order), and the recomputed core's "
             + (", ".join(off_route) + " convs run off the tensor-core "
                "route (conv_kernel / wgrad_kernel float atomics)"
                if off_route else "convs all on the tensor-core routes"))

    prof, _ = device_profile(lambda: _measured_step(model, batch))
    by_row: dict = {}
    for k in prof["kernels"]:
        row = _row_of_kernel(k["name"])
        if row is not None:
            ms, calls = by_row.get(row, (0.0, 0))
            by_row[row] = (ms + k["device_ms"], calls + k["calls"])
    n_real = int(batch[2].sum())
    bounds = unet_step_bounds(R128, VOX_W, 3, R128_M, VOX_CLASSES, n_real,
                              remat=True)
    table = {str(row): {
        "launches": _rows(launch_r)[row],
        "kernel_launches_profiled": by_row.get(row, (0, 0))[1],
        "device_ms": by_row.get(row, (0.0, 0))[0],
        "bound_ms": bounds[row][1], "bound_launches": bounds[row][0]}
        for row in R128_ROWS}
    table["sums"] = {"device_ms": by_row.get("sums", (0.0, 0))[0],
                     "kernel_launches_profiled": by_row.get("sums",
                                                            (0, 0))[1]}
    res = {"forms": forms, **held, "remat_vs_kept": {
        k: held_n[k] for k in ("loss_plain", "loss_rel_err",
                               "kernel_grad_cosine", "grad_ratio_max",
                               "grad_worst", "grad_rel_err_max_held")},
        "remat_vs_kept_bit_identical": all(identical.values()),
        "remat_vs_kept_cause": cause, "off_route_levels": off_route,
        "launches_remat": {k: v for k, v in launch_r.items() if v},
        "launches_kept": {k: v for k, v in launch_n.items() if v},
        "launches_by_row_remat": _rows(launch_r),
        "launches_by_row_kept": _rows(launch_n),
        "memory_remat": mem_r, "memory_kept": mem_n,
        "step_device_busy_ms": prof["device_busy_ms"],
        "step_wall_ms": prof["wall_ms"], "idle_share": prof["idle_share"],
        "by_stage_ms": prof["by_stage_ms"], "rows": table, "card": card}
    print(f"  128^3 remat step, forms {forms}: {_readings_line(held)}",
          flush=True)
    print(f"  remat vs kept core: loss {float(lr):.6f} / {float(ln):.6f} "
          f"(rel {held_n['loss_rel_err']:.2e}), gradients bit-identical "
          f"{all(identical.values())}, conv-kernel cosine "
          f"{held_n['kernel_grad_cosine']:.6f}, worst ratio "
          f"{held_n['grad_ratio_max']:.3f} at {held_n['grad_worst']}"
          + (f"; cause: {cause}" if cause else ""), flush=True)
    print(f"  launches by row, remat {_rows(launch_r)}, kept "
          f"{_rows(launch_n)}; off the tensor-core route: {off_route}",
          flush=True)
    print(f"  memory (GiB above the step's start): remat kept "
          f"{mem_r['after_forward_gib']:.3f} after the forward, peak "
          f"{mem_r['peak_gib']:.3f}; without remat "
          f"{mem_n['after_forward_gib']:.3f} / {mem_n['peak_gib']:.3f} "
          f"[{card}]", flush=True)
    for row, t in table.items():
        print(f"    row {row}: {t}", flush=True)
    if not ok:
        raise AssertionError(f"128^3 remat step: kernels disagree with the "
                             f"plain versions: {res}")
    if not ok_n:
        raise AssertionError(f"128^3 remat step outside phase 8's limits "
                             f"of the kept-core step: {held_n}")
    del model, kept, f32
    torch.cuda.empty_cache()
    return res, launch_r, launch_n


def r128_fit(card, per_step, per_forward):
    """(b) and (c): api.fit for 2 epochs of 3 steps with the metrics log
    and the profiler trace, a fresh 1-epoch run resumed from 'latest' for
    epoch 2, api.evaluate of the best checkpoint against its epoch's
    validation pass, and Predictor on it. Returns (launches by path,
    result)."""
    import math
    import os
    import shutil

    import numpy as np
    import torch

    from pcseg_tpu_torch import api
    from pcseg_tpu_torch.ckpt.checkpoint import latest_path
    from pcseg_tpu_torch.data.synthetic import synthetic_events
    from pcseg_tpu_torch.infer import Predictor
    from pcseg_tpu_torch.train.loop import split_indices
    from pcseg_tpu_torch.utils.observe import TRACE_NAME

    # 4 events: 3 train steps of 1, 1 eval batch
    events = list(synthetic_events(4, min_points=3 * R128_M // 4,
                                   max_points=R128_M, seed=21))
    resumed_dir = R128_CKPT + "_resume"
    for d in (R128_CKPT, resumed_dir, R128_TRACE):
        shutil.rmtree(d, ignore_errors=True)
    common = ["model.name=voxel_unet3d", f"model.num_classes={VOX_CLASSES}",
              f"model.grid_size={R128}", f"model.unet_width={VOX_W}",
              "model.levels=3", "model.compute_dtype=bfloat16",
              "model.remat=true", "data.batch_size=1",
              f"data.buckets={R128_M}", "train.log_every_steps=0"]
    quiet = dict(log=lambda _: None)
    paths: dict = {}

    def driven(name, fn, steps, forwards):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = launch_counts()
        want = {k: per_step.get(k, 0) * steps + per_forward.get(k, 0)
                * forwards for k in got}
        if got != want:
            raise AssertionError(f"128^3 {name}: launches {got} != {want} "
                                 f"({steps} steps, {forwards} forwards)")
        paths[name] = got
        return out

    metrics = os.path.join(R128_CKPT, "metrics.jsonl")
    torch.cuda.reset_peak_memory_stats()
    res = driven("r128_fit", lambda: api.fit(events, overrides=common + [
        "train.num_epochs=2", f"train.checkpoint_dir={R128_CKPT}",
        f"train.metrics_log={metrics}", f"train.profile_dir={R128_TRACE}"],
        **quiet), 6, 2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [h[k] for h in res.history for k in ("train_loss", "val_loss")]
    if [h["train_steps"] for h in res.history] != [3, 3] or \
            not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"128^3 fit: history {res.history}")
    records = [json.loads(ln) for ln in open(metrics)]
    if [r["epoch"] for r in records] != [0, 1]:
        raise AssertionError(f"128^3 fit: metrics log {records}")
    trace_path = os.path.join(R128_TRACE, TRACE_NAME)
    trace = json.load(open(trace_path))["traceEvents"]
    names = {ev.get("name") for ev in trace}
    kernels = sum(ev.get("cat") == "kernel" for ev in trace)
    stages = {"voxelize", "core", "head", "devoxelize"}
    if not stages <= names or not kernels:
        raise AssertionError(f"128^3 fit: the trace lacks stages "
                             f"{stages - names} or kernels ({kernels})")

    # a fresh run of one epoch, then resumed from its 'latest' for epoch 2
    driven("r128_resume_first", lambda: api.fit(events, overrides=common + [
        "train.num_epochs=1", f"train.checkpoint_dir={resumed_dir}"],
        **quiet), 3, 1)
    again = driven("r128_resume", lambda: api.fit(
        events, overrides=common + ["train.num_epochs=2",
                                    f"train.checkpoint_dir={resumed_dir}"],
        resume_from=latest_path(resumed_dir), **quiet), 3, 1)
    if [h["epoch"] for h in again.history] != [1] or again.state.step != 6:
        raise AssertionError(f"128^3 resume: history {again.history}, step "
                             f"{again.state.step}")
    loss2, loss2_resumed = (res.history[1]["train_loss"],
                            again.history[0]["train_loss"])

    # (c) the best checkpoint on its epoch's validation events
    _, val_idx = split_indices(len(events), 0.2, 0)
    val = [events[i] for i in val_idx]
    best = res.history[res.best_epoch]
    ev = driven("r128_evaluate", lambda: api.evaluate(
        res.checkpoint_path, val, batch_size=1, buckets=(R128_M,)), 0,
        len(val))
    eval_rel = abs(ev["loss"] - best["val_loss"]) / abs(best["val_loss"])
    acc_diff = abs(ev["accuracy"] - best["val_acc"])
    if eval_rel > VOX_LOSS_REL or acc_diff > R128_EVAL_ACC_POINTS:
        raise AssertionError(f"128^3 evaluate: loss {ev['loss']} / accuracy "
                             f"{ev['accuracy']} against the val pass's "
                             f"{best['val_loss']} / {best['val_acc']}")
    one = synthetic_events(1, min_points=1000, max_points=1000, seed=23)
    served = [p for p, _ in val] + [p for p, _ in one]
    pred = Predictor.from_checkpoint(res.checkpoint_path,
                                     buckets=(1024, R128_M))
    preds, logits = driven("r128_serving", lambda: (pred.predict_batch(
        served, batch_size=1), pred.logits(served[-1])), 0, len(served) + 1)
    if [p.shape[0] for p in preds] != [e.shape[0] for e in served] or \
            not np.isfinite(logits).all():
        raise AssertionError("128^3 serving: bad predictions")
    warm = res.history[-1]
    out = {
        "train_loss": [h["train_loss"] for h in res.history],
        "val_loss": [h["val_loss"] for h in res.history],
        "epoch2_train_loss": loss2, "epoch2_train_loss_resumed":
            loss2_resumed, "epoch2_train_loss_diff": loss2_resumed - loss2,
        "resumed_step": again.state.step,
        "ms_per_step": warm["train_seconds"] * 1e3 / warm["train_steps"],
        "peak_mem_gib": peak, "metrics_records": len(records),
        "trace_bytes": os.path.getsize(trace_path),
        "trace_kernel_events": kernels,
        "evaluate": {k: ev[k] for k in ("loss", "accuracy", "f1_macro",
                                        "dropped")},
        "evaluate_vs_val_pass": {"best_epoch": res.best_epoch,
                                 "val_loss": best["val_loss"],
                                 "val_acc": best["val_acc"],
                                 "loss_rel": eval_rel,
                                 "accuracy_diff_points": acc_diff},
        "served_events": len(preds), "launches": paths, "card": card}
    print(f"  fit 128^3 remat [{card}]: train loss {out['train_loss']}, val "
          f"loss {out['val_loss']}; {out['ms_per_step']:.2f} ms/step (epoch "
          f"2), peak {peak:.3f} GiB; metrics log {len(records)} records, "
          f"trace {out['trace_bytes']} bytes, {kernels} kernel events",
          flush=True)
    print(f"  epoch-2 train loss: uninterrupted {loss2:.6f}, resumed from "
          f"'latest' {loss2_resumed:.6f} (difference "
          f"{loss2_resumed - loss2:.3e})", flush=True)
    print(f"  evaluate best (epoch {res.best_epoch}): loss {ev['loss']:.6f} "
          f"accuracy {ev['accuracy']:.3f} vs val pass "
          f"{best['val_loss']:.6f} / {best['val_acc']:.3f} (rel "
          f"{eval_rel:.2e}, tol {VOX_LOSS_REL}); Predictor served "
          f"{len(preds)} events", flush=True)
    return paths, out


def r256_step(card):
    """One 256^3 remat train step (B1 x 32,768) through the kernels:
    finite loss and gradients, launches, peak memory, and the loss and
    conv-kernel gradients against the same step through the plain
    versions."""
    import torch

    batch = _remat_batch(R256, R256_M, 24)
    model = _remat_model(R256, True)
    t0 = time.perf_counter()
    lk, gk, launches, mem = _measured_step(model, batch)
    ms_k = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(lk)) and all(
        bool(torch.isfinite(g).all()) for g in gk.values())
    want = {k: VOX_PER_STEP[k] * (2 if row in R128_FWD_ROWS else 1)
            for row, k in R128_ROWS.items()}
    got = {k: launches[k] for k in want}
    t0 = time.perf_counter()
    lp, gp, _, _ = _measured_step(model, batch, plain=True)
    ms_p = (time.perf_counter() - t0) * 1e3
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    kern = [n for n in gp if n.endswith(".kernel")]
    kk = torch.cat([gk[n].flatten() for n in kern])
    kp = torch.cat([gp[n].flatten() for n in kern])
    kcos = float(kk @ kp / (kk.norm() * kp.norm()))
    res = {"loss_kernels": float(lk), "loss_plain": float(lp),
           "loss_rel_err": loss_rel, "kernel_grad_cosine": kcos,
           "finite": finite, "launches_by_row": _rows(launches),
           "off_route_levels": _off_route_levels(R256, VOX_W, 3),
           "memory": mem, "step_ms_kernels_first": ms_k,
           "step_ms_plain_first": ms_p, "card": card}
    print(f"  256^3 remat step [{card}]: loss kernels {float(lk):.6f} plain "
          f"{float(lp):.6f} (rel {loss_rel:.2e}), conv-kernel gradient "
          f"cosine {kcos:.6f}, finite {finite}; launches by row "
          f"{_rows(launches)}; kept {mem['after_forward_gib']:.3f} GiB "
          f"after the forward, peak {mem['peak_gib']:.3f} GiB; first step "
          f"{ms_k:.0f} ms kernels, {ms_p:.0f} ms plain", flush=True)
    del model
    torch.cuda.empty_cache()
    if not finite or got != want or loss_rel > VOX_LOSS_REL or \
            kcos < VOX_KERNEL_COS:
        raise AssertionError(f"256^3 remat step: {res}, launches {got} != "
                             f"{want}")
    return res


# ---------------------------------------------------------------------------
# phase 21: the data on disk
# ---------------------------------------------------------------------------

# (a) the size of the reference's train_xyze_1e4.h5, with the CLI synth's
# defaults (100-2,000 points, 4 classes, seed 0); (b) PointNetSeg at full
# width from those files through `cli train` (its default buckets, which
# `cli eval` shares, so the evaluation repeats the validation batches),
# 2 epochs of 125 train steps and 32 val batches; (d) the default voxel
# U-Net one epoch from a 512-event file
FILES_EVENTS, FILES_VOX_EVENTS = 10_000, 512
FILES_PN = ["model.bn_stats=fused", "model.compute_dtype=bfloat16",
            f"data.batch_size={PN_B}", "data.prefetch_depth=2",
            "train.num_epochs=2", "train.log_every_steps=0"]
FILES_VOX = ["model.name=voxel_unet3d", "model.compute_dtype=bfloat16",
             f"data.batch_size={VOX_B}", f"data.buckets={VOX_M}",
             "train.num_epochs=1", "train.log_every_steps=0"]
FILES_CKPT = "build/chip_smoke_ckpt_files"


def _cli(argv) -> tuple[dict, str]:
    """``pcseg_tpu_torch.cli.main(argv)`` in this process (so the launch
    counts see it): its JSON line and everything it printed."""
    import contextlib
    import io

    from pcseg_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} exited {rc}:\n{out[-2000:]}")
    return json.loads(out.strip().splitlines()[-1]), out


def _synth(tmp, name, events) -> tuple[str, str, dict]:
    """``python -m pcseg_tpu_torch.cli synth`` as a user runs it."""
    import os

    data, labels = (os.path.join(tmp, f"{name}_xyze.h5"),
                    os.path.join(tmp, f"{name}_label.h5"))
    proc = subprocess.run(
        [sys.executable, "-m", "pcseg_tpu_torch.cli", "synth", "--data",
         data, "--labels", labels, "--events", str(events)],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"cli synth failed:\n{proc.stderr[-3000:]}")
    return data, labels, json.loads(proc.stdout.strip().splitlines()[-1])


def _epoch_points(item) -> int:
    """Padded points of a batch, host or placed (shape only, no sync)."""
    pts = getattr(item, "tensors", item)[0]
    return int(pts.shape[0] * pts.shape[1])


# the idle share is read over a window of this many train steps; the
# host-clock epochs are timed this many times each
FILES_PROFILE_STEPS, FILES_ROUNDS = 30, 3


def files_feed(card, ds, train_idx, cw):
    """(b)'s feed checks and timings on the training split of ``ds``: the
    prefetched device batches against the inline ones (torch.equal), the
    packer's batches (gathered straight from the files) against numpy's
    from events read one by one, byte for byte, with its call counts; one
    timed train epoch and a profiled window (idle share) at prefetch
    depth 0 and 2, packer on and off."""
    import itertools

    import torch

    from pcseg_tpu_torch.core.config import ModelConfig
    from pcseg_tpu_torch.data import native
    from pcseg_tpu_torch.data.batching import BucketBatcher
    from pcseg_tpu_torch.data.prefetch import (
        DevicePlace,
        device_batch,
        prefetch,
    )
    from pcseg_tpu_torch.models.factory import build_model
    from pcseg_tpu_torch.profile_serving import device_profile
    from pcseg_tpu_torch.train.loop import _run_epoch_train
    from pcseg_tpu_torch.train.steps import create_train_state

    dev = torch.device("cuda")

    def batcher(use_native=True):
        return BucketBatcher(ds, PN_B, indices=train_idx, shuffle=True,
                             seed=0, use_native=use_native)

    # the prefetched device batches against the inline ones
    place = DevicePlace(dev)
    fetched = prefetch(batcher(), 2, place)
    n_equal = 0
    try:
        for item, host in zip(fetched, batcher()):
            a, b = device_batch(item, dev), device_batch(host, dev)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"prefetched batch {n_equal} differs "
                                     "from the inline one")
            n_equal += 1
    finally:
        fetched.close()
    if n_equal != len(batcher()):
        raise AssertionError(f"prefetch gave {n_equal} batches")

    # the packer against numpy, byte for byte, on the same epoch
    native.reset_calls()
    n_native = 0
    for a, b in zip(batcher(True), batcher(False)):
        if any(x.tobytes() != y.tobytes() for x, y in zip(a, b)):
            raise AssertionError(f"packer batch {n_native} differs")
        n_native += 1
    calls = dict(native.CALLS)
    if calls != {"pack_batch": 0, "pack_gather": n_native,
                 "bucket_sort_windows": 1}:
        raise AssertionError(f"packer calls {calls} for {n_native} batches")

    real = sum(ds.num_points(int(i)) for i in train_idx)
    model = build_model(ModelConfig(bn_stats="fused",
                                    compute_dtype="bfloat16"), PN_CLASSES,
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(model.cuda(), None)
    state.model.train()
    timing, epochs = {}, itertools.count()

    def epoch(depth, use_native, max_steps=None):
        """Train steps over one epoch (or its first ``max_steps``): (s,
        steps, padded points)."""
        it = batcher(use_native)
        it = prefetch(it, depth, place) if depth else it
        pts = [0]

        def counted():
            for item in itertools.islice(it, max_steps):
                pts[0] += _epoch_points(item)
                yield item

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            _, _, steps, _ = _run_epoch_train(
                state, counted(), 1e-4, cw, 0, next(epochs), dev,
                lambda _: None)
        finally:
            if depth:
                it.close()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, steps, pts[0]

    # host-clock epochs vary from run to run on a shared host: each
    # setting is timed FILES_ROUNDS times, in turns (ABCD DCBA ABCD)
    settings = [(d, n) for d in (0, 2) for n in (True, False)]
    runs = {k: [] for k in settings}
    for r in range(FILES_ROUNDS):
        for depth, use_native in (settings if r % 2 == 0 else
                                  settings[::-1]):
            runs[depth, use_native].append(epoch(depth, use_native))
    for depth, use_native in settings:
        prof, _ = device_profile(
            lambda: epoch(depth, use_native, FILES_PROFILE_STEPS), stages=())
        ms = sorted(sec * 1e3 / steps for sec, steps, _ in
                    runs[depth, use_native])
        _, steps, padded = runs[depth, use_native][0]
        key = f"depth{depth}_{'native' if use_native else 'numpy'}"
        med = ms[len(ms) // 2]
        timing[key] = {
            "ms_per_step": med, "ms_per_step_runs": ms, "steps": steps,
            "padded_points_per_s": padded / (med * steps / 1e3),
            "points_per_s": real / (med * steps / 1e3),
            "profiled_steps": FILES_PROFILE_STEPS,
            "profiled_wall_ms_per_step":
                prof["wall_ms"] / FILES_PROFILE_STEPS,
            "device_busy_ms_per_step":
                prof["device_busy_ms"] / FILES_PROFILE_STEPS,
            "idle_share": prof["idle_share"]}
        print(f"  epoch at prefetch depth {depth}, "
              f"{'packer' if use_native else 'numpy'} [{card}]: median "
              f"{med:.3f} ms/step of {len(ms)} epochs of {steps} steps "
              f"({ms[0]:.3f}-{ms[-1]:.3f}), "
              f"{timing[key]['points_per_s']:.4e} points/s "
              f"({timing[key]['padded_points_per_s']:.4e} padded); "
              f"{FILES_PROFILE_STEPS} profiled steps: busy "
              f"{timing[key]['device_busy_ms_per_step']:.3f} ms/step, "
              f"idle share {prof['idle_share']:.3f}", flush=True)
    del state, model
    torch.cuda.empty_cache()
    return {"prefetched_batches_equal": n_equal,
            "packer_batches_equal": n_native, "packer_calls": calls,
            "timing": timing}


def files_phase(card):
    """Phase 21: (a) 10,000 events written by ``cli synth`` and read back
    bit for bit by the port's reader (events/s both ways); (b) PointNetSeg
    trained from them by ``cli train`` (rows 15-17's launches a step held
    to phase 6's, finite losses) and the feed checks of ``files_feed``;
    (c) ``cli eval`` of the best checkpoint against its epoch's
    validation pass (its events written to files of their own), ``cli
    infer`` of event 0 against ``Predictor.predict``; (d) the default
    voxel U-Net one epoch from a 512-event file through ``cli train``,
    its launches a step and a forward held to phase 12's. Returns
    (PointNet launches, voxel launches, result)."""
    import math
    import os
    import tempfile

    import torch

    from pcseg_tpu_torch.data.hdf5 import (
        PointCloudDataset,
        write_event_files,
    )
    from pcseg_tpu_torch.data.synthetic import synthetic_events
    from pcseg_tpu_torch.infer import Predictor
    from pcseg_tpu_torch.train.loop import split_indices

    out = {"card": card}
    t_phase = time.perf_counter()

    def at():
        return f"[{time.perf_counter() - t_phase:.1f} s]"

    with tempfile.TemporaryDirectory() as tmp:
        # (a) write, then read every event back
        data, labels, synth = _synth(tmp, "train", FILES_EVENTS)
        events = list(synthetic_events(FILES_EVENTS))
        t0 = time.perf_counter()
        with PointCloudDataset(data, labels) as ds:
            for i, (p, y) in enumerate(events):
                got_p, got_y = ds[i]
                if got_p.tobytes() != p.tobytes() or \
                        got_y.tobytes() != y.tobytes():
                    raise AssertionError(f"event {i} read back differs")
        read_s = time.perf_counter() - t0
        out["io"] = {
            "events": synth["events"],
            "bytes": os.path.getsize(data) + os.path.getsize(labels),
            "write_events_per_s": synth["events"] / synth["write_seconds"],
            "read_events_per_s": FILES_EVENTS / read_s,
            "points": int(sum(p.shape[0] for p, _ in events))}
        print(f"  (a) cli synth: {synth['events']} events, "
              f"{out['io']['bytes'] / 2 ** 20:.1f} MiB, written at "
              f"{out['io']['write_events_per_s']:.0f} events/s, read back "
              f"bit for bit at {out['io']['read_events_per_s']:.0f} "
              f"events/s [{card}] {at()}", flush=True)

        # (b) cli train from the files
        metrics = os.path.join(FILES_CKPT, "metrics.jsonl")
        if os.path.exists(metrics):
            os.unlink(metrics)
        reset_counts()
        res, _ = _cli(["train", "--data", data, "--labels", labels,
                       *FILES_PN, f"train.checkpoint_dir={FILES_CKPT}",
                       f"train.metrics_log={metrics}"])
        torch.cuda.synchronize()
        pn_launches = launch_counts()
        hist = [json.loads(ln) for ln in open(metrics)]
        steps = sum(h["train_steps"] for h in hist)
        want = {k: PN_FUSED_PER_STEP.get(k, 0) * steps for k in pn_launches}
        per_epoch = -(-int(0.8 * FILES_EVENTS) // PN_B)    # 125
        if [h["train_steps"] for h in hist] != [per_epoch] * 2 or \
                pn_launches != want:
            raise AssertionError(f"cli train: {len(hist)} epochs, steps "
                                 f"{[h['train_steps'] for h in hist]}, "
                                 f"launches {pn_launches} != {want}")
        losses = [h[k] for h in hist for k in ("train_loss", "val_loss")]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"cli train: non-finite loss {losses}")
        out["pointnet_fit"] = {
            "steps": steps,
            "launches_per_step": {k: v / steps for k, v in
                                  pn_launches.items() if v},
            "train_loss": [h["train_loss"] for h in hist],
            "val_loss": [h["val_loss"] for h in hist],
            "ms_per_step": [h["train_seconds"] * 1e3 / h["train_steps"]
                            for h in hist],
            "epoch_seconds": [h["seconds"] for h in hist],
            "best_epoch": res["best_epoch"]}
        print(f"  (b) cli train PointNetSeg fused bf16 B{PN_B}, prefetch "
              f"depth 2 [{card}]: {steps} steps, launches per step "
              f"{out['pointnet_fit']['launches_per_step']}; train loss "
              f"{out['pointnet_fit']['train_loss']}, val loss "
              f"{out['pointnet_fit']['val_loss']}; ms/step "
              f"{out['pointnet_fit']['ms_per_step']} {at()}", flush=True)

        with PointCloudDataset(data, labels) as ds:
            train_idx, val_idx = split_indices(len(ds), 0.2, 0)
            cw = torch.tensor([1.0] * PN_CLASSES, device="cuda")
            out["feed"] = files_feed(card, ds, train_idx, cw)
            print(f"  (b) feed checks and timings done {at()}", flush=True)
            val = [ds[int(i)] for i in val_idx]
            event0 = ds[0][0]

        # (c) cli eval on the validation events, cli infer on event 0
        vdata, vlabels = (os.path.join(tmp, "val_xyze.h5"),
                          os.path.join(tmp, "val_label.h5"))
        write_event_files(vdata, vlabels, val)
        ckpt = res["checkpoint"]
        ev, _ = _cli(["eval", "--checkpoint", ckpt, "--data", vdata,
                      "--labels", vlabels])
        best = hist[res["best_epoch"]]
        if ev["loss"] != best["val_loss"] or ev["accuracy"] != \
                best["val_acc"]:
            raise AssertionError(f"cli eval {ev['loss']} / {ev['accuracy']} "
                                 f"!= the val pass's {best['val_loss']} / "
                                 f"{best['val_acc']}")
        inf, _ = _cli(["infer", "--checkpoint", ckpt, "--data", data,
                       "--labels", labels, "--event", "0", "--dump"])
        want_pred = Predictor.from_checkpoint(ckpt).predict(event0)
        if inf["predictions"] != want_pred.tolist():
            raise AssertionError("cli infer disagrees with Predictor")
        out["eval"] = {"loss": ev["loss"], "accuracy": ev["accuracy"],
                       "best_epoch": res["best_epoch"],
                       "val_pass": [best["val_loss"], best["val_acc"]]}
        out["infer"] = {"event": 0, "num_points": inf["num_points"],
                        "accuracy": inf["accuracy"]}
        print(f"  (c) cli eval of the best checkpoint (epoch "
              f"{res['best_epoch']}): loss {ev['loss']:.6f}, accuracy "
              f"{ev['accuracy']:.3f} %, equal to its val pass; cli infer "
              f"event 0 ({inf['num_points']} points) equal to "
              f"Predictor.predict [{card}] {at()}", flush=True)

        # (d) the default voxel U-Net from a 512-event file
        vd, vl, _ = _synth(tmp, "voxel", FILES_VOX_EVENTS)
        vmetrics = os.path.join(FILES_CKPT + "_voxel", "metrics.jsonl")
        if os.path.exists(vmetrics):
            os.unlink(vmetrics)
        reset_counts()
        _cli(["train", "--data", vd, "--labels", vl, *FILES_VOX,
              f"train.checkpoint_dir={FILES_CKPT}_voxel",
              f"train.metrics_log={vmetrics}"])
        torch.cuda.synchronize()
        vox_launches = launch_counts()
        (h,) = [json.loads(ln) for ln in open(vmetrics)]
        n_train = int(0.8 * FILES_VOX_EVENTS)
        steps = -(-n_train // VOX_B)
        evals = -(-(FILES_VOX_EVENTS - n_train) // VOX_B)
        want = {k: DEFAULT_PER_STEP.get(k, 0) * steps
                + DEFAULT_PER_FORWARD.get(k, 0) * evals for k in vox_launches}
        if h["train_steps"] != steps or vox_launches != want:
            raise AssertionError(f"cli train voxel: {h['train_steps']} steps,"
                                 f" launches {vox_launches} != {want}")
        if not (math.isfinite(h["train_loss"]) and
                math.isfinite(h["val_loss"])):
            raise AssertionError(f"cli train voxel: {h}")
        out["voxel_fit"] = {
            "steps": steps, "eval_batches": evals,
            "launches_per_step": {k: DEFAULT_PER_STEP.get(k, 0) for k, v in
                                  vox_launches.items() if v},
            "train_loss": h["train_loss"], "val_loss": h["val_loss"],
            "ms_per_step": h["train_seconds"] * 1e3 / steps,
            "epoch_seconds": h["seconds"]}
        print(f"  (d) cli train voxel_unet3d default 64^3/w16/L3 bf16 "
              f"B{VOX_B} x {VOX_M} [{card}]: {steps} steps + {evals} eval "
              f"batches, launches held to phase 12's; train loss "
              f"{h['train_loss']:.4f}, val loss {h['val_loss']:.4f}; "
              f"{out['voxel_fit']['ms_per_step']:.2f} ms/step (first epoch) "
              f"{at()}", flush=True)
    del events, val
    return pn_launches, vox_launches, out


def _mma_fields(at, cases) -> dict:
    """The tensor-core rows' device times at the row's shape and each
    case's (device ms, library device ms, bound ms) beside them, keyed by
    variant and shape, and the cases off the tensor-core route (op ms,
    plain ms, library ms); nothing for the other rows."""
    if "device_ms" not in at:
        return {}
    mma = [c for c in cases if "device_ms" in c]
    return {"device_ms": at["device_ms"],
            "library_device_ms": at["library_device_ms"],
            "by_shape": {f"{c['case']} {c['shape']}": [
                c["device_ms"], c["library_device_ms"], c["bound_ms"]]
                for c in mma},
            "repeat_bit_identical": all(c["repeat_bit_identical"]
                                        for c in mma),
            "off_route": {f"{c['case']} {c['shape']}": [
                c["ms"], c["plain_ms"], c["library_ms"]]
                for c in cases if "device_ms" not in c}}


def _r128_fields(name, r128) -> dict:
    """Row ``name``'s device ms, launches and bound in one 128^3 remat
    step (phase 20), beside its row."""
    row = next(r for r, k in R128_ROWS.items() if k == name)
    return {"r128_remat_step": r128["rows"][str(row)]}


def _scatter_fields(cases) -> dict:
    """Row 11's op times, bf16 output, second yardstick and default-batch
    numbers beside its row; nothing for the other rows."""
    if cases[0]["name"] != "trilinear_scatter":
        return {}
    keys = ("op_ms", "bf16_ms", "bf16_op_ms", "bf16_bound_ms", "library",
            "library_op_ms", "index_add_alone_ms", "index_add_alone_op_ms")
    return {"by_case": {c["case"]: {k: c[k] for k in ("ms",) + keys}
                        for c in cases},
            **{k: cases[0][k] for k in keys}}


def step_spread(card, n) -> int:
    """Phases 8, 12 and 16's step comparisons n times each; their loss and
    worst gradient ratio as one JSON line."""
    runs = {"phase8": lambda: vox_step_compare(card, hold=False),
            "phase12": lambda: vox_step_compare(card, default=True,
                                                hold=False),
            "phase16": lambda: sparse_step_compare(card, hold=False)}
    out = {"card": card}
    for _ in range(n):
        for key, run in runs.items():
            res = run()
            for field in ("loss_rel_err", "loss_rel_kernels_vs_kernels",
                          "grad_ratio_max", "kernel_grad_cosine",
                          "update_ratio_max"):
                if field in res:
                    out.setdefault(key, {}).setdefault(field, []).append(
                        res[field])
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pcseg_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SIGNATURES:
        _build.load_library(name)
    print(f"[1] build: {time.perf_counter() - t0:.1f} s", flush=True)
    wgmma = wgmma_report()
    if sys.argv[1:2] == ["--step-spread"]:
        return step_spread(card, int(sys.argv[2]))
    if sys.argv[1:2] == ["--r128"]:
        r128, launch_r, launch_n = r128_step(card)
        _, fitted = r128_fit(card, launch_r,
                             {k: launch_n[k] for k in PER_FORWARD})
        print(json.dumps({"card": card, "r128_step": r128,
                          "r128_fit": fitted, "r256_step": r256_step(card)}))
        return 0
    if sys.argv[1:2] == ["--files"]:
        print(json.dumps({"card": card, "files": files_phase(card)[2]}))
        return 0
    if sys.argv[1:2] == ["--pointnet"]:
        gen = torch.Generator(device="cuda").manual_seed(0)
        cases, sums = pn_training_cases(gen, dropout=False)
        print(json.dumps({"card": card, "pointnet_cases": cases,
                          "row15_step": sums}))
        return 0

    print(f"[2] kernels vs plain versions [{card}]", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [run_case(*c, gen) for c in kernel_cases()]

    print(f"[3] serving [{card}]", flush=True)
    launches, served = serve(card)

    print(f"[4] PointNet training kernels vs plain versions, B{PN_B} x "
          f"{PN_M} [{card}]", flush=True)
    pn_cases, pn_sums = pn_training_cases(gen)

    print(f"[5] one fused train step, kernels vs plain [{card}]", flush=True)
    step = pn_step_compare(card)
    step_widths = [pn_step_compare(card, classes, input_dim)
                   for classes, input_dim in PN_WIDTHS]

    print(f"[6] api.fit on the card [{card}]", flush=True)
    from pcseg_tpu_torch.data.synthetic import synthetic_events

    events = list(synthetic_events(5 * PN_B, min_points=1100,
                                   max_points=PN_M, seed=3))
    fit_launches, fits = {}, {}
    for bn_stats in ("fused", "exact"):
        got, fits[bn_stats] = pn_fit(card, bn_stats, events)
        for k, v in got.items():
            fit_launches[k] = fit_launches.get(k, 0) + v
    for classes, input_dim in PN_WIDTHS:
        got, fits[f"fused {classes} classes, input_dim {input_dim}"] = \
            pn_fit(card, "fused", pn_events(3 * PN_B, 7, classes, input_dim),
                   classes, input_dim)
        for k, v in got.items():
            fit_launches[k] = fit_launches.get(k, 0) + v
    unused = [k for k, v in fit_launches.items() if v == 0]
    if unused:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{unused}")

    print(f"[7] voxel U-Net backward kernels vs plain versions, B{VOX_B} x "
          f"{VOX_R}^3 [{card}]", flush=True)
    vox_cases = []
    for kind, label, r, cin, cout, kw in vox_bwd_cases():
        if kind == "conv3x3":
            vox_cases += vox_conv3x3_case(label, r, cin, cout, kw, gen)
        else:
            vox_cases.append(vox_resample_case(kind, label, r, cin, cout,
                                               kw, gen))
    vox_cases.append(vox_scatter_case(gen))

    print(f"[8] one voxel U-Net train step, kernels vs plain [{card}]",
          flush=True)
    vox_step = vox_step_compare(card)

    print(f"[9] api.fit on the voxel U-Net, then Predictor [{card}]",
          flush=True)
    vox_launches, vox_serve, vox_fitted = vox_fit(card)
    unused = [k for k in VOX_PER_STEP if vox_launches[k] == 0]
    if unused:
        raise AssertionError(f"kernels never launched on the voxel training "
                             f"path: {unused}")

    print(f"[10] default-configuration kernels vs plain versions, B{VOX_B} "
          f"x {VOX_R}^3 [{card}]", flush=True)
    points, mask = default_batch()
    def_cases = [default_voxelize_case(points, mask),
                 default_gather_case(points, mask, gen)]
    vox_cases.append(default_scatter_case(points, mask, gen))
    def_cases += default_head_cases(gen)
    head_widths = head_width_cases(gen)
    # row 10 at the sparse model's call site and on uniform ids; rows 13
    # and 11 past 32 channels
    row10_sparse = sparse_voxelize_case()
    row10_uniform = uniform_voxelize_case()
    wide_devox = wide_devox_cases(points, mask, gen)
    del points, mask

    print(f"[11] serving the default configuration [{card}]", flush=True)
    def_launches, def_served = serve(card, default=True)

    print(f"[12] one default-configuration train step, kernels vs plain; "
          f"api.fit with no impl override, then Predictor [{card}]",
          flush=True)
    def_step = vox_step_compare(card, default=True)
    def_fit_launches, def_fit_serve, def_fitted = vox_fit(card, default=True)
    unused = [k for k in DEFAULT_PER_STEP if def_fit_launches[k] == 0]
    if unused:
        raise AssertionError(f"kernels never launched on the default "
                             f"training path: {unused}")

    print(f"[12b] the 20- and 40-class 32^3 U-Nets through the fused head: "
          f"serving and one train step each, kernels vs plain [{card}]",
          flush=True)
    wide_served, wide_stepped, wide = {}, {}, []
    for classes in WIDE_CLASSES:
        served_c, stepped_c, res_c = wide_head_phase(card, classes)
        for got, into in ((served_c, wide_served), (stepped_c, wide_stepped)):
            for k, v in got.items():
                into[k] = into.get(k, 0) + v
        wide.append(res_c)

    print(f"[13] sparse kernels vs plain versions, B{SP_B} x {SP_M} track "
          f"events [{card}]", flush=True)
    sp_cases = sparse_cases(gen)

    print(f"[14] serving the sparse U-Net [{card}]", flush=True)
    sp_launches, sp_served = sparse_serve(card)

    print(f"[15] sparse training kernels vs plain versions, B{SP_B} x "
          f"{SP_M} track events [{card}]", flush=True)
    spb_cases = sparse_bwd_cases(gen)

    print(f"[16] one sparse train step, kernels vs plain [{card}]",
          flush=True)
    sp_step = sparse_step_compare(card)

    print(f"[17] api.fit on the sparse U-Net, then Predictor [{card}]",
          flush=True)
    spf_launches, spf_serve, sp_fitted = sparse_fit(card)
    unused = [k for k in SP_PER_STEP if spf_launches[k] == 0]
    if unused:
        raise AssertionError(f"kernels never launched on the sparse training "
                             f"path: {unused}")

    print(f"[18] rows 14 and 19 (reached only by tests) vs plain versions "
          f"[{card}]", flush=True)
    to_cases, to_launches = test_only_cases(gen)

    print(f"[19] serving PointNetSeg through Predictor [{card}]", flush=True)
    pns_launches, pn_served = pointnet_serve(card)

    print(f"[20] the {R128}^3 remat U-Net: one step vs plain and without "
          f"remat; api.fit, resume from 'latest', api.evaluate, Predictor; "
          f"one {R256}^3 remat step [{card}]", flush=True)
    r128, r128_launch_r, r128_launch_n = r128_step(card)
    r128_paths, r128_fitted = r128_fit(
        card, r128_launch_r, {k: r128_launch_n[k] for k in PER_FORWARD})
    r256 = r256_step(card)

    print(f"[21] the data on disk: cli synth of {FILES_EVENTS} events, cli "
          f"train / eval / infer from the files (PointNetSeg, then the "
          f"default voxel U-Net), prefetch and the native packer [{card}]",
          flush=True)
    files_pn, files_vox, files = files_phase(card)

    main_case = {
        "conv3x3_gn_act": ("act", "B8 64^3x16->64^3x16"),
        "down2x_gn_act": ("act", "B8 64^3x16->32^3x32"),
        "up2x_gn_act": ("act", "B8 32^3x32->64^3x16"),
    }
    kernels = []
    for name, (label, shape) in main_case.items():
        mine = [c for c in cases if c["name"] == name]
        at = next(c for c in mine if c["case"] == label and c["shape"] == shape)
        key = MMA_KEY.get(name, name)
        by_path = {"serving": launches[key],
                   "voxel_fit": vox_launches[key],
                   "voxel_fit_serving": vox_serve[key],
                   "default_serving": def_launches[key],
                   "default_fit": def_fit_launches[key],
                   "default_fit_serving": def_fit_serve[key],
                   **{p: got[key] for p, got in r128_paths.items()},
                   "files_voxel_fit": files_vox[key]}
        kernels.append({
            "name": name, "route": "cuda", "source": FWD_SOURCES[name],
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "shape": shape,
            **_mma_fields(at, mine), **_r128_fields(name, r128),
        })
    # voxel backward rows: numbers at the largest shape each has on the
    # training path; launches from the api.fit run of phase 9
    vox_main = {"conv3x3_dgrad": ("act", "B8 64^3 16->16"),
                "conv3x3_wgrad": ("act", "B8 64^3 16->16"),
                "down2x_bwd": ("act", "B8 64^3x16->32^3x32"),
                "up2x_bwd": ("act", "B8 32^3x32->64^3x16"),
                "trilinear_scatter": ("devox bwd", "B8 M8192 R64 C4")}
    for name, (label, shape) in vox_main.items():
        mine = [c for c in vox_cases if c["name"] == name]
        at = next(c for c in mine if c["case"] == label and c["shape"] == shape)
        key = MMA_KEY.get(name, name)
        by_path = {"voxel_fit": vox_launches[key],
                   "default_fit": def_fit_launches[key],
                   **{p: got[key] for p, got in r128_paths.items()},
                   "files_voxel_fit": files_vox[key]}
        kernels.append({
            "name": name, "route": "cuda", "source": VOX_SOURCES[name],
            "replaces": VOX_REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "shape": shape,
            **_mma_fields(at, mine), **_scatter_fields(mine),
            **_r128_fields(name, r128),
        })
    # default-configuration rows: numbers at the B8 x 8192, 64^3 shapes of
    # phase 10; launches from phases 11 and 12
    for at in def_cases:
        name = at["name"]
        by_path = {"default_serving": def_launches[name],
                   "default_fit": def_fit_launches[name],
                   "default_fit_serving": def_fit_serve[name],
                   "wide_head_serving": wide_served[name],
                   "wide_head_step": wide_stepped[name],
                   "files_voxel_fit": files_vox[name]}
        if name in sp_launches and SP_PER_FORWARD.get(name):
            by_path["sparse_serving"] = sp_launches[name]
            by_path["sparse_fit"] = spf_launches[name]
            by_path["sparse_fit_serving"] = spf_serve[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCE if name.startswith("head") else TRI_SOURCE,
            "replaces": DEFAULT_REPLACES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": at["max_abs_err"], "ms": at["ms"],
            "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": at["library_ms"],
            "shape": at["shape"],
        })
    # sparse rows: numbers at the level-0 64 -> 64 bf16 shape (the largest
    # LN input; the level-1 conv's numbers are in the cases); launches from
    # phases 14 and 17; the training kernels' rows from phase 15 (rowcol
    # at the readout's one shape)
    for name in ("block_conv", "bias_ln_relu_mask"):
        mine = [c for c in sp_cases + spb_cases if c["name"] == name]
        at = next(c for c in mine if c["case"] == "level 0")
        by_path = {"sparse_serving": sp_launches[name],
                   "sparse_fit": spf_launches[name],
                   "sparse_fit_serving": spf_serve[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": SP_SOURCES[name],
            "replaces": SP_REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "shape": at["shape"],
        })
    for name in SP_BWD_REPLACES:
        mine = [c for c in spb_cases if c["name"] == name]
        at = next(c for c in mine if c["case"] in ("level 0", "readout bwd"))
        kernels.append({
            "name": name, "route": "cuda", "source": SP_BWD_SOURCES[name],
            "replaces": SP_BWD_REPLACES[name],
            "launches": spf_launches[name],
            "launches_by_path": {"sparse_fit": spf_launches[name]},
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "shape": at["shape"],
        })
    # row 20's backward on its vector route (the launches of the op row
    # above that took it): numbers at level 0, every on-route case's error
    mine = [c for c in spb_cases if c["name"] == "bias_ln_relu_mask_bwd"
            and c["route"] == "vector"]
    at = next(c for c in mine if c["case"] == "level 0")
    kernels.append({
        "name": "bias_ln_relu_mask_bwd_vec", "route": "cuda",
        "source": SP_SOURCES["bias_ln_relu_mask"],
        "replaces": SP_BWD_REPLACES["bias_ln_relu_mask_bwd"],
        "launches": spf_launches["bias_ln_relu_mask_bwd_vec"],
        "launches_by_path": {
            "sparse_fit": spf_launches["bias_ln_relu_mask_bwd_vec"]},
        "max_abs_err": max(c["max_abs_err"] for c in mine),
        "ms": at["ms"], "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
        "library_ms": at["library_ms"], "shape": at["shape"],
    })
    # row 21's tensor-core routes (the launches of the op rows above that
    # took them): numbers at level 0 64 -> 64, every on-route case's error
    for name, replaces in (("block_conv", SP_REPLACES["block_conv"]),
                           ("block_conv_dgrad",
                            SP_BWD_REPLACES["block_conv_dgrad"]),
                           ("block_conv_wgrad",
                            SP_BWD_REPLACES["block_conv_wgrad"])):
        key = f"{name}_mma"
        mine = [c for c in sp_cases + spb_cases
                if c["name"] == name and c["route"] == "tensor cores"]
        at = next(c for c in mine if c["case"] == "level 0")
        by_path = {"sparse_fit": spf_launches[key]}
        if name == "block_conv":
            by_path.update(sparse_serving=sp_launches[key],
                           sparse_fit_serving=spf_serve[key])
        kernels.append({
            "name": key, "route": "cuda", "source": SP_SOURCES["block_conv"],
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": at["ms"], "device_ms": at["device_ms"],
            "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": at["library_ms"],
            "shape": at["shape"],
        })
    # PointNet rows: forward numbers at each kernel's largest shape, the
    # backward's beside them; launches are forward + backward on the main
    # path (both api.fit runs)
    pn_main = {"fused_block": "conv5", "fused_global_pool_block":
               "global_feat", "fused_seg4_ce": "seg4+CE",
               "dropout": "seg1 out"}
    for name, label in pn_main.items():
        mine = [c for c in pn_cases if c["name"] == name]
        at = next(c for c in mine if c["case"] == label)
        by_path = {p: got[name] + got.get(f"{name}_bwd", 0)
                   for p, got in (("fit", fit_launches),
                                  ("files_pointnet_fit", files_pn))}
        kernels.append({
            "name": name, "route": "cuda",
            "source": PN_SOURCES[name],
            "replaces": PN_REPLACES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "shape": at["shape"],
            "bwd_ms": at["bwd_ms"], "bwd_plain_ms": at["bwd_plain_ms"],
            "bwd_bound_ms": at["bwd_bound_ms"],
            **{k: at[k] for k in ("bwd_library_ms", "device_ms",
                                  "bwd_device_ms") if k in at},
            **({"step_sums": pn_sums} if name == "fused_block" else {}),
        })
    # rows 14 and 19: numbers at the PointNet global layer's shape and at
    # the B8 x 8192, R64 voxel shape; no main path launches them
    paths = {"serving": launches, "voxel_fit": vox_launches,
             "voxel_fit_serving": vox_serve, "default_serving": def_launches,
             "default_fit": def_fit_launches,
             "default_fit_serving": def_fit_serve,
             "sparse_serving": sp_launches, "sparse_fit": spf_launches,
             "sparse_fit_serving": spf_serve,
             "pointnet_serving": pns_launches,
             "files_pointnet_fit": files_pn, "files_voxel_fit": files_vox}
    for name, label, keys in (
            ("fused_global_pool", "pointnet global",
             ("fused_pool", "fused_pool_bwd")),
            ("segment_scatter", "voxel R64", ("segment_scatter",))):
        mine = [c for c in to_cases if c["name"] == name]
        at = next(c for c in mine if c["case"] == label)
        by_path = {path: sum(got[k] for k in keys)
                   for path, got in paths.items()}
        if any(by_path.values()):
            raise AssertionError(f"{name} launched on a main path: "
                                 f"{by_path}")
        by_path["tests"] = sum(to_launches[k] for k in keys)
        row = {
            "name": name, "route": "cuda",
            "source": TEST_ONLY_SOURCES[name],
            "replaces": TEST_ONLY_REPLACES[name], "launches": 0,
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "library": at["library"],
            "shape": at["shape"],
        }
        if "bwd_ms" in at:
            row.update({k: at[k] for k in (
                "bwd_ms", "bwd_plain_ms", "bwd_bound_ms", "bwd_library_ms",
                "bwd_library")})
        kernels.append(row)
    print(json.dumps({"cases": cases, "serving": served,
                      "pointnet_cases": pn_cases, "row15_step": pn_sums,
                      "pointnet_step": step,
                      "pointnet_step_widths": step_widths,
                      "pointnet_fit": fits, "voxel_cases": vox_cases,
                      "voxel_step": vox_step, "voxel_fit": vox_fitted,
                      "default_cases": def_cases, "default_serving":
                      def_served, "default_step": def_step,
                      "head_width_cases": head_widths,
                      "voxelize_sparse_site": row10_sparse,
                      "voxelize_uniform": row10_uniform,
                      "wide_devox_cases": wide_devox,
                      "wide_head": wide,
                      "default_fit": def_fitted, "sparse_cases": sp_cases,
                      "sparse_serving": sp_served,
                      "sparse_train_cases": spb_cases, "sparse_step": sp_step,
                      "sparse_fit": sp_fitted, "test_only_cases": to_cases,
                      "pointnet_serving": pn_served, "wgmma": wgmma,
                      "r128_step": r128, "r128_fit": r128_fitted,
                      "r256_step": r256, "files": files}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
