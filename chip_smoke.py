#!/usr/bin/env python3
"""Drive the pcseg_tpu_torch port on one CUDA card and check it.

    python3 chip_smoke.py

1. Builds the CUDA kernels from pcseg_tpu_torch/csrc/ (nvcc, sm_90a, one
   process per source, all at once), then prints ptxas's registers, shared
   memory and spills of the wgmma libraries (pointnet_wgmma.cu, row 16;
   pointnet_chain.cu, rows 15 and 17) and the HGMMA instructions in each
   of their wgmma kernels' SASS (cuobjdump), failing if one has none.
2. Holds each conv kernel against its plain PyTorch version at every
   shape the voxel serving path launches (batch 8, 64^3 grid, widths
   16/32/64), and times kernel, plain version and one cuDNN call of the
   same convolution (a yardstick only: the port never calls it).
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
   pool block at 1000 rows a batch row. Rows 15-17 print each kernel's
   device time beside
   the op's CUDA-event time, and row 15 its sums over the 8 launches of
   a step.
5. One whole fused PointNetSeg train step (full width, 4 classes,
   dropout 0.3, seeded random weights) with the kernels and with the
   plain versions, from the same state and seeds: loss, gradients and
   new batch_stats.
6. Trains PointNetSeg through api.fit on synthetic events (bucket 2048,
   batch 64, 4 train steps and one eval batch per epoch, 2 epochs), with
   bn_stats="fused" and "exact": launch counts per step, finite losses,
   ms per step, points/s, peak memory.
7. Holds each voxel U-Net backward kernel (the 3^3 dgrad and wgrad, the
   down and up backward, the trilinear scatter of the devoxelize VJP)
   against its plain version at every shape one B8 x 8192 train step at
   64^3/w16/L3 launches, and times kernel, plain version, bound and one
   PyTorch call of the same function (cuDNN's convolution_backward,
   index_add_; yardsticks only).
8. One whole voxel U-Net train step (seeded random weights, one batch of
   synthetic events) with the kernels, with the plain versions, and in f32
   on the plain core: loss and gradients.
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
   (index_add_, grid_sample, bf16 matmuls; yardsticks only).
11. Serves the default configuration as phase 3 serves the scatter/gather
   one: launch counts per forward, logits against the plain versions.
12. One default-configuration train step with the kernels, with the plain
   versions and in f32, held as phase 8; then api.fit with no impl
   override and Predictor on its checkpoint, held as phase 9.
13. Holds the sparse family's two kernels (the raw block conv and the
   fused conv-bias + LayerNorm + ReLU + mask) against their plain versions
   at every serving shape of the JAX package's sparse bench configuration
   (SparseVoxelNet R64, width 64, depth 4, 2 levels, tile 8, tile
   capacities (64, 32), bf16, on B8 x 8192 track events) and at width 16
   in f32, and times kernel, plain version, bound and one PyTorch call of
   the same function (cuDNN's conv3d on the materialized halo,
   F.layer_norm; yardsticks only).
14. Serves that model (seeded random weights) through Predictor as phase 3
   serves the voxel U-Net: 8 / 10 / 1 block_conv / bias_ln_relu_mask /
   voxelize_contract launches per forward, no dropped tile, logits
   against the plain versions.
15. Holds the sparse family's training kernels (the LN backward, the block
   conv's dgrad and wgrad, rowcol_scatter) against their plain versions at
   every shape one B8 x 8192 train step of that configuration launches,
   and every kernel of the family, forward and backward, at the shapes its
   repair opened (LN at 256 and 24 channels, the conv at widths 8 and 24
   and at tile 16); times kernel, plain version, bound and one PyTorch call
   of the same function (cuDNN's convolution_backward on the materialized
   halo, native_layer_norm_backward, index_add_; yardsticks only).
16. One whole sparse train step (forward, loss, backward, Adam) with the
   kernels, with the plain versions and in f32: loss, every gradient and
   every Adam update.
17. Trains that model through api.fit (bucket 8192, batch 8, 3 train steps
   and one eval batch per epoch, 2 epochs, track events): launch counts
   per step (8 / 7 / 8 / 10 / 10 / 1 / 1 block_conv / dgrad / wgrad / LN /
   LN backward / voxelize_contract / rowcol_scatter), finite losses, no
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
20. Prints the kernels as one JSON line, the card's name and power limit,
   and as the last line {"ok": true, "device": {...}}.

Exits non-zero, without the last line, when there is no CUDA device or
any phase fails.

    python3 chip_smoke.py --step-spread N

builds the kernels, repeats only the whole-step comparisons of phases 8,
12 and 16 N times, and prints each loss reading as one JSON line: the
spread their loss limits are set from. It holds nothing and prints no
result.

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
PER_FORWARD = {"conv3x3_gn_act": 13, "down2x_gn_act": 2, "up2x_gn_act": 2}
# the default configuration (voxelize_impl / devox_impl "auto" -> the
# one-hot forms at 64^3) adds the voxelizer, the fused head and the gather
DEFAULT_PER_FORWARD = dict(PER_FORWARD, voxelize_contract=1, head_grid2=1,
                           trilinear_gather=1)
# tolerances, kernel vs plain version on identical inputs:
# y is bf16 from f32 sums taken in another order, so an element may round
# to the neighbouring bf16 value: |dy| <= 2^-7 |y| + 1e-4 max|y|.
Y_RTOL, Y_ATOL_REL = 2.0 ** -7, 1e-4
# stats are f32 sums of 10^5-10^6 terms in another order (and with
# atomics): |ds| <= 1e-3 of the largest |s| of its (batch, sum|sumsq) row.
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


# the wgmma kernels of rows 16 and 15, by source
WGMMA_SOURCES = {
    "pointnet_wgmma": ("gp_wgmma_fwd_kernel", "gp_wgmma_dx_kernel",
                       "gp_wgmma_dw_kernel"),
    "pointnet_chain": ("chain_wgmma_fwd_kernel", "chain_wgmma_bwd_kernel",
                       "chain_wgmma_dx_kernel", "chain_wgmma_dw_kernel"),
}


def wgmma_report() -> dict:
    """Phase 1's look at the wgmma libraries: ptxas's registers, shared
    memory and spills of each kernel of each source (-Xptxas -v on a
    cubin of the same source and flags) and, where cuobjdump is present,
    the HGMMA instructions in each wgmma kernel's SASS; fails if one has
    none."""
    import shutil
    from pathlib import Path

    from pcseg_tpu_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    tool = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    out = {}
    for name, kernels in WGMMA_SOURCES.items():
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
            print("  cuobjdump not found: HGMMA count not taken", flush=True)
            out[name] = {"ptxas": lines, "hgmma": None}
            continue
        sass = subprocess.run([tool, "-sass", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout
        hgmma = dict.fromkeys(kernels, 0)
        current = None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                current = next((k for k in kernels if k in m.group(1)), None)
            elif current and "HGMMA" in ln:
                hgmma[current] += 1
        print(f"  HGMMA instructions in {name}'s SASS: {json.dumps(hgmma)}",
              flush=True)
        if not all(hgmma.values()):
            raise AssertionError(f"a wgmma kernel of {name} has no HGMMA: "
                                 f"{hgmma}")
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

    y_k, st_k = run()
    torch.cuda.synchronize()
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
        "bytes": nbytes, "flops": flops,
    }
    ok = y_ok and st_ok
    print(f"  {'ok ' if ok else 'BAD'} {kernel:15s} {res['shape']:22s} "
          f"{label:10s} y max|err| {y_err:.3e} (rel {res['max_rel_err']:.2e})"
          f"  stats rel {st_err:.2e}  kernel {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  cuDNN {library_ms:.4f} ms  bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']})", flush=True)
    if not ok:
        raise AssertionError(
            f"{kernel} {label} {res['shape']}: kernel disagrees with its "
            f"plain version (y err {y_err}, stats rel err {st_err})")
    return res


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


def pn_ce_case(gen):
    import torch

    from pcseg_tpu_torch.ops import fused_ce as fc

    n, cin, c = PN_B * PN_M, 128, PN_CLASSES
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
        "name": "fused_seg4_ce", "case": "seg4+CE",
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
    cases += [pn_global_case(gen),
              pn_global_case(gen, 64, 1000, "ragged M1000"),
              pn_ce_case(gen)]
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


def pn_batch(seed: int):
    """One B64 x 2048 batch of synthetic events (1100-2048 points)."""
    import numpy as np

    from pcseg_tpu_torch.data.batching import pad_events
    from pcseg_tpu_torch.data.class_stats import scan_classes
    from pcseg_tpu_torch.data.synthetic import synthetic_events

    events = list(synthetic_events(PN_B, min_points=1100, max_points=PN_M,
                                   seed=seed))
    cw = scan_classes(events).weights
    return pad_events(events, PN_M, batch_size=PN_B), np.asarray(cw)


def pn_step_compare(card):
    """One fused train step with the kernels and with the plain versions,
    from the same weights, batch and dropout seeds, and the same step in
    f32 on plain layers as the yardstick of the chain's own rounding."""
    import torch

    from pcseg_tpu_torch.models.pointnet import PointNetSeg, pointnet_apply
    from pcseg_tpu_torch.ops.losses import cross_entropy_sums

    (pts, labels, _), cw = pn_batch(5)
    points = torch.from_numpy(pts).cuda()
    labels = torch.from_numpy(labels).cuda()
    cw = torch.from_numpy(cw).cuda()
    model = PointNetSeg(PN_CLASSES, dropout=PN_DROP, bn_stats="fused",
                        compute_dtype="bfloat16",
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

    lk, bnk = step(False)
    gk = grads()
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
           "fwd_bwd_ms_f32_plain_layers": ms_f, "card": card}
    print(f"  loss kernels {float(lk):.6f} plain {float(lp):.6f} (rel "
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


def pn_fit(card, bn_stats, events):
    """The main path: api.fit on the card. Returns (launches, result)."""
    import math

    import torch

    from pcseg_tpu_torch import api
    from pcseg_tpu_torch.ops import dropout as dr
    from pcseg_tpu_torch.ops import fused_block as fb
    from pcseg_tpu_torch.ops import fused_ce as fc
    from pcseg_tpu_torch.ops import fused_global as fg

    mods = (fb, fg, fc, dr)
    overrides = [f"model.bn_stats={bn_stats}", "model.compute_dtype=bfloat16",
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
        raise AssertionError(f"fit {bn_stats}: launch counts {launches} != "
                             f"{expected}")
    losses = [h[k] for h in res.history for k in ("train_loss", "val_loss")]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"fit {bn_stats}: non-finite loss {losses}")
    warm = res.history[-1]
    ms_step = warm["train_seconds"] * 1e3 / warm["train_steps"]
    out = {
        "bn_stats": bn_stats, "steps": steps, "launches": launches,
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
    print(f"  fit bn_stats={bn_stats} [{card}]: {steps} train steps at "
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
VOX_PER_STEP = {"conv3x3_gn_act": 13, "down2x_gn_act": 2, "up2x_gn_act": 2,
                "conv3x3_dgrad": 12, "conv3x3_wgrad": 13, "down2x_bwd": 2,
                "up2x_bwd": 2, "trilinear_scatter": 1}
# the default configuration's step adds the one-hot forward kernels and
# the fused head forward and backward
DEFAULT_PER_STEP = dict(VOX_PER_STEP, voxelize_contract=1, head_grid2=1,
                        trilinear_gather=1, head_grid2_bwd=1)
# whole step, kernels vs plain versions: loss 1e-4 relative; the conv
# kernels' gradient vector at cosine >= 0.998; each gradient's relative L2
# within 3x the plain bf16 chain's own distance from the same step in f32
# (the train-mode GroupNorm backward amplifies one-ulp bf16 flips, as the
# BN backward does in phase 5), except the conv biases that a GroupNorm
# follows, whose gradient is 0 up to rounding (reported, not held)
VOX_LOSS_REL, VOX_KERNEL_COS, VOX_GRAD_RATIO = 1e-4, 0.998, 3.0
# the default configuration's logits are bf16 (the fused head's grid2), so
# a one-ulp flip of a voxel logit moves the loss: 7.6e-5 to 2.5e-4
# relative over ten runs on one H100 (the stats atomics' order moves it
# from run to run), held to 3x the largest
DEFAULT_LOSS_REL = 7.5e-4


def vox_bwd_cases():
    """(kernel, label, r, cin, cout, kwargs) at every shape the backward
    of one train step launches: the 3^3 blocks at each level (the accum
    and stats-free y1 halves of the decoder at levels 0 and 1, the stem at
    level 0), the two down and the two up blocks."""
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
    return cases


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
             else ""), flush=True)
    return res


def vox_conv3x3_case(label, r, cin, cout, kw, gen):
    """dgrad and wgrad of one 3^3 block at one shape: two result rows
    (the stem, whose input is data, launches no dgrad: one row)."""
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
    if activate:
        dargs = (gy, y, gstats, x, w, scale, shift, activate, want_gadj)
        dk = cb.conv3x3_dgrad_cuda(*dargs)
        torch.cuda.synchronize()
        dp = cb.conv3x3_dgrad_plain(*dargs)
        checks = {"dx": _bf16_check(dk[0], dp[0]),
                  "dscale/dshift": _sum_check(dk[1], dp[1])}
        if want_gadj:
            checks["g'"] = (float((dk[2].float() - dp[2].float()).abs()
                                  .max()), bool(torch.equal(dk[2], dp[2])))
        res = {
            "name": "conv3x3_dgrad", "case": label, "shape": shape,
            "max_abs_err": _held(f"conv3x3_dgrad {label} {shape}", checks),
            "ms": time_ms(lambda: cb.conv3x3_dgrad_cuda(*dargs)),
            "plain_ms": time_ms(lambda: cb.conv3x3_dgrad_plain(*dargs),
                                iters=3),
            "library_ms": time_ms(lambda: _library_bwd(
                gy, x, wl, 1, 1, False, [True, False, False])),
        }
        nbytes = (cot + n * cin * 2 * 2 + 27 * cin * cout * 2 + vec
                  + 2 * VOX_B * cin * 4 + (n * cout * 2 if want_gadj else 0))
        res["bound_ms"], res["bound_by"] = _bound(nbytes, flops)
        rows.append(_vox_report(res))
    wargs = (x, scale, shift, gy, y, gstats, activate)
    wk = cb.conv3x3_wgrad_cuda(*wargs)
    torch.cuda.synchronize()
    wp = cb.conv3x3_wgrad_plain(*wargs)
    checks = {"dW": _sum_check(wk[0], wp[0]), "dbias": _sum_check(wk[1],
                                                                 wp[1])}
    res = {
        "name": "conv3x3_wgrad", "case": label, "shape": shape,
        "max_abs_err": _held(f"conv3x3_wgrad {label} {shape}", checks),
        "ms": time_ms(lambda: cb.conv3x3_wgrad_cuda(*wargs)),
        "plain_ms": time_ms(lambda: cb.conv3x3_wgrad_plain(*wargs), iters=3),
        "library_ms": time_ms(lambda: _library_bwd(
            gy, x, wl, 1, 1, False, [False, True, True])),
    }
    nbytes = cot + n * cin * 2 + vec + 27 * cin * cout * 4 + cout * 4
    res["bound_ms"], res["bound_by"] = _bound(nbytes, flops)
    rows.append(_vox_report(res))
    return rows


def vox_resample_case(name, r, cin, cout, gen):
    import torch

    from pcseg_tpu_torch.ops import conv3d_block as cb

    up = name == "up2x_bwd"
    x, w, bias, scale, shift = _vox_inputs(gen, r, cin, cout, 2)
    fwd = cb.up2x_gn_act_cuda if up else cb.down2x_gn_act_cuda
    y, _ = fwd(x, w, bias, scale, shift)
    gy, gstats = _vox_cotangents(gen, y.shape)
    args = (x, w, scale, shift, gy, y, gstats)
    kern = getattr(cb, f"{name}_cuda")
    plain = getattr(cb, f"{name}_plain")
    gk = kern(*args)
    torch.cuda.synchronize()
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
    res = {
        "name": name, "case": "act", "shape": shape,
        "max_abs_err": _held(f"{name} {shape}", checks),
        "ms": time_ms(lambda: kern(*args)),
        "plain_ms": time_ms(lambda: plain(*args), iters=3),
        "library_ms": time_ms(lambda: _library_bwd(
            gy, x, wl, 2, 0, up, [True, True, True])),
    }
    n_in, n_out = VOX_B * r ** 3, VOX_B * ro ** 3
    nbytes = (n_in * cin * 2 * 2 + n_out * cout * 2 * 2 + 8 * cin * cout * 2
              + 4 * VOX_B * cin * 4 + VOX_B * 2 * cout * 4
              + 2 * VOX_B * cin * 4 + 8 * cin * cout * 4 + cout * 4)
    # dgrad and wgrad: each one product over the 8 taps of every pair
    flops = 2 * 2 * max(n_in, n_out) * cin * cout
    res["bound_ms"], res["bound_by"] = _bound(nbytes, flops)
    return _vox_report(res)


def vox_scatter_case(gen):
    import torch

    from pcseg_tpu_torch.ops import voxel as vx

    b, m, r, c = VOX_B, VOX_M, VOX_R, VOX_CLASSES
    # continuous voxel coords over the event box, 3/4 of the points real
    u = torch.rand((b, m, 3), generator=gen, device="cuda") * r - 0.5
    valid = torch.rand((b, m), generator=gen, device="cuda") < 0.75
    go = torch.randn((b, m, c), generator=gen, device="cuda") * 1e-3
    go = torch.where(valid[..., None], go, 0.0)
    k = vx.trilinear_scatter(u, go, r)
    torch.cuda.synchronize()
    p = vx.trilinear_scatter_plain(u, go, r)
    err = _held("trilinear_scatter", {"dgrid": _sum_check(k, p)})
    rows, vals = vx.trilinear_scatter_taps(u, go, r)
    rows, vals = rows.reshape(-1), vals.reshape(-1, c)
    out = torch.zeros((b * r ** 3, c), device="cuda")
    res = {
        "name": "trilinear_scatter", "case": "devox bwd",
        "shape": f"B{b} M{m} R{r} C{c}", "max_abs_err": err,
        "ms": time_ms(lambda: vx.trilinear_scatter(u, go, r)),
        "plain_ms": time_ms(lambda: vx.trilinear_scatter_plain(u, go, r),
                            iters=3),
        # one index_add_ of the precomputed 8 B M weighted tap rows
        "library_ms": time_ms(lambda: out.index_add_(0, rows, vals)),
    }
    # read u and go once, write the f32 grid once; 8 taps x C products
    # of each real point
    n_real = int(valid.sum())
    res["bound_ms"], res["bound_by"] = _bound(
        b * m * 3 * 4 + b * m * c * 4 + b * r ** 3 * c * 4,
        2 * 8 * c * n_real)
    return _vox_report(res)


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

    lk = step(model, False)
    gk = grads(model)
    lp = step(model, True)
    gp = grads(model)
    lf = step(model32, True)
    gf = grads(model32)
    torch.cuda.synchronize()
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
    loss_tol = DEFAULT_LOSS_REL if default else VOX_LOSS_REL
    ok = (loss_rel <= loss_tol and kcos >= VOX_KERNEL_COS
          and ratio[worst] <= VOX_GRAD_RATIO
          and all(torch.isfinite(g).all() for g in gk.values()))
    ms_k = time_ms(lambda: step(model, False), iters=3)
    ms_p = time_ms(lambda: step(model, True), iters=3)
    ms_f = time_ms(lambda: step(model32, True), iters=3)
    res = {"forms": forms, "loss_kernels": float(lk),
           "loss_plain": float(lp),
           "loss_f32": float(lf), "loss_rel_err": loss_rel,
           "loss_tol": loss_tol,
           "kernel_grad_cosine": kcos,
           "grad_rel_err_kernels_vs_plain": rel,
           "grad_rel_err_plain_vs_f32": own, "grad_ratio": ratio,
           "grad_ratio_max": ratio[worst], "grad_worst": worst,
           "grad_rel_err_max_held": max(rel[n] for n in ratio),
           "grad_rel_err_plain_vs_f32_max_held": max(own[n] for n in ratio),
           "zero_grad_bias_rel_err_max": max(rel[n] for n in zero),
           "fwd_bwd_ms_kernels": ms_k, "fwd_bwd_ms_plain": ms_p,
           "fwd_bwd_ms_f32_plain_core": ms_f, "card": card}
    print(f"  forms {forms}: loss kernels {float(lk):.6f} plain "
          f"{float(lp):.6f} (rel "
          f"{loss_rel:.2e}, tol {loss_tol:.2e}), f32 {float(lf):.6f}; "
          f"conv-kernel gradient cosine {kcos:.6f} (tol {VOX_KERNEL_COS}); "
          f"gradients kernels vs plain <= {res['grad_rel_err_max_held']:.3e}"
          f" (rel L2), plain vs f32 <= "
          f"{res['grad_rel_err_plain_vs_f32_max_held']:.3e}; worst ratio "
          f"{ratio[worst]:.3f} at {worst} (tol {VOX_GRAD_RATIO}); fwd+bwd "
          f"{ms_k:.2f} ms with kernels, {ms_p:.2f} ms plain, {ms_f:.2f} ms "
          f"f32 plain core [{card}]", flush=True)
    if hold and not ok:
        raise AssertionError(f"voxel train step: kernels disagree with the "
                             f"plain versions: {res}")
    return res


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


def default_voxelize_case(points, mask):
    import torch

    from pcseg_tpu_torch.ops import voxel as vx

    b, m, r = VOX_B, VOX_M, VOX_R
    r3 = r ** 3
    flat, ext, _, _ = vx.voxel_rows(points, mask, r)
    c1 = ext.shape[-1]
    k = vx.voxelize_contract(flat, ext, r)
    torch.cuda.synchronize()
    p = vx.voxelize_contract_plain(flat, ext, r)
    zyx = (flat // (r * r), flat // r % r, flat % r)
    faces = int((mask & torch.stack([(a == 0) | (a == r - 1) for a in zyx])
                 .any(0)).sum())
    hot = int(p[..., -1].max())
    dcnt = float((k[..., -1] - p[..., -1]).abs().max())
    checks = {"sums": _onehot_check(k, p), "counts": (dcnt, dcnt == 0.0),
              "dummy row": (float(k[-1].abs().max()), not k[-1].any()),
              "edge cases": (0.0, faces > 0 and hot >= 2000)}
    err = _held("voxelize_contract", checks)
    rows = (flat + torch.arange(b, device="cuda")[:, None] * (r3 + 1)
            ).reshape(-1)
    vals = ext.to(torch.bfloat16).float().reshape(-1, c1)
    out = torch.zeros((b * (r3 + 1), c1), device="cuda")
    n_real = int(mask.sum())
    res = {
        "name": "voxelize_contract", "case": "voxelize",
        "shape": f"B{b} M{m} -> {r}^3x{c1}", "max_abs_err": err,
        "points_on_faces": faces, "hot_voxel_points": hot,
        "ms": device_ms(lambda: vx.voxelize_contract(flat, ext, r)),
        "wrapper_ms": time_ms(lambda: vx.voxelize_contract(flat, ext, r)),
        "plain_ms": device_ms(
            lambda: vx.voxelize_contract_plain(flat, ext, r)),
        # one index_add_ of the bf16-rounded rows at the same ids
        "library_ms": device_ms(lambda: out.index_add_(0, rows, vals)),
    }
    # ids and rows read once, the f32 grid written once; C1 adds a point
    res["bound_ms"], res["bound_by"] = _bound(
        b * m * 4 + b * m * c1 * 4 + b * r3 * c1 * 4, n_real * c1,
        F32_FLOP_PER_S)
    return _vox_report(res)


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


def default_head_cases(gen):
    """The fused head forward and backward at 64^3 x 16 -> 4: two rows."""
    import torch

    from pcseg_tpu_torch.ops import conv3d_block as cb

    c, nc = VOX_W, VOX_CLASSES
    x, w, bias, scale, shift = _vox_inputs(gen, VOX_R, c, nc, 1)
    n = x.numel() // c
    shape = f"B{VOX_B} {VOX_R}^3x{c}->{nc}"
    fwd = (x, w, bias, scale, shift)
    yk = cb.head_grid2_cuda(*fwd)
    torch.cuda.synchronize()
    err = _held("head_grid2", {"y": _bf16_check(yk, cb.head_grid2_plain(
        *fwd))})
    gy = torch.randn(yk.shape, generator=gen, device="cuda").to(torch.bfloat16)
    bwd = (x, gy, w, scale, shift)
    gk = cb.head_grid2_bwd_cuda(*bwd)
    torch.cuda.synchronize()
    gp = cb.head_grid2_bwd_plain(*bwd)
    checks = {"dx": _bf16_check(gk[0], gp[0])}
    for name, a, r in zip(("dscale/dshift", "dW", "dbias"), gk[1:], gp[1:]):
        checks[name] = _sum_check(a, r)
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
# included; an LN after each, after the down conv and after the up conv
SP_PER_FORWARD = {"block_conv": 8, "bias_ln_relu_mask": 10,
                  "voxelize_contract": 1}
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
                   bias_ln_relu_mask_bwd=10, rowcol_scatter=1)
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


def sp_conv_case(kind, bs, label, cin, cout, dtype, gen):
    """``kind`` "fwd", "dgrad" or "wgrad" of the raw block conv on the
    tiles ``bs``: kernel vs plain version, times, bound and the cuDNN
    call of the same conv on the materialized halo (``convolution`` or
    ``convolution_backward`` for the input or weight gradient)."""
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
    k = run()
    torch.cuda.synchronize()
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
        "ms": time_ms(run), "plain_ms": time_ms(plain),
        "library_ms": time_ms(library),
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
        k = fl.bias_ln_relu_mask_bwd(*args)
        torch.cuda.synchronize()
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
        name = "bias_ln_relu_mask_bwd"
        keys = ("bias_ln_relu_mask_bwd", "column_sum")
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
        return {n: float((a[n] - b[n]).norm())
                / max(float((b[n] - f[n]).norm()), 1e-30) for n in b}

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
            for field in ("loss_rel_err", "grad_ratio_max",
                          "kernel_grad_cosine", "update_ratio_max"):
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

    print(f"[6] api.fit on the card [{card}]", flush=True)
    from pcseg_tpu_torch.data.synthetic import synthetic_events

    events = list(synthetic_events(5 * PN_B, min_points=1100,
                                   max_points=PN_M, seed=3))
    fit_launches, fits = {}, {}
    for bn_stats in ("fused", "exact"):
        got, fits[bn_stats] = pn_fit(card, bn_stats, events)
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
            vox_cases.append(vox_resample_case(kind, r, cin, cout, gen))
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
    def_cases += default_head_cases(gen)
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

    main_case = {
        "conv3x3_gn_act": ("act", "B8 64^3x16->64^3x16"),
        "down2x_gn_act": ("act", "B8 64^3x16->32^3x32"),
        "up2x_gn_act": ("act", "B8 32^3x32->64^3x16"),
    }
    kernels = []
    for name, (label, shape) in main_case.items():
        mine = [c for c in cases if c["name"] == name]
        at = next(c for c in mine if c["case"] == label and c["shape"] == shape)
        by_path = {"serving": launches[name],
                   "voxel_fit": vox_launches[name],
                   "voxel_fit_serving": vox_serve[name],
                   "default_serving": def_launches[name],
                   "default_fit": def_fit_launches[name],
                   "default_fit_serving": def_fit_serve[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "shape": shape,
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
        by_path = {"voxel_fit": vox_launches[name],
                   "default_fit": def_fit_launches[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": TRI_SOURCE if name == "trilinear_scatter" else SOURCE,
            "replaces": VOX_REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "shape": shape,
        })
    # default-configuration rows: numbers at the B8 x 8192, 64^3 shapes of
    # phase 10; launches from phases 11 and 12
    for at in def_cases:
        name = at["name"]
        by_path = {"default_serving": def_launches[name],
                   "default_fit": def_fit_launches[name],
                   "default_fit_serving": def_fit_serve[name]}
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
    # PointNet rows: forward numbers at each kernel's largest shape, the
    # backward's beside them; launches are forward + backward on the main
    # path (both api.fit runs)
    pn_main = {"fused_block": "conv5", "fused_global_pool_block":
               "global_feat", "fused_seg4_ce": "seg4+CE",
               "dropout": "seg1 out"}
    for name, label in pn_main.items():
        mine = [c for c in pn_cases if c["name"] == name]
        at = next(c for c in mine if c["case"] == label)
        kernels.append({
            "name": name, "route": "cuda",
            "source": PN_SOURCES[name],
            "replaces": PN_REPLACES[name],
            "launches": fit_launches[name] + fit_launches.get(
                f"{name}_bwd", 0),
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
             "pointnet_serving": pns_launches}
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
                      "pointnet_fit": fits, "voxel_cases": vox_cases,
                      "voxel_step": vox_step, "voxel_fit": vox_fitted,
                      "default_cases": def_cases, "default_serving":
                      def_served, "default_step": def_step,
                      "default_fit": def_fitted, "sparse_cases": sp_cases,
                      "sparse_serving": sp_served,
                      "sparse_train_cases": spb_cases, "sparse_step": sp_step,
                      "sparse_fit": sp_fitted, "test_only_cases": to_cases,
                      "pointnet_serving": pn_served, "wgmma": wgmma}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
