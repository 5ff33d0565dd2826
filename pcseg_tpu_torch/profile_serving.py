"""Where the serving time goes, on one CUDA card.

    python -m pcseg_tpu_torch.profile_serving [--model NAME] [--out DIR]

Builds the serving configurations of chip_smoke.py with seeded random
weights. ``--model voxel_unet3d`` (the default): the voxel U-Net 64^3,
w16, 3 levels, bf16, as ``default`` (every impl at "auto": fused conv
kernels, the one-hot voxelize_contract and trilinear_gather, the fused
grid2 head) and ``scatter_gather`` (fused conv kernels, scatter voxelize,
gather devoxelize, the plain head), in turn, on synthetic events.
``--model sparse_voxelnet``: the block-sparse SparseVoxelNet of the JAX
package's sparse bench (R64, w64, depth 4, 2 levels, tile 8, capacities
(64, 32), bf16) on track events. ``--model pointnet_seg``: PointNetSeg at
full width (4 classes, seeded random weights and running statistics)
served through ``Predictor`` BN-folded in f32 (the default), folded in
bf16 and unfolded, on synthetic events. For each, for a B8 x 8192 batch
and for one 1000-point event it reports:

- host-clock stage times (pad on the host, copy to the card, forward,
  copy back), each ended by a synchronize;
- device time by kernel from torch.profiler over one forward, the
  device's busy share of that forward's wall time, and device time by
  stage (``stage_of``: the conv kernels, the voxelize, head, gather and
  scatter kernels, the sparse block conv and LN kernels, for PointNet
  serving the library's matrix products, and the PyTorch glue around
  them).

With ``--out`` the profiler table is also written to DIR/profile_*.txt.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np
import torch

from pcseg_tpu_torch.data.batching import pad_events
from pcseg_tpu_torch.data.synthetic import synthetic_events, track_events
from pcseg_tpu_torch.infer import Predictor
from pcseg_tpu_torch.models.pointnet import PointNetSeg
from pcseg_tpu_torch.models.sparse_unet import SparseVoxelNet
from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d


def _stages(model, events, bucket, batch):
    """Host-clock ms of each serving stage (median of 5)."""
    rows = []
    for _ in range(5):
        t0 = time.perf_counter()
        pts, _, msk = pad_events(
            [(e, np.zeros(e.shape[0], np.int64)) for e in events], bucket,
            batch_size=batch)
        t1 = time.perf_counter()
        points = torch.from_numpy(pts).cuda()
        mask = torch.from_numpy(msk).cuda()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = model(points, mask)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.cpu()
        t4 = time.perf_counter()
        rows.append([t1 - t0, t2 - t1, t3 - t2, t4 - t3])
    med = np.median(np.asarray(rows) * 1e3, axis=0)
    return dict(zip(["pad_ms", "h2d_ms", "forward_ms", "d2h_ms"],
                    med.tolist())), (points, mask)


# kernel-name substring -> stage, first match wins; anything else is the
# PyTorch glue (elementwise ops, reductions, copies, Adam, the loss).
# PointNet training: row 16's wgmma kernels ("global_pool", its backward
# "global_pool_bwd"), row 15's chain kernels ("pointnet_block", its
# backward "pointnet_block_bwd"), row 17's classifier + CE forward and
# backward ("seg4_ce") and dropout; every key is a whole kernel name's
# stem, so none matches another kernel (row 19's pool_fwd_kernel, the
# voxel conv_kernel)
STAGES = (("gp_wgmma_fwd", "global_pool"),
          # the key decoder row 16 shares with row 19, which no path runs
          ("pool_finalize_kernel", "global_pool"),
          ("gp_cotangent", "global_pool_bwd"),
          ("gp_wgmma_dx", "global_pool_bwd"),
          ("gp_wgmma_dw", "global_pool_bwd"),
          ("chain_wgmma_fwd_kernel", "pointnet_block"),
          ("chain_simt_fwd_kernel", "pointnet_block"),
          ("chain_narrow_fwd_kernel", "pointnet_block"),
          ("chain_wide_fwd_kernel", "pointnet_block"),
          ("chain_wgmma_bwd_kernel", "pointnet_block_bwd"),
          ("chain_cotangent_kernel", "pointnet_block_bwd"),
          ("chain_wgmma_dx_kernel", "pointnet_block_bwd"),
          ("chain_wgmma_dw_kernel", "pointnet_block_bwd"),
          ("chain_simt_bwd_kernel", "pointnet_block_bwd"),
          ("chain_narrow_bwd_kernel", "pointnet_block_bwd"),
          ("chain_wide_bwd_kernel", "pointnet_block_bwd"),
          ("ce_seg4_fwd_kernel", "seg4_ce"), ("ce_seg4_bwd_kernel", "seg4_ce"),
          ("ce_seg4_bwd_mma_kernel", "seg4_ce"),
          ("ce_seg4_wide_fwd_kernel", "seg4_ce"),
          ("ce_seg4_wide_bwd_kernel", "seg4_ce"),
          ("dropout_kernel", "dropout"),
          ("head_fwd_kernel", "head"), ("head_fwd_stream_kernel", "head"),
          ("head_bwd_kernel", "head_bwd"),
          ("head_bwd_sum_kernel", "head_bwd"),
          ("voxelize_contract_kernel", "voxelize"),
          ("block_conv", "block_conv"),
          ("block_dgrad", "block_conv_dgrad"),
          ("block_wgrad", "block_conv_wgrad"),
          ("wgrad_reduce", "block_conv_wgrad"),
          ("bias_ln_relu_mask_kernel", "ln"),
          ("bias_ln_relu_mask_bwd", "ln_bwd"),
          ("ln_bwd_vec_kernel", "ln_bwd"), ("column_sum", "ln_bwd"),
          ("rowcol_scatter", "readout_bwd"),
          ("trilinear_gather_kernel", "devox_gather"),
          ("trilinear_scatter_bin_kernel", "devox_scatter"),
          ("trilinear_scatter_tile_kernel", "devox_scatter"),
          ("trilinear_scatter_long_kernel", "devox_scatter"),
          ("conv_kernel", "conv"), ("up_kernel", "conv"),
          ("wgrad_kernel", "conv"), ("conv3x3_mma_kernel", "conv"),
          ("down2x_mma_kernel", "conv"), ("up2x_mma_kernel", "conv"),
          ("up2x_bwd_mma_kernel", "conv"), ("down2x_bwd_mma_kernel", "conv"),
          ("dgrad_mma_kernel", "conv"), ("wgrad_mma_kernel", "conv"),
          ("fixed_sum_kernel", "conv"))

# PointNet serving only: the library's matrix-product kernel families
# (cuBLAS xmma, cuBLASLt nvjet and its split-K reduction, CUTLASS SIMT and
# tensor-op, gemv) as their own stage, kept out of the other breakdowns
# so that their "glue" means what it meant before
LIBRARY_PRODUCTS = tuple((key, "matmul") for key in (
    "xmma_gemm", "nvjet_", "splitKreduce_kernel", "cutlass_80_simt_sgemm",
    "cutlass_80_tensorop", "gemv"))


def stage_of(kernel_name: str, stages=STAGES) -> str:
    return next((st for key, st in stages if key in kernel_name), "glue")


def voxel_model(forms: str) -> VoxelUNet3d:
    """The 64^3/w16/L3 bf16 U-Net with its ``default`` forms or the
    explicit ``scatter_gather`` ones (fused conv kernels, scatter voxelize,
    gather devoxelize)."""
    explicit = {} if forms == "default" else dict(
        conv_impl="fused", voxelize_impl="scatter", devox_impl="gather")
    return VoxelUNet3d(
        num_classes=4, grid_size=64, width=16, levels=3,
        compute_dtype="bfloat16", generator=torch.Generator().manual_seed(0),
        **explicit)


def sparse_model() -> SparseVoxelNet:
    """The JAX package's sparse bench configuration (pcseg_tpu/bench.py
    :210-214)."""
    return SparseVoxelNet(
        num_classes=4, grid_size=64, width=64, depth=4, levels=2, tile=8,
        max_tiles=64, max_tiles_schedule=(64, 32), compute_dtype="bfloat16",
        generator=torch.Generator().manual_seed(0))


# Predictor's PointNetSeg serving modes: (fold, dtype)
POINTNET_MODES = {"folded_f32": (True, "float32"),
                  "folded_bf16": (True, "bfloat16"),
                  "unfolded": (False, "float32")}


def pointnet_model(num_classes: int = 4, seed: int = 0) -> PointNetSeg:
    """PointNetSeg at full width with seeded random weights, and BN scales,
    shifts and running statistics drawn from the same generator (a trained
    model's are not the init's 1 / 0 / 0 / 1)."""
    gen = torch.Generator().manual_seed(seed)
    model = PointNetSeg(num_classes=num_classes, generator=gen)
    with torch.no_grad():
        for name, group in model.batch_stats().items():
            c = group["mean"].shape[0]
            params = getattr(model, name)
            params.scale.copy_(0.5 + torch.rand(c, generator=gen))
            params.bias.copy_(0.1 * torch.randn(c, generator=gen))
            group["mean"].copy_(0.1 * torch.randn(c, generator=gen))
            group["var"].copy_(0.5 + torch.rand(c, generator=gen))
    return model


def pointnet_predictor(mode: str, model: PointNetSeg | None = None,
                       device=None) -> Predictor:
    """``model`` (default ``pointnet_model()``) served by Predictor in one
    of POINTNET_MODES."""
    model = model or pointnet_model()
    fold, dtype = POINTNET_MODES[mode]
    return Predictor(model.state_dict(), model.num_classes, fold=fold,
                     dtype=dtype, device=device)


def device_profile(fn, stages=STAGES):
    """Profile one warm call of ``fn``: wall ms, device-busy ms, idle
    share and device time by kernel name and by ``stages``, and the
    profiler itself."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a CPU op's self device time repeats its kernels', and
    # so does a named stage's range on the device (utils/observe.py)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    kernels = [{"name": e.key[:90], "calls": e.count,
                "device_ms": e.self_device_time_total / 1e3}
               for e in events]
    by_stage: dict = {}
    for e in events:
        st = stage_of(e.key, stages)
        by_stage[st] = by_stage.get(st, 0.0) + e.self_device_time_total / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "by_stage_ms": by_stage, "kernels": kernels}, prof


def profile_calls(fn, iters: int = 10, attempts: int = 3) -> dict:
    """Device ms per call of ``fn`` of each kernel it launches, by name,
    from torch.profiler over ``iters`` warm calls. Late in a long process
    the profiler records only some launches, or none, so ``fn`` is
    profiled again (up to ``attempts`` times) while a kernel's recorded
    launches are not a whole multiple of ``iters``; a kernel's time per
    call is then its mean time per recorded launch (from the attempt that
    recorded most of it) times its launches per call (recorded launches
    over ``iters``, rounded up, the most any attempt saw). A complete
    profile gives its device time over ``iters``."""
    seen: dict = {}  # name -> (launches, mean ms a launch, launches a call)
    for _ in range(attempts):
        res, _ = device_profile(lambda: [fn() for _ in range(iters)])
        rec: dict = {}
        for k in res["kernels"]:
            ms, calls = rec.get(k["name"], (0.0, 0))
            rec[k["name"]] = (ms + k["device_ms"], calls + k["calls"])
        for name, (ms, calls) in rec.items():
            best, mean, per = seen.get(name, (0, 0.0, 0))
            if calls > best:
                best, mean = calls, ms / calls
            seen[name] = (best, mean, max(per, -(-calls // iters)))
        if rec and all(calls % iters == 0 for _, calls in rec.values()):
            break
    return {name: mean * per for name, (_, mean, per) in seen.items()}


def kernel_ms(fn, pattern: str, iters: int = 10) -> dict:
    """Device ms per call of ``fn`` of the kernels whose names match
    ``pattern``, keyed by its first group (the profilers of rows 15-17 and
    16); ``profile_calls`` keeps launches the profiler drops from reading
    as faster kernels."""
    out: dict = {}
    for name, ms in profile_calls(fn, iters).items():
        m = re.search(pattern, name)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + ms
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="voxel_unet3d",
                    choices=("voxel_unet3d", "sparse_voxelnet",
                             "pointnet_seg"))
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.model == "sparse_voxelnet":
        batch = list(track_events(8, 8192, 0))
        single = [track_events(1, 1000, 1)[0]]
        models = {"sparse": lambda: sparse_model().cuda().eval()}
    else:
        batch = [p for p, _ in synthetic_events(8, min_points=4000,
                                                max_points=8192, seed=0)]
        single = [next(iter(synthetic_events(1, min_points=1000,
                                             max_points=1000, seed=1)))[0]]
    if args.model == "voxel_unet3d":
        models = {form: lambda form=form: voxel_model(form).cuda().eval()
                  for form in ("default", "scatter_gather")}
    elif args.model == "pointnet_seg":
        models = {mode: lambda mode=mode: pointnet_predictor(
            mode).device_forward for mode in POINTNET_MODES}
    kernel_stages = STAGES + LIBRARY_PRODUCTS \
        if args.model == "pointnet_seg" else STAGES
    card = torch.cuda.get_device_name(0)
    report = {"card": card, "model": args.model}
    for form, make in models.items():
        model = make()
        if form in POINTNET_MODES:
            forms = dict(zip(("fold", "dtype"), POINTNET_MODES[form]))
        elif hasattr(model, "resolve_forms"):
            forms = model.resolve_forms()
        else:
            forms = {"impl": model.impl}
        for label, events, bucket, b in (("batch8x8192", batch, 8192, 8),
                                         ("single1000", single, 1024, 1)):
            name = f"{form}_{label}"
            stages, (points, mask) = _stages(model, events, bucket, b)
            prof_res, prof = device_profile(lambda: model(points, mask),
                                            kernel_stages)
            report[name] = {"forms": forms, "stages": stages, **prof_res}
            print(f"[{name}] {card}: stages {json.dumps(stages)}")
            print(f"  one forward: wall {prof_res['wall_ms']:.3f} ms, device "
                  f"busy {prof_res['device_busy_ms']:.3f} ms, idle share "
                  f"{prof_res['idle_share']:.3f}; by stage "
                  f"{json.dumps(prof_res['by_stage_ms'])}")
            for k in prof_res["kernels"][:15]:
                print(f"  {k['device_ms']:9.4f} ms  x{k['calls']:<4d} "
                      f"{k['name']}")
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                with open(os.path.join(args.out, f"profile_{name}.txt"),
                          "w") as f:
                    f.write(prof.key_averages().table(
                        sort_by="self_device_time_total", row_limit=60))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
