"""Where the training time goes, on one CUDA card.

    python -m pcseg_tpu_torch.profile_training [--model MODEL] [--out DIR]

``--model pointnet_seg`` (the default) builds the PointNetSeg training
configuration of chip_smoke.py (full width, 4 classes, dropout 0.3, bf16,
seeded random weights, Adam) and, for ``bn_stats`` "fused" and "exact",
one B64 x 2048 batch of synthetic events (1100-2048 points each).
``--model voxel_unet3d`` builds the voxel U-Net training configurations
of chip_smoke.py (64^3, width 16, 3 levels, 4 classes, bf16, seeded
random weights, Adam): ``voxel_default`` (every impl at "auto": fused conv
kernels, the one-hot voxelize_contract and trilinear_gather, the fused
grid2 head) and ``voxel_scatter_gather`` (fused conv kernels, scatter
voxelize, gather devoxelize), and one B8 x 8192 batch of synthetic events
(4000-8192 points each). ``--model sparse_voxelnet`` builds the JAX
package's sparse bench step (pcseg_tpu/bench.py:195-244: SparseVoxelNet
R64, w64, depth 4, 2 levels, tile 8, capacities (64, 32), bf16, seeded
random weights, Adam, unit class weights) on one B8 x 8192 batch of track
events with labels drawn by numpy, as the bench draws them. For each it
reports:

- host-clock stage times of a train step (pad on the host, copy to the
  card, ``train_step``), each ended by a synchronize, median of 5 after 3
  warm steps;
- device time by kernel from torch.profiler over one train step, the
  device's busy share of that step's wall time, and device time by stage
  (``profile_serving.stage_of``; for the sparse step: the conv forward,
  its dgrad and wgrad, the LN forward and backward, the readout's
  backward, the voxelizer and the PyTorch glue; for PointNetSeg: row 16's
  wgmma kernels forward and backward, row 15's chain kernels forward
  ("pointnet_block") and backward ("pointnet_block_bwd"), row 17's
  classifier + CE forward and backward ("seg4_ce"), dropout and the
  glue).

With ``--out`` the profiler tables are also written to
DIR/profile_train_*.txt.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from pcseg_tpu_torch.data.batching import pad_events
from pcseg_tpu_torch.data.class_stats import scan_classes
from pcseg_tpu_torch.data.synthetic import synthetic_events, track_events
from pcseg_tpu_torch.models.pointnet import PointNetSeg
from pcseg_tpu_torch.profile_serving import (
    device_profile,
    sparse_model,
    voxel_model,
)
from pcseg_tpu_torch.train.steps import create_train_state, train_step

CLASSES = 4
# (batch, bucket, min points) of each model's training configuration
SHAPES = {"pointnet_seg": (64, 2048, 1100), "voxel_unet3d": (8, 8192, 4000),
          "sparse_voxelnet": (8, 8192, 8192)}


def sparse_batch(b: int, m: int, classes: int = CLASSES):
    """The sparse bench's batch (pcseg_tpu/bench.py:220-223): b track
    events of m points, then labels from the same numpy generator."""
    rng = np.random.default_rng(0)
    points = track_events(b, m, rng)
    labels = rng.integers(0, classes, size=(b, m)).astype(np.int64)
    return [(points[i], labels[i]) for i in range(b)]


def _configs(model: str):
    """(label, model) pairs to profile."""
    def gen():
        return torch.Generator().manual_seed(0)

    if model == "voxel_unet3d":
        return [(f"voxel_{forms}", voxel_model(forms))
                for forms in ("default", "scatter_gather")]
    if model == "sparse_voxelnet":
        return [("sparse", sparse_model())]
    return [(bn_stats, PointNetSeg(CLASSES, bn_stats=bn_stats,
                                   compute_dtype="bfloat16",
                                   generator=gen()))
            for bn_stats in ("fused", "exact")]


def _stages(state, events, cw, gen, b, m):
    rows = []
    for i in range(8):
        t0 = time.perf_counter()
        batch = pad_events(events, m, batch_size=b)
        t1 = time.perf_counter()
        tensors = tuple(torch.from_numpy(a).cuda() for a in batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        train_step(state, tensors, 1e-3, gen, cw)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i >= 3:
            rows.append([t1 - t0, t2 - t1, t3 - t2])
    med = np.median(np.asarray(rows) * 1e3, axis=0)
    return dict(zip(["pad_ms", "h2d_ms", "step_ms"], med.tolist())), tensors


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="pointnet_seg", choices=sorted(SHAPES))
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    b, m, min_points = SHAPES[args.model]
    if args.model == "sparse_voxelnet":
        events = sparse_batch(b, m)
        cw = torch.ones(CLASSES, device="cuda")
    else:
        events = list(synthetic_events(b, min_points=min_points,
                                       max_points=m, seed=5))
        cw = torch.from_numpy(scan_classes(events).weights).cuda()
    card = torch.cuda.get_device_name(0)
    report = {"card": card, "model": args.model, "batch": f"B{b} x {m}"}
    for label, model in _configs(args.model):
        torch.cuda.reset_peak_memory_stats()
        state = create_train_state(model.cuda())
        gen = torch.Generator().manual_seed(1)
        stages, batch = _stages(state, events, cw, gen, b, m)
        prof_res, prof = device_profile(
            lambda: train_step(state, batch, 1e-3, gen, cw))
        report[label] = {"stages": stages,
                         "points_per_s": b * m / (stages["step_ms"] / 1e3),
                         "peak_mem_gib":
                             torch.cuda.max_memory_allocated() / 2 ** 30,
                         **prof_res}
        print(f"[{label}] {card}: stages {json.dumps(stages)}")
        print(f"  one step: wall {prof_res['wall_ms']:.3f} ms, device busy "
              f"{prof_res['device_busy_ms']:.3f} ms, idle share "
              f"{prof_res['idle_share']:.3f}; by stage "
              f"{json.dumps(prof_res['by_stage_ms'])}")
        for k in prof_res["kernels"][:15]:
            print(f"  {k['device_ms']:9.4f} ms  x{k['calls']:<4d} {k['name']}")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"profile_train_{label}.txt"),
                      "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="self_device_time_total", row_limit=60))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
