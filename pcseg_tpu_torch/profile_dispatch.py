"""What the registered kernel ops cost the eager paths, on one CUDA card.

    python -m pcseg_tpu_torch.profile_dispatch [--tree DIR] [--tag T]
                                               [--rounds N] [--out DIR]

Builds chip_smoke.py's serving configurations with seeded random weights:
the default voxel U-Net (64^3, w16, 3 levels, bf16, every impl "auto";
phase 11), the block-sparse SparseVoxelNet (R64, w64, depth 4, 2 levels,
tile 8, capacities (64, 32), bf16, on track events; phase 14) and
PointNetSeg folded f32 (phase 19); and phase 9's voxel train step (the
same U-Net on the scatter / gather forms, Adam, B8 x 8192 synthetic
events). It reports, medians of ``--rounds`` after two warm rounds:

- ms per 16 events through ``Predictor.predict_batch`` (batch 8, bucket
  8192) and ms per ``predict`` of one 1,000-point event, for each
  configuration;
- ms per ``train_step``, each ended by a synchronize;
- where the checkout registers its kernels as ``pcseg::`` ops, both of
  those again with the ops swapped in place for the CUDA functions they
  dispatch to (``serving_direct``, ``voxel_step_direct_ms``: the eager
  paths as they were before the ops existed), in turns in this process
  (op, direct, direct, op); and the host microseconds of one call of each
  op against one direct call of its CUDA function, on the arguments of a
  B1 x 1024 serving forward of the voxel and sparse configurations
  (blocks of 100 calls in the same turns, the device synchronized after
  each block), with the op's calls a forward.

``--tree DIR`` imports ``pcseg_tpu_torch`` from the checkout at DIR (an
earlier commit unpacked with ``git archive``), so that the eager paths of
two versions are timed, one process each, in one call. One JSON line at
the end; with ``--out`` it is also written to
DIR/profile_dispatch[_<tag>].json.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path


def _package(tree: str | None):
    """Import ``pcseg_tpu_torch`` from ``tree`` (or this checkout)."""
    if tree:
        # ``python -m`` imported this checkout's package already
        for name in [k for k in sys.modules if k == "pcseg_tpu_torch"
                     or k.startswith("pcseg_tpu_torch.")]:
            del sys.modules[name]
        sys.path.insert(0, str(Path(tree).resolve()))
    import pcseg_tpu_torch

    return Path(pcseg_tpu_torch.__file__).resolve().parent


def serving_configs():
    """(label, Predictor, events, 1,000-point event) of chip_smoke.py's
    phases 11, 14 and 19."""
    import numpy as np

    from pcseg_tpu_torch.data.synthetic import synthetic_events, track_events
    from pcseg_tpu_torch.infer import Predictor
    from pcseg_tpu_torch.profile_serving import (
        pointnet_model,
        pointnet_predictor,
        sparse_model,
        voxel_model,
    )

    events = [p for p, _ in synthetic_events(16, min_points=4000,
                                             max_points=8192, seed=0)]
    single = next(iter(synthetic_events(1, min_points=1000, max_points=1000,
                                        seed=1)))[0]
    model = voxel_model("default")
    yield ("voxel_default", Predictor(model.state_dict(), 4, model=model),
           events, single)
    model = sparse_model()
    rng = np.random.default_rng(0)
    yield ("sparse_block",
           Predictor(model.state_dict(), 4, model=model,
                     strict_capacity=True),
           [track_events(1, int(m), rng)[0]
            for m in rng.integers(4000, 8193, 16)],
           track_events(1, 1000, 1)[0])
    yield ("pointnet_folded_f32",
           pointnet_predictor("folded_f32", pointnet_model()), events, single)


def _round(pred, events, single):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred.predict_batch(events, batch_size=8)
    t1 = time.perf_counter()
    pred.predict(single)
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3


def _median_ms(rows) -> dict:
    import numpy as np

    return {"predict_batch_16_ms": float(np.median([r[0] for r in rows])),
            "predict_1000pt_ms": float(np.median([r[1] for r in rows]))}


def _voxel_step():
    """Phase 9's voxel train step (scatter / gather forms): a function
    that takes one and returns its ms, each ended by a synchronize."""
    import numpy as np
    import torch

    from pcseg_tpu_torch.data.batching import pad_events
    from pcseg_tpu_torch.data.class_stats import scan_classes
    from pcseg_tpu_torch.data.synthetic import synthetic_events
    from pcseg_tpu_torch.profile_serving import voxel_model
    from pcseg_tpu_torch.train.steps import (
        create_train_state,
        dropout_seeds,
        train_step,
    )

    events = list(synthetic_events(8, min_points=4000, max_points=8192,
                                   seed=5))
    cw = torch.from_numpy(scan_classes(events).weights).cuda()
    batch = tuple(torch.from_numpy(a).cuda()
                  for a in pad_events(events, 8192, batch_size=8))
    state = create_train_state(voxel_model("scatter_gather").cuda())

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch, 1e-3, dropout_seeds(1, 0, state.step), cw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    return step


# where the autograd Functions and the forward wrappers find each op:
# (ops module, attribute) -> op name
_OP_SITES = {("conv3d_block", "_conv3x3_op"): "conv3x3_gn_act",
             ("conv3d_block", "_head_grid2_op"): "head_grid2",
             ("fused_ln", "_fwd_op"): "bias_ln_relu_mask",
             ("block_conv", "_fwd_op"): "block_conv",
             ("voxel", "_voxelize_op"): "voxelize_contract",
             ("voxel", "_gather_op"): "trilinear_gather"}


@contextlib.contextmanager
def _direct_calls():
    """The eager paths call each op's CUDA function directly, as the
    checkouts before the ops were registered did (no dispatcher)."""
    import importlib

    from pcseg_tpu_torch.ops._build import OP_IMPLS

    cb = importlib.import_module("pcseg_tpu_torch.ops.conv3d_block")
    saved = {}
    for (mod, attr), name in _OP_SITES.items():
        m = importlib.import_module(f"pcseg_tpu_torch.ops.{mod}")
        saved[(m, attr)] = getattr(m, attr)
        setattr(m, attr, OP_IMPLS[name][1])
    resample = dict(cb._RESAMPLE)
    for up, name in ((False, "down2x_gn_act"), (True, "up2x_gn_act")):
        cb._RESAMPLE[up] = (OP_IMPLS[name][1],) + resample[up][1:]
    try:
        yield
    finally:
        for (m, attr), fn in saved.items():
            setattr(m, attr, fn)
        cb._RESAMPLE.update(resample)


def _in_turns(fn, rounds: int) -> dict:
    """``fn()`` -> a tuple of ms, timed through the ops and with direct
    calls in turns (op, direct, direct, op; ``rounds`` each a turn, two
    warm): the medians of each."""
    import numpy as np

    rows = {"op": [], "direct": []}
    for turn, who in enumerate(("op", "direct", "direct", "op")):
        ctx = _direct_calls() if who == "direct" else contextlib.nullcontext()
        with ctx:
            got = [fn() for _ in range(rounds + (2 if turn < 2 else 0))]
        rows[who] += got[2:] if turn < 2 else got
    return {who: [float(v) for v in np.median(np.asarray(r), axis=0)]
            for who, r in rows.items()}


def _op_args(preds) -> tuple[dict, dict]:
    """The first call's arguments of each pcseg:: op and its calls a
    forward, from one B1 x 1024 forward of each predictor."""
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from pcseg_tpu_torch.data.batching import pad_events

    args, calls = {}, {}

    class Capture(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kwargs=None):
            name = func.__name__.split(".")[0]
            if func.namespace == "pcseg":
                calls[name] = calls.get(name, 0) + 1
                args.setdefault(name, tuple(
                    t.clone() if isinstance(t, torch.Tensor) else t
                    for t in a))
            return func(*a, **(kwargs or {}))

    for pred, single in preds:
        pts, _, msk = pad_events([(single, np.zeros(len(single), np.int64))],
                                 1024, batch_size=1)
        with Capture():
            pred.device_forward(torch.from_numpy(pts).cuda(),
                                torch.from_numpy(msk).cuda())
    return args, calls


def _dispatch_us(preds, rounds: int) -> dict:
    """Host us a call: each pcseg:: op against its CUDA function."""
    import numpy as np
    import torch

    from pcseg_tpu_torch.ops._build import OP_IMPLS

    args, calls = _op_args(preds)
    out = {}
    for name, a in sorted(args.items()):
        op, direct = getattr(torch.ops.pcseg, name), OP_IMPLS[name][1]
        times = {"op": [], "direct": []}
        for _ in range(2 + rounds):
            for who, fn in (("op", op), ("direct", direct),
                            ("direct", direct), ("op", op)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(100):
                    fn(*a)
                torch.cuda.synchronize()
                times[who].append((time.perf_counter() - t0) * 1e4)
        op_us, direct_us = (float(np.median(times[k][4:]))
                            for k in ("op", "direct"))
        out[name] = {"op_us": op_us, "direct_us": direct_us,
                     "calls_a_b1_forward": calls[name]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    pkg = _package(args.tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_dispatch needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from pcseg_tpu_torch.ops import _build

    _build.build_all()
    report = {"tree": args.tag or args.tree or "this checkout",
              "package": str(pkg), "card": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "serving": {}}
    has_ops = hasattr(_build, "OP_IMPLS")
    preds = []
    for label, pred, events, single in serving_configs():
        if has_ops:
            by = _in_turns(lambda: _round(pred, events, single), args.rounds)
            report["serving"][label] = _median_ms([by["op"]])
            report.setdefault("serving_direct", {})[label] = _median_ms(
                [by["direct"]])
        else:
            for _ in range(2):
                _round(pred, events, single)
            report["serving"][label] = _median_ms(
                [_round(pred, events, single) for _ in range(args.rounds)])
        if label != "pointnet_folded_f32":
            preds.append((pred, single))
    step = _voxel_step()
    if has_ops:
        by = _in_turns(lambda: (step(),), args.rounds)
        report["voxel_step_ms"] = by["op"][0]
        report["voxel_step_direct_ms"] = by["direct"][0]
        report["dispatch"] = _dispatch_us(preds, args.rounds)
    else:
        report["voxel_step_ms"] = float(np.median(
            [step() for _ in range(2 + args.rounds)][2:]))
    line = json.dumps(report)
    print(line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = f"profile_dispatch_{args.tag}.json" if args.tag else \
            "profile_dispatch.json"
        with open(os.path.join(args.out, name), "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
