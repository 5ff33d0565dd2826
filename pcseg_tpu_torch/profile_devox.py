"""Rows 11 and 13, the matmul devoxelize's backward and forward
(csrc/onehot_contract.cu ``trilinear_scatter`` and ``trilinear_gather``),
at the voxel step's shape on one card, with their PyTorch yardsticks.

    python -m pcseg_tpu_torch.profile_devox [--tree DIR] [--out DIR]

Two batches of B8 x 8192 points on a 64^3 grid with C = 4 channels:
"uniform" (continuous coords uniform over the grid, 3/4 of the points
real: chip_smoke.py's row 11 case) and "default" (chip_smoke.py's default
batch: seven synthetic events and an all-masked row, 2,000 points of
event 0 on one spot). For each:

- row 11 by device time (torch.profiler, every kernel of the op summed)
  and by CUDA events around back-to-back calls (the op, its allocations
  included), with f32 output and with the bf16 output the train step
  runs; two calls compared bit for bit;
- its yardsticks: ``torch.zeros`` + ``index_add_`` of the precomputed
  tap rows (the same function from scratch) and ``index_add_`` alone
  into a grid zeroed once outside the timing;
- row 13 by device time and CUDA events, with ``F.grid_sample`` of the
  same clipped trilinear function in f32;
- each op's bound: its inputs read once and its output written once at
  3.35 TB/s.

``--tree DIR`` imports ``pcseg_tpu_torch`` from the checkout at DIR (an
earlier commit unpacked with ``git archive``), so that two versions are
timed by this script, one process each, in one call. A version whose
``trilinear_scatter`` has no ``out_dtype`` is timed with the
``.to(torch.bfloat16)`` cast its step ran. One JSON line at the end; with
``--out`` it is also written to DIR/profile_devox[_<tag>].json.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

B, M, R, C = 8, 8192, 64, 4
HBM_BYTES_PER_S = 3.35e12
ITERS = 20


def _package(tree: str | None):
    """pcseg_tpu_torch.ops.voxel (and the batching helpers) from ``tree``
    or from this checkout."""
    if tree:
        root = str(Path(tree).resolve())
        for name in [k for k in sys.modules
                     if k == "pcseg_tpu_torch"
                     or k.startswith("pcseg_tpu_torch.")]:
            del sys.modules[name]
        sys.path.insert(0, root)
    from pcseg_tpu_torch.data.batching import pad_events
    from pcseg_tpu_torch.data.synthetic import synthetic_events
    from pcseg_tpu_torch.ops import voxel as vx

    if tree and not Path(vx.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {vx.__file__}, not from {root}")
    return vx, pad_events, synthetic_events


def kernel_ms(fn, iters: int = ITERS, attempts: int = 3) -> dict:
    """Device ms per call of ``fn`` by kernel name, from torch.profiler
    over ``iters`` warm calls, profiled again while a kernel's recorded
    launches are not a whole multiple of ``iters``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen: dict = {}
    for _ in range(attempts):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rec = {e.key: (e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0}
        for name, (ms, calls) in rec.items():
            best, mean, per = seen.get(name, (0, 0.0, 0))
            if calls > best:
                best, mean = calls, ms / calls
            seen[name] = (best, mean, max(per, -(-calls // iters)))
        if rec and all(calls % iters == 0 for _, calls in rec.values()):
            break
    return {name: mean * per for name, (_, mean, per) in seen.items()}


def event_ms(fn, iters: int = ITERS) -> float:
    """CUDA-event ms per call of back-to-back calls of ``fn``."""
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


def _both(fn) -> dict:
    """Device ms (all kernels) with each kernel's share, and op ms."""
    by_kernel = kernel_ms(fn)
    return {"device_ms": sum(by_kernel.values()), "op_ms": event_ms(fn),
            "kernels": {k[:60]: v for k, v in by_kernel.items()}}


def batches(vx, pad_events, synthetic_events):
    """(name, u, mask, go) of the two batches, from fixed seeds."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    u = torch.rand((B, M, 3), generator=gen, device="cuda") * R - 0.5
    valid = torch.rand((B, M), generator=gen, device="cuda") < 0.75
    go = torch.randn((B, M, C), generator=gen, device="cuda") * 1e-3
    out = [("uniform", u, valid, torch.where(valid[..., None], go, 0.0))]

    events = list(synthetic_events(B - 1, min_points=4000, max_points=M,
                                   seed=7))
    pts, _, mask = pad_events(events, M, batch_size=B)
    pts[0, 1:2001, :3] = pts[0, 0, :3]
    points = torch.from_numpy(pts).cuda()
    mask = torch.from_numpy(mask).cuda()
    _, _, lo, scale = vx.voxel_rows(points, mask, R)
    u = vx.trilinear_u(points, mask, lo, scale)
    go = torch.randn((B, M, C), generator=gen, device="cuda") * 1e-3
    out.append(("default", u, mask, torch.where(mask[..., None], go, 0.0)))
    return out


def scatter_case(vx, u, go) -> dict:
    import torch

    has_dtype = "out_dtype" in inspect.signature(
        vx.trilinear_scatter).parameters
    if has_dtype:
        def half():
            return vx.trilinear_scatter(u, go, R, out_dtype=torch.bfloat16)
    else:
        def half():
            return vx.trilinear_scatter(u, go, R).to(torch.bfloat16)

    def full():
        return vx.trilinear_scatter(u, go, R)

    a, b = full(), full()
    ref = vx.trilinear_scatter_plain(u, go, R)
    rows, vals = vx.trilinear_scatter_taps(u, go, R)
    rows, vals = rows.reshape(-1), vals.reshape(-1, C)
    zeroed = torch.zeros((B * R ** 3, C), device="cuda")

    def from_scratch():
        return torch.zeros((B * R ** 3, C), device="cuda").index_add_(
            0, rows, vals)

    def add_only():
        return zeroed.index_add_(0, rows, vals)

    n_real = int((go != 0).any(-1).sum())
    point_bytes = B * M * 3 * 4 + B * M * C * 4
    return {
        "max_abs_err": float((a - ref).abs().max()),
        "max_abs_ref": float(ref.abs().max()),
        "two_calls_identical": bool(torch.equal(a, b)),
        "bf16_is_f32_rounded": bool(torch.equal(half(), a.to(torch.bfloat16))),
        "real_points": n_real,
        "f32": _both(full), "bf16": _both(half),
        "zeros_index_add": _both(from_scratch),
        "index_add_alone": _both(add_only),
        "bound_ms_f32": (point_bytes + B * R ** 3 * C * 4)
        / HBM_BYTES_PER_S * 1e3,
        "bound_ms_bf16": (point_bytes + B * R ** 3 * C * 2)
        / HBM_BYTES_PER_S * 1e3,
    }


def gather_case(vx, u, mask) -> dict:
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    g2 = torch.randn((B, R * R, R * C), generator=gen,
                     device="cuda").to(torch.bfloat16)

    def kernel():
        return vx.trilinear_gather(u, mask, g2)

    err = float((kernel() - vx.trilinear_gather_plain(u, mask, g2))
                .abs().max())
    grid5 = g2.float().reshape(B, R, R, R, C).permute(0, 4, 1, 2, 3)
    grid5 = grid5.contiguous()
    coords = ((2 * u + 1) / R - 1).flip(-1).reshape(B, 1, 1, M, 3)

    def library():
        return F.grid_sample(grid5, coords, mode="bilinear",
                             padding_mode="border", align_corners=False)

    zi, _, xs, _ = vx._tri_taps(u, R, lambda t: t)
    base = torch.arange(B, device="cuda")[:, None] * R ** 3
    touched = torch.cat([(base + z * R + x)[mask] for z in zi for x in xs])
    n_rows = int(torch.unique(touched).numel())
    return {
        "max_abs_err": err, "grid_rows_read": n_rows,
        "kernel": _both(kernel), "grid_sample": _both(library),
        "bound_ms": (B * M * 3 * 4 + B * M + n_rows * C * 2 + B * M * C * 4)
        / HBM_BYTES_PER_S * 1e3,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_devox: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    vx, pad_events, synthetic_events = _package(args.tree)
    res = {"card": card, "tree": args.tree or ".",
           "shape": f"B{B} M{M} R{R} C{C}", "cases": {}}
    for name, u, mask, go in batches(vx, pad_events, synthetic_events):
        res["cases"][name] = {"scatter": scatter_case(vx, u, go),
                              "gather": gather_case(vx, u, mask)}
    line = json.dumps(res)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = f"_{args.tag}" if args.tag else ""
        Path(args.out, f"profile_devox{tag}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
