"""Rows 11, 13 and 10, the matmul devoxelize's backward and forward and
the matmul voxelizer (csrc/onehot_contract.cu ``trilinear_scatter``,
``trilinear_gather`` and ``voxelize_contract``), at the voxel step's
shapes on one card, with their PyTorch yardsticks.

    python -m pcseg_tpu_torch.profile_devox [--tree DIR] [--out DIR]
        [--only voxelize] [--variants]

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
  3.35 TB/s;
- a digest (sha256) of each op's output, so that two checkouts' bits can
  be compared (rows 11 and 13 keep theirs at C <= 32).

Row 10 at its two call sites: the default voxel model's voxelize on the
"default" batch (B8 x 8192 at 64^3, C1 3) and the sparse model's
block-sparse voxelize of chip_smoke.py's track events (tile-major ids,
C1 2), and on ids uniform over the grid (C1 3): device and op ms by
kernel (the op is one launch, its table's zeros included), two calls bit
for bit, max |err| against the plain version, the bound (ids as the
callers pass them and rows read, the f32 table written), and
``torch.zeros`` + ``index_add_`` (the same function from scratch) and
``index_add_`` alone. Rows 11 and 13 also at 40 channels on a 32^3 grid
(the 40-class U-Net's devoxelize; a checkout that refuses the width
records the refusal).

``--only voxelize`` times row 10 alone. ``--variants`` adds row 10 from
variant builds of ``csrc/onehot_contract.cu`` under
``build/pcseg_tpu_torch/devox_*`` (``VOX_VARIANTS``: a contiguous slab
of the table a block, by 16-byte stores or by TMA bulk stores; slab
flags in place of the grid barrier; the fill and barrier without the
adds, the fill alone; 1 and 4 blocks an SM), each by device time and,
where it computes the function, against the plain version; this
checkout only, not with ``--tree``. ``--tree DIR`` imports
``pcseg_tpu_torch`` from the checkout at DIR (an earlier commit
unpacked with ``git archive``), so that two versions are
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
# row 10's variant builds (csrc/onehot_contract.cu's PCSEG_VOX_* hooks):
# tag -> (-D defines, whether it computes the function)
VOX_VARIANTS = {
    "fill_slabs": (("PCSEG_VOX_FILL=1",), True),
    "tma_fill": (("PCSEG_VOX_FILL=2",), True),
    "slab_flags": (("PCSEG_VOX_FILL=1", "PCSEG_VOX_SLAB_FLAGS=1"), True),
    "fill_barrier": (("PCSEG_VOX_FILL_ONLY=1",), False),
    "fill_alone": (("PCSEG_VOX_FILL_ONLY=2",), False),
    "blocks_1": (("PCSEG_VOX_MIN_BLOCKS=1",), True),
    "blocks_4": (("PCSEG_VOX_MIN_BLOCKS=4",), True),
}
WIDE_R, WIDE_C = 32, 40
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


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    import hashlib

    import torch

    raw = t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


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


def default_points(pad_events, synthetic_events):
    """chip_smoke.py's default batch: seven synthetic events and an
    all-masked row, 2,000 points of event 0 on one spot."""
    import torch

    events = list(synthetic_events(B - 1, min_points=4000, max_points=M,
                                   seed=7))
    pts, _, mask = pad_events(events, M, batch_size=B)
    pts[0, 1:2001, :3] = pts[0, 0, :3]
    return torch.from_numpy(pts).cuda(), torch.from_numpy(mask).cuda()


def batches(vx, pad_events, synthetic_events):
    """(name, u, mask, go) of the two batches, from fixed seeds."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    u = torch.rand((B, M, 3), generator=gen, device="cuda") * R - 0.5
    valid = torch.rand((B, M), generator=gen, device="cuda") < 0.75
    go = torch.randn((B, M, C), generator=gen, device="cuda") * 1e-3
    out = [("uniform", u, valid, torch.where(valid[..., None], go, 0.0))]

    points, mask = default_points(pad_events, synthetic_events)
    _, _, lo, scale = vx.voxel_rows(points, mask, R)
    u = vx.trilinear_u(points, mask, lo, scale)
    go = torch.randn((B, M, C), generator=gen, device="cuda") * 1e-3
    out.append(("default", u, mask, torch.where(mask[..., None], go, 0.0)))
    return out


def scatter_case(vx, u, go, r=R) -> dict:
    import torch

    c = go.shape[-1]

    has_dtype = "out_dtype" in inspect.signature(
        vx.trilinear_scatter).parameters
    if has_dtype:
        def half():
            return vx.trilinear_scatter(u, go, r, out_dtype=torch.bfloat16)
    else:
        def half():
            return vx.trilinear_scatter(u, go, r).to(torch.bfloat16)

    def full():
        return vx.trilinear_scatter(u, go, r)

    a, b = full(), full()
    ref = vx.trilinear_scatter_plain(u, go, r)
    rows, vals = vx.trilinear_scatter_taps(u, go, r)
    rows, vals = rows.reshape(-1), vals.reshape(-1, c)
    zeroed = torch.zeros((B * r ** 3, c), device="cuda")

    def from_scratch():
        return torch.zeros((B * r ** 3, c), device="cuda").index_add_(
            0, rows, vals)

    def add_only():
        return zeroed.index_add_(0, rows, vals)

    n_real = int((go != 0).any(-1).sum())
    point_bytes = B * M * 3 * 4 + B * M * c * 4
    return {
        "max_abs_err": float((a - ref).abs().max()),
        "max_abs_ref": float(ref.abs().max()),
        "two_calls_identical": bool(torch.equal(a, b)),
        "bf16_is_f32_rounded": bool(torch.equal(half(), a.to(torch.bfloat16))),
        "sha_f32": digest(a), "sha_bf16": digest(half()),
        "real_points": n_real,
        "f32": _both(full), "bf16": _both(half),
        "zeros_index_add": _both(from_scratch),
        "index_add_alone": _both(add_only),
        "bound_ms_f32": (point_bytes + B * r ** 3 * c * 4)
        / HBM_BYTES_PER_S * 1e3,
        "bound_ms_bf16": (point_bytes + B * r ** 3 * c * 2)
        / HBM_BYTES_PER_S * 1e3,
    }


def gather_case(vx, u, mask, r=R, c=C) -> dict:
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    g2 = torch.randn((B, r * r, r * c), generator=gen,
                     device="cuda").to(torch.bfloat16)

    def kernel():
        return vx.trilinear_gather(u, mask, g2)

    out = kernel()
    err = float((out - vx.trilinear_gather_plain(u, mask, g2)).abs().max())
    grid5 = g2.float().reshape(B, r, r, r, c).permute(0, 4, 1, 2, 3)
    grid5 = grid5.contiguous()
    coords = ((2 * u + 1) / r - 1).flip(-1).reshape(B, 1, 1, M, 3)

    def library():
        return F.grid_sample(grid5, coords, mode="bilinear",
                             padding_mode="border", align_corners=False)

    zi, _, xs, _ = vx._tri_taps(u, r, lambda t: t)
    base = torch.arange(B, device="cuda")[:, None] * r ** 3
    touched = torch.cat([(base + z * r + x)[mask] for z in zi for x in xs])
    n_rows = int(torch.unique(touched).numel())
    return {
        "max_abs_err": err, "grid_rows_read": n_rows, "sha": digest(out),
        "two_calls_identical": bool(torch.equal(out, kernel())),
        "kernel": _both(kernel), "grid_sample": _both(library),
        "bound_ms": (B * M * 3 * 4 + B * M + n_rows * c * 2 + B * M * c * 4)
        / HBM_BYTES_PER_S * 1e3,
    }


def variant_libs() -> dict:
    """Row 10's variant builds of this checkout, one nvcc each, together."""
    from concurrent.futures import ThreadPoolExecutor

    from pcseg_tpu_torch.ops._build import build_variant

    with ThreadPoolExecutor(len(VOX_VARIANTS)) as pool:
        libs = pool.map(lambda kv: build_variant(
            "onehot_contract", f"devox_{kv[0]}", kv[1][0]),
            VOX_VARIANTS.items())
        return dict(zip(VOX_VARIANTS, libs))


def variant_call(lib, flat, ext, r):
    """The wrapper's launch (ops/voxel.py voxelize_contract) through a
    variant build's entry."""
    import torch

    from pcseg_tpu_torch.ops._build import raise_on, stream_of

    b, m, c1 = ext.shape
    out = torch.empty((b, r ** 3, c1), device=ext.device)
    raise_on(lib.pcseg_voxelize_contract(
        flat.data_ptr(), flat.element_size(), ext.data_ptr(), out.data_ptr(),
        b, m, r, c1, stream_of(ext)), "voxelize_contract variant")
    return out


def voxelize_case(vx, flat, ext, r=R, libs=None) -> dict:
    """Row 10 on one call site's ids and rows (and on ``libs``, variant
    builds by tag)."""
    import torch

    c1 = ext.shape[-1]
    flat, ext = flat.contiguous(), ext.float().contiguous()

    def kernel():
        return vx.voxelize_contract(flat, ext, r)

    a = kernel()
    ref = vx.voxelize_contract_plain(flat, ext, r)
    rows = (flat.long() + torch.arange(B, device="cuda")[:, None]
            * (r ** 3 + 1)).reshape(-1)
    vals = ext.to(torch.bfloat16).float().reshape(-1, c1)
    zeroed = torch.zeros((B * (r ** 3 + 1), c1), device="cuda")

    def from_scratch():
        return torch.zeros((B * (r ** 3 + 1), c1), device="cuda").index_add_(
            0, rows, vals)

    variants = {}
    for tag, lib in (libs or {}).items():
        def call(lib=lib):
            return variant_call(lib, flat, ext, r)

        got = call()
        variants[tag] = _both(call)
        if VOX_VARIANTS[tag][1]:
            variants[tag].update(
                max_abs_err=float((got - ref).abs().max()),
                counts_exact=bool(torch.equal(got[..., -1], ref[..., -1])))
    return {
        "shape": f"B{B} M{M} -> {r}^3x{c1}",
        "id_bytes": flat.element_size(),
        "max_abs_err": float((a - ref).abs().max()),
        "max_abs_ref": float(ref.abs().max()),
        "counts_exact": bool(torch.equal(a[..., -1], ref[..., -1])),
        "two_calls_identical": bool(torch.equal(a, kernel())),
        "hot_voxel_points": int(ref[..., -1].max()),
        "kernel": _both(kernel),
        "zeros_index_add": _both(from_scratch),
        "index_add_alone": _both(lambda: zeroed.index_add_(0, rows, vals)),
        # ids and rows read once, the f32 table written once
        "bound_ms": (B * M * flat.element_size() + B * M * c1 * 4
                     + B * r ** 3 * c1 * 4) / HBM_BYTES_PER_S * 1e3,
        "variants": variants,
    }


def voxelize_sites(vx, points, mask, libs=None) -> dict:
    """Row 10 at its two call sites: the default batch's voxel rows, and
    the sparse model's tile-major ids on track events (C1 2); and on ids
    uniform over the grid (3/4 of the points real, C1 3: no voxel holds
    many points)."""
    import torch

    from pcseg_tpu_torch.data.synthetic import track_events

    flat, ext, _, _ = vx.voxel_rows(points, mask, R)
    out = {"default": voxelize_case(vx, flat, ext, libs=libs)}
    gen = torch.Generator(device="cuda").manual_seed(3)
    real = torch.rand((B, M), generator=gen, device="cuda") < 0.75
    ids = torch.randint(0, R ** 3, (B, M), generator=gen, device="cuda")
    rows = torch.cat([torch.rand((B, M, 1), generator=gen, device="cuda"),
                      torch.ones((B, M, 2), device="cuda")], -1)
    out["uniform"] = voxelize_case(vx, torch.where(real, ids, R ** 3),
                                   torch.where(real[..., None], rows, 0.0),
                                   libs=libs)
    pts = torch.from_numpy(track_events(B, M, 0)).cuda()
    tmask = torch.ones(pts.shape[:2], dtype=torch.bool, device="cuda")
    t = 8
    flat, _, _ = vx.voxel_indices(pts[..., :3].float(), tmask, R)
    i, j, k = flat // (R * R), (flat // R) % R, flat % R
    nt = R // t
    tid = ((i // t) * nt + (j // t)) * nt + (k // t)
    intra = ((i % t) * t + (j % t)) * t + (k % t)
    blocked = torch.where(flat >= R ** 3, R ** 3, tid * t ** 3 + intra)
    ext = torch.cat([pts[..., 3:].float(),
                     torch.ones_like(pts[..., :1].float())], -1)
    out["sparse"] = voxelize_case(vx, blocked, ext, libs=libs)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", choices=("voxelize",), default=None)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if args.variants and args.tree:
        ap.error("--variants builds this checkout's variants: no --tree")

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
    points, mask = default_points(pad_events, synthetic_events)
    libs = variant_libs() if args.variants else None
    res["voxelize"] = voxelize_sites(vx, points, mask, libs)
    if args.only:
        return _emit(res, args)
    for name, u, mask_u, go in batches(vx, pad_events, synthetic_events):
        res["cases"][name] = {"scatter": scatter_case(vx, u, go),
                              "gather": gather_case(vx, u, mask_u)}
    # the 40-class 32^3 U-Net's devoxelize pair
    _, _, lo, scale = vx.voxel_rows(points, mask, WIDE_R)
    u = vx.trilinear_u(points, mask, lo, scale)
    gen = torch.Generator(device="cuda").manual_seed(2)
    go = torch.randn((B, M, WIDE_C), generator=gen, device="cuda") * 1e-3
    go = torch.where(mask[..., None], go, 0.0)
    wide = {}
    for name, fn in (("scatter", lambda: scatter_case(vx, u, go, WIDE_R)),
                     ("gather", lambda: gather_case(vx, u, mask, WIDE_R,
                                                    WIDE_C))):
        try:
            wide[name] = fn()
        except ValueError as err:      # a checkout that refuses C 40
            wide[name] = {"refused": str(err)}
    res["wide"] = {"shape": f"B{B} M{M} R{WIDE_R} C{WIDE_C}", **wide}
    return _emit(res, args)


def _emit(res: dict, args) -> int:
    """Print the JSON line, and write it under ``--out``."""
    line = json.dumps(res)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = f"_{args.tag}" if args.tag else ""
        Path(args.out, f"profile_devox{tag}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
