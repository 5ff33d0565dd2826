"""Row 21, the sparse U-Net's block conv (csrc/block_conv.cu: forward,
dgrad and wgrad), at the shapes one sparse train step runs on one card,
with its bound and cuDNN's call of the same conv.

    python -m pcseg_tpu_torch.profile_blockconv [--tree DIR] [--out DIR]

The tiles of chip_smoke.py's sparse batch: B8 x 8192 track events (seed 0)
on a 64^3 grid in tiles of 8^3, capacities (64, 32): level 0 (NT 64) and
level 1 (NT 32, ``block_pool``). Three shapes, bf16: the stem (2 -> 64,
level 0; forward and wgrad, no dgrad), level 0 (64 -> 64) and level 1
(128 -> 128). For each op at each shape:

- the op's device time (torch.profiler, every kernel of the call summed,
  each kernel's share beside it) and its CUDA-event time around
  back-to-back calls (the wrapper's host time and allocations included);
- the launch count of the tensor-core route where the checkout has one,
  max |err| against the plain version and whether two calls give the
  same bits;
- the bound: the larger of the bytes it must move (inputs read once,
  output written once) at 3.35 TB/s and the products of the real tiles'
  voxels (2 x 27 x Cin x Cout flops each) at 989 TFLOP/s;
- cuDNN on the materialized (B NT, Cin, 10, 10, 10) halo of every tile,
  real or not (``F.conv3d``, or ``convolution_backward`` for the input or
  the weight gradient), device and op time.

``--tree DIR`` imports ``pcseg_tpu_torch`` from the checkout at DIR (an
earlier commit unpacked with ``git archive``), so that two versions are
timed by this script, one process each, in one call. One JSON line at the
end; with ``--out`` it is also written to DIR/profile_blockconv[_<tag>].json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from pcseg_tpu_torch.profile_devox import event_ms, kernel_ms

B, M, R, T, CAPS = 8, 8192, 64, 8, (64, 32)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# (label, level, Cin, Cout, ops)
SHAPES = [("stem", 0, 2, 64, ("fwd", "wgrad")),
          ("level 0", 0, 64, 64, ("fwd", "dgrad", "wgrad")),
          ("level 1", 1, 128, 128, ("fwd", "dgrad", "wgrad"))]
NAMES = {"fwd": "block_conv", "dgrad": "block_conv_dgrad",
         "wgrad": "block_conv_wgrad"}


def _package(tree: str | None):
    """The block conv and the tile builders from ``tree`` or from this
    checkout."""
    if tree:
        root = str(Path(tree).resolve())
        for name in [k for k in sys.modules
                     if k == "pcseg_tpu_torch"
                     or k.startswith("pcseg_tpu_torch.")]:
            del sys.modules[name]
        sys.path.insert(0, root)
    from pcseg_tpu_torch.data.synthetic import track_events
    from pcseg_tpu_torch.ops import block_conv as bc
    from pcseg_tpu_torch.ops import block_sparse as bsp

    if tree and not Path(bc.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {bc.__file__}, not from {root}")
    return bc, bsp, track_events


def _both(fn) -> dict:
    by_kernel = kernel_ms(fn)
    return {"device_ms": sum(by_kernel.values()), "op_ms": event_ms(fn),
            "kernels": {k[:60]: v for k, v in by_kernel.items()}}


def levels(bsp, track_events):
    import torch

    pts = torch.from_numpy(track_events(B, M, 0)).cuda()
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device="cuda")
    bs, _, _ = bsp.block_sparse_voxelize(pts, mask, R, CAPS[0], T,
                                         plain=True)
    return [bs, bsp.block_pool(bs, CAPS[1])[0]]


def conv_case(bc, bsp, bs, cin, cout, op, gen) -> dict:
    import torch
    import torch.nn.functional as F

    t3 = T ** 3
    b, nt = bs.tile_mask.shape
    real = bs.tile_mask
    slots = bsp.neighbor_slots(bs)
    bf = torch.bfloat16
    x = torch.randn((b, nt, t3, cin), generator=gen, device="cuda")
    x = torch.where(real[..., None, None], x, 0.0).to(bf)
    gy = torch.randn((b, nt, t3, cout), generator=gen, device="cuda")
    gy = torch.where(real[..., None, None], gy, 0.0).to(bf)
    w2 = ((torch.rand((27 * cin, cout), generator=gen, device="cuda") * 2
           - 1) * (6.0 / (27 * cin)) ** 0.5).to(bf)
    run, plain = {
        "fwd": (lambda: bc.block_conv_fwd(x, slots, w2),
                lambda: bc.block_conv_plain(x, slots, w2)),
        "dgrad": (lambda: bc.block_conv_dgrad(gy, slots, w2),
                  lambda: bc.block_conv_dgrad_plain(gy, slots, w2)),
        "wgrad": (lambda: bc.block_conv_wgrad(x, slots, gy),
                  lambda: bc.block_conv_wgrad_plain(x, slots, gy)),
    }[op]
    key = f"{NAMES[op]}_mma"
    before = bc.LAUNCHES.get(key)
    a = run()
    torch.cuda.synchronize()
    mma = None if before is None else bc.LAUNCHES[key] - before
    err = float((a.float() - plain().float()).abs().max())
    same = bool(torch.equal(a, run()))

    halo = bc.gather_halo_slots(x.reshape(b, nt, T, T, T, cin), slots)
    halo = halo.reshape(b * nt, T + 2, T + 2, T + 2, cin).permute(
        0, 4, 1, 2, 3).contiguous()
    wl = w2.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2).contiguous()
    go = gy.reshape(b * nt, T, T, T, cout).permute(0, 4, 1, 2, 3)
    go = go.contiguous()
    if op == "fwd":
        def library():
            return F.conv3d(halo, wl)
    else:
        mask = [op == "dgrad", op == "wgrad", False]

        def library():
            return torch.ops.aten.convolution_backward(
                go, halo, wl, None, [1, 1, 1], [0, 0, 0], [1, 1, 1], False,
                [0, 0, 0], 1, mask)

    n_real = int(real.sum())
    ins = {"fwd": x.numel() + w2.numel(), "dgrad": gy.numel() + w2.numel(),
           "wgrad": x.numel() + gy.numel()}[op]
    n_out = {"fwd": b * nt * t3 * cout, "dgrad": x.numel(),
             "wgrad": w2.numel()}[op]
    nbytes = (ins + n_out) * 2 + slots.numel() * 4
    flops = 2 * 27 * cin * cout * t3 * n_real
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOP_PER_S * 1e3
    return {
        "shape": f"B{b} NT{nt} t{T} {cin}->{cout} bf16",
        "real_tiles": n_real, "tensor_core_launches": mma,
        "max_abs_err": err, "two_calls_identical": same,
        "kernel": _both(run), "cudnn": _both(library),
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes > by_ops else "operations",
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_blockconv: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    bc, bsp, track_events = _package(args.tree)
    tiles = levels(bsp, track_events)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"card": card, "tree": args.tree or ".", "cases": {}}
    for label, lv, cin, cout, ops in SHAPES:
        res["cases"][label] = {op: conv_case(bc, bsp, tiles[lv], cin, cout,
                                             op, gen) for op in ops}
    line = json.dumps(res)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = f"_{args.tag}" if args.tag else ""
        Path(args.out, f"profile_blockconv{tag}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
