"""Rows 1, 2 and 3, the voxel U-Net's 3^3 conv (forward, dgrad, wgrad),
at the shapes the voxel steps run on one card, with their bound and
cuDNN's call of the same conv.

    python -m pcseg_tpu_torch.profile_ring [--tree DIR] [--tag T] [--out DIR]

Shapes ("act": the activation, the stats and their cotangent): the 64^3
step's three levels at B8 (64^3 x 16, 32^3 x 32, 16^3 x 64), where every
kernel takes whole rows of the ring (csrc/conv3d_dgrad.cu), and at B1 the
128^3 step's level 0 (128^3 x 16) and the 256^3 step's three levels
(256^3 x 16, 128^3 x 32, 64^3 x 64), where all three take column tiles
of the ring. For each op at each shape:

- the op's device time (torch.profiler, every kernel of the call summed,
  each kernel's share beside it) and its CUDA-event time around
  back-to-back calls;
- which kernel took it (the tensor-core launch count), max |err| of each
  output against the plain version, whether two calls give the same
  bits, and the sha256 of the outputs, so that two checkouts' bits can be
  compared;
- the bound: the larger of the bytes it must move (inputs read once,
  outputs written once) at 3.35 TB/s and its 2 x 27 C^2 flops a voxel at
  989 TFLOP/s;
- cuDNN's bf16 call of the same conv (``F.conv3d``, or
  ``convolution_backward`` for the input or the weight gradient; TF32
  off), device and op time.

``--tree DIR`` imports ``pcseg_tpu_torch`` from the checkout at DIR (an
earlier commit unpacked with ``git archive``), so that two versions are
timed, and their bits compared, one process each, in one call. One JSON
line at the end; with ``--out`` it is also written to
DIR/profile_ring[_<tag>].json.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

from pcseg_tpu_torch.profile_devox import _both

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# (label, B, (D, H, W), C)
SHAPES = [("64^3 x 16", 8, (64, 64, 64), 16),
          ("32^3 x 32", 8, (32, 32, 32), 32),
          ("16^3 x 64", 8, (16, 16, 16), 64),
          ("128^3 x 16", 1, (128, 128, 128), 16),
          ("256^3 x 16", 1, (256, 256, 256), 16),
          ("128^3 x 32", 1, (128, 128, 128), 32),
          ("64^3 x 64", 1, (64, 64, 64), 64)]
MMA = {"fwd": "conv3x3_mma", "dgrad": "conv3x3_dgrad_mma",
       "wgrad": "conv3x3_wgrad_mma"}


def _package(tree: str | None):
    """ops/conv3d_block.py from ``tree`` or from this checkout."""
    if tree:
        root = str(Path(tree).resolve())
        for name in [k for k in sys.modules
                     if k == "pcseg_tpu_torch"
                     or k.startswith("pcseg_tpu_torch.")]:
            del sys.modules[name]
        sys.path.insert(0, root)
    from pcseg_tpu_torch.ops import conv3d_block as cb

    if tree and not Path(cb.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {cb.__file__}, not from {root}")
    return cb


def _digest(ts) -> str:
    """The first 16 hex digits of the sha256 of the outputs' bytes."""
    import torch

    h = hashlib.sha256()
    for t in ts:
        if t is not None:
            h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                     .tobytes())
    return h.hexdigest()[:16]


def shape_cases(cb, b, dhw, c, gen) -> dict:
    import torch
    import torch.nn.functional as F

    x = torch.randn((b, *dhw, c), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = ((torch.rand((3, 3, 3, c, c), generator=gen, device="cuda") * 2 - 1)
         * (6.0 / (27 * c)) ** 0.5)
    bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
    scale = torch.rand((b, c), generator=gen, device="cuda") * 0.6 + 0.7
    shift = torch.randn((b, c), generator=gen, device="cuda") * 0.3
    y, _ = cb.conv3x3_gn_act_plain(x, w, bias, scale, shift)
    gy = torch.randn(y.shape, generator=gen, device="cuda").to(torch.bfloat16)
    gstats = torch.stack([
        torch.randn((b, c), generator=gen, device="cuda") * 1e-2,
        torch.randn((b, c), generator=gen, device="cuda") * 1e-3], dim=1)
    fargs = (x, w, bias, scale, shift)
    dargs = (gy, y, gstats, x, w, scale, shift, True, False)
    wargs = (x, scale, shift, gy, y, gstats, True)
    wl = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2)
    xl, gl = x.permute(0, 4, 1, 2, 3), gy.permute(0, 4, 1, 2, 3)

    def library_bwd(mask):
        return lambda: torch.ops.aten.convolution_backward(
            gl, xl, wl, [c], [1] * 3, [1] * 3, [1] * 3, False, [0] * 3, 1,
            mask)

    t, wb, vec = x.numel() * 2, 27 * c * c * 2, 2 * b * c * 4
    ops = {
        "fwd": (lambda: cb.conv3x3_gn_act_cuda(*fargs),
                lambda: cb.conv3x3_gn_act_plain(*fargs),
                lambda: F.conv3d(xl, wl, padding=1),
                2 * t + wb + c * 4 + 2 * vec),
        "dgrad": (lambda: cb.conv3x3_dgrad_cuda(*dargs),
                  lambda: cb.conv3x3_dgrad_plain(*dargs),
                  library_bwd([True, False, False]), 4 * t + wb + 3 * vec),
        "wgrad": (lambda: cb.conv3x3_wgrad_cuda(*wargs),
                  lambda: cb.conv3x3_wgrad_plain(*wargs),
                  library_bwd([False, True, True]),
                  3 * t + 2 * vec + 27 * c * c * 4 + c * 4),
    }
    flops = 2 * (x.numel() // c) * 27 * c * c
    out = {}
    for op, (run, plain, library, nbytes) in ops.items():
        before = cb.LAUNCHES[MMA[op]]
        got = run()
        torch.cuda.synchronize()
        mma = cb.LAUNCHES[MMA[op]] - before
        ref = plain()
        err = [float((a.float() - r.float()).abs().max())
               for a, r in zip(got, ref) if a is not None]
        again = run()
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / BF16_FLOP_PER_S * 1e3
        out[op] = {
            "route": "tensor cores" if mma else "CUDA cores",
            "max_abs_err": err,
            "two_calls_identical": all(
                a is None and r is None or torch.equal(a, r)
                for a, r in zip(got, again)),
            "sha256": _digest(got), "kernel": _both(run),
            "cudnn": _both(library), "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
        del got, again, ref
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_ring: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cb = _package(args.tree)
    res = {"card": card, "tree": args.tree or ".", "cases": {}}
    for label, b, dhw, c in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        res["cases"][f"B{b} {label}"] = cases = shape_cases(cb, b, dhw, c,
                                                            gen)
        print(f"B{b} {label}: " + "; ".join(
            f"{op} {v['route']} {v['kernel']['device_ms']:.4f} ms "
            f"(cuDNN {v['cudnn']['device_ms']:.4f}, bound "
            f"{v['bound_ms']:.4f}) err {max(v['max_abs_err']):.2e} same "
            f"{v['two_calls_identical']} {v['sha256']}"
            for op, v in cases.items()), flush=True)
        torch.cuda.empty_cache()
    line = json.dumps(res)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = f"_{args.tag}" if args.tag else ""
        Path(args.out, f"profile_ring{tag}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
