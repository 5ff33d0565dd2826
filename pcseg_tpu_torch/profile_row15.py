"""What holds rows 15 and 17's kernels above their bound, on one card.

    python -m pcseg_tpu_torch.profile_row15 [--out DIR]

At every shape of a B64 x 2048 PointNet train step (seeded random inputs,
bf16), for row 15 (``fused_block``, each layer) and row 17
(``fused_seg4_ce``, at 4 classes and at 13) it reports:

- each kernel's device time (torch.profiler over 10 calls), forward and
  backward;
- the host time of one wrapper call (the mean over 100 calls without a
  synchronize): back-to-back calls of an op whose kernels are shorter than
  this are bound by the host;
- row 15's forward without its statistics (``emit_stats=False``), the
  share of the epilogue's column sums;
- three variants of ``csrc/pointnet_chain.cu``, built next to the
  regular build with one of its ``-D`` hooks (nothing of the package uses
  them): ``split`` (``PCSEG_CHAIN_SWEEP=0``), every backward on the split
  kernels (cotangent, dx, dW), to time against the one sweep where that
  runs; ``cheap_hash`` (wrong masks, time only), the dropout bits taken
  from one multiply of the element index instead of the two mix32 rounds
  (the same keep share); and ``no_y_store`` (time only), the forward's y
  stores taken out, so that the hash's and the stores' cost show beside
  the real kernels'.

One JSON line at the end; with ``--out`` it is also written to
DIR/profile_row15.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from pcseg_tpu_torch.ops import _build
from pcseg_tpu_torch.ops import fused_block as fb
from pcseg_tpu_torch.ops import fused_ce as fc
from pcseg_tpu_torch.profile_serving import kernel_ms as profile_kernels

B, M, DROP = 64, 2048, 0.3
# (layer, cin, cout, normalize + relu prologue, dropout, row bias): the
# fused_block launches of one step (conv2 and conv3 share a shape)
LAYERS = [("conv1", 4, 64, False, 0.0, False),
          ("conv2/conv3", 64, 64, True, 0.0, False),
          ("conv4", 64, 128, True, 0.0, False),
          ("conv5", 128, 1024, True, 0.0, False),
          ("seg1", 64, 512, True, 0.0, True),
          ("seg2", 512, 256, True, DROP, False),
          ("seg3", 256, 128, True, DROP, False)]
# variant -> (the -D define of csrc/pointnet_chain.cu, its directions)
VARIANTS = {"split": ("PCSEG_CHAIN_SWEEP=0", ("bwd",)),
            "cheap_hash": ("PCSEG_CHAIN_CHEAP_HASH", ("fwd", "bwd")),
            "no_y_store": ("PCSEG_CHAIN_NO_Y_STORE", ("fwd",))}


def kernel_ms(fn) -> dict:
    return profile_kernels(fn, r"((?:chain|ce)_\w+)")


def host_ms(fn, iters: int = 100) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def cases():
    """(name, forward call, backward call) of every layer and of row 17."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = B * M

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def vectors(c):
        return [randn(c) * 0.2, torch.rand(c, generator=gen, device="cuda")
                + 0.5, randn(c), randn(c) * 0.2]

    out = []
    for name, cin, cout, norm, drop, has_rb in LAYERS:
        x = randn(n, cin).to(torch.bfloat16)
        bn = vectors(cin) if norm else [None] * 4
        w, b = randn(cin, cout) * cin ** -0.5, randn(cout) * 0.1
        rb = randn(B, cout) if has_rb else None
        rpb = M if has_rb else 0
        fwd = (x, *bn, w, b, rb, 7, norm, drop, True, rpb, torch.bfloat16)
        y = fb.fused_block_fwd_cuda(*fwd)[0]
        bwd = (x, *bn, w, y, randn(n, cout).to(torch.bfloat16),
               randn(cout) * 1e-2, randn(cout) * 1e-3, 7, norm, drop, rpb,
               has_rb)
        nostats = fwd[:11] + (False,) + fwd[12:]
        out.append((name, lambda f=fwd: fb.fused_block_fwd_cuda(*f),
                    lambda g=bwd: fb.fused_block_bwd_cuda(*g),
                    lambda f=nostats: fb.fused_block_fwd_cuda(*f)))
    x = randn(n, 128).to(torch.bfloat16)
    ct = torch.ones((), device="cuda")
    # row 17 at the main path's 4 classes (the backward on mma.sync) and
    # at 13 (on the FMA pass, which takes 9-32)
    for c, name in ((4, "seg4+CE"), (13, "seg4+CE 13 classes")):
        ce = (x, *vectors(128), randn(128, c) / 11, randn(c) * 0.1,
              torch.randint(-1, c, (n,), generator=gen, device="cuda"),
              torch.rand(c, generator=gen, device="cuda") + 0.5)
        out.append((name, lambda a=ce: fc.seg4_ce_fwd_cuda(*a),
                    lambda a=ce: fc.seg4_ce_bwd_cuda(*a, ct), None))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_row15 needs a CUDA device")
    card = torch.cuda.get_device_name(0)
    regular = _build.load_library("pointnet_chain")
    layers = cases()
    report = {"card": card, "shape": f"B{B} x {M}", "layers": {}}
    for name, fwd, bwd, nostats in layers:
        rec = {"fwd_kernels_ms": kernel_ms(fwd), "bwd_kernels_ms": kernel_ms(bwd),
               "fwd_host_ms": host_ms(fwd), "bwd_host_ms": host_ms(bwd)}
        if nostats is not None:
            rec["fwd_no_stats_ms"] = kernel_ms(nostats)
        report["layers"][name] = rec
    for variant, (define, directions) in VARIANTS.items():
        _build._LOADED["pointnet_chain"] = _build.build_variant(
            "pointnet_chain", f"row15_{variant}", defines=(define,))
        for name, fwd, bwd, _ in layers:
            rec = report["layers"][name]
            for d, fn in (("fwd", fwd), ("bwd", bwd)):
                if d in directions:
                    rec[f"{d}_{variant}_ms"] = kernel_ms(fn)
    _build._LOADED["pointnet_chain"] = regular
    for name, rec in report["layers"].items():
        print(f"[{card}] {name}: {json.dumps(rec)}", flush=True)
    line = json.dumps(report)
    print(line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_row15.json"), "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
