"""Rows 20 (backward), 9 and 8: the sparse U-Net's LayerNorm backward
(csrc/fused_ln.cu, ``bias_ln_relu_mask_bwd``) and the voxel head's
backward and forward (csrc/conv3d_block.cu, ``head_grid2_bwd``,
``head_grid2``), timed against their bounds and one PyTorch call of the
same function.

    python -m pcseg_tpu_torch.profile_lnhead [--tree DIR] [--out DIR]

Shapes, bf16 throughout:

- row 20's backward at the two LayerNorm widths of one sparse train step
  (chip_smoke.py's B8 x 8192 track events, seed 0, 64^3 in tiles of 8^3,
  capacities (64, 32)): level 0, 262,144 rows x 64, and level 1, 131,072
  x 128, each row active where its tile is real;
- rows 9 and 8 at the default voxel step's head, B8 64^3 x 16 -> 4, and
  at wider heads the JAX package's fused head takes: 20 and 40 classes on
  a 32^3 grid (16 channels) and C 128 -> 8 classes on a 32^3 grid (a
  checkout whose kernels refuse a width records the refusal).

For each: the op's device time (torch.profiler, every kernel of the call
summed, each kernel's share beside it) and its CUDA-event time around
back-to-back calls; max |err| against the plain version; whether two
calls give the same bits; the launches of row 20's vector route where the
checkout has one; the bound (the larger of the bytes it must move, each
input read once and each output written once, at 3.35 TB/s, and its
flops at 989 TFLOP/s bf16 / 67 TFLOP/s f32); and the library call:
``native_layer_norm_backward`` (which leaves out the mask, the ReLU and
the pre-bias) and, for the head's backward, its two bf16 products (``gy
@ W^T``, ``s^T @ gy``), for its forward the bf16 product of the activated
grid and the weights (``s @ W``). Row 8 also reports its plain version's
device time.

``--tree DIR`` imports ``pcseg_tpu_torch`` from the checkout at DIR (an
earlier commit unpacked with ``git archive``), as profile_blockconv.py
does, so that two versions are timed in one call, one process each.
``--variants`` (this checkout only) also times row 9 at each shape from
variant builds of ``csrc/conv3d_block.cu`` (``_build.build_variant``,
under ``build/pcseg_tpu_torch/lnhead_*``; nothing of the package loads
them), each with one part of ``head_bwd_kernel`` changed:

- ``no_products``: the mma products of dW and dbias taken out (wrong
  results: time only);
- ``ksplit_1``: one warp a (m, n) pair, each on every K step (right
  results, its sums in another order);
- ``two_stages``: a ring of 2 x / gy tiles instead of kHeadStages (right
  results, the same bits).

Each variant's max |d| from the regular build's outputs is reported.
Where the checkout's row 8 is the older one-thread-a-voxel kernel (it
launches ``head_fwd_launch<kHeadMaxNC>`` above 4 classes), ``--variants``
also times row 8 at its shapes from a build with
``head_fwd_launch<kHeadSlots>`` there (passes of 16 class slots, as its
comment says): the dispatch's share of its time apart from the design's;
this works with ``--tree`` too.

One JSON line at the end; with ``--out`` it is also written to
DIR/profile_lnhead[_<tag>].json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from pcseg_tpu_torch.profile_blockconv import _both, _package, levels

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
# row 20: (label, level, C); row 9: (label, B, R, C, NC)
LN_SHAPES = [("level 0", 0, 64), ("level 1", 1, 128)]
HEAD_SHAPES = [("B8 64^3x16->4", 8, 64, 16, 4),
               ("B8 32^3x16->20", 8, 32, 16, 20),
               ("B8 32^3x16->40", 8, 32, 16, 40),
               ("B8 32^3x128->8", 8, 32, 128, 8)]


def _bound(nbytes: float, flops: float, rate: float) -> tuple:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / rate * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def _same(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def ln_case(fl, active, c, gen) -> dict:
    import torch

    bf = torch.bfloat16
    active = active.reshape(-1)
    n = active.numel()
    x = (torch.randn((n, c), generator=gen, device="cuda") * 2).to(bf)
    pre = torch.randn((c,), generator=gen, device="cuda") * 0.1
    scale = torch.rand((c,), generator=gen, device="cuda") + 0.5
    bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
    g = torch.randn((n, c), generator=gen, device="cuda").to(bf)
    args = (x, pre, scale, bias, active, g, 1e-5)
    vec = fl.LAUNCHES.get("bias_ln_relu_mask_bwd_vec")
    got = fl.bias_ln_relu_mask_bwd(*args)
    torch.cuda.synchronize()
    vec = None if vec is None else fl.LAUNCHES[
        "bias_ln_relu_mask_bwd_vec"] - vec
    ref = fl.bias_ln_relu_mask_bwd_plain(*args)
    err = max(float((a.float() - r.float()).abs().max())
              for a, r in zip(got, ref))
    w, bb = scale.to(bf), bias.to(bf)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [c], w, bb, 1e-5)

    def library():
        return torch.ops.aten.native_layer_norm_backward(
            g, x, [c], mean, rstd, w, bb, [True, True, True])

    bound, by = _bound(3 * n * c * 2 + n + 6 * c * 4, 30 * n * c,
                       F32_FLOP_PER_S)
    return {"shape": f"{n}x{c} bf16", "active_rows": int(active.sum()),
            "vector_launches": vec, "max_abs_err": err,
            "two_calls_identical": _same(got, fl.bias_ln_relu_mask_bwd(*args)),
            "kernel": _both(lambda: fl.bias_ln_relu_mask_bwd(*args)),
            "library": _both(library), "bound_ms": bound, "bound_by": by}


def head_case(cb, b, r, c, nc, gen) -> dict:
    import torch

    bf = torch.bfloat16
    x = torch.randn((b, r, r, r, c), generator=gen, device="cuda").to(bf)
    w = torch.rand((1, 1, 1, c, nc), generator=gen, device="cuda") - 0.5
    scale = torch.rand((b, c), generator=gen, device="cuda") + 0.5
    shift = torch.randn((b, c), generator=gen, device="cuda") * 0.3
    gy = torch.randn((b, r, r, r, nc), generator=gen, device="cuda").to(bf)
    args = (x, gy, w, scale, shift)
    got = cb.head_grid2_bwd_cuda(*args)
    torch.cuda.synchronize()
    ref = cb.head_grid2_bwd_plain(*args)
    err = max(float((a.float() - p.float()).abs().max())
              for a, p in zip(got, ref))
    n = b * r ** 3
    a = cb.act(x, scale, shift).reshape(n, c)
    wq = w.reshape(c, nc).to(bf)
    g = gy.reshape(n, nc)
    # x and gy read, dx written, the weights, scale and shift read, dW,
    # dbias and dstats written; two products of n c nc multiply-adds
    bound, by = _bound(n * c * 2 * 2 + n * nc * 2 + c * nc * 4
                       + 2 * b * c * 4 + 2 * b * c * 4 + c * nc * 4
                       + nc * 4, 4 * n * c * nc, BF16_FLOP_PER_S)
    return {"shape": f"B{b} {r}^3x{c}->{nc} bf16", "max_abs_err": err,
            "two_calls_identical": _same(got, cb.head_grid2_bwd_cuda(*args)),
            "kernel": _both(lambda: cb.head_grid2_bwd_cuda(*args)),
            "library": _both(lambda: (g @ wq.t(), a.t() @ g)),
            "bound_ms": bound, "bound_by": by}


def head_fwd_inputs(b, r, c, nc, gen):
    import torch

    x = torch.randn((b, r, r, r, c), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.rand((1, 1, 1, c, nc), generator=gen, device="cuda") - 0.5
    bias = torch.randn((nc,), generator=gen, device="cuda") * 0.1
    scale = torch.rand((b, c), generator=gen, device="cuda") + 0.5
    shift = torch.randn((b, c), generator=gen, device="cuda") * 0.3
    return x, w, bias, scale, shift


def head_fwd_case(cb, b, r, c, nc, gen) -> dict:
    """Row 8: device and op ms, max |err| against the plain version and
    whether every element is within one bf16 step of it (2^-7 |ref| +
    1e-4 max |ref|), two calls bit for bit, the bound (x read, y written,
    the weights, bias, scale and shift read; 2 n c nc flops bf16), the
    plain version's device ms and one bf16 matmul of the activated grid."""
    import torch

    args = head_fwd_inputs(b, r, c, nc, gen)
    got = cb.head_grid2_cuda(*args)
    torch.cuda.synchronize()
    ref = cb.head_grid2_plain(*args).float()
    d = (got.float() - ref).abs()
    n = b * r ** 3
    a = cb.act(*args[:1], *args[3:]).reshape(n, c)
    wq = args[1].reshape(c, nc).to(torch.bfloat16)
    bound, by = _bound(n * c * 2 + n * nc * 2 + c * nc * 4 + nc * 4
                       + 2 * b * c * 4, 2 * n * c * nc, BF16_FLOP_PER_S)
    return {"shape": f"B{b} {r}^3x{c}->{nc} bf16",
            "max_abs_err": float(d.max()),
            "within_bf16_step": bool((d <= 2.0 ** -7 * ref.abs()
                                      + 1e-4 * ref.abs().max()).all()),
            "two_calls_identical": bool(torch.equal(
                got, cb.head_grid2_cuda(*args))),
            "kernel": _both(lambda: cb.head_grid2_cuda(*args)),
            "plain": _both(lambda: cb.head_grid2_plain(*args)),
            "library": _both(lambda: a @ wq),
            "bound_ms": bound, "bound_by": by}


# the line of csrc/conv3d_block.cu the row-8 variant edits (present only
# in a checkout whose forward is the older one-thread-a-voxel kernel)
_FWD_VARIANT_EDITS = {
    "slots16": (("head_fwd_launch<kHeadMaxNC>(",
                 "head_fwd_launch<kHeadSlots>("),),
}


def head_fwd_variants(cb, gen) -> dict:
    """Row 8 at HEAD_SHAPES from each applicable variant build beside the
    regular one: device ms, and max |d| from the regular build's y."""
    import torch

    from pcseg_tpu_torch.ops import _build

    src = (_build._CSRC / "conv3d_block.cu").read_text()
    libs = {"regular": _build.load_library("conv3d_block")}
    for name, edits in _FWD_VARIANT_EDITS.items():
        if not all(old in src for old, _ in edits):
            continue
        text = src
        for old, new in edits:
            text = text.replace(old, new, 1)
        libs[name] = _build.build_variant("conv3d_block", f"lnhead_{name}",
                                          (), text)
    if len(libs) == 1:
        return {}
    out = {}
    for label, b, r, c, nc in HEAD_SHAPES:
        args = head_fwd_inputs(b, r, c, nc, gen)
        row, ref = {}, None
        for name, lib in libs.items():
            saved = _build._LOADED["conv3d_block"]
            _build._LOADED["conv3d_block"] = lib
            try:
                got = cb.head_grid2_cuda(*args)
                row[name] = {"kernel": _both(
                    lambda: cb.head_grid2_cuda(*args))}
            finally:
                _build._LOADED["conv3d_block"] = saved
            if ref is None:
                ref = got
            row[name]["max_abs_d_vs_regular"] = float(
                (got.float() - ref.float()).abs().max())
        out[label] = row
    return out


# the lines of csrc/conv3d_block.cu each row-9 variant edits
_VARIANT_EDITS = {
    "no_products": (("    if (it > 0) products(sb ^ 1);\n", ""),
                    ("  if (it > 0) products((it - 1) & 1);\n", "")),
    "ksplit_1": (("  p->ksplit = pairs < kHeadWarps ? kHeadWarps / pairs : 1;",
                  "  p->ksplit = 1;"),),
    "two_stages": (("constexpr int kHeadStages = 4;",
                    "constexpr int kHeadStages = 2;"),),
}


def head_variants(cb, gen) -> dict:
    """Row 9 at HEAD_SHAPES from each variant build beside the regular
    one: device ms, and max |d| from the regular build's outputs."""
    import torch

    from pcseg_tpu_torch.ops import _build

    src = (_build._CSRC / "conv3d_block.cu").read_text()
    libs = {"regular": _build.load_library("conv3d_block")}
    for name, edits in _VARIANT_EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"profile_lnhead: {name} found no {old!r}")
            text = text.replace(old, new, 1)
        libs[name] = _build.build_variant("conv3d_block", f"lnhead_{name}",
                                          (), text)
    out = {}
    for label, b, r, c, nc in HEAD_SHAPES:
        bf = torch.bfloat16
        x = torch.randn((b, r, r, r, c), generator=gen, device="cuda").to(bf)
        w = torch.rand((1, 1, 1, c, nc), generator=gen, device="cuda") - 0.5
        scale = torch.rand((b, c), generator=gen, device="cuda") + 0.5
        shift = torch.randn((b, c), generator=gen, device="cuda") * 0.3
        gy = torch.randn((b, r, r, r, nc), generator=gen,
                         device="cuda").to(bf)
        args = (x, gy, w, scale, shift)
        row, ref = {}, None
        for name, lib in libs.items():
            saved = _build._LOADED["conv3d_block"]
            _build._LOADED["conv3d_block"] = lib
            try:
                got = cb.head_grid2_bwd_cuda(*args)
                row[name] = {"kernel": _both(
                    lambda: cb.head_grid2_bwd_cuda(*args))}
            finally:
                _build._LOADED["conv3d_block"] = saved
            if ref is None:
                ref = got
            row[name]["max_abs_d_vs_regular"] = max(
                float((a.float() - p.float()).abs().max())
                for a, p in zip(got, ref))
        out[label] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_lnhead: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _, bsp, track_events = _package(args.tree)
    # after _package, the package (and these modules) come from the tree
    from pcseg_tpu_torch.ops import conv3d_block as cb
    from pcseg_tpu_torch.ops import fused_ln as fl

    tiles = levels(bsp, track_events)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"card": card, "tree": args.tree or ".", "ln_bwd": {},
           "head_bwd": {}, "head_fwd": {}}
    for label, lv, c in LN_SHAPES:
        res["ln_bwd"][label] = ln_case(fl, tiles[lv].active, c, gen)
    for label, b, r, c, nc in HEAD_SHAPES:
        try:
            res["head_bwd"][label] = head_case(cb, b, r, c, nc, gen)
        except (ValueError, RuntimeError) as err:   # a checkout before
            res["head_bwd"][label] = {"refused": str(err)}   # the repair
    for label, b, r, c, nc in HEAD_SHAPES:
        try:
            res["head_fwd"][label] = head_fwd_case(cb, b, r, c, nc, gen)
        except (ValueError, RuntimeError) as err:
            res["head_fwd"][label] = {"refused": str(err)}
    if args.variants:
        if not args.tree:
            res["head_bwd_variants"] = head_variants(cb, gen)
        res["head_fwd_variants"] = head_fwd_variants(cb, gen)
    line = json.dumps(res)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = f"_{args.tag}" if args.tag else ""
        Path(args.out, f"profile_lnhead{tag}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
