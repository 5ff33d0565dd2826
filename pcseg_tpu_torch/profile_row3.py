"""Where row 3's wgrad (the 3^3 conv's dW, csrc/conv3d_dgrad.cu
``wgrad_mma_kernel``) spends its time, on one card.

    python -m pcseg_tpu_torch.profile_row3 [--out DIR]

Builds variants of ``csrc/conv3d_dgrad.cu`` next to the regular build
(nothing of the package uses them), each with one part of the wgrad
changed:

- ``no_products``: the K loop's ldmatrix and mma taken out;
- ``no_formation``: the ring's and g''s formation for the planes after
  the first taken out (``put`` and ``form_g`` in the plane loop);
- ``no_loads_formation``: also the loads of those planes (``fetch`` and
  ``load_g``), so that only the products and the barriers are left;
- ``per_step_taps``: each fragment's tap, plane slot and shift worked out
  again every K step instead of once a plane;
- ``uncapped_table``: the depth ranges set by occupancy alone, the
  partial table no longer held within the bytes of the x and gy it
  reduces.

The first four give wrong results (time only); ``uncapped_table`` is
right and is held to the regular build's dW. Each runs at the voxel
step's three shapes (B8 64^3 x 16, 32^3 x 32, 16^3 x 64, the "act"
variant, seeded random inputs) beside the regular build, timed by device
time (torch.profiler over 20 calls: the kernel and its fixed-order sum),
with cuDNN's ``convolution_backward`` of the same weight gradient beside
them. One JSON line at the end; with ``--out`` it is also written to
DIR/profile_row3.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from pcseg_tpu_torch.ops import _build
from pcseg_tpu_torch.ops import conv3d_block as cb
from pcseg_tpu_torch.profile_serving import profile_calls

B = 8
SHAPES = ((64, 16), (32, 32), (16, 64))   # (grid R, channels C)

# the plane loop's lines each variant edits
_PRODUCTS = "    for (int r = 0; r < TH; ++r)\n      for (int cc = 0; cc < TW; cc += 16) {"
_FORMATION = ("    if (next) rs.put(d + 2, false);\n"
              "    if (d + 1 < d1) form_g(d + 1);\n")
_LOADS = ("    if (next) rs.fetch(d + 2);\n"
          "    if (d + 1 < d1) load_g(d + 1);\n")
_TAPS_START = "    uint32_t a_slot[TPW];"
_TAPS_END = "    const uint32_t g_u = smem_u32(sg + (d & 1) * Wg::kG);\n"
_CAP = "    nd = nd < most ? nd : most;\n"


def _variant(src: str, name: str) -> str:
    """The source of variant ``name``: the regular source with the
    wgrad's lines edited (each edit must find its line)."""
    head, sep, body = src.partition("wgrad_mma_kernel(const RingArgs p) {")

    def cut(text, old, new=""):
        if old not in text:
            raise RuntimeError(f"profile_row3: {name} found no {old!r}")
        return text.replace(old, new, 1)

    if name == "no_products":
        body = cut(body, _PRODUCTS, _PRODUCTS.replace("r < TH", "r < 0"))
    elif name in ("no_formation", "no_loads_formation"):
        body = cut(body, _FORMATION)
        if name == "no_loads_formation":
            body = cut(body, _LOADS)
    elif name == "per_step_taps":
        a = body.index(_TAPS_START)
        b = body.index(_TAPS_END)
        taps = body[a:b]
        body = body[:a] + body[b:]
        body = cut(body, _PRODUCTS, _PRODUCTS + "\n" + taps)
    elif name == "uncapped_table":
        body = cut(body, _CAP)
    return head + sep + body


VARIANTS = ("no_products", "no_formation", "no_loads_formation",
            "per_step_taps", "uncapped_table")


def _inputs(gen, r, c):
    x = torch.randn((B, r, r, r, c), generator=gen, device="cuda").to(
        torch.bfloat16)
    scale = torch.rand((B, c), generator=gen, device="cuda") + 0.5
    shift = torch.randn((B, c), generator=gen, device="cuda") * 0.3
    gy = torch.randn((B, r, r, r, c), generator=gen, device="cuda").to(
        torch.bfloat16)
    y = torch.randn((B, r, r, r, c), generator=gen, device="cuda").to(
        torch.bfloat16)
    gstats = torch.randn((B, 2, c), generator=gen, device="cuda") * 1e-2
    return x, scale, shift, gy, y, gstats, True


def _with(lib, fn):
    """``fn()`` with the wrappers loading ``lib`` as conv3d_dgrad (and its
    launch grid asked of it), then the regular library again."""
    saved = _build._LOADED.get("conv3d_dgrad")
    _build._LOADED["conv3d_dgrad"] = lib
    cb._ring_grid.cache_clear()
    try:
        return fn()
    finally:
        if saved is None:
            _build._LOADED.pop("conv3d_dgrad", None)
        else:
            _build._LOADED["conv3d_dgrad"] = saved
        cb._ring_grid.cache_clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_row3 needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip() or torch.cuda.get_device_name(0)
    src = (_build._CSRC / "conv3d_dgrad.cu").read_text()
    libs = {"regular": _build.load_library("conv3d_dgrad")}
    for name in VARIANTS:
        libs[name] = _build.build_variant(
            "conv3d_dgrad", f"row3_{name}", (), _variant(src, name))
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": card, "shapes": {}}
    for r, c in SHAPES:
        a = _inputs(gen, r, c)
        ref = cb.conv3x3_wgrad_cuda(*a)
        row = {}
        for name, lib in libs.items():
            grid = lib.pcseg_ring_grid(2, B, c, r, r, r)
            ms = _with(lib, lambda: profile_calls(
                lambda: cb.conv3x3_wgrad_cuda(*a), 20))
            row[name] = {"device_ms": sum(ms.values()), "blocks_x": grid,
                         "table_mb": B * grid * (27 * c * c + c) * 4 / 1e6}
            if name == "uncapped_table":
                got = _with(lib, lambda: cb.conv3x3_wgrad_cuda(*a))
                err = max(float((g - f).abs().max() / f.abs().max())
                          for g, f in zip(got, ref))
                if err > 1e-5:
                    raise AssertionError(f"uncapped_table disagrees: {err}")
                row[name]["rel_err_vs_regular"] = err
        wl = torch.randn((c, c, 3, 3, 3), generator=gen,
                         device="cuda").to(torch.bfloat16)
        x, gy = a[0].permute(0, 4, 1, 2, 3), a[3].permute(0, 4, 1, 2, 3)
        row["cudnn_device_ms"] = sum(profile_calls(
            lambda: torch.ops.aten.convolution_backward(
                gy, x, wl, [c], [1] * 3, [1] * 3, [1] * 3, False, [0] * 3,
                1, [False, True, True]), 20).values())
        key = f"B{B} {r}^3x{c}"
        out["shapes"][key] = row
        print(f"[{card}] {key}: " + ", ".join(
            f"{k} {v['device_ms']:.4f} ms (x blocks {v['blocks_x']}, table "
            f"{v['table_mb']:.1f} MB)" for k, v in row.items()
            if isinstance(v, dict)) + f"; cuDNN {row['cudnn_device_ms']:.4f}"
            " ms", flush=True)
    line = json.dumps(out)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_row3.json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
