"""Where a tile of row 16's wgmma kernels spends its time, on one card.

    python -m pcseg_tpu_torch.profile_row16 [--out DIR]

Builds two variants of ``csrc/pointnet_wgmma.cu`` next to the regular
build (nothing of the package uses them):

- ``phases``: the same kernels with a %globaltimer stamp, by each block's
  thread 0, at its start, its first full stage, the end of its mainloop,
  the end of the accumulator store and of its epilogue walk; per block and
  kernel (forward, dx) it reports the median and 90th percentile of each
  phase, and the gap between a block's end and the next block's start on
  the same SM;
- ``no_prologue``: the forward with the prologue taken out of its A
  fragments (the raw x goes to the tensor cores; wrong results, time
  only), so that the prologue's cost shows beside the real kernel's.

Both run at the main path's shape (B64 x 2048 points, 1024 -> 1024, bf16,
seeded random inputs) beside the regular library, each kernel timed by
device time (torch.profiler over 10 calls). One JSON line at the end;
with ``--out`` it is also written to DIR/profile_row16.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

import numpy as np
import torch

from pcseg_tpu_torch.ops import _build
from pcseg_tpu_torch.ops import fused_global as fg
from pcseg_tpu_torch.profile_serving import kernel_ms

GP = r"(gp_\w+)"  # row 16's kernels

B, M, C = 64, 2048, 1024
PHASES = ("fill", "mainloop", "store_acc", "walk")
# the stamps go to g_stamp[(kernel * 8192 + block) * 8 + index]; index 7
# holds the block's SM
_STAMP = ("if (threadIdx.x == 0) {{ unsigned long long t_; asm volatile("
          "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
          "g_stamp[({k} * 8192 + blockIdx.x) * 8 + {i}] = t_; }}")
_SMID = ("if (threadIdx.x == 0) {{ unsigned s_; asm volatile("
         "\"mov.u32 %0, %%smid;\" : \"=r\"(s_)); "
         "g_stamp[({k} * 8192 + blockIdx.x) * 8 + 7] = s_; }}")
# per kernel: (where to start looking, anchor, stamp index, stamp before the
# anchor's line)
_ANCHORS = {
    0: [("gp_wgmma_fwd_kernel(", "const int ksteps = p.cin / kBK;", 0, False),
        ("void fwd_step(", "mbar_wait(&full[s], (ks / kFwdStages) & 1);", 1,
         False),
        ("gp_wgmma_fwd_kernel(", "// the ring is free for the epilogue", 2,
         True),
        ("gp_wgmma_fwd_kernel(", "bar_sync(2 + wg, 128);", 3, False),
        ("gp_wgmma_fwd_kernel(", "atomicAdd(&p.s1[col], w.a1.x);", 4, True)],
    1: [("gp_wgmma_dx_kernel(", "const int ksteps = p.cout / kBK;", 0, False),
        ("gp_wgmma_dx_kernel(", "mbar_wait(&full[s], (ks / kDxStages) & 1);",
         1, False),
        ("gp_wgmma_dx_kernel(", "// the ring is free for the epilogue", 2,
         True),
        ("gp_wgmma_dx_kernel(", "bar_sync(2 + wg, 128);", 3, False),
        ("gp_wgmma_dx_kernel(", "atomicAdd(&p.dg[col], w.sg.x);", 4, True)],
}


def _insert(src: str, start: str, anchor: str, text: str,
            before: bool) -> str:
    """``text`` on its own line before or after the line of the first
    ``anchor`` after ``start``."""
    pos = src.index(anchor, src.index(start))
    line_start = src.rindex("\n", 0, pos) + 1
    at = line_start if before else src.index("\n", pos) + 1
    return src[:at] + text + "\n" + src[at:]


def phases_source(src: str) -> str:
    for k, anchors in _ANCHORS.items():
        for start, anchor, i, before in anchors:
            text = _STAMP.format(k=k, i=i)
            if i == 0:
                text += " " + _SMID.format(k=k)
            if i == 1:
                text = f"if (ks == 0) {{ {text} }}"
            src = _insert(src, start, anchor, text, before)
    src = src.replace('#include "hopper.cuh"\n', '#include "hopper.cuh"\n'
                      '__device__ unsigned long long g_stamp[2 * 8192 * 8];\n',
                      1)
    return src.replace('extern "C" {', 'extern "C" {\nint read_stamps(void* h) '
                       '{ return (int)cudaMemcpyFromSymbol(h, g_stamp, '
                       'sizeof(g_stamp)); }\n', 1)


def no_prologue_source(src: str) -> str:
    pos = src.index("f[kk][i] = pack_bf16x2(pro1(bf16_lo(r[i]), mu.x,")
    end = src.index(";", pos)
    # the vector loads stay alive, so that only the arithmetic goes
    return src[:pos] + ("f[kk][i] = r[i] ^ (uint32_t)(mu.x == 12345.f && "
                        "iv.y == ga.x && be.y == 0.f)") + src[end:]


def inputs():
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = B * M

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = randn(n, C).to(torch.bfloat16)
    bn = [randn(C) * 0.2, torch.rand(C, generator=gen, device="cuda") + 0.5,
          randn(C), randn(C) * 0.2]
    w = (torch.rand((C, C), generator=gen, device="cuda") * 2 - 1) / 32
    sign = torch.sign(randn(C))
    fwd = (x, *bn, w, randn(C) / 32, sign, M)
    y, _, _, _, idx = fg.global_pool_fwd_cuda(*fwd)
    bwd = (x, *bn, w, y, randn(C) * 1e-2, randn(C) * 1e-3, randn(B, C),
           idx, M)
    return fwd, bwd


def phase_table(lib, fwd, bwd) -> dict:
    _build._LOADED["pointnet_wgmma"] = lib
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    out = {}
    for k, (name, run) in enumerate((
            ("forward", lambda: fg.global_pool_fwd_cuda(*fwd)),
            ("dx", lambda: fg.global_pool_bwd_cuda(*bwd)))):
        run()
        run()
        torch.cuda.synchronize()
        buf = np.zeros(2 * 8192 * 8, np.uint64)
        if lib.read_stamps(buf.ctypes.data):
            raise RuntimeError("read_stamps failed")
        blocks = (B * M // 128) * (C // 256)
        st = buf.reshape(2, 8192, 8)[k, :blocks].astype(np.int64)
        t = (st[:, :5] - st[:, 0].min()) / 1e3  # us
        d = np.diff(t, axis=1)
        gaps = []
        for sm in np.unique(st[:, 7]):
            rows = np.where(st[:, 7] == sm)[0]
            rows = rows[np.argsort(t[rows, 0])]
            gaps += list(t[rows[1:], 0] - t[rows[:-1], 4])
        out[name] = {
            "span_us": float(t[:, 4].max()),
            **{ph: {"median_us": float(np.median(d[:, i])),
                    "p90_us": float(np.percentile(d[:, i], 90))}
               for i, ph in enumerate(PHASES)},
            "gap_us": {"median_us": float(np.median(gaps)),
                       "p90_us": float(np.percentile(gaps, 90))},
        }
        print(f"[{name}] span {out[name]['span_us']:.1f} us; per block "
              f"(median us): " + ", ".join(
                  f"{ph} {out[name][ph]['median_us']:.2f}"
                  for ph in (*PHASES, "gap_us")), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_row16 needs a CUDA device")
    card = torch.cuda.get_device_name(0)
    src = (_build._CSRC / "pointnet_wgmma.cu").read_text()
    regular = _build.load_library("pointnet_wgmma")
    fwd, bwd = inputs()
    report = {"card": card, "shape": f"B{B} x {M}, {C} -> {C}",
              "kernels_ms": kernel_ms(lambda: fg.global_pool_fwd_cuda(*fwd),
                                      GP)}
    report["kernels_ms"].update(
        kernel_ms(lambda: fg.global_pool_bwd_cuda(*bwd), GP))
    report["phases"] = phase_table(
        _build.build_variant("pointnet_wgmma", "row16_phases",
                             src=phases_source(src)), fwd, bwd)
    _build._LOADED["pointnet_wgmma"] = _build.build_variant(
        "pointnet_wgmma", "row16_no_prologue", src=no_prologue_source(src))
    report["forward_no_prologue_ms"] = kernel_ms(
        lambda: fg.global_pool_fwd_cuda(*fwd), GP)["gp_wgmma_fwd_kernel"]
    _build._LOADED["pointnet_wgmma"] = regular
    print(f"[{card}] kernels {json.dumps(report['kernels_ms'])}; forward "
          f"without the prologue {report['forward_no_prologue_ms']:.4f} ms",
          flush=True)
    line = json.dumps(report)
    print(line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_row16.json"), "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
