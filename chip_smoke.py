#!/usr/bin/env python3
"""Drive the pcseg_tpu_torch port on one CUDA card and check it.

    python3 chip_smoke.py

1. Builds the CUDA kernels from pcseg_tpu_torch/csrc/ (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch version at every shape the
   serving path launches (batch 8, 64^3 grid, widths 16/32/64), and times
   kernel, plain version and one cuDNN call of the same convolution
   (a yardstick only: the port never calls it).
3. Serves the voxel U-Net at full width (64^3, w16, 3 levels, 4 classes,
   bf16, scatter voxelize, gather devoxelize, seeded random weights)
   through Predictor.predict_batch (16 events, 4000-8192 points: two
   forwards of 8 at bucket 8192) and Predictor.predict (one 1000-point
   event, bucket 1024). Checks that every kernel launched 13 / 2 / 2 times
   per forward and that the logits are finite and match the same model
   run through the plain versions on the card.
4. Prints the kernels as one JSON line, the card's name and power limit,
   and as the last line {"ok": true, "device": {...}}.

Exits non-zero, without the last line, when there is no CUDA device or
any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak
SOURCE = "pcseg_tpu_torch/csrc/conv3d_block.cu"
REPLACES = {
    "conv3x3_gn_act": "pcseg_tpu/ops/pallas/conv3d_block.py:429",
    "down2x_gn_act": "pcseg_tpu/ops/pallas/conv3d_block.py:1318",
    "up2x_gn_act": "pcseg_tpu/ops/pallas/conv3d_block.py:1403",
}
PER_FORWARD = {"conv3x3_gn_act": 13, "down2x_gn_act": 2, "up2x_gn_act": 2}
# tolerances, kernel vs plain version on identical inputs:
# y is bf16 from f32 sums taken in another order, so an element may round
# to the neighbouring bf16 value: |dy| <= 2^-7 |y| + 1e-4 max|y|.
Y_RTOL, Y_ATOL_REL = 2.0 ** -7, 1e-4
# stats are f32 sums of 10^5-10^6 terms in another order (and with
# atomics): |ds| <= 1e-3 of the largest |s| of its (batch, sum|sumsq) row.
STATS_TOL = 1e-3
# end-to-end logits: a one-ulp bf16 flip (2^-8 relative) in an early
# layer's y propagates through the 17 layers after it, so the logits are
# held to a few bf16 ulps of their own scale, |d| <= 4 * 2^-8 * max|ref|,
# and the argmax may change only at near-ties (>= 99.9% agreement).
LOGITS_REL, ARGMAX_AGREE = 4 * 2.0 ** -8, 0.999


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 10) -> float:
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


def kernel_cases():
    """(kernel, label, b, r, cin, cout, kwargs) at every shape the
    serving path launches."""
    cases = []
    for r, c in ((64, 16), (32, 32), (16, 64)):
        cases.append(("conv3x3_gn_act", "act", 8, r, c, c, {}))
        cases.append(("conv3x3_gn_act", "act+accum", 8, r, c, c,
                      {"accum": True}))
    cases.append(("conv3x3_gn_act", "stem", 8, 64, 16, 16,
                  {"activate": False}))
    cases.append(("conv3x3_gn_act", "no-stats", 8, 64, 16, 16,
                  {"want_stats": False}))
    cases.append(("conv3x3_gn_act", "no-stats", 8, 32, 32, 32,
                  {"want_stats": False}))
    cases.append(("down2x_gn_act", "act", 8, 64, 16, 32, {}))
    cases.append(("down2x_gn_act", "act", 8, 32, 32, 64, {}))
    cases.append(("up2x_gn_act", "act", 8, 16, 64, 32, {}))
    cases.append(("up2x_gn_act", "act", 8, 32, 32, 16, {}))
    return cases


def run_case(kernel, label, b, r, cin, cout, kw, gen):
    import torch
    import torch.nn.functional as F

    from pcseg_tpu_torch.ops import conv3d_block as cb

    dev = "cuda"
    k = 3 if kernel == "conv3x3_gn_act" else 2
    x = torch.randn((b, r, r, r, cin), generator=gen, device=dev).to(
        torch.bfloat16)
    bound = (6.0 / (k ** 3 * cin)) ** 0.5
    w = (torch.rand((k, k, k, cin, cout), generator=gen, device=dev) * 2
         - 1) * bound
    bias = torch.randn((cout,), generator=gen, device=dev) * 0.1
    scale = torch.rand((b, cin), generator=gen, device=dev) * 0.6 + 0.7
    shift = torch.randn((b, cin), generator=gen, device=dev) * 0.3
    activate = kw.get("activate", True)
    want_stats = kw.get("want_stats", True)
    accum = None
    ro = {"conv3x3_gn_act": r, "down2x_gn_act": r // 2,
          "up2x_gn_act": 2 * r}[kernel]
    if kw.get("accum"):
        accum = torch.randn((b, ro, ro, ro, cout), generator=gen,
                            device=dev).to(torch.bfloat16)

    if kernel == "conv3x3_gn_act":
        def run():
            return cb.conv3x3_gn_act(x, w, bias, scale, shift, accum,
                                     activate=activate, want_stats=want_stats)

        def plain():
            return cb.conv3x3_gn_act_plain(
                x, w, bias, scale, shift, accum, activate=activate,
                want_stats=want_stats)

        wl = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2)

        def library():
            return F.conv3d(x.permute(0, 4, 1, 2, 3), wl, padding=1)
        taps = 27
    elif kernel == "down2x_gn_act":
        def run():
            return cb.down2x_gn_act(x, w, bias, scale, shift)

        def plain():
            return cb.down2x_gn_act_plain(x, w, bias, scale, shift)

        wl = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2)

        def library():
            return F.conv3d(x.permute(0, 4, 1, 2, 3), wl, stride=2)
        taps = 8
    else:
        def run():
            return cb.up2x_gn_act(x, w, bias, scale, shift)

        def plain():
            return cb.up2x_gn_act_plain(x, w, bias, scale, shift)

        wl = w.to(torch.bfloat16).flip(0, 1, 2).permute(3, 4, 0, 1, 2)

        def library():
            return F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), wl, stride=2)
        taps = 1

    y_k, st_k = run()
    torch.cuda.synchronize()
    y_p, st_p = plain()
    yk, yp = y_k.float(), y_p.float()
    if y_k.shape != y_p.shape or not torch.isfinite(yk).all():
        raise AssertionError(f"{kernel} {label}: bad output shape or values")
    dy = (yk - yp).abs()
    y_err = float(dy.max())
    ymax = float(yp.abs().max())
    y_ok = bool((dy <= Y_RTOL * yp.abs() + Y_ATOL_REL * ymax).all())
    st_err = 0.0
    st_ok = True
    if want_stats:
        denom = st_p.abs().amax(dim=2, keepdim=True).clamp(min=1e-30)
        rel = ((st_k - st_p).abs() / denom)
        st_err = float(rel.max())
        st_ok = st_err <= STATS_TOL
    elif st_k is not None:
        raise AssertionError(f"{kernel} {label}: stats returned unasked")

    ms = time_ms(run)
    plain_ms = time_ms(plain)
    library_ms = time_ms(library)
    nbytes = (x.numel() * 2 + w.numel() * 2 + cout * 4 + y_k.numel() * 2
              + (2 * b * cin * 4 if activate else 0)
              + (accum.numel() * 2 if accum is not None else 0)
              + (2 * b * cout * 4 if want_stats else 0))
    flops = 2 * y_k.numel() * cin * taps
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    res = {
        "name": kernel, "case": label,
        "shape": f"B{b} {r}^3x{cin}->{ro}^3x{cout}",
        "max_abs_err": y_err, "max_rel_err": y_err / max(ymax, 1e-30),
        "stats_rel_err": st_err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }
    ok = y_ok and st_ok
    print(f"  {'ok ' if ok else 'BAD'} {kernel:15s} {res['shape']:22s} "
          f"{label:10s} y max|err| {y_err:.3e} (rel {res['max_rel_err']:.2e})"
          f"  stats rel {st_err:.2e}  kernel {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  cuDNN {library_ms:.4f} ms  bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']})", flush=True)
    if not ok:
        raise AssertionError(
            f"{kernel} {label} {res['shape']}: kernel disagrees with its "
            f"plain version (y err {y_err}, stats rel err {st_err})")
    return res


def serve(card: str):
    import numpy as np
    import torch

    from pcseg_tpu_torch.data.batching import pad_events
    from pcseg_tpu_torch.data.synthetic import synthetic_events
    from pcseg_tpu_torch.infer import Predictor
    from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d
    from pcseg_tpu_torch.ops import conv3d_block as cb

    model = VoxelUNet3d(
        num_classes=4, grid_size=64, width=16, levels=3,
        compute_dtype="bfloat16", conv_impl="fused", voxelize_impl="scatter",
        devox_impl="gather", generator=torch.Generator().manual_seed(0),
    )
    pred = Predictor(model.state_dict(), 4, model=model)
    events = [p for p, _ in synthetic_events(
        16, min_points=4000, max_points=8192, seed=0)]
    single = next(iter(synthetic_events(
        1, min_points=1000, max_points=1000, seed=1)))[0]
    n_batch_pts = sum(e.shape[0] for e in events)

    torch.cuda.reset_peak_memory_stats()
    cb.reset_launches()
    t0 = time.perf_counter()
    preds = pred.predict_batch(events, batch_size=8)
    t1 = time.perf_counter()
    p_single = pred.predict(single)
    t2 = time.perf_counter()
    launches = dict(cb.LAUNCHES)
    forwards = 3
    expected = {k: v * forwards for k, v in PER_FORWARD.items()}
    print(f"  main path: {forwards} forwards, launches {launches} "
          f"(expected {expected})", flush=True)
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    if [p.shape[0] for p in preds] != [e.shape[0] for e in events] or \
            p_single.shape != (single.shape[0],):
        raise AssertionError("prediction shapes do not match the events")
    first = {"batch_ms": (t1 - t0) * 1e3, "single_ms": (t2 - t1) * 1e3}

    reps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_batch(events, batch_size=8)
        t1 = time.perf_counter()
        pred.predict(single)
        t2 = time.perf_counter()
        reps.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
    batch_ms = sorted(r[0] for r in reps)[1]
    single_ms = sorted(r[1] for r in reps)[1]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # kernels vs plain versions through the whole model, one batch of 8
    pts, _, msk = pad_events(
        [(e, np.zeros(e.shape[0], np.int64)) for e in events[:8]], 8192,
        batch_size=8)
    points = torch.from_numpy(pts).cuda()
    mask = torch.from_numpy(msk).cuda()
    out_k = model(points, mask)
    out_p = model(points, mask, plain=True)
    if out_k.shape != (8, 8192, 4) or not torch.isfinite(out_k).all():
        raise AssertionError(f"logits: shape {tuple(out_k.shape)} or "
                             "non-finite values")
    d = (out_k - out_p).abs()
    err = float(d.max())
    scale = float(out_p.abs().max())
    agree = float((out_k.argmax(-1) == out_p.argmax(-1))[mask].float()
                  .mean())
    ok = err <= LOGITS_REL * scale and agree >= ARGMAX_AGREE
    print(f"  logits kernels vs plain on the card: max|err| {err:.4e} "
          f"(max|logit| {scale:.3f}; tol {LOGITS_REL * scale:.4f}), argmax "
          f"agreement {agree:.6f} (tol {ARGMAX_AGREE})", flush=True)
    if not ok:
        raise AssertionError(f"logits disagree with the plain model: max "
                             f"err {err}, argmax agreement {agree}")
    res = {
        "first_call": first,
        "predict_batch_16_ms": batch_ms,
        "ms_per_event_batched": batch_ms / len(events),
        "points_per_s_batched": n_batch_pts / (batch_ms / 1e3),
        "predict_1000pt_ms": single_ms,
        "peak_mem_gib": peak_gib,
        "logits_max_abs_err": err,
        "argmax_agreement": agree,
        "card": card,
    }
    print(f"  serving [{card}]: predict_batch(16 events, {n_batch_pts} pts) "
          f"{batch_ms:.2f} ms = {res['ms_per_event_batched']:.2f} ms/event, "
          f"{res['points_per_s_batched']:.4e} points/s; predict(1000 pts) "
          f"{single_ms:.2f} ms; first calls {first['batch_ms']:.2f} / "
          f"{first['single_ms']:.2f} ms; peak {peak_gib:.3f} GiB",
          flush=True)
    return launches, res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pcseg_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    _build.load_library()
    print(f"[1] build: {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"[2] kernels vs plain versions [{card}]", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [run_case(*c, gen) for c in kernel_cases()]

    print(f"[3] serving [{card}]", flush=True)
    launches, served = serve(card)

    main_case = {
        "conv3x3_gn_act": ("act", "B8 64^3x16->64^3x16"),
        "down2x_gn_act": ("act", "B8 64^3x16->32^3x32"),
        "up2x_gn_act": ("act", "B8 32^3x32->64^3x16"),
    }
    kernels = []
    for name, (label, shape) in main_case.items():
        mine = [c for c in cases if c["name"] == name]
        at = next(c for c in mine if c["case"] == label and c["shape"] == shape)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "shape": shape,
        })
    print(json.dumps({"cases": cases, "serving": served}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
