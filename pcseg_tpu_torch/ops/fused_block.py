"""Fused [normalize -> ReLU -> dropout -> matmul -> stats] block: a CUDA
kernel + its plain version, forward and backward.

Counterpart of pcseg_tpu/ops/pallas/fused_block.py (``fused_block``). Op
contract, one layer of the PointNet training chain (x the previous
layer's raw bf16 output, N rows):

    x_hat  = (x - mu) * inv                # BN with GIVEN batch stats
    z      = x_hat * gamma + beta
    a      = bf16(dropout(relu(z)))        # prologue in f32
    y      = a @ W + b [+ row_bias[row // rows_per_batch]]   # f32 sums
    s1, s2 = column sums of y and y^2      # from the f32 y
    y is stored in ``out_dtype`` (bf16, or f32 for a logits layer)

``mu``/``inv`` are inputs: the caller computes them from the previous
layer's (s1, s2) in differentiable glue, so autograd carries the
batch-statistics gradient and the op's backward handles fixed-stats
normalization only. It returns ``dx`` (x's dtype), ``dW`` and ``db``
(f32), ``dgamma_like = colsum(dz * x_hat)``, ``dbeta_like = colsum(dz)``,
``d(row_bias)`` (per batch row), and the stats-input cotangents
``dmu = -gamma * inv * dbeta_like``, ``dinv = gamma * dgamma_like / inv``.
The cotangent of y is ``dy_eff = (dy + ds1) + 2 * y_bf16 * ds2``, rounded
to bf16 for both backward products. Dropout masks are regenerated from
the seed (ops/dropout.py), nothing is stored.

``fused_block`` runs the CUDA kernels (csrc/pointnet_chain.cu) on CUDA
tensors and the plain version on CPU tensors (or when ``plain=True``, the
on-card reference). The plain version keeps the kernels' rounding points,
so the two agree up to f32 summation order. On the card a width takes one
of three routes (``route_of``): TMA + wgmma kernels for widths that are
multiples of 64 (one launch forward; backward one sweep where a block's
dW partial fits in registers, else three launches: the bf16 cotangent, dx,
dW), and CUDA-core kernels for conv1 (any other Cin, Cout 64, 128 or
256) and the logits layer (Cin 128, Cout 1..128), one launch each way; any
other width raises ValueError before the library loads.
"""

from __future__ import annotations

import functools

import torch

from pcseg_tpu_torch.ops._build import (
    load_library,
    on_cuda,
    ptr,
    raise_on,
    stream_of,
)
from pcseg_tpu_torch.ops.dropout import keep_mask, seed_key, threshold

# launches since the last reset; each wrapper adds one where it launches
# its kernel entry and nowhere else
LAUNCHES = {"fused_block": 0, "fused_block_bwd": 0}
# the logits layer's and the classifier + CE's widest class count (the JAX
# fused_seg4_ce's LANES, pcseg_tpu/ops/pallas/fused_ce.py:38)
MAX_CLASSES = 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# helpers shared with fused_global.py and fused_ce.py
# ---------------------------------------------------------------------------

def check(name, t, shape, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if not t.is_cuda:
        raise ValueError(f"{name} is on {t.device}, expected a CUDA device")


def f32_vec(v, c, name):
    if v.dtype == torch.float32 and v.shape == (c,) and v.is_contiguous() \
            and v.is_cuda:  # as it comes on the main path: no conversion
        return v
    out = v.float().contiguous()
    check(name, out, (c,), torch.float32)
    return out


def norm_vecs(mu, inv, gamma, beta, cin):
    """The prologue's four (Cin,) f32 vectors checked for a launch, or
    four Nones where there is no normalize prologue."""
    if mu is None:
        return None, None, None, None
    return tuple(f32_vec(v, cin, name) for v, name in
                 ((mu, "mu"), (inv, "inv"), (gamma, "gamma"), (beta, "beta")))


def prologue_plain(x, mu, inv, gamma, beta, relu, seed, drop_rate):
    """(x_hat, z, a f32-of-bf16, drop multiplier or None) in f32."""
    xf = x.float()
    if mu is not None:
        x_hat = (xf - mu) * inv
        z = x_hat * gamma + beta
    else:
        x_hat = z = xf
    a = torch.relu(z) if relu else z
    dmask = None
    if drop_rate > 0.0:
        scale = 1.0 / (1.0 - drop_rate)
        keep = keep_mask(seed, drop_rate, z.shape, z.device)
        zero = torch.zeros((), dtype=torch.float32, device=z.device)
        a = torch.where(keep, a * scale, zero)
        dmask = torch.where(keep, torch.full((), scale, device=z.device),
                            zero)
    return x_hat, z, a.to(torch.bfloat16).float(), dmask


def dz_plain(da, z, relu, dmask):
    if dmask is not None:
        da = da * dmask
    if relu:
        da = da * (z > 0.0).float()
    return da


def stats_cotangents(gamma, inv, dg_like, dbeta_like):
    """dmu, dinv from the gamma/beta-like sums (fused_block.py:530-531)."""
    return -gamma * inv * dbeta_like, gamma * dg_like / inv


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fused_block_fwd_plain(x, mu, inv, gamma, beta, w, b, row_bias, seed,
                          relu, drop_rate, emit_stats, rows_per_batch,
                          out_dtype):
    _, _, a, _ = prologue_plain(x, mu, inv, gamma, beta, relu, seed,
                                drop_rate)
    y = a @ w.to(torch.bfloat16).float() + b
    if row_bias is not None:
        y = y + row_bias.repeat_interleave(rows_per_batch, dim=0)
    s1 = s2 = None
    if emit_stats:
        s1, s2 = y.sum(0), (y * y).sum(0)
    return y.to(out_dtype), s1, s2


def fused_block_bwd_plain(x, mu, inv, gamma, beta, w, y, dy, ds1, ds2,
                          seed, relu, drop_rate, rows_per_batch,
                          has_row_bias):
    """-> (dx, dw, db, dg_like|None, dbeta_like|None, drb|None)."""
    d = dy.float()
    if ds1 is not None:
        d = (d + ds1) + 2.0 * y.float() * ds2
    db = d.sum(0)
    drb = None
    if has_row_bias:
        drb = d.reshape(-1, rows_per_batch, d.shape[1]).sum(1)
    d_b = d.to(torch.bfloat16).float()
    x_hat, z, a, dmask = prologue_plain(x, mu, inv, gamma, beta, relu, seed,
                                        drop_rate)
    wf = w.to(torch.bfloat16).float()
    dw = a.t() @ d_b
    dz = dz_plain(d_b @ wf.t(), z, relu, dmask)
    if mu is None:
        return dz.to(x.dtype), dw, db, None, None, drb
    dg = (dz * x_hat).sum(0)
    dbeta = dz.sum(0)
    dx = (dz * gamma * inv).to(x.dtype)
    return dx, dw, db, dg, dbeta, drb


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def route_of(cin: int, cout: int) -> str:
    """The kernel a width takes on a CUDA tensor (csrc/pointnet_chain.cu
    route_of, the same rule; the first that takes it): "wgmma" for Cin and
    Cout multiples of 64, up to 512 and 1024; "simt" for conv1 (any other
    Cin >= 1, Cout 64, 128 or 256); "narrow" for the logits layer (Cin
    128, Cout 1..128). Any other width raises ValueError, before the
    library is built or loaded."""
    if 0 < cin <= 512 and 0 < cout <= 1024 and cin % 64 == 0 \
            and cout % 64 == 0:
        return "wgmma"
    if cin >= 1 and cout in (64, 128, 256):
        return "simt"
    if cin == 128 and 1 <= cout <= MAX_CLASSES:
        return "narrow"
    raise ValueError(
        f"fused_block on a CUDA tensor takes Cin and Cout multiples of 64 up "
        f"to 512 and 1024, any Cin with Cout 64, 128 or 256, or Cin 128 with "
        f"Cout 1..{MAX_CLASSES}; got {cin} -> {cout}")


def w_operand(w, cin, cout):
    """W as the kernels take it: f32 or bf16, contiguous (they round it to
    bf16 themselves; the wgmma route into a permuted copy, the others as
    they stage it). Returns (w, 1 if f32 else 0)."""
    if w.dtype not in (torch.float32, torch.bfloat16) or \
            not w.is_contiguous():
        w = w.float().contiguous()
    check("w", w, (cin, cout), w.dtype)
    return w, int(w.dtype == torch.float32)


@functools.lru_cache(maxsize=None)
def _bwd_split(lib, cin, cout, dy_f32, row_bias) -> int:
    """1 where the library runs the wgmma backward as split kernels (they
    need the d and a scratch), 0 where it runs the one sweep."""
    return lib.pcseg_chain_bwd_split(cin, cout, dy_f32, row_bias)


def _drop_args(seed, drop_rate):
    if drop_rate > 0.0:
        return seed_key(seed), threshold(drop_rate), 1.0 / (1.0 - drop_rate), 1
    return 0, 0, 1.0, 0


def _checked_row_bias(row_bias, n, rows_per_batch, cout, route):
    if row_bias is None:
        return None
    if route != "wgmma":
        raise ValueError("fused_block takes a row bias only at widths that "
                         "are multiples of 64")
    if rows_per_batch <= 0 or n % rows_per_batch:
        raise ValueError(f"N={n} is not a multiple of rows_per_batch="
                         f"{rows_per_batch}")
    rb = row_bias.float().contiguous()
    check("row_bias", rb, (n // rows_per_batch, cout), torch.float32)
    return rb


def fused_block_fwd_cuda(x, mu, inv, gamma, beta, w, b, row_bias, seed,
                         relu, drop_rate, emit_stats, rows_per_batch,
                         out_dtype):
    n, cin = x.shape
    cout = w.shape[1]
    route = route_of(cin, cout)
    check("x", x, (n, cin), torch.bfloat16)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    wk, w_f32 = w_operand(w, cin, cout)
    bf = f32_vec(b, cout, "b")
    norm = norm_vecs(mu, inv, gamma, beta, cin)
    rb = _checked_row_bias(row_bias, n, rows_per_batch, cout, route)
    dev = x.device
    y = torch.empty((n, cout), dtype=out_dtype, device=dev)
    wq = (torch.empty(cin * cout, dtype=torch.bfloat16, device=dev)
          if route == "wgmma" else None)  # W rounded and permuted
    s1 = s2 = None
    if emit_stats:  # cleared by the kernel entry
        s1, s2 = torch.empty((2, cout), dtype=torch.float32, device=dev)
    key, thr, scale, drop = _drop_args(seed, drop_rate)
    rc = load_library("pointnet_chain").pcseg_chain_fwd(
        x.data_ptr(), *(ptr(t) for t in norm), wk.data_ptr(), ptr(wq),
        bf.data_ptr(), ptr(rb), y.data_ptr(), ptr(s1), ptr(s2), n, cin, cout,
        max(rows_per_batch, 1), int(relu), key, thr, scale, drop, w_f32,
        int(out_dtype == torch.float32), stream_of(x),
    )
    raise_on(rc, "fused_block")
    LAUNCHES["fused_block"] += 1
    return y, s1, s2


def fused_block_bwd_cuda(x, mu, inv, gamma, beta, w, y, dy, ds1, ds2, seed,
                         relu, drop_rate, rows_per_batch, has_row_bias):
    n, cin = x.shape
    cout = w.shape[1]
    route = route_of(cin, cout)
    if has_row_bias and route != "wgmma":
        raise ValueError("fused_block takes a row bias only at widths that "
                         "are multiples of 64")
    if has_row_bias and (rows_per_batch <= 0 or n % rows_per_batch):
        raise ValueError(f"N={n} is not a multiple of rows_per_batch="
                         f"{rows_per_batch}")
    dev = x.device
    check("x", x, (n, cin), torch.bfloat16)
    wk, w_f32 = w_operand(w, cin, cout)
    if not dy.is_contiguous():
        dy = dy.contiguous()
    if dy.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dy must be bf16 or f32, got {dy.dtype}")
    check("dy", dy, (n, cout), dy.dtype)
    norm = norm_vecs(mu, inv, gamma, beta, cin)
    stats = ds1 is not None
    if stats:
        check("y", y, (n, cout), torch.bfloat16)
        ds1 = f32_vec(ds1, cout, "ds1")
        ds2 = f32_vec(ds2, cout, "ds2")
    # dW, db, dgamma, dbeta and d(row_bias) in one allocation; the kernel
    # entry clears them
    nb = n // rows_per_batch if has_row_bias else 0
    sizes = [cin * cout, cout, cin if mu is not None else 0,
             cin if mu is not None else 0, nb * cout]
    sums = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    dw, db, dg, dbeta, drb = sums.split(sizes)
    dw = dw.view(cin, cout)
    dg = dg if mu is not None else None
    dbeta = dbeta if mu is not None else None
    drb = drb.view(nb, cout) if has_row_bias else None
    dx = torch.empty((n, cin), dtype=x.dtype, device=dev)
    lib = load_library("pointnet_chain")
    dy_f32 = int(dy.dtype == torch.float32)
    wq = d_scr = a_scr = None
    if route == "wgmma":  # bf16 scratch: W (permuted) and, where the split
        # kernels run, d (N, Cout) and a (N, Cin); one allocation
        split = _bwd_split(lib, cin, cout, dy_f32, int(has_row_bias))
        scr = torch.empty(cin * cout + split * n * (cout + cin),
                          dtype=torch.bfloat16, device=dev)
        wq = scr.data_ptr()
        if split:
            d_scr = wq + 2 * cin * cout
            a_scr = d_scr + 2 * n * cout
    key, thr, scale, drop = _drop_args(seed, drop_rate)
    rc = lib.pcseg_chain_bwd(
        x.data_ptr(), *(ptr(t) for t in norm), wk.data_ptr(), wq,
        ptr(y) if stats else None, dy.data_ptr(), ptr(ds1), ptr(ds2),
        dx.data_ptr(), dw.data_ptr(), db.data_ptr(), ptr(dg), ptr(dbeta),
        ptr(drb), d_scr, a_scr, w_f32, dy_f32, n, cin, cout,
        max(rows_per_batch, 1), int(relu), key, thr, scale, drop,
        stream_of(x),
    )
    raise_on(rc, "fused_block_bwd")
    LAUNCHES["fused_block_bwd"] += 1
    return dx, dw, db, dg, dbeta, drb


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mu, inv, gamma, beta, w, b, row_bias, seed, relu,
                drop_rate, emit_stats, rows_per_batch, out_dtype, plain):
        kern = on_cuda(x, plain)
        fwd = fused_block_fwd_cuda if kern else fused_block_fwd_plain
        y, s1, s2 = fwd(x, mu, inv, gamma, beta, w, b, row_bias, seed, relu,
                        drop_rate, emit_stats, rows_per_batch, out_dtype)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, mu, inv, gamma, beta, w,
                              y if emit_stats else None)
        ctx.cfg = (seed, relu, drop_rate, rows_per_batch,
                   row_bias is not None, kern, emit_stats)
        if not emit_stats:
            s1 = s2 = x.new_empty(0, dtype=torch.float32)
            ctx.mark_non_differentiable(s1, s2)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, mu, inv, gamma, beta, w, y = ctx.saved_tensors
        seed, relu, drop_rate, rpb, has_rb, kern, emit_stats = ctx.cfg
        if dy is None:
            dy = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                             device=x.device)
        if not emit_stats or (ds1 is None and ds2 is None):
            ds1 = ds2 = None
        else:
            ds1 = torch.zeros_like(ds2) if ds1 is None else ds1
            ds2 = torch.zeros_like(ds1) if ds2 is None else ds2
        bwd = fused_block_bwd_cuda if kern else fused_block_bwd_plain
        dx, dw, db, dg, dbeta, drb = bwd(x, mu, inv, gamma, beta, w, y, dy,
                                         ds1, ds2, seed, relu, drop_rate,
                                         rpb, has_rb)
        dmu = dinv = None
        if mu is not None:
            dmu, dinv = stats_cotangents(gamma, inv, dg, dbeta)
        return (dx, dmu, dinv, dg, dbeta, dw, db, drb) + (None,) * 7


def fused_block(x, mu, inv, gamma, beta, w, b, row_bias=None, seed=0,
                relu=True, drop_rate=0.0, emit_stats=True, rows_per_batch=0,
                out_dtype=torch.bfloat16, *, plain=False):
    """One fused chain layer (see the module docstring).

    x (N, Cin) bf16; mu/inv/gamma/beta (Cin,) f32, or all None (no
    normalize prologue, conv1); w (Cin, Cout), rounded to bf16 inside (its
    gradient comes back f32, unrounded); b (Cout,); row_bias
    (N // rows_per_batch, Cout) or None; seed a 32-bit int (used only when
    drop_rate > 0). Returns (y (N, Cout) out_dtype, s1, s2 (Cout,) f32, or
    None when emit_stats=False).
    """
    y, s1, s2 = _FusedBlock.apply(x, mu, inv, gamma, beta, w, b, row_bias,
                                  int(seed), bool(relu), float(drop_rate),
                                  bool(emit_stats), int(rows_per_batch),
                                  out_dtype, bool(plain))
    if not emit_stats:
        return y, None, None
    return y, s1, s2
