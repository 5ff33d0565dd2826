"""Global layer + global max pool in one op: a CUDA kernel + its plain
version, forward and backward.

Counterpart of pcseg_tpu/ops/pallas/fused_global.py
(``fused_global_pool_block``). PointNet's global stage is
``bn5-normalize -> relu -> matmul W_global -> bn_global -> relu -> max over
the points of each event``. With z = (y - mu_g) * inv_g * gamma_g + beta_g
and inv_g > 0, z is monotone in y with slope sign(gamma_g), so

    argmax_rows z = argmax_rows (sign(gamma_g) * y)

although mu_g, inv_g (batch stats of y itself) are known only after the
pass. The op therefore returns the stats of y and, per (batch row,
channel), ``best = max sign * y`` over the stored bf16 y and its FIRST
row index (torch.max's tie rule); the caller normalizes the (B, C)
winners in differentiable glue. A channel with gamma_g = 0 has sign 0:
every row ties at 0 and row 0 wins.

Backward: ``dy_eff = (ds1 + 2 * y * ds2) + onehot(idx) * dbest * sign``,
then the layer backward of fused_block (dx, dW, db, dgamma/dbeta-like).

On the card the forward kernel keeps (value, row) per (batch, channel) as
one 64-bit key (an order-preserving map of the float above the inverted
row) combined across blocks with ``atomicMax``, so the larger value wins
and, among equal values, the smaller row.
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.ops._build import (
    load_library,
    on_cuda,
    raise_on,
    stream_of,
)
from pcseg_tpu_torch.ops.fused_block import (
    check,
    f32_vec,
    norm_vecs,
    prologue_plain,
    stats_cotangents,
)

LAUNCHES = {"fused_global_pool_block": 0, "fused_global_pool_block_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def first_max(sm: torch.Tensor):
    """(nb, M, C) -> (max over M, first row attaining it) per (nb, C)."""
    best = sm.amax(dim=1)
    rows = torch.arange(sm.shape[1], device=sm.device)[None, :, None]
    big = torch.full((), sm.shape[1], device=sm.device)
    idx = torch.where(sm == best[:, None, :], rows, big).amin(dim=1)
    return best, idx.to(torch.int32)


def global_pool_fwd_plain(x, mu, inv, gamma, beta, w, b, sign,
                          rows_per_batch):
    _, _, a, _ = prologue_plain(x, mu, inv, gamma, beta, True, 0, 0.0)
    yf = a @ w.to(torch.bfloat16).float() + b
    s1, s2 = yf.sum(0), (yf * yf).sum(0)
    y = yf.to(torch.bfloat16)
    sm = y.float() * sign
    best, idx = first_max(sm.reshape(-1, rows_per_batch, sm.shape[1]))
    return y, s1, s2, best, idx


def global_pool_bwd_plain(x, mu, inv, gamma, beta, w, y, ds1, ds2, pval, idx,
                          rows_per_batch):
    n, cout = y.shape
    rows = torch.arange(rows_per_batch, device=y.device)[None, :, None]
    hit = rows == idx[:, None, :].long()
    pool = torch.where(hit, pval[:, None, :], torch.zeros((), device=y.device))
    d = ds1 + 2.0 * y.float() * ds2 + pool.reshape(n, cout)
    db = d.sum(0)
    d_b = d.to(torch.bfloat16).float()
    x_hat, z, a, _ = prologue_plain(x, mu, inv, gamma, beta, True, 0, 0.0)
    wf = w.to(torch.bfloat16).float()
    dw = a.t() @ d_b
    dz = (d_b @ wf.t()) * (z > 0.0).float()
    dx = (dz * gamma * inv).to(x.dtype)
    return dx, dw, db, (dz * x_hat).sum(0), dz.sum(0)


def global_pool_fwd_cuda(x, mu, inv, gamma, beta, w, b, sign,
                         rows_per_batch):
    n, cin = x.shape
    cout = w.shape[1]
    check("x", x, (n, cin), torch.bfloat16)
    wq = w.to(torch.bfloat16).contiguous()
    check("w", wq, (cin, cout), torch.bfloat16)
    norm = norm_vecs(mu, inv, gamma, beta, cin)
    bf, sg = f32_vec(b, cout, "b"), f32_vec(sign, cout, "sign")
    if n % rows_per_batch:
        raise ValueError(f"N={n} is not a multiple of rows_per_batch="
                         f"{rows_per_batch}")
    nb, dev = n // rows_per_batch, x.device
    y = torch.empty((n, cout), dtype=torch.bfloat16, device=dev)
    s1 = torch.zeros(cout, dtype=torch.float32, device=dev)
    s2 = torch.zeros(cout, dtype=torch.float32, device=dev)
    keys = torch.zeros((nb, cout), dtype=torch.int64, device=dev)
    best = torch.empty((nb, cout), dtype=torch.float32, device=dev)
    idx = torch.empty((nb, cout), dtype=torch.int32, device=dev)
    rc = load_library("pointnet_fused").pcseg_global_pool_fwd(
        x.data_ptr(), *(t.data_ptr() for t in norm), wq.data_ptr(),
        bf.data_ptr(), sg.data_ptr(), y.data_ptr(), s1.data_ptr(),
        s2.data_ptr(), keys.data_ptr(), best.data_ptr(), idx.data_ptr(), n,
        cin, cout, rows_per_batch, stream_of(x),
    )
    raise_on(rc, "fused_global_pool_block")
    LAUNCHES["fused_global_pool_block"] += 1
    return y, s1, s2, best, idx


def global_pool_bwd_cuda(x, mu, inv, gamma, beta, w, y, ds1, ds2, pval, idx,
                         rows_per_batch):
    n, cin = x.shape
    cout = w.shape[1]
    nb, dev = n // rows_per_batch, x.device
    wq = w.to(torch.bfloat16).contiguous()
    norm = norm_vecs(mu, inv, gamma, beta, cin)
    ds1, ds2 = f32_vec(ds1, cout, "ds1"), f32_vec(ds2, cout, "ds2")
    pval = pval.float().contiguous()
    check("pval", pval, (nb, cout), torch.float32)
    check("idx", idx, (nb, cout), torch.int32)
    check("y", y, (n, cout), torch.bfloat16)
    dx = torch.empty((n, cin), dtype=x.dtype, device=dev)
    dw = torch.zeros((cin, cout), dtype=torch.float32, device=dev)
    db = torch.zeros(cout, dtype=torch.float32, device=dev)
    dg = torch.zeros(cin, dtype=torch.float32, device=dev)
    dbeta = torch.zeros(cin, dtype=torch.float32, device=dev)
    scratch = torch.empty((n, cout), dtype=torch.bfloat16, device=dev)
    rc = load_library("pointnet_fused").pcseg_global_pool_bwd(
        x.data_ptr(), *(t.data_ptr() for t in norm), wq.data_ptr(),
        y.data_ptr(), ds1.data_ptr(), ds2.data_ptr(), pval.data_ptr(),
        idx.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        dg.data_ptr(), dbeta.data_ptr(), scratch.data_ptr(), n, cin, cout,
        rows_per_batch, stream_of(x),
    )
    raise_on(rc, "fused_global_pool_block_bwd")
    LAUNCHES["fused_global_pool_block_bwd"] += 1
    return dx, dw, db, dg, dbeta


class _GlobalPoolBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mu, inv, gamma, beta, w, b, sign, rows_per_batch,
                plain):
        kern = on_cuda(x, plain)
        fwd = global_pool_fwd_cuda if kern else global_pool_fwd_plain
        y, s1, s2, best, idx = fwd(x, mu, inv, gamma, beta, w, b, sign,
                                   rows_per_batch)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, mu, inv, gamma, beta, w, y, sign, idx)
        ctx.cfg = (rows_per_batch, kern)
        ctx.mark_non_differentiable(idx)
        return s1, s2, best, idx

    @staticmethod
    def backward(ctx, ds1, ds2, dbest, _didx):
        x, mu, inv, gamma, beta, w, y, sign, idx = ctx.saved_tensors
        rpb, kern = ctx.cfg
        cout = w.shape[1]
        z = torch.zeros(cout, dtype=torch.float32, device=x.device)
        ds1 = z if ds1 is None else ds1.float()
        ds2 = z if ds2 is None else ds2.float()
        if dbest is None:
            dbest = torch.zeros(idx.shape, dtype=torch.float32,
                                device=x.device)
        # d best / d y at the winner row = sign  (best = max sign * y)
        pval = dbest.float() * sign.reshape(1, -1).float()
        bwd = global_pool_bwd_cuda if kern else global_pool_bwd_plain
        dx, dw, db, dg, dbeta = bwd(x, mu, inv, gamma, beta, w, y, ds1, ds2,
                                    pval, idx, rpb)
        dmu, dinv = stats_cotangents(gamma, inv, dg, dbeta)
        return dx, dmu, dinv, dg, dbeta, dw, db, None, None, None


def fused_global_pool_block(x, mu, inv, gamma, beta, w, b, sign,
                            rows_per_batch, *, plain=False):
    """[bn5-normalize -> relu -> matmul -> stats -> sign-pool].

    x (N, Cin) bf16, the raw conv5 output; mu/inv/gamma/beta (Cin,) bn5
    terms; w (Cin, Cout), rounded to bf16 inside; b (Cout,); sign (Cout,)
    = sign(gamma_global), detached. N = B * rows_per_batch. Returns
    (s1, s2 (Cout,) f32 column sums of y and y^2, best (B, Cout) f32 =
    max over the batch row of sign * bf16(y), idx (B, Cout) int32 = the
    first row attaining it).
    """
    return _GlobalPoolBlock.apply(x, mu, inv, gamma, beta, w, b, sign,
                                  int(rows_per_batch), bool(plain))
