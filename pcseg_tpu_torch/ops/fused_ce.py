"""Fused [seg3-normalize -> ReLU -> seg4 matmul -> weighted CE + accuracy]:
the classifier layer and the loss in one op, a CUDA kernel + its plain
version, forward and backward.

Counterpart of pcseg_tpu/ops/pallas/fused_ce.py (``fused_seg4_ce``). For
x the raw bf16 seg3 output and C classes:

    a       = bf16(relu((x - mu) * inv * gamma + beta))
    logits  = a @ bf16(W) + b                 # f32, never stored
    num     = sum_i w[y_i] * (logsumexp_i - logits_i[y_i])
    den     = sum_i w[y_i]
    correct = count(argmax_i == y_i)          # first class on ties

over rows with label >= 0 (label -1 is padding: the reference's
``ignore_index=-1``), the contract of ``ops/losses.cross_entropy_sums``.
Only ``num`` carries a gradient: the backward recomputes the logits and
seeds ``dlogits = ct_num * w[y] * (softmax - onehot)`` (rounded to bf16
for both products) into the seg4 backward: dx, dW (Cin, C) f32, db, and
the gamma/beta-like sums with the same stats-input algebra as fused_block.

On the card (csrc/pointnet_chain.cu) each direction is one CUDA-core
kernel: up to 32 classes 16 lanes a row (32 above 8 classes) load its 128
channels in 16-byte (8-byte) pieces, the logits come from FMAs and a
butterfly of shuffles, and the backward forms dlogits in registers (no
(N, C) scratch; on mma.sync up to 8 classes) and sums dW, db, dgamma and
dbeta over its rows before one atomic a value and block; from 33 to 128
classes tiles of 32 rows go through shared memory, the softmax a warp's
shuffles. Cin 128 and 1..128 classes, the JAX kernel's range
(``check_widths`` raises ValueError for any other width before the library
loads).
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
    MAX_CLASSES,
    check,
    f32_vec,
    norm_vecs,
    prologue_plain,
    stats_cotangents,
    w_operand,
)

LAUNCHES = {"fused_seg4_ce": 0, "fused_seg4_ce_bwd": 0}
CIN = 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _logits_plain(x, mu, inv, gamma, beta, w, b):
    x_hat, z, a, _ = prologue_plain(x, mu, inv, gamma, beta, True, 0, 0.0)
    wq = w.to(x.dtype).float()
    return x_hat, z, a, wq, a @ wq + b


def _ce_parts(logits, labels, class_weights):
    c = logits.shape[1]
    valid = labels >= 0
    onehot = (labels[:, None] == torch.arange(c, device=labels.device)).float()
    mx = logits.amax(dim=1, keepdim=True)
    ex = torch.exp(logits - mx)
    se = ex.sum(dim=1, keepdim=True)
    wrow = (onehot * class_weights).sum(dim=1) * valid.float()
    return valid, onehot, mx, ex, se, wrow


def seg4_ce_fwd_plain(x, mu, inv, gamma, beta, w, b, labels, class_weights):
    *_, logits = _logits_plain(x, mu, inv, gamma, beta, w, b)
    valid, onehot, mx, ex, se, wrow = _ce_parts(logits, labels, class_weights)
    lse = torch.log(se) + mx
    true_logit = (onehot * logits).sum(dim=1, keepdim=True)
    num = (wrow * (lse - true_logit)[:, 0]).sum()
    den = wrow.sum()
    correct = (valid & (logits.argmax(dim=1) == labels)).float().sum()
    return num, den, correct


def seg4_ce_bwd_plain(x, mu, inv, gamma, beta, w, b, labels, class_weights,
                      ct_num):
    x_hat, z, a, wq, logits = _logits_plain(x, mu, inv, gamma, beta, w, b)
    _, onehot, _, ex, se, wrow = _ce_parts(logits, labels, class_weights)
    dlogits = (ct_num * wrow)[:, None] * (ex / se - onehot)
    db = dlogits.sum(0)
    dl_b = dlogits.to(torch.bfloat16).float()
    dw = a.t() @ dl_b
    dz = (dl_b @ wq.t()) * (z > 0.0).float()
    dx = (dz * gamma * inv).to(x.dtype)
    return dx, dw, db, (dz * x_hat).sum(0), dz.sum(0)


def check_widths(cin: int, c: int) -> None:
    """The kernels' widths: Cin 128 (PointNetSeg's seg3) and 1..128
    classes; any other raises ValueError before the library loads."""
    if cin != CIN or not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"fused_seg4_ce on a CUDA tensor takes Cin {CIN} "
                         f"and 1..{MAX_CLASSES} classes; got {cin} -> {c}")


def _common_cuda(x, mu, inv, gamma, beta, w, b, labels, class_weights):
    n, cin = x.shape
    c = w.shape[1]
    check_widths(cin, c)
    check("x", x, (n, cin), torch.bfloat16)
    wq, w_f32 = w_operand(w, cin, c)  # rounded to bf16 by the kernels
    norm = norm_vecs(mu, inv, gamma, beta, cin)
    lab = labels
    if lab.dtype != torch.int64 or not lab.is_contiguous():
        lab = lab.long().contiguous()
    check("labels", lab, (n,), torch.int64)
    return (n, cin, c, wq, w_f32, norm, f32_vec(b, c, "b"), lab,
            f32_vec(class_weights, c, "class_weights"))


def seg4_ce_fwd_cuda(x, mu, inv, gamma, beta, w, b, labels, class_weights):
    n, cin, c, wq, w_f32, norm, bf, lab, cw = _common_cuda(
        x, mu, inv, gamma, beta, w, b, labels, class_weights)
    # num, den, correct; the kernel entry clears them
    acc = torch.empty(3, dtype=torch.float32, device=x.device)
    rc = load_library("pointnet_chain").pcseg_seg4_ce_fwd(
        x.data_ptr(), *(t.data_ptr() for t in norm), wq.data_ptr(),
        bf.data_ptr(), lab.data_ptr(), cw.data_ptr(), acc.data_ptr(), w_f32,
        n, cin, c, stream_of(x),
    )
    raise_on(rc, "fused_seg4_ce")
    LAUNCHES["fused_seg4_ce"] += 1
    return acc.unbind()


def seg4_ce_bwd_cuda(x, mu, inv, gamma, beta, w, b, labels, class_weights,
                     ct_num):
    n, cin, c, wq, w_f32, norm, bf, lab, cw = _common_cuda(
        x, mu, inv, gamma, beta, w, b, labels, class_weights)
    dev = x.device
    ct = ct_num  # one f32 value
    if ct.dtype != torch.float32 or not ct.is_contiguous():
        ct = ct.float().contiguous()
    dx = torch.empty((n, cin), dtype=x.dtype, device=dev)
    # dW, db, dgamma, dbeta in one allocation; the kernel entry clears them
    sizes = [cin * c, c, cin, cin]
    dw, db, dg, dbeta = torch.empty(sum(sizes), dtype=torch.float32,
                                    device=dev).split(sizes)
    dw = dw.view(cin, c)
    rc = load_library("pointnet_chain").pcseg_seg4_ce_bwd(
        x.data_ptr(), *(t.data_ptr() for t in norm), wq.data_ptr(),
        bf.data_ptr(), lab.data_ptr(), cw.data_ptr(), ct.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), db.data_ptr(), dg.data_ptr(),
        dbeta.data_ptr(), w_f32, n, cin, c, stream_of(x),
    )
    raise_on(rc, "fused_seg4_ce_bwd")
    LAUNCHES["fused_seg4_ce_bwd"] += 1
    return dx, dw, db, dg, dbeta


class _Seg4CE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mu, inv, gamma, beta, w, b, labels, class_weights,
                plain):
        kern = on_cuda(x, plain)
        fwd = seg4_ce_fwd_cuda if kern else seg4_ce_fwd_plain
        num, den, correct = fwd(x, mu, inv, gamma, beta, w, b, labels,
                                class_weights)
        ctx.save_for_backward(x, mu, inv, gamma, beta, w, b, labels,
                              class_weights)
        ctx.kern = kern
        ctx.mark_non_differentiable(den, correct)
        return num, den, correct

    @staticmethod
    def backward(ctx, ct_num, _ct_den, _ct_correct):
        x, mu, inv, gamma, beta, w, b, labels, cw = ctx.saved_tensors
        bwd = seg4_ce_bwd_cuda if ctx.kern else seg4_ce_bwd_plain
        dx, dw, db, dg, dbeta = bwd(x, mu, inv, gamma, beta, w, b, labels,
                                    cw, ct_num)
        dmu, dinv = stats_cotangents(gamma, inv, dg, dbeta)
        # labels are integers and the class weights are data (the
        # reference never optimizes them)
        return dx, dmu, dinv, dg, dbeta, dw, db, None, None, None


def fused_seg4_ce(x, mu, inv, gamma, beta, w, b, labels, class_weights, *,
                  plain=False):
    """(num, den, correct) of the weighted masked CE over the classifier.

    x (N, Cin) bf16 raw seg3 output; mu/inv/gamma/beta (Cin,) seg3 BN
    terms; w (Cin, C) (its gradient comes back f32); b (C,); labels (N,)
    int with -1 padding; class_weights (C,) f32. Returns three f32
    scalars; only ``num`` is differentiable.
    """
    return _Seg4CE.apply(x, mu, inv, gamma, beta, w, b, labels,
                         class_weights, bool(plain))
