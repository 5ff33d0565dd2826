"""PointNetSeg training forward on the fused kernel chain (counterpart of
pcseg_tpu/models/pointnet_fused.py).

Each layer is one ``ops.fused_block.fused_block`` ([normalize the previous
layer -> ReLU -> dropout -> matmul -> stats]); the global layer and the
max pool are one ``ops.fused_global.fused_global_pool_block``; the
classifier and the weighted CE are one ``ops.fused_ce.fused_seg4_ce``, so
the (N, C) logits are never stored. The head's (N, 1088) concat is never
built: seg1 = point_feat @ W[:64] + a per-batch-row bias g @ W[64:]
(the split-matmul trick).

Semantics = the reference model with single-pass ("fast") BN:
- batch statistics include padded positions AND any all-masked dummy
  rows (the plain path excludes dummy rows; only a short final batch
  differs);
- variance E[x^2] - mu^2 in f32, clamped at 0;
- activations between layers are the raw pre-norm bf16 values, stats f32.

The mu/inv glue between the kernels is plain torch, so autograd carries
the batch-statistics gradient; each op's backward handles only
normalization with fixed statistics.

Dropout draws two seeds per step from the caller: ``seeds[0]`` masks
seg1's output (in seg2's prologue), ``seeds[1]`` seg2's output. The masks
are those of ops/dropout.py at the same seeds, so the fused and the plain
path drop the same elements.

Dispatch to the kernels is per tensor: CUDA tensors launch them, CPU
tensors (or ``plain=True``) run their plain versions.
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.ops.batchnorm import EPS, running_update
from pcseg_tpu_torch.ops.fused_block import fused_block
from pcseg_tpu_torch.ops.fused_ce import fused_seg4_ce
from pcseg_tpu_torch.ops.fused_global import fused_global_pool_block

# (conv name, BN of its INPUT or None); global_feat is fused with the pool
_ENCODER_CHAIN = [
    ("conv1", None),           # raw points in
    ("conv2", "bn1"),
    ("conv3", "bn2"),
    ("conv4", "bn3"),
    ("conv5", "bn4"),
]
_BN_OF = {"conv1": "bn1", "conv2": "bn2", "conv3": "bn3", "conv4": "bn4",
          "conv5": "bn5"}


def _stats_to_norm(s1, s2, n: float):
    """Column sums -> (mu, inv, biased var); differentiable glue."""
    mu = s1 / n
    var = (s2 / n - mu.square()).clamp_min(0.0)
    return mu, torch.rsqrt(var + EPS), var


def _fused_chain(params, batch_stats, points, *, seeds, dropout_rate,
                 plain):
    """The chain through seg_conv3: (y_s3 raw pre-norm bf16, (s1, s2) of
    seg3, n, new_batch_stats, (B, M))."""
    b_, m_, d_ = points.shape
    n = b_ * m_
    nf = float(n)
    seed0, seed1 = (int(seeds[0]), int(seeds[1])) if dropout_rate > 0.0 \
        else (0, 0)
    new_bn = {}

    def update_running(bn_name, s1, s2):
        mu, _, var = _stats_to_norm(s1.detach(), s2.detach(), nf)
        new_bn[bn_name] = running_update(batch_stats[bn_name], mu, var, nf)

    # --- encoder chain
    h = points.reshape(n, d_).to(torch.bfloat16)
    stats = None
    saved = {}
    for conv, bn_in in _ENCODER_CHAIN:
        if bn_in is None:
            mu = inv = gamma = beta = None
        else:
            mu, inv, _ = _stats_to_norm(*stats, nf)
            gamma, beta = params[bn_in]["scale"], params[bn_in]["bias"]
        y, s1, s2 = fused_block(
            h, mu, inv, gamma, beta, params[conv]["kernel"],
            params[conv]["bias"], None, 0, bn_in is not None, 0.0, True, 0,
            plain=plain)
        update_running(_BN_OF[conv], s1, s2)
        saved[conv] = (h, stats)
        h, stats = y, (s1, s2)

    # --- global layer + global max pool, one op. BN + ReLU is monotone
    # per channel with slope sign(gamma), so the op pools sign * y and
    # only the (B, 1024) winners are normalized here.
    mu5, inv5, _ = _stats_to_norm(*stats, nf)
    gam_g = params["bn_global"]["scale"]
    bet_g = params["bn_global"]["bias"]
    sign_g = torch.sign(gam_g).detach()
    s1_g, s2_g, best, _ = fused_global_pool_block(
        h, mu5, inv5, params["bn5"]["scale"], params["bn5"]["bias"],
        params["global_feat"]["kernel"], params["global_feat"]["bias"],
        sign_g, m_, plain=plain)
    update_running("bn_global", s1_g, s2_g)
    mu_g, inv_g, _ = _stats_to_norm(s1_g, s2_g, nf)
    y_best = sign_g * best                       # raw y at the winner
    z_best = torch.where(gam_g == 0.0, bet_g,
                         (y_best - mu_g) * inv_g * gam_g + bet_g)
    g = torch.relu(z_best)                       # (B, 1024)

    # --- head; seg1 through the split-matmul trick
    w_seg1 = params["seg_conv1"]["kernel"]       # (1088, 512)
    w_top, w_bot = w_seg1[:64], w_seg1[64:]
    gbias = (g.to(torch.bfloat16) @ w_bot.to(torch.bfloat16)).float()
    # conv3's saved input is conv2's raw output and its stats: what seg1's
    # prologue needs to regenerate point_feat
    y2, stats2 = saved["conv3"]
    mu2, inv2, _ = _stats_to_norm(*stats2, nf)
    y_s1, s1_1, s2_1 = fused_block(
        y2, mu2, inv2, params["bn2"]["scale"], params["bn2"]["bias"], w_top,
        params["seg_conv1"]["bias"], gbias, 0, True, 0.0, True, m_,
        plain=plain)
    update_running("bn_seg1", s1_1, s2_1)

    mu_s1, inv_s1, _ = _stats_to_norm(s1_1, s2_1, nf)
    y_s2, s1_2, s2_2 = fused_block(
        y_s1, mu_s1, inv_s1, params["bn_seg1"]["scale"],
        params["bn_seg1"]["bias"], params["seg_conv2"]["kernel"],
        params["seg_conv2"]["bias"], None, seed0, True, dropout_rate, True,
        0, plain=plain)
    update_running("bn_seg2", s1_2, s2_2)

    mu_s2, inv_s2, _ = _stats_to_norm(s1_2, s2_2, nf)
    y_s3, s1_3, s2_3 = fused_block(
        y_s2, mu_s2, inv_s2, params["bn_seg2"]["scale"],
        params["bn_seg2"]["bias"], params["seg_conv3"]["kernel"],
        params["seg_conv3"]["bias"], None, seed1, True, dropout_rate, True,
        0, plain=plain)
    update_running("bn_seg3", s1_3, s2_3)
    return y_s3, (s1_3, s2_3), nf, new_bn, (b_, m_)


def pointnet_apply_fused(params, batch_stats, points, *, seeds,
                         dropout_rate, plain=False):
    """Training forward: (logits (B, M, C) f32, new_batch_stats). The
    logits layer is one more fused_block that stores f32 and emits no
    stats."""
    y_s3, (s1_3, s2_3), nf, new_bn, (b_, m_) = _fused_chain(
        params, batch_stats, points, seeds=seeds, dropout_rate=dropout_rate,
        plain=plain)
    mu_s3, inv_s3, _ = _stats_to_norm(s1_3, s2_3, nf)
    logits, _, _ = fused_block(
        y_s3, mu_s3, inv_s3, params["bn_seg3"]["scale"],
        params["bn_seg3"]["bias"], params["seg_conv4"]["kernel"],
        params["seg_conv4"]["bias"], None, 0, True, 0.0, False, 0,
        torch.float32, plain=plain)
    return logits.reshape(b_, m_, -1), new_bn


def pointnet_fused_train_loss(params, batch_stats, points, labels,
                              class_weights, *, seeds, dropout_rate,
                              plain=False):
    """Training LOSS on the fused chain with the classifier + CE op:
    ((num, den, correct), new_batch_stats), where num / den is the
    weighted CE (ops/losses.cross_entropy_sums contract) and correct the
    argmax-correct count over label-valid rows."""
    y_s3, (s1_3, s2_3), nf, new_bn, _ = _fused_chain(
        params, batch_stats, points, seeds=seeds, dropout_rate=dropout_rate,
        plain=plain)
    mu_s3, inv_s3, _ = _stats_to_norm(s1_3, s2_3, nf)
    out = fused_seg4_ce(
        y_s3, mu_s3, inv_s3, params["bn_seg3"]["scale"],
        params["bn_seg3"]["bias"], params["seg_conv4"]["kernel"],
        params["seg_conv4"]["bias"], labels.reshape(-1), class_weights,
        plain=plain)
    return out, new_bn
