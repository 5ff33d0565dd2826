"""Pointwise (1x1-conv) dense blocks (counterpart of
pcseg_tpu/ops/pointwise.py).

Every conv of the reference model is ``nn.Conv1d(Cin, Cout, 1)``: one
matmul per layer over all B*M points, activations channels-last
(B, M, C). The JAX package runs these matmuls outside any Pallas kernel,
so here they are plain ``torch.matmul``: operands rounded to the compute
dtype, products summed in f32 (the JAX ``preferred_element_type=f32``),
bias added in f32.

Init matches torch Conv1d defaults: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
for kernel and bias, drawn from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.ops.batchnorm import batchnorm_eval, batchnorm_train


def dense_init(generator: torch.Generator | None, in_dim: int,
               out_dim: int) -> dict:
    bound = 1.0 / in_dim ** 0.5

    def uniform(*shape):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound

    return {"kernel": uniform(in_dim, out_dim), "bias": uniform(out_dim)}


def pointwise_dense(p: dict, x: torch.Tensor,
                    compute_dtype: torch.dtype | None = None):
    """(B, M, Cin) @ (Cin, Cout) + b -> (B, M, Cout) f32."""
    dt = compute_dtype or x.dtype
    a = x.to(dt).float()
    w = p["kernel"].to(dt).float()
    return a @ w + p["bias"]


def pointwise_block(dense: dict, bn_params: dict, bn_state: dict,
                    x: torch.Tensor, *, train: bool, relu: bool = True,
                    mask: torch.Tensor | None = None,
                    compute_dtype: torch.dtype | None = None,
                    fast_stats: bool = False, group=None):
    """[1x1 conv -> BN -> ReLU]. Returns (y f32, new_bn_state or None).
    ``group``: the mesh of synced BN (``batchnorm_train``)."""
    y = pointwise_dense(dense, x, compute_dtype)
    if train:
        y, new_bn = batchnorm_train(bn_params, bn_state, y, mask=mask,
                                    fast_stats=fast_stats, group=group)
    else:
        y, new_bn = batchnorm_eval(bn_params, bn_state, y), None
    if relu:
        y = torch.relu(y)
    return y, new_bn
