"""SparseVoxelNet at widths whose kernels the port took only after their
repair (a width of 8 or 24: Cout 8, 24, 48 and 96 in the convs, the LN
at those widths; three levels: 4 W channels at level 2), served through
``Predictor(device="cpu")`` against the JAX package's model on the same
weights (numpy, carried over with ``ckpt.convert.from_jax_variables``).

The JAX model runs the fused raw forms the port follows: the bias + LN
kernel in interpret mode (``fused_ln="interpret"``) on raw convs, here in
their XLA halo form (``conv_impl="xla"``: the same raw conv, f32 sums
rounded once, which the JAX package also takes at channel counts its
Pallas conv's lanes do not hold). Small size: grid 16, tile 4, depth 2, 3
levels, bf16, B2 x 512 track events with masked points. Logits within
4 * 2^-8 of max|logit| (a one-ulp bf16 flip in an early layer travels
through the layers after it); the overflow counts equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.models.sparse_unet import SparseVoxelNet as JaxSparseVoxelNet
from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.infer import Predictor
from pcseg_tpu_torch.models.sparse_unet import SparseVoxelNet
from test_torch_sparse_unet import LOGITS_REL, SMALL, _numpy_vars, _points

torch.set_num_threads(1)

C = 4


@pytest.mark.parametrize("width", [8, 24])
def test_repaired_widths_serve_like_jax(width):
    kw = dict(SMALL, width=width, levels=3)
    jm = JaxSparseVoxelNet(**kw, fused_ln="interpret", conv_impl="xla")
    variables = _numpy_vars(jm, width)
    pts, mask = _points()
    want, jdropped = jm.apply(variables, jnp.asarray(pts),
                              mask=jnp.asarray(mask), return_overflow=True)
    want = np.asarray(want)
    model = SparseVoxelNet(**kw)
    pred = Predictor(from_jax_variables(variables), C, model=model,
                     device="cpu", strict_capacity=True)
    _, dropped = model(torch.from_numpy(pts), torch.from_numpy(mask),
                       return_overflow=True)
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdropped))
    scale = float(np.abs(want).max())
    for i in range(pts.shape[0]):
        n = int(mask[i].sum())
        got = pred.logits(pts[i, :n])
        err = float(np.abs(got - want[i, :n]).max())
        print(f"width {width}, event {i}: max|err| {err:.3e} at max|logit| "
              f"{scale:.3f}")
        assert got.shape == (n, C) and np.isfinite(got).all()
        assert err <= LOGITS_REL * scale, err
