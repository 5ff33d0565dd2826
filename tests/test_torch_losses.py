"""The port's ``weighted_masked_cross_entropy`` (``pcseg_tpu_torch.ops``)
against the JAX package's (``pcseg_tpu.ops``) on the same logits, with
and without class weights, on batches with ignored targets and on one
whose every target is ignored (the ``finfo.tiny`` floor: 0, not NaN), to
f32 rounding (rtol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.ops import weighted_masked_cross_entropy as jax_wce
from pcseg_tpu_torch.ops import weighted_masked_cross_entropy

torch.set_num_threads(1)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("ignored", ["some", "all"])
def test_matches_jax(weighted, ignored):
    rng = np.random.default_rng(3 + weighted)
    b, m, c = 3, 50, 5
    logits = (rng.normal(size=(b, m, c)) * 3).astype(np.float32)
    labels = rng.integers(0, c, size=(b, m)).astype(np.int64)
    labels[rng.random((b, m)) < 0.3] = -1
    if ignored == "all":
        labels[:] = -1
    w = rng.uniform(0.2, 3.0, size=c).astype(np.float32) if weighted \
        else None
    want = float(jax_wce(jnp.asarray(logits), jnp.asarray(labels),
                         None if w is None else jnp.asarray(w)))
    got = weighted_masked_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == ()
    if ignored == "all":
        assert float(got) == want == 0.0
    else:
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
        # torch's own loss with the reference's settings
        ref = torch.nn.functional.cross_entropy(
            torch.from_numpy(logits).reshape(-1, c),
            torch.from_numpy(labels).reshape(-1), ignore_index=-1,
            weight=None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
