"""The port's segment scatter (ops/voxel_scatter.py, its plain version on
the CPU) against the JAX package's Pallas kernel (interpret mode on the
CPU), with spill rows; and what the port adds to the contract: an id
outside [0, R3] adds nothing.

Tolerance: both sides add the same f32 terms, in another order, so every
sum is held to 1e-5 of the largest |sum|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.ops.pallas.voxel_scatter import pallas_segment_scatter
from pcseg_tpu_torch.ops import voxel_scatter as vs

torch.set_num_threads(1)


def _inputs(seed, b, m, nseg, c, spill=10):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, nseg, size=(b, m)).astype(np.int32)
    feats = rng.normal(size=(b, m, c)).astype(np.float32)
    ids[:, -spill:] = nseg                   # masked points: the spill row
    feats[:, -spill:] = 0.0
    return ids, feats


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    tol = 1e-5 * max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= tol


@pytest.mark.parametrize("b,m,nseg,c", [(2, 256, 64, 3), (2, 300, 512, 1),
                                        (1, 512, 27, 8)])
def test_matches_pallas(b, m, nseg, c):
    ids, feats = _inputs(0, b, m, nseg, c)
    want = pallas_segment_scatter(jnp.asarray(ids), jnp.asarray(feats), nseg)
    got = vs.segment_scatter(torch.tensor(ids), torch.tensor(feats), nseg)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


def test_hot_segment_matches_pallas():
    """Every point of an event in one segment (the card's atomics
    serialise there)."""
    b, m, nseg, c = 2, 256, 64, 4
    ids, feats = _inputs(1, b, m, nseg, c, spill=0)
    ids[0] = 5
    want = pallas_segment_scatter(jnp.asarray(ids), jnp.asarray(feats), nseg)
    got = vs.segment_scatter(torch.tensor(ids), torch.tensor(feats), nseg)
    _close(got.numpy(), want)
    np.testing.assert_allclose(got[0, 5].numpy(), feats[0].sum(0), rtol=1e-5)


def test_ids_outside_the_grid_add_nothing():
    b, m, nseg, c = 2, 128, 64, 2
    ids, feats = _inputs(2, b, m, nseg, c, spill=0)
    bad = ids.copy()
    bad[:, ::4] = nseg + 7
    bad[:, 1::4] = -3
    keep = ids.copy()
    keep[:, ::4] = nseg
    keep[:, 1::4] = nseg
    got = vs.segment_scatter(torch.tensor(bad), torch.tensor(feats), nseg)
    want = vs.segment_scatter(torch.tensor(keep), torch.tensor(feats), nseg)
    assert torch.equal(got, want)
