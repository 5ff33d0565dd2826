"""The port's SparseVoxelNet (block impl, ``models/sparse_unet.py``)
against the JAX package's, on the same weights (numpy, carried over with
``ckpt.convert.from_jax_variables``) and points, and its serving path
(``Predictor``, ``api.predict``, checkpoints).

The JAX model runs its fused TPU forms in interpret mode
(``fused_ln="interpret"``, ``conv_impl="interpret"``): raw convs, the
Pallas block conv and the fused bias + LN kernel, the form the port
follows. Small size: grid 16, tile 4, width 16, depth 2, 2 levels, bf16,
B2 x 512 track events with masked points. Logits within 4 * 2^-8 of
max|logit| (a one-ulp bf16 flip in an early layer travels through the
layers after it); masked rows exactly 0.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.bench import _track_batch
from pcseg_tpu.core.config import ModelConfig as JaxModelConfig
from pcseg_tpu.models.factory import build_model as jax_build_model
from pcseg_tpu.models.sparse_unet import SparseVoxelNet as JaxSparseVoxelNet
from pcseg_tpu_torch import api
from pcseg_tpu_torch.ckpt.checkpoint import load_checkpoint, save_checkpoint
from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.core.config import ModelConfig
from pcseg_tpu_torch.data.synthetic import track_events
from pcseg_tpu_torch.infer import Predictor
from pcseg_tpu_torch.models.factory import build_model
from pcseg_tpu_torch.models.sparse_unet import SparseVoxelNet

torch.set_num_threads(1)

C = 4
SMALL = dict(num_classes=C, grid_size=16, width=16, depth=2, levels=2,
             tile=4, max_tiles=48, compute_dtype="bfloat16")
LOGITS_REL = 4 * 2.0 ** -8


def _numpy_vars(model, seed):
    """Random parameters in the JAX model's structure, made with numpy:
    He-uniform kernels, non-trivial biases and LayerNorm affines."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.key(0))["params"]
    params = {}
    for name, group in shapes.items():
        if "kernel" in group:
            k = group["kernel"].shape
            bound = np.sqrt(6.0 / np.prod(k[:-1]))
            params[name] = {
                "kernel": rng.uniform(-bound, bound, k).astype(np.float32),
                "bias": (rng.normal(size=k[-1:]) * 0.1).astype(np.float32),
            }
        else:
            c = group["scale"].shape
            params[name] = {
                "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": (rng.normal(size=c) * 0.1).astype(np.float32),
            }
    return {"params": params, "batch_stats": {}}


def _points(seed=0):
    pts = track_events(2, 512, seed)
    mask = np.ones(pts.shape[:2], bool)
    mask[1, 400:] = False
    return pts, mask


def _port(kw, variables):
    model = SparseVoxelNet(**kw)
    model.load_state_dict(from_jax_variables(variables))
    return model


@pytest.fixture(scope="module")
def reference():
    """The JAX interpret-mode model's logits and dropped counts."""
    jm = JaxSparseVoxelNet(**SMALL, fused_ln="interpret",
                           conv_impl="interpret")
    variables = _numpy_vars(jm, 0)
    pts, mask = _points()
    logits, dropped = jm.apply(variables, jnp.asarray(pts),
                               mask=jnp.asarray(mask), return_overflow=True)
    return variables, (pts, mask), np.asarray(logits), np.asarray(dropped)


def test_model_matches_jax_interpret_model(reference):
    variables, (pts, mask), want, jdropped = reference
    got, dropped = _port(SMALL, variables)(
        torch.from_numpy(pts), torch.from_numpy(mask), return_overflow=True)
    got = got.numpy()
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print(f"sparse U-Net logits vs the JAX interpret-mode model: max|err| "
          f"{err:.3e} at max|logit| {scale:.3f}")
    assert got.shape == want.shape and np.isfinite(got).all()
    assert err <= LOGITS_REL * scale, err
    assert not got[~mask].any()
    np.testing.assert_array_equal(dropped.numpy(), jdropped)


def test_unfused_jax_chain_differs_by_the_up_rounding(reference):
    """On the CPU the JAX model's default (``fused_ln=True``) takes the
    unfused chain, whose non-raw ``block_up2x`` skips the bf16 rounding of
    the fused raw form the port follows: a few bf16 ulps of the logits'
    scale (printed; a known divergence inside the JAX package)."""
    variables, (pts, mask), _, _ = reference
    want = np.asarray(JaxSparseVoxelNet(**SMALL).apply(
        variables, jnp.asarray(pts), mask=jnp.asarray(mask)))
    got = _port(SMALL, variables)(torch.from_numpy(pts),
                                  torch.from_numpy(mask)).numpy()
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print(f"sparse U-Net logits vs the JAX unfused CPU chain: max|err| "
          f"{err:.3e} at max|logit| {scale:.3f}")
    assert err <= LOGITS_REL * scale, err


def test_overflow_counts_match_jax(reference):
    """At capacities that drop tiles at both levels, the forward's count
    and overflow_counts equal the JAX model's."""
    variables, (pts, mask), _, _ = reference
    kw = dict(SMALL, max_tiles=12, max_tiles_schedule=(12, 4))
    jm = JaxSparseVoxelNet(**kw)
    jp, jmask = jnp.asarray(pts), jnp.asarray(mask)
    want = np.asarray(jm.overflow_counts(jp, jmask))
    _, jdropped = jm.apply(variables, jp, mask=jmask, return_overflow=True)
    np.testing.assert_array_equal(np.asarray(jdropped), want)
    assert want.min() > 0
    model = _port(kw, variables)
    tp, tmask = torch.from_numpy(pts), torch.from_numpy(mask)
    np.testing.assert_array_equal(model.overflow_counts(tp, tmask).numpy(),
                                  want)
    _, dropped = model(tp, tmask, return_overflow=True)
    np.testing.assert_array_equal(dropped.numpy(), want)
    assert model.tile_cap(0) == jm._tile_cap(0) == 12
    assert model.tile_cap(3) == jm._tile_cap(3) == 4


def test_predictor_warns_and_raises_on_overflow(reference):
    variables = reference[0]
    kw = dict(SMALL, max_tiles=8)
    event = _points()[0][0]
    pred = Predictor(from_jax_variables(variables), C,
                     model=SparseVoxelNet(**kw), device="cpu")
    with pytest.warns(UserWarning, match="capacity overflow"):
        assert pred.predict(event).shape == (event.shape[0],)
    strict = Predictor(from_jax_variables(variables), C,
                       model=SparseVoxelNet(**kw), device="cpu",
                       strict_capacity=True)
    with pytest.raises(RuntimeError, match="capacity overflow"):
        strict.predict_batch([event, event[:100]])
    # in capacity: no warning
    roomy = Predictor(from_jax_variables(variables), C,
                      model=SparseVoxelNet(**SMALL), device="cpu",
                      strict_capacity=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        roomy.predict_batch([event, event[:100]])


def test_checkpoint_of_carried_weights_serves(reference, tmp_path):
    """JAX weights carried across, saved as a port checkpoint with the
    sparse config, rebuilt by the factory and served through api.predict;
    the config (schedule and strict_capacity included) round-trips."""
    variables, (pts, mask), _, _ = reference
    cfg = ModelConfig(name="sparse_voxelnet", grid_size=16, unet_width=16,
                      depth=2, levels=2, tile=4, max_tiles=48,
                      max_tiles_schedule=(48, 24), compute_dtype="bfloat16",
                      strict_capacity=True)
    path = str(tmp_path / "sparse.pt")
    save_checkpoint(path, from_jax_variables(variables), C, cfg)
    _, nc, back = load_checkpoint(path)
    assert nc == C and back == cfg
    pred = api.predictor(path, device="cpu")
    assert pred.strict_capacity
    assert pred.model.max_tiles_schedule == (48, 24)
    event = pts[0]
    want = _port(dict(SMALL, max_tiles_schedule=(48, 24)), variables)(
        torch.from_numpy(event[None]))[0].argmax(-1).numpy()
    np.testing.assert_array_equal(api.predict(path, event, device="cpu"),
                                  want)


def test_factory_default_matches_jax():
    """ModelConfig(name="sparse_voxelnet") at its defaults (64^3, tile 8,
    width 16, depth 4, one level, f32) in both packages; the JAX model on
    the CPU takes its unfused chain, which in f32 at one level computes
    the same function: f32 sums in another order, 1e-4 of scale."""
    cfg_j, cfg_p = JaxModelConfig(name="sparse_voxelnet"), \
        ModelConfig(name="sparse_voxelnet")
    for name in ("impl", "depth", "max_active", "max_tiles", "tile",
                 "max_tiles_schedule", "strict_capacity", "unet_width",
                 "grid_size", "compute_dtype", "voxelize_impl"):
        assert getattr(cfg_p, name) == getattr(cfg_j, name), name
    jm = jax_build_model(cfg_j, C)
    model = build_model(cfg_p, C)
    for name in ("width", "depth", "levels", "tile", "max_tiles",
                 "compute_dtype", "impl", "grid_size"):
        assert getattr(model, name) == getattr(jm, name), name
    variables = _numpy_vars(jm, 1)
    pts, mask = _points(3)
    want = np.asarray(jm.apply(variables, jnp.asarray(pts),
                               mask=jnp.asarray(mask)))
    model.load_state_dict(from_jax_variables(variables))
    got = model(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), err


def test_track_events_match_bench_batch():
    want = _track_batch(np.random.default_rng(5), 3, 1000)
    np.testing.assert_array_equal(track_events(3, 1000, 5), want)
