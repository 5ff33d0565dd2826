"""The port's PointNetSeg serving (``Predictor`` on the CPU: the BN-folded
chain of ops/fold.py and models/pointnet.pointnet_apply_folded, and the
unfolded model with its pool masked) against the JAX package's
``Predictor`` on the same variables, made with numpy.

Tolerances: f32 on both sides, products summed in another order, so the
folded and the unfolded logits are held to 1e-5 of max |logit|. In bf16
both round every layer's operands at the same points, but a product that
lands next to a bf16 rounding boundary may round the other way and the
flip travels on: 2^-7 of max |logit|, and >= 99.9 % argmax agreement.
"""

import numpy as np
import pytest
import torch

from pcseg_tpu.infer import Predictor as JaxPredictor
from pcseg_tpu.models.pointnet import PointNetSeg as JaxPointNetSeg
from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.infer import Predictor
from pcseg_tpu_torch.models.pointnet import BN_FOR, PointNetSeg, _stages

torch.set_num_threads(1)

NUM_CLASSES = 4
BUCKETS = (128, 256, 512)


def pointnet_variables(seed=0, num_classes=NUM_CLASSES):
    """Full-width PointNetSeg variables in the JAX nested numpy form:
    uniform layers as torch's Conv1d init, random BN terms and running
    statistics (a trained model's, not the init's 1 / 0 / 0 / 1)."""
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for name, din, dout in _stages(num_classes, 4):
        bound = din ** -0.5
        params[name] = {
            "kernel": rng.uniform(-bound, bound, (din, dout)),
            "bias": rng.uniform(-bound, bound, dout)}
        bn = BN_FOR.get(name)
        if bn is not None:
            params[bn] = {"scale": rng.uniform(0.5, 1.5, dout),
                          "bias": rng.normal(size=dout) * 0.1}
            var = rng.uniform(0.5, 1.5, dout)
            var[rng.random(dout) < 0.05] = 1e-4   # nearly dead channels
            stats[bn] = {"mean": rng.normal(size=dout) * 0.1, "var": var}

    def f32(tree):
        return {k: {leaf: np.asarray(v, np.float32) for leaf, v in g.items()}
                for k, g in tree.items()}

    return {"params": f32(params), "batch_stats": f32(stats)}


def events(seed=1, sizes=(60, 97, 128, 200, 333, 450)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 4)).astype(np.float32) for n in sizes]


@pytest.fixture(scope="module")
def variables():
    return pointnet_variables()


def _pair(variables, **kw):
    jax_pred = JaxPredictor(variables, NUM_CLASSES, buckets=BUCKETS, **kw)
    pred = Predictor(from_jax_variables(variables), NUM_CLASSES,
                     buckets=BUCKETS, device="cpu", **kw)
    return jax_pred, pred


def _logits(pred, evs):
    return np.concatenate([pred.logits(e) for e in evs])


@pytest.mark.parametrize("fold", [True, False])
def test_f32_serving_matches_jax(variables, fold):
    jax_pred, pred = _pair(variables, fold=fold)
    assert isinstance(pred.model, PointNetSeg)
    evs = events()
    ref = _logits(jax_pred, evs)
    got = _logits(pred, evs)
    assert got.dtype == np.float32 and got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= 1e-5 * float(np.abs(ref).max()), err


def test_bf16_serving_matches_jax(variables):
    jax_pred, pred = _pair(variables, dtype="bfloat16")
    evs = events(2, sizes=(500, 400, 300, 512, 470))
    ref = _logits(jax_pred, evs)
    got = _logits(pred, evs)
    scale = float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= 2.0 ** -7 * scale
    agree = float((got.argmax(-1) == ref.argmax(-1)).mean())
    assert agree >= 0.999, agree


def test_folded_matches_unfolded(variables):
    """Within the port: the folded f32 chain against the eval-mode model
    with its pool masked (ops/fold.py's identity)."""
    state = from_jax_variables(variables)
    folded = Predictor(state, NUM_CLASSES, buckets=BUCKETS, device="cpu")
    plain = Predictor(state, NUM_CLASSES, buckets=BUCKETS, device="cpu",
                      fold=False)
    evs = events(3)
    ref = _logits(plain, evs)
    err = float(np.abs(_logits(folded, evs) - ref).max())
    assert err <= 1e-5 * float(np.abs(ref).max()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_batch_matches_predict(variables, dtype):
    """Padding invariance: an event alone (its own bucket, batch 1) and
    inside a padded batch of 4 with a dummy row predict the same."""
    _, pred = _pair(variables, dtype=dtype)
    evs = events(4, sizes=(70, 130, 90, 256, 31, 400, 200))
    batched = pred.predict_batch(evs, batch_size=4)
    for e, got in zip(evs, batched):
        alone = pred.predict(e)
        assert got.shape == (e.shape[0],)
        assert float((got == alone).mean()) >= 0.999


@pytest.mark.parametrize("fold", [True, False])
def test_padding_never_wins_the_pool(variables, fold):
    """Rows outside the mask hold large values here (Predictor pads with
    zeros, which may not win either): the valid rows' logits are those of
    the event alone, in the port and in the JAX folded forward."""
    from pcseg_tpu.models.pointnet import pointnet_apply_folded as jax_apply
    from pcseg_tpu.ops.fold import fold_pointnet as jax_fold

    _, pred = _pair(variables, fold=fold)
    ev = events(5, sizes=(100,))[0]
    padded = np.full((1, 256, 4), 50.0, np.float32)
    padded[0, :100] = ev
    mask = np.zeros((1, 256), bool)
    mask[0, :100] = True
    got = pred.device_forward(torch.from_numpy(padded),
                              torch.from_numpy(mask))[0, :100].numpy()
    alone = pred.device_forward(torch.from_numpy(ev[None]),
                                torch.ones((1, 100), dtype=torch.bool))
    ref = alone[0].numpy()
    assert float(np.abs(got - ref).max()) <= 1e-5 * float(np.abs(ref).max())
    if fold:
        want = np.asarray(jax_apply(jax_fold(variables), padded,
                                    compute_dtype=np.float32,
                                    pool_mask=mask))[0, :100]
        assert float(np.abs(got - want).max()) <= 1e-5 * float(
            np.abs(want).max())


def test_unfolded_fused_bn_stats_raises(variables):
    state = from_jax_variables(variables)
    model = PointNetSeg(NUM_CLASSES, bn_stats="fused")
    with pytest.raises(ValueError, match="mask_norm_and_pool"):
        Predictor(state, NUM_CLASSES, model=model, fold=False, device="cpu")
    with pytest.raises(ValueError, match="mask_norm_and_pool"):
        JaxPredictor(variables, NUM_CLASSES, fold=False,
                     model=JaxPointNetSeg(NUM_CLASSES, bn_stats="fused"))
    # folded serving reads only the weights and running stats
    pred = Predictor(state, NUM_CLASSES, model=model, device="cpu")
    assert pred.predict(events()[0]).shape == (60,)
    with pytest.raises(ValueError, match="dtype"):
        Predictor(state, NUM_CLASSES, dtype="float16", device="cpu")
