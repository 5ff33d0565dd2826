"""JAX checkpoint directories in the port (``ckpt/checkpoint.py``): the
port's msgpack decoder against the ``msgpack`` library and flax, and
directories written by the JAX package's ``save_checkpoint`` (a whole
TrainState: step, params, batch_stats and the optax state, as
``train_model`` saves it) read bit for bit for all three families, served
by ``Predictor.from_checkpoint`` with the logits of a ``Predictor`` built
from ``from_jax_variables`` of the same weights, and evaluated by
``api.evaluate`` as the same weights in the port's own file. Resuming
training from such a directory is refused (its optax state is not
ported)."""

import dataclasses

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from pcseg_tpu.ckpt.checkpoint import save_checkpoint as jax_save
from pcseg_tpu.core.config import ModelConfig as JaxModelConfig
from pcseg_tpu.models.sparse_unet import SparseVoxelNet as JaxSparseVoxelNet
from pcseg_tpu.models.voxel_unet import VoxelUNet3d as JaxVoxelUNet3d
from pcseg_tpu.train.optim import make_optimizer
from pcseg_tpu.train.steps import TrainState as JaxTrainState
from pcseg_tpu_torch import api
from pcseg_tpu_torch.ckpt.checkpoint import (
    load_checkpoint,
    load_jax_checkpoint,
    msgpack_decode,
    save_checkpoint,
)
from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.core.config import ModelConfig
from pcseg_tpu_torch.data.synthetic import synthetic_events, track_events
from pcseg_tpu_torch.infer import Predictor
from pcseg_tpu_torch.models.factory import build_model
from tests import test_torch_pointnet as pn
from tests import test_torch_sparse_unet as sp
from tests import test_torch_voxel_train as vt

torch.set_num_threads(1)

C = 4
FAMILIES = {
    "pointnet_seg": dict(name="pointnet_seg"),
    "voxel_unet3d": dict(name="voxel_unet3d", grid_size=8, unet_width=8,
                         levels=2, compute_dtype="float32", impl="xla",
                         voxelize_impl="scatter", devox_impl="gather"),
    "sparse_voxelnet": dict(name="sparse_voxelnet", grid_size=16,
                            unet_width=16, depth=2, levels=2, tile=4,
                            max_tiles=48, compute_dtype="bfloat16"),
}


def _variables(family):
    if family == "pointnet_seg":
        return pn._numpy_vars(3)
    if family == "voxel_unet3d":
        return vt._numpy_vars(JaxVoxelUNet3d(**vt.XLA_F32), 4)
    return sp._numpy_vars(JaxSparseVoxelNet(**sp.SMALL), 5)


def _jax_dir(path, family, variables, with_config=True):
    """A JAX TrainState directory, as the JAX ``train_model`` writes one."""
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.asarray(7, jnp.int32), params=params,
                          batch_stats=variables["batch_stats"],
                          opt_state=make_optimizer().init(params))
    meta = {"epoch": 3, "num_classes": C, "class_weights": [1, 2, 0.5, 1],
            "val_loss": 1.25}
    if with_config:
        meta["config"] = {"model": dataclasses.asdict(
            JaxModelConfig(**FAMILIES[family]))}
    jax_save(path, state, meta)
    return path


def _tree_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _tree_equal(got[k], want[k])
        else:
            w = np.asarray(want[k])
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            assert got[k].tobytes() == w.tobytes(), k


def _events(family, n=6):
    if family == "sparse_voxelnet":
        return [p for p in track_events(n, 300, 4)]
    return [p for p, _ in synthetic_events(n, min_points=20, max_points=200,
                                           seed=9)]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jax_directory_serves_as_carried_weights(tmp_path, family):
    variables = _variables(family)
    path = _jax_dir(str(tmp_path / "ck"), family, variables)
    got, meta = load_jax_checkpoint(path)
    _tree_equal(got, {"params": variables["params"],
                      "batch_stats": variables["batch_stats"]})
    assert meta["num_classes"] == C and meta["epoch"] == 3
    sd, nc, cfg = load_checkpoint(path)
    assert nc == C and cfg == ModelConfig(**FAMILIES[family])
    want_sd = from_jax_variables(variables)
    assert sd.keys() == want_sd.keys()
    assert all(torch.equal(sd[k], want_sd[k]) for k in sd)

    served = Predictor.from_checkpoint(path, device="cpu")
    ref = Predictor(want_sd, C, model=build_model(cfg, C), device="cpu")
    assert type(served.model) is type(ref.model)
    for pts in _events(family):
        a, b = served.logits(pts), ref.logits(pts)
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("family", ["pointnet_seg", "voxel_unet3d"])
def test_evaluate_jax_directory(tmp_path, family):
    variables = _variables(family)
    path = _jax_dir(str(tmp_path / "ck"), family, variables)
    port = save_checkpoint(str(tmp_path / "port.pt"),
                           from_jax_variables(variables), C,
                           ModelConfig(**FAMILIES[family]),
                           metadata={"class_weights": [1, 2, 0.5, 1]})
    events = list(synthetic_events(8, min_points=20, max_points=200, seed=2))
    kw = dict(batch_size=4, buckets=(256,), device="cpu")
    assert api.evaluate(path, events, **kw) == api.evaluate(port, events,
                                                            **kw)


def test_directory_without_config_is_a_pointnet(tmp_path):
    variables = _variables("pointnet_seg")
    path = _jax_dir(str(tmp_path / "ck"), "pointnet_seg", variables,
                    with_config=False)
    _, nc, cfg = load_checkpoint(path)
    assert nc == C and cfg == ModelConfig()
    served = Predictor.from_checkpoint(path, device="cpu")
    ref = Predictor(from_jax_variables(variables), C, device="cpu")
    pts = _events("pointnet_seg", 1)[0]
    assert served.logits(pts).tobytes() == ref.logits(pts).tobytes()


def test_resume_from_a_jax_directory_is_refused(tmp_path):
    path = _jax_dir(str(tmp_path / "ck"), "pointnet_seg",
                    _variables("pointnet_seg"))
    events = list(synthetic_events(6, min_points=20, max_points=100, seed=1))
    with pytest.raises(NotImplementedError, match="optax state"):
        api.fit(events, resume_from=path, device="cpu", log=lambda *a: None)


def test_msgpack_decoder_matches_the_library():
    value = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32,
                      2**64 - 1, -1, -32, -33, -128, -129, -2**15 - 1,
                      -2**31 - 1, -2**63],
             "floats": [0.5, -1e300, float("inf")], "flags": [True, False,
                                                           None],
             "text": ["", "a" * 31, "b" * 32, "é" * 300, "c" * 70000],
             "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
             "nested": {str(i): list(range(i)) for i in range(20)},
             "wide": list(range(70000))}
    blob = msgpack.packb(value, use_bin_type=True)
    assert msgpack_decode(blob) == msgpack.unpackb(blob, raw=False)
    # what flax writes: ext 1 ndarrays (bf16 widened), ext 3 scalars
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "i": np.arange(5, dtype=np.int64), "s": np.float32(2.5),
            "e": np.zeros((0, 3), np.float16),
            "bf": jnp.asarray([[1.5, -2.0], [0.0, 3.0]], jnp.bfloat16),
            "n": [1, {"k": None}]}
    got = msgpack_decode(serialization.to_bytes(tree))
    want = serialization.msgpack_restore(serialization.to_bytes(tree))
    for k in ("a", "i", "e"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()
    assert got["s"] == want["s"] and got["s"].dtype == np.float32
    assert got["bf"].dtype == np.float32
    assert got["bf"].tolist() == np.asarray(want["bf"], np.float32).tolist()
    assert got["n"] == want["n"]


def test_msgpack_decoder_refuses_what_it_does_not_read():
    with pytest.raises(NotImplementedError, match="ext type 2"):
        msgpack_decode(serialization.to_bytes({"c": 1 + 2j}))
    chunked = msgpack.packb({"w": {"__msgpack_chunked_array__": True,
                                   "shape": {"0": 2}, "chunks": {}}})
    with pytest.raises(NotImplementedError, match="chunked array"):
        msgpack_decode(chunked)
    with pytest.raises(ValueError, match="trailing"):
        msgpack_decode(msgpack.packb(1) + b"\x00")
