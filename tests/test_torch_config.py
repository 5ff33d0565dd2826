"""The port's ``Config.to_json`` / ``Config.from_dict`` against the JAX
package's (pcseg_tpu/core/config.py): a round trip gives the config back,
both packages write the same fields with equal values (the seven
parallel fields too), an unknown field raises KeyError naming it, and a
JAX-written config loads whole."""

import dataclasses
import json

import pytest

from pcseg_tpu.core import config as jax_config
from pcseg_tpu_torch.core import config as port_config

# the JAX TrainConfig's parallel fields, which the port shares
PARALLEL = ("data_parallel", "model_parallel", "parallelism",
            "coordinator_address", "num_processes", "process_id",
            "sync_batchnorm")
# a value off the default in every section, the same in both packages
OVERRIDES = ["data.batch_size=16", "data.buckets=128,1024",
             "data.val_fraction=0.25", "model.name=sparse_voxelnet",
             "model.max_tiles_schedule=64,32", "model.remat=true",
             "model.dropout=0.1", "optim.lr=3e-4", "optim.lr_gamma=0.7",
             "train.checkpoint_name=run7", "train.num_epochs=5",
             "train.metrics_log=m.jsonl", "train.data_parallel=2",
             "train.sync_batchnorm=true"]


def _pair(overrides=()):
    port = port_config.apply_overrides(port_config.Config(), overrides)
    jax = jax_config.apply_overrides(jax_config.Config(), overrides)
    return port, jax


@pytest.mark.parametrize("overrides", [[], OVERRIDES],
                         ids=["defaults", "overridden"])
def test_round_trip(overrides):
    port, _ = _pair(overrides)
    text = port.to_json()
    back = port_config.Config.from_dict(json.loads(text))
    assert back == port
    assert isinstance(back.data.buckets, tuple)
    assert isinstance(back.model.max_tiles_schedule, tuple)
    assert back.to_json() == text


@pytest.mark.parametrize("overrides", [[], OVERRIDES],
                         ids=["defaults", "overridden"])
def test_to_json_matches_jax_on_shared_fields(overrides):
    """Both packages write the same fields, the parallel ones included,
    each with the same value in both JSON texts, but the checkpoint name's
    default: the port's checkpoints are ``.pt`` files
    (``best_model.pt``), the JAX package's directories."""
    port, jax = _pair(overrides)
    mine, theirs = json.loads(port.to_json()), json.loads(jax.to_json())
    assert mine.keys() == theirs.keys()
    assert set(PARALLEL) <= set(mine["train"])
    for section in mine:
        assert set(theirs[section]) == set(mine[section]), section
        for k, v in mine[section].items():
            if not overrides and k == "checkpoint_name":
                assert (v, theirs[section][k]) == ("best_model.pt",
                                                   "best_model")
                continue
            assert theirs[section][k] == v, (section, k)


def test_from_dict_of_a_jax_config():
    """A JAX-written JSON (a JAX checkpoint's ``meta.json`` config too)
    loads whole, to the JAX values, the overridden parallel fields
    among them."""
    _, jax = _pair(OVERRIDES)
    d = json.loads(jax.to_json())
    got = port_config.Config.from_dict(d)
    assert got.train.data_parallel == 2 and got.train.sync_batchnorm
    for section in ("data", "model", "optim", "train"):
        for f in dataclasses.fields(getattr(got, section)):
            want = getattr(getattr(jax, section), f.name)
            assert getattr(getattr(got, section), f.name) == (
                tuple(want) if isinstance(want, (list, tuple)) else want)


def test_unknown_fields_raise():
    with pytest.raises(KeyError, match="unknown config field model.widht"):
        port_config.Config.from_dict({"model": {"widht": 3}})
    with pytest.raises(KeyError, match="unknown config section 'modle'"):
        port_config.Config.from_dict({"modle": {}})
    for cls in (port_config.Config, jax_config.Config):
        with pytest.raises(KeyError, match="optim.lrate"):
            cls.from_dict({"optim": {"lrate": 1.0}})
