"""The port's own checkpoint: one file holding the tensors, the class
count and the model config as JSON, and for a training run the optimizer
state and metadata (epoch, metrics, class weights).

A training run writes two: the best model (``train.checkpoint_name``) on
improvement, and the rolling resume target ``latest.pt``
(``latest_path``) every ``train.save_latest_every`` epochs, both in
``train.checkpoint_dir``. The 'latest' metadata carries the JAX package's
keys (``epoch``, ``num_classes``, ``class_weights``, ``config``,
``best_f1_target``, ``best_val_loss``, ``best_epoch``,
``patience_counter``) and the optimizer ``step``; ``train_model
(resume_from=)`` reads either checkpoint.

Written with ``torch.save`` to a temporary file in the same directory and
renamed into place, so a crash never leaves a torn checkpoint; read with
``torch.load(weights_only=True)``, which unpickles tensors and plain
containers only.

``load_checkpoint`` and ``load_train_state`` also read the JAX package's
checkpoint directories (``state.msgpack`` + ``meta.json``,
pcseg_tpu/ckpt/checkpoint.py) of any family, so a model trained with the
JAX package serves here: ``load_jax_checkpoint`` decodes what
``flax.serialization.to_bytes`` wrote with the port's own msgpack decoder
(``msgpack_decode``: maps, arrays, strings, binaries, ints, floats, bools,
nil; ext 1, an ndarray as (shape, dtype name, bytes), and ext 3, a numpy
scalar; bfloat16 arrays widen to float32), ``meta.json``'s
``config.model`` rebuilds the model and ``convert.from_jax_variables``
carries the weights. Any other ext, and flax's chunked form of arrays
past 2^30 bytes, raise naming it.

A JAX directory of a whole TrainState (``step``, ``params``,
``batch_stats``, ``opt_state``, as the JAX ``train_model`` saves it) also
resumes training: ``load_train_state(path, model, optimizer)`` maps the
optax chain's Adam state (``opt_state`` = {"0": add_decayed_weights'
empty state, "1": {"count", "mu", "nu"}}, ``mu`` / ``nu`` nested as the
parameters) onto ``torch.optim.Adam``'s per-parameter ``step`` /
``exp_avg`` / ``exp_avg_sq`` under the names ``from_jax_variables`` gives
the parameters, and adds the TrainState's ``step`` to ``meta.json``'s
epoch and selection state. A directory without that Adam state raises.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile

import numpy as np
import torch

from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.core.config import ModelConfig

LATEST_NAME = "latest.pt"


def latest_path(checkpoint_dir: str) -> str:
    """Where a training run writes its 'latest' checkpoint."""
    return os.path.join(checkpoint_dir, LATEST_NAME)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, state_dict: dict, num_classes: int,
                    config: ModelConfig, *, optimizer_state: dict | None = None,
                    metadata: dict | None = None) -> str:
    """``state_dict``: the model's (parameters and BN running stats);
    ``optimizer_state``: ``torch.optim.Optimizer.state_dict()`` of a
    training run; ``metadata``: JSON-serializable run facts."""
    payload = {
        "state_dict": _to_cpu(dict(state_dict)),
        "num_classes": int(num_classes),
        "config": json.dumps(config.to_dict()),
    }
    if optimizer_state is not None:
        payload["optimizer"] = _to_cpu(optimizer_state)
    if metadata is not None:
        payload["metadata"] = json.dumps(metadata, default=float)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str):
    """-> (state_dict of CPU tensors, num_classes, ModelConfig) of the
    port's checkpoint file or a JAX checkpoint directory (its
    ``config.model``, PointNetSeg's defaults where it has none)."""
    if is_jax_checkpoint(path):
        variables, meta = load_jax_checkpoint(path)
        cfg = ModelConfig(**((meta.get("config") or {}).get("model") or {}))
        return from_jax_variables(variables), int(meta["num_classes"]), cfg
    payload = torch.load(path, map_location="cpu", weights_only=True)
    cfg = ModelConfig(**json.loads(payload["config"]))
    return payload["state_dict"], int(payload["num_classes"]), cfg


def load_train_state(path: str, model: torch.nn.Module | None = None,
                     optimizer: torch.optim.Optimizer | None = None):
    """-> (optimizer state_dict or None, metadata dict) of a training
    checkpoint. A JAX directory: with the ``model`` and its Adam
    ``optimizer`` to resume, its optax state as ``optimizer``'s state_dict
    and its ``meta.json`` with the TrainState's ``step``
    (``jax_adam_state``); without them None and its ``meta.json``."""
    if is_jax_checkpoint(path):
        if optimizer is None:
            return None, _jax_meta(path)
        return jax_adam_state(path, model, optimizer)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta = json.loads(payload["metadata"]) if "metadata" in payload else {}
    return payload.get("optimizer"), meta


# -- JAX checkpoint directories

def is_jax_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "state.msgpack"))


def _jax_meta(path: str) -> dict:
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def load_jax_checkpoint(path: str):
    """A JAX checkpoint directory -> ({"params": ..., "batch_stats": ...}
    with numpy leaves, metadata dict)."""
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        state = msgpack_decode(f.read())
    variables = {k: state.get(k) or {} for k in ("params", "batch_stats")}
    return variables, _jax_meta(path)


def _leaves(tree: dict) -> dict:
    """{name: {leaf: array}} -> {"name.leaf": array}, as
    ``from_jax_variables`` names the parameters."""
    return {f"{name}.{leaf}": arr for name, group in tree.items()
            for leaf, arr in group.items()}


def jax_adam_state(path: str, model: torch.nn.Module,
                   optimizer: torch.optim.Optimizer):
    """A JAX TrainState directory -> (``optimizer``'s state_dict holding
    the optax Adam state, metadata with the TrainState's ``step``). optax's
    ``count`` is each parameter's Adam ``step`` (both count the updates
    made; the bias corrections use the count after the next one), ``mu``
    its ``exp_avg`` and ``nu`` its ``exp_avg_sq``, bit for bit."""
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        state = msgpack_decode(f.read())
    opt = state.get("opt_state")
    adam = opt.get("1") if isinstance(opt, dict) else None
    if not (isinstance(adam, dict) and {"count", "mu", "nu"} <= adam.keys()):
        raise ValueError(f"{path} holds no optax Adam state (an opt_state "
                         "with count / mu / nu): serve or evaluate it, or "
                         "train from its weights without resume_from")
    mu, nu = _leaves(adam["mu"]), _leaves(adam["nu"])
    names = [n for n, _ in model.named_parameters()]
    if set(names) != set(mu) or set(names) != set(nu):
        raise ValueError(f"{path}: the optax state's parameters "
                         f"{sorted(set(mu) ^ set(names))} do not match the "
                         "model's")
    sd = optimizer.state_dict()
    ids = [i for group in sd["param_groups"] for i in group["params"]]
    if len(ids) != len(names):
        raise ValueError("the optimizer must hold every parameter of the "
                         "model, in its order")
    count = float(np.asarray(adam["count"]))
    sd["state"] = {i: {"step": torch.tensor(count),
                       "exp_avg": torch.from_numpy(np.array(mu[n])),
                       "exp_avg_sq": torch.from_numpy(np.array(nu[n]))}
                   for i, n in zip(ids, names)}
    meta = dict(_jax_meta(path), step=int(np.asarray(state["step"])))
    return sd, meta


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, data = msgpack_decode(payload)
    if name == "bfloat16":
        bits = np.frombuffer(data, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(data, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, payload: bytes):
    if code == 1:
        return _ndarray(payload)
    if code == 3:
        return _ndarray(payload)[()]
    raise NotImplementedError(f"msgpack ext type {code} (the port reads "
                              "ext 1, ndarray, and ext 3, numpy scalar)")


def msgpack_decode(data: bytes):
    """Decode one msgpack value (the subset flax writes, see the module
    docstring)."""
    value, end = _decode(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes after the "
                         "msgpack value")
    return value


def _decode(buf, p: int):
    b = buf[p]
    p += 1
    if b <= 0x7F:
        return b, p
    if b >= 0xE0:
        return b - 0x100, p
    if 0x80 <= b <= 0x8F:
        return _map(buf, p, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _array(buf, p, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return bytes(buf[p : p + n]).decode(), p + n
    if b == 0xC0:
        return None, p
    if b in (0xC2, 0xC3):
        return b == 0xC3, p
    fixed = _FIXED.get(b)
    if fixed is not None:
        (v,) = struct.unpack_from(fixed, buf, p)
        return v, p + struct.calcsize(fixed)
    sized = _SIZED.get(b)
    if sized is not None:
        kind, fmt = sized
        (n,) = struct.unpack_from(fmt, buf, p)
        p += struct.calcsize(fmt)
        if kind == "str":
            return bytes(buf[p : p + n]).decode(), p + n
        if kind == "bin":
            return bytes(buf[p : p + n]), p + n
        if kind == "array":
            return _array(buf, p, n)
        if kind == "map":
            return _map(buf, p, n)
        code = struct.unpack_from(">b", buf, p)[0]
        return _ext(code, bytes(buf[p + 1 : p + 1 + n])), p + 1 + n
    if 0xD4 <= b <= 0xD8:                       # fixext 1..16
        n = 1 << (b - 0xD4)
        code = struct.unpack_from(">b", buf, p)[0]
        return _ext(code, bytes(buf[p + 1 : p + 1 + n])), p + 1 + n
    raise ValueError(f"msgpack type byte {b:#x} at {p - 1} is not valid")


def _array(buf, p: int, n: int):
    out = []
    for _ in range(n):
        v, p = _decode(buf, p)
        out.append(v)
    return out, p


def _map(buf, p: int, n: int):
    out = {}
    for _ in range(n):
        k, p = _decode(buf, p)
        v, p = _decode(buf, p)
        out[k] = v
    if out.get("__msgpack_chunked_array__"):
        raise NotImplementedError("flax's chunked array (an array past 2^30 "
                                  "bytes) is not read by the port")
    return out, p


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
