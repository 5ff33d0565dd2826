"""Test-only writer of the JAX package's checkpoint directories, without
JAX, flax or the msgpack package: ``state.msgpack`` holds what
``flax.serialization.to_bytes`` writes for a TrainState (``step``,
``params``, ``batch_stats``, ``opt_state``, the last the optax chain of
``add_decayed_weights`` and ``scale_by_adam``), ``meta.json`` the
metadata. tests/test_torch_jax_resume.py holds its bytes to flax's; the
card's smoke script writes one with it and resumes training from it, since
that machine has no JAX.
"""

import json
import os
import struct

import numpy as np


def _pack(v, out: list) -> None:
    """Append msgpack's encoding of ``v``: the types flax writes, each in
    its shortest form (as the msgpack package packs them)."""
    if v is None:
        out.append(b"\xc0")
    elif isinstance(v, (bool, np.bool_)):
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, np.ndarray) or isinstance(v, np.generic):
        a = np.asarray(v)
        body = []
        _pack([list(a.shape), a.dtype.name, a.tobytes()], body)
        _ext(1, b"".join(body), out)
    elif isinstance(v, int):
        _int(v, out)
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        data = v.encode()
        n = len(data)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        elif n < 2 ** 8:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n < 2 ** 16:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(data)
    elif isinstance(v, bytes):
        n = len(v)
        fmt = (b"\xc4", ">B") if n < 2 ** 8 else (
            (b"\xc5", ">H") if n < 2 ** 16 else (b"\xc6", ">I"))
        out.append(fmt[0] + struct.pack(fmt[1], n) + v)
    elif isinstance(v, (list, tuple)):
        _header(len(v), 0x90, b"\xdc", b"\xdd", out)
        for x in v:
            _pack(x, out)
    elif isinstance(v, dict):
        _header(len(v), 0x80, b"\xde", b"\xdf", out)
        for k, x in v.items():
            _pack(k, out)
            _pack(x, out)
    else:
        raise TypeError(f"cannot pack {type(v)}")


def _header(n, fix, b16, b32, out):
    if n < 16:
        out.append(bytes([fix | n]))
    elif n < 2 ** 16:
        out.append(b16 + struct.pack(">H", n))
    else:
        out.append(b32 + struct.pack(">I", n))


def _int(v, out):
    if 0 <= v < 128:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, top in ((b"\xcc", ">B", 2 ** 8), (b"\xcd", ">H", 2 ** 16),
                               (b"\xce", ">I", 2 ** 32), (b"\xcf", ">Q", 2 ** 64)):
            if v < top:
                out.append(code + struct.pack(fmt, v))
                return
        raise OverflowError(v)
    else:
        for code, fmt, low in ((b"\xd0", ">b", -2 ** 7), (b"\xd1", ">h", -2 ** 15),
                               (b"\xd2", ">i", -2 ** 31), (b"\xd3", ">q", -2 ** 63)):
            if v >= low:
                out.append(code + struct.pack(fmt, v))
                return
        raise OverflowError(v)


def _ext(code, data, out):
    n = len(data)
    fixed = {1: b"\xd4", 2: b"\xd5", 4: b"\xd6", 8: b"\xd7", 16: b"\xd8"}
    if n in fixed:
        out.append(fixed[n])
    elif n < 2 ** 8:
        out.append(b"\xc7" + struct.pack(">B", n))
    elif n < 2 ** 16:
        out.append(b"\xc8" + struct.pack(">H", n))
    else:
        out.append(b"\xc9" + struct.pack(">I", n))
    out.append(struct.pack(">b", code) + data)


def msgpack_encode(value) -> bytes:
    out: list = []
    _pack(value, out)
    return b"".join(out)


def _f32(tree: dict) -> dict:
    return {name: {leaf: np.ascontiguousarray(a, np.float32)
                   for leaf, a in group.items()}
            for name, group in tree.items()}


def write_jax_checkpoint(path: str, step: int, params: dict,
                         batch_stats: dict, count: int, mu: dict, nu: dict,
                         meta: dict) -> str:
    """A JAX TrainState directory at ``path``: ``params``, ``batch_stats``,
    ``mu`` and ``nu`` nested {name: {leaf: array}} (written f32), ``step``
    the TrainState's and ``count`` the Adam state's int32 counter."""
    state = {"step": np.asarray(step, np.int32), "params": _f32(params),
             "batch_stats": _f32(batch_stats),
             "opt_state": {"0": {}, "1": {
                 "count": np.asarray(count, np.int32), "mu": _f32(mu),
                 "nu": _f32(nu)}}}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "state.msgpack"), "wb") as f:
        f.write(msgpack_encode(state))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=float)
    return path
