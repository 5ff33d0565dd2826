"""Row 8's tensor-core layout (csrc/conv3d_block.cu ``head_fwd_kernel``),
emulated on the CPU.

The plan's rule (``head_fwd_plan``: k16 steps over the channels and the
steps the loads cover, n8 tiles over the classes, W^T's shared row
stride, the warps' y staging; the byte-streaming route at up to 4
classes) is restated here and the kernel's constants are read out of the
source. The emulation deals each batch element's m16 tiles of voxels to
blocks and warps as the kernel does (every (blocks x kFwdWarps)-th tile a
warp), builds each lane's A registers from its loads (rows g and g + 8:
channels 4 t .. + 3 at one k16 step, 32 p + 8 t .. + 7 of step pair p
where the steps load in pairs, ``head_fwd_ch``) and its B registers from
W^T's rows at the same channels, lays them on the mma's k slots as the
hardware reads them (slots 2 t, 2 t + 1 and 2 t + 8, 2 t + 9 of lane t),
applies the prologue to each A register by the channels the kernel infers
from the lane, takes each k16 step's product (summed here in f64 and
rounded once: the mma's own order inside a step is the hardware's), adds
the bias and rounds once to bf16. Every voxel's row must be written once
and the result must be the plain version's (``head_grid2_plain``) within
one bf16 step: 2^-7 of |ref| + 1e-4 of max |ref|, as the card tests hold
it.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pcseg_tpu_torch.ops import conv3d_block as cb

torch.set_num_threads(1)

SRC = Path(cb.__file__).resolve().parents[1] / "csrc" / "conv3d_block.cu"


def _consts(*keys):
    src = SRC.read_text()
    env = {}
    for key, expr in re.findall(
            r"constexpr (?:int|size_t) (\w+) = ([^;]+);", src):
        try:
            env[key] = eval(expr.replace("/", "//"), {}, dict(env))
        except (NameError, SyntaxError):
            continue
    return {k: env[k] for k in keys}


K = _consts("kFwdWarps", "kHeadMaxC", "kHeadMaxNC", "kSmemMax")


def plan(c, nc):
    """head_fwd_plan restated, and the route pcseg_head_grid2 takes."""
    ks = -(-c // 16)
    kp = 1 if ks == 1 else -(-ks // 2) * 2
    nt = -(-nc // 8)
    ws = 24 if ks == 1 else (16 * kp + 31) // 64 * 64 + 32
    ys = -(-16 * nc // 8) * 8
    ksm = 1 if ks <= 1 else 2 if ks <= 2 else 4 if ks <= 4 else 8
    return {"route": "stream" if nc <= 4 else "tensor cores", "ks": ks,
            "kp": kp, "ksm": ksm, "nt": nt, "ws": ws, "ys": ys,
            "smem": 2 * nt * 8 * ws + 8 * 16 * kp
            + 2 * K["kFwdWarps"] * ys}


def head_fwd_ch(ksm, s, t):
    """The channel of k slot 2 t of step s (slots 2 t + 1, 2 t + 8, 2 t
    + 9 take the next three)."""
    return 4 * t if ksm == 1 else 32 * (s // 2) + 8 * t + 4 * (s % 2)


def test_plan_takes_every_width_of_the_head():
    """64^3 x 16 -> 4 takes the byte-streaming route; 32^3 x 16 -> 20:
    one k16 step, 3 n8 tiles; C 128 -> 8: eight k16 steps loaded in pairs;
    every width head_shape_ok takes (C a multiple of 8 up to 128, 1 to 128
    classes) fits a block's shared memory, each step's lane map is a
    permutation of its 16 channels, and a half warp's 8-byte W^T reads of
    its class rows fall on distinct bank pairs or at worst two to a
    pair."""
    assert plan(16, 4)["route"] == "stream"
    p = plan(16, 20)
    assert (p["route"], p["ks"], p["nt"]) == ("tensor cores", 1, 3)
    assert (plan(128, 8)["ks"], plan(128, 8)["kp"]) == (8, 8)
    assert (K["kHeadMaxC"], K["kHeadMaxNC"]) == (128, 128)
    for c in range(8, K["kHeadMaxC"] + 1, 8):
        for nc in range(5, K["kHeadMaxNC"] + 1):
            assert plan(c, nc)["smem"] <= K["kSmemMax"], (c, nc)
        q = plan(c, 5)
        # the steps' lane maps cover the loaded channels once each
        chans = sorted(head_fwd_ch(q["ksm"], s, t) + e for s in
                       range(q["kp"]) for t in range(4) for e in range(4))
        assert chans == list(range(16 * q["kp"]))
        for s in range(q["ks"]):
            banks = {}
            for lane in range(16):       # a half warp's 8-byte reads
                g, t = lane >> 2, lane & 3
                word = (g * q["ws"] + head_fwd_ch(q["ksm"], s, t)) // 2
                banks.setdefault(word % 32 // 2, []).append(lane)
            assert max(len(v) for v in banks.values()) <= 2, (c, s)


def deal(nm, blocks):
    """The m16 tiles each warp takes, in order: tile i to warp i mod
    (blocks x kFwdWarps)."""
    stride = blocks * K["kFwdWarps"]
    return [list(range(first, nm, stride)) for first in range(stride)]


@pytest.mark.parametrize("nm", [1, 7, 100, 16385])
def test_tiles_are_dealt_once(nm):
    for blocks in (1, 3, 83):
        got = sorted(t for warp in deal(nm, blocks) for t in warp)
        assert got == list(range(nm))


def slots(t):
    """The k slots of lane t's four A (and two B) halves in the mma's
    order: a0/b0 slots 2t, 2t + 1; a2/b1 slots 2t + 8, 2t + 9."""
    return [2 * t, 2 * t + 1], [2 * t + 8, 2 * t + 9]


def emulate(x, w, bias, scale, shift, gx=3):
    """The kernel's y (B, V, NC) as f32 values of bf16, and how often each
    voxel's row was written."""
    b, v, c = x.shape
    nc = w.shape[1]
    p = plan(c, nc)
    assert p["route"] == "tensor cores"
    ks, nt, ws, ksm = p["ks"], p["nt"], p["ws"], p["ksm"]
    wt = np.zeros((nt * 8, ws), np.float32)
    wt[:nc, :c] = w.to(torch.bfloat16).float().numpy().T
    y = np.full((b, v, nc), np.nan, np.float32)
    written = np.zeros((b, v), np.int64)
    nm = -(-v // 16)
    for bi in range(b):
        xs = np.zeros((nm * 16, 16 * p["kp"]), np.float32)
        xs[:v, :c] = x[bi].float().numpy()
        sst = np.zeros((16 * p["kp"], 2), np.float32)
        sst[:c, 0] = scale[bi].numpy()
        sst[:c, 1] = shift[bi].numpy()
        for mt in sum(deal(nm, gx), []):
            acc = np.zeros((16, nt * 8), np.float32)
            for s in range(p["kp"]):
                amat = np.zeros((16, 16))
                bmat = np.zeros((16, nt * 8))
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    ch = head_fwd_ch(ksm, s, t) + (16 * s if ksm == 1 else 0)
                    for h in range(2):
                        row = mt * 16 + g + 8 * h
                        vals = xs[row, ch:ch + 4]         # the load
                        for half, sl in enumerate(slots(t)):
                            for e in range(2):
                                k = ch + 2 * half + e   # lane's channel
                                pre = torch.relu(
                                    torch.tensor(vals[2 * half + e])
                                    * torch.tensor(sst[k, 0])
                                    + torch.tensor(sst[k, 1]))
                                amat[g + 8 * h, sl[e]] = pre.to(
                                    torch.bfloat16).float()
                    for j in range(nt):
                        words = wt[8 * j + g, ch:ch + 4]  # 8-byte read
                        for half, sl in enumerate(slots(t)):
                            for e in range(2):
                                bmat[sl[e], 8 * j + g] = \
                                    words[2 * half + e]
                acc = acc + (amat @ bmat).astype(np.float32)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for j in range(nt):
                    for h in range(2):
                        row = mt * 16 + g + 8 * h
                        for e in range(2):
                            k = 8 * j + 2 * t + e
                            if k < nc and row < v:
                                val = acc[g + 8 * h, k] + np.float32(
                                    bias[k])
                                y[bi, row, k] = torch.tensor(val).to(
                                    torch.bfloat16).float()
            written[bi, mt * 16:min(mt * 16 + 16, v)] += 1
    return y, written


@pytest.mark.parametrize("c,nc", [(16, 5), (8, 7), (24, 13), (32, 20),
                                  (16, 40), (48, 9), (128, 8)])
def test_fragments_and_dealing_give_the_plain_head(c, nc):
    """Every voxel written once (a partial last m16 tile, tiles dealt to
    3 blocks of kFwdWarps warps), each A register's channels as the lane
    infers them, at one step and in step pairs (48 channels: a pair half
    past C), C not a multiple of 16 (a half-empty k16 step), odd class
    counts and several n8 tiles: the plain version's y within one bf16
    step."""
    rng = np.random.default_rng(400 + c + nc)
    b, r = 2, 5
    x = torch.from_numpy(rng.normal(size=(b, r, r, r, c)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 1, 1, c, nc)).astype(
        np.float32))
    bias = torch.from_numpy((rng.normal(size=nc) * 0.1).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, (b, c)).astype(
        np.float32))
    shift = torch.from_numpy((rng.normal(size=(b, c)) * 0.3).astype(
        np.float32))
    got, written = emulate(x.reshape(b, -1, c), w.reshape(c, nc), bias,
                           scale, shift)
    assert (written == 1).all()
    ref = cb.head_grid2_plain(x, w, bias, scale, shift).float().reshape(
        b, -1, nc).numpy()
    assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref)
                  + 1e-4 * np.abs(ref).max())
