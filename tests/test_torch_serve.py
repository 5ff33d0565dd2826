"""Exported serving artifacts in the port (``pcseg_tpu_torch/serve.py``,
``cli export``) on the CPU, and the eight kernels' registered ops
(``pcseg::*``) they carry.

- Each family's ``ExportedPredictor`` against its live ``Predictor``, bit
  for bit (the same ops on the same inputs in the same order: the graph
  is the live forward's): PointNetSeg folded in f32 and bf16 and
  unfolded, the default voxel U-Net at 16^3 / w8 / L2 bf16, SparseVoxelNet
  block and gather (``max_active=8``, which overflows: a warning, or
  RuntimeError with ``strict_capacity``).
- Each family's exported graph holds the ``pcseg::`` op nodes the live
  forward calls, by name and count: the kernels are in the artifact, not
  their plain versions inlined.
- Against the JAX package's artifacts (``pcseg_tpu.serve`` on the CPU,
  weights carried by ``from_jax_variables``): PointNetSeg folded f32 to
  1e-5 of max |logit| (f32 on both sides, products summed in another
  order), and the gather impl's overflow surfacing as the JAX test
  (tests/test_serve.py) holds it, with the same dropped count.
- Refusals, ``torch.library.opcheck`` of the eight ops on CPU tensors,
  ``cli export`` from the port's checkpoint and from a JAX checkpoint
  directory, and a fresh process that serves an artifact without
  importing ``pcseg_tpu_torch.models``, ``infer`` or ``ops.fold``.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pcseg_tpu.infer import Predictor as JaxPredictor
from pcseg_tpu.models.sparse_unet import SparseVoxelNet as JaxSparseVoxelNet
from pcseg_tpu.serve import export_predictor as jax_export
from pcseg_tpu.serve import load_exported as jax_load
from pcseg_tpu_torch.ckpt.checkpoint import save_checkpoint
from pcseg_tpu_torch.ckpt.convert import from_jax_variables
from pcseg_tpu_torch.cli import main
from pcseg_tpu_torch.core.config import ModelConfig
from pcseg_tpu_torch.data.batching import pad_events
from pcseg_tpu_torch.infer import Predictor
from pcseg_tpu_torch.models.sparse_unet import SparseVoxelNet
from pcseg_tpu_torch.models.voxel_unet import VoxelUNet3d
from pcseg_tpu_torch.ops import block_conv, conv3d_block, fused_ln, voxel
from pcseg_tpu_torch.serve import export_predictor, load_exported
from tests.jax_format import write_jax_checkpoint
from tests.test_torch_pointnet_serving import pointnet_variables
from tests.test_torch_sparse_unet import _numpy_vars

torch.set_num_threads(1)

C = 4
F32_REL = 1e-5


def _events(sizes, seed, dim=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, dim)).astype(np.float32) for n in sizes]


class _OpCounts(TorchDispatchMode):
    """Counts the pcseg:: ops a forward calls."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "pcseg":
            name = func.__name__.split(".")[0]
            self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _graph_ops(path, b, m):
    ep = torch.export.load(os.path.join(path, f"fwd_b{b}_m{m}.pt2"))
    counts = {}
    for node in ep.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith(
                "pcseg."):
            name = str(node.target).split(".")[1]
            counts[name] = counts.get(name, 0) + 1
    return counts


def _live_ops(pred, b, m, dim=4):
    pts = torch.from_numpy(np.random.default_rng(9).normal(
        size=(b, m, dim)).astype(np.float32))
    mask = torch.ones((b, m), dtype=torch.bool)
    with _OpCounts() as mode:
        pred.device_forward(pts, mask)
    return mode.counts


def _assert_same(served, pred, evs, b, m):
    """The exported forward's logits equal the live one's on one padded
    (b, m) batch of ``evs``, and so do predict_batch's predictions at
    batch b (a CPU matmul's sums may change with the batch, so the two
    are held at one batch size)."""
    pts, _, msk = pad_events([(e, np.zeros(len(e), np.int64))
                              for e in evs[:b]], m, batch_size=b)
    pts, msk = torch.from_numpy(pts), torch.from_numpy(msk)
    assert torch.equal(served.device_forward(pts, msk),
                       pred.device_forward(pts, msk))
    for g, w in zip(served.predict_batch(evs, batch_size=b),
                    pred.predict_batch(evs, batch_size=b)):
        np.testing.assert_array_equal(g, w)


# -- PointNetSeg

@pytest.fixture(scope="module")
def pn_variables():
    return from_jax_variables(pointnet_variables(3))


@pytest.fixture(scope="module")
def pn_artifact(tmp_path_factory, pn_variables):
    """PointNetSeg folded f32 at batches 1 and 2, buckets 64 and 128."""
    pred = Predictor(pn_variables, C, buckets=(64, 128), device="cpu")
    path = str(tmp_path_factory.mktemp("pn") / "artifact")
    export_predictor(pred, path, batch_sizes=(1, 2))
    return pred, path


@pytest.mark.parametrize("fold,dtype", [(True, "float32"),
                                        (True, "bfloat16"),
                                        (False, "float32")])
def test_pointnet_round_trip(tmp_path, pn_artifact, pn_variables, fold,
                             dtype):
    if (fold, dtype) == (True, "float32"):
        pred, path = pn_artifact
    else:
        pred = Predictor(pn_variables, C, buckets=(64, 128), device="cpu",
                         fold=fold, dtype=dtype)
        path = str(tmp_path / "artifact")
        manifest = export_predictor(pred, path, batch_sizes=(1, 2))
        assert manifest["batch_sizes"] == [1, 2]
        assert manifest["buckets"] == [64, 128]
        assert manifest["platforms"] == ["cpu"]
        assert not manifest["returns_overflow"]
    served = load_exported(path, device="cpu")
    # the artifact's graphs keep no dtype asserts of the traced .to() calls
    assert "_assert_tensor_metadata" not in str(torch.export.load(
        os.path.join(path, "fwd_b2_m64.pt2")).graph)
    evs = _events((33, 64, 100, 7, 128), 3)
    _assert_same(served, pred, evs, 2, 128)
    # logits and predict at the smallest exported batch, 1: Predictor's
    for e in evs:
        np.testing.assert_array_equal(served.logits(e), pred.logits(e))
    # PointNetSeg's serving forward launches no kernel
    assert _graph_ops(path, 2, 64) == {} == _live_ops(pred, 2, 64)
    # the programs are graphs: the weights are stored once, beside them
    sizes = {f: os.path.getsize(os.path.join(path, f))
             for f in os.listdir(path) if f.endswith(".pt2")}
    assert len(sizes) == 4
    weights = os.path.getsize(os.path.join(path, "weights", "weights.pt"))
    assert max(sizes.values()) < weights / 4, (sizes, weights)


def test_pointnet_matches_jax_artifact(tmp_path, pn_artifact):
    """The port's folded f32 artifact against the JAX package's on the
    same variables: 1e-5 of max |logit|."""
    _, path = pn_artifact
    jax_path = str(tmp_path / "jax_artifact")
    jax_export(JaxPredictor(pointnet_variables(3), C, buckets=(64, 128)),
               jax_path, batch_sizes=(1, 2))
    served, jax_served = load_exported(path, device="cpu"), jax_load(jax_path)
    for e in _events((33, 64, 100), 4):
        got, want = served.logits(e), jax_served.logits(e)
        err = float(np.abs(got - want).max())
        assert err <= F32_REL * float(np.abs(want).max()), err


def test_refusals(pn_artifact):
    _, path = pn_artifact
    served = load_exported(path, device="cpu")
    with pytest.raises(ValueError, match="not in exported"):
        served.predict_batch(_events((10, 20, 30), 5), batch_size=3)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        served.predict(_events((129,), 5)[0])
    # device_forward takes the exported shapes only, f32 points, bool mask
    for pts, msk in ((torch.zeros(3, 64, 4), torch.ones(3, 64, dtype=bool)),
                     (torch.zeros(1, 96, 4), torch.ones(1, 96, dtype=bool)),
                     (torch.zeros(1, 64, 3), torch.ones(1, 64, dtype=bool)),
                     (torch.zeros(1, 64, 4, dtype=torch.float64),
                      torch.ones(1, 64, dtype=bool)),
                     (torch.zeros(1, 64, 4), torch.ones(1, 64))):
        with pytest.raises(ValueError, match="exported programs take"):
            served.device_forward(pts, msk)
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    try:
        for edit, match in (({"platforms": ["cuda"]}, "exported for"),
                            ({"version": 2}, "unsupported artifact")):
            with open(mpath, "w") as f:
                json.dump(dict(manifest, **edit), f)
            with pytest.raises(ValueError, match=match):
                load_exported(path, device="cpu")
    finally:
        with open(mpath, "w") as f:
            json.dump(manifest, f)


def test_fresh_process_imports_no_model_code(pn_artifact, tmp_path):
    """A new interpreter serves the artifact with the serving module alone:
    no pcseg_tpu_torch.models, infer or ops.fold, and the live logits."""
    pred, path = pn_artifact
    ev = _events((77,), 6)[0]
    np.save(tmp_path / "ev.npy", ev)
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        from pcseg_tpu_torch.serve import load_exported
        torch.set_num_threads(1)
        served = load_exported({path!r}, device="cpu")
        np.save({str(tmp_path / 'out.npy')!r},
                served.logits(np.load({str(tmp_path / 'ev.npy')!r})))
        bad = sorted(k for k in sys.modules if k.startswith((
            "pcseg_tpu_torch.models", "pcseg_tpu_torch.infer",
            "pcseg_tpu_torch.ops.fold", "jax", "pcseg_tpu.")))
        assert not bad, bad
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  pred.logits(ev))


# -- the voxel U-Net's default configuration

def test_voxel_default_round_trip(tmp_path):
    model = VoxelUNet3d(C, grid_size=16, width=8, levels=2,
                        compute_dtype="bfloat16",
                        generator=torch.Generator().manual_seed(0))
    assert model.resolve_forms() == {"conv": "fused", "voxelize": "matmul",
                                     "devoxelize": "matmul",
                                     "head": "grid2"}
    pred = Predictor(model.state_dict(), C, buckets=(64,), model=model,
                     device="cpu")
    path = str(tmp_path / "artifact")
    export_predictor(pred, path, batch_sizes=(2,))
    served = load_exported(path, device="cpu")
    _assert_same(served, pred, _events((50, 64, 13), 7), 2, 64)
    live = _live_ops(pred, 2, 64)
    assert live == {"voxelize_contract": 1, "conv3x3_gn_act": 8,
                    "down2x_gn_act": 1, "up2x_gn_act": 1, "head_grid2": 1,
                    "trilinear_gather": 1}
    assert _graph_ops(path, 2, 64) == live


# -- SparseVoxelNet

def test_sparse_block_round_trip(tmp_path):
    model = SparseVoxelNet(C, grid_size=16, width=16, depth=1, levels=2,
                           tile=4, max_tiles=64, compute_dtype="bfloat16",
                           generator=torch.Generator().manual_seed(0))
    pred = Predictor(model.state_dict(), C, buckets=(256,), model=model,
                     device="cpu", strict_capacity=True)
    path = str(tmp_path / "artifact")
    manifest = export_predictor(pred, path, batch_sizes=(2,))
    assert manifest["returns_overflow"]
    assert manifest["capacity"] == ["tiles", "max_tiles"]
    served = load_exported(path, device="cpu", strict_capacity=True)
    _assert_same(served, pred, _events((120, 256, 31), 8), 2, 256)
    live = _live_ops(pred, 2, 256)
    assert live == {"voxelize_contract": 1, "block_conv": 2,
                    "bias_ln_relu_mask": 4}
    assert _graph_ops(path, 2, 256) == live


def test_sparse_gather_overflow_matches_jax(tmp_path):
    """The gather impl at max_active=8 (tests/test_serve.py's case): the
    port's artifact warns, or raises with strict_capacity, as its live
    Predictor and the JAX artifact do, with the JAX forward's dropped
    count, and its logits equal the live ones bit for bit and the JAX
    artifact's to 1e-5 of max |logit| (f32)."""
    kw = dict(num_classes=C, grid_size=16, width=8, levels=1, impl="gather",
              max_active=8)
    variables = _numpy_vars(JaxSparseVoxelNet(**kw), 1)
    model = SparseVoxelNet(**kw)
    model.load_state_dict(from_jax_variables(variables))
    pred = Predictor(model.state_dict(), C, buckets=(256,), model=model,
                     device="cpu")
    path, jax_path = str(tmp_path / "artifact"), str(tmp_path / "jax")
    manifest = export_predictor(pred, path, batch_sizes=(1,))
    assert manifest["capacity"] == ["sites", "max_active"]
    jax_export(JaxPredictor(variables, C, buckets=(256,),
                            model=JaxSparseVoxelNet(**kw)),
               jax_path, batch_sizes=(1,))
    pts = _events((200,), 2)[0]
    got = {}
    for name, p in (("port", load_exported(path, device="cpu")),
                    ("live", pred), ("jax", jax_load(jax_path))):
        with pytest.warns(UserWarning, match="capacity overflow") as rec:
            got[name] = p.logits(pts)
        got[name + " words"] = str(rec[0].message)
    np.testing.assert_array_equal(got["port"], got["live"])
    assert got["port words"] == got["live words"]
    assert "max_active" in got["port words"]
    # the same count of dropped sites as the JAX forward
    assert got["port words"].split(":")[1].split()[0] == \
        got["jax words"].split(":")[1].split()[0]
    err = float(np.abs(got["port"] - got["jax"]).max())
    assert err <= F32_REL * float(np.abs(got["jax"]).max()), err
    for strict in (load_exported(path, device="cpu", strict_capacity=True),
                   jax_load(jax_path, strict_capacity=True)):
        with pytest.raises(RuntimeError, match="capacity overflow"):
            strict.predict(pts)


# -- the eight ops

def _op_cases():
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    bf = torch.bfloat16
    b, r, c = 2, 4, 8
    x = rnd(b, r, r, r, c, dtype=bf)
    vec = (rnd(b, c), rnd(b, c))
    coarse = rnd(b, r // 2, r // 2, r // 2, 2 * c, dtype=bf)
    flat = torch.randint(0, r ** 3 + 1, (b, 40), generator=g)
    slots = torch.full((1, 3, 27), -1, dtype=torch.int32)
    slots[0, :2, 13] = torch.tensor([0, 1], dtype=torch.int32)
    slots[0, 0, 14], slots[0, 1, 12] = 1, 0
    return {
        "conv3x3_gn_act": (x, rnd(3, 3, 3, c, c), rnd(c), *vec, x, True,
                           True),
        "down2x_gn_act": (x, rnd(2, 2, 2, c, 2 * c), rnd(2 * c), *vec),
        "up2x_gn_act": (coarse, rnd(2, 2, 2, 2 * c, c), rnd(c),
                        rnd(b, 2 * c), rnd(b, 2 * c)),
        "head_grid2": (x, rnd(1, 1, 1, c, C), rnd(C), *vec),
        "voxelize_contract": (flat, rnd(b, 40, 3), r),
        "trilinear_gather": (rnd(b, 40, 3).abs() * r / 2,
                             torch.rand(b, 40, generator=g) > 0.2,
                             rnd(b, r * r, r * C, dtype=bf), r),
        "bias_ln_relu_mask": (rnd(30, c, dtype=bf), rnd(c), rnd(c), rnd(c),
                              torch.rand(30, generator=g) > 0.3, 1e-5, bf),
        "block_conv": (rnd(1, 3, 8, c, dtype=bf), slots, rnd(27 * c, c,
                                                              dtype=bf)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_opcheck(name):
    op = getattr(torch.ops.pcseg, name)
    torch.library.opcheck(op, _op_cases()[name])


def test_ops_run_the_plain_versions_on_the_cpu():
    """Each op's CPU implementation is its wrapper's plain version, and no
    kernel is counted."""
    cases = _op_cases()
    plain = {
        "conv3x3_gn_act": lambda *a: conv3d_block.conv3x3_gn_act_plain(
            *a[:6], activate=a[6], want_stats=a[7]),
        "down2x_gn_act": conv3d_block.down2x_gn_act_plain,
        "up2x_gn_act": conv3d_block.up2x_gn_act_plain,
        "head_grid2": conv3d_block.head_grid2_plain,
        "voxelize_contract": voxel.voxelize_contract_plain,
        "trilinear_gather": lambda u, m, g2, r:
            voxel.trilinear_gather_plain(u, m, g2),
        "bias_ln_relu_mask": fused_ln.bias_ln_relu_mask_plain,
        "block_conv": block_conv.block_conv_plain,
    }
    for m in (conv3d_block, voxel, fused_ln, block_conv):
        m.reset_launches()
    for name, args in cases.items():
        got = getattr(torch.ops.pcseg, name)(*args)
        want = plain[name](*args)
        for g, w in zip(*((t,) if isinstance(t, torch.Tensor) else t
                          for t in (got, want))):
            assert torch.equal(g, w), name
    for m in (conv3d_block, voxel, fused_ln, block_conv):
        assert not any(m.LAUNCHES.values())


def test_first_op_call_imports_no_dynamo():
    """The ops are defined through torch.library.Library: calling one
    imports no torch._dynamo (custom_op's wrapper does, seconds at the
    start of every eager serving or training process)."""
    code = textwrap.dedent("""
        import sys
        import torch
        from pcseg_tpu_torch.ops import fused_ln
        x = torch.ones(4, 8)
        fused_ln.bias_ln_relu_mask_fwd(x, x[0], x[0], x[0], x[:, 0] > 0)
        assert "torch._dynamo" not in sys.modules
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr


# -- cli export

def _cli_last(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_export_round_trips(tmp_path, capsys):
    """From the port's checkpoint file and from a JAX checkpoint directory
    (the JAX layout, written without JAX): the artifact serves what
    Predictor.from_checkpoint serves, bit for bit."""
    variables = pointnet_variables(5)
    port_ck = save_checkpoint(str(tmp_path / "ck.pt"),
                              from_jax_variables(variables), C,
                              ModelConfig())
    zeros = jax.tree.map(np.zeros_like, variables["params"])
    jax_ck = write_jax_checkpoint(
        str(tmp_path / "jax_ck"), 3, variables["params"],
        variables["batch_stats"], 3, zeros, zeros,
        {"epoch": 1, "num_classes": C})
    ev = _events((90,), 7)[0]
    for ck in (port_ck, jax_ck):
        out = str(tmp_path / f"art_{os.path.basename(ck)}")
        assert main(["export", "--checkpoint", ck, "--out", out,
                     "--batch-sizes", "1", "--buckets", "128",
                     "--device", "cpu"]) == 0
        printed = _cli_last(capsys)
        assert printed["exported"] == out and printed["buckets"] == [128]
        assert printed["platforms"] == ["cpu"]
        np.testing.assert_array_equal(
            load_exported(out, device="cpu").logits(ev),
            Predictor.from_checkpoint(ck, device="cpu",
                                      buckets=(128,)).logits(ev))
    # --no-fold reaches the Predictor
    out = str(tmp_path / "unfolded")
    assert main(["export", "--checkpoint", port_ck, "--out", out,
                 "--batch-sizes", "1", "--buckets", "128", "--no-fold",
                 "--device", "cpu"]) == 0
    capsys.readouterr()
    np.testing.assert_array_equal(
        load_exported(out, device="cpu").logits(ev),
        Predictor.from_checkpoint(port_ck, device="cpu", buckets=(128,),
                                  fold=False).logits(ev))
