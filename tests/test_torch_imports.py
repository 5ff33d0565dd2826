"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, and its entry points never fall back to the CPU on their own."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pcseg_tpu_torch import api, cli
from pcseg_tpu_torch.core.device import resolve_device
from pcseg_tpu_torch.core.config import ModelConfig
from pcseg_tpu_torch.infer import Predictor
from pcseg_tpu_torch.models.factory import build_model
from pcseg_tpu_torch.models.pointnet import PointNetSeg
from pcseg_tpu_torch.models.sparse_unet import SparseVoxelNet


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import pcseg_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            pcseg_tpu_torch.__path__, "pcseg_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "h5py", "msgpack", "pcseg_tpu"))
        assert not bad, bad
        for name in ("ops.conv3d_block", "utils.observe", "data.hdf5",
                     "data.prefetch", "data.native", "cli"):
            assert "pcseg_tpu_torch." + name in names, name
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")

    cfg = ModelConfig(name="voxel_unet3d", grid_size=8, unet_width=8,
                      levels=2)
    model = build_model(cfg, 4, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        Predictor(model.state_dict(), 4, model=model)
    p = Predictor(model.state_dict(), 4, model=model, device="cpu")
    assert p.predict(np.zeros((10, 4), np.float32)).shape == (10,)
    # training too: api.fit takes the card unless told otherwise
    events = [(np.zeros((5, 4), np.float32), np.zeros(5, np.int64))] * 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.fit(events)
    # and the CLI, unless given --device cpu
    for cmd in ("train", "infer", "eval"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main([cmd, "--checkpoint", "x.pt", "--data", "d.h5",
                      "--labels", "l.h5"] if cmd != "train" else [cmd])


def test_unported_families_raise():
    model = build_model(ModelConfig(name="pointnet_seg"), 4)
    assert isinstance(model, PointNetSeg)
    # the sparse family builds with its block impl; the others wait
    assert isinstance(build_model(ModelConfig(name="sparse_voxelnet"), 4),
                      SparseVoxelNet)
    for impl in ("dense", "gather"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(ModelConfig(name="sparse_voxelnet", impl=impl), 4)
    # PointNet trains and serves in the port: Predictor's default model
    served = Predictor(model.state_dict(), 4, device="cpu")
    assert isinstance(served.model, PointNetSeg)
    assert served.predict(np.zeros((10, 4), np.float32)).shape == (10,)
