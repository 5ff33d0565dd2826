"""Build and load the port's CUDA kernels.

The sources under ``pcseg_tpu_torch/csrc/`` have a plain C interface. At
first use each one is compiled with ``nvcc`` for ``sm_90a`` into
``build/pcseg_tpu_torch/`` at the root of the checkout and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The library
file name carries a hash of the source and of every ``csrc/*.cuh`` header
it includes (``#include "name.cuh"``, found beside the source, so no -I
flag is needed), so an edited kernel or header is never served from a
stale build.

``build_host`` compiles a host C++ source of the same directory
(``csrc/collate.cpp``, the batch packer) the same way with ``g++``, the
compiler ``nvcc`` itself drives.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pcseg_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint32
_F = ctypes.c_float
# entry name -> argtypes; every pointer and the stream are c_void_p so
# ctypes never truncates them to 32-bit ints
SIGNATURES = {
    "conv3d_block": {
        "pcseg_conv3x3_gn_act": [_P] * 8 + [_I] * 7 + [_P],
        "pcseg_down2x_gn_act": [_P] * 7 + [_I] * 6 + [_P],
        "pcseg_up2x_gn_act": [_P] * 7 + [_I] * 6 + [_P],
        "pcseg_conv3x3_dgrad": [_P] * 10 + [_I] * 7 + [_P],
        "pcseg_conv3x3_wgrad": [_P] * 8 + [_I] * 7 + [_P],
        "pcseg_down2x_bwd": [_P] * 11 + [_I] * 6 + [_P],
        "pcseg_up2x_bwd": [_P] * 11 + [_I] * 6 + [_P],
        "pcseg_head_grid2": [_P] * 6 + [_I] * 4 + [_P],
        "pcseg_head_grid2_bwd_scratch": [_I] * 4,
        "pcseg_head_grid2_bwd": [_P] * 10 + [_I] * 4 + [_P],
    },
    "conv3d_dgrad": {
        "pcseg_ring_grid": [_I] * 6,
        "pcseg_conv3x3_mma": [_P] * 9 + [_I] * 6 + [_P],
        "pcseg_conv3x3_dgrad_mma": [_P] * 11 + [_I] * 6 + [_P],
        "pcseg_conv3x3_wgrad_mma": [_P] * 8 + [_I] * 6 + [_P],
    },
    "resample": {
        "pcseg_resample_grid": [_I] * 4,
        "pcseg_down2x_mma": [_P] * 8 + [_I] * 6 + [_P],
        "pcseg_up2x_mma": [_P] * 8 + [_I] * 6 + [_P],
        "pcseg_up2x_bwd_mma": [_P] * 10 + [_I] * 6 + [_P],
        "pcseg_down2x_bwd_slices": [_I],
        "pcseg_down2x_bwd_mma": [_P] * 10 + [_I] * 6 + [_P],
    },
    "onehot_contract": {
        "pcseg_voxelize_contract": [_P, _I, _P, _P] + [_I] * 4 + [_P],
        "pcseg_trilinear_scatter_scratch": [_I] * 4,
        "pcseg_trilinear_scatter": [_P] * 4 + [_I] * 5 + [_P],
        "pcseg_trilinear_gather": [_P] * 4 + [_I] * 4 + [_P],
        "pcseg_rowcol_scatter": [_P] * 4 + [_I] * 5 + [_P],
        "pcseg_segment_scatter": [_P] * 3 + [_I] * 4 + [_P],
    },
    "pointnet_fused": {
        "pcseg_dropout": [_P, _P, _L, _U, _U, _F, _I, _P],
        "pcseg_fused_pool_fwd": [_P, _I] + [_P] * 7 + [_L, _I, _L, _P],
        "pcseg_fused_pool_bwd": [_P] * 3 + [_I, _L, _I, _L, _P],
    },
    "pointnet_chain": {
        "pcseg_chain_fwd": [_P] * 12 + [_L, _I, _I, _L, _I, _U, _U, _F, _I,
                                       _I, _I, _P],
        "pcseg_chain_bwd": [_P] * 19 + [_I, _I, _L, _I, _I, _L, _I, _U, _U,
                                       _F, _I, _P],
        "pcseg_chain_bwd_split": [_I] * 4,
        "pcseg_seg4_ce_fwd": [_P] * 10 + [_I, _L, _I, _I, _P],
        "pcseg_seg4_ce_bwd": [_P] * 15 + [_I, _L, _I, _I, _P],
    },
    "pointnet_wgmma": {
        "pcseg_gp_fwd": [_P] * 14 + [_L, _I, _I, _L, _P],
        "pcseg_gp_bwd": [_P] * 18 + [_L, _I, _I, _L, _P],
    },
    "block_conv": {
        "pcseg_block_route": [_I] * 6,
        "pcseg_block_conv": [_P] * 4 + [_I] * 6 + [_P],
        "pcseg_block_conv_dgrad": [_P] * 4 + [_I] * 6 + [_P],
        "pcseg_block_wgrad_groups": [_I] * 7,
        "pcseg_block_wgrad": [_P] * 5 + [_I] * 8 + [_P],
    },
    "fused_ln": {
        "pcseg_bias_ln_relu_mask": [_P] * 6 + [_L, _I, _F, _I, _I, _P],
        "pcseg_bias_ln_relu_mask_bwd_max_c": [],
        "pcseg_bias_ln_relu_mask_bwd_vec_ok": [_I],
        "pcseg_bias_ln_relu_mask_bwd_blocks": [_L, _I, _I, _I, _I],
        "pcseg_bias_ln_relu_mask_bwd": [_P] * 9 + [_L, _I, _F, _I, _I, _I,
                                                  _P],
    },
}

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "pcseg_tpu_torch are compiled at first use"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_digest(src: Path) -> str:
    """Hash of a source and, recursively, of the headers it includes from
    its own directory."""
    h, seen, todo = hashlib.sha256(), set(), [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        todo += sorted(path.parent / m.decode() for m in _INCLUDE.findall(text)
                       if (path.parent / m.decode()).is_file())
    return h.hexdigest()[:16]


def _compile(cmd: list, src: Path, out: Path) -> Path:
    """Run ``cmd + [-o tmp, src]`` into ``out`` (atomically renamed), or
    raise with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(cmd[0]).name} failed for {src} (exit "
                f"{proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source (and
    its headers) exists; returns the shared library's path."""
    src = _CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{source_digest(src)}.so"
    return out if out.is_file() else _compile([_nvcc(), *NVCC_FLAGS], src,
                                              out)


def build_host(name: str) -> Path:
    """Compile the host source ``csrc/<name>.cpp`` with ``g++`` unless a
    build of this exact source exists; returns the library's path."""
    src = _CSRC / f"{name}.cpp"
    out = BUILD_DIR / f"lib{name}-{source_digest(src)}.so"
    if out.is_file():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found on PATH: {src} is compiled at "
                           "first use")
    return _compile([cxx, "-O3", "-std=c++17", "-shared", "-fPIC"], src, out)


def _bind(path: Path, name: str) -> ctypes.CDLL:
    """Load a library of source ``name`` with the argtypes and int return
    type of every entry set."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        entry = getattr(lib, fn)
        entry.argtypes = argtypes
        entry.restype = ctypes.c_int
    return lib


def load_library(name: str = "conv3d_block") -> ctypes.CDLL:
    """Build (if needed) and load one kernel library."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = _bind(build(name), name)
    return lib


def build_variant(name: str, tag: str, defines=(), src: str | None = None
                  ) -> ctypes.CDLL:
    """A profiler's variant of ``csrc/<name>.cu``: the source (or ``src``,
    an edited copy of it) and the headers copied to ``BUILD_DIR/<tag>``,
    compiled with the extra ``-D`` ``defines`` and loaded with the regular
    library's entries. Nothing of the package loads it."""
    out = BUILD_DIR / tag
    out.mkdir(parents=True, exist_ok=True)
    text = src if src is not None else (_CSRC / f"{name}.cu").read_text()
    (out / f"{name}.cu").write_text(text)
    for header in _CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    lib_path = out / "lib.so"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
         str(lib_path), str(out / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr}")
    return _bind(lib_path, name)


# -- launch helpers shared by the kernel wrappers

def on_cuda(x, plain: bool = False) -> bool:
    """True where a wrapper launches its kernel: ``x`` is a CUDA tensor
    and the plain version was not asked for. A CPU tensor takes the plain
    version; any other device is refused."""
    if x.device.type == "cpu" or plain:
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t):
    return None if t is None else t.data_ptr()


def raise_on(rc: int, name: str) -> None:
    """Raise if a kernel entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def build_all() -> list[Path]:
    """Compile every kernel source at once, one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(SIGNATURES)) as pool:
        return list(pool.map(build, SIGNATURES))
