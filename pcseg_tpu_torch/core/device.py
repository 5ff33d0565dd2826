"""Device resolution: the port runs on CUDA unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; ``"cpu"`` (the tests) runs
    every kernel's plain version. Asking for CUDA where there is none
    raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pcseg_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
