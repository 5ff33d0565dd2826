"""pcseg_tpu_torch — the PyTorch/CUDA port of pcseg_tpu for NVIDIA Hopper.

Serves the voxel U-Net (``models.voxel_unet.VoxelUNet3d``) through
hand-written CUDA conv kernels (``csrc/conv3d_block.cu``). Imports torch
and numpy only, never JAX or the JAX package. Entry points run on CUDA
unless the caller passes ``device="cpu"``, where every kernel wrapper
takes its plain PyTorch version.
"""

__version__ = "0.1.0"
