"""pcseg_tpu_torch — the PyTorch/CUDA port of pcseg_tpu for NVIDIA Hopper.

Trains and serves the JAX package's three model families (PointNetSeg,
the voxel U-Net ``models.voxel_unet.VoxelUNet3d``, the sparse
``models.sparse_unet.SparseVoxelNet``) through hand-written CUDA kernels
(``csrc/``, one counterpart for each Pallas kernel), on one device or
data-parallel with one process per device on ``torch.distributed``
(``parallel/mesh.py``); reads the reference's HDF5 event files, JAX
checkpoints and ``best_model.pth``, and exports serving artifacts
(``serve.py``). Entry points: ``api``, ``infer.Predictor`` and ``python -m
pcseg_tpu_torch.cli``. Imports torch and numpy only, never JAX or the JAX
package. Entry points run on CUDA unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.
"""

__version__ = "0.1.0"
