"""Subpackage of the pcseg_tpu_torch port."""

from pcseg_tpu_torch.ops.losses import weighted_masked_cross_entropy

__all__ = ["weighted_masked_cross_entropy"]
