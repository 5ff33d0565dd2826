"""Subpackage of the pcseg_tpu_torch port."""
