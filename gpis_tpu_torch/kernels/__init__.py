"""gpis_tpu_torch.kernels (see the package docstring)."""
