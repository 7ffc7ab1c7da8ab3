"""gpis_tpu_torch.data (see the package docstring)."""
