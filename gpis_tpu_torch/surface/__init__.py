"""gpis_tpu_torch.surface (see the package docstring)."""
