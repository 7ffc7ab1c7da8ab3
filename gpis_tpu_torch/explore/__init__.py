"""gpis_tpu_torch.explore (see the package docstring)."""
