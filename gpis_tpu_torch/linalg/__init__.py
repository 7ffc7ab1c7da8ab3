"""gpis_tpu_torch.linalg (see the package docstring)."""
