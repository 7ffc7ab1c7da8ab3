"""gpis_tpu_torch.utils (see the package docstring)."""
