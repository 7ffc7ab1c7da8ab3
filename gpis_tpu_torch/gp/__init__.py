"""gpis_tpu_torch.gp (see the package docstring)."""
