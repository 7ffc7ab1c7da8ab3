"""gpis_tpu_torch.viz (see the package docstring)."""
