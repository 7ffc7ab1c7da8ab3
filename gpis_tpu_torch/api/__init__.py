"""gpis_tpu_torch.api (see the package docstring)."""
