"""gpis_tpu_torch.cli: the `gpis-torch` command line (see cli/main.py)."""
