"""gpis_tpu_torch.native: the C++ host runtime (see native/build.py)."""
