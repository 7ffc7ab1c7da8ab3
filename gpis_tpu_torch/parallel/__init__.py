"""Row mesh over torch.distributed ranks (port of gpis_tpu/parallel)."""
