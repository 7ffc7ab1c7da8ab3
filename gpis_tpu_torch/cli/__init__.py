"""gpis_tpu_torch.cli: the `gpis-torch` command line (see cli/main.py)."""


def add_device_arg(p):
    """The `--device` flag every verb takes."""
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' for the plain PyTorch "
                        "path)")
