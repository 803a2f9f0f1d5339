"""Command-line runners of the PyTorch port (the JAX package's flags and
output formats, plus ``--device {cuda,cpu}``)."""


def add_device_arg(ap) -> None:
    """The one flag the port's runners add to the JAX package's."""
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the PHY runs: the CUDA card (default; "
                         "fails without one) or the CPU")
