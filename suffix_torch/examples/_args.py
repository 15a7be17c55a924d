"""The examples' one command-line option."""

from __future__ import annotations

import argparse


def device_arg(description: str) -> str | None:
    """``--device`` from the command line (default: CUDA)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="torch device, e.g. cpu (default: cuda)")
    return p.parse_args().device
