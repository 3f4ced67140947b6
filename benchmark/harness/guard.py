"""What a run refuses: a missing card, and a process that loaded JAX or
the JAX package."""

from __future__ import annotations

import subprocess
import sys

#: top-level module names that no run may load: the measured program is
#: the PyTorch port, whose name begins with the JAX package's, so names
#: are compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "genfer_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: the
    process's ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def card_count(torch) -> int:
    """The number of CUDA cards torch sees (0 without a card)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def power_limit() -> str:
    """The first card's power limit as ``nvidia-smi`` reports it, or
    ``"unknown"`` where it cannot be read."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    lines = smi.stdout.strip().splitlines()
    return lines[0].strip() if lines else "unknown"
