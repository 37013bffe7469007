"""Where the port runs: on the card unless the caller asks for the CPU.

The entry points (``create_grid``, ``model.initialize``, ``integrate_model``,
``io.load_checkpoint`` and the ``convert`` loaders) take ``device="cuda"`` by
default and resolve it here.  Without a card that default raises: a run
never falls back to the CPU by itself.
"""

from __future__ import annotations

from typing import Any

import torch

DEFAULT = "cuda"


def resolve_device(device: Any) -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} (the default of scythe_tpu_torch's entry "
            "points) is not available: torch.cuda.is_available() is false. "
            "Pass device='cpu' to run on the CPU."
        )
    return dev
