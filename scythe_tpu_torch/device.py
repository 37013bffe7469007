"""Where the port runs: on the card unless the caller asks for the CPU.

The entry points (``create_grid``, ``model.initialize``, ``integrate_model``,
``io.load_checkpoint`` and the ``convert`` loaders) take ``device="cuda"`` by
default and resolve it here.  Without a card that default raises: a run
never falls back to the CPU by itself.  ``traced_reason`` says whether
autograd or a functorch transform watches a call, for the graph runner and
the kernels' wrappers alike.
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


def traced_reason(tensors) -> str | None:
    """Why autograd or a functorch transform has to see the ops on
    ``tensors`` one by one, or None: ``graphs.scan``'s two input checks,
    which the condensation adjustment's dispatch makes too."""
    if torch._C._functorch.peek_interpreter_stack() is not None:
        return "inside a functorch transform"
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return "an input requires grad"
    return None
