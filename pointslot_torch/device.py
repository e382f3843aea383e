"""Device resolution: explicit, never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return the torch.device the caller asked for.

    ``"cuda"`` (the default) needs a CUDA card: without one this raises
    instead of carrying on on the CPU. ``"cpu"`` runs the plain PyTorch
    versions of every kernel (the tests' path)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
