"""pointslot_torch: the PyTorch/CUDA port of pointslot_tpu for NVIDIA Hopper.

The JAX package ``pointslot_tpu`` stays the reference; this package imports
``torch`` and nothing of JAX or of ``pointslot_tpu``. It keeps its own copies
of the jax-free pieces it needs (config dataclasses, the BRIEF table, the
synthetic scene).

Numerics: the working type is float32 everywhere, on the card as well. The
JAX package's CPU oracle is float32, and the port is held to it, so TF32 is
switched off for both matrix products and cuDNN convolutions here, at import:

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

Every entry point takes ``device=`` (default ``"cuda"``). Asking for CUDA on
a machine without it raises; the CPU runs only when the caller asks for it.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from pointslot_torch.config import CameraConfig, ORBConfig, SystemConfig  # noqa: E402
from pointslot_torch.device import resolve_device  # noqa: E402

__all__ = ["CameraConfig", "ORBConfig", "SystemConfig", "resolve_device"]
