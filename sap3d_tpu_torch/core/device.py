"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``.  A CUDA
device on a host without a usable GPU is an error, not a silent fall back to
the CPU: a run that was meant for the card and ran on the host would report
host numbers under the card's name.  Callers that want the CPU (the tests)
say so with ``device="cpu"``.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = DEFAULT_DEVICE) -> torch.device:
    """Return ``torch.device(device)``, raising if it names CUDA and no GPU
    is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False on this host; pass device='cpu' to run the plain PyTorch "
            "path on the CPU"
        )
    return dev


# the CLI's --dtype values (the kernel takes float32 and bfloat16)
_DTYPES = {"float32": torch.float32, "f32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(dtype: str | torch.dtype | None) -> torch.dtype:
    """Compute dtype from a CLI-style name; ``None`` means float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[dtype]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}; known: {sorted(_DTYPES)}") from None
