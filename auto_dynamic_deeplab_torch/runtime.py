"""Device selection and the package's single numerics switch.

``ALLOW_TF32`` is the one place the port sets
``torch.backends.cudnn.allow_tf32`` and ``torch.backends.cuda.matmul.allow_tf32``:
both are False, so the fp32 policy computes in full fp32 on the card (the
JAX fp32 path's convs and matmuls are fp32 too). The bf16 policy casts its
operands to bf16 explicitly and is not affected by either flag.
"""
from __future__ import annotations

import torch

ALLOW_TF32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for ``cpu``. Asking for ``cuda`` without a GPU raises; there is no
    silent fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (CLI: --device cpu) to run on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = ALLOW_TF32
        torch.backends.cuda.matmul.allow_tf32 = ALLOW_TF32
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
