"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point puts its tensors on: `device` when given,
    else CUDA. Without CUDA and without an explicit device this raises —
    the port never runs on the CPU unless the caller asks for it.

    On CUDA it also turns TF32 off for matmuls and convolutions: the
    ray-triangle math stays FP32 (reduced precision loses grazing hits)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
