"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None, *, meta: bool = False) -> torch.device:
    """``None`` means the CUDA device; the CPU runs only when asked for.
    With ``meta=True`` the meta device is taken too: tensors with shapes
    and dtypes and no storage (``launch.steps.abstract_params``).

    Raises when a CUDA device is wanted and none is available.  On CUDA it
    also turns TF32 off for matmuls and cuDNN convolutions: cuDNN runs f32
    convolutions in TF32 by default, which keeps about three decimal
    digits and would drift from the f32 reference.
    """
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device unless device='cpu' is "
                "passed, and torch.cuda.is_available() is False")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu" and not (meta and device.type == "meta"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {device}")
    return device
