"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A CUDA
request without a usable card raises; nothing drops to the CPU quietly.
"""

from __future__ import annotations

import torch


def set_float32_parity() -> None:
    """Keep float32 convolutions and matmuls in full fp32 (no TF32).

    cuDNN convolutions default to TF32, which rounds like a 10-bit mantissa;
    the chunked-AR loop amplifies rounding of that size far past the decode
    quality budget, so float32 decodes turn it off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. Raises if CUDA is asked for and unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU")
        set_float32_parity()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
