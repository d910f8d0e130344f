"""Device resolution and numerics settings for the port.

Entry points default to the CUDA card. They run on the CPU only when the
caller asks for it (``device="cpu"``, as the tests do), and they raise when
no card is present and the CPU was not asked for: the port never falls back
to the CPU on its own.

Every f32 matmul runs at full precision. The JAX package sets
``precision=HIGHEST`` everywhere because the tracker diverged under
reduced-precision products; here that means TF32 off for both cuBLAS and
cuDNN.
"""

from __future__ import annotations

from typing import Callable

import torch


def set_full_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "clid_slam_torch: CUDA is not available; pass device='cpu' "
                "to run on the CPU"
            )
        set_full_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_device(t: torch.Tensor) -> Callable[[torch.device], torch.Tensor]:
    """``t`` on a given device, copied there at the first call for it: later
    calls copy nothing, so they wait for nothing and a CUDA graph can hold
    the copy."""
    copies = {}

    def on(device):
        if device not in copies:
            copies[device] = t.to(device)
        return copies[device]

    return on


def scalar(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` as a 0-d tensor of ``dtype`` on ``device``. A Python number is
    filled in on the device (``torch.tensor`` would copy it from pageable
    host memory, and the host would wait); a tensor is converted."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)
