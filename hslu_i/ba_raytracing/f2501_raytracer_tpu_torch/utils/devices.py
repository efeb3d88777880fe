"""Device selection for the port's entry points.

Entry points render on the card: `device=None` means "cuda". The CPU is
used only when the caller asks for it (`device="cpu"`, as the tests do);
without a card and without that request an entry point raises instead of
quietly running the plain PyTorch twins on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch twins on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
