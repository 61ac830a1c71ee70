"""Where the port runs: one place that resolves the device.

Entry points run on CUDA unless the caller passes ``device="cpu"``, which
selects the plain PyTorch versions of the kernels.  With no device and no
CUDA, ``resolve`` raises: the port never falls back to the CPU on its own.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """The torch.device an entry point runs on.  None means the current
    CUDA device, and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on CUDA unless the caller "
                "passes device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy array -> tensor on `device`.  A CUDA copy goes through pinned
    memory and is only enqueued on the current stream (no host sync)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)
