"""Device selection shared by the port's entry points."""

from __future__ import annotations

import numpy as np
import torch

from .utils.profiling import count


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Asked for ``cuda`` (or for nothing) without a card, this
    raises — the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def as_tensor(x, device: torch.device, dtype: torch.dtype | None = None):
    """numpy array / tensor / scalar -> tensor on ``device``. Integer and
    bool data keep their type unless ``dtype`` says otherwise."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a new tensor on ``device``, counted as one
    ``h2d_copies``: on a card through pinned memory, non-blocking (no
    wait for the work in flight, which keeps the tensors it was given)."""
    count("h2d_copies")
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)
