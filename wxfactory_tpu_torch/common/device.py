"""The torch device a caller asked for."""

import torch


def resolve_device(device) -> torch.device:
    """The torch device a run was asked for; a CUDA request without a
    usable GPU raises instead of running somewhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev
