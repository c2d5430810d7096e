"""The torch device a caller asked for, and the count of host syncs."""

import contextlib

import numpy as np
import torch

# Waits of the host for the device made through ``host_read``, ``to_host``,
# ``from_host`` and ``synchronize`` (the Krylov controls, the NaN guard,
# checkpoints, the end of a run, a host preconditioner's solve).
host_syncs = 0
_forbidding = False


@contextlib.contextmanager
def forbid_uncounted_syncs():
    """Within the block, any wait of the host for the card but the counted
    ones raises (torch's CUDA sync debug mode "error"): an ``.item()``, a
    ``bool()`` of a device value, a copy from host memory. Does nothing
    without a card."""
    global _forbidding
    if not torch.cuda.is_available():
        yield
        return
    before, outer = torch.cuda.get_sync_debug_mode(), _forbidding
    _forbidding = True
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        _forbidding = outer
        torch.cuda.set_sync_debug_mode(before)


@contextlib.contextmanager
def _counted_wait():
    """Lets one counted wait through ``forbid_uncounted_syncs``."""
    global host_syncs
    host_syncs += 1
    if not _forbidding:
        yield
        return
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("error")


def host_read(t: torch.Tensor):
    """``t.tolist()``, counted in ``host_syncs``."""
    with _counted_wait():
        return t.tolist()


def to_host(t: torch.Tensor):
    """``t`` as a numpy array on the host, counted in ``host_syncs``."""
    with _counted_wait():
        return t.detach().cpu().numpy()


def from_host(a, like: torch.Tensor) -> torch.Tensor:
    """The host array ``a`` as a tensor of ``like``'s dtype on its device
    (a copy from pageable host memory, which waits for the card), counted
    in ``host_syncs``."""
    with _counted_wait():
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def to_device(a, like: torch.Tensor) -> torch.Tensor:
    """The host array ``a`` as a float64 tensor on ``like``'s device,
    without a wait: on a CUDA device the copy goes through pinned host
    memory and is queued on the current stream (the caching host
    allocator keeps the pinned block until the copy has run), so it
    passes ``forbid_uncounted_syncs``; on the CPU a plain conversion."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))
    if like.device.type != "cuda":
        return t.to(like.device)
    return t.pin_memory().to(like.device, non_blocking=True)


def synchronize(dev: torch.device) -> None:
    """Wait for the work queued on ``dev`` (a CUDA device), counted in
    ``host_syncs``."""
    with _counted_wait():
        torch.cuda.synchronize(dev)


def resolve_device(device) -> torch.device:
    """The torch device a run was asked for; a CUDA request without a
    usable GPU raises instead of running somewhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev
