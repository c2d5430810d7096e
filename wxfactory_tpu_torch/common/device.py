"""The torch device a caller asked for, and the count of host syncs."""

import contextlib

import torch

# Waits of the host for the device made through ``host_read``, ``to_host``
# and ``synchronize`` (the Krylov controls, the NaN guard, checkpoints, the
# end of a run).
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
