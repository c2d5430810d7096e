"""Global (whole-vector) reductions on torch tensors.

Counterpart of ``wxfactory_tpu/solvers/global_ops.py``: named functions so
that the Krylov algorithms' reduction sites stay visible. On one device
each is one reduction kernel; the result stays on the tensor's device."""

import torch


def global_norm(vec: torch.Tensor) -> torch.Tensor:
    """2-norm across the whole vector."""
    v = vec.reshape(-1)
    return torch.sqrt(torch.dot(v, v))


def global_dotprod(vec1: torch.Tensor, vec2: torch.Tensor) -> torch.Tensor:
    """Dot product across the whole vectors."""
    return torch.dot(vec1.reshape(-1), vec2.reshape(-1))


def global_inf_norm(vec: torch.Tensor) -> torch.Tensor:
    """Infinity norm across the whole vector."""
    return vec.abs().max()
