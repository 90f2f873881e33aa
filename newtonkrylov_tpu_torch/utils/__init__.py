"""Utilities: the default device, and conversion from the JAX package's
objects (:mod:`.convert`)."""

import torch

__all__ = ["default_device"]


def default_device() -> torch.device:
    """The device an entry point creates its tensors on when the caller
    names none: the card.  Without CUDA, using it raises as PyTorch does;
    nothing falls back to the CPU."""
    return torch.device("cuda")
