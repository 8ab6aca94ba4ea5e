"""The one place that decides where a tensor goes."""

import torch


def resolve_device(device):
    """``None`` means the card, and raises without one: no entry point
    looks for a GPU and carries on without it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain versions on the host")
        return torch.device("cuda")
    return torch.device(device)
