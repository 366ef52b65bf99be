"""The PyTorch and CUDA port of `agrifly_tpu` (README.md, "The PyTorch / CUDA port")."""

import torch


def card_or_raise(device, what: str) -> torch.device:
    """`device` as a torch.device. The port builds its tensors on the card
    by default; where a CUDA device is asked for and there is none, `what`
    raises instead of building on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device; pass device='cpu' to run on the CPU")
    return device
