"""Device selection for the library entry points."""

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device.  A CUDA device with no card present
    raises: the entry points never fall back to the CPU by themselves."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def peak_allocated(device):
    """torch.cuda.max_memory_allocated of ``device`` on a card, else None:
    the device's peak allocation so far, as a build's stage ends.  A
    stage that ran on the host under a CUDA ``device`` with no card (the
    numpy backends) reads None too."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.max_memory_allocated(dev)
