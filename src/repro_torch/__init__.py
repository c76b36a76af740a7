"""PyTorch/CUDA port of the ``repro`` package for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports
nothing of it.  Its entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU, where the kernels' plain PyTorch
versions run instead.
"""
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    and no card is present (never carries on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
