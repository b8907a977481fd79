"""Device policy: the port runs on the card unless the caller asks for the CPU."""

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; a CUDA request without a card raises.

    There is no quiet fallback to the CPU: a caller that wants the CPU (the
    tests, parity checks) says `device="cpu"`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev
