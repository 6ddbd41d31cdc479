"""The device an entry point of the port runs on when the caller names
none: the CUDA card. Without a card that is an error that says how to ask
for the CPU, never a silent move to it."""

from __future__ import annotations

import torch


def resolve(device: torch.device | str | None, who: str) -> torch.device:
    """``device`` as a torch.device, "cuda" when it is None; RuntimeError
    naming ``device="cpu"`` when that means a card and none is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; the port runs on the "
                           "card by default, pass device=\"cpu\" to run on "
                           "the CPU")
    return device
