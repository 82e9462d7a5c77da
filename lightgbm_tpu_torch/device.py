"""The device rule of the port's entry points.

They run on the card: ``device=None`` (or "cuda") resolves to CUDA and
raises when there is none.  The CPU runs only when the caller asks for
it (``device="cpu"``) — the kernels' plain versions, for tests and
reference runs.  Nothing falls back from the card to the CPU quietly.
"""
from __future__ import annotations

import torch

from .utils import log


def resolve_device(device=None) -> torch.device:
    if isinstance(device, torch.device):
        device = str(device)
    device = (device or "cuda").strip().lower()
    if device == "cpu":
        return torch.device("cpu")
    if device == "cuda" or device.startswith("cuda:"):
        if not torch.cuda.is_available():
            log.fatal("device=%s requested (the default) but no CUDA device "
                      "is available; pass device=cpu to run the plain "
                      "versions on the CPU" % device)
        return torch.device(device)
    log.fatal("Parameter device=%s is not supported (cuda or cpu)" % device)
