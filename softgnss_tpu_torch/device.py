"""Where the port's entry points run: on the card, unless the caller names
the CPU.

Every entry point that creates or receives a capture (the synthesizers,
``acquire``, ``track``, ``run_receiver``, the CLI) runs on ``"cuda"`` by
default and raises when no CUDA device is available; nothing falls back
to the host on its own.  A CPU tensor, or ``device="cpu"``, keeps the
work on the host, where every kernel wrapper takes its plain version.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device) -> torch.device:
    """``torch.device(device)``; raises if it is a CUDA device and none is
    available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but no CUDA device is "
                           "available; pass device='cpu' to run on the host")
    return dev


def place(signal, device=None) -> torch.Tensor:
    """The int8 capture ``signal`` as a tensor on ``device``: a tensor stays
    where it lies unless ``device`` is given; a NumPy array (or memmap)
    goes to ``device``, ``"cuda"`` when none is given."""
    if isinstance(signal, torch.Tensor):
        return signal if device is None else signal.to(resolve(device))
    dev = resolve("cuda" if device is None else device)
    return torch.from_numpy(np.require(signal, np.int8, ["C", "W"])).to(dev)
