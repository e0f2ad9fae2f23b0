"""Device resolution for the port's entry points.

Entry points run on ``"cuda"`` unless the caller asks for ``"cpu"``.  A
request for CUDA on a machine without a usable GPU raises: there is no
silent CPU path.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"`` / ``"cuda:k"`` / ``"cpu"`` (or a ``torch.device``) → a
    ``torch.device`` the port can run on; raises ``RuntimeError`` when
    CUDA is asked for and no GPU is available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was requested but torch finds no "
                "CUDA device; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(
            f"device={str(device)!r} is not supported; use 'cuda' or 'cpu'")
    return dev
