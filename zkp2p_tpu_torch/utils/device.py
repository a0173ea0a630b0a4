"""Device resolution for the port's entry points: CUDA unless the caller
asks for the CPU, and an error, never a fallback, when CUDA is asked for
and absent."""

from __future__ import annotations

import torch


def check_device(device=None) -> torch.device:
    """The device asked for (None: CUDA), checked without initialising
    CUDA in this process (a supervisor that only spawns workers must not):
    raises when CUDA is wanted and there is none."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass device='cpu' "
                "to run the plain versions of its kernels on the CPU"
            )
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {d}")
    return d


def resolve_device(device=None) -> torch.device:
    """None -> the current CUDA device; "cpu" -> the CPU (the plain
    versions of every kernel).  Raises when CUDA is wanted and there is
    none."""
    d = check_device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d
