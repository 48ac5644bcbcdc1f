"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another one.  Without a GPU and without an explicit device this raises;
    the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "determined_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain versions on the CPU"
        )
    return dev
