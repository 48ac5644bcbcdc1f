"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

#: names the device a task process (a cluster trial, a serving replica)
#: runs on; ``cuda`` when unset
DEVICE_ENV = "DTPU_TORCH_DEVICE"


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


def task_device(logger) -> torch.device:
    """The device of a process the master's agent started: CUDA (the
    current device, by index) unless ``DTPU_TORCH_DEVICE`` names another;
    logged as ``device: ...``.  Raises as ``resolve_device`` does."""
    device = resolve_device(os.environ.get(DEVICE_ENV) or None)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device() if device.index is None
                              else device.index)
        logger.info("device: %s (%s), CUDA_VISIBLE_DEVICES=%s", device,
                    torch.cuda.get_device_name(device),
                    os.environ.get("CUDA_VISIBLE_DEVICES", "(unset)"))
    else:
        logger.info("device: %s (%s=%s)", device, DEVICE_ENV, os.environ.get(DEVICE_ENV))
    return device
