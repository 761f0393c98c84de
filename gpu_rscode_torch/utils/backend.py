"""Device selection for the port's entry points.

The rule every entry point (``RSCodec``, ``api.encode_file``,
``api.decode_file``, the CLI) holds: run on CUDA unless the caller names
another device.  With no device given and no GPU present they raise; they
never carry on on the CPU by themselves.
"""

from __future__ import annotations

import torch


def cuda_devices_present() -> bool:
    """True when at least one CUDA device is visible to PyTorch."""
    return torch.cuda.is_available() and torch.cuda.device_count() > 0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device and raises ``RuntimeError`` when
    there is none.  A named device is taken as given; a CUDA one that is not
    present raises as well.
    """
    if device is None:
        if not cuda_devices_present():
            raise RuntimeError(
                "no CUDA device present; pass device='cpu' (CLI: --device cpu) "
                "to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not cuda_devices_present():
        raise RuntimeError(f"device {str(dev)!r} requested but no CUDA device is present")
    return dev


def backend_label() -> str:
    """The label a measurement records for where it ran: "cuda" when a CUDA
    device is present, else "cpu"."""
    return "cuda" if cuda_devices_present() else "cpu"
