"""Device probe of the port.

The JAX package probes for a TPU (``is_tpu``, ``pallas_platform``); the port
asks ``torch.cuda`` instead.  There is no global device state: entry points
take a ``device`` argument and resolve ``None`` through
:func:`default_device`, which refuses to fall back to the CPU quietly.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Union

import torch


class NoDeviceError(RuntimeError):
    """No CUDA card is visible and the caller did not ask for the CPU."""


def default_device() -> torch.device:
    """``cuda:0`` when a card is visible; raises :class:`NoDeviceError`
    otherwise — a CPU sweep is only ever an explicit request."""
    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is available; pass device='cpu' "
            "(CLI: --backend torch --device cpu) to run the plain version "
            "on the CPU"
        )
    return torch.device("cuda", 0)


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` -> :func:`default_device`; anything else as given."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(f"device {dev} requested but CUDA is unavailable")
    return dev


def device_desc() -> str:
    """One-liner for logs: the card's name and the visible card count."""
    if not torch.cuda.is_available():
        return "cpu (no CUDA device)"
    return f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"


def nvidia_smi(query: str = "name,power.limit") -> Optional[str]:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` of the first
    card (by default its name and power limit), or None when the tool is
    missing or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None
