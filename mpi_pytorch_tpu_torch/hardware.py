"""Device resolution and the card facts reports and roofline bounds need.

``resolve_device`` is THE gate every entry point goes through: the default
is the GPU, ``MPT_PLATFORM=cpu`` selects the CPU, and asking for CUDA on a
machine without it raises — the port never carries on quietly on the CPU.
"""

from __future__ import annotations

import os
import subprocess

import torch

# Published dense peaks of one NVIDIA H100 SXM (NVIDIA data sheet), at its
# full 700 W power limit: the denominators of a kernel's bound.
H100_PEAK_BF16_FLOPS = 989e12  # tensor cores, dense
H100_PEAK_F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
H100_PEAK_HBM_BYTES_PER_S = 3.35e12


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``"cuda"`` — or ``"cpu"`` under ``MPT_PLATFORM=cpu``. Raises when CUDA
    is asked for and there is none."""
    if device is None:
        device = "cpu" if os.environ.get("MPT_PLATFORM", "").lower() == "cpu" else "cuda"
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False — pass "
            "device='cpu' (or set MPT_PLATFORM=cpu) to run the plain PyTorch "
            "versions on the CPU"
        )
    return dev


def card_report() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them —
    written beside every number measured on it (a card set below its
    maximum power runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def bound_ms(bytes_moved: float, ops: float, peak_ops_per_s: float) -> tuple[float, str]:
    """The least time (ms) an H100 SXM could take for work that moves
    ``bytes_moved`` bytes of device memory and does ``ops`` operations at
    ``peak_ops_per_s``, and which of the two bounds it:
    ``("bytes" | "operations")``."""
    t_bytes = bytes_moved / H100_PEAK_HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
