"""The cards a run uses. A measurement path that finds no card fails: it
never falls back to the CPU."""
from __future__ import annotations

import subprocess

import torch


class NoCard(RuntimeError):
    pass


def require_cards(n: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark measures the card and has no CPU mode")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} cards, {torch.cuda.device_count()} visible")


def power_limit_w(index: int = 0):
    """The card's power limit in watts as ``nvidia-smi`` reads it (None where
    it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", str(index)],
                             capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def info(count: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes), "power_limit_w": power_limit_w(0)}
