"""The CUDA device: selection and the card's identity for measurements."""

from __future__ import annotations

import subprocess

import torch


def cuda_device() -> torch.device:
    """The current CUDA device (the first card, unless a process of a
    multi-card run set its own); raises where there is none (a measurement
    path never falls back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", torch.cuda.current_device())


def card_info() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]
