"""The table of peaks (``peaks.json``), by the card's name."""

from __future__ import annotations

import json
import os


def hbm_bytes_per_s(kind: str) -> float | None:
    """Published device-memory bandwidth of the card ``kind``, or None."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as f:
        entry = json.load(f).get(kind)
    return None if entry is None else float(entry["hbm_bytes_per_s"])
