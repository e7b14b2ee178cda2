"""What a run measured on: the card's name and count, and nvidia-smi's
name and power limit."""
from __future__ import annotations

import subprocess


def power_limit() -> str:
    """nvidia-smi's name and power limit of the first card, or why it could
    not be read."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    if r.returncode != 0:
        return f"nvidia-smi failed: {(r.stderr or r.stdout).strip()}"
    return r.stdout.strip().splitlines()[0]


def record(torch, n_cards: int, peak_bytes: int) -> dict:
    """The result's ``device`` object."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n_cards, "memory_peak_bytes": int(peak_bytes),
            "smi": power_limit()}
