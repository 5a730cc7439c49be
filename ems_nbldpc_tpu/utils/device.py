"""The card a measurement runs on.

A measurement that finds no GPU fails: there is no CPU fallback, and every
number is reported beside the card's name and power limit, since a card
set below its maximum power runs slower under load.
"""
from __future__ import annotations

import subprocess


def require_gpu(n: int = 1):
    """The visible devices, if there are at least ``n`` and they are GPUs;
    raises SystemExit otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        raise SystemExit(
            f"needs {n} GPU(s); JAX sees {len(devs)} "
            f"{devs[0].platform} device(s)"
        )
    return devs


def card_info() -> str:
    """``name, power.limit`` of the first card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
