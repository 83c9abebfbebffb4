"""What the measuring scripts print about the card they ran on."""

from __future__ import annotations

import subprocess


def nvidia_smi_name_power() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them (one line per card). Raises if nvidia-smi fails."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip()


def require_gpu():
    """The first JAX device, which must be a GPU; raises SystemExit
    otherwise, so no measurement is ever taken on another device."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform} ({dev})")
    return dev
