"""The card a measurement runs on.

Measurement entry points (bench.py, chip_smoke.py) run on a GPU only: they
refuse to start on any other platform instead of timing the CPU, and they
print the card's name and power limit beside every number, because a card
set below its maximum power limit runs slower under load.
"""

from __future__ import annotations

import subprocess


def require_gpu():
    """Return jax.devices()[0] if it is a GPU; raise SystemExit otherwise."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform} "
                         f"({devs[0].device_kind}); refusing to measure")
    return devs[0]


def device_summary() -> dict:
    """platform, device_kind and count as JAX reports them."""
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` (one
    line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
