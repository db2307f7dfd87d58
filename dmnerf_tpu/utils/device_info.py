"""What a measurement runs on: the accelerator JAX sees and the card's power limit.

Every time the benchmark or the chip smoke test prints names the device it ran on
(platform, device_kind, count), the card's name and power limit as nvidia-smi reports
them (a card set below its maximum power runs slower under load), and the matmul
precision in force (float32 matmuls on a GPU may run as TF32 at "default").
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def require_gpu():
    """The first JAX device; raises unless it is a GPU (no CPU fallback)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU visible to JAX: default backend is {dev.platform!r} "
                           f"({dev.device_kind})")
    return dev


def card_info() -> str:
    """`name, power.limit` lines of every card, exactly as nvidia-smi prints them."""
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def matmul_precision() -> str:
    import jax

    return str(jax.config.jax_default_matmul_precision or "default")


def device_summary() -> dict:
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
