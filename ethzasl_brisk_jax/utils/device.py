"""The accelerator a measurement runs on: required, and named.

A measurement that finds no GPU fails; it never falls back to the CPU.
"""
from __future__ import annotations

import subprocess


class NoGpuError(RuntimeError):
    """JAX's default backend is not a GPU."""


def require_gpu(n: int = 1) -> list:
    """JAX's devices, when the default backend is a GPU with >= n cards."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:  # a requested backend failed to start
        raise NoGpuError(f"JAX found no usable backend: {e}") from e
    if devices[0].platform != "gpu":
        raise NoGpuError(
            f"needs a GPU; JAX's default backend is {devices[0].platform}"
        )
    if len(devices) < n:
        raise NoGpuError(f"needs {n} GPUs; JAX sees {len(devices)}")
    return devices


def device_record(devices) -> dict:
    """The device as JAX reports it, for result lines."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def gpu_name_and_power_limit() -> list[str]:
    """``name, power.limit`` of each card, as nvidia-smi prints them.

    Runs nvidia-smi in a child process, which does not touch JAX.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]
