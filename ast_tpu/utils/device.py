"""What a measurement needs to know about the device it ran on.

Every number a benchmark or smoke run prints names its device: JAX's
platform, device kind and device count, plus the card's name and power
limit as ``nvidia-smi`` reports them (a card set below its maximum power
runs slower under load).  A measurement that finds no GPU fails here; it
never falls back to the CPU.
"""

import shutil
import subprocess

NVIDIA_SMI_QUERY = ["--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


class NoGpuError(RuntimeError):
    """JAX's default backend is not a GPU."""


def device_info(devices=None):
    """{"platform", "kind", "count"} of JAX's devices, as JAX reports
    them (``platform`` of the first device, its ``device_kind``)."""
    import jax

    devices = jax.devices() if devices is None else devices
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def require_gpu(devices=None):
    """``device_info`` when JAX's devices are GPUs; ``NoGpuError``
    naming the platform found otherwise."""
    info = device_info(devices)
    if info["platform"] != "gpu":
        raise NoGpuError(
            f"no GPU: JAX's default platform is {info['platform']!r} "
            f"({info['count']} x {info['kind']}); this measurement runs "
            "only on a GPU")
    return info


def parse_nvidia_smi(text):
    """Parse ``nvidia-smi --query-gpu=name,power.limit --format=csv,
    noheader`` output: one ``{"name", "power_limit"}`` per card line."""
    cards = []
    for line in text.strip().splitlines():
        if not line.strip():
            continue
        name, _, limit = line.rpartition(",")
        if not name:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append({"name": name.strip(), "power_limit": limit.strip()})
    if not cards:
        raise ValueError("nvidia-smi printed no card")
    return cards


def nvidia_smi(binary="nvidia-smi"):
    """(raw output, parsed cards) of the name/power-limit query.  Raises
    ``FileNotFoundError`` when the binary is missing."""
    path = shutil.which(binary)
    if path is None:
        raise FileNotFoundError(f"{binary} not found on PATH")
    out = subprocess.run([path, *NVIDIA_SMI_QUERY], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    return out.strip(), parse_nvidia_smi(out)
