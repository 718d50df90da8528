"""The card: its presence, name and power limit, peak memory, and the
check that no JAX module is loaded."""

from __future__ import annotations

import subprocess
import sys

import torch

# top-level module names a run may not hold (compared whole: the port's
# package is `rnnt_tpu_torch`, which only begins with `rnnt_tpu`)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "rnnt_tpu")


def forbidden_loaded(modules=None) -> list:
    """Top-level names of `modules` (sys.modules by default) that are
    forbidden."""
    names = {n.split(".", 1)[0] for n in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN_MODULES))


def require_cards(n: int) -> None:
    """Exit with code 2, printing no result, without n CUDA cards."""
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: the benchmark runs on the card")
    if torch.cuda.device_count() < n:
        sys.exit(f"the cell needs {n} cards, {torch.cuda.device_count()} "
                 "are visible")


def power_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as ex:
        return f"nvidia-smi unavailable ({type(ex).__name__})"


def describe(device, count: int, peak_bytes: int) -> dict:
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": kind, "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def peak_bytes(device) -> int:
    return (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
