"""Shared benchmark helpers (the port of `rnnt_tpu.cli.benchutil`).

Every serving and streaming bench records the device round trip beside its
latencies, so that a reader can separate the launch-and-synchronise floor
from the stack's own time.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from rnnt_tpu_torch.device import resolve_device


def nvidia_smi_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (first card)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def measure_rtt_ms(device="cuda", n: int = 20) -> float:
    """p50 of `n` round trips of a one-element add on `device`, each ended
    by `.item()` (which waits for the result), after one untimed call.  On
    the card this is the launch-plus-synchronise floor."""
    dev = resolve_device(device)
    x = torch.zeros((), dtype=torch.float32, device=dev)
    (x + 1).item()
    rtts = []
    for _ in range(n):
        t0 = time.perf_counter()
        (x + 1).item()
        rtts.append(time.perf_counter() - t0)
    return float(np.percentile(np.asarray(rtts) * 1e3, 50))
