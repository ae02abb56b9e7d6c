"""What a run records about its own noise: the host's cores and load, the
intra-op threads, the card's clocks and power sampled beside the window,
and the spread of the window's frames."""

from __future__ import annotations

import os
import statistics
import subprocess
from typing import List

SMI_QUERY = "clocks.sm,power.draw,power.limit,temperature.gpu"


def host_state() -> dict:
    import torch

    return {"cpus": len(os.sched_getaffinity(0)),
            "loadavg": list(os.getloadavg()),
            "torch_threads": torch.get_num_threads()}


class SmiSampler:
    """``nvidia-smi`` sampling the card every ``period_ms`` while the window
    runs; ``stop`` ends it, waits for it and returns its rows."""

    def __init__(self, period_ms: int = 2000):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={SMI_QUERY}",
                 "--format=csv,noheader,nounits", f"--loop-ms={period_ms}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self) -> List[List[str]]:
        if self.proc is None:
            return []
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        return [[x.strip() for x in line.split(",")]
                for line in out.splitlines() if line.strip()]


def quartiles(values: List[float]) -> List[float]:
    """(q1, median, q3) as ``statistics.quantiles(n=4)`` gives them."""
    if len(values) < 2:
        return [values[0]] * 3 if values else []
    return list(statistics.quantiles(values, n=4))
