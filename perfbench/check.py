"""How ``correct`` is decided: the program's accumulation, read back as
display values by ``Renderer.readback_framebuffer`` once the window has
closed, against the reference's (``reference/``) at a sample of pixels
drawn from the seed, over every frame the window accumulated.

One number is compared: ``off_share``, the share (%) of the sampled pixels
whose widest channel gap to the reference exceeds ``GAP``. The reference
follows the program's arithmetic, so a sound run matches it bit for bit
except where two triangles are hit at exactly the same distance; the
limit (``limits.json``, or the configuration's own ``check_limits``) was
set from sound runs and the bfloat16 control as ``PERF.md`` records.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
GAP = 1e-5  # display units: a fortieth of an 8-bit step at 1.0


def limits_for(config: dict) -> Dict[str, float]:
    with open(HERE / "limits.json") as f:
        limits = json.load(f)
    limits.update(config.get("check_limits", {}))
    return limits


def sample_pixels(seed: int, width: int, height: int,
                  count: int) -> Tuple[np.ndarray, np.ndarray]:
    """``count`` distinct pixels (px, py), uniform over the frame."""
    rng = np.random.default_rng(int(seed))
    lin = rng.choice(width * height, size=min(count, width * height),
                     replace=False)
    return (lin % width).astype(np.int64), (lin // width).astype(np.int64)


def compare(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """The compared numbers of (K, 4) display values against the
    reference's. A non-finite value counts as off."""
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64)).max(axis=1)
    off = ~(gap <= GAP)
    return {"off_share": float(100.0 * off.mean())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)


def lines(checked: Dict[str, dict]):
    """One plain line per compared number of a result's ``check``, with its
    limit."""
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r}, "
            f"{'ok' if c['value'] <= c['limit'] else 'OVER'})"
            for k, c in checked.items()]
