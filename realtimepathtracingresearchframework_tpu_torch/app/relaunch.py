"""Relaunch-on-rebuild: the developer-loop "elastic restart".

The reference tracks the executable's mtime; when a rebuild lands it exits
the frame loop, persists all state through the auto-serialized imstate ini,
spawns the sibling binary, and hands over (app_state.cpp:537-555,
main.cpp:231-246). Here the "executable" is the Python package and its
CUDA sources: we watch the package's ``.py`` files and ``csrc/*.cu`` /
``csrc/*.cuh`` and re-exec the interpreter with identical argv; the new
process rebuilds an edited kernel at its first launch (``kernels/build.py``
keys each library by its sources' digest), and state continuity comes from
the same imstate ini mechanism.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Iterable, Optional

from realtimepathtracingresearchframework_tpu_torch.utils.error_io import info


SOURCE_SUFFIXES = (".py", ".cu", ".cuh")  # the program: Python and CUDA


def _package_sources() -> Iterable[str]:
    import realtimepathtracingresearchframework_tpu_torch as pkg

    root = os.path.dirname(pkg.__file__)
    for dirpath, _dirnames, filenames in os.walk(root):
        for f in filenames:
            if f.endswith(SOURCE_SUFFIXES):
                yield os.path.join(dirpath, f)


class RebuildWatcher:
    """Snapshot source mtimes at startup; ``changed()`` flips true once any
    watched file is rewritten (the reference's executable-mtime check)."""

    def __init__(self, paths: Optional[Iterable[str]] = None,
                 min_interval_s: float = 2.0):
        self._paths = list(paths) if paths is not None else list(_package_sources())
        self._mtimes: Dict[str, float] = {}
        self._min_interval_s = float(min_interval_s)
        self._last_check = 0.0
        for p in self._paths:
            try:
                self._mtimes[p] = os.stat(p).st_mtime
            except OSError:
                pass

    def changed(self) -> bool:
        # called from the viewer's frame loop: throttle the full-package
        # stat sweep (one stat per source file) to every couple seconds
        import time

        now = time.monotonic()
        if now - self._last_check < self._min_interval_s:
            return False
        self._last_check = now
        for p, old in self._mtimes.items():
            try:
                if os.stat(p).st_mtime != old:
                    return True
            except OSError:
                return True
        return False


def relaunch(save_state=None) -> None:
    """Persist state (callable writes the imstate ini) and replace this
    process with a fresh interpreter running the same argv."""
    if save_state is not None:
        save_state()
    info("source changed; relaunching %s", " ".join(sys.argv))
    os.execv(sys.executable, [sys.executable] + sys.argv)
