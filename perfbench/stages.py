"""The port's frame stages in a traced window.

The port names the stages of its frame path with ``rptr.`` spans
(``utils/profiling.py``), which the profiler records as ``user_annotation``
ranges on the clock of its device activities: ``rptr.pass`` >
``rptr.bounce.<b>`` > the stages below, and ``rptr.sync.<site>`` around
each blocking device-to-host read. A kernel belongs to the innermost stage
span open at its launch; pass, bounce and sync spans are not stages.

``Trace`` keeps no correlation ids, so the window's launch calls and its
kernels pair in order: on one stream they run in the order they were
launched, one kernel a launch. The window holds the kernels whose start
the profiler puts inside it, and its device timestamps drift from the
host's: the kernels of the first or the last launches can fall outside,
so the kernels are a run of consecutive launches, not always all of them.
The run is found by the walks: the port launches each walk kernel
(``perfbench.kernels.is_walk``) itself, outside any PyTorch operator, and
launches nothing else there. The walk kernels, taken in order, must sit
at the walk launches, taken in order, at one offset; where no offset, or
more than one, fits every walk, nothing is read.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from perfbench.kernels import is_walk
from perfbench.trace import LAUNCH_CALLS, Trace

PASS_SPAN = "rptr.pass"
SYNC_PREFIX = "rptr.sync."
STAGES = ("rptr.camera", "rptr.closest", "rptr.shade", "rptr.nee",
          "rptr.shadow", "rptr.sort", "rptr.blend")


def traced_by_port(trace: Optional[Trace]) -> bool:
    """The window holds device activity and the port's spans: a program
    without them, such as an older commit, and a run on the CPU, where no
    read waits for a device, read nothing."""
    return (trace is not None and bool(trace.device)
            and any(n == PASS_SPAN for n, _, _ in trace.host))


def sync_spans(trace: Trace) -> List[Tuple[str, float, float]]:
    return [h for h in trace.host if h[0].startswith(SYNC_PREFIX)]


def _outside_operators(trace: Trace, launches) -> List[int]:
    """Indices of the launch times that no PyTorch operator (a host span
    named ``namespace::op``) encloses."""
    ops = sorted((s, s + d) for n, s, d in trace.host if "::" in n)
    starts, reach, far = [], [], float("-inf")
    for s, e in ops:
        far = max(far, e)
        starts.append(s)
        reach.append(far)
    out = []
    for i, t in enumerate(launches):
        j = bisect.bisect_right(starts, t) - 1
        if j < 0 or reach[j] < t:
            out.append(i)
    return out


def launch_offset(trace: Trace, launches) -> Optional[int]:
    """The launch index of the window's first kernel: 0 where every launch
    has its kernel, else the one offset at which the walk kernels meet the
    launches made outside any operator; None where there is none, or more
    than one."""
    if len(launches) == len(trace.kernels):
        return 0
    kernels = sorted(trace.kernels, key=lambda k: k[1])
    walks = [i for i, (name, _, _) in enumerate(kernels) if is_walk(name)]
    bare = _outside_operators(trace, launches)
    if not walks or len(bare) < len(walks):
        return None
    fits = []
    for skip in range(len(bare) - len(walks) + 1):
        a = bare[skip] - walks[0]
        if (0 <= a and a + len(kernels) <= len(launches)
                and all(bare[skip + j] - w == a for j, w in enumerate(walks))
                and bare[:skip] == [b for b in bare if b < a]
                and bare[skip + len(walks):] == [
                    b for b in bare if b >= a + len(kernels)]):
            fits.append(a)
    return fits[0] if len(fits) == 1 else None


def kernel_stages(trace: Optional[Trace]):
    """[(stage or None, kernel name, device us)] of the window's kernels,
    each under the innermost stage span open at its launch; None without
    the port's spans or where the kernels meet the launches at no single
    offset (``launch_offset``)."""
    if not traced_by_port(trace) or not trace.kernels:
        return None
    launches = sorted(s for n, s, _ in trace.host if n in LAUNCH_CALLS)
    a = launch_offset(trace, launches)
    if a is None:
        return None
    launches = launches[a:a + len(trace.kernels)]
    spans = sorted(((s, s + d, n) for n, s, d in trace.host if n in STAGES),
                   key=lambda x: (x[0], -x[1]))
    stack, j, stages = [], 0, []
    for t in launches:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        stages.append(stack[-1][2] if stack else None)
    kernels = sorted(trace.kernels, key=lambda k: k[1])
    return [(st, name, dur) for st, (name, _, dur) in zip(stages, kernels)]


def stage_ms(trace: Optional[Trace], stages, keep=lambda name: True):
    """Device ms a frame of the kernels launched in ``stages`` whose name
    ``keep`` admits; None where ``kernel_stages`` reads nothing."""
    ks = kernel_stages(trace)
    if ks is None:
        return None
    us = sum(d for st, name, d in ks if st in stages and keep(name))
    return us / trace.frames / 1e3
