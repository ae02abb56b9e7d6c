"""Numerical watchdogs — the PyTorch port's counterpart of the reference's
``utils/debug.py`` (its runtime validation stack, SURVEY §5.2).

The reference traps NaN production inside its jitted programs with
``jax_debug_nans``: each op's output is checked and the offending op re-run
un-jitted with a traceback. torch has no such trap. Here
``enable_nan_debugging`` sets a flag under which the renderer checks each
pass's accumulators with ``torch.isfinite`` right after the pass (a device
sync per pass) and raises naming the frame, the sample and the chunk. That
is coarser than the reference's per-op trap: it names the pass, not the op,
and it sees only what reaches the accumulators (a NaN that a later select
discards goes unseen). ``assert_all_finite`` checks a nested structure of
tensors and arrays at a readback boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.utils.error_io import throw_error

_nan_debugging = False


def enable_nan_debugging() -> None:
    """Check every pass's accumulators for non-finite values (a device sync
    per pass). Expensive — debug only."""
    global _nan_debugging
    _nan_debugging = True


def disable_nan_debugging() -> None:
    global _nan_debugging
    _nan_debugging = False


def nan_debugging() -> bool:
    """Whether ``enable_nan_debugging`` is in effect."""
    return _nan_debugging


def _leaves(tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):  # jax.tree orders a dict by its keys
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None and np.isscalar(tree):
        yield np.asarray(tree)


def assert_all_finite(tree, name: str = "value") -> None:
    """Host-side finite check over a nested structure (tuples, lists, dicts,
    named tuples) of tensors and arrays, leaves in ``jax.tree.leaves``
    order; use at readback boundaries (forces a device sync)."""
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            bad = int((~torch.isfinite(leaf)).sum())
            shape = tuple(leaf.shape)
        else:
            a = np.asarray(leaf)
            if a.dtype.kind != "f":
                continue
            bad = int((~np.isfinite(a)).sum())
            shape = a.shape
        if bad:
            throw_error("%s: leaf %d has %d non-finite values (shape %s)",
                        name, i, bad, shape)


def check_pass_finite(acc, frame: int, sample: int, chunk: int) -> None:
    """Under ``enable_nan_debugging``: raise if a pass left a non-finite
    value in its chunk's accumulators ``acc`` (a device sync), naming the
    frame (its first sample index), the in-batch sample and the chunk."""
    if not _nan_debugging:
        return
    for k, a in enumerate(acc):
        bad = int((~torch.isfinite(a)).sum())
        if bad:
            throw_error("non-finite accumulation: frame %d sample %d chunk %d "
                        "channel %d has %d non-finite values", frame, sample,
                        chunk, k, bad)
