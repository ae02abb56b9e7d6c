"""Device lists and grids (the reference's ``parallel/mesh.py``).

The reference lays its chips out as a ``jax.sharding.Mesh``, replicates the
scene into every chip's memory and shards the pixel grid in row bands or
2-D tiles (SURVEY 5.8). Here a 1-D "mesh" is a list of ``torch.device``s
and a 2-D one a list of rows of them; the renders of ``render_sharded.py``
and ``Renderer(devices=...)`` put one replica of the device scene on each
(``replicate``, the counterpart of ``replicated``). ``row_sharded`` has no
counterpart: without a ``NamedSharding`` the row bands are simply rendered
on their device and joined on the first one.

A device may appear more than once (``["cpu"] * 8``, or ``cuda:0``
repeated on a machine with one card): each entry is a unit of work, and
its replica is the same tensors.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def make_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The given devices, or every CUDA device (none without a card)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def make_mesh_2d(rows: int, cols: int,
                 devices: Optional[Sequence] = None) -> List[List[torch.device]]:
    """A ``rows`` x ``cols`` grid of the first ``rows * cols`` devices (of
    every CUDA device by default), row-major: tile (iy, ix) renders on
    ``grid[iy][ix]``. Raises ``ValueError`` when there are too few."""
    devices = make_mesh(devices)
    if len(devices) < rows * cols:
        raise ValueError(f"need {rows * cols} devices, have {len(devices)}")
    return [devices[r * cols:(r + 1) * cols] for r in range(rows)]


def replicate(tree, device, memo: Optional[dict] = None):
    """A copy of ``tree`` with every tensor leaf on ``device``: tensors are
    moved (``Tensor.to``, which returns a tensor already there as it is),
    NamedTuples, tuples, lists and dicts are rebuilt around their moved
    leaves, and everything else (numpy arrays, ints, the host metadata of
    K7's static pack, None) is kept as the same object. ``memo`` (a dict
    kept by the caller between calls) maps each source tensor to its copy,
    so a tree that changed in a few leaves copies only those; after the
    call it holds the leaves of this tree only."""
    device = torch.device(device)
    used = {}

    def go(x):
        if isinstance(x, torch.Tensor):
            hit = None if memo is None else memo.get(id(x))
            if hit is None or hit[0] is not x:
                hit = (x, x.to(device))
            used[id(x)] = hit
            return hit[1]
        if isinstance(x, np.ndarray):
            return x
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(go(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(go(v) for v in x)
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        return x

    out = go(tree)
    if memo is not None:
        memo.clear()
        memo.update(used)
    return out
