"""Row-band and 2-D tile sharded renders (the reference's
``parallel/render_sharded.py``).

Data-parallel over rays: each device renders a row band (or a tile) of the
pixel grid on its own replica of the scene (``mesh.replicate``). The only
traffic between devices is the reference's thin plan (SURVEY 5.8): the
bands are joined on the first device, its all-gather, and the ray counts
are summed, its ``psum``.

Usage::

    f = build_sharded_render(make_mesh(), cfg, width, height)
    accum, rays = f(device_scene, fp, view, spp)   # accum (H, W, 4)

Every tile renders through ``integrator.render_tile`` with the frame's
width and height, so the camera mapping and the RNG's pixel keying are the
whole frame's and the joined image is the single-device frame's. The
devices run one after another: each pass reads its live-lane count on the
host once per bounce (``integrator.trace_paths``), which waits for that
device.
"""

from __future__ import annotations

import torch

from realtimepathtracingresearchframework_tpu_torch.ops.integrator import (
    IntegratorConfig,
    render_tile,
    tile_tables,
)
from realtimepathtracingresearchframework_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
)


def build_sharded_render(devices, cfg: IntegratorConfig, width: int,
                         height: int):
    """Returns (ds, fp, view, spp) -> (accum (H, W, 4) on the first device,
    rays as an int), the frame split into one row band per device of
    ``devices`` (``mesh.make_mesh``), top band on the first. ``height``
    must divide evenly by the number of devices (``ValueError``)."""
    devices = make_mesh(devices)
    n_dev = len(devices)
    if height % n_dev != 0:
        raise ValueError(f"height {height} not divisible by {n_dev} devices")
    rows = height // n_dev
    return _tiled([[(d, 0, i * rows, width, rows)]
                   for i, d in enumerate(devices)], cfg, width, height)


def build_sharded_render_2d(grid, cfg: IntegratorConfig, width: int,
                            height: int):
    """2-D sharding over ``grid`` (``mesh.make_mesh_2d``: rows of devices):
    device ``grid[iy][ix]`` renders the (H / rows, W / cols) tile (iy, ix).
    The frame must divide evenly in both dimensions (``ValueError``)."""
    rows, cols = len(grid), len(grid[0])
    if height % rows != 0 or width % cols != 0:
        raise ValueError(
            f"frame {width}x{height} not divisible by mesh "
            f"(tile_x={cols}, tile_y={rows})"
        )
    th, tw = height // rows, width // cols
    return _tiled([[(torch.device(grid[iy][ix]), ix * tw, iy * th, tw, th)
                    for ix in range(cols)] for iy in range(rows)],
                  cfg, width, height)


def _tiled(tiles, cfg, width, height):
    """The render over ``tiles``, rows of (device, x0, y0, tile_w, tile_h):
    each tile's swizzle tables made once on its device, the scene
    replicated per device at each call (only the tensors that changed since
    the last call are copied), the tiles joined on the first device."""
    flat = [t for row in tiles for t in row]
    tables = [tile_tables(tw, th, d, x0, y0)
              for d, x0, y0, tw, th in flat]
    memos = {d: {} for d, *_ in flat}
    first = flat[0][0]

    def render(ds, fp, view, spp):
        out = []
        for (d, x0, y0, tw, th), tab in zip(flat, tables):
            out.append(render_tile(
                replicate(ds, d, memos[d]), cfg, fp, replicate(view, d),
                width, height, int(spp), y0=y0, tile_h=th, x0=x0, tile_w=tw,
                tables=tab))
        imgs = iter(img.to(first) for img, _ in out)
        accum = torch.cat([torch.cat([next(imgs) for _ in row], dim=1)
                           for row in tiles], dim=0)
        return accum, sum(int(rays) for _, rays in out)

    return render
