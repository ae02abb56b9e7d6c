"""One-step entry points (the counterparts of the reference's
``__graft_entry__.py``: ``entry`` and ``dryrun_multichip``).

- ``entry(device)`` -> (fn, example_args): one megakernel path-traced
  sample batch over a 32x32 cornell-box tile on ``device``.
- ``dryrun_multichip(n, device)``: one row-band sharded render over n
  devices at 16 x 2n pixels, and, when n is even, one over a 2 x n/2 grid
  of 2-D tiles; checks their shapes and ray counts and prints a summary.
  Where the machine has fewer than n cards, ``cuda:0`` is repeated, and the
  summary says how many distinct devices took part.

Run: ``python -m realtimepathtracingresearchframework_tpu_torch.parallel.dryrun
[N] [--device cpu]``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.backend.params import (
    RenderParams,
)
from realtimepathtracingresearchframework_tpu_torch.backend.renderer import (
    Renderer,
)
from realtimepathtracingresearchframework_tpu_torch.models import procedural
from realtimepathtracingresearchframework_tpu_torch.models.camera import (
    OrientedCamera,
)
from realtimepathtracingresearchframework_tpu_torch.models.scene import Scene
from realtimepathtracingresearchframework_tpu_torch.ops.integrator import (
    FrameParams,
    ViewBuffers,
    render_tile,
)
from realtimepathtracingresearchframework_tpu_torch.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
)
from realtimepathtracingresearchframework_tpu_torch.parallel.render_sharded import (
    build_sharded_render,
    build_sharded_render_2d,
)


def _build(width: int, height: int, max_depth: int = 3, device="cuda"):
    """The cornell box on a renderer at width x height on ``device``, its
    camera's view, the frame parameters and the integrator config."""
    r = Renderer(device=device)
    r.initialize(width, height)
    r.set_scene(Scene.from_vkr_scene(procedural.cornell_box()))
    cam = OrientedCamera.look_at([0, 1.0, 3.2], [0, 1.0, 0.0], fovy=50)
    view = ViewBuffers(*(
        torch.from_numpy(np.asarray(a, np.float32)).to(r.device)
        for a in cam.view_basis(width, height)))
    fp = FrameParams(rr_path_depth=2, glossy_only_mode=0, sample_offset=0,
                     shot_offset=0)
    cfg = r._integrator_config(RenderParams(max_path_depth=max_depth))
    return r, cfg, fp, view


def entry(device="cuda"):
    """(fn, example_args): ``fn(fp, view, spp)`` renders ``spp`` samples of
    the 32x32 cornell tile and returns its (32, 32, 4) mean."""
    width = height = 32
    r, cfg, fp, view = _build(width, height, device=device)
    ds = r.device_scene

    def fn(fp, view, spp):
        accum, _rays = render_tile(ds, cfg, fp, view, width, height, spp)
        return accum

    return fn, (fp, view, 1)


def _devices(n_devices: int, device="cuda"):
    """n devices of kind ``device``: cards 0 to n - 1 where there are that
    many, else ``cuda:0`` n times; ``"cpu"`` n times on the CPU."""
    if torch.device(device).type == "cpu":
        return make_mesh(["cpu"] * n_devices)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("dryrun_multichip: no CUDA device")
    return make_mesh([f"cuda:{i}" for i in range(n_devices)]
                     if count >= n_devices else ["cuda:0"] * n_devices)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One sharded render step over ``n_devices`` at tiny shapes (1 spp,
    depth 2): row bands of 2 rows at 16 x 2n, and on an even n a 2 x n/2
    grid of 16 x 2 tiles. Asserts the shapes and rays > 0, prints the
    reference's summary line with the distinct devices, and returns the
    results."""
    devices = _devices(n_devices, device)
    distinct = len(set(devices))
    width, height = 16, 2 * n_devices
    r, cfg, fp, view = _build(width, height, max_depth=2, device=devices[0])
    f = build_sharded_render(devices, cfg, width, height)
    accum, rays = f(r.device_scene, fp, view, 1)
    assert accum.shape == (height, width, 4), accum.shape
    assert rays > 0
    out = {"accum": accum, "rays": rays, "devices": devices}
    if n_devices % 2 == 0:
        rows, cols = 2, n_devices // 2
        w2, h2 = 16 * cols, 2 * rows
        f2 = build_sharded_render_2d(make_mesh_2d(rows, cols, devices), cfg,
                                     w2, h2)
        accum2, rays2 = f2(r.device_scene, fp, view, 1)
        assert accum2.shape == (h2, w2, 4), accum2.shape
        assert rays2 > 0
        out.update(accum2=accum2, rays2=rays2)
    print(
        f"dryrun_multichip: OK on {n_devices} devices ({distinct} distinct: "
        f"{', '.join(str(d) for d in dict.fromkeys(devices))}) — "
        f"accum {tuple(accum.shape)}, {rays} rays, "
        f"mean rgb {float(accum[..., :3].mean()):.4f}"
        + (f"; 2-D mesh {tuple(out['accum2'].shape)} OK"
           if "accum2" in out else ""),
        flush=True,
    )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
