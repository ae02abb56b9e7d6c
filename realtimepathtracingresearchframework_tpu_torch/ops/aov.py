"""AOV (arbitrary output variable) rendering: the first-hit channels.

Port of the reference's ``ops/aov.py`` (aov.py:43-142), the analogue of the
reference renderer's ENABLE_AOV_BUFFERS path (pt_megakernel.glsl:482-486,
shade_base_material.glsl:29-31) as one dedicated first-hit pass at sample
0's jitter:

- ALBEDO_ROUGHNESS: rgb = the hit material's base colour, a = roughness
  (0 and 1 on a miss);
- NORMAL_DEPTH: rgb = the interpolated shading normal, normalised (world
  space on two-level scenes), a = hit distance (2e32 on a miss);
- MOTION_JITTER: xy = the hit point's screen motion against the previous
  view in NDC units (2 x the UV delta, 0 on a miss), zw = the subpixel
  jitter in NDC units.

The camera rays go through the scene's route kernel, as the integrator's
closest-hit dispatch sends them (K1, K2, K8, K4, K6 or K7), without the
alpha test, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from realtimepathtracingresearchframework_tpu_torch.ops import integrator as intg
from realtimepathtracingresearchframework_tpu_torch.ops import pointsets
from realtimepathtracingresearchframework_tpu_torch.ops.intersect import T_MAX
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3


class AOVs(NamedTuple):
    albedo_roughness: torch.Tensor  # (H, W, 4)
    normal_depth: torch.Tensor  # (H, W, 4)
    motion_jitter: torch.Tensor  # (H, W, 4)


def _project(view: intg.ViewBuffers, p: Vec3):
    """Screen coordinates of world points: solve rel = a du + b dv + c tl
    for (a, b, c) (aov.py:111-123) with the view's 3x3 basis inverted once,
    and divide by c."""
    m = torch.stack([view.cam_du, view.cam_dv, view.cam_dir_top_left], dim=1)
    inv = torch.linalg.inv(m)
    rel = [p[k] - view.cam_pos[k] for k in range(3)]
    a, b, c = (inv[r, 0] * rel[0] + inv[r, 1] * rel[1] + inv[r, 2] * rel[2]
               for r in range(3))
    return a / c, b / c


def render_aovs(ds: intg.DeviceScene, cfg: intg.IntegratorConfig,
                fp: intg.FrameParams, view: intg.ViewBuffers,
                prev_view: intg.ViewBuffers, width: int, height: int) -> AOVs:
    """First-hit AOV pass over every pixel in row-major order, with the
    jitter of sample ``fp.sample_offset`` (aov.py:49-142)."""
    dev = view.cam_pos.device
    py, px = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    px, py = px.reshape(-1).to(torch.int32), py.reshape(-1).to(torch.int32)
    dims = (float(width), float(height))
    state = pointsets.make_state(cfg.rng_variant, fp.sample_offset,
                                 fp.shot_offset, px, py, width, bufs=ds.rng)
    _, (j0, j1) = pointsets.draw2t(cfg.rng_variant, ds.rng, state, 0)
    ro, rd = intg.camera_rays_v(view, px, py, dims, j0, j1)
    hit = intg._closest_hit_dispatch(ds, cfg, ro, rd, 0.0, T_MAX)
    was_hit = hit.tri >= 0
    tri = torch.clamp(hit.tri, min=0).to(torch.int64)
    c = intg._fetch_cols_ranges(ds.attr_packed, tri,
                                [(intg._A_N0, intg._A_UV0),
                                 (intg._A_MID, intg._A_MID + 1)])
    b1, b2 = hit.u, hit.v
    b0 = 1.0 - b1 - b2
    n_sh = Vec3(*(c[intg._A_N0 + k] * b0 + c[intg._A_N1 + k] * b1
                  + c[intg._A_N2 + k] * b2 for k in range(3)))
    mid = c[intg._A_MID].to(torch.int64)
    if cfg.two_level:
        # object -> world by the instance's A^-T (see visit_hit)
        inst = torch.clamp(hit.inst, min=0).to(torch.int64)
        n_sh = intg._mat3_apply(ds.tlas.inst_inv_t[inst], n_sh)
        mid = mid + ds.tlas.inst_mat_offset[inst].to(torch.int64)
    norm = torch.sqrt(n_sh.x * n_sh.x + n_sh.y * n_sh.y + n_sh.z * n_sh.z)
    n_sh = Vec3(*(x / torch.clamp(norm, min=1e-20) for x in n_sh))
    mc = intg._fetch_cols_ranges(ds.mat_packed, mid,
                                 [(intg._M_BASE, intg._M_ROUGH + 1)])

    def on_hit(x, miss):
        return torch.where(was_hit, x, miss)

    albedo = [on_hit(mc[intg._M_BASE + k], 0.0) for k in range(3)]
    rough = on_hit(mc[intg._M_ROUGH], 1.0)
    normal = [on_hit(x, 0.0) for x in n_sh]
    depth = on_hit(hit.t, T_MAX)
    # motion in NDC units (aov.py:125-132): 2 x the UV delta, as the
    # reference's TAA reprojects with start + 0.5 * motion
    p = Vec3(*(ro[k] + hit.t * rd[k] for k in range(3)))
    now, prev = _project(view, p), _project(prev_view, p)
    motion = [on_hit(2.0 * (b - a), 0.0) for a, b in zip(now, prev)]
    jitter = [(j - 0.5) * 2.0 / d for j, d in zip((j0, j1), dims)]

    def image(chans):
        return torch.stack(chans, dim=-1).reshape(height, width, 4)

    return AOVs(albedo_roughness=image([*albedo, rough]),
                normal_depth=image([*normal, depth]),
                motion_jitter=image([*motion, *jitter]))
