"""The ``rptr.shade`` stage of a bounce as two fused kernels.

``shade_hit`` is everything ``visit_hit`` does after the traversal: the
miss and its sky term (Hosek or Preetham sky, the sun cap and its MIS
weight), the hit attributes from ``attr_packed`` (edges, interpolated and
geometric normals, the approximate solid angle), the material row, the
two-sided flip and ``total_t``, on textured scenes the footprint, the mip
and the three atlas samples (``shade_textures`` at ``aniso_taps == 0``,
normal map included), the emitter's MIS term, ``bounce_count``, ``rays``,
and in the wavefront variant the empty deferred shadow queue. It returns
the updated carry fields and the hit context that NEE and
``shade_scatter`` read.

``shade_scatter`` is the part of ``scatter_tail`` after NEE: the
glossy-only mask, the BSDF sample in the shading frame, termination and
throughput, the footprint's transport, the next ray (the wavefront
variant's origin rule included) and Russian roulette. The RNG draws stay
outside (``pointsets.draw2t`` / ``draw1``, in the integrator's order): both
kernels take the drawn samples as inputs.

The plain versions (``shade_hit_plain``, ``shade_scatter_plain``) are the
eager code, in the kernels' argument layout, and cover every feature; the
kernels (``csrc/shade.cu``) cover the configurations that ``fused`` admits:
not two-level, no thin transmission, no anisotropic taps. The wrappers
(``shade_hit``, ``shade_scatter``) run the plain version on CPU tensors
and launch the kernel on CUDA tensors, with no fallback; ``launches``
counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from realtimepathtracingresearchframework_tpu_torch.ops import nee as nee_mod
from realtimepathtracingresearchframework_tpu_torch.ops import shade_common as sc
from realtimepathtracingresearchframework_tpu_torch.ops import vec3 as v3
from realtimepathtracingresearchframework_tpu_torch.ops.bsdf_gltf import (
    GLTFMaterial,
    sample_gltf_brdf_v,
)
from realtimepathtracingresearchframework_tpu_torch.ops.texture_atlas import (
    sample_atlas,
    sample_atlas_aniso,
)
from realtimepathtracingresearchframework_tpu_torch.ops.vec3 import Vec3
from realtimepathtracingresearchframework_tpu_torch.utils.profiling import span

KERNEL = "shade"
# each kernel's launches in this process (reset with reset_launches)
launches = {"shade_hit": 0, "shade_scatter": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def fused(cfg) -> bool:
    """Whether the kernels implement ``cfg``'s shading: every
    configuration but two-level scenes, thin transmission and anisotropic
    texture taps."""
    return not (cfg.two_level or cfg.thin_transmission or cfg.aniso_taps > 0)


class HitIn(NamedTuple):
    """``shade_hit``'s operands, one (N,) tensor per field."""

    ro: Vec3
    rd: Vec3
    illum: Vec3  # after the traversal (the wavefront's resolved shadows)
    throughput: Vec3
    active: torch.Tensor  # bool
    prev_pdf: torch.Tensor
    bounce_count: torch.Tensor  # int32
    total_t: torch.Tensor
    rays: torch.Tensor  # int32
    hit: tuple  # traverse.Hit, or tlas.TwoLevelHit on two-level scenes
    foot: Optional[tuple] = None  # shade_common.Footprint on textured scenes


class HitOut(NamedTuple):
    """``shade_hit``'s results: the carry's new fields and the hit
    context."""

    illum: Vec3
    active: torch.Tensor
    bounce_count: torch.Tensor
    total_t: torch.Tensor
    rays: torch.Tensor
    pend: Optional[tuple]  # shade_common.PendingNEE (empty) in the
    p: Vec3
    n_sh: Vec3
    gn: Vec3
    w_o: Vec3
    mat: GLTFMaterial


class ScatterIn(NamedTuple):
    """``shade_scatter``'s operands: the carry after NEE, the hit context
    and the bounce's drawn samples."""

    ro: Vec3
    rd: Vec3
    throughput: Vec3
    active: torch.Tensor
    prev_pdf: torch.Tensor
    bounce_count: torch.Tensor
    total_t: torch.Tensor
    foot: Optional[tuple]
    p: Vec3
    n_sh: Vec3
    gn: Vec3
    w_o: Vec3
    mat: GLTFMaterial
    dir_sample: tuple  # (u0, u1)
    lobe_sample: tuple  # (u0, u1)
    rr_sample: torch.Tensor


class ScatterOut(NamedTuple):
    ro: Vec3
    rd: Vec3
    t_min: torch.Tensor
    throughput: Vec3
    active: torch.Tensor
    prev_pdf: torch.Tensor
    foot: Optional[tuple]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def shade_hit_plain(ds, cfg, fp, h: HitIn) -> HitOut:
    """``shade_hit`` in eager PyTorch, for every configuration."""
    ro, rd, active, hit = h.ro, h.rd, h.active, h.hit
    two_level = cfg.two_level
    rays = h.rays + active.to(h.rays.dtype)
    pend = sc.empty_pend(h.prev_pdf) if cfg.wavefront else None
    was_miss = hit.tri < 0

    # ---- miss: sky (pt_megakernel.glsl:480-489)
    sky = sc._sky_illum(ds, rd, h.prev_pdf, cfg)
    illum = v3.where(active & was_miss, h.illum + h.throughput * sky, h.illum)
    active = active & ~was_miss

    # ---- hit attributes (rt/hit.glsl:63-92), row-indexed tables; uv,
    # tangent and texel density only when texturing
    tri = torch.clamp(hit.tri, min=0).to(torch.int64)
    attr_ranges = ([(sc._A_E1, sc._A_MID + 1)] if cfg.has_textures
                   else [(sc._A_E1, sc._A_UV0), (sc._A_MID, sc._A_MID + 1)])
    c = sc._fetch_cols_ranges(ds.attr_packed, tri, attr_ranges)
    e1 = Vec3(c[sc._A_E1], c[sc._A_E1 + 1], c[sc._A_E1 + 2])
    e2 = Vec3(c[sc._A_E2], c[sc._A_E2 + 1], c[sc._A_E2 + 2])
    b1, b2 = hit.u, hit.v
    b0 = 1.0 - b1 - b2
    n0, n1, n2 = sc._A_N0, sc._A_N1, sc._A_N2
    n_sh = Vec3(
        c[n0] * b0 + c[n1] * b1 + c[n2] * b2,
        c[n0 + 1] * b0 + c[n1 + 1] * b1 + c[n2 + 1] * b2,
        c[n0 + 2] * b0 + c[n1 + 2] * b1 + c[n2 + 2] * b2,
    )
    inst = lin = None
    if two_level:
        # object -> world: edges by the instance's linear part A, normals
        # by A^-T (integrator.py:1158-1169)
        inst = torch.clamp(hit.inst, min=0).to(torch.int64)
        lin = ds.tlas.inst_linear[inst]
        lin_it = ds.tlas.inst_inv_t[inst]
        e1 = sc._mat3_apply(lin, e1)
        e2 = sc._mat3_apply(lin, e2)
        n_sh = sc._mat3_apply(lin_it, n_sh)
    gn_raw = v3.cross(e1, e2)
    gn_raw = v3.where(v3.dot(n_sh, gn_raw) < 0.0, -gn_raw, gn_raw)
    gn_len = v3.length(gn_raw)  # 2*area
    gn = gn_raw * (1.0 / torch.clamp(gn_len, min=1e-20))
    # approx solid angle of the hit triangle as seen from the origin
    approx_sa = (
        (0.5 * gn_len)
        * v3.dot(gn, rd).abs()
        / torch.clamp(hit.t * hit.t, min=1e-20)
    )
    n_sh = v3.normalize(n_sh)

    mid = c[sc._A_MID].to(torch.int64)
    if two_level:
        mid = mid + ds.tlas.inst_mat_offset[inst]
    mat_ranges = ([(sc._M_BASE, sc._M_NMTEX + 1)] if cfg.has_textures
                  else [(sc._M_BASE, sc._M_BCTEX)])
    if cfg.thin_transmission:
        mat_ranges = mat_ranges + [(sc._M_CCGLOSS, sc._M_CCGLOSS + 1)]
    mc = sc._fetch_cols_ranges(ds.mat_packed, mid, mat_ranges)
    mat = sc._material_from_cols(mc, thin=cfg.thin_transmission)

    p = ro + rd * hit.t
    w_o = -rd

    # two-sided flip (pt_megakernel.glsl:622-634)
    backface = v3.dot(w_o, gn) < 0.0
    flip = backface & ~mat.onesided
    n_sh = v3.where(flip, -n_sh, n_sh)
    gn = v3.where(flip, -gn, gn)

    total_t = torch.where(active, h.total_t + hit.t, h.total_t)

    if cfg.has_textures:
        mat, n_sh = _shade_textures(ds, cfg, fp, h.foot, c, mc, mat, n_sh, gn,
                                    rd, total_t, inst, lin, b0, b1, b2)

    # ---- emitter hit MIS (shade_base_material.glsl:33-39)
    num_bins = max(cfg.num_lights // max(cfg.light_bin_size, 1), 1)
    emit_intensity = mc[sc._M_EMIT]
    emit_radiance = mat.base_color * emit_intensity
    has_emit = emit_intensity > 0.0
    wpdf_light = (1.0 - ds.sky.sun_radiance[3]) * nee_mod.approx_tri_lights_pdf(
        approx_sa, max(cfg.num_lights, 1), num_bins, cfg.use_light_bins
    )
    w_emit = nee_mod.nee_mis_heuristic(1.0, h.prev_pdf, 1.0, wpdf_light)
    illum = v3.where(
        active & has_emit,
        illum + h.throughput * emit_radiance * w_emit,
        illum,
    )

    bounce_count = torch.where(active, h.bounce_count + 1, h.bounce_count)
    return HitOut(illum=illum, active=active, bounce_count=bounce_count,
                  total_t=total_t, rays=rays, pend=pend, p=p, n_sh=n_sh, gn=gn,
                  w_o=w_o, mat=mat)


def _shade_textures(ds, cfg, fp, foot, c, mc, mat: GLTFMaterial, n_sh: Vec3,
                    gn: Vec3, rd: Vec3, total_t, inst, lin, b0, b1, b2):
    """The texture stage of ``shade_hit`` (rt/material_textures.glsl,
    integrator.py:1205-1318): base colour, specular/roughness and the
    normal map, sampled at the mip of the transported footprint elongated
    along the grazing tangent and scaled by the path length, or with
    ``cfg.aniso_taps`` along the footprint's major axis. Returns (material,
    shading normal)."""
    uv = torch.stack([
        c[sc._A_UV0] * b0 + c[sc._A_UV1] * b1 + c[sc._A_UV2] * b2,
        c[sc._A_UV0 + 1] * b0 + c[sc._A_UV1 + 1] * b1 + c[sc._A_UV2 + 1] * b2,
    ], dim=-1)
    density = c[sc._A_DENS]
    if inst is not None:
        # object-space density scales by 1/|s| in world units
        density = density / torch.clamp(ds.tlas.inst_scale[inst], min=1e-8)
    dpdx, dpdy = sc._footprint_to_dpdxy_v(rd, *foot)
    dt_un = rd - gn * v3.dot(rd, gn)
    cos2 = torch.clamp(1.0 - v3.dot(dt_un, dt_un), min=0.0)
    elong_s = 1.0 / torch.clamp(torch.sqrt(cos2) + cos2, min=1e-6)
    ex = dt_un * elong_s
    dpdx_e = dpdx + ex * v3.dot(dpdx, dt_un)
    dpdy_e = dpdy + ex * v3.dot(dpdy, dt_un)
    footprint_world = (
        torch.maximum(v3.length(dpdx_e), v3.length(dpdy_e)) * total_t)

    if cfg.aniso_taps > 0 and inst is None:
        # the (elongated, path-scaled) footprint vectors projected onto
        # the triangle's uv parametrisation via the edge metric
        e1v = Vec3(c[sc._A_E1], c[sc._A_E1 + 1], c[sc._A_E1 + 2])
        e2v = Vec3(c[sc._A_E2], c[sc._A_E2 + 1], c[sc._A_E2 + 2])
        g11 = v3.dot(e1v, e1v)
        g12 = v3.dot(e1v, e2v)
        g22 = v3.dot(e2v, e2v)
        det = torch.clamp(g11 * g22 - g12 * g12, min=1e-20)
        du1 = c[sc._A_UV1] - c[sc._A_UV0]
        dv1 = c[sc._A_UV1 + 1] - c[sc._A_UV0 + 1]
        du2 = c[sc._A_UV2] - c[sc._A_UV0]
        dv2 = c[sc._A_UV2 + 1] - c[sc._A_UV0 + 1]

        def duv_of(dp):
            w = dp * total_t
            p1 = v3.dot(w, e1v)
            p2 = v3.dot(w, e2v)
            a = (p1 * g22 - p2 * g12) / det
            b = (p2 * g11 - p1 * g12) / det
            return torch.stack([a * du1 + b * du2, a * dv1 + b * dv2], dim=-1)

        duvdx, duvdy = duv_of(dpdx_e), duv_of(dpdy_e)

        def tex_sample(tid):
            return sample_atlas_aniso(ds.atlas, tid, uv, duvdx, duvdy,
                                      taps=int(cfg.aniso_taps))
    else:
        def tex_sample(tid):
            base_w = ds.atlas.desc[torch.clamp(tid, min=0).to(torch.int64),
                                   0, 1].to(torch.float32)
            mip = torch.log2(torch.clamp(footprint_world * density * base_w,
                                         min=1.0))
            return sample_atlas(ds.atlas, tid, uv, mip)

    bc_tid = mc[sc._M_BCTEX].to(torch.int32)
    bc = tex_sample(bc_tid)
    base = v3.where(bc_tid >= 0, Vec3(bc[:, 0], bc[:, 1], bc[:, 2]),
                    mat.base_color)
    mat = mat._replace(base_color=base, transmission_color=base)

    sp_tid = mc[sc._M_SPTEX].to(torch.int32)
    sp = tex_sample(sp_tid)
    has_sp = sp_tid >= 0
    mat = mat._replace(
        roughness=torch.where(has_sp, sp[:, 1], mat.roughness),
        metallic=torch.where(has_sp, sp[:, 2], mat.metallic),
    )

    # normal mapping in the uv tangent frame (pt_megakernel.glsl:636-648)
    nm_tid = mc[sc._M_NMTEX].to(torch.int32)
    nm = tex_sample(nm_tid)
    tn = Vec3(
        (nm[:, 0] * 2.0 - 1.0) * fp.bump_scale,
        (nm[:, 1] * 2.0 - 1.0) * fp.bump_scale,
        nm[:, 2] * 2.0 - 1.0,
    )
    tang = Vec3(c[sc._A_TAN], c[sc._A_TAN + 1], c[sc._A_TAN + 2])
    if inst is not None:
        tang = sc._mat3_apply(lin, tang)
    tang = v3.normalize(tang - n_sh * v3.dot(tang, n_sh))
    hand = c[sc._A_TAN + 3]
    if inst is not None:
        hand = hand * ds.tlas.inst_sign[inst]
    bitan = v3.cross(n_sh, tang) * hand
    n_mapped = v3.normalize(tang * tn.x + bitan * tn.y + n_sh * tn.z)
    ok_nm = (nm_tid >= 0) & (v3.length(tn) > 1e-4)
    return mat, v3.where(ok_nm, n_mapped, n_sh)


def shade_scatter_plain(ds, cfg, fp, s: ScatterIn) -> ScatterOut:
    """``shade_scatter`` in eager PyTorch, for every configuration."""
    active, throughput, mat = s.active, s.throughput, s.mat
    n_sh, gn, w_o = s.n_sh, s.gn, s.w_o
    had_nee = active  # the wavefront's lanes owning a queued shadow ray
    # glossy-only debug mode (shade_base_material.glsl:69-70)
    if fp.glossy_only_mode != 0:
        glossy = (mat.roughness < 0.1) & (mat.ior != 1.0)
        active = active & glossy

    # ---- BSDF sample
    vx, vy = nee_mod.ortho_frame_v(n_sh)
    weight, w_i, _spdf, mis_wpdf = sample_gltf_brdf_v(
        mat, n_sh, w_o, vx, vy, s.dir_sample, s.lobe_sample,
        cfg.has_transmission, cfg.thin_transmission,
    )
    valid_dir = v3.dot(w_i, n_sh) * v3.dot(w_i, gn) > 0.0
    weight_zero = (weight.x == 0.0) & (weight.y == 0.0) & (weight.z == 0.0)
    terminate = (mis_wpdf == 0.0) | weight_zero | ~valid_dir
    keep = active & ~terminate
    throughput = v3.where(keep, throughput * weight, throughput)
    prev_pdf = torch.where(keep, mis_wpdf, s.prev_pdf)
    active = keep

    foot = s.foot
    if cfg.has_textures:
        # transport the texture footprint across the bounce
        # (pt_megakernel.glsl:698-701)
        do_ref = active & (v3.dot(w_i, n_sh) * v3.dot(w_o, n_sh) > -0.999)
        ref = sc._reflect_footprint_v(w_i, s.rd, *foot)
        foot = sc.Footprint(*(torch.where(do_ref, r, f)
                                for r, f in zip(ref, foot)))

    rd = v3.where(active, w_i, s.rd)
    if cfg.wavefront:
        # the next visit's deferred shadow ray starts at THIS hit point,
        # also on lanes whose path just ended
        ro = v3.where(active | had_nee, s.p, s.ro)
    else:
        ro = v3.where(active, s.p, s.ro)
    t_min = (v3.length(ro) + s.total_t) * sc.RAY_EPSILON

    # ---- Russian roulette (pt_megakernel.glsl:713-730)
    prefix = v3.max_component(throughput)
    rr_prob = torch.where(
        s.bounce_count > 6,
        torch.clamp(prefix, max=0.95),
        torch.clamp(prefix, max=1.0),
    )
    do_rr = active & (s.bounce_count >= fp.rr_path_depth)
    survive = s.rr_sample < rr_prob
    throughput = v3.where(
        do_rr & survive,
        throughput * (1.0 / torch.clamp(rr_prob, min=1e-9)),
        throughput,
    )
    active = active & (~do_rr | survive)
    return ScatterOut(ro=ro, rd=rd, t_min=t_min, throughput=throughput,
                      active=active, prev_pdf=prev_pdf, foot=foot)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

# the operand order of csrc/shade.cu's pointer tables (enum HitPtr and enum
# ScatterPtr there): inputs, the scene's tables, outputs
HIT_IN = ("ro.x", "ro.y", "ro.z", "rd.x", "rd.y", "rd.z", "illum.x",
          "illum.y", "illum.z", "throughput.x", "throughput.y",
          "throughput.z", "active", "prev_pdf", "bounce_count", "total_t",
          "rays", "t", "tri", "u", "v", "foot.a", "foot.b", "foot.c")
HIT_TABLES = ("attr", "mat", "perez", "zenith", "sun_dir", "sun_cos",
              "sun_radiance", "scale", "hosek_configs", "hosek_radiances",
              "texels", "desc", "num_mips", "srgb")
HIT_FLOAT_OUT = ("illum.x", "illum.y", "illum.z", "total_t", "p.x", "p.y",
                 "p.z", "n_sh.x", "n_sh.y", "n_sh.z", "gn.x", "gn.y", "gn.z",
                 "w_o.x", "w_o.y", "w_o.z", "base.x", "base.y", "base.z",
                 "metallic", "specular", "roughness", "ior",
                 "specular_transmission", "pend.zero", "pend.one")
HIT_OTHER_OUT = ("active", "bounce_count", "rays", "onesided", "pend.traced")
SCATTER_IN = ("ro.x", "ro.y", "ro.z", "rd.x", "rd.y", "rd.z", "throughput.x",
              "throughput.y", "throughput.z", "active", "prev_pdf",
              "bounce_count", "total_t", "foot.a", "foot.b", "foot.c", "p.x",
              "p.y", "p.z", "n_sh.x", "n_sh.y", "n_sh.z", "gn.x", "gn.y",
              "gn.z", "w_o.x", "w_o.y", "w_o.z", "base.x", "base.y", "base.z",
              "tcolor.x", "tcolor.y", "tcolor.z", "metallic", "roughness",
              "ior", "specular_transmission", "onesided", "dir.0", "dir.1",
              "lobe.0", "rr")
SCATTER_FLOAT_OUT = ("ro.x", "ro.y", "ro.z", "rd.x", "rd.y", "rd.z", "t_min",
                     "throughput.x", "throughput.y", "throughput.z",
                     "prev_pdf", "foot.a", "foot.b", "foot.c")
SCATTER_OTHER_OUT = ("active",)


def _lib():
    from realtimepathtracingresearchframework_tpu_torch.kernels import build

    lib = build.load(KERNEL)
    if not getattr(lib, "_rptr_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rptr_shade_hit.argtypes = [p, i, i, ctypes.c_longlong,
                                       ctypes.c_longlong, i, i, i, i, f, f, p]
        lib.rptr_shade_hit.restype = i
        lib.rptr_shade_scatter.argtypes = [p, i, i, i, i, i, i, i, p]
        lib.rptr_shade_scatter.restype = i
        lib.rptr_shade_error_string.argtypes = [i]
        lib.rptr_shade_error_string.restype = ctypes.c_char_p
        lib.rptr_shade_layout.argtypes = [ctypes.POINTER(ctypes.c_double), i]
        lib.rptr_shade_layout.restype = i
        _check_layout(lib)
        lib._rptr_bound = True
    return lib


def _check_layout(lib) -> None:
    """Raise unless the library was compiled for ``shade_common.LAYOUT``
    (the table columns, the atlas's mip count, the one-sided flag and the
    ray epsilon that csrc/shade.cu hard-codes)."""
    want = list(sc.LAYOUT.values())
    buf = (ctypes.c_double * (len(want) + 1))()
    got = list(buf[:lib.rptr_shade_layout(buf, len(buf))])
    if got != want:
        differ = {k: (g, w) for k, g, w in zip(sc.LAYOUT, got, want) if g != w}
        raise RuntimeError(f"{KERNEL}: csrc/shade.cu is compiled for another "
                           f"table layout: {len(got)} numbers, {len(want)} "
                           f"expected; (kernel, shade_common) {differ}")


def _operand(name, x, dtype, n, dev):
    """``x`` as a contiguous (n,) ``dtype`` tensor on ``dev`` (a broadcast
    operand, such as the camera's origin, is copied once)."""
    if x.device != dev or x.dim() > 1 or (x.dim() == 1 and x.shape[0] != n):
        raise ValueError(f"{KERNEL}: {name}: expected ({n},) on {dev}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if x.dtype != dtype:
        x = x.to(dtype)
    return x.expand(n).contiguous()


def _table(name, x, dtype, dev):
    if x.device != dev or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{KERNEL}: {name}: expected a contiguous {dtype} "
                         f"table on {dev}, got {x.dtype} on {x.device}, "
                         f"contiguous {x.is_contiguous()}")
    return x


def _bound(fn, ptrs, dev, *args):
    """``run()``: one launch through the C entry ``fn`` with the pointer
    table ``ptrs`` on ``dev``'s current stream, uncounted; returns the CUDA
    error code (0 = launched)."""
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)

    def run():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            return fn(arr, len(ptrs), *args, stream)

    return run


def _launch(name, run):
    """Launch a bound kernel and count it. While a profiler records, the
    launch lies in an operator-named span (``rptr::<name>``): in a trace the
    walks stay the only launches outside an operator, which is how the
    benchmark's stage attribution finds their kernels (perfbench/stages.py)."""
    if run is None:
        return
    with span(f"rptr::{name}"):
        rc = run()
    if rc != 0:
        msg = _lib().rptr_shade_error_string(rc).decode()
        raise RuntimeError(f"{KERNEL} {name} launch failed: {msg} (cudaError {rc})")
    launches[name] += 1


def _check_fused(cfg):
    if not fused(cfg):
        raise ValueError(f"{KERNEL}: two-level scenes, thin transmission and "
                         "anisotropic taps take the plain stage (shade.fused)")


def bind_hit(ds, cfg, fp, h: HitIn):
    """Check the operands of one ``shade_hit`` launch on the card, allocate
    its outputs and bind it: (run, HitOut), ``run()`` as ``_bound``'s, None
    when there is no lane."""
    _check_fused(cfg)
    dev = h.active.device
    n = h.active.shape[0]
    f32, i32 = torch.float32, torch.int32
    textured = bool(cfg.has_textures)
    ins = [*h.ro, *h.rd, *h.illum, *h.throughput, h.active, h.prev_pdf,
           h.bounce_count, h.total_t, h.rays, h.hit.t, h.hit.tri, h.hit.u,
           h.hit.v, *(h.foot if textured else (None,) * 3)]
    types = {"active": torch.bool, "bounce_count": i32, "rays": i32,
             "tri": i32}
    ops = [None if x is None else _operand(k, x, types.get(k, f32), n, dev)
           for k, x in zip(HIT_IN, ins)]
    sky, atlas = ds.sky, ds.atlas
    hosek = sky.hosek_configs.shape[0] == 9
    if (ds.attr_packed.shape[0] != sc.ATTR_W or ds.mat_packed.shape[0] != sc.MAT_W
            or (textured and tuple(atlas.desc.shape[1:]) != (sc.MAX_MIPS, 3))):
        raise ValueError(
            f"{KERNEL}: tables of another layout: attributes "
            f"{tuple(ds.attr_packed.shape)}, materials {tuple(ds.mat_packed.shape)}"
            f", atlas descriptor {tuple(atlas.desc.shape) if textured else None}; "
            f"the kernel reads ({sc.ATTR_W}, R), ({sc.MAT_W}, M) and "
            f"(T, {sc.MAX_MIPS}, 3)")
    tables = [ds.attr_packed, ds.mat_packed, sky.perez, sky.zenith,
              sky.sun_dir, sky.sun_cos_angle, sky.sun_radiance, sky.scale,
              sky.hosek_configs, sky.hosek_radiances]
    tables = [_table(k, x, f32, dev) for k, x in zip(HIT_TABLES, tables)]
    if textured:
        tables += [_table("texels", atlas.texels, i32, dev),
                   _table("desc", atlas.desc, i32, dev),
                   _table("num_mips", atlas.num_mips, i32, dev),
                   _table("srgb", atlas.srgb, torch.bool, dev)]
    else:
        tables += [None] * 4
    fout = torch.empty((len(HIT_FLOAT_OUT), n), dtype=f32, device=dev).unbind(0)
    active = torch.empty(n, dtype=torch.bool, device=dev)
    bounce = torch.empty(n, dtype=i32, device=dev)
    rays = torch.empty(n, dtype=i32, device=dev)
    onesided = torch.empty(n, dtype=torch.bool, device=dev)
    traced = torch.empty(n, dtype=torch.bool, device=dev)
    o = dict(zip(HIT_FLOAT_OUT, fout))
    pend = None
    if cfg.wavefront:
        z, one = o["pend.zero"], o["pend.one"]
        pend = sc.PendingNEE(Vec3(z, one, z), z, z, Vec3(z, z, z), traced)
    base = Vec3(o["base.x"], o["base.y"], o["base.z"])
    mat = GLTFMaterial(
        base_color=base, metallic=o["metallic"], specular=o["specular"],
        roughness=o["roughness"], ior=o["ior"],
        specular_transmission=o["specular_transmission"],
        transmission_color=base, onesided=onesided)

    def vec(k):
        return Vec3(o[f"{k}.x"], o[f"{k}.y"], o[f"{k}.z"])

    out = HitOut(illum=vec("illum"), active=active, bounce_count=bounce,
                 total_t=o["total_t"], rays=rays, pend=pend, p=vec("p"),
                 n_sh=vec("n_sh"), gn=vec("gn"), w_o=vec("w_o"), mat=mat)
    if n == 0:
        return None, out
    num_bins = max(cfg.num_lights // max(cfg.light_bin_size, 1), 1)
    n_lights = num_bins if cfg.use_light_bins else max(cfg.num_lights, 1)
    ptrs = [None if x is None else x.data_ptr()
            for x in (*ops, *tables, *fout, active, bounce, rays, onesided,
                      traced)]
    run = _bound(_lib().rptr_shade_hit, ptrs, dev, n, ds.attr_packed.shape[1],
                 ds.mat_packed.shape[1], int(hosek), int(textured),
                 int(bool(cfg.enable_sun_sky)), int(bool(cfg.wavefront)),
                 float(np.float32(fp.bump_scale)), float(np.float32(n_lights)))
    run.keep = (ops, tables)  # the operands live as long as the launch
    return run, out


def shade_hit(ds, cfg, fp, h: HitIn) -> HitOut:
    """``shade_hit_plain`` on CPU tensors; on CUDA tensors one launch of
    csrc/shade.cu's ``shade_hit`` kernel, for a configuration that
    ``fused`` admits."""
    if h.active.device.type != "cuda":
        return shade_hit_plain(ds, cfg, fp, h)
    run, out = bind_hit(ds, cfg, fp, h)
    _launch("shade_hit", run)
    return out


def bind_scatter(ds, cfg, fp, s: ScatterIn):
    """Check the operands of one ``shade_scatter`` launch on the card,
    allocate its outputs and bind it: (run, ScatterOut), as ``bind_hit``."""
    _check_fused(cfg)
    dev = s.active.device
    n = s.active.shape[0]
    f32 = torch.float32
    textured = bool(cfg.has_textures)
    m = s.mat
    ins = [*s.ro, *s.rd, *s.throughput, s.active, s.prev_pdf, s.bounce_count,
           s.total_t, *(s.foot if textured else (None,) * 3), *s.p, *s.n_sh,
           *s.gn, *s.w_o, *m.base_color, *m.transmission_color, m.metallic,
           m.roughness, m.ior, m.specular_transmission, m.onesided,
           s.dir_sample[0], s.dir_sample[1], s.lobe_sample[0], s.rr_sample]
    types = {"active": torch.bool, "onesided": torch.bool,
             "bounce_count": torch.int32}
    ops = [None if x is None else _operand(k, x, types.get(k, f32), n, dev)
           for k, x in zip(SCATTER_IN, ins)]
    fout = torch.empty((len(SCATTER_FLOAT_OUT), n), dtype=f32,
                       device=dev).unbind(0)
    active = torch.empty(n, dtype=torch.bool, device=dev)
    o = dict(zip(SCATTER_FLOAT_OUT, fout))

    def vec(k):
        return Vec3(o[f"{k}.x"], o[f"{k}.y"], o[f"{k}.z"])

    foot = (sc.Footprint(o["foot.a"], o["foot.b"], o["foot.c"])
            if textured else s.foot)
    out = ScatterOut(ro=vec("ro"), rd=vec("rd"), t_min=o["t_min"],
                     throughput=vec("throughput"), active=active,
                     prev_pdf=o["prev_pdf"], foot=foot)
    if n == 0:
        return None, out
    ptrs = [None if x is None else x.data_ptr() for x in (*ops, *fout, active)]
    run = _bound(_lib().rptr_shade_scatter, ptrs, dev, n, int(textured),
                 int(bool(cfg.has_transmission)), int(bool(cfg.wavefront)),
                 int(fp.glossy_only_mode != 0), int(fp.rr_path_depth))
    run.keep = ops
    return run, out


def shade_scatter(ds, cfg, fp, s: ScatterIn) -> ScatterOut:
    """``shade_scatter_plain`` on CPU tensors; on CUDA tensors one launch
    of csrc/shade.cu's ``shade_scatter`` kernel, for a configuration that
    ``fused`` admits."""
    if s.active.device.type != "cuda":
        return shade_scatter_plain(ds, cfg, fp, s)
    run, out = bind_scatter(ds, cfg, fp, s)
    _launch("shade_scatter", run)
    return out


def fields(out, prefix="") -> dict:
    """{name: (N,) tensor} of a stage's results (``HitOut``,
    ``ScatterOut``), nested tuples flattened, None fields left out."""
    found = {}
    for name, x in zip(out._fields, out):
        key = f"{prefix}{name}"
        if isinstance(x, torch.Tensor):
            found[key] = x
        elif x is not None:
            found.update(fields(x, key + "."))
    return found


def differences(a, b) -> dict:
    """{field: (lanes that differ, largest absolute difference)} between
    two results of one stage, bit for bit (a NaN equals only the same
    NaN); fields that agree on every lane are left out."""
    out = {}
    fb = fields(b)
    for name, x in fields(a).items():
        y = fb[name].to(x.device)
        ne = (x.view(torch.int32) != y.view(torch.int32)
              if x.dtype == torch.float32 else x != y)
        lanes = int(ne.sum())
        if lanes:
            diff = (x.double() - y.double()).abs()[ne]
            finite = diff[diff.isfinite()]
            out[name] = (lanes, float(finite.max()) if finite.numel() else
                         float("inf"))
    return out
