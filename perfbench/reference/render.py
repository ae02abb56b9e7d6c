"""The reference's entry: the display values of a set of pixels after a
number of 1-spp frames, rendered in plain PyTorch from the input scene.

``Reference(vs, ...)`` derives everything from the input scene itself: the
world-space triangles and attributes, the materials, the texture atlas, the
emitters (re-laid in bins of equal power for binned RIS), the sky and its
own BVH. ``pixels(px, py, frames, shot)`` traces every (pixel, frame)
lane, blends each pixel's frames in order as the progressive accumulation
does, and resolves the result to sRGB display values.

``precision="bfloat16"`` is the control: the scene's geometry and shading
attributes are held in bfloat16 (rounded, then computed in float32), the
step below float32 that would tempt a change to the program.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import integrator as integ
from perfbench.reference import lights as lights_mod
from perfbench.reference import nee as nee_mod
from perfbench.reference.camera import OrientedCamera
from perfbench.reference.material import BASE_MATERIAL_NOALPHA, BASE_MATERIAL_THIN
from perfbench.reference.resolve import resolve_channels
from perfbench.reference.scene import load_scene
from perfbench.reference.sky import build_sky
from perfbench.reference.texture_atlas import build_atlas
from perfbench.reference.walk import Walk

BUCKET_COUNT = 16  # RenderBackendOptions.light_sampling_bucket_count
ALBEDO = (0.2, 0.2, 0.2)  # SceneConfig.albedo
PRECISIONS = ("float32", "bfloat16")
LANES_PER_BATCH = 1 << 18

_FLAT_FLOATS = ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                "texel_density", "tangent")


class _White:
    """The 1-texel white texture of a scene without textures."""

    srgb = False
    mips = [np.full((1, 1, 4), 255, np.uint8)]


class Reference:
    def __init__(self, vs, camera: dict, sun: dict, width: int, height: int,
                 max_depth: int, light_selection: str, device,
                 precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        if light_selection not in ("uniform", "ris"):
            raise ValueError(f"light selection {light_selection!r}")
        data = load_scene(vs)
        flat = data.flat
        if precision == "bfloat16":
            for name in _FLAT_FLOATS:
                a = torch.from_numpy(np.ascontiguousarray(getattr(flat, name)))
                setattr(flat, name, a.to(torch.bfloat16).to(torch.float32).numpy())
        mats = data.materials
        tl = lights_mod.collect_emitters(flat, mats)
        bin_size = None
        if light_selection == "ris" and tl.count > 0:
            bin_size = min(BUCKET_COUNT, tl.count)
            tl = lights_mod.equalize_emitter_bins(tl, bin_size)
        num_lights = tl.count
        if num_lights == 0:
            tl = lights_mod.empty_lights()
        atlas = build_atlas(data.textures, device)
        has_textures = atlas is not None
        if atlas is None:
            atlas = build_atlas([_White()], device)
        if any(f & BASE_MATERIAL_THIN for f in data.material_flags):
            raise NotImplementedError("thin transmission is not in the reference")
        if has_textures and any(
                t >= 0 and not (f & BASE_MATERIAL_NOALPHA)
                for t, f in zip(mats.base_color_tex, data.material_flags)):
            raise NotImplementedError("the alpha test is not in the reference")
        self.cfg = integ.Config(
            max_path_depth=int(max_depth),
            light_bin_size=bin_size if bin_size is not None else BUCKET_COUNT,
            use_light_bins=bin_size is not None,
            num_lights=num_lights,
            has_textures=has_textures,
        )
        self.scene = integ.Scene(
            walk=Walk(flat.v0, flat.e1, flat.e2, device),
            attr_packed=integ.pack_attr_table(flat).to(device),
            mat_packed=integ.pack_material_table(mats).to(device),
            lights=nee_mod.light_buffers(tl.v0, tl.v1, tl.v2, tl.radiance, device),
            sky=build_sky(sun["dir"], sun["turbidity"], ALBEDO,
                          has_area_lights=num_lights > 0, device=device),
            atlas=atlas,
        )
        cam = OrientedCamera.look_at(camera["eye"], camera["center"],
                                     fovy=camera["fovy"])
        self.view = integ.View(*(torch.from_numpy(np.asarray(a, np.float32)).to(device)
                                 for a in cam.view_basis(width, height)))
        self.fp = integ.FrameParams()
        self.width, self.height = int(width), int(height)
        self.device = device
        self.closest_rays = 0
        self.shadow_rays = 0

    def pixels(self, px: np.ndarray, py: np.ndarray, frames: int,
               shot: int) -> np.ndarray:
        """(K, 4) display values (sRGB r, g, b, alpha) of pixels (px, py)
        after ``frames`` frames of 1 spp from sample 0, with shot offset
        ``shot``. Counts the rays traced by kind in ``closest_rays`` and
        ``shadow_rays``."""
        k = len(px)
        dev = self.device
        px_t = torch.as_tensor(np.asarray(px), dtype=torch.int32, device=dev)
        py_t = torch.as_tensor(np.asarray(py), dtype=torch.int32, device=dev)
        frame_of_lane = torch.arange(frames, device=dev).repeat_interleave(k)
        samples = [[] for _ in range(4)]
        n = k * frames
        for a in range(0, n, LANES_PER_BATCH):
            sl = slice(a, min(n, a + LANES_PER_BATCH))
            lane = torch.arange(sl.start, sl.stop, device=dev) % k
            out, closest, shadow = integ.trace_samples(
                self.scene, self.cfg, self.fp, self.view, self.width,
                self.height, px_t[lane], py_t[lane], frame_of_lane[sl],
                int(shot) & 0xFFFFFFFF)
            for c in range(4):
                samples[c].append(out[c])
            self.closest_rays += int(closest.sum())
            self.shadow_rays += int(shadow.sum())
        samples = [torch.cat(s).reshape(frames, k) for s in samples]
        acc = tuple(torch.zeros(k, dtype=torch.float32, device=dev)
                    for _ in range(4))
        for f in range(frames):
            integ.blend(acc, tuple(s[f] for s in samples), f)
        disp = resolve_channels(acc, 0.0, -1)
        return torch.stack(disp, dim=-1).cpu().numpy()
