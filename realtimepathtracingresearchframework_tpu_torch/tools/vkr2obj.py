"""Convert a .vks scene to Wavefront .obj (ext/libvkr/scripts/vkr2obj.py
equivalent). Uses the libvkr CPU decode convention (Y/Z swizzle + X
negation, vkr.c:1223-1235) so output matches the reference tool."""

from __future__ import annotations

import sys

import numpy as np

from realtimepathtracingresearchframework_tpu_torch.models import vkr
from realtimepathtracingresearchframework_tpu_torch.models.quantization import (
    dequantize_vertices_libvkr,
    unpack_normal_uv,
)


def convert(vks_path: str, obj_path: str) -> None:
    scene = vkr.open_scene(vks_path, load_textures=False)
    with open(obj_path, "w") as f:
        f.write(f"# exported from {vks_path}\n")
        base = 1
        for mi, mesh in enumerate(scene.meshes):
            f.write(f"o {mesh.name or f'mesh{mi}'}\n")
            v = dequantize_vertices_libvkr(
                mesh.vertices_q, mesh.vertex_scale, mesh.vertex_offset
            )
            n, uv = unpack_normal_uv(mesh.normal_uv_q)
            for p in v:
                f.write(f"v {p[0]:.6g} {p[1]:.6g} {p[2]:.6g}\n")
            for t in uv:
                f.write(f"vt {t[0]:.6g} {t[1]:.6g}\n")
            for p in n:
                f.write(f"vn {p[0]:.6g} {p[1]:.6g} {p[2]:.6g}\n")
            for t in range(mesh.num_triangles):
                i0, i1, i2 = base + 3 * t, base + 3 * t + 1, base + 3 * t + 2
                f.write(
                    f"f {i0}/{i0}/{i0} {i1}/{i1}/{i1} {i2}/{i2}/{i2}\n"
                )
            base += 3 * mesh.num_triangles


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 1:
        print("usage: python -m ...tools.vkr2obj <scene.vks> [out.obj]")
        return 2
    out = argv[1] if len(argv) > 1 else argv[0].rsplit(".", 1)[0] + ".obj"
    convert(argv[0], out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
