"""Print .vkt texture info (ext/libvkr/scripts/vktinfo.py equivalent)."""

from __future__ import annotations

import struct
import sys

from realtimepathtracingresearchframework_tpu_torch.models import texture


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m ...tools.vktinfo <texture.vkt>")
        return 2
    with open(argv[0], "rb") as f:
        header = f.read(32)
    magic, version, mips, w, h, fmt = struct.unpack_from("<iiiiii", header, 0)
    if magic != texture.VKT_MAGIC:
        print(f"{argv[0]}: not a .vkt file")
        return 1
    names = {
        131: "BC1_RGB_UNORM", 132: "BC1_RGB_SRGB", 133: "BC1_RGBA_UNORM",
        134: "BC1_RGBA_SRGB", 137: "BC3_UNORM", 138: "BC3_SRGB",
        141: "BC5_UNORM", 37: "R8G8B8A8_UNORM",
    }
    print(f"version: {version}")
    print(f"size:    {w} x {h}")
    print(f"format:  {names.get(fmt, fmt)}")
    print(f"mips:    {mips}")
    t = texture.read_vkt(argv[0])
    for i, m in enumerate(t.mips):
        print(f"  mip[{i}]: {m.shape[1]} x {m.shape[0]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
