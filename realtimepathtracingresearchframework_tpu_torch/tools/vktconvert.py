"""Convert a PNG image to .vkt (vkr_convert_texture equivalent,
ext/libvkr/src/vkr.h:439-456): upsample to the next power of two, build the
mip chain, write RGBA8 .vkt."""

from __future__ import annotations

import sys

import numpy as np

from realtimepathtracingresearchframework_tpu_torch.models import texture
from realtimepathtracingresearchframework_tpu_torch.utils.image_io import read_png


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def convert(in_path: str, out_path: str) -> None:
    img = read_png(in_path)
    h, w = img.shape[:2]
    nh, nw = _next_pow2(h), _next_pow2(w)
    if (nh, nw) != (h, w):
        # bilinear upsample to pow2 (the reference uses stb_image_resize)
        yi = np.clip((np.arange(nh) + 0.5) * h / nh - 0.5, 0, h - 1)
        xi = np.clip((np.arange(nw) + 0.5) * w / nw - 0.5, 0, w - 1)
        y0 = np.floor(yi).astype(int); y1 = np.minimum(y0 + 1, h - 1)
        x0 = np.floor(xi).astype(int); x1 = np.minimum(x0 + 1, w - 1)
        fy = (yi - y0)[:, None, None]; fx = (xi - x0)[None, :, None]
        a = img[y0][:, x0].astype(np.float32)
        b = img[y0][:, x1].astype(np.float32)
        c = img[y1][:, x0].astype(np.float32)
        d = img[y1][:, x1].astype(np.float32)
        img = (a*(1-fx)*(1-fy) + b*fx*(1-fy) + c*(1-fx)*fy + d*fx*fy + 0.5).astype(np.uint8)
    texture.write_vkt(out_path, img)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 1:
        print("usage: python -m ...tools.vktconvert <in.png> [out.vkt]")
        return 2
    out = argv[1] if len(argv) > 1 else argv[0].rsplit(".", 1)[0] + ".vkt"
    convert(argv[0], out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
