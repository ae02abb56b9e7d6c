"""Image comparison tool.

Equivalent of the standalone ``util/compare_exr.cpp`` comparator: per-channel
relative error vs a reference image, emits an ``<file>_err.exr`` error image,
and fails when the max relative error exceeds the threshold
(compare_exr.cpp:51-132; default threshold 1e-6 at :83).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np

from realtimepathtracingresearchframework_tpu_torch.utils.image_io import (
    read_exr_rgba,
    read_pfm,
    write_exr_rgba,
)


@dataclass
class CompareResult:
    max_rel_error: float
    mean_rel_error: float
    num_failed: int
    passed: bool


def _load(path) -> np.ndarray:
    if isinstance(path, np.ndarray):
        return path
    if path.endswith(".pfm"):
        return read_pfm(path)
    if path.endswith(".exr"):
        return read_exr_rgba(path)
    raise ValueError(f"unsupported image format: {path}")


def compare_images(
    test_path: str,
    ref_path: str,
    threshold: float = 1e-6,
    write_error_image: bool = True,
) -> CompareResult:
    """Per-channel relative error |t-r| / max(|r|, eps) like compare_exr.cpp:75-97."""
    test = _load(test_path)
    ref = _load(ref_path)
    nchan = min(test.shape[-1], ref.shape[-1], 3)
    test = test[..., :nchan].astype(np.float64)
    ref = ref[..., :nchan].astype(np.float64)
    if test.shape != ref.shape:
        raise ValueError(f"shape mismatch: {test.shape} vs {ref.shape}")

    denom = np.maximum(np.abs(ref), 1e-12)
    rel = np.abs(test - ref) / denom
    failed = rel > threshold

    if write_error_image and isinstance(test_path, str):
        err_img = np.zeros((*rel.shape[:2], 3), np.float32)
        err_img[..., :nchan] = rel.astype(np.float32)
        base, _ = os.path.splitext(test_path)
        write_exr_rgba(base + "_err.exr", err_img, half=False)

    # a PIXEL fails if any of its channels does (the printed count says
    # "pixels"; a raw component sum over-reports by up to nchan)
    failed_px = failed.any(axis=-1) if failed.ndim == 3 else failed
    return CompareResult(
        max_rel_error=float(rel.max()),
        mean_rel_error=float(rel.mean()),
        num_failed=int(failed_px.sum()),
        passed=bool(rel.max() <= threshold),
    )


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("usage: compare_images <test> <reference> [threshold]")
        return 2
    threshold = float(argv[2]) if len(argv) > 2 else 1e-6
    r = compare_images(argv[0], argv[1], threshold)
    print(
        f"max rel error {r.max_rel_error:.3e}, mean {r.mean_rel_error:.3e}, "
        f"{r.num_failed} pixels over threshold {threshold:g}"
    )
    return 0 if r.passed else 1


if __name__ == "__main__":
    raise SystemExit(main())
