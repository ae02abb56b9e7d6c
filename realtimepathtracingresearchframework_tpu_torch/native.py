"""ctypes bindings for the native host decoders (native/vkr_decode.cpp).

The reference keeps hot host paths native (libvkr's C decoders,
mmapped BCn reads); this module exposes the equivalent C++ library. Every
entry point has a numpy fallback in models/quantization.py /
models/texture.py — the library accelerates scene load, it never changes
results (tests assert bit-equality).

Build: ``cmake -S native -B native/build -G Ninja && cmake --build native/build``
Disable: ``RPTR_NO_NATIVE=1``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_checked = False


def _find_library() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    candidates = [
        os.path.join(here, "native", "build", "librptr_native.so"),
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "librptr_native.so"),
    ]
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _checked
    if _checked:
        return _lib
    _checked = True
    if os.environ.get("RPTR_NO_NATIVE"):
        return None
    path = _find_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.rptr_dequantize_vertices.argtypes = [u64p, ctypes.c_int64, f32p, f32p, f32p]
        lib.rptr_dequantize_normal_uv.argtypes = [u64p, ctypes.c_int64, f32p, f32p]
        lib.rptr_dequantize_transforms.argtypes = [u8p, ctypes.c_int64, f32p]
        lib.rptr_decode_bc1.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
        ]
        lib.rptr_decode_bc3.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
        lib.rptr_decode_bc5.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
        lib.rptr_native_version.restype = ctypes.c_int
        assert lib.rptr_native_version() == 1
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None


def dequantize_vertices(vq: np.ndarray, scale, offset) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    vq = np.ascontiguousarray(vq, np.uint64)
    out = np.empty((len(vq), 3), np.float32)
    lib.rptr_dequantize_vertices(
        vq, len(vq),
        np.ascontiguousarray(scale, np.float32),
        np.ascontiguousarray(offset, np.float32),
        out,
    )
    return out


def dequantize_normal_uv(nq: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    nq = np.ascontiguousarray(nq, np.uint64)
    n = np.empty((len(nq), 3), np.float32)
    uv = np.empty((len(nq), 2), np.float32)
    lib.rptr_dequantize_normal_uv(nq, len(nq), n, uv)
    return n, uv


def dequantize_transforms(blob: np.ndarray) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    blob = np.ascontiguousarray(blob, np.uint8).reshape(-1, 24)
    out = np.empty((len(blob), 3, 4), np.float32)
    lib.rptr_dequantize_transforms(blob.reshape(-1), len(blob), out.reshape(-1))
    return out


def decode_bc1(data: bytes, width: int, height: int, opaque: bool):
    lib = get_lib()
    if lib is None:
        return None
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, width, 4), np.uint8)
    lib.rptr_decode_bc1(src, width, height, int(opaque), out.reshape(-1))
    return out


def decode_bc3(data: bytes, width: int, height: int):
    lib = get_lib()
    if lib is None:
        return None
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, width, 4), np.uint8)
    lib.rptr_decode_bc3(src, width, height, out.reshape(-1))
    return out


def decode_bc5(data: bytes, width: int, height: int):
    lib = get_lib()
    if lib is None:
        return None
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, width, 4), np.uint8)
    lib.rptr_decode_bc5(src, width, height, out.reshape(-1))
    return out
