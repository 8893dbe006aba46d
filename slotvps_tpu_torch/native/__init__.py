"""Native (C++) host-side fusion kernels, loaded via ctypes.

The port's copy of ``slotvps_tpu/native``: the same C++ source and the same
functions.  The host-side fusion hot loops are a small C++ library compiled
on first use with g++ into ``slotvps_tpu_torch/_build/`` (listed in
``.gitignore``); plain C linkage + ctypes, no pybind11.

Falls back silently to the pure-numpy implementations when no compiler is
available (``available()`` reports the state).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    src = osp.join(osp.dirname(__file__), "fusion.cpp")
    cache = osp.join(osp.dirname(osp.dirname(__file__)), "_build")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    lib_path = osp.join(cache, f"libslotvps_fusion_{digest}.so")
    if not osp.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        try:
            os.makedirs(cache, exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 src, "-o", tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib_path)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None

    i64 = ctypes.c_int64
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.unify_pan_result.argtypes = [
        u8p, u8p, i64p, ctypes.c_void_p, i64, i64, i64, i64, i64,
        u8p, u8p, u8p]
    lib.unify_pan_result.restype = None
    lib.region_stats.argtypes = [
        i32p, i64, i64, i64, i32p, i64p, i64p, i64p, i64p, i64p]
    lib.region_stats.restype = i64
    lib.paint_regions.argtypes = [i32p, i64, i64, i32p, u8p, i64, u8p]
    lib.paint_regions.restype = None
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        _LIB = _build_and_load()
    return _LIB


def available() -> bool:
    return _lib() is not None


def unify_frame_native(seg: np.ndarray, pan: np.ndarray,
                       cls_ind: np.ndarray, obj_id: Optional[np.ndarray],
                       stuff_area_limit: int, id_last_stuff: int
                       ) -> Optional[np.ndarray]:
    """Single-frame fusion; returns [H, W, 3] or None if unavailable."""
    lib = _lib()
    if lib is None:
        return None
    seg = np.ascontiguousarray(seg, np.uint8)
    pan = np.ascontiguousarray(pan, np.uint8)
    cls_ind = np.ascontiguousarray(cls_ind, np.int64)
    h, w = seg.shape
    out = np.zeros((3, h, w), np.uint8)
    if obj_id is not None:
        obj_arr = np.ascontiguousarray(obj_id, np.int64)
        obj_ptr = obj_arr.ctypes.data_as(ctypes.c_void_p)
    else:
        obj_ptr = None
    lib.unify_pan_result(
        seg, pan, cls_ind, obj_ptr, len(cls_ind), h, w,
        id_last_stuff, stuff_area_limit, out[0], out[1], out[2])
    return np.stack([out[0], out[1], out[2]], axis=-1)


def region_stats_native(keys: np.ndarray, max_keys: int = 2048):
    """One-pass unique/count/bbox of an int32 key map.

    Returns (keys [n], counts [n], bboxes [n, 4] as x0 y0 x1 y1) or None."""
    lib = _lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.int32)
    h, w = keys.shape
    out_keys = np.zeros(max_keys, np.int32)
    cnt = np.zeros(max_keys, np.int64)
    x0 = np.zeros(max_keys, np.int64)
    y0 = np.zeros(max_keys, np.int64)
    x1 = np.zeros(max_keys, np.int64)
    y1 = np.zeros(max_keys, np.int64)
    n = lib.region_stats(keys, h, w, max_keys, out_keys, cnt, x0, y0, x1, y1)
    if n < 0:
        return None
    order = np.argsort(out_keys[:n], kind="stable")
    bboxes = np.stack([x0[:n], y0[:n], x1[:n], y1[:n]], axis=1)[order]
    return out_keys[:n][order], cnt[:n][order], bboxes


def paint_regions_native(keys: np.ndarray, lut_keys: np.ndarray,
                         lut_rgb: np.ndarray) -> Optional[np.ndarray]:
    """[H, W] int32 keys + (key -> rgb) LUT -> [H, W, 3] uint8, or None."""
    lib = _lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.int32)
    lut_keys = np.ascontiguousarray(lut_keys, np.int32)
    lut_rgb = np.ascontiguousarray(lut_rgb, np.uint8)
    h, w = keys.shape
    out = np.zeros((h, w, 3), np.uint8)
    lib.paint_regions(keys, h, w, lut_keys, lut_rgb, len(lut_keys), out)
    return out
