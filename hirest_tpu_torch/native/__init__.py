"""ctypes bindings for the native feature-packing library.

An own copy of hirest_tpu/native for the port, built into this package's
own untracked build/ directory.

Builds `libfeatpack.so` on first use (g++, see Makefile) and exposes the
batch-packing / warping / trimming primitives. Every entry point has a
NumPy fallback (the pure-Python timeline library), so the framework works
without a compiler; the native path removes per-example Python loops from
the input pipeline hot path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
# builds land in the untracked build/ dir; no .so is committed
_BUILD_PATH = os.path.join(_DIR, "build", "libfeatpack.so")
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    try:
        # make no-ops when build/libfeatpack.so is newer than featpack.cpp
        subprocess.run(["make", "-C", _DIR], check=True, capture_output=True)
        path = _BUILD_PATH
    except (subprocess.CalledProcessError, FileNotFoundError):
        path = _BUILD_PATH
        if not os.path.exists(path):
            _build_failed = True
            print("featpack native build failed; using NumPy fallback")
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        _build_failed = True
        print(f"featpack load failed ({e}); using NumPy fallback")
        return None

    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)

    lib.resample_rows.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64,
                                  ctypes.c_int64]
    lib.pack_batch.argtypes = [ctypes.POINTER(f32p), i64p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                               f32p]
    lib.pack_batch.restype = ctypes.c_int64
    lib.warp_segments.argtypes = [f32p, i64p, i64p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64, f32p]
    lib.trim_to_moment.argtypes = [f32p, i32p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, f32p, f32p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def pack_batch(features: Sequence[np.ndarray], bucket: int,
               n_model_frames: int = -1) -> np.ndarray:
    """Stack variable-length [T_i, D] float32 features into a zero-padded
    [B, bucket, D] batch, resampling to n_model_frames when > 0."""
    lib = _load()
    dim = features[0].shape[1]
    batch = len(features)
    out = np.empty((batch, bucket, dim), dtype=np.float32)

    if lib is None:
        from hirest_tpu_torch.timeline import resample_frames

        out[:] = 0
        for i, f in enumerate(features):
            f = np.ascontiguousarray(f, dtype=np.float32)
            if n_model_frames > 0:
                # native resamples the WHOLE timeline to the bucket-capped
                # count (featpack.cpp pack_batch) — truncating after a
                # full resample would keep only the first part of the video
                f = resample_frames(f, min(n_model_frames, bucket))
            n = min(f.shape[0], bucket)
            out[i, :n] = f[:n]
        return out

    arrs = [np.ascontiguousarray(f, dtype=np.float32) for f in features]
    ptrs = (ctypes.POINTER(ctypes.c_float) * batch)(*[_fp(a) for a in arrs])
    lens = np.array([a.shape[0] for a in arrs], dtype=np.int64)
    lib.pack_batch(ptrs, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                   batch, dim, bucket, n_model_frames, _fp(out))
    return out


def warp_segments(seg_feats: np.ndarray, bounds: Sequence, n_frames: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        from hirest_tpu_torch.timeline import warp_segments as np_warp

        return np_warp(seg_feats, list(bounds), n_frames)
    seg_feats = np.ascontiguousarray(seg_feats, dtype=np.float32)
    n_segs, dim = seg_feats.shape
    starts = np.array([b[0] for b in bounds], dtype=np.int64)
    ends = np.array([b[1] for b in bounds], dtype=np.int64)
    out = np.empty((n_frames, dim), dtype=np.float32)
    lib.warp_segments(_fp(seg_feats),
                      starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                      ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                      n_segs, dim, n_frames, _fp(out))
    return out


def trim_to_moment(feats: np.ndarray, mask: np.ndarray, target: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        from hirest_tpu_torch.timeline import trim_to_moment as np_trim

        if not np.any(mask):
            # match the native path: an all-zero mask yields (target, dim)
            # zeros, not a (0, dim) array that breaks downstream stacking
            return np.zeros((target, feats.shape[1]), dtype=np.float32)
        return np_trim(feats, mask, target)
    feats = np.ascontiguousarray(feats, dtype=np.float32)
    mask = np.ascontiguousarray(mask, dtype=np.int32)
    t, dim = feats.shape
    scratch = np.empty((t, dim), dtype=np.float32)
    out = np.zeros((target, dim), dtype=np.float32)
    lib.trim_to_moment(_fp(feats),
                       mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                       t, dim, target, _fp(scratch), _fp(out))
    return out
