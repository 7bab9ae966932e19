"""ctypes bindings for the host geometry library (``core/native/geometry.cpp``).

The port's own copy of pillarnext_tpu/core/native_geometry.py.  The C++
library gives the data pipeline its point-in-rotated-box and BEV quad
collision tests (GT paste), plus exact rotated-overlap / IoU and greedy
rotated-NMS oracles for the tests.

The library is compiled on first use with ``c++ -O3 -std=c++17 -shared
-fPIC`` (``$CXX`` when set) into ``pillarnext_tpu_torch/_build/``, named by
the hash of the source and flags, in a private directory renamed into
place, so concurrent first uses never load a half-written library.  Unlike
the JAX package, a failed build or load raises: the NumPy versions in
``core/box_ops.py`` are the tests' oracles, not a fallback.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "geometry.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler found: put c++ on PATH or set CXX")
    return cxx


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library, compiled first if no up-to-date build exists."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libpnx_geometry_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        try:
            out = tmp / "lib.so"
            proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(out), str(SOURCE)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"building {SOURCE.name} failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(out, so)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    lib = ctypes.CDLL(str(so))

    i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

    lib.pnx_points_in_rbbox.argtypes = [f32p, i64, i64, f32p, i64, i64, u8p]
    lib.pnx_box_collision_test.argtypes = [f32p, i64, f32p, i64, u8p]
    lib.pnx_boxes_overlap_bev.argtypes = [f32p, i64, f32p, i64, f32p]
    lib.pnx_boxes_aligned_iou_bev.argtypes = [f32p, f32p, i64, f32p]
    lib.pnx_rotated_nms.argtypes = [f32p, i64, ctypes.c_float, i64p]
    lib.pnx_rotated_nms.restype = i64
    for name in ("pnx_points_in_rbbox", "pnx_box_collision_test", "pnx_boxes_overlap_bev",
                 "pnx_boxes_aligned_iou_bev"):
        getattr(lib, name).restype = None
    return lib


def points_in_rbbox(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N, M) bool: point i inside rotated 3-D box j (z = box center)."""
    points = np.ascontiguousarray(points, dtype=np.float32)
    boxes = np.ascontiguousarray(boxes, dtype=np.float32)
    n, m = points.shape[0], boxes.shape[0]
    out = np.zeros((n, m), dtype=np.uint8)
    if n and m:
        library().pnx_points_in_rbbox(points, n, points.shape[1], boxes, m, boxes.shape[1], out)
    return out.astype(bool)


def box_collision_test(corners_a: np.ndarray, corners_b: np.ndarray) -> np.ndarray:
    """(N, K) bool BEV collision matrix from (.., 4, 2) corner quads."""
    a = np.ascontiguousarray(corners_a, dtype=np.float32)
    b = np.ascontiguousarray(corners_b, dtype=np.float32)
    n, k = a.shape[0], b.shape[0]
    out = np.zeros((n, k), dtype=np.uint8)
    if n and k:
        library().pnx_box_collision_test(a, n, b, k, out)
    return out.astype(bool)


def boxes_overlap_bev(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Exact (N, M) BEV overlap areas of [x,y,z,dx,dy,dz,yaw] boxes (oracle)."""
    a = np.ascontiguousarray(boxes_a, dtype=np.float32)
    b = np.ascontiguousarray(boxes_b, dtype=np.float32)
    n, m = a.shape[0], b.shape[0]
    out = np.zeros((n, m), dtype=np.float32)
    if n and m:
        library().pnx_boxes_overlap_bev(a, n, b, m, out)
    return out


def boxes_aligned_iou_bev(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Row-aligned exact BEV IoU (N,) (oracle)."""
    a = np.ascontiguousarray(boxes_a, dtype=np.float32)
    b = np.ascontiguousarray(boxes_b, dtype=np.float32)
    out = np.zeros((a.shape[0],), dtype=np.float32)
    if a.shape[0]:
        library().pnx_boxes_aligned_iou_bev(a, b, a.shape[0], out)
    return out


def rotated_nms(boxes: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy rotated-BEV NMS over score-sorted (N, 7) boxes; returns kept
    row indices (oracle for the on-device NMS)."""
    b = np.ascontiguousarray(boxes, dtype=np.float32)
    keep = np.zeros((b.shape[0],), dtype=np.int64)
    cnt = library().pnx_rotated_nms(b, b.shape[0], float(thresh), keep) if b.shape[0] else 0
    return keep[:cnt]
