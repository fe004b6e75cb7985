"""ctypes bindings for the native host-IO library (native/pf_io.cc; the
port's counterpart of patchfusion_tpu/data/native.py).

At first use the repository's `native/pf_io.cc` is compiled with g++ (`$CXX`
where set) into `patchfusion_tpu_torch/_build/libpfio-<hash of the source
and flags>.so`. Where it cannot be built or loaded, or `PF_DISABLE_NATIVE` is
set, every helper falls back to numpy; `backend()` says which of the two
runs. The dataset code calls these helpers unconditionally.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "pf_io.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-shared")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Path:
    """Compile native/pf_io.cc unless a build of this source and these
    flags exists; returns the library's path."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    lib = BUILD_DIR / f"libpfio-{h.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o",
                        str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PF_DISABLE_NATIVE"):
            return None
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError):
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64
        lib.pf_load_raw_bgr.restype = ctypes.c_int
        lib.pf_load_raw_bgr.argtypes = [ctypes.c_char_p, f32p, i64, i64]
        lib.pf_decode_bgr_u8.restype = None
        lib.pf_decode_bgr_u8.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                         f32p, i64, i64]
        lib.pf_resize_bilinear_ac.restype = None
        lib.pf_resize_bilinear_ac.argtypes = [f32p, f32p] + [i64] * 5
        _lib = lib
        return _lib


def backend() -> str:
    """'native' where the library is built and loaded, else 'numpy'."""
    return "native" if _load() is not None else "numpy"


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_raw_bgr(path: str, h: int = 2160, w: int = 3840) -> np.ndarray:
    """.raw uint8 BGR file -> float32 RGB HWC in [0, 1]."""
    lib = _load()
    if lib is not None:
        out = np.empty((h, w, 3), np.float32)
        if lib.pf_load_raw_bgr(path.encode(), _fptr(out), h, w) == 0:
            return out
    img = np.fromfile(path, dtype=np.uint8).reshape(h, w, 3)
    return img.astype(np.float32)[:, :, ::-1] / 255.0


def decode_bgr_u8(buf: np.ndarray) -> np.ndarray:
    """uint8 HWC BGR -> float32 RGB in [0, 1]."""
    lib = _load()
    h, w, _ = buf.shape
    if lib is not None and buf.flags["C_CONTIGUOUS"]:
        out = np.empty((h, w, 3), np.float32)
        lib.pf_decode_bgr_u8(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _fptr(out), h, w)
        return out
    return buf.astype(np.float32)[:, :, ::-1] / 255.0


def resize_bilinear_ac(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """float32 HWC (or HW) bilinear align_corners=True resize."""
    lib = _load()
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    if (h, w) == (oh, ow):
        out = img.astype(np.float32)
        return out[..., 0] if squeeze else out
    if lib is not None:
        src = np.ascontiguousarray(img, np.float32)
        out = np.empty((oh, ow, c), np.float32)
        lib.pf_resize_bilinear_ac(_fptr(src), _fptr(out), h, w, c, oh, ow)
        return out[..., 0] if squeeze else out
    from patchfusion_tpu_torch.ops.resize import resize_matrix
    wh = resize_matrix(oh, h, "bilinear", align_corners=True)
    ww = resize_matrix(ow, w, "bilinear", align_corners=True)
    out = np.einsum("ph,hwc,qw->pqc", wh, img.astype(np.float32), ww)
    return out[..., 0] if squeeze else out

