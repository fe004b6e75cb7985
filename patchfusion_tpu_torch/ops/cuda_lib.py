"""Build, load and call the port's CUDA kernel library.

The kernels live in `patchfusion_tpu_torch/csrc/*.cu`. At first use
`build_kernels` compiles each source with its own `nvcc` for sm_90a, all
started together, and links the objects into one shared library with a
plain C interface, cached under `patchfusion_tpu_torch/_build/<hash of the
sources and flags>/`; `load_kernels` loads it with ctypes once per process.
The library links the CUDA driver (`-lcuda`) for the attention kernel's
TMA tensor maps (`cuTensorMapEncodeTiled`).
The helpers below are the argument checks the kernel wrappers
(`ops/fused_head.py`, `ops/vit_attention.py`, `ops/resize.py`) share.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the driver API, for cuTensorMapEncodeTiled
LINK_FLAGS = ("-lcuda",)
LIB_NAME = "libpf_kernels.so"

_lib = None


def _find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built")
    return found


def build_kernels(build_dir: Path = BUILD_DIR, sources=None,
                  defines=()) -> Path:
    """Compile csrc/*.cu (or the named `sources` among them, with `-D`
    `defines`: a timing build) into the shared library under `build_dir`
    (default `_build/`) unless a build of these exact sources and flags
    exists there. Returns the library's path; nvcc's output (with ptxas
    register and shared-memory use per kernel) is kept beside it as
    nvcc.log."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    srcs = sorted(CSRC.glob("*.cu")) if sources is None else \
        [CSRC / name for name in sources]
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(flags + LINK_FLAGS).encode())
    h.update(" ".join(f.name for f in srcs).encode())
    out_dir = Path(build_dir) / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    tag = os.getpid()
    jobs = []
    log = []
    try:
        for src in srcs:
            obj = out_dir / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *flags, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]}: code {proc.returncode}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-4000:])
        tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
        cmd = [nvcc, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs), *LINK_FLAGS]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             check=False)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed with code "
                               f"{res.returncode}:\n{res.stderr[-4000:]}")
        os.replace(tmp, lib)
    finally:
        for _, obj, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            obj.unlink(missing_ok=True)
        (out_dir / "nvcc.log").write_text("\n".join(log))
    return lib


def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_kernels()))
        vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_float)
        lib.pf_logbinomial_depth.argtypes = (
            [vp] * 5 + [i32] * 7 + [i64] * 4 + [f32] * 2
            + [i32, vp, ctypes.POINTER(i32)])
        lib.pf_clb_pt.argtypes = (
            [vp] * 8 + [i32] * 9 + [i64] * 8 + [f32, i32, vp])
        bind_clb_depth(lib)
        lib.pf_vit_attention.argtypes = (
            [vp] * 4 + [i32] * 4 + [i64] * 9 + [f32] + [i32] * 3 + [vp])
        lib.pf_resize.argtypes = (
            [vp] * 2 + [i32] * 8 + [i64] * 4 + [f32] * 2 + [i32] * 2 + [vp])
        for fn in (lib.pf_logbinomial_depth, lib.pf_clb_pt,
                   lib.pf_vit_attention, lib.pf_resize):
            fn.restype = i32
        lib.pf_clb_tc_smem.argtypes = [i32] * 4
        lib.pf_clb_depth_smem.argtypes = [ctypes.POINTER(i32), i32, i32]
        lib.pf_clb_depth_smem.restype = i32
        lib.pf_clb_tc_smem.restype = i64
        _lib = lib
    return _lib


def bind_clb_depth(lib: ctypes.CDLL) -> None:
    """Argument types of pf_clb_logbinomial_depth, in the kernel library
    or a timing build of csrc/clb_depth.cu alone."""
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    lib.pf_clb_logbinomial_depth.argtypes = (
        [vp] * 9 + [i32, ctypes.POINTER(i32)] + [i32] * 9 + [i64] * 12
        + [f32] * 3 + [i32, vp])
    lib.pf_clb_logbinomial_depth.restype = i32


# ---------------------------------------------------------------------------
# argument checks shared by the wrappers
# ---------------------------------------------------------------------------

def on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (the wrappers then run the plain twins), False
    for CUDA tensors; raises for mixed or other devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {dev}")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t "
                           f"{err}")
