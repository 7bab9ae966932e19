"""Build and load the package's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds.  The build happens on first use, from the sources in the package
only, into ``pillarnext_tpu_torch/_build/``; a library is named by the hash
of the sources and flags, so an edited source rebuilds.

Nothing here runs at import time: CPU-only installs import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # feats, slot, w0, bn0, w1, bn1, out, n, cap, df, c0, c1, dtype, stream
    "pnx_pfn_two_layer": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # c0, c1, dtype, smem_bytes (out), blocks_per_sm (out)
    "pnx_pfn_launch_shape": (_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)),
    # table, idx, out, m, r, row_bytes, stream
    "pnx_row_gather": (_P, _P, _P, _L, _L, _L, _P),
    # x, seg, out, ent_val, ent_seg, ent_rows, n, c, tile, dtype, op, vb, stream
    "pnx_segscan_tiles": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    # full, ent_rows, out, n, c, tile, dtype, vb, stream
    "pnx_segscan_fill": (_P, _P, _P, _L, _I, _I, _I, _I, _P),
    # dtype, op, vb, threads (out), smem_bytes (out), registers (out), blocks_per_sm (out)
    "pnx_segscan_launch_shape": (_I, _I, _I, *(ctypes.POINTER(_I),) * 4),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library() -> tuple[ctypes.CDLL, dict]:
    """(loaded library, build record).  The record holds the build seconds
    (0 when an up-to-date library was found) and nvcc's register/shared
    memory report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libpnx_kernels_{_digest()}.so"
    record = {"path": str(so), "seconds": 0.0, "ptxas": ""}
    if not so.exists():
        t0 = time.perf_counter()
        # build in a private directory beside the target and rename:
        # concurrent builds never load a half-written library
        tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        try:
            nvcc = _nvcc()
            objs = [tmp / f"{src.stem}.o" for src in _sources()]
            procs = [
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                )
                for src, obj in zip(_sources(), objs)
            ]
            outs = [(p, *p.communicate()) for p in procs]
            for p, out, err in outs:
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({p.returncode}):\n{out}\n{err}")
            lib_tmp = tmp / "lib.so"
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(lib_tmp), *map(str, objs)],
                capture_output=True, text=True,
            )
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
            os.replace(lib_tmp, so)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        record["seconds"] = time.perf_counter() - t0
        record["ptxas"] = "".join(err for _, _, err in outs)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib, record


@functools.cache
def entry(name: str):
    """A C entry point of the library, its argument types set."""
    return getattr(library()[0], name)


def launch(name: str, *args) -> None:
    """Call a kernel's C entry point on the current stream; raise on a
    launch error.  Pointers are passed as Python ints."""
    err = entry(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with error code {err}")


def check_cuda_tensor(t: torch.Tensor, name: str, dtypes=None, ndim=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of an accepted dtype
    and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if dtypes is not None and t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
