"""Build and bind the port's CUDA kernels (``csrc/*.cu``) at first use.

nvcc compiles the sources into one shared library with a plain C interface,
under ``build/`` at the repository root (git-ignored), named by a hash of the
sources and flags so that an edit rebuilds and an unchanged tree reuses the
library.  ``ctypes`` loads it: every pointer and the stream are passed as
``c_void_p`` and every entry point returns ``cudaGetLastError()``, which
:func:`check` turns into an exception.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, w, b, out, rows, dim, eps, stream
    "vit_layernorm_rows": (_P, _P, _P, _P, _I, _I, _F, _P),
    # a, w, bias, res, out, M, N, K, epilogue, stream
    "vit_gemm_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # qkv, out, batch, n, heads, dim_head, scale*log2(e), stream
    "vit_attention_rows": (_P, _P, _I, _I, _I, _I, _F, _P),
}


class KernelLibrary:
    """The loaded library, with how it was obtained: ``build_seconds`` is the
    nvcc time of this process (``None`` when an existing build was reused)
    and ``build_log`` is nvcc's ptxas report."""

    def __init__(self, path: Path, build_seconds, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib.vit_error_string.argtypes = (ctypes.c_int,)
        self.lib.vit_error_string.restype = ctypes.c_char_p

    def check(self, name: str, err: int) -> None:
        if err:
            msg = self.lib.vit_error_string(err).decode()
            raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


_library: KernelLibrary | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if not nvcc.is_file():
        raise RuntimeError(f"nvcc not found at {nvcc}; set CUDA_HOME to the CUDA toolkit")
    return str(nvcc)


def load_library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _library
    if _library is not None:
        return _library
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"libvit_kernels_{digest.hexdigest()[:16]}.so"
    seconds, log = None, ""
    if not path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    _library = KernelLibrary(path, seconds, log)
    return _library
