"""Build and bind the port's CUDA kernels (``csrc/*.cu``) at first use.

nvcc compiles each source to an object, all sources at once in parallel, and
links them into one shared library with a plain C interface, under
:func:`build_dir` (``build/`` at the repository root in a checkout,
git-ignored; a user cache directory for an installed package).  Each object
is named by a hash of its source, the headers (``csrc/*.cuh``) and the
flags, and the library by the hash of those, so that an edit to one source
rebuilds that source alone and an unchanged tree reuses the library.  ``ctypes`` loads it: every pointer and the stream are passed as
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
import tempfile
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
_ROOT = Path(__file__).resolve().parents[2]  # the repository root in a checkout, site-packages once installed
BUILD_DIR_ENV = "VIT_TORCH_BUILD_DIR"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel
)

_P, _I, _F, _U, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint, ctypes.c_longlong
_S = ctypes.POINTER(ctypes.c_longlong)  # a host array of strides
_PP = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers
# dropout arguments: drop (0/1), seed (the int32 seed's bit pattern), keep
# threshold, 1/(1 - rate)
_DROP = (_I, _U, _U, _F)
_SIGNATURES = {
    # x, w, b, out, rows, dim, eps, stream
    "vit_layernorm_rows": (_P, _P, _P, _P, _I, _I, _F, _P),
    # a, w, bias, res, out, M, N, K, epilogue, rows per image, heads, dropout, stream
    "vit_gemm_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, *_DROP, _P),
    # qkv, out, batch, n, n_keys, heads, dim_head, scale*log2(e), dropout, gamma_q, gamma_k, stream
    "vit_attention_rows": (_P, _P, _I, _I, _I, _I, _I, _F, *_DROP, _P, _P, _P),
    # qkv, dm, m, dqkv, keep scratch, statistics scratch (the wide kernels'), batch, n, heads, dim_head,
    # scale*log2(e), scale, dropout, gamma_q, gamma_k, dgamma partials, dgamma, stream
    "vit_attention_bwd_rows": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, *_DROP, _P, _P, _P, _P, _P),
    # g, gm, rows, n, dim, heads, seed, threshold, 1/(1 - rate), stream
    "vit_dropout_apply": (_P, _P, _L, _I, _I, _I, _U, _U, _F, _P),
    # attn_keep, out_keep, batch, n, dim, heads, seed, threshold, stream
    "vit_dropout_masks": (_P, _P, _I, _I, _I, _I, _U, _U, _P),
    # rows -> rows of the partial-sum scratch buffer
    "vit_layernorm_bwd_blocks": (_I,),
    # x, dh, w, res, dx, partial, sums, rows, dim, eps, stream
    "vit_layernorm_bwd_rows": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    # the [res_f32] variant: x, dh, w, res, res is f32, dx, dx is f32, partial, sums, rows, dim, eps, stream
    "vit_layernorm_bwd_rows_res": (_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _F, _P),
    # the FF backward's gemm_bf16 epilogues: a, w, bias, h1 in, out, h1 out, column partials, column sums,
    # M, N, K, epilogue, stream
    "vit_gemm_ff": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # a, b, out, partial slots, tile counters, M, N, K, blocks, stream-K chunk, stream
    "vit_gemm_wgrad": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # q, k, v, o, lse, q ids, kv ids, gamma_q, gamma_k, bias, bias is bf16, batch, heads, n, m, dim_head,
    # scale, causal, dropout, 21 strides, stream
    "vit_flash_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, *_DROP, _S, _P),
    # q, k, v, dO, lse, delta, q ids, kv ids, gamma_q, gamma_k, dq, batch, heads, n, m, dim_head, scale,
    # causal, dropout, strides, stream
    "vit_flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, *_DROP, _S, _P),
    # ..., gamma_q, gamma_k, dk, dv, batch, heads, n, m, dim_head, scale, causal, dropout, strides, stream
    "vit_flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, *_DROP, _S,
                          _P),
    # q, k, v, o, bias, bias is bf16, its head and row strides, batch, heads, n, m, dim_head, dim_value, scale,
    # 12 strides, stream
    "vit_short_attention": (_P, _P, _P, _P, _P, _I, _L, _L, _I, _I, _I, _I, _I, _I, _F, _S, _P),
    # keep, batch, heads, n, m, seed, threshold, stream
    "vit_flash_dropout_masks": (_P, _I, _I, _I, _I, _U, _U, _P),
    # x, out, layers x 12 weight pointers, layers, scratch h, qkv, m, y, a, barrier, batch, n, dim, heads,
    # dim_head, mlp, scale*log2(e), eps, the tools/ epilogues (0/1), stream
    "vit_stack_layers": (_P, _P, _PP, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P),
}


def build_dir(root: Path = _ROOT) -> Path:
    """Where the library is built: ``$VIT_TORCH_BUILD_DIR`` when set; else
    ``build/`` under ``root`` when ``root`` is a checkout (it holds ``.git``
    or ``pyproject.toml``); else ``vit_pytorch_tpu_torch`` under the user's
    cache directory (``$XDG_CACHE_HOME``, or ``~/.cache``), since an
    installed package's ``root`` is ``site-packages``."""
    override = os.environ.get(BUILD_DIR_ENV)
    if override:
        return Path(override)
    if (root / ".git").exists() or (root / "pyproject.toml").is_file():
        return root / "build"
    cache = os.environ.get("XDG_CACHE_HOME")
    return (Path(cache) if cache else Path.home() / ".cache") / "vit_pytorch_tpu_torch"


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
    """Build (once per source hash) and load the kernel library of
    ``CSRC_DIR``; every wrapper's launch goes through the one it returns."""
    global _library
    if _library is None:
        _library = build_library(CSRC_DIR)
    return _library


def build_library(csrc_dir: Path) -> KernelLibrary:
    """Build (once per source hash) and load the library of the sources in
    ``csrc_dir``: another copy of ``csrc/`` (a mutation check's) shares the
    objects of the sources it leaves unchanged."""
    sources = sorted(csrc_dir.glob("*.cu"))
    headers = hashlib.sha256()
    for hdr in sorted(csrc_dir.glob("*.cuh")):
        headers.update(hdr.name.encode() + hdr.read_bytes())
    headers.update(" ".join(NVCC_FLAGS).encode())
    keys = [hashlib.sha256(headers.digest() + src.name.encode() + src.read_bytes()).hexdigest()[:16]
            for src in sources]
    digest = hashlib.sha256("".join(keys).encode())
    path = build_dir() / f"libvit_kernels_{digest.hexdigest()[:16]}.so"
    seconds, log = None, ""
    if not path.is_file():
        t0 = time.perf_counter()
        log = _build(path, sources, keys)
        seconds = time.perf_counter() - t0
    return KernelLibrary(path, seconds, log)


def _build(path: Path, sources, keys) -> str:
    """nvcc each source whose object is not built yet to an object under
    ``objects/`` (named by the hash of the source, the headers and the
    flags, so an edit to one source rebuilds that source alone), all at
    once, then link them into ``path``; returns nvcc's output."""
    nvcc = _nvcc()
    objdir = path.parent / "objects"
    objdir.mkdir(parents=True, exist_ok=True)
    objects = [objdir / f"{src.stem}-{key}.o" for src, key in zip(sources, keys)]
    with tempfile.TemporaryDirectory(dir=path.parent) as tmpdir:
        todo = [(src, obj, Path(tmpdir) / obj.name) for src, obj in zip(sources, objects) if not obj.is_file()]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, _, tmp in todo
        ]
        outputs = [proc.communicate()[0] for proc in procs]
        log = "".join(outputs)
        if any(proc.returncode for proc in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        for _, obj, tmp in todo:
            os.replace(tmp, obj)
        tmp = Path(tmpdir) / path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log += link.stdout
        if link.returncode:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        os.replace(tmp, path)
    return log
