"""Build and load the CUDA kernels of `llm_inference_tpu_torch/csrc/`.

At first use every `csrc/*.cu` is compiled by its own `nvcc` process (all
started together) for `sm_90a`, the objects are linked into one shared
library with a plain C interface, and the library is loaded with ctypes.
The library's name carries a hash of the sources, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source is never served by a
stale build. The build directory is
`build/kernels/` at the repository root (listed in .gitignore).

Importing this module builds nothing; `lib()` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# C entry points: (name, argtypes); every one returns an int, cudaError_t
# but for qmm_tiled_route (which K8 kernel a shape takes) and
# decode_attn_tile_slots (the K2/K5/K10 tile for a head size and cache
# kind); layer_tail_plan and qmm4_gemv_plan write K6/K7's and K1 int4
# GEMV's ring plans into an int array
SIGNATURES = {
    "qmm_launch": [_P] * 8 + [_I] * 4 + [_F, _P],
    "qmm4_launch": [_P] * 8 + [_I] * 4 + [_F, _P],
    "qmm4_gemv_plan": [_I] * 5 + [_P],
    "qmm_mma_launch": [_P] * 11 + [_I, _F, _P],
    "qmm_prologue_launch": [_P] * 6 + [_I] * 4 + [_F, _P],
    "qmm_tiled_launch": [_P] * 6 + [_I] * 5 + [_P],
    "qmm_tiled_route": [_I] * 4,
    "layer_tail_launch": [_P] * 13 + [_I] * 7 + [_F, _P],
    "ffn_fused_launch": [_P] * 10 + [_I] * 5 + [_F, _P],
    "layer_tail_plan": [_I] * 9 + [_P],
    "layer_fused_launch": [_P] * 24 + [_I] * 11 + [_F, _F, _P],
    "decode_attn_launch": [_P] * 9 + [_I] * 7 + [_F, _F, _I, _P],
    "decode_attn_tile_slots": [_I, _I],
    "flash_attn_launch": [_P] * 7 + [_I] * 7 + [_F, _F, _I, _P],
    "paged_decode_attn_launch": [_P] * 10 + [_I] * 8 + [_F, _F, _I, _P],
    "paged_flash_attn_launch": [_P] * 8 + [_I] * 8 + [_F, _F, _I, _P],
    "kv_rope_write_launch": [_P] * 11 + [_LL] * 9 + [_I] * 9 + [_P],
    "kv_scale_write_launch": [_P] * 5 + [_I] * 3 + [_P],
}

_lib = None
build_seconds = None   # wall time of the build this process made, if any


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return path


def _build(sources, out: Path) -> None:
    nvcc = _nvcc()
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in sources:
        obj = tmp / (src.stem + ".o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{src.name}:\n{log}")
    if errors:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    so = tmp / out.name
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *map(str, objs),
                           "-o", str(so)], capture_output=True, text=True)
    if link.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    os.replace(so, out)
    shutil.rmtree(tmp, ignore_errors=True)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(CSRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    # the shared headers take part in the hash, not in the source list
    for src in sorted(sources + list(CSRC_DIR.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libllmi_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        t0 = time.perf_counter()
        _build(sources, out)
        build_seconds = time.perf_counter() - t0
    handle = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.kernels_error_string.argtypes = [ctypes.c_int]
    handle.kernels_error_string.restype = ctypes.c_char_p
    _lib = handle
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib().kernels_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
