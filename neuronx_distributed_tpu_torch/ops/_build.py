"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``_build/`` beside the
package (listed in ``.gitignore``), and loaded with ``ctypes``.  The library
name carries a hash of the source and of the ``csrc`` headers it includes
(followed through headers that include others), so an edited kernel
rebuilds and a stale library is never loaded.
:func:`build_all` starts one ``nvcc`` per source at once.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class FlashParams(ctypes.Structure):
    """Mirror of ``struct FlashParams`` in ``csrc/flash_attention.cu``
    (pointers, then ``(b, h, s)`` element strides, then sizes and
    options); :func:`load` checks its size against the library's."""

    _fields_ = (
        [(n, _P) for n in ("q", "k", "v", "o", "dout", "lse", "delta", "qseg",
                           "kseg", "dq", "dk", "dv")]
        + [(n, ctypes.c_longlong * 3) for n in ("q_st", "k_st", "v_st", "o_st",
                                                "do_st", "dq_st", "dk_st",
                                                "dv_st")]
        + [(n, _I) for n in ("B", "HQ", "HKV", "S", "T", "D")]
        + [("scale", _F), ("softcap", _F)]
        + [(n, _I) for n in ("causal", "window", "dtype")])


# the flash libraries (one per group of head dims) export the same entries
_FLASH_ENTRIES = {
    "flash_attention_fwd": ([ctypes.POINTER(FlashParams), _P], _I),
    "flash_attention_dq": ([ctypes.POINTER(FlashParams), _P], _I),
    "flash_attention_dkv": ([ctypes.POINTER(FlashParams), _P], _I),
    "flash_params_size": ([], _I),
    "flash_wgmma_smem_bytes": ([_I, _I], _I),
}

# C signature of every exported kernel entry, by library name
SIGNATURES = {
    "paged_attention": {
        "paged_attention_fwd": (
            [_I, _I] + [_P] * 14                           # dtype, quant, pointers
            + [_I, _I, _I, _I, _I, _I, _I, _I,             # B S NQ NKV D NP page PP
               _F, _I, _F, _I, _P],                        # scale window cap sk stream
            _I),
        "paged_attention_wgmma_fwd": (
            [_I] + [_P] * 14                               # quant, pointers
            + [_I, _I, _I, _I, _I, _I, _I, _I,             # B S NQ NKV D NP page PP
               _F, _I, _F, _I, _P],                        # scale window cap sk stream
            _I),
        "paged_attention_decode_fwd": (
            [_I] + [_P] * 14                               # quant, pointers
            + [_I, _I, _I, _I, _I, _I, _I, _I,             # B S NQ NKV D NP page PP
               _F, _I, _F, _I, _P],                        # scale window cap sk stream
            _I),
        "paged_wgmma_smem_bytes": ([_I, _I], _I),          # D, quant
        "paged_decode_smem_bytes": ([_I, _I], _I),         # D, quant
        "paged_decode_max_clusters": ([_I, _I, _I, _I], _I),  # D quant G sk
    },
    "flash_attention": _FLASH_ENTRIES,          # head_dim 64 and 128
    "flash_attention_d256": _FLASH_ENTRIES,     # head_dim 256
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report per library (registers, shared memory, spills),
# kept beside the library so that a cached build still has it
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and PATH): the port's CUDA "
        "kernels are built from source at first use")


def _includes(path: str, seen: set) -> bytes:
    """The text of ``path`` and of every ``csrc`` file it includes
    (``#include "..."``), followed transitively, each file once (``seen``
    holds the paths read, so an include cycle ends)."""
    seen.add(path)
    with open(path, "rb") as f:
        text = f.read()
    for inc in re.findall(rb'#include "([^"]+)"', text):
        dep = os.path.join(os.path.dirname(path), inc.decode())
        if dep not in seen:
            text += _includes(dep, seen)
    return text


def _source(name: str, csrc: str = CSRC) -> Tuple[str, str]:
    """The source's path and a hash of it, of the ``csrc`` headers it
    includes (transitively) and of the flags."""
    path = os.path.join(csrc, f"{name}.cu")
    digest = hashlib.sha256(_includes(path, set())
                            + " ".join(NVCC_FLAGS).encode())
    return path, digest.hexdigest()[:16]


def _log_path(lib: str) -> str:
    return lib[:-len(".so")] + ".log"


def _start(name: str):
    """``(library path, running nvcc or None when already built)``."""
    src, digest = _source(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(lib):
        if name not in build_logs and os.path.exists(_log_path(lib)):
            with open(_log_path(lib)) as f:
                build_logs[name] = f.read()
        build_logs.setdefault(name, "(cached build)")
        return lib, None
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return lib, (proc, tmp, src)


def _finish(name: str, lib: str, job) -> str:
    if job is None:
        return lib
    proc, tmp, src = job
    try:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (rc {proc.returncode}):\n{out}")
        with open(_log_path(lib), "w") as f:  # the report of a cached build
            f.write(out.strip())
        os.replace(tmp, lib)  # atomic: a reader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_logs[name] = out.strip()
    return lib


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a library of the same source hash
    exists; returns the library path.  The compiler's report is kept in
    :data:`build_logs`."""
    return _finish(name, *_start(name))


def build_all(names=None) -> Dict[str, str]:
    """Build every library in ``names`` (default: all of
    :data:`SIGNATURES`), one ``nvcc`` per source, all started together;
    returns their paths."""
    names = list(SIGNATURES) if names is None else list(names)
    jobs = {name: _start(name) for name in names}
    return {name: _finish(name, *jobs[name]) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name`` (built on first use), with ``argtypes``
    and ``restype`` set for every entry in :data:`SIGNATURES`."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build(name))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            if "flash_params_size" in SIGNATURES[name] and (
                    lib.flash_params_size() != ctypes.sizeof(FlashParams)):
                raise RuntimeError(
                    f"FlashParams is {ctypes.sizeof(FlashParams)} bytes in "
                    f"Python and {lib.flash_params_size()} in the library")
            _libs[name] = lib
        return _libs[name]
