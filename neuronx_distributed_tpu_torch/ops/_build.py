"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``_build/`` beside the
package (listed in ``.gitignore``), and loaded with ``ctypes``.  The library
name carries a hash of the source and of the ``csrc`` headers it includes
(followed through headers that include others), so an edited kernel
rebuilds and a stale library is never loaded.  A source listed in
:data:`PARTS` is compiled as several objects, one ``nvcc -c`` per part
(a macro on its command line picks the part), which are then linked into
its one library.
:func:`build_all` starts one ``nvcc`` per source, or per part, at once.
Nothing here runs at import time.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# sources compiled in parts, side by side, then linked: the flash
# libraries one part per kernel (FLASH_PART in flash_attention.cuh), since
# cicc runs minutes on one core for the three of them together, and the
# paged library one part per route
_FLASH_PARTS = ("-DFLASH_PART=1", "-DFLASH_PART=2", "-DFLASH_PART=3")
PARTS = {"flash_attention": _FLASH_PARTS,
         "flash_attention_d256": _FLASH_PARTS,
         # one part per route (PAGED_PART in paged_attention.cu)
         "paged_attention": ("-DPAGED_PART=1", "-DPAGED_PART=2",
                             "-DPAGED_PART=3")}

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
    includes (transitively), of the flags and of its parts."""
    path = os.path.join(csrc, f"{name}.cu")
    digest = hashlib.sha256(_includes(path, set())
                            + " ".join(NVCC_FLAGS).encode()
                            + " ".join(PARTS.get(name, ())).encode())
    return path, digest.hexdigest()[:16]


def _log_path(lib: str) -> str:
    return lib[:-len(".so")] + ".log"


def _start(name: str, nice: int = 0):
    """``(library path, running nvcc or None when already built)``; its
    ``nvcc`` run ``nice`` steps below this process's priority."""
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
    parts = PARTS.get(name)
    if parts is None:
        objs = []
        procs = [_nvcc([*NVCC_FLAGS, "-shared", "-o", tmp, src])]
    else:
        objs = [f"{tmp[:-len('.so')]}.part{i}.o" for i in range(len(parts))]
        procs = [_nvcc([*NVCC_FLAGS, "-c", flag, "-o", obj, src])
                 for flag, obj in zip(parts, objs)]
    for p in procs if nice else ():
        try:   # the compilers nvcc starts from here on inherit it
            os.setpriority(os.PRIO_PROCESS, p.pid,
                           os.getpriority(os.PRIO_PROCESS, 0) + nice)
        except OSError:
            pass
    return lib, (procs, objs, tmp, src)


def _nvcc(args) -> subprocess.Popen:
    return subprocess.Popen([find_nvcc(), *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(proc: subprocess.Popen, what: str) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {what} (rc {proc.returncode}):\n{out}")
    return out.strip()


def _discard(job) -> None:
    """Stop a build's ``nvcc`` still running and remove its files."""
    procs, objs, tmp, _ = job
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for path in [tmp, *objs]:
        if os.path.exists(path):
            os.remove(path)


def _finish(name: str, lib: str, job) -> str:
    if job is None:
        return lib
    procs, objs, tmp, src = job
    try:
        parts = PARTS.get(name, (None,))
        outs = [_wait(p, f"{src} {part or ''}".strip())
                for p, part in zip(procs, parts)]
        if objs:
            _wait(_nvcc([*NVCC_FLAGS, "-shared", "-o", tmp, *objs]),
                  f"the link of {name}")
        out = "\n".join(outs)
        with open(_log_path(lib), "w") as f:  # the report of a cached build
            f.write(out)
        os.replace(tmp, lib)  # atomic: a reader never sees a partial file
    finally:   # a failed part's siblings are not left running
        _discard(job)
    build_logs[name] = out
    return lib


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a library of the same source hash
    exists; returns the library path.  The compiler's report is kept in
    :data:`build_logs`."""
    return _finish(name, *_start(name))


def start_all(names=None, background=()) -> Dict[str, tuple]:
    """Start the build of every library in ``names`` (default: all of
    :data:`SIGNATURES`), one ``nvcc`` per source or part, all at once, and
    return at once; :func:`finish_all` waits for them.  The libraries in
    ``background`` build at a lower CPU priority, so the others, and this
    process's own work, come first."""
    names = list(SIGNATURES) if names is None else list(names)
    return {name: _start(name, nice=10 if name in background else 0)
            for name in names}


def finish_all(jobs: Dict[str, tuple], names=None) -> Dict[str, str]:
    """Wait for the builds of ``names`` (default: every one) that
    :func:`start_all` started, removing them from ``jobs``; returns their
    paths.  When one fails, every build left in ``jobs`` is stopped."""
    names = list(jobs) if names is None else list(names)
    try:
        return {name: _finish(name, *jobs.pop(name)) for name in names}
    except BaseException:
        stop_all(jobs)
        raise


def stop_all(jobs: Dict[str, tuple]) -> None:
    """Stop every build still in ``jobs`` and remove its files."""
    for _, job in jobs.values():
        if job is not None:
            _discard(job)
    jobs.clear()


def build_all(names=None) -> Dict[str, str]:
    """Build every library in ``names`` (default: all of
    :data:`SIGNATURES`), one ``nvcc`` per source or part, all started
    together; returns their paths."""
    return finish_all(start_all(names))


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
