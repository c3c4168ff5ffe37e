"""Token-dataset loader (counterpart of
``neuronx_distributed_tpu/data/loader.py``): ctypes bindings over the port's
native ``nxd_data`` library (``csrc/loader.cpp``), with a bit-identical
numpy fallback.

A flat tokenized corpus (an NXDT file: magic ``NXDT``, version 1, uint16 or
int32 tokens) is chunked into ``seq_len + 1``-token samples, shuffled per
epoch with a seed-deterministic Fisher-Yates (splitmix64, the same in C++
and Python), sharded round-robin over the data-parallel ranks and
prefetched on background threads (native path).  Batches come out as CPU
int32 tensors, ``ids`` and ``labels`` already shifted.

The library is built with ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` at
first use into the package's ``_build/`` (a per-pid temp name and an atomic
rename: several data-parallel processes on one host may race to build it).
Without ``g++`` the numpy fallback runs, says so in a warning, and
:attr:`TokenDataset.is_native` is False.  The loader is host code: it feeds
the device path, it is not on it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import weakref
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_tpu_torch.resilience.faults import fault_point
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

_MAGIC = 0x5444584E  # "NXDT"
_VERSION = 1
_DTYPES = {1: np.uint16, 2: np.int32}
_DTYPE_CODES = {np.dtype(np.uint16): 1, np.dtype(np.int32): 2}

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc", "loader.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libnxd_data.so")

_lib = None
_lib_tried = False


def _build_native() -> Optional[str]:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _CSRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return _LIB_PATH
    except (subprocess.SubprocessError, FileNotFoundError, OSError) as e:
        logger.warning("native data loader build failed (%s); using the "
                       "numpy fallback", e)
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None


def _load_native():
    """Build (once) and load the native library; None if unavailable."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    path = _LIB_PATH
    if not os.path.exists(path) or \
            os.path.getmtime(path) < os.path.getmtime(_CSRC):
        path = _build_native()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        logger.warning("loading the native data loader failed (%s); using "
                       "the numpy fallback", e)
        return None
    c = ctypes
    lib.nxd_open.restype = c.c_void_p
    lib.nxd_open.argtypes = [c.c_char_p]
    lib.nxd_close.argtypes = [c.c_void_p]
    lib.nxd_num_tokens.restype = c.c_uint64
    lib.nxd_num_tokens.argtypes = [c.c_void_p]
    lib.nxd_num_chunks.restype = c.c_uint64
    lib.nxd_num_chunks.argtypes = [c.c_void_p, c.c_uint32]
    lib.nxd_loader_create.restype = c.c_void_p
    lib.nxd_loader_create.argtypes = [
        c.c_void_p, c.c_uint32, c.c_uint32, c.c_uint32, c.c_uint32,
        c.c_uint64, c.c_uint32, c.c_uint32]
    lib.nxd_loader_destroy.argtypes = [c.c_void_p]
    lib.nxd_loader_num_batches.restype = c.c_uint64
    lib.nxd_loader_num_batches.argtypes = [c.c_void_p]
    lib.nxd_loader_set_epoch.argtypes = [c.c_void_p, c.c_uint64, c.c_uint64]
    lib.nxd_loader_next.restype = c.c_int64
    lib.nxd_loader_next.argtypes = [c.c_void_p, c.POINTER(c.c_int32)]
    lib.nxd_pack_assign.restype = c.c_int64
    lib.nxd_pack_assign.argtypes = [
        c.POINTER(c.c_int32), c.c_int64, c.c_int32, c.c_int32,
        c.POINTER(c.c_int32)]
    _lib = lib
    return _lib


def native_pack_assign(lengths: np.ndarray, seq_len: int,
                       window: int) -> Optional[Tuple[np.ndarray, int]]:
    """First-fit row assignment in the native library (``nxd_pack_assign``);
    None ONLY when the native path is unavailable (the caller then runs
    the bit-identical Python loop).  A piece longer than ``seq_len`` raises
    rather than falling back."""
    lib = _load_native()
    if lib is None:
        return None
    lengths = np.ascontiguousarray(lengths, np.int32)
    out = np.empty(len(lengths), np.int32)
    n_rows = lib.nxd_pack_assign(
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(len(lengths)), ctypes.c_int32(int(seq_len)),
        ctypes.c_int32(int(window)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if n_rows < 0:
        raise ValueError(
            f"pack_assign: invalid input (seq_len={seq_len}, window={window}, "
            f"max piece length {int(lengths.max()) if len(lengths) else 0}): "
            "every piece must satisfy 0 <= length <= seq_len")
    return out, int(n_rows)


# -- file format -------------------------------------------------------------


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write a flat token array as an NXDT file (uint16 when the vocab fits,
    int32 otherwise; uint16 and int32 arrays keep their type)."""
    tokens = np.ascontiguousarray(tokens).reshape(-1)
    if tokens.size and tokens.min() < 0:
        raise ValueError("token ids must be non-negative (found negative "
                         "values)")
    if tokens.dtype not in (np.uint16, np.int32):
        tokens = tokens.astype(np.int32 if tokens.max(initial=0) > 65535
                               else np.uint16)
    head32 = np.array([_MAGIC, _VERSION, _DTYPE_CODES[tokens.dtype], 0],
                      np.uint32)
    with open(path, "wb") as f:
        f.write(head32.tobytes())
        f.write(np.uint64(tokens.size).tobytes())
        f.write(tokens.tobytes())


def _read_header(f, path: str) -> Tuple[type, int]:
    head32 = np.frombuffer(f.read(16), np.uint32)
    if len(head32) < 4 or head32[0] != _MAGIC or head32[1] != _VERSION:
        raise ValueError(f"{path} is not an NXDT token file")
    n = int(np.frombuffer(f.read(8), np.uint64)[0])
    return _DTYPES[int(head32[2])], n


def read_token_file(path: str) -> np.ndarray:
    """An NXDT file back as a flat numpy array."""
    with open(path, "rb") as f:
        dtype, n = _read_header(f, path)
        return np.frombuffer(f.read(), dtype, count=n)


# -- the deterministic shuffle shared with C++ --------------------------------

_M64 = (1 << 64) - 1


def _splitmix64(state: int) -> Tuple[int, int]:
    state = (state + 0x9E3779B97F4A7C15) & _M64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31), state


def _shuffled_chunks(total: int, seed: int, epoch: int) -> np.ndarray:
    """The Fisher-Yates of the C++ ``build_order``."""
    order = np.arange(total, dtype=np.uint64)
    state = (seed + 0x51ED2700 * (epoch + 1)) & _M64
    for i in range(total, 1, -1):
        r, state = _splitmix64(state)
        j = r % i
        order[i - 1], order[j] = order[j], order[i - 1]
    return order


class TokenDataset:
    """Handle over an NXDT token file (a native mmap when the library is
    available, else the file read into numpy)."""

    def __init__(self, path: str):
        self.path = path
        self._lib = _load_native()
        self._handle = None
        self._np_tokens = None
        self._loaders: "weakref.WeakSet" = weakref.WeakSet()
        if self._lib is not None:
            self._handle = self._lib.nxd_open(path.encode())
            if not self._handle:
                raise ValueError(f"failed to open token file {path}")
            self.num_tokens = int(self._lib.nxd_num_tokens(self._handle))
        else:
            logger.warning("token dataset %s: the native loader is not "
                           "available, reading with the numpy fallback", path)
            self._np_tokens = read_token_file(path)
            self.num_tokens = int(self._np_tokens.size)

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def num_chunks(self, seq_len: int) -> int:
        if self.num_tokens < seq_len + 1:
            return 0
        return (self.num_tokens - 1) // seq_len

    def max_token_id(self) -> int:
        """The largest token id in the file (one streaming scan of a memory
        map, cached)."""
        if not hasattr(self, "_max_token"):
            if self._np_tokens is not None:
                data = self._np_tokens
            else:
                with open(self.path, "rb") as f:
                    dtype, n = _read_header(f, self.path)
                data = np.memmap(self.path, dtype, mode="r", offset=24,
                                 shape=(n,))
            self._max_token = int(data.max()) if data.size else 0
        return self._max_token

    def validate_vocab(self, vocab_size: int, what: str = "model") -> None:
        """Raise when the file holds ids outside ``[0, vocab_size)``: an
        out-of-range id otherwise trains to a silent NaN loss."""
        if self.max_token_id() >= vocab_size:
            raise ValueError(
                f"data file {self.path} contains token id "
                f"{self.max_token_id()} >= {what} vocab_size {vocab_size}; "
                "rebuild the data or pick a larger-vocab config "
                "(out-of-range ids train to NaN)")

    def close(self):
        if self._handle is not None:
            # the loaders' prefetch threads read the dataset's mmap: destroy
            # them before closing it
            for loader in list(self._loaders):
                loader.close()
            self._lib.nxd_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class TokenDataLoader:
    """Iterates ``{"ids": [B, S], "labels": [B, S]}`` int32 CPU tensors for
    one data-parallel rank.  ``(seed, epoch)`` fixes the order and
    ``set_epoch(epoch, skip_batches=)`` resumes mid-epoch, so a restart
    reads the same batches."""

    def __init__(self, dataset: TokenDataset, batch_size: int, seq_len: int,
                 dp_rank: int = 0, dp_size: int = 1, seed: int = 0,
                 prefetch_depth: int = 4, num_threads: int = 2):
        if dp_rank >= dp_size:
            raise ValueError(f"dp_rank {dp_rank} >= dp_size {dp_size}")
        self.ds = dataset
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.seed = seed
        self.epoch = 0
        self._cursor = 0
        self._loader = None
        if dataset.is_native:
            lib = dataset._lib
            self._loader = lib.nxd_loader_create(
                dataset._handle, batch_size, seq_len, dp_rank, dp_size, seed,
                prefetch_depth, num_threads)
            if not self._loader:
                raise ValueError("native loader creation failed")
            dataset._loaders.add(self)
            self.num_batches = int(lib.nxd_loader_num_batches(self._loader))
        else:
            # the same count on every rank (the smallest share), as the
            # native loader computes it
            total = dataset.num_chunks(seq_len)
            self.num_batches = (total // dp_size) // batch_size

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Reshuffle for ``epoch`` and reset the cursor (both paths are
        single-shot between calls); ``skip_batches`` resumes mid-epoch."""
        self.epoch = epoch
        self._cursor = skip_batches
        if self._loader is not None:
            self.ds._lib.nxd_loader_set_epoch(self._loader, epoch,
                                              skip_batches)

    @staticmethod
    def _batch(rows: np.ndarray) -> dict:
        # copies: the native path reuses ``rows`` for the next batch
        return {"ids": torch.from_numpy(np.array(rows[:, :-1], np.int32)),
                "labels": torch.from_numpy(np.array(rows[:, 1:], np.int32))}

    def _iter_native(self) -> Iterator[dict]:
        lib = self.ds._lib
        out = np.empty((self.batch_size, self.seq_len + 1), np.int32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        while True:
            fault_point("data/next_batch", epoch=self.epoch, rank=self.dp_rank)
            if lib.nxd_loader_next(self._loader, ptr) < 0:
                return
            yield self._batch(out)

    def _iter_numpy(self) -> Iterator[dict]:
        total = self.ds.num_chunks(self.seq_len)
        order = _shuffled_chunks(total, self.seed, self.epoch)
        mine = order[self.dp_rank::self.dp_size][
            :self.num_batches * self.batch_size]
        toks = self.ds._np_tokens
        n = self.seq_len
        while self._cursor < self.num_batches:
            fault_point("data/next_batch", epoch=self.epoch, rank=self.dp_rank)
            b = self._cursor
            self._cursor += 1
            chunk_ids = mine[b * self.batch_size:(b + 1) * self.batch_size]
            yield self._batch(np.stack(
                [toks[int(c) * n:int(c) * n + n + 1] for c in chunk_ids]))

    def __iter__(self) -> Iterator[dict]:
        if self._loader is not None:
            return self._iter_native()
        return self._iter_numpy()

    def __len__(self) -> int:
        return self.num_batches

    def close(self):
        if self._loader is not None:
            self.ds._lib.nxd_loader_destroy(self._loader)
            self._loader = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def step_indexed(loader: TokenDataLoader):
    """``data(step) -> batch`` over ``loader``'s epochs: step ``s`` is batch
    ``s % len(loader)`` of epoch ``s // len(loader)``.  Any jump (a resume,
    a rollback, an epoch boundary) re-seeks by epoch and skip, so the
    order equals an uninterrupted run's (the launchers' facade for
    ``fit``)."""
    n = max(len(loader), 1)
    state = {"iter": None, "expected": None}

    def data(step: int) -> dict:
        if state["expected"] != step:
            loader.set_epoch(step // n, skip_batches=step % n)
            state["iter"] = iter(loader)
        b = next(state["iter"], None)
        if b is None:
            loader.set_epoch(step // n)
            state["iter"] = iter(loader)
            b = next(state["iter"])
        state["expected"] = step + 1
        return b

    return data
