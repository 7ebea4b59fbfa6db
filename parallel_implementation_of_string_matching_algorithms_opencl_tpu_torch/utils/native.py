"""ctypes binding to the repo's native host library
(``native/tpumatch_native.cpp``): the serial C baselines, the table
precompute, the corpus generators and the mmap chunk reader.

The port's own copy of the JAX package's ``utils/native.py`` (importing
that module would import jax through its package ``__init__``): the same
library, built on demand with ``make -C native``, and the same functions
with the same results.  Nothing on the matching path needs it: it is the
serial CPU baseline and a second oracle.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libtpumatch_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    """``make -C native`` into a file of this process's own, renamed over
    the library when done, so that another process never loads a library
    that is still being written."""
    tmp = f"libtpumatch_native.so.{os.getpid()}.tmp"
    try:
        r = subprocess.run(
            ["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"],
            capture_output=True,
            text=True,
            timeout=120,
        )
        if r.returncode == 0:
            os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)
        return r.returncode == 0
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(os.path.join(_NATIVE_DIR, tmp)):
            os.unlink(os.path.join(_NATIVE_DIR, tmp))


def _declare(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    for name in ("tm_serial_naive", "tm_serial_kmp", "tm_serial_bm"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64, i64p, ctypes.c_int64]
    lib.tm_serial_rk.restype = ctypes.c_int64
    lib.tm_serial_rk.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64,
                                 ctypes.c_uint32, i64p, ctypes.c_int64]
    lib.tm_kmp_failure.restype = None
    lib.tm_kmp_failure.argtypes = [u8p, ctypes.c_int64, i32p]
    lib.tm_bm_bad_char.restype = None
    lib.tm_bm_bad_char.argtypes = [u8p, ctypes.c_int64, i32p]
    lib.tm_bm_good_suffix.restype = None
    lib.tm_bm_good_suffix.argtypes = [u8p, ctypes.c_int64, i32p]
    lib.tm_rk_powers.restype = None
    lib.tm_rk_powers.argtypes = [ctypes.c_int64, ctypes.c_uint32, u32p]
    lib.tm_gen_bytes.restype = None
    lib.tm_gen_bytes.argtypes = [ctypes.c_uint64, u8p, ctypes.c_int64]
    lib.tm_gen_alphabet.restype = None
    lib.tm_gen_alphabet.argtypes = [ctypes.c_uint64, u8p, ctypes.c_int32,
                                    u8p, ctypes.c_int64]
    lib.tm_open.restype = ctypes.c_void_p
    lib.tm_open.argtypes = [ctypes.c_char_p]
    lib.tm_size.restype = ctypes.c_int64
    lib.tm_size.argtypes = [ctypes.c_void_p]
    lib.tm_read_chunk.restype = ctypes.c_int64
    lib.tm_read_chunk.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int64, u8p]
    lib.tm_close.restype = None
    lib.tm_close.argtypes = [ctypes.c_void_p]


def load():
    """Return the loaded library, building it if needed; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        # Rebuild when missing or older than the source (the .so is not
        # version-controlled).
        src = os.path.join(_NATIVE_DIR, "tpumatch_native.cpp")
        stale = not os.path.exists(_LIB_PATH) or (
            os.path.exists(src)
            and os.path.getmtime(_LIB_PATH) < os.path.getmtime(src)
        )
        if stale and not _build() and not os.path.exists(_LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            # Another process may have been writing the library in place:
            # build a whole one of our own and try once more.
            if not _build():
                return None
            try:
                lib = ctypes.CDLL(_LIB_PATH)
            except OSError:
                return None
        _declare(lib)
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _u8(a: np.ndarray):
    if a.dtype != np.uint8 or not a.flags.c_contiguous:
        raise ValueError(f"expected a contiguous uint8 array, got {a.dtype}")
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _need():
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


# -- serial baselines (second oracle / speedup denominator) ----------------

_SERIAL = {"naive": "tm_serial_naive", "kmp": "tm_serial_kmp", "boyer_moore": "tm_serial_bm"}


def serial_match(text: bytes, pattern: bytes, algo: str = "naive",
                 cap: int = 1 << 20, rk_base: int = 0x01000193):
    """(count, offsets ndarray) from the native serial implementation."""
    lib = _need()
    t = np.frombuffer(text, np.uint8)
    p = np.frombuffer(pattern, np.uint8)
    out = np.empty(cap, np.int64)
    op = out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    if algo in ("rk", "rabin_karp"):
        cnt = lib.tm_serial_rk(_u8(t), len(t), _u8(p), len(p),
                               ctypes.c_uint32(rk_base), op, cap)
    else:
        key = _SERIAL.get({"bm": "boyer_moore"}.get(algo, algo))
        if key is None:
            raise KeyError(algo)
        cnt = getattr(lib, key)(_u8(t), len(t), _u8(p), len(p), op, cap)
    return int(cnt), out[: min(cnt, cap)].copy()


# -- native table precompute ------------------------------------------------

def kmp_failure(pattern: np.ndarray) -> np.ndarray:
    out = np.empty(len(pattern), np.int32)
    _need().tm_kmp_failure(_u8(pattern), len(pattern),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def bm_bad_char(pattern: np.ndarray) -> np.ndarray:
    out = np.empty(256, np.int32)
    _need().tm_bm_bad_char(_u8(pattern), len(pattern),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def bm_good_suffix(pattern: np.ndarray) -> np.ndarray:
    out = np.empty(len(pattern) + 1, np.int32)
    _need().tm_bm_good_suffix(_u8(pattern), len(pattern),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def rk_powers(m: int, base: int) -> np.ndarray:
    out = np.empty(m, np.uint32)
    _need().tm_rk_powers(m, ctypes.c_uint32(base),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


# -- fast corpus generation -------------------------------------------------

def gen_bytes(n: int, seed: int = 0) -> np.ndarray:
    out = np.empty(n, np.uint8)
    _need().tm_gen_bytes(ctypes.c_uint64(seed), _u8(out), n)
    return out


def gen_alphabet(n: int, alphabet: bytes, seed: int = 0) -> np.ndarray:
    alph = np.frombuffer(alphabet, np.uint8)
    out = np.empty(n, np.uint8)
    _need().tm_gen_alphabet(ctypes.c_uint64(seed), _u8(alph), len(alph), _u8(out), n)
    return out


# -- mmap chunk reader ------------------------------------------------------

class NativeFile:
    """Sequential-readahead chunk reader over the native mmap handle."""

    def __init__(self, path: str):
        self._lib = _need()
        self._h = self._lib.tm_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"tm_open failed for {path}")
        self.size = self._lib.tm_size(self._h)

    def read_chunk(self, offset: int, length: int, out: np.ndarray | None = None):
        """uint8[length] with bytes [offset, offset+length), zero-padded past
        EOF; returns (array, bytes_read).  ``out`` may be any contiguous
        uint8 array of at least ``length`` bytes, such as the numpy view of
        a pinned ``torch.uint8`` tensor, which is then ready to copy to the
        card."""
        if out is None:
            out = np.empty(length, np.uint8)
        elif len(out) < length:
            raise ValueError(f"out holds {len(out)} bytes, {length} asked for")
        got = self._lib.tm_read_chunk(self._h, offset, length, _u8(out))
        return out, int(got)

    def close(self):
        if self._h:
            self._lib.tm_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
