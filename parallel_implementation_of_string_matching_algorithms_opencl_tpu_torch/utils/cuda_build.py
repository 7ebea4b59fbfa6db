"""Build the package's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``.  The library lands in ``_build/<hash>/`` beside the package,
keyed by the source text, the shared headers (``csrc/*.cuh``) and the
compiler flags, so an edited source or header rebuilds and an unchanged one
is reused.  ``build_all`` runs one ``nvcc`` per source, all at once.  A
failed build raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("swar", "shift_and", "rk_roll")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC"]

PTR, INT, I64, U32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_uint32)

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels cannot be built"
    )


def library_path(name: str) -> Path:
    """Content-hashed location of ``csrc/<name>.cu``'s shared library; the
    hash covers every ``csrc/*.cuh`` too, since any source may include
    them."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str):
    """Start compiling ``csrc/<name>.cu`` under a temporary name (a
    concurrent or cut-off build never leaves a partial library at the final
    path); returns (process, command, temporary path, final path)."""
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, cmd, tmp, out


def _finish(name: str, proc, cmd, tmp: str, out: Path) -> None:
    """Wait for one build; keep the compiler's output (register and
    shared-memory use per kernel) in ``build.log`` beside the library."""
    try:
        stdout, stderr = proc.communicate()
        (out.parent / "build.log").write_text(" ".join(cmd) + "\n" + stdout
                                              + stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name}.cu (exit {proc.returncode}):\n"
                f"{stderr[-4000:]}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every listed source whose library does not exist yet, one
    ``nvcc`` each, all started together; returns name -> library path."""
    running = [(n, *_start(n)) for n in names if not library_path(n).exists()]
    errors = []
    for name, *job in running:
        try:
            _finish(name, *job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: library_path(n) for n in names}


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists."""
    return build_all((name,))[name]


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use, with
    ``argtypes`` set from ``signatures`` (C entry -> argument types, the
    stream excluded: ``launch`` appends it).  Every entry returns a CUDA
    error code; ``tpm_error_string`` names it."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = [*argtypes, PTR]
            getattr(lib, fn).restype = INT
        lib.tpm_error_string.argtypes = [INT]
        lib.tpm_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def launch(lib: ctypes.CDLL, fn: str, device: torch.device, *args) -> None:
    """Call C entry ``fn`` on ``device``'s current stream (appended as the
    last argument); raise on a refused launch."""
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{fn} failed: CUDA error {err} "
            f"({lib.tpm_error_string(err).decode()})"
        )


def build_log(name: str) -> str:
    """Compiler output of the last build of ``csrc/<name>.cu``."""
    log = library_path(name).parent / "build.log"
    return log.read_text() if log.exists() else ""
