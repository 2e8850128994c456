"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and bind them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use into its own shared library,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

under ``kernels/build/`` (listed in ``.gitignore``), keyed by a hash of
the sources (with every ``csrc/*.cuh`` header) and the flags, then loaded
with ``ctypes``. The libraries link against the CUDA runtime alone: the
flash kernels' TMA maps come from ``cuTensorMapEncodeTiled``, a libcuda
function, reached through ``cudaGetDriverEntryPoint`` (no ``-lcuda``), and
no source includes CUTLASS. Nothing is built when a module is imported.
``build`` starts one ``nvcc`` per source, all together, and waits for
them all. A failed compile, and a launch that
returns a non-zero ``cudaError_t``, raise.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build", "kernel_function", "on_device",
           "build_logs"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SOURCES = tuple(sorted(p.stem for p in _CSRC.glob("*.cu")))

# compiler output of each source built by this process (ptxas registers,
# shared memory and spills, from -Xptxas -v)
build_logs: dict[str, str] = {}
_libs: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels are built only where the CUDA "
                           "toolkit is installed")
    return str(path)


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    h.update((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return _BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> None:
    """Compile every named source that is not built yet, in parallel."""
    unknown = sorted(set(names) - set(SOURCES))
    if unknown:
        raise ValueError(f"no CUDA source for {unknown}; have {SOURCES}")
    pending = [n for n in names if not _target(n).exists()]
    if not pending:
        return
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in pending:
        out = _target(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, out, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


# the devices whose context each thread has made current
_current = threading.local()


@contextlib.contextmanager
def on_device(device):
    """Launch kernels on ``device`` from this thread: ``torch.cuda.device``
    with the device's context made current, once a thread. On a thread
    where PyTorch has not yet touched the card (a new thread, or the
    autograd engine's worker before its first CUDA op) no context is
    current, entering ``torch.cuda.device`` of the device PyTorch takes as
    current makes none, and the kernels' launches fail with ``invalid
    argument``."""
    import torch
    with torch.cuda.device(device):
        done = _current.__dict__.setdefault("devices", set())
        if device.index not in done:
            torch.cuda.set_device(device)
            done.add(device.index)
        yield


def kernel_function(source: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of ``csrc/<source>.cu`` as a callable.

    ``argtypes`` must give ``ctypes.c_void_p`` for every pointer and the
    stream (a bare Python int would be passed as a 32-bit int). The
    callable raises if the entry point returns a non-zero cudaError_t.
    """
    key = (source, symbol)
    fn = _functions.get(key)
    if fn is not None:
        return fn
    lib = _library(source)
    raw = getattr(lib, symbol)
    raw.argtypes = argtypes
    raw.restype = ctypes.c_int
    err = getattr(lib, f"{source}_error_string")

    def call(*args):
        rc = raw(*args)
        if rc:
            raise RuntimeError(f"{symbol} failed: cudaError_t {rc} "
                               f"({err(rc).decode()})")

    _functions[key] = call
    return call
