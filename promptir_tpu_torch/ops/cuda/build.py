"""Build the hand-written CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc`` process,
all started together, and one more ``nvcc`` links the objects into one shared
library with a plain C interface. The library lands in
``promptir_tpu_torch/_build/`` under a name keyed by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one loads at once. No
PyTorch header is compiled: the build takes seconds, where
``torch.utils.cpp_extension.load`` takes minutes.

:func:`lib` builds or loads the library inside a ``setup.library`` span
(``utils/tracing.py``; its ``built`` attribute says whether nvcc ran), which
is how long the library took to become usable.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on a non-zero code, because a refused launch never runs
and ``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from promptir_tpu_torch.utils import tracing

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_functions: dict = {}  # (library, name) -> the declared function
# what the last build printed (ptxas register and shared-memory use); None
# when the library was already built
build_log: str | None = None


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> pathlib.Path:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpromptir_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list) -> list:
    """Run the commands side by side; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = []
    for cmd, p in zip(cmds, procs):
        try:
            out, _ = p.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            for q in procs:
                q.kill()
            raise RuntimeError(
                f"nvcc failed with code {p.returncode}: {' '.join(cmd)}\n{out}")
        outs.append(out)
    return outs


def build() -> pathlib.Path:
    """Compile the kernels unless the current library exists; return its path."""
    global build_log
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    logs = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                 for src, o in zip(srcs, objs)])
    logs += _run([[_nvcc(), "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                   "-o", str(tmp), *map(str, objs)]])
    build_log = "".join(logs)
    for o in objs:
        o.unlink()
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            with tracing.setup_span("setup.library") as s:
                s.attrs["built"] = not library_path().exists()
                _lib = ctypes.CDLL(str(build()))
            _lib.pk_error_string.argtypes = [ctypes.c_int]
            _lib.pk_error_string.restype = ctypes.c_char_p
        return _lib


def function(name: str, argtypes: list, restype=ctypes.c_int):
    """A library function with its ctypes signature declared (once a
    library and name: the wrappers call this at every launch)."""
    key = (id(lib()), name)
    fn = _functions.get(key)
    if fn is None:
        fn = getattr(lib(), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _functions[key] = fn
    return fn


def dtype_code(t) -> int:
    """The kernels' dtype code of a tensor (0 fp32, 1 bf16); raises otherwise."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return codes[t.dtype]


def stream_of(t) -> int:
    """The current CUDA stream on t's card, as the launchers take it (the
    raw handle: a Stream object costs a few microseconds of host time a
    launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_card_of(t):
    """Context that makes t's card the current device around a launch: the
    launchers start their kernels, and set their shared-memory limit
    (common.cuh:allow_smem), on the current device. Nothing to do when it
    already is."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def check(code: int, what: str) -> None:
    if code != 0:
        msg = lib().pk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
