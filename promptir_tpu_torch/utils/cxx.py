"""Host C++ libraries of the port: built at first use, loaded with ctypes.

The port's host-side native code (`promptir_tpu_torch/native/*.cpp`: the
JPEG decoder, the PNG decoder and the fused sample preparation) is built
with the host's `g++` the first time it is called, into
`promptir_tpu_torch/_build/`, under a name keyed by a hash of the sources
and the flags, so an edit or a new flag builds anew and a stale library is
never loaded. Parallel processes each build to a name of their own and
move it into place (`os.replace`), so none loads a half-written file. A
missing `g++` or a failed build raises: nothing falls back.

ctypes' `CDLL` releases the GIL for the length of each call, so the
training loader's threads run the libraries side by side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Callable, Optional, Sequence

_PKG = pathlib.Path(__file__).resolve().parents[1]
NATIVE = _PKG / "native"
BUILD_DIR = _PKG / "_build"


class Library:
    """A shared library built from `sources` (file names in native/) with
    `flags`, linked against `link` (e.g. `-lz`); `declare` sets the
    argument and result types of its functions once it is loaded."""

    def __init__(self, stem: str, sources: Sequence[str],
                 flags: Sequence[str], link: Sequence[str] = (),
                 declare: Optional[Callable[[ctypes.CDLL], None]] = None):
        self.stem = stem
        self.sources = tuple(NATIVE / s for s in sources)
        self.flags = tuple(flags)
        self.link = tuple(link)
        self.declare = declare
        self._lock = threading.Lock()
        self._cdll: Optional[ctypes.CDLL] = None

    def path(self) -> pathlib.Path:
        """Where the library of the current sources and flags is built."""
        h = hashlib.sha256(" ".join(self.flags + self.link).encode())
        for src in self.sources:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return BUILD_DIR / f"lib{self.stem}_{h.hexdigest()[:16]}.so"

    def build(self) -> pathlib.Path:
        """Build the library unless it is there; its path."""
        so = self.path()
        if so.exists():
            return so
        cxx = shutil.which("g++")
        names = ", ".join(s.name for s in self.sources)
        if cxx is None:
            raise RuntimeError(f"g++ not found: {names} are built with the "
                               "host's g++")
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(
            f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [cxx, *self.flags, *map(str, self.sources), "-o", str(tmp),
               *self.link]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {names} failed "
                               f"({' '.join(cmd)}):\n{r.stderr[-3000:]}")
        os.replace(tmp, so)
        return so

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if need be."""
        with self._lock:
            if self._cdll is None:
                cdll = ctypes.CDLL(str(self.build()))
                if self.declare is not None:
                    self.declare(cdll)
                self._cdll = cdll
        return self._cdll
