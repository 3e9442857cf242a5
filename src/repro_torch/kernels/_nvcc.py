"""Build CUDA sources into shared libraries with a plain C interface, and
load them with ``ctypes``.

Each library is one ``.cu`` source (plus the headers it includes, from its
own directory or from ``kernels/include/``) compiled by ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared`` into ``build/kernels/`` at the
repo root.
The file name carries a hash of the sources, headers and flags, so an edited
source is rebuilt and an unchanged one is reused. Nothing here runs at
import time: the CPU tests import every module, and only a first launch on a
CUDA tensor (or an explicit ``build_all``) calls ``nvcc``.

Libraries link the CUDA runtime statically, so each keeps its own current
device: every C entry point takes the device index and makes it current
around its launch. Pointers and the stream travel as ``c_void_p``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
#: ``-Xptxas=-v`` puts each kernel's registers, shared memory and spills in
#: the build log (``CudaLibrary.log``)
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v")

#: headers shared by several kernels (``-I``)
INCLUDE_DIR = Path(__file__).resolve().parent / "include"
#: the split-TF32 tensor-core products and ``cp.async`` staging
SPLIT_TF32 = INCLUDE_DIR / "split_tf32.cuh"

#: libraries are built here, beside the sources' checkout (``.gitignore``d)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


class CudaLibrary:
    """One shared library built from ``source`` (which may include any of
    ``headers``), loaded once per process."""

    def __init__(self, name: str, source: Path, headers: Sequence[Path] = (),
                 extra_flags: Sequence[str] = ()):
        self.name = name
        self.source = Path(source)
        self.headers = tuple(Path(h) for h in headers)
        self.flags = ARCH_FLAGS + NVCC_FLAGS + tuple(extra_flags)
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        #: what ``nvcc`` printed on the last build in this process
        self.log = ""

    def digest(self) -> str:
        h = hashlib.sha256()
        for p in (self.source, *self.headers):
            h.update(p.name.encode())
            h.update(p.read_bytes())
        h.update(" ".join(self.flags).encode())
        return h.hexdigest()[:16]

    @property
    def path(self) -> Path:
        return BUILD_DIR / f"lib{self.name}-{self.digest()}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this library unless it is already built; the
        output goes to a temporary name and is renamed when complete, so a
        concurrent or interrupted build never leaves a torn library."""
        out = self.path
        if out.exists():
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *self.flags, "-I", str(self.source.parent), "-I", str(INCLUDE_DIR),
               "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        proc._repro_tmp = tmp  # type: ignore[attr-defined]
        proc._repro_out = out  # type: ignore[attr-defined]
        return proc

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        self.log, _ = proc.communicate()
        tmp, out = proc._repro_tmp, proc._repro_out  # type: ignore[attr-defined]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{self.log}")
        os.replace(tmp, out)

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                self._lib = ctypes.CDLL(str(self.path))
            return self._lib


def build_all(libs: Iterable[CudaLibrary]) -> Dict[str, str]:
    """Build every library that is not built yet, one ``nvcc`` per source,
    all started together; returns each library's compiler output."""
    libs: List[CudaLibrary] = list(libs)
    procs = [lib.start_build() for lib in libs]
    errors = []
    for lib, proc in zip(libs, procs):
        try:
            lib.finish_build(proc)
        except RuntimeError as ex:
            errors.append(str(ex))
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in libs:
        lib.load()
    return {lib.name: lib.log for lib in libs}
