"""Build a CUDA source of the port into a shared library and load it.

Every kernel of the port is CUDA C++ under ``csrc/`` with a plain C
interface.  ``CudaLibrary`` compiles one such source with ``nvcc`` for
``sm_90a`` at first use, under ``build/kernels/`` at the root of the
checkout (the file name carries a hash of the source and flags, so an
edit rebuilds), and loads it with ``ctypes``.  Nothing is compiled or
loaded when a module is imported.  The compiler's output (``-Xptxas=-v``:
registers and spills of each kernel) is kept beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels build only "
                           "where the CUDA toolkit is installed")
    return found


class CudaLibrary:
    """One ``csrc/<name>.cu`` built into ``build/kernels/<name>-<hash>.so``.

    ``signatures`` maps each exported C function to ``(argtypes,
    restype)``; ``load()`` declares them on the loaded library.
    ``source`` builds another file instead (e.g. another checkout's
    ``csrc/<name>.cu``).
    """

    def __init__(self, name: str, signatures: dict,
                 source: str | os.PathLike | None = None):
        self.name = name
        self.source = Path(source) if source else CSRC / f"{name}.cu"
        self.signatures = signatures
        self.build_log = ""        # nvcc/ptxas output of the last build
        self._lib = None

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"{self.name}-{digest[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless this exact build exists; returns the
        library's path."""
        lib = self.path()
        if lib.exists():
            log = lib.with_suffix(".log")
            self.build_log = log.read_text() if log.exists() else ""
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            capture_output=True, text=True, check=False)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed on {self.source}:\n{self.build_log}")
        lib.with_suffix(".log").write_text(self.build_log)
        os.replace(tmp, lib)
        return lib

    def load(self) -> ctypes.CDLL:
        """The built library with its functions' signatures declared."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for fn, (argtypes, restype) in self.signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            self._lib = lib
        return self._lib
