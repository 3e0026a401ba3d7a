"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into
``build/mcjax_torch/lib<name>-<digest>.so`` (next to the package; ``build/``
is git-ignored), where the digest covers the source, the headers of
``csrc/`` it may include and the flags, so an edited source or header is
rebuilt and a stale library is never loaded. The libraries
have a plain C interface: every pointer and the stream are passed as
``c_void_p`` and each entry returns ``cudaGetLastError()`` after its launch.
Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "mcjax_torch"

# --fmad=false: the only fused multiply-adds are the ones the sources write
# out (__fmaf_rn), placed where XLA on the CPU contracts.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


class CudaLibrary:
    """One kernel source, its shared library and its launch count.

    ``signatures`` maps each C entry point to its ctypes argument types.
    ``launches`` is a plain int that ``launch`` adds one to for every kernel
    launch, ``npt_launches`` one for every launch of a kernel's NPT form
    among them and ``field_launches`` one for every launch of its field
    form; callers reset all three to 0 to count the launches of one run.
    """

    def __init__(self, name: str, signatures: dict[str, list]):
        self.name = name
        self.signatures = signatures
        self.launches = 0
        self.npt_launches = 0
        self.field_launches = 0
        self.build_log = ""
        self.build_seconds: float | None = None
        self._lib: ctypes.CDLL | None = None

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    @property
    def path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> tuple[subprocess.Popen, Path] | None:
        """Start nvcc in the background unless the library is built."""
        if self.path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, proc: subprocess.Popen, tmp: Path) -> None:
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        os.replace(tmp, self.path)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.path))
            for fn, argtypes in self.signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, fn: str, *args, npt: bool = False,
               field: bool = False) -> None:
        """Call entry ``fn`` (which launches a kernel's NPT form if ``npt``,
        its field form if ``field``); raise if the launch reported a CUDA
        error."""
        err = getattr(self.load(), fn)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {err}")
        self.launches += 1
        self.npt_launches += npt
        self.field_launches += field


def build_all(libs: list[CudaLibrary]) -> float:
    """Build every library not built yet, one nvcc per source, all started
    together; each one's output is read as it comes, and its wall time from
    the common start is left in its ``build_seconds``. Returns the wall
    time in seconds."""
    t0 = time.perf_counter()
    started = [(lib, job) for lib in libs
               if (job := lib.start_build()) is not None]

    def finish(item) -> None:
        lib, (proc, tmp) = item
        lib.finish_build(proc, tmp)
        lib.build_seconds = time.perf_counter() - t0

    if started:
        with ThreadPoolExecutor(len(started)) as pool:
            list(pool.map(finish, started))
    return time.perf_counter() - t0
