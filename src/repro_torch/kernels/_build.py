"""Build the CUDA sources in ``csrc/`` into shared libraries at first use.

Each ``csrc/<name>.cu`` becomes one library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  A library may have parts,
``csrc/<name>.<part>.cu``, compiled apart and linked in, so that a source
with many kernels builds on several cores.  Libraries land in ``_build/``
under a name that carries a hash of the sources, so an edited source is
rebuilt and a stale library is never loaded.  ``build`` starts one
``nvcc`` per source of every missing library, all at once, waits for all
of them, and links each library.

A ``CudaKernel`` binds one C entry point and counts its launches: the count
goes up by one where the kernel was launched and nowhere else, so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
# -split-compile=0 lets one source's optimizer use the cores the other,
# shorter builds leave idle
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
              "-split-compile=0")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
#: Dynamic shared memory one block may use on sm_90 (bytes).
MAX_SMEM = 232_448

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "the PATH); the CUDA kernels build only where the "
                           "CUDA toolkit is installed")


def library_names() -> list[str]:
    """One library per ``csrc/*.cu`` source that is not a part."""
    return sorted(p.stem for p in CSRC.glob("*.cu") if "." not in p.stem)


def sources(name: str) -> list[pathlib.Path]:
    """``csrc/<name>.cu`` and its parts, ``csrc/<name>.<part>.cu``."""
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob(f"{name}.*.cu"))]


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in [*sources(name), *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, pathlib.Path]:
    """Compile every named library that is not built yet, all sources in
    parallel, then link each.

    Returns the library paths; raises ``KernelBuildError`` with nvcc's
    output if any source fails to compile or link.  Each ``<lib>.log``
    keeps nvcc's ``-Xptxas -v`` report of all its sources (registers,
    shared memory, spills).
    """
    names = library_names() if names is None else list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    procs = {n: [] for n in todo}
    for n in todo:
        for src in sources(n):
            obj = BUILD_DIR / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs[n].append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT,
                                              text=True), obj))
    failed = []
    for n, p in todo.items():
        log, objs, ok = [], [], True
        for proc, obj in procs[n]:
            out, _ = proc.communicate()
            log.append(out)
            objs.append(obj)
            ok = ok and proc.returncode == 0
        tmp = p.with_name(f"{p.name}.{tag}.tmp")
        if ok:
            link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                                   *map(str, objs)], capture_output=True,
                                  text=True)
            log.append(link.stdout + link.stderr)
            ok = link.returncode == 0
        p.with_suffix(".log").write_text("".join(log))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if ok:
            os.replace(tmp, p)
        else:
            failed.append(f"--- {n} ---\n" + "".join(log))
            tmp.unlink(missing_ok=True)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


class CudaKernel:
    """One hand-written kernel: its C entry point and its launch count.

    ``replaces`` names the TPU kernel it ports (file:line of its ``def``);
    ``source`` is its CUDA file in the repo.
    """

    def __init__(self, name: str, *, lib: str, symbol: str, argtypes,
                 replaces: str):
        self.name = name
        self.lib = lib
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.source = f"src/repro_torch/kernels/csrc/{lib}.cu"
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def _entry(self):
        if self._fn is None:
            lib = load(self.lib)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = (lib, fn)
        return self._fn

    def query(self, symbol: str, *args: int) -> int:
        """Call another entry point of the kernel's library that takes ints
        and returns an int (an occupancy query); never counts a launch."""
        lib, _ = self._entry()
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = ctypes.c_int
        return fn(*args)

    def launch(self, *args) -> None:
        """Call the C entry point (which launches on the given stream and
        returns ``cudaGetLastError()``); raise on a non-zero code."""
        lib, fn = self._entry()
        err = fn(*args)
        if err:
            msg = lib.repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1


#: Every kernel of the port by name (filled as the wrapper modules import).
KERNELS: dict[str, CudaKernel] = {}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    """Launch count of every kernel by name."""
    return {n: k.launches for n, k in KERNELS.items()}


def ptr(t) -> ctypes.c_void_p:
    """Device address of a tensor's first element."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """The current PyTorch stream on the tensor's device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
