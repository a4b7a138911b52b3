"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources are the package's own ``csrc/*.cu``.  They are compiled at first
use into ``gp_grief_tpu_torch/_build/<hash>/`` (the hash covers the sources
and the flags, so an edited source rebuilds) as one shared library with a
plain C interface: one ``nvcc -c`` per source, all started together, then one
link.  Nothing includes PyTorch's headers, which keeps a build to seconds.  A
missing ``nvcc`` or a failed build raises with the compiler's output.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_library", "build_log", "NVCC_FLAGS"]

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
LIB_NAME = "libgp_grief_kernels.so"

# sm_90a (not sm_90): the arch-specific target Hopper's wgmma/setmaxnreg need.
# -Xptxas -v records registers, shared memory and spills in build.log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_longlong
# name -> argtypes of every C entry point in csrc/.
_SIGNATURES = {
    "gp_grief_phi_fused_f32": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR],
    "gp_grief_phi_fused_f64": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR],
    # x, out, K0, K1, K2, g, n0..n2, o0..o2, pre, post, P, fast, x_bf16, out_bf16, stream
    "gp_grief_kron_tile_pass": [_PTR] * 5 + [_INT] * 7 + [_I64, _I64] + [_INT] * 4 + [_PTR],
    # x, out, K, n, o, pre, post, fast, x_bf16, out_bf16, stream
    "gp_grief_kron_wide_pass": [_PTR] * 3 + [_INT] * 2 + [_I64, _I64] + [_INT] * 3 + [_PTR],
}


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
        "the CUDA kernels are built from csrc/ at first use and need the CUDA toolkit"
    )


def _lib_path() -> Path:
    sources = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def _run_all(cmds) -> str:
    """Run the commands concurrently; raise with the output of any that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(proc.returncode)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed with exit code {failed[0]}:\n{log}")
    return log


def _compile(lib_path: Path) -> None:
    nvcc = _find_nvcc()
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objs = [lib_path.with_name(f"{src.stem}.{tag}.o") for src in sources]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for src, o in zip(sources, objs)])
    tmp = lib_path.with_name(f"{LIB_NAME}.{tag}.tmp")
    log += "\n" + _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    (lib_path.parent / "build.log").write_text(log)
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile ``csrc/`` if this source hash has no library yet, then load it
    and declare every entry point's argument and return types."""
    lib_path = _lib_path()
    if not lib_path.exists():
        _compile(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    """The nvcc command and its output (ptxas register/spill report) of the
    library :func:`load_library` loads; empty if it has not been built."""
    log = _lib_path().parent / "build.log"
    return log.read_text() if log.exists() else ""
