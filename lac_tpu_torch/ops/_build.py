"""Build and load the port's CUDA kernels: nvcc by hand, bound with ctypes.

The JAX package has no counterpart: Pallas compiles its kernels inside
``jax.jit``. Here the ``csrc/*.cu`` files (plain C entry points, no PyTorch
header; ``o0n_rans32.cu``, ``ctx_nib_rans32.cu`` and ``o0c_rans32.cu``,
which share ``nib_model.cuh``) are compiled on first use, by one call of

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into one library in ``ops/build/``, under a name that holds a hash of every
source in ``csrc/`` and the flags. The compiler writes to a temporary name that is then renamed into
place, so no lock file is needed and a build that was cut off leaves
nothing that a later build waits on. The first build prints its seconds
and what ``-Xptxas -v`` says of each kernel's registers, shared memory and
spills.

Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ["load_library", "NVCC_FLAGS"]

_OPS_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_OPS_DIR, "csrc")
_BUILD_DIR = os.path.join(_OPS_DIR, "build")
_BUILD_TIMEOUT_S = 300

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # syms, lo, fr, T, B, rate, stream
    "lac_o0n_intervals": (_P, _P, _P, _I, _I, _I, _P),
    # lo, fr, lengths, words, nwords, T, B, cap, stream
    "lac_rans32_encode": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # words, lengths, syms, T, B, cap, rate, stream
    "lac_o0n_decode": (_P, _P, _P, _I, _I, _I, _I, _P),
    "lac_o1n_intervals": (_P, _P, _P, _I, _I, _I, _P),
    "lac_o1n_decode": (_P, _P, _P, _I, _I, _I, _I, _P),
    "lac_o2n_intervals": (_P, _P, _P, _I, _I, _I, _P),
    "lac_o2n_decode": (_P, _P, _P, _I, _I, _I, _I, _P),
    "lac_o0c_intervals": (_P, _P, _P, _I, _I, _I, _P),
    "lac_o0c_decode": (_P, _P, _P, _I, _I, _I, _I, _P),
    # launch shape of the order1n/order2n kernels: lanes a block; shared
    # bytes a block for a lo-context count
    "lac_ctx_lanes": (),
    "lac_ctx_shared_bytes": (_I,),
}

_KERNELS = ("o0n_intervals_kernel", "rans32_encode_kernel", "o0n_decode_kernel",
            "ctx_intervals_kernel", "ctx_decode_kernel",
            "o0c_intervals_kernel", "o0c_decode_kernel")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def _ptxas_summary(log: str) -> str:
    """One line per kernel: registers, shared memory and spill bytes."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = next((k for k in _KERNELS if k in m.group(1)), m.group(1))
            tmpl = re.search(r"ILi(\d+)E", m.group(1))  # template argument
            if tmpl:
                name += f"<{tmpl.group(1)}>"
        if "spill stores" in line and name:
            out.append(f"  {name}: {line.split('ptxas info    :')[-1].strip()}")
        if "Used" in line and "registers" in line and name:
            out.append(f"  {name}: {line.split('ptxas info    :')[-1].strip()}")
    return "\n".join(out)


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")) + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _build(so_path: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp{os.getpid()}"
    units = [p for p in _sources() if p.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, *units]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    dt = time.perf_counter() - t0
    print(f"[lac_tpu_torch] built {os.path.basename(so_path)} with nvcc in {dt:.2f} s")
    summary = _ptxas_summary(proc.stderr + proc.stdout)
    if summary:
        print(summary)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in _sources():
            with open(path, "rb") as f:
                digest.update(os.path.basename(path).encode() + b"\0" + f.read())
        so_path = os.path.join(_BUILD_DIR, f"lac_kernels-{digest.hexdigest()[:16]}.so")
        if not os.path.exists(so_path):
            _build(so_path)
        lib = ctypes.CDLL(so_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        return lib
