"""Build and load the port's CUDA kernels: nvcc by hand, bound with ctypes.

The JAX package has no counterpart: Pallas compiles its kernels inside
``jax.jit``. Here the ``csrc/*.cu`` files (plain C entry points, no PyTorch
header; ``o0n_rans32.cu``, ``ctx_nib_rans32.cu`` and ``o0c_rans32.cu``,
which share ``nib_model.cuh``, ``causal_attn.cu``, and
``causal_attn_sm90.cu`` with its PTX wrappers in ``sm90.cuh``) are compiled on
first use, one ``nvcc`` process per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c

and linked by one more ``nvcc -shared`` into one library in ``ops/build/``,
under a name that holds a hash of every source in ``csrc/`` and the flags.
The linker writes to a temporary name that is then renamed into place, so
no lock file is needed and a build that was cut off leaves nothing that a
later build waits on. The first build prints its seconds and what
``-Xptxas -v`` says of each kernel's registers, static shared memory and
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

__all__ = ["load_library", "sass_counts", "NVCC_FLAGS"]

_OPS_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_OPS_DIR, "csrc")
_BUILD_DIR = os.path.join(_OPS_DIR, "build")
_BUILD_TIMEOUT_S = 300

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
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
    # f32 K10/K11: q, k, v, o, lse, B, H, S, D, sh, ss, scale, stream
    "lac_attn_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _F, _P),
    # q, k, v, dO, lse, di, dk, dv, B, H, S, D, sh, ss, scale, stream
    "lac_attn_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _F, _P),
    # f32 K12: q, k, v, dO, lse, di, dq, B, H, S, D, sh, ss, scale, stream
    "lac_attn_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _F, _P),
    # dynamic shared bytes a block of K10/K11/K12 (10, 11, 12) at head dim D
    "lac_attn_smem_bytes": (_I, _I),
    # bf16 K10-K12 on the tensor cores; ss, sh, sb are byte strides
    # q, k, v, o, lse, B, H, S, D, ss, sh, sb, scale, stream
    "lac_attn_fwd_sm90": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _F, _P),
    # q, k, v, dO, lse, di, dk, dv, B, H, S, D, ss, sh, sb, scale, stream
    "lac_attn_bwd_dkv_sm90": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _F,
                              _P),
    # q, k, v, dO, lse, di, dq, B, H, S, D, ss, sh, sb, scale, stream
    "lac_attn_bwd_dq_sm90": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _F, _P),
}

_KERNELS = ("o0n_intervals_kernel", "rans32_encode_kernel", "o0n_decode_kernel",
            "ctx_intervals_kernel", "ctx_decode_kernel",
            "o0c_intervals_kernel", "o0c_decode_kernel",
            "causal_attn_fwd_kernel", "causal_attn_bwd_dkv_kernel",
            "causal_attn_bwd_dq_kernel", "causal_attn_fwd_sm90_kernel",
            "causal_attn_bwd_dkv_sm90_kernel", "causal_attn_bwd_dq_sm90_kernel")

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


def _kernel_label(mangled: str) -> str:
    """A kernel's short name with its template argument, e.g.
    ``causal_attn_fwd_sm90_kernel<64>``, from its mangled symbol."""
    name = next((k for k in _KERNELS if k in mangled), mangled)
    tmpl = re.search(r"ILi(\d+)E", mangled)  # template <int>
    return f"{name}<{tmpl.group(1)}>" if tmpl else name


def _ptxas_summary(log: str) -> str:
    """One line per kernel: registers, shared memory and spill bytes; and
    every ptxas warning (a setmaxnreg that ptxas ignored shows here)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = _kernel_label(m.group(1))
        if "warning" in line:
            out.append(f"  {line.strip()}")
        if "spill stores" in line and name:
            out.append(f"  {name}: {line.split('ptxas info    :')[-1].strip()}")
        if "Used" in line and "registers" in line and name:
            out.append(f"  {name}: {line.split('ptxas info    :')[-1].strip()}")
    return "\n".join(out)


def sass_counts(lib: ctypes.CDLL, opcode: str) -> dict:
    """{kernel label: the number of ``opcode`` instructions in its SASS}, for
    every kernel of the built library ``lib``, from ``cuobjdump -sass``
    (which comes with the toolkit, beside nvcc)."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True, text=True,
                          timeout=_BUILD_TIMEOUT_S, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _kernel_label(m.group(1))
            counts[name] = 0
        elif name is not None and re.search(rf"\b{opcode}\b", line):
            counts[name] += 1
    return counts


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")) + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _build(so_path: str) -> None:
    """One nvcc per source, all at once, then one link into ``so_path``."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    units = [p for p in _sources() if p.endswith(".cu")]
    objs = [os.path.join(_BUILD_DIR, f"{os.path.basename(u)[:-3]}.{tag}.o") for u in units]
    tmp = f"{so_path}.{tag}"
    t0 = time.perf_counter()
    try:
        procs = [
            subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o, u],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for u, o in zip(units, objs)
        ]
        logs, failed = [], []
        for u, proc in zip(units, procs):
            try:
                out, err = proc.communicate(timeout=_BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for p in procs:
                    p.kill()
                raise RuntimeError(f"nvcc took over {_BUILD_TIMEOUT_S} s on {u}")
            logs.append(out + err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on {u}:\n{err[-4000:]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        link = subprocess.run([_nvcc(), "-shared", "-Xcompiler", "-fPIC", "-o", tmp, *objs],
                              capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
        os.replace(tmp, so_path)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.remove(path)
    dt = time.perf_counter() - t0
    print(f"[lac_tpu_torch] built {os.path.basename(so_path)} with {len(units)} parallel "
          f"nvcc calls and a link in {dt:.2f} s")
    summary = _ptxas_summary("\n".join(logs))
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
