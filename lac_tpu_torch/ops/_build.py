"""Build and load the port's CUDA kernels: nvcc by hand, bound with ctypes.

The JAX package has no counterpart: Pallas compiles its kernels inside
``jax.jit``. Here the ``csrc/*.cu`` files (plain C entry points, no PyTorch
header; ``nib_rans32.cu``, ``rans32_encode.cu``, ``o0c_rans32.cu``,
``causal_attn.cu``, ``causal_attn_sm90.cu`` with its PTX wrappers in
``sm90.cuh``, and ``step_attn.cu``) are compiled on first use, one
``nvcc`` process per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c

and linked by one more ``nvcc -shared`` into one library in ``ops/build/``,
under a name that holds a hash of every source in ``csrc/`` and the flags.
The linker writes to a temporary name that is then renamed into place, so
no lock file is needed and a build that was cut off leaves nothing that a
later build waits on. The first build prints its seconds and what
``-Xptxas -v`` says of each kernel's registers, static shared memory and
spills. ``sass_counts`` counts opcodes in each kernel's SASS, in the whole
kernel or in its innermost loop.

    python -m lac_tpu_torch.ops._build [CSRC_DIR]

builds the sources of ``CSRC_DIR`` (default: this package's) into a
temporary directory under ``ops/build/`` and prints the ptxas summary and
the codec kernels' innermost-loop opcode counts, so that two trees'
kernels can be compared.

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
import sys
import tempfile
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
    # launch shape of K1, K3-K7: lanes a block (4 threads each); each
    # kernel's shared bytes a block
    "lac_nib_lanes": (),
    "lac_o0n_intervals_shared_bytes": (),
    "lac_o0n_decode_shared_bytes": (),
    "lac_o1n_intervals_shared_bytes": (),
    "lac_o1n_decode_shared_bytes": (),
    "lac_o2n_intervals_shared_bytes": (),
    "lac_o2n_decode_shared_bytes": (),
    "lac_o0c_intervals": (_P, _P, _P, _I, _I, _I, _P),
    "lac_o0c_decode": (_P, _P, _P, _I, _I, _I, _I, _P),
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
    # the cached step's attention: q, k, v, ck, cv, pos, o, scratch, B, KVH,
    # R, W, D, bf16, q_sb, q_sh, k_sb, k_sh, v_sb, v_sh, scale, stream
    "lac_step_attn": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L,
                      _L, _L, _F, _P),
    # its scratch f32 values at B, KVH, R, W, D, bf16 (-1: shapes it does not take)
    "lac_step_attn_scratch": (_I, _I, _I, _I, _I, _I),
}

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
    """A kernel's short name with every template argument, e.g.
    ``causal_attn_fwd_sm90_kernel<64>`` or ``nib_decode_kernel<1, 16>``,
    from its mangled symbol: the first of its length-prefixed names
    (``_ZN<len><name>...``) that is not its anonymous namespace
    (``_GLOBAL__N_...``), so that another tree's kernels get their names
    too."""
    name, pos = mangled, 3 if mangled.startswith("_ZN") else 2
    while mangled.startswith("_Z") and (m := re.compile(r"\d+").match(mangled, pos)):
        pos = m.end() + int(m.group())
        if not mangled[m.end():].startswith("_GLOBAL__N"):
            name = mangled[m.end():pos]
            break
    tmpl = re.search(r"I((?:Li\d+E)+)E", mangled)  # template <int, ...>
    if not tmpl:
        return name
    args = re.findall(r"Li(\d+)E", tmpl.group(1))
    return f"{name}<{', '.join(args)}>"


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


# the opcodes of the codec kernels' inner loops that phase 0 of
# chip_smoke.py prints for K1 and K3-K9: the integer ones, then those of the
# shared-memory and warp units
INT_OPCODES = ("IADD3", "VIADD", "LOP3", "SHF", "ISETP", "SEL", "IMNMX", "VIMNMX", "VIADDMNMX",
               "PRMT", "IMAD", "POPC", "REDUX", "SHFL", "VOTE", "LDS", "STS")


def _sass_functions(so_path: str) -> dict:
    """{kernel label: [(address, opcode, text)]} from ``cuobjdump -sass``
    (which comes with the toolkit, beside nvcc)."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          timeout=_BUILD_TIMEOUT_S, check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs[_kernel_label(m.group(1))] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            toks = m.group(2).split()
            op = toks[1] if toks[0].startswith("@") and len(toks) > 1 else toks[0]
            cur.append((int(m.group(1), 16), op.split(".")[0], m.group(2)))
    return funcs


def _innermost_loop(instrs: list) -> list:
    """The instructions from a backward branch's target (``BRA 0x3a0``) to
    the branch, for the longest such span that holds no EXIT and no other
    such span: the kernel's hot innermost loop, not a short set-up or
    zero-fill loop beside it (empty if there is none). The branch to itself
    after EXIT, and the jump from a divergent slow path past EXIT back into
    a loop, are no loops."""
    exits = [addr for addr, op, _ in instrs if op == "EXIT"]
    loops = []
    for addr, op, text in instrs:
        m = re.search(r"BRA\S*\s+0x([0-9a-f]+)", text) if op == "BRA" else None
        target = int(m.group(1), 16) if m else None
        if target is not None and target < addr and not any(target <= e <= addr for e in exits):
            loops.append((target, addr))
    inner = [a for a in loops
             if not any(b != a and a[0] <= b[0] and b[1] <= a[1] for b in loops)]
    if not inner:
        return []
    best = max(inner, key=lambda span: span[1] - span[0])
    return [i for i in instrs if best[0] <= i[0] <= best[1]]


def sass_counts(lib, opcodes, inner_loop: bool = False) -> dict:
    """{kernel label: {opcode: count, "all": instructions}} for every kernel
    of the built library ``lib`` (a loaded CDLL or a path), over the whole
    kernel or, with ``inner_loop``, over its innermost loop. An opcode
    counts with its modifiers (``SHF`` counts ``SHF.R.U32``)."""
    out = {}
    for name, instrs in _sass_functions(getattr(lib, "_name", lib)).items():
        if inner_loop:
            instrs = _innermost_loop(instrs)
        out[name] = {op: sum(1 for i in instrs if i[1] == op) for op in opcodes}
        out[name]["all"] = len(instrs)
    return out


def _sources(csrc: str = _CSRC) -> list[str]:
    return sorted(glob.glob(os.path.join(csrc, "*.cu")) + glob.glob(os.path.join(csrc, "*.cuh")))


def _build(so_path: str, csrc: str = _CSRC) -> None:
    """One nvcc per source of ``csrc``, all at once, then one link into
    ``so_path``."""
    build_dir = os.path.dirname(so_path)
    os.makedirs(build_dir, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    units = [p for p in _sources(csrc) if p.endswith(".cu")]
    objs = [os.path.join(build_dir, f"{os.path.basename(u)[:-3]}.{tag}.o") for u in units]
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


def main(argv: list[str]) -> int:
    csrc = os.path.abspath(argv[0]) if argv else _CSRC
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        so_path = os.path.join(tmp, "lac_kernels.so")
        _build(so_path, csrc)
        loops = sass_counts(so_path, INT_OPCODES, inner_loop=True)
    for name, counts in loops.items():
        if not name.startswith("causal_attn"):  # the codec kernels
            print(f"{name} innermost loop: {counts}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
