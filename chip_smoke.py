import faulthandler; faulthandler.dump_traceback_later(900, exit=True)  # noqa: E702

# Drive lac_tpu_torch's main path on one CUDA card and check it.
#
#   python3 chip_smoke.py
#
# Phase 0  the card's name and power limit; build the CUDA kernels.
# Phase 1  each kernel against its plain PyTorch version on the card, at the
#          shapes the main path gives it: T = 4096 and 1024 steps, with one
#          lane per block of the 32 MiB corpus (B = 8192 and 32768): corpus
#          lanes, seeded random lanes whose words overflow cap, and ragged
#          lengths with 0, 1 and T-1. Equal integer for integer.
# Phase 2  the main path through its entry points: the CLI at its defaults
#          (order0n, block 4096) on the 32 MiB smoke corpus, then
#          engine.compress_bytes at block 1024; byte compare after decode,
#          and each container's crc32 and length against the golden values
#          that lac_tpu's native coder gives (lac_tpu_torch/smoke.py). The
#          kernels' launch counts are zeroed just before and read just after.
# Phase 3  numbers: end-to-end MB/s, host ms of decode's two parts (the
#          container parse and the rest) and of the container write, each
#          kernel's time from CUDA events beside its bound, bits per byte,
#          peak device memory.
#
# It imports the standard library, numpy, torch and lac_tpu_torch only. A
# hang ends in a traceback and a non-zero exit (faulthandler above). Without
# a CUDA device, or without the package beside it, it exits non-zero before
# printing any result. The last line is the JSON result.

import json
import os
import shutil
import subprocess
import sys
import time
import zlib

import numpy as np

RATE = 4
SEED = 0
BLOCK_SIZES = (4096, 1024)  # the CLI default, then bench.py's primary block
E2E_REPS = 3
EVENT_REPS = 5

# H100 SXM, dense, from NVIDIA's data sheet:
HBM_BYTES_PER_S = 3.35e12
# int32 ops: 64 INT32 lanes per SM against 128 FP32 lanes whose FMA counts
# two flops, so a quarter of the 67 TFLOP/s float32 (non-tensor) peak.
INT32_OPS_PER_S = 67e12 / 4
# Integer ops per coded symbol that the function needs, whatever a kernel
# spends beyond them, counting each add, shift, multiply, compare and select
# once (a u32 divide or modulo counts one). A boundary costs 3 to scale from
# its 15-bit state (multiply, shift, add); a state update costs 4.
#   K1 (158): split the byte 2; the 4 boundaries either side of the two
#     nibbles 4 x 3; f_h, f_l 2; compose lo12 3 and f12 1; update the 32
#     states of the hi table and the visited lo table 32 x 4; two rates 2 x 4
#     (four compares, four adds); one visit count 2.
#   K2 (8): compare, shift, select, divide, modulo, shift, 2 adds.
#   K3 (213): slot and slot >> 8 2; a 4-probe binary search per nibble, each
#     probe a scaled boundary and a compare and a select (hi 4 x 5, lo scaled
#     by f_h too 4 x 6); the boundaries either side of the hi nibble 2 x 3,
#     f_h 1, remainder 2; of the lo nibble 2 x 4, f12 1; the rANS step 4 and
#     its refill 5; the output byte 2; the same updates, rates and count as
#     K1 128 + 8 + 2.
OPS_PER_SYMBOL = {"o0n_intervals": 158, "rans32_encode": 8, "o0n_decode": 213}

REPLACES = {
    "o0n_intervals": "lac_tpu/ops/pallas_rans.py:742",
    "rans32_encode": "lac_tpu/ops/pallas_rans.py:179",
    "o0n_decode": "lac_tpu/ops/pallas_rans.py:849",
}
SOURCE = "lac_tpu_torch/ops/csrc/o0n_rans32.cu"


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        state = "failed" if exc[0] else "done"
        print(f"== {self.name} {state} in {dt:.2f} s", flush=True)
        return False


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def sync_time(torch, fn):
    """(result, ms) of one call, host clock around a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def event_ms(torch, fn, reps=EVENT_REPS):
    """Mean ms per call from CUDA events over ``reps`` calls, after a warm-up."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def phase1_inputs(corpus: bytes, t_len: int, b: int):
    rng = np.random.default_rng(SEED)
    syms_bt = np.frombuffer(corpus[: t_len * b], dtype=np.uint8).reshape(b, t_len).copy()
    syms_bt[8:72] = rng.integers(0, 256, (64, t_len), dtype=np.uint8)  # overflow cap
    lengths = np.full(b, t_len, dtype=np.int32)
    lengths[:3] = (0, 1, t_len - 1)
    lengths[72:200] = rng.integers(0, t_len + 1, 128)
    return np.ascontiguousarray(syms_bt.T), lengths


def max_abs_diff(torch, a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def phase1(torch, rk, corpus, dev):
    """Kernels against plain versions; returns (max_abs_err, plain_ms at the
    first shape) per kernel."""
    err = {k: 0 for k in OPS_PER_SYMBOL}
    plain_ms = {}
    for si, t_len in enumerate(BLOCK_SIZES):
        b = len(corpus) // t_len
        syms_np, len_np = phase1_inputs(corpus, t_len, b)
        syms = torch.from_numpy(syms_np).to(dev)
        lengths = torch.from_numpy(len_np).to(dev)
        cap = t_len // 2 + 3

        lo, fr = rk.o0n_encode_intervals(syms, RATE)
        (plo, pfr), ms1 = sync_time(torch, lambda: rk.o0n_intervals_plain(syms, RATE))
        e1 = max(max_abs_diff(torch, lo, plo), max_abs_diff(torch, fr, pfr))

        words, nwords = rk.rans32_encode(lo, fr, lengths, cap)
        (pwords, pnwords), ms2 = sync_time(
            torch, lambda: rk.rans32_encode_plain(lo, fr, lengths, cap))
        e2 = max(max_abs_diff(torch, words, pwords), max_abs_diff(torch, nwords, pnwords))
        check(bool((nwords > cap).any()), f"T={t_len}: no lane overflowed cap")

        out = rk.o0n_rans32_decode(words, lengths, t_len, RATE)
        pout, ms3 = sync_time(torch, lambda: rk.o0n_decode_plain(words, lengths, t_len, RATE))
        e3 = max_abs_diff(torch, out, pout)

        # round trip on the lanes whose words fit cap; zeros past each length
        t_idx = torch.arange(t_len, device=dev)[:, None]
        live = t_idx < lengths[None, :]
        fits = (nwords <= cap)[None, :]
        check(bool(((out == syms) | ~live | ~fits).all()), f"T={t_len}: round trip")
        check(bool(((out == 0) | live).all()), f"T={t_len}: zeros past length")

        for name, e in zip(OPS_PER_SYMBOL, (e1, e2, e3)):
            err[name] = max(err[name], e)
            check(e == 0, f"T={t_len} B={b}: {name} differs from its plain version by {e}")
        print(f"T={t_len} B={b}: K1 K2 K3 equal to plain "
              f"(plain ms {ms1:.1f} {ms2:.1f} {ms3:.1f}; "
              f"{int((nwords > cap).sum())} lanes overflow cap {cap})", flush=True)
        if si == 0:
            plain_ms = dict(zip(OPS_PER_SYMBOL, (ms1, ms2, ms3)))
    return err, plain_ms


def phase2(cli, engine, smoke, corpus, work):
    path = os.path.join(work, "corpus.bin")
    with open(path, "wb") as f:
        f.write(corpus)
    check(cli.main(["compress", path, "-o", path + ".lac"]) == 0, "cli compress")
    check(cli.main(["decompress", path + ".lac", "-o", path + ".out"]) == 0, "cli decompress")
    check(cli.main(["verify", path + ".lac"]) == 0, "cli verify")
    with open(path + ".out", "rb") as f:
        check(f.read() == corpus, "cli round trip differs from the corpus")
    with open(path + ".lac", "rb") as f:
        c4096 = f.read()
    c1024 = engine.compress_bytes(corpus, model_id="order0n", block_size=1024)
    check(engine.decompress_bytes(c1024) == corpus, "block 1024 round trip")
    for bs, c in ((4096, c4096), (1024, c1024)):
        got = smoke.container_digest(c)
        check(got == smoke.GOLDEN[bs],
              f"block {bs}: container (crc32, len) {got} != golden {smoke.GOLDEN[bs]}")
        print(f"block {bs}: container crc32 {got[0]} len {got[1]} equals lac_tpu's; "
              f"{8 * len(c) / len(corpus):.4f} bits/byte", flush=True)
    return {4096: c4096, 1024: c1024}


def e2e(torch, engine, corpus):
    rates = {}
    for bs in BLOCK_SIZES:
        enc, dec = [], []
        for _ in range(E2E_REPS):
            c, ms = sync_time(torch, lambda: engine.compress_bytes(
                corpus, model_id="order0n", block_size=bs))
            enc.append(ms)
            out, ms = sync_time(torch, lambda: engine.decompress_bytes(c))
            dec.append(ms)
            check(out == corpus, f"block {bs}: timed round trip")
        enc_mbs = len(corpus) / 1e6 / (float(np.median(enc)) / 1e3)
        dec_mbs = len(corpus) / 1e6 / (float(np.median(dec)) / 1e3)
        rates[bs] = (enc_mbs, dec_mbs)
        print(f"e2e block {bs}: encode {enc_mbs:.1f} MB/s, decode {dec_mbs:.1f} MB/s "
              f"(median of {E2E_REPS}; encode ms {[round(x, 1) for x in enc]}, "
              f"decode ms {[round(x, 1) for x in dec]})", flush=True)
    return rates


def host_split(torch, turbo, container_mod, c):
    """Host ms, median of 3, of the parts of the path for container ``c``:
    the parse that decode starts with (``read_container``), the decode after
    it (``turbo.decompress_parsed``, K3 and its copies included), and the
    ``write_container`` that encode ends with."""
    parse, rest, write = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        header, blocks = container_mod.read_container(c)
        parse.append(1e3 * (time.perf_counter() - t0))
        _, ms = sync_time(torch, lambda: turbo.decompress_parsed(header, blocks))
        rest.append(ms)
        t0 = time.perf_counter()
        container_mod.write_container(header, blocks)
        write.append(1e3 * (time.perf_counter() - t0))
    return tuple(float(np.median(v)) for v in (parse, rest, write))


def kernel_times(torch, rk, corpus, dev, t_len):
    """Event times and bounds of K1, K2, K3 on the main path's inputs at
    block ``t_len`` (all of the corpus, one lane per block)."""
    b = len(corpus) // t_len
    syms = torch.from_numpy(
        np.frombuffer(corpus, dtype=np.uint8).reshape(b, t_len).T.copy()).to(dev)
    lengths = torch.full((b,), t_len, dtype=torch.int32, device=dev)
    cap = t_len // 2 + 3
    lo, fr = rk.o0n_encode_intervals(syms, RATE)
    words, nwords = rk.rans32_encode(lo, fr, lengths, cap)
    ms = {
        "o0n_intervals": event_ms(torch, lambda: rk.o0n_encode_intervals(syms, RATE)),
        "rans32_encode": event_ms(torch, lambda: rk.rans32_encode(lo, fr, lengths, cap)),
        "o0n_decode": event_ms(
            torch, lambda: rk.o0n_rans32_decode(words, lengths, t_len, RATE)),
    }
    nsym = int(lengths.sum().item())
    words_read = int(torch.clamp(nwords, max=cap).sum().item())
    moved = {
        "o0n_intervals": t_len * b * (1 + 4 + 4),
        "rans32_encode": nsym * 8 + b * 4 + b * cap * 2 + b * 4,
        "o0n_decode": words_read * 2 + b * 4 + t_len * b,
    }
    out = {}
    for name in ms:
        t_bytes = 1e3 * moved[name] / HBM_BYTES_PER_S
        t_ops = 1e3 * nsym * OPS_PER_SYMBOL[name] / INT32_OPS_PER_S
        out[name] = {
            "ms": ms[name],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        print(f"kernel {name} T={t_len} B={b}: {ms[name]:.3f} ms, bound "
              f"{out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']} "
              f"(bytes {t_bytes:.4f} ms, ops {t_ops:.4f} ms)", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from lac_tpu_torch import cli, smoke
    from lac_tpu_torch.ops import _build
    from lac_tpu_torch.ops import rans_kernels as rk
    from lac_tpu_torch.runtime import engine, turbo
    from lac_tpu_torch.stream import container

    dev = torch.device("cuda", 0)
    work = os.path.join(root, "smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        with Phase("phase 0: device and build"):
            smi = nvidia_smi_line()
            print(f"nvidia-smi: {smi}")
            print(f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
            t0 = time.perf_counter()
            _build.load_library()
            print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
            corpus = smoke.smoke_corpus()
            check(len(corpus) == smoke.SMOKE_BYTES, "corpus length")
            print(f"corpus {len(corpus)} bytes, crc32 {zlib.crc32(corpus)}")

        with Phase("phase 1: kernels against plain versions"):
            err, plain_ms = phase1(torch, rk, corpus, dev)

        with Phase("phase 2: main path"):
            torch.cuda.reset_peak_memory_stats()
            rk.reset_launches()
            containers = phase2(cli, engine, smoke, corpus, work)
            counts = dict(rk.launches)
            peak = torch.cuda.max_memory_allocated()
            print(f"main path launches {counts} over 2 compress + 2 decompress calls; "
                  f"max_memory_allocated {peak} bytes")
            for name, n in counts.items():
                check(n > 0, f"kernel {name} was not launched on the main path")

        with Phase("phase 3: numbers"):
            e2e(torch, engine, corpus)
            times = kernel_times(torch, rk, corpus, dev, BLOCK_SIZES[0])
            kernel_times(torch, rk, corpus, dev, BLOCK_SIZES[1])
            for bs, c in containers.items():
                print(f"bits/byte block {bs}: {8 * len(c) / len(corpus):.6f}")
                parse, rest, write = host_split(torch, turbo, container, c)
                print(f"host split block {bs}: decode = parse {parse:.1f} ms + "
                      f"decompress_parsed {rest:.1f} ms; encode ends with write "
                      f"{write:.1f} ms (medians of 3)")

        kernels = [
            {
                "name": name,
                "route": "cuda",
                "source": SOURCE,
                "replaces": REPLACES[name],
                "launches": counts[name],
                "max_abs_err": err[name],
                "ms": times[name]["ms"],
                "plain_ms": plain_ms[name],
                "bound_ms": times[name]["bound_ms"],
                "bound_by": times[name]["bound_by"],
                "library_ms": None,
            }
            for name in OPS_PER_SYMBOL
        ]
        print(json.dumps({"kernels": kernels}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
