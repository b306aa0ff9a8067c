import faulthandler; faulthandler.dump_traceback_later(900, exit=True)  # noqa: E702

# Drive lac_tpu_torch's main path on one CUDA card and check it.
#
#   python3 chip_smoke.py
#
# Phase 0  the card's name and power limit; build the CUDA kernels; the
#          launch shapes of the order0n (K1, K3), order1n (K4, K5) and
#          order2n (K6, K7) kernels; the HGMMA (wgmma) instructions in each
#          kernel's SASS (cuobjdump -sass): the bf16 K10-K12 must have some,
#          the f32 kernels have none; the integer opcodes of the innermost
#          loops of K1, K3, K4, K5, K6 and K7 (four steps of a lane; one
#          template over the hi rows and lo contexts: 1 and 16 for order0n,
#          16 and 16 for order1n, 16 and 64 for order2n) and of K8 and K9
#          (two steps).
# Phase 1  each kernel against its plain PyTorch version on the card, at the
#          shapes the main path gives it: T = 4096 and 1024 steps, with one
#          lane per block of the 32 MiB corpus (B = 8192 and 32768): corpus
#          lanes, seeded random lanes whose words overflow cap, ragged
#          lengths with 0, 1 and T-1, and one lane of a single repeated byte
#          (one context visited T times). For each of the four models: its
#          intervals kernel, K2 on those intervals, its decode kernel. Equal
#          integer for integer. Then order0c's three once more at the
#          fallback's block 8192 (T = 8192, B = 4096, cap 4099, where lac_tpu
#          decodes in chunks). K10-K12 at the training shape (B 64, H 8,
#          S 1024, D 64, bf16, the model's [B, S, H, D] storage) and at
#          B 16, then S 1000 and 257, D 128, f32 and the [B, H, S, D]
#          storage; then bf16 at the tile edges of the tensor-core K10-K12,
#          S 1, 63, 64, 65, 127, 128 and 129 at D 64 and 128 in both
#          storage orders.
# Phase 2  the main path of each model through its entry points, on the
#          32 MiB smoke corpus: the CLI at block 4096 (order0n at its
#          defaults, then --model order1n, order2n and order0c), then
#          engine.compress_bytes at block 1024; then order0n at block 8192
#          through turbo.turbo_compress, which records order0c (the codec
#          gate's fallback). Byte compare after decode, and each container's
#          crc32 and length against the golden values that lac_tpu's native
#          coder gives (lac_tpu_torch/smoke.py). The kernels' launch counts
#          are zeroed just before each path and read just after it.
#          Then the training path (slice 4), its attention through K10-K12
#          (bf16, so ops/csrc/causal_attn_sm90.cu; the byte-16l run must
#          launch the tensor-core entry points, and no scalar kernel): the
#          shipped byte-6l checkpoint's loss on smoke.lm_windows() through
#          the kernels (_FUSED "flash", then "splash") and the exact
#          branch, each within 2e-3 nats of
#          smoke.GOLDEN_LM; byte-16l at full width (d 512, 16 layers, 8
#          heads of 64, d_ff 2048; the recipe of tools/train_byte16l.py,
#          batch 64 x seq 1024, lr 3e-4, seed 0, max_seq 2048) trained 8
#          steps with the kernels (_FUSED "flash"), then the same 8 steps
#          from the same init with "bf16s" (no kernel), losses compared
#          step by step, its best-eval checkpoint reloaded bit-equal; and
#          the CLI's train at its defaults (byte-6l) for 3 steps at batch 8
#          x seq 256.
# Phase 3  numbers: end-to-end MB/s, host ms of decode's two parts (the
#          container parse and the rest) and of the container write, each
#          kernel's time from CUDA events beside its bound at each block the
#          main path codes at (4096, 1024; order0c's K8, K2, K9 also at the
#          fallback's 8192), beside the earlier K1-K9, bits per
#          byte, peak device memory; for the training path its
#          tokens/s, the attention kernels' share of a step, their plain
#          versions' and scaled_dot_product_attention's times at the
#          training shape.
# Phase 4  LM coding (slice 11; it reaches no TPU kernel, so K1-K12 must
#          not launch): (a) the CLI's compress --model lm at its defaults
#          (prng:byte-12l:0 at full width, block 512, 64 lanes, prob_bits
#          16, cache_grow 128, window mode auto) on the first 128 KiB of
#          the corpus, 256 blocks in 4 waves, then decompress, byte
#          compare, three times, timed, each container equal to the first,
#          and the header's resolved settings; (b) the shipped
#          byte-6l checkpoint through lm_compress_bytes at the same settings
#          on the first 32 KiB, round trip, bits/byte within 1 % of
#          smoke.GOLDEN_LM_BPB (lac_tpu's on the CPU); (c) determinism:
#          (a)'s first wave encoded twice gives the same words, which equal
#          (a)'s payloads, and a container the port made on the CPU is
#          refused on the card by its fingerprint; (d) numbers: encode and
#          decode tokens/s of (a) (median of its 3), ms a decode step, the
#          CUDA kernels one step launches (torch.profiler), peak device
#          memory, (b)'s bits/byte, and the least time a step could take
#          (bytes over HBM, flops over bf16).
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
# Integer lane-ops a second, over every pipe an integer instruction can
# take. Each of an SM's 4 schedulers issues one warp instruction (32 lanes)
# a cycle: to the 16-lane INT32 pipe (add, logic, shift, compare, select,
# min/max, byte permute) or, as IMAD (add, multiply, shift left), to the
# 16-lane FMA pipe. So no kernel runs more than 128 integer lanes a cycle an
# SM: 132 SMs x 128 x 1.98 GHz (the boost clock) = 33.45e12, half the 67
# TFLOP/s float32 peak, which counts an FMA's two flops on the same 128
# lanes.
INT_OPS_PER_S = 67e12 / 2
# Integer ops per coded symbol that the function needs, whatever a kernel
# spends beyond them, counting each add, shift, multiply, compare and select
# once, but a multiply and the add it feeds once (IMAD, IMAD.HI), and a u32
# divide or modulo once, as (32-bit ops, 16-bit ops). A 16-bit op counts a
# half: two 16-bit values share a 32-bit lane (packed halves, as K1 and
# K3-K9 hold them, or the DPX 16x2 forms). A state update (4: a shift and a subtract,
# or a subtract, a shift and an add, and the select) works on values below
# 2^16: a nibble state is at most 2^15, an order0c entry at most M = 65280.
# A nibble row's 17 states have constant ends (st[0] = 0 moves toward 0,
# st[16] = 2^15 toward 2^15), so 15 move. A nibble boundary
# ((st * 240) >> 15) + k is a shift (the state to the top half) and one
# IMAD.HI (times 480, plus k): 2. The rANS state is 32 bits, so boundaries,
# the search, intervals and the coder step count at 32.
#   K1 (25, 120): split the byte 2; the 4 boundaries either side of the two
#     nibbles 4 x 2; f_h, f_l 2; compose lo12 2 (a shift and an IMAD) and
#     f12 1; two rates 2 x 4 (four compares, four adds); one visit count 2;
#     16-bit: update the 15 moving states of the hi row and the visited lo
#     row 2 x 15 x 4.
#   K2 (7, 0): compare, shift, select, divide, modulo, rem + lo, and
#     q * 2^16 + that (an IMAD).
#   K3 (71, 120): slot and slot >> 8 2; a 4-probe binary search per nibble,
#     each probe a boundary and a compare and a select (hi 4 x 4, lo scaled
#     by f_h too 4 x 5); the boundaries either side of the hi nibble 2 x 2,
#     f_h 1, remainder 2; of the lo nibble 2 x 3, f12 1; the rANS step 3
#     (a shift, a subtract, an IMAD) and its refill 5; the output byte 1
#     (h * 16 + l); the same rates and count as K1 8 + 2; 16-bit: K1's 120
#     updates.
#   K4 (28, 120): K1's, plus the hi row's visit count 2 (the hi rate
#     replaces the step rate, so no more rates) and the hi row picked by
#     prev_h 1 (an IMAD to its address).
#   K6 (30, 120): K4's, plus the lo context h*4 + (prev_h >> 2) 2.
#   K5 (74, 120), K7 (76, 120): K3's plus what K4 and K6 add to K1.
# order0c moves all 256 entries of its joint-byte CDF every step; entry 0
# stays 0, so 255 move, each the same update toward 0 or toward M as a
# nibble state's, counted at the same 4.
#   K8 (15, 1020): the interval 7 (the two boundaries either side of the
#     byte, each an entry and an add, the top one an add more, the s = 255
#     select, the width); the rate 8; 16-bit: the 255 updates 1020.
#   K9 (47, 1020): slot 1; an 8-probe binary search, each probe a boundary
#     add, a compare and a select, 24; the interval 4 (the upper boundary 2,
#     the s = 255 select, the width); the rANS step 3 and its refill 5; the
#     output byte 2; K8's rate 8; 16-bit: K8's 1020 updates.
OPS_PER_SYMBOL = {
    "o0n_intervals": (25, 120), "rans32_encode": (7, 0), "o0n_decode": (71, 120),
    "o1n_intervals": (28, 120), "o1n_decode": (74, 120),
    "o2n_intervals": (30, 120), "o2n_decode": (76, 120),
    "o0c_intervals": (15, 1020), "o0c_decode": (47, 1020),
}

REPLACES = {
    "o0n_intervals": "lac_tpu/ops/pallas_rans.py:742",
    "rans32_encode": "lac_tpu/ops/pallas_rans.py:179",
    "o0n_decode": "lac_tpu/ops/pallas_rans.py:849",
    "o1n_intervals": "lac_tpu/ops/pallas_rans.py:1044",
    "o1n_decode": "lac_tpu/ops/pallas_rans.py:1148",
    "o2n_intervals": "lac_tpu/ops/pallas_rans.py:1277",
    "o2n_decode": "lac_tpu/ops/pallas_rans.py:1382",
    "o0c_intervals": "lac_tpu/ops/pallas_rans.py:113",
    # and _decode_chunk_kernel :493, the reference's decode for wide rows
    "o0c_decode": "lac_tpu/ops/pallas_rans.py:377",
}
SOURCE = {name: "lac_tpu_torch/ops/csrc/" + (
    "o0c_rans32.cu" if name.startswith("o0c")
    else "rans32_encode.cu" if name == "rans32_encode"
    else "nib_rans32.cu") for name in OPS_PER_SYMBOL}
# K10-K12, the training path's causal attention (ops/attention.py)
ATTN = ("causal_attn_fwd", "causal_attn_bwd_dkv", "causal_attn_bwd_dq")
# the main path's type is bf16: K10-K12 run on the tensor cores there
# (f32 inputs take causal_attn.cu's scalar kernels)
SOURCE.update({name: "lac_tpu_torch/ops/csrc/causal_attn_sm90.cu" for name in ATTN})
# the entry point each kernel's bf16 run launches
ATTN_SYMBOL = {"causal_attn_fwd": "lac_attn_fwd_sm90",
               "causal_attn_bwd_dkv": "lac_attn_bwd_dkv_sm90",
               "causal_attn_bwd_dq": "lac_attn_bwd_dq_sm90"}
# the scalar f32-FMA K10-K12 that bf16 ran on before the tensor-core kernels,
# at the training shape (CUDA events; H100 80GB HBM3, 700.00 W; PERF.md
# section 6)
EARLIER_MS = {"causal_attn_fwd": 3.435, "causal_attn_bwd_dkv": 6.082,
              "causal_attn_bwd_dq": 4.994}
# codec kernels before their redesigns, by block (CUDA events; H100 80GB
# HBM3, 700.00 W; PERF.md section 6): K2 with 128 lanes a block and its
# loads on the serial chain; K8 and K9 with one 32-bit entry a register and
# warp reductions for the interval and the search; K1 and K3-K7 with one
# thread a lane
EARLIER_CODEC_MS = {
    "o0n_intervals": {4096: 2.811, 1024: 0.836},
    "o0n_decode": {4096: 3.050, 1024: 1.103},
    "rans32_encode": {4096: 1.819, 1024: 0.670},
    "o1n_intervals": {4096: 2.846, 1024: 1.452},
    "o1n_decode": {4096: 3.005, 1024: 1.615},
    "o2n_intervals": {4096: 2.952, 1024: 3.146},
    "o2n_decode": {4096: 2.948, 1024: 2.966},
    "o0c_intervals": {4096: 4.574, 1024: 4.510, 8192: 4.693},
    "o0c_decode": {4096: 6.431, 1024: 6.306, 8192: 6.643},
}


def sm90_smem_bytes(name: str, d: int) -> int:
    """Dynamic shared bytes a block of the tensor-core K10, K11 or K12 at head
    dim d (fwd_smem, dkv_smem and dq_smem of causal_attn_sm90.cu): 1024 of
    alignment, the bf16 tiles (K10: Q of 128 rows, 2 stages of K and V of
    128 keys; K11: K and V of 128 keys, 2 stages of Q and dO of 64 queries
    with their f32 lse and di; K12: Q and dO of 128 rows, 2 stages of K and
    V of 128 keys at D 64, 64 at D 128) and 5 mbarriers."""
    if name == "causal_attn_fwd":
        return 1024 + 128 * d * 2 + 2 * 2 * 128 * d * 2 + 5 * 8
    if name == "causal_attn_bwd_dq":
        return 1024 + 2 * 128 * d * 2 + 2 * 2 * (128 if d == 64 else 64) * d * 2 + 5 * 8
    return 1024 + 2 * 128 * d * 2 + 2 * (2 * 64 * d * 2 + 2 * 64 * 4) + 5 * 8


# kernels that must contain HGMMA: the bf16 K10-K12 at D 64 and 128
WGMMA_KERNELS = tuple(f"{k}<{d}>" for k in ("causal_attn_fwd_sm90_kernel",
                                           "causal_attn_bwd_dkv_sm90_kernel",
                                           "causal_attn_bwd_dq_sm90_kernel")
                      for d in (64, 128))
# the JAX library Pallas kernels that lac_tpu's training attention reaches
# (JAX 0.9.0, jax/experimental/pallas/ops/tpu/; via lac_tpu/models/
# transformer.py:706-768); splash's are the same three at scale 1
REPLACES.update({
    "causal_attn_fwd": "jax/experimental/pallas/ops/tpu/flash_attention.py:589",
    "causal_attn_bwd_dkv": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
    "causal_attn_bwd_dq": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
})
# phase 1 shapes (B, H, S, D, dtype, storage) and the tolerances: max
# |kernel - plain| / max(max |plain|, 1) for O, dQ, dK, dV; lse absolute.
# f32: the same f32 math summed in another order. bf16: the outputs are
# rounded once to bf16 (2^-8 of the largest value) after f32 math.
ATTN_SHAPES = (
    (64, 8, 1024, 64, "bf16", "bshd"),  # the byte-16l training shape
    (16, 8, 1024, 64, "bf16", "bshd"),
    (4, 8, 1000, 64, "bf16", "bhsd"),
    (4, 4, 257, 128, "bf16", "bshd"),
    (4, 8, 1000, 128, "f32", "bshd"),
    (4, 4, 257, 64, "f32", "bhsd"),
    # the tile edges of the tensor-core K10 (128 queries, 128-key stages),
    # K11 (128 keys, 64-query stages) and K12 (128 queries, 128-key stages
    # at D 64, 64-key at D 128): every case of the causal mask and of a
    # ragged last tile
    *((2, 2, s, d, "bf16", layout) for s in (1, 63, 64, 65, 127, 128, 129)
      for d in (64, 128) for layout in ("bshd", "bhsd")),
)
ATTN_TOL = {"bf16": 1e-2, "f32": 1e-4}
LSE_TOL = 1e-4
# the training recipe of tools/train_byte16l.py:24-40, cut to 8 steps
TRAIN = dict(steps=8, batch=64, seq=1024, lr=3e-4, seed=0, eval_every=8, eval_batches=4)
TRAIN_BYTES = 24 << 20  # the smoke corpus up to here trains; the rest evaluates
# loss agreement of the kernels' run ("flash") with the "bf16s" run: steps 0
# and 1 run on the same parameters (the first update has lr 0), so only the
# attention's rounding differs (bf16s rounds scores and probabilities to
# bf16); later steps follow two Adam trajectories, whose first real update
# moves every parameter by about lr along the sign of its gradient.
STEP_TOL = {0: 2e-3, 1: 2e-3}
LATER_STEP_TOL = 2e-2
GOLDEN_TOL = 2e-3  # nats, the port's loss against lac_tpu's GOLDEN_LM
# H100 SXM dense peaks (NVIDIA's data sheet): bf16 tensor cores, f32 CUDA cores
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# model id -> the prefix of its kernels and wrappers in ops/rans_kernels.py
CODECS = {"order0n": "o0n", "order1n": "o1n", "order2n": "o2n", "order0c": "o0c"}
# the codec gate's fallback: order0n at block 8192 records order0c
FALLBACK = ("order0n", 8192, "order0c")
# the most words a lane may have for lac_tpu's fused order0c decode at its
# 2048-lane width (_fused_vmem_ok); it decodes wider rows in chunks
FUSED_MAX_WORDS = 2656
# phase 4, LM coding: (a) at the CLI's defaults on the first 128 KiB of the
# corpus (256 blocks of 512 tokens, 4 waves of 64 lanes)
LM_REF = "prng:byte-12l:0"
LM_CLI_BYTES = 128 << 10
LM_BPB_TOL = 0.01  # relative, the port's bits/byte against lac_tpu's
LM_REPS = 3


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
    syms_bt[3] = ord("e")  # one context visited T times: counts past 255
    syms_bt[8:72] = rng.integers(0, 256, (64, t_len), dtype=np.uint8)  # overflow cap
    lengths = np.full(b, t_len, dtype=np.int32)
    lengths[:3] = (0, 1, t_len - 1)
    lengths[72:200] = rng.integers(0, t_len + 1, 128)
    return np.ascontiguousarray(syms_bt.T), lengths


def max_abs_diff(torch, a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def phase1(torch, rk, corpus, dev):
    """Kernels against plain versions; returns (max_abs_err, plain_ms at the
    first shape) per kernel. After the two main shapes, order0c once more at
    the fallback's block 8192 (cap 4099), where lac_tpu decodes in chunks."""
    err = {k: 0 for k in OPS_PER_SYMBOL}
    plain_ms = {}
    for si, t_len in enumerate((*BLOCK_SIZES, FALLBACK[1])):
        codecs = CODECS.values() if t_len in BLOCK_SIZES else (CODECS[FALLBACK[2]],)
        b = len(corpus) // t_len
        syms_np, len_np = phase1_inputs(corpus, t_len, b)
        syms = torch.from_numpy(syms_np).to(dev)
        lengths = torch.from_numpy(len_np).to(dev)
        cap = t_len // 2 + 3
        t_idx = torch.arange(t_len, device=dev)[:, None]
        live = t_idx < lengths[None, :]
        for c in codecs:
            kin, kdec = f"{c}_intervals", f"{c}_decode"
            lo, fr = getattr(rk, f"{c}_encode_intervals")(syms, RATE)
            (plo, pfr), ms1 = sync_time(
                torch, lambda: getattr(rk, f"{c}_intervals_plain")(syms, RATE))
            e1 = max(max_abs_diff(torch, lo, plo), max_abs_diff(torch, fr, pfr))

            words, nwords = rk.rans32_encode(lo, fr, lengths, cap)
            (pwords, pnwords), ms2 = sync_time(
                torch, lambda: rk.rans32_encode_plain(lo, fr, lengths, cap))
            e2 = max(max_abs_diff(torch, words, pwords), max_abs_diff(torch, nwords, pnwords))
            check(bool((nwords > cap).any()), f"T={t_len} {c}: no lane overflowed cap")

            out = getattr(rk, f"{c}_rans32_decode")(words, lengths, t_len, RATE)
            pout, ms3 = sync_time(
                torch, lambda: getattr(rk, f"{c}_decode_plain")(words, lengths, t_len, RATE))
            e3 = max_abs_diff(torch, out, pout)

            # round trip on the lanes whose words fit cap; zeros past each length
            fits = (nwords <= cap)[None, :]
            check(bool(((out == syms) | ~live | ~fits).all()), f"T={t_len} {c}: round trip")
            check(bool(((out == 0) | live).all()), f"T={t_len} {c}: zeros past length")
            check(bool((out[:, 3] == syms[:, 3]).all()), f"T={t_len} {c}: single-byte lane")

            for name, e in ((kin, e1), ("rans32_encode", e2), (kdec, e3)):
                err[name] = max(err[name], e)
                check(e == 0, f"T={t_len} B={b}: {name} differs from its plain version by {e}")
            wide = ""
            if t_len == FALLBACK[1]:
                n = int(((nwords > FUSED_MAX_WORDS) & (nwords <= cap)).sum())
                check(n > 0, f"T={t_len}: no coded lane needs more than {FUSED_MAX_WORDS} words")
                wide = f"; {n} coded lanes need more than {FUSED_MAX_WORDS} words"
            print(f"T={t_len} B={b}: {kin}, rans32_encode, {kdec} equal to plain "
                  f"(plain ms {ms1:.1f} {ms2:.1f} {ms3:.1f}; "
                  f"{int((nwords > cap).sum())} lanes overflow cap {cap}{wide})", flush=True)
            if si == 0:
                plain_ms[kin], plain_ms[kdec] = ms1, ms3
                plain_ms.setdefault("rans32_encode", ms2)
    return err, plain_ms


def check_container(smoke, model, bs, c, corpus_len):
    got = smoke.container_digest(c)
    want = smoke.GOLDEN[(model, bs)]
    check(got == want, f"{model} block {bs}: container (crc32, len) {got} != golden {want}")
    print(f"{model} block {bs}: container crc32 {got[0]} len {got[1]} equals lac_tpu's; "
          f"{8 * len(c) / corpus_len:.4f} bits/byte", flush=True)


def phase2_fallback(turbo, container_mod, smoke, corpus):
    """order0n at block 8192 through turbo_compress: its codec gate records
    order0c; the container against its golden, decoded back."""
    model, bs, recorded = FALLBACK
    c = turbo.turbo_compress(corpus, block_size=bs, model=model)
    header, _ = container_mod.read_container(c)
    check(header.model_id == recorded, f"{model} block {bs} recorded {header.model_id}")
    check(turbo.turbo_decompress(c) == corpus, f"{model} block {bs}: round trip")
    check_container(smoke, recorded, bs, c, len(corpus))
    return c


def phase2(cli, engine, rk, smoke, model, corpus, work):
    """One model's main path: the CLI at block 4096 (the order0n path at the
    CLI's defaults), then the engine at block 1024. Returns the containers
    and the codec kernels' launches at each block."""
    path = os.path.join(work, f"{model}.bin")
    with open(path, "wb") as f:
        f.write(corpus)
    opts = [] if model == "order0n" else ["--model", model]
    check(cli.main(["compress", path, "-o", path + ".lac", *opts]) == 0, "cli compress")
    check(cli.main(["decompress", path + ".lac", "-o", path + ".out"]) == 0, "cli decompress")
    check(cli.main(["verify", path + ".lac"]) == 0, "cli verify")
    with open(path + ".out", "rb") as f:
        check(f.read() == corpus, f"{model}: cli round trip differs from the corpus")
    with open(path + ".lac", "rb") as f:
        c4096 = f.read()
    at4096 = dict(rk.launches)
    c1024 = engine.compress_bytes(corpus, model_id=model, block_size=1024)
    check(engine.decompress_bytes(c1024) == corpus, f"{model}: block 1024 round trip")
    for bs, c in ((4096, c4096), (1024, c1024)):
        check_container(smoke, model, bs, c, len(corpus))
    by_block = {4096: at4096, 1024: {k: n - at4096[k] for k, n in rk.launches.items()}}
    return {4096: c4096, 1024: c1024}, by_block


def e2e(torch, engine, model, corpus):
    for bs in BLOCK_SIZES:
        enc, dec = [], []
        for _ in range(E2E_REPS):
            c, ms = sync_time(torch, lambda: engine.compress_bytes(
                corpus, model_id=model, block_size=bs))
            enc.append(ms)
            out, ms = sync_time(torch, lambda: engine.decompress_bytes(c))
            dec.append(ms)
            check(out == corpus, f"{model} block {bs}: timed round trip")
        enc_mbs = len(corpus) / 1e6 / (float(np.median(enc)) / 1e3)
        dec_mbs = len(corpus) / 1e6 / (float(np.median(dec)) / 1e3)
        print(f"e2e {model} block {bs}: encode {enc_mbs:.1f} MB/s, decode {dec_mbs:.1f} MB/s "
              f"(median of {E2E_REPS}; encode ms {[round(x, 1) for x in enc]}, "
              f"decode ms {[round(x, 1) for x in dec]})", flush=True)


def host_split(torch, turbo, container_mod, c):
    """Host ms, median of 3, of the parts of the path for container ``c``:
    the parse that decode starts with (``read_container``), the decode after
    it (``turbo.decompress_parsed``, the decode kernel and its copies
    included), and the ``write_container`` that encode ends with."""
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


def kernel_times(torch, rk, corpus, dev, t_len, codecs=tuple(CODECS.values())):
    """Event times and bounds of the kernels of ``codecs`` and K2 on the main
    path's inputs at block ``t_len`` (all of the corpus, one lane per block).
    K2 is timed on the first codec's intervals (order0n's at blocks 4096 and
    1024, order0c's at the fallback's 8192)."""
    b = len(corpus) // t_len
    syms = torch.from_numpy(
        np.frombuffer(corpus, dtype=np.uint8).reshape(b, t_len).T.copy()).to(dev)
    lengths = torch.full((b,), t_len, dtype=torch.int32, device=dev)
    cap = t_len // 2 + 3
    nsym = int(lengths.sum().item())
    ms, moved = {}, {}
    for c in codecs:
        intervals = getattr(rk, f"{c}_encode_intervals")
        decode = getattr(rk, f"{c}_rans32_decode")
        lo, fr = intervals(syms, RATE)
        words, nwords = rk.rans32_encode(lo, fr, lengths, cap)
        ms[f"{c}_intervals"] = event_ms(torch, lambda: intervals(syms, RATE))
        moved[f"{c}_intervals"] = t_len * b * (1 + 4 + 4)
        if c == codecs[0]:
            ms["rans32_encode"] = event_ms(
                torch, lambda: rk.rans32_encode(lo, fr, lengths, cap))
            moved["rans32_encode"] = nsym * 8 + b * 4 + b * cap * 2 + b * 4
        ms[f"{c}_decode"] = event_ms(torch, lambda: decode(words, lengths, t_len, RATE))
        words_read = int(torch.clamp(nwords, max=cap).sum().item())
        moved[f"{c}_decode"] = words_read * 2 + b * 4 + t_len * b
    out = {}
    for name in ms:
        t_bytes = 1e3 * moved[name] / HBM_BYTES_PER_S
        ops32, ops16 = OPS_PER_SYMBOL[name]
        t_ops = 1e3 * nsym * (ops32 + ops16 / 2) / INT_OPS_PER_S
        out[name] = {
            "ms": ms[name],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        earlier = EARLIER_CODEC_MS.get(name, {}).get(t_len)
        print(f"kernel {name} T={t_len} B={b}: {ms[name]:.3f} ms, bound "
              f"{out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']} "
              f"(bytes {t_bytes:.4f} ms, ops {t_ops:.4f} ms; "
              f"{ms[name] / out[name]['bound_ms']:.2f}x the bound)"
              + (f"; the earlier kernel {earlier} ms, {earlier / ms[name]:.2f}x"
                 if earlier else ""), flush=True)
    return out


# --------------------------------------------------------------------------
# The training path: K10-K12 and the port's byte-LM training
# --------------------------------------------------------------------------


def attn_inputs(torch, b, h, s, d, dtype, layout, dev, seed=SEED):
    """q, k, v, dO [B, H, S, D] on the card, stored as ``layout``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32

    def one():
        x = (torch.randn((b, s, h, d), generator=g, device=dev) * 2.0).to(dt)
        return x.transpose(1, 2) if layout == "bshd" else x.transpose(1, 2).contiguous()

    return one(), one(), one(), one()


def rel_err(torch, got, want) -> tuple:
    """(max abs error, max abs error / max(max |want|, 1))."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1.0)


def phase1_attention(torch, A, dev):
    """K10-K12 against their plain versions at ATTN_SHAPES; returns
    (max abs error per kernel, plain ms per kernel at the first shape)."""
    err = {k: 0.0 for k in ATTN}
    plain_ms = {}
    for si, (b, h, s, d, dtype, layout) in enumerate(ATTN_SHAPES):
        q, k, v, do = attn_inputs(torch, b, h, s, d, dtype, layout, dev)
        scale = d ** -0.5
        o, lse = A.causal_attn_fwd(q, k, v, scale)
        (po, plse), ms_f = sync_time(torch, lambda: A.attention_plain_fwd(q, k, v, scale))
        di = A._di(po, do)
        dk, dv = A.causal_attn_bwd_dkv(q, k, v, do, plse, di, scale)
        (pdk, pdv), ms_kv = sync_time(
            torch, lambda: A.attention_plain_bwd_dkv(q, k, v, do, plse, di, scale))
        dq = A.causal_attn_bwd_dq(q, k, v, do, plse, di, scale)
        pdq, ms_q = sync_time(
            torch, lambda: A.attention_plain_bwd_dq(q, k, v, do, plse, di, scale))
        torch.cuda.synchronize()
        lse_err = float((lse - plse).abs().max())
        rows = {"causal_attn_fwd": [("O", o, po)],
                "causal_attn_bwd_dkv": [("dK", dk, pdk), ("dV", dv, pdv)],
                "causal_attn_bwd_dq": [("dQ", dq, pdq)]}
        tol = ATTN_TOL[dtype]
        parts = []
        for name, outs in rows.items():
            for label, got, want in outs:
                e, r = rel_err(torch, got, want)
                err[name] = max(err[name], e)
                parts.append(f"{label} {r:.2e}")
                check(r <= tol, f"{name} B={b} H={h} S={s} D={d} {dtype}: {label} rel err "
                                f"{r:.3e} > {tol}")
        check(lse_err <= LSE_TOL, f"causal_attn_fwd S={s} D={d} {dtype}: lse err {lse_err}")
        print(f"attention B={b} H={h} S={s} D={d} {dtype} {layout}: K10-K12 within {tol} "
              f"of plain ({', '.join(parts)}; lse {lse_err:.2e}; plain ms {ms_f:.1f} "
              f"{ms_kv:.1f} {ms_q:.1f})", flush=True)
        if si == 0:
            plain_ms = {"causal_attn_fwd": ms_f, "causal_attn_bwd_dkv": ms_kv,
                        "causal_attn_bwd_dq": ms_q}
    return err, plain_ms


def phase2_golden(torch, T, A, ttrain, smoke, root, dev):
    """The shipped byte-6l checkpoint's loss on the golden windows, through
    K10 (impl flash, then splash, fused) and through the exact branch;
    returns the kernels' launch counts on the flash run."""
    path = os.path.join(root, smoke.LM_CHECKPOINT)
    check(os.path.exists(path), f"{smoke.LM_CHECKPOINT} did not reach this machine")
    cfg, model = ttrain.load_checkpoint(path)
    toks = torch.from_numpy(smoke.lm_windows()).to(dev)
    want = smoke.GOLDEN_LM["byte6l-pysrc"]
    out = {}
    for label, impl, fused in (("flash kernels", "flash", True),
                               ("splash kernels", "splash", True),
                               ("exact branch", "bf16s", False)):
        T._FUSED["impl"] = impl
        A.reset_launches()
        with torch.no_grad():
            loss = ttrain.lm_loss(cfg, model, toks, fused=fused).item()
        counts = dict(A.launches)
        d = loss - want
        print(f"golden byte6l-pysrc, {label}: loss {loss:.6f} nats, lac_tpu {want:.6f}, "
              f"diff {d:+.2e} (tolerance {GOLDEN_TOL}); launches {counts}", flush=True)
        check(abs(d) <= GOLDEN_TOL, f"byte-6l loss with the {label} off GOLDEN_LM by {d}")
        if fused:
            check(counts["causal_attn_fwd"] == cfg.n_layers, f"K10 launches {counts}")
            out = out or counts
    T._FUSED["impl"] = "bf16s"
    return out


def timed_steps(torch, ttrain):
    """Wrap ttrain._step to record each step's ms (host clock, synchronized);
    returns the list and a function that restores the step."""
    real = ttrain._step
    times = []

    def step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        return out

    ttrain._step = step
    return times, lambda: setattr(ttrain, "_step", real)


def phase2_train(torch, T, A, ttrain, registry, corpus, work, dev):
    """byte-16l at full width, 8 steps through K10-K12, then 8 steps from the
    same init through bf16s; returns (launch counts of the kernels' run,
    step ms of that run, peak bytes of that run, the config)."""
    import dataclasses

    cfg = dataclasses.replace(registry.PRESETS["byte-16l"](), max_seq=2048)
    init = T.init_params(cfg, seed=TRAIN["seed"], device=dev)
    ckpt = os.path.join(work, "byte16l.npz")
    kw = dict(TRAIN, log_every=1, eval_corpus=corpus[TRAIN_BYTES:], init=init,
              fused_attn=True)
    runs = {}
    for impl in ("flash", "bf16s"):
        T._FUSED["impl"] = impl
        A.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        times, restore = timed_steps(torch, ttrain)
        try:
            params, losses = ttrain.train_byte_lm(
                cfg, corpus[:TRAIN_BYTES], save_best_path=ckpt if impl == "flash" else None,
                **kw)
        finally:
            restore()
        torch.cuda.synchronize()
        runs[impl] = dict(params=params, losses=losses, launches=dict(A.launches),
                          symbols=dict(A.symbol_launches), ms=times,
                          peak=torch.cuda.max_memory_allocated())
        med = float(np.median(times[1:]))
        print(f"byte-16l {impl}: losses {[round(x, 5) for x in losses]}; step ms "
              f"{[round(x, 1) for x in times]}, median of steps 1-{len(times) - 1} {med:.1f} "
              f"({TRAIN['batch'] * TRAIN['seq'] / (med / 1e3):.1f} tokens/s); launches "
              f"{runs[impl]['launches']}; max_memory_allocated {runs[impl]['peak']} bytes",
              flush=True)
    T._FUSED["impl"] = "bf16s"
    fl, bs = runs["flash"], runs["bf16s"]
    check(len(fl["losses"]) == TRAIN["steps"] and all(np.isfinite(fl["losses"])),
          f"byte-16l losses {fl['losses']}")
    for i, (a, b) in enumerate(zip(fl["losses"], bs["losses"])):
        tol = STEP_TOL.get(i, LATER_STEP_TOL)
        check(abs(a - b) <= tol, f"byte-16l step {i}: flash {a} vs bf16s {b} (tolerance {tol})")
    print(f"byte-16l: flash and bf16s losses agree, max diff steps 0-1 "
          f"{max(abs(a - b) for a, b in zip(fl['losses'][:2], bs['losses'][:2])):.2e}, "
          f"later {max(abs(a - b) for a, b in zip(fl['losses'][2:], bs['losses'][2:])):.2e}",
          flush=True)
    n = cfg.n_layers
    steps, evals = TRAIN["steps"], TRAIN["eval_batches"]
    want = {"causal_attn_fwd": steps * 2 * n + evals * n, "causal_attn_bwd_dkv": steps * n,
            "causal_attn_bwd_dq": steps * n}
    check(fl["launches"] == want, f"byte-16l launches {fl['launches']}, expected {want}")
    # bf16 training: K10 and K11 are the tensor-core entry points, all of them
    want_sym = {ATTN_SYMBOL[k]: n for k, n in want.items()}
    got_sym = {k: n for k, n in fl["symbols"].items() if n}
    check(got_sym == want_sym, f"byte-16l entry points {got_sym}, expected {want_sym}")
    print(f"byte-16l flash entry points: {got_sym}", flush=True)
    check(set(bs["launches"].values()) == {0}, f"bf16s launched kernels: {bs['launches']}")
    lcfg, loaded = ttrain.load_checkpoint(ckpt)
    check(lcfg == dataclasses.replace(cfg, max_seq=TRAIN["seq"]), f"saved config {lcfg}")
    same = all(torch.equal(a, b) for a, b in zip(loaded.parameters(), fl["params"].parameters()))
    check(same, "the saved byte-16l checkpoint does not reload bit-equal")
    print(f"byte-16l: best-eval checkpoint {os.path.getsize(ckpt)} bytes reloads bit-equal",
          flush=True)
    return fl["launches"], fl["ms"], fl["peak"], cfg


def phase2_cli(cli, A, ttrain, corpus, work):
    """The CLI's train at its defaults (byte-6l) for 3 steps; its output
    loads. Like lac_tpu's, it leaves the fused attention off."""
    path = os.path.join(work, "train.bin")
    with open(path, "wb") as f:
        f.write(corpus[: 4 << 20])
    out = os.path.join(work, "cli_lm.npz")
    A.reset_launches()
    check(cli.main(["train", path, "-o", out, "--steps", "3", "--batch", "8",
                    "--seq", "256"]) == 0, "cli train")
    counts = dict(A.launches)
    cfg, model = ttrain.load_checkpoint(out)
    check(cfg.n_layers == 6 and cfg.max_seq == 256, f"cli train saved {cfg}")
    print(f"cli train byte-6l: {os.path.getsize(out)} bytes, loads; launches {counts}",
          flush=True)
    return counts


def attn_bounds(b, h, s, d, dtype) -> dict:
    """Least ms of each of K10-K12 on its inputs: the larger of its bytes
    (each input read once, each output written once) over HBM_BYTES_PER_S
    and its flops over the peak for the type. One causal product of
    [S, D] by [D, S] needs D S (S + 1) flops per (b, h): K10 two (scores,
    PV), K11 four (scores, dP, dV, dK), K12 three (scores, dP, dQ)."""
    es = 2 if dtype == "bf16" else 4
    t = b * h * s * d * es  # one [B, H, S, D] tensor
    r = b * h * s * 4       # one f32 [B, H, S] row vector (lse, di)
    prod = b * h * d * s * (s + 1)
    work = {"causal_attn_fwd": (3 * t + t + r, 2 * prod),
            "causal_attn_bwd_dkv": (4 * t + 2 * r + 2 * t, 4 * prod),
            "causal_attn_bwd_dq": (4 * t + 2 * r + t, 3 * prod)}
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * flops / PEAK_FLOPS[dtype]
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "t_bytes": t_bytes, "t_ops": t_ops, "flops": flops}
    return out


def attn_times(torch, A, dev, cfg):
    """K10-K12, their plain versions and scaled_dot_product_attention at the
    training shape (B 64, H 8, S 1024, D 64, bf16, [B, S, H, D] storage)."""
    import torch.nn.functional as F

    b, h, s, d = TRAIN["batch"], cfg.n_heads, TRAIN["seq"], cfg.head_dim
    q, k, v, do = attn_inputs(torch, b, h, s, d, "bf16", "bshd", dev)
    scale = d ** -0.5
    o, lse = A.causal_attn_fwd(q, k, v, scale)
    di = A._di(o, do)
    ms = {"causal_attn_fwd": event_ms(torch, lambda: A.causal_attn_fwd(q, k, v, scale)),
          "causal_attn_bwd_dkv": event_ms(
              torch, lambda: A.causal_attn_bwd_dkv(q, k, v, do, lse, di, scale)),
          "causal_attn_bwd_dq": event_ms(
              torch, lambda: A.causal_attn_bwd_dq(q, k, v, do, lse, di, scale))}
    _, pf = sync_time(torch, lambda: A.attention_plain_fwd(q, k, v, scale))
    _, pkv = sync_time(torch, lambda: A.attention_plain_bwd_dkv(q, k, v, do, lse, di, scale))
    _, pq = sync_time(torch, lambda: A.attention_plain_bwd_dq(q, k, v, do, lse, di, scale))
    plain = {"causal_attn_fwd": pf, "causal_attn_bwd_dkv": pkv, "causal_attn_bwd_dq": pq}
    # the library yardstick: SDPA's forward for K10; its backward alone (one
    # autograd call computing dQ, dK and dV) for K11 and K12 together
    sdpa_f = event_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_b = event_ms(torch, lambda: torch.autograd.grad(og, (qg, kg, vg), do,
                                                         retain_graph=True))
    library = {"causal_attn_fwd": sdpa_f, "causal_attn_bwd_dkv": sdpa_b,
               "causal_attn_bwd_dq": sdpa_b}
    bounds = attn_bounds(b, h, s, d, "bf16")
    out = {}
    for name in ATTN:
        out[name] = dict(ms=ms[name], plain_ms=plain[name], library_ms=library[name],
                         bound_ms=bounds[name]["bound_ms"], bound_by=bounds[name]["bound_by"])
        print(f"kernel {name} B={b} H={h} S={s} D={d} bf16: {ms[name]:.3f} ms, bound "
              f"{bounds[name]['bound_ms']:.4f} ms by {bounds[name]['bound_by']} (bytes "
              f"{bounds[name]['t_bytes']:.4f} ms, ops {bounds[name]['t_ops']:.4f} ms); "
              f"{bounds[name]['flops'] / ms[name] / 1e9:.1f} TFLOP/s of the function's "
              f"{bounds[name]['flops'] / 1e9:.2f} GFLOP; "
              f"plain {plain[name]:.1f} ms; sdpa {library[name]:.3f} ms"
              + (f"; the earlier scalar kernel {EARLIER_MS[name]} ms, "
                 f"{EARLIER_MS[name] / ms[name]:.2f}x" if name in EARLIER_MS else ""),
              flush=True)
    print(f"sdpa forward {sdpa_f:.3f} ms, backward {sdpa_b:.3f} ms; K10-K12 "
          f"{sum(ms.values()):.3f} ms", flush=True)
    return out


# --------------------------------------------------------------------------
# Phase 4: LM coding (the cached decode step, the integer CDF, rANS-64/32,
# the container round trip)
# --------------------------------------------------------------------------


def phase4_cli(torch, cli, container_mod, corpus, work):
    """(a): the CLI at its LM defaults, compress then decompress, LM_REPS
    times, each pair timed on the host clock around a synchronize; every
    container must equal the first. Returns (the container, its waves,
    encode ms, decode ms)."""
    data = corpus[:LM_CLI_BYTES]
    path = os.path.join(work, "lm.bin")
    with open(path, "wb") as f:
        f.write(data)
    first, enc, dec = None, [], []
    for _ in range(LM_REPS):
        rc, ms = sync_time(torch, lambda: cli.main(["compress", path, "--model", "lm", "-o",
                                                    path + ".lac"]))
        check(rc == 0, "cli compress --model lm")
        enc.append(ms)
        rc, ms = sync_time(torch, lambda: cli.main(["decompress", path + ".lac", "-o",
                                                    path + ".out"]))
        check(rc == 0, "cli decompress of the lm container")
        dec.append(ms)
        with open(path + ".out", "rb") as f:
            check(f.read() == data, "lm: cli round trip differs from the corpus")
        with open(path + ".lac", "rb") as f:
            c = f.read()
        check(first is None or c == first, "lm: a repeated cli compress wrote another container")
        first = first or c
    header, blocks = container_mod.read_container(first)
    cfg = header.config
    want = {"model_ref": LM_REF, "block_tokens": 512, "lanes": 64, "cache_grow": 128,
            "window_mode": "slide", "slide_seg": 0, "max_seq": 1024}
    got = {k: cfg[k] for k in want}
    check(got == want and header.prob_bits == 16 and len(blocks) == 256,
          f"lm container header {got}, prob_bits {header.prob_bits}, {len(blocks)} blocks")
    waves = -(-len(blocks) // cfg["lanes"])
    raw = sum(b.token_count == 0 for b in blocks)
    print(f"lm (a) cli: {len(data)} -> {len(first)} bytes "
          f"({8 * len(first) / len(data):.4f} bits/byte, random weights), {len(blocks)} blocks "
          f"in {waves} waves, {raw} stored raw; header {got}, prob_bits {header.prob_bits}; "
          f"{LM_REPS} round trips equal, {LM_REPS} containers equal", flush=True)
    return first, waves, enc, dec


def phase4_trained(ttrain, lm_api, smoke, root, corpus):
    """(b): the shipped byte-6l checkpoint at the CLI's settings; returns its
    bits/byte."""
    path = os.path.join(root, smoke.LM_CHECKPOINT)
    model = ttrain.load_checkpoint(path)
    data = corpus[: smoke.LM_BPB_BYTES]
    c = lm_api.lm_compress_bytes(data, model_ref="file:" + smoke.LM_CHECKPOINT, model=model,
                                 **smoke.LM_CODING)
    check(lm_api.lm_decompress_bytes(c, model=model) == data, "lm (b): byte-6l round trip")
    bpb = 8 * len(c) / len(data)
    rel = bpb / smoke.GOLDEN_LM_BPB - 1
    print(f"lm (b) byte-6l: {len(data)} -> {len(c)} bytes, {bpb:.6f} bits/byte, lac_tpu "
          f"{smoke.GOLDEN_LM_BPB:.6f} (relative {rel:+.2e}, tolerance {LM_BPB_TOL}); "
          f"round trip equal", flush=True)
    check(abs(rel) <= LM_BPB_TOL, f"lm (b): bits/byte {bpb} off GOLDEN_LM_BPB by {rel:+.3e}")
    return bpb


def phase4_determinism(torch, lm_api, lm_engine, registry, container_mod, corpus, c_a, model):
    """(c): (a)'s first wave encoded twice, equal words equal to (a)'s
    payloads; a CPU container refused on the card."""
    cfg, params = model
    _, blocks = container_mod.read_container(c_a)
    lanes, bt = 64, 512
    toks = np.frombuffer(corpus[: lanes * bt], dtype=np.uint8).reshape(lanes, bt)
    tokens = torch.from_numpy(toks.astype(np.int64)).cuda()
    lengths = torch.full((lanes,), bt, dtype=torch.int64, device="cuda")
    w1, n1 = lm_engine.lm_encode(cfg, params, tokens, lengths, 16, 128)
    w2, n2 = lm_engine.lm_encode(cfg, params, tokens, lengths, 16, 128)
    check(torch.equal(w1, w2) and torch.equal(n1, n2), "lm (c): two encodes of wave 0 differ")
    words, nwords = w1.cpu().numpy(), n1.cpu().numpy()
    coded = 0
    for j in range(lanes):
        if blocks[j].token_count:
            coded += 1
            check(words[j, : nwords[j]].astype(">u4").tobytes() == blocks[j].payload,
                  f"lm (c): wave 0 lane {j} differs from the cli container's block")
    cpu_model = registry.resolve_lm(LM_REF, device="cpu")
    c_cpu = lm_api.lm_compress_bytes(corpus[:256], model_ref=LM_REF, model=cpu_model,
                                     block_tokens=64, lanes=4, device="cpu")
    check(lm_api.lm_decompress_bytes(c_cpu, model=cpu_model, device="cpu") == corpus[:256],
          "lm (c): the cpu container's round trip on the cpu")
    try:
        lm_api.lm_decompress_bytes(c_cpu)
    except ValueError as e:
        check("fingerprint mismatch" in str(e), f"lm (c): wrong refusal {e}")
        refusal = str(e)
    else:
        raise RuntimeError("check failed: the card decoded the port's cpu container")
    print(f"lm (c): wave 0 encoded twice, equal ({int(nwords.sum())} words), and equal to "
          f"the cli container's {coded} coded blocks of wave 0; a cpu container "
          f"(block 64, 4 lanes) round-trips on the cpu and the card refuses it: {refusal}",
          flush=True)


def lm_step_bound(torch, cfg, params, b: int, width: float) -> dict:
    """Least ms of one lock-step decode step of ``b`` lanes at cache width
    ``width``: every weight read once (the embedding table only its b rows),
    the K/V cache read once and the new K/V written once, over
    HBM_BYTES_PER_S; against the step's flops (2 a multiply-add of every
    product) over the bf16 peak."""
    es = torch.finfo(cfg.dtype).bits // 8
    weights = sum(p.numel() * p.element_size() for name, p in params.named_parameters()
                  if name not in ("embed", "pos_embed"))
    emb = b * cfg.d_model * es * (2 if cfg.pos_embedding == "learned" else 1)
    head = cfg.vocab * cfg.d_model * es if cfg.tie_embeddings else 0
    kv_row = 2 * cfg.n_layers * b * cfg.n_kv_heads * cfg.head_dim * es
    nbytes = weights + emb + head + kv_row * width + kv_row
    macs = sum(p.numel() for name, p in params.named_parameters()
               if p.dim() == 2 and name not in ("embed", "pos_embed")) * b
    macs += (cfg.vocab * cfg.d_model * b) if cfg.tie_embeddings else 0
    macs += 2 * cfg.n_layers * b * cfg.n_heads * (width + 1) * cfg.head_dim
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * 2 * macs / PEAK_FLOPS["bf16"]
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "bytes": nbytes, "weights": weights,
            "kv": kv_row * width, "flops": 2 * macs, "t_bytes": t_bytes, "t_ops": t_ops}


def decode_steps(torch, lm_engine, vector, T, cfg, params, b: int, width: int, n: int):
    """``n`` decode steps (model, integer CDF, rANS step) at cache width
    ``width``, each with pos ``width - 1``, as a function of the cache."""
    dev = params.embed.device
    cache = T.init_cache(cfg, b, width, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    words = torch.randint(0, 1 << 32, (b, 514), generator=g, device=dev, dtype=torch.int64)
    active = torch.ones((b,), dtype=torch.bool, device=dev)
    state = [torch.zeros((b,), dtype=torch.int64, device=dev), vector.rans_decode_init(words)]

    def run():
        for _ in range(n):
            cache["pos"] = width - 1
            cdf, _ = lm_engine._step_cdf(cfg, params, cache, state[0], 16)
            state[0], state[1] = vector._decode_step(state[1], cdf, 16, active)

    return run


def profile_step(torch, lm_engine, vector, T, cfg, params, b: int, width: int):
    """One decode step at cache width ``width`` under torch.profiler, and 20
    without it: (CUDA kernels, memcpy/memset activities, device busy ms of
    the profiled step, host ms a step of the 20, host clock around a
    synchronize)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    one = decode_steps(torch, lm_engine, vector, T, cfg, params, b, width, 1)
    twenty = decode_steps(torch, lm_engine, vector, T, cfg, params, b, width, 20)
    with lm_engine._coding(params.embed.device):
        one()
        _, ms = sync_time(torch, twenty)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mem = [e for e in dev_events if e.name.lower().startswith(("memcpy", "memset"))]
    busy_us = sum(getattr(e, "device_time", 0) or 0 for e in dev_events)
    return len(dev_events) - len(mem), len(mem), busy_us / 1e3, ms / 20


def phase4_numbers(torch, lm_engine, vector, T, container_mod, smoke, c_a, waves, enc, dec,
                   peak, model, smi):
    """(d): tokens/s of (a) (median of its LM_REPS timed round trips), ms a
    decode step, the kernels a step launches, peak memory, the bound of a
    step."""
    cfg, params = model
    kw = dict(smoke.LM_CODING)
    b, bt = kw["lanes"], kw["block_tokens"]
    _, blocks = container_mod.read_container(c_a)
    # decode skips a wave whose blocks are all stored raw
    coded_waves = sum(any(blk.token_count for blk in blocks[w0 : w0 + b])
                      for w0 in range(0, len(blocks), b))
    enc_ms, dec_ms = float(np.median(enc)), float(np.median(dec))
    widths = [w for _, n, w in lm_engine._grown_segments(bt, kw["cache_grow"]) for _ in range(n)]
    mean_w = float(np.mean(widths))
    bound = lm_step_bound(torch, cfg, params, b, mean_w)
    kernels, mem, busy_ms, step_ms = profile_step(torch, lm_engine, vector, T, cfg, params, b,
                                                  int(round(mean_w)))
    print(f"lm (d) [{smi}] byte-12l, {b} lanes, block {bt}, cache_grow {kw['cache_grow']}, "
          f"through the cli: encode {LM_CLI_BYTES / (enc_ms / 1e3):.1f} tokens/s ({waves} "
          f"waves, {enc_ms / (waves * bt):.3f} ms a step), decode "
          f"{LM_CLI_BYTES / (dec_ms / 1e3):.1f} tokens/s ({coded_waves} of {waves} waves hold "
          f"a coded block and run, {dec_ms / max(1, coded_waves * bt):.3f} ms a step); median "
          f"of {LM_REPS}; encode ms {[round(x, 1) for x in enc]}, decode ms "
          f"{[round(x, 1) for x in dec]}", flush=True)
    print(f"lm (d) [{smi}] decode step at the schedule's mean cache width {mean_w:.0f}: "
          f"{step_ms:.3f} ms (20 steps, host clock); under torch.profiler one step launches "
          f"{kernels} CUDA kernels and {mem} memcpy/memset, device busy {busy_ms:.3f} ms "
          f"({100 * (1 - busy_ms / step_ms):.1f} % of the unprofiled step idle)", flush=True)
    print(f"lm (d) [{smi}] step bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
          f"(bytes {bound['bytes'] / 1e6:.1f} MB: weights {bound['weights'] / 1e6:.1f} MB, "
          f"K/V at width {mean_w:.0f} {bound['kv'] / 1e6:.1f} MB, {bound['t_bytes']:.4f} ms; "
          f"flops {bound['flops'] / 1e9:.2f} G, {bound['t_ops']:.4f} ms), "
          f"{b / (bound['bound_ms'] / 1e3):.0f} tokens/s; the step is "
          f"{step_ms / bound['bound_ms']:.1f}x the bound; max_memory_allocated over (a) "
          f"{peak} bytes", flush=True)

def path_kernels(codec: str) -> tuple:
    return (f"{codec}_intervals", "rans32_encode", f"{codec}_decode")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from lac_tpu_torch import cli, smoke
    from lac_tpu_torch import train as ttrain
    from lac_tpu_torch.coder import vector
    from lac_tpu_torch.models import lm_registry
    from lac_tpu_torch.models import transformer as T
    from lac_tpu_torch.ops import _build
    from lac_tpu_torch.ops import attention as A
    from lac_tpu_torch.ops import rans_kernels as rk
    from lac_tpu_torch.runtime import engine, lm_api, lm_engine, turbo
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
            lib = _build.load_library()
            print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
            for model, c in (("order0n", "o0n"), ("order1n", "o1n"), ("order2n", "o2n")):
                print(f"{model} kernels ({c}_intervals, {c}_decode): {lib.lac_nib_lanes()} "
                      f"lanes of 4 threads a block, "
                      f"{getattr(lib, f'lac_{c}_intervals_shared_bytes')()} / "
                      f"{getattr(lib, f'lac_{c}_decode_shared_bytes')()} shared bytes a block")
            for name in ATTN:
                print(f"{name} bf16 (tensor cores): 384 threads, "
                      f"{sm90_smem_bytes(name, 64)} / {sm90_smem_bytes(name, 128)} dynamic "
                      f"shared bytes a block at D 64 / 128")
            for kid, name in zip((10, 11, 12), ATTN):
                print(f"{name} f32 (scalar): 256 threads, "
                      f"{lib.lac_attn_smem_bytes(kid, 64)} / "
                      f"{lib.lac_attn_smem_bytes(kid, 128)} dynamic shared bytes a block "
                      f"at D 64 / 128")
            hgmma = {k: v["HGMMA"] for k, v in _build.sass_counts(lib, ("HGMMA",)).items()}
            print(f"HGMMA instructions in each kernel's SASS: {hgmma}")
            for name in WGMMA_KERNELS:
                check(hgmma.get(name, 0) > 0, f"{name} has no HGMMA in its SASS")
            print(f"kernels without HGMMA (the f32 K10-K12, the codecs): "
                  f"{sorted(k for k, n in hgmma.items() if n == 0)}")
            loops = _build.sass_counts(lib, _build.INT_OPCODES, inner_loop=True)
            group = "four steps of a lane, 4 threads"
            for name, what in (("nib_intervals_kernel<1, 16>", f"K1, {group}"),
                               ("nib_decode_kernel<1, 16>", f"K3, {group}"),
                               ("nib_intervals_kernel<16, 16>", f"K4, {group}"),
                               ("nib_decode_kernel<16, 16>", f"K5, {group}"),
                               ("nib_intervals_kernel<16, 64>", f"K6, {group}"),
                               ("nib_decode_kernel<16, 64>", f"K7, {group}"),
                               ("o0c_intervals_kernel", "two steps of the model, 8 entries "
                                                        "a thread"),
                               ("o0c_decode_kernel", "two steps of the model, 16 entries "
                                                     "a thread")):
                check(loops.get(name, {}).get("all", 0) > 0,
                      f"{name}: no loop found in its SASS")
                print(f"{name} innermost loop ({what}): {loops[name]}", flush=True)
            corpus = smoke.smoke_corpus()
            check(len(corpus) == smoke.SMOKE_BYTES, "corpus length")
            print(f"corpus {len(corpus)} bytes, crc32 {zlib.crc32(corpus)}")

        with Phase("phase 1: kernels against plain versions"):
            err, plain_ms = phase1(torch, rk, corpus, dev)
            aerr, aplain = phase1_attention(torch, A, dev)
            err.update(aerr)
            plain_ms.update(aplain)

        with Phase("phase 2: main path"):
            # launches of each codec kernel at each block the main path codes at
            shape_counts = {bs: {k: 0 for k in OPS_PER_SYMBOL}
                            for bs in (*BLOCK_SIZES, FALLBACK[1])}
            containers = {}
            torch.cuda.reset_peak_memory_stats()
            for model, c in CODECS.items():
                rk.reset_launches()
                containers[model], by_block = phase2(cli, engine, rk, smoke, model, corpus,
                                                     work)
                path_counts = {k: sum(by[k] for by in by_block.values())
                               for k in path_kernels(c)}
                print(f"{model} path launches {path_counts} over 2 compress + "
                      f"2 decompress calls", flush=True)
                for name, n in path_counts.items():
                    check(n > 0, f"kernel {name} was not launched on the {model} path")
                for bs, launched in by_block.items():
                    for name, n in launched.items():
                        shape_counts[bs][name] += n
            rk.reset_launches()
            c = phase2_fallback(turbo, container, smoke, corpus)
            path_counts = {k: rk.launches[k] for k in path_kernels(CODECS[FALLBACK[2]])}
            print(f"{FALLBACK[0]} block {FALLBACK[1]} path launches {path_counts} over 1 "
                  f"compress + 1 decompress call", flush=True)
            for name, n in path_counts.items():
                check(n > 0, f"kernel {name} was not launched on the fallback path")
                shape_counts[FALLBACK[1]][name] += n
            print("main path launches by block: " + "; ".join(
                f"{bs}: {{{', '.join(f'{k}: {n}' for k, n in by.items() if n)}}}"
                for bs, by in shape_counts.items()), flush=True)
            containers[FALLBACK[2]][FALLBACK[1]] = c
            counts = {k: sum(by[k] for by in shape_counts.values()) for k in OPS_PER_SYMBOL}
            peak = torch.cuda.max_memory_allocated()
            print(f"main path launches {counts}; max_memory_allocated {peak} bytes")

            golden_counts = phase2_golden(torch, T, A, ttrain, smoke, root, dev)
            train_counts, step_ms, train_peak, cfg16 = phase2_train(
                torch, T, A, ttrain, lm_registry, corpus, work, dev)
            for name in ATTN:
                check(train_counts[name] > 0, f"kernel {name} was not launched training")
            counts.update(train_counts)
            cli_counts = phase2_cli(cli, A, ttrain, corpus, work)
            print(f"training path launches: golden (fused) {golden_counts}; byte-16l "
                  f"{train_counts}; cli train {cli_counts}", flush=True)

        with Phase("phase 3: numbers"):
            for model in CODECS:
                e2e(torch, engine, model, corpus)
            times = kernel_times(torch, rk, corpus, dev, BLOCK_SIZES[0])
            kernel_times(torch, rk, corpus, dev, BLOCK_SIZES[1])
            kernel_times(torch, rk, corpus, dev, FALLBACK[1], (CODECS[FALLBACK[2]],))
            for model, by_block in containers.items():
                for bs, c in by_block.items():
                    print(f"bits/byte {model} block {bs}: {8 * len(c) / len(corpus):.6f}")
                    parse, rest, write = host_split(torch, turbo, container, c)
                    print(f"host split {model} block {bs}: decode = parse {parse:.1f} ms + "
                          f"decompress_parsed {rest:.1f} ms; encode ends with write "
                          f"{write:.1f} ms (medians of 3)")

            atimes = attn_times(torch, A, dev, cfg16)
            times.update({k: {"ms": v["ms"], "bound_ms": v["bound_ms"],
                              "bound_by": v["bound_by"]} for k, v in atimes.items()})
            plain_ms.update({k: v["plain_ms"] for k, v in atimes.items()})
            tok = TRAIN["batch"] * TRAIN["seq"]
            step_med = float(np.median(step_ms[1:]))
            per_step = {"causal_attn_fwd": 2 * cfg16.n_layers,
                        "causal_attn_bwd_dkv": cfg16.n_layers,
                        "causal_attn_bwd_dq": cfg16.n_layers}
            kern_ms = sum(atimes[k]["ms"] * n for k, n in per_step.items())
            print(f"byte-16l training: {tok / (step_med / 1e3):.1f} tokens/s (median step "
                  f"{step_med:.1f} ms over steps 1-{TRAIN['steps'] - 1}, {tok} tokens a step); "
                  f"K10-K12 {kern_ms:.1f} ms a step ({100 * kern_ms / step_med:.1f} %); "
                  f"max_memory_allocated {train_peak} bytes", flush=True)

        with Phase("phase 4: LM coding"):
            rk.reset_launches()
            A.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            c_lm, waves, enc_ms, dec_ms = phase4_cli(torch, cli, container, corpus, work)
            lm_peak = torch.cuda.max_memory_allocated()
            lm_counts = {**rk.launches, **A.launches}
            print(f"lm path launches of K1-K12: {lm_counts}", flush=True)
            check(set(lm_counts.values()) == {0}, "the lm path launched a TPU-kernel port")
            bpb_b = phase4_trained(ttrain, lm_api, smoke, root, corpus)
            lm_model = lm_registry.resolve_lm(LM_REF)
            phase4_determinism(torch, lm_api, lm_engine, lm_registry, container, corpus, c_lm,
                               lm_model)
            phase4_numbers(torch, lm_engine, vector, T, container, smoke, c_lm, waves, enc_ms,
                           dec_ms, lm_peak, lm_model, smi)
            print(f"lm (d) [{smi}] bits/byte of (b): {bpb_b:.6f}", flush=True)

        library_ms = {k: atimes[k]["library_ms"] for k in ATTN}
        kernels = [
            {
                "name": name,
                "route": "cuda",
                "source": SOURCE[name],
                "replaces": REPLACES[name],
                "launches": counts[name],
                "max_abs_err": err[name],
                "ms": times[name]["ms"],
                "plain_ms": plain_ms[name],
                "bound_ms": times[name]["bound_ms"],
                "bound_by": times[name]["bound_by"],
                "library_ms": library_ms.get(name),
            }
            for name in (*OPS_PER_SYMBOL, *ATTN)
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
