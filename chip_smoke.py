import faulthandler; faulthandler.dump_traceback_later(1150, exit=True)  # noqa: E702

# Drive lac_tpu_torch's main path on one CUDA card and check it.
#
#   python3 chip_smoke.py              phases 0-8
#   python3 chip_smoke.py --flagship   the flagship schedules alone (below)
#   python3 chip_smoke.py --det8       phase 7 alone (its float comparisons
#                                      against smoke's goldens)
#   python3 chip_smoke.py --phase8     phase 8 alone
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
#          decode tokens/s of (a) (median of its 3), peak device memory,
#          (b)'s bits/byte; a step of byte-12l at 64 lanes and the
#          schedule's mean cache width 320, eagerly and as a CUDA graph
#          replay (runtime/step_graph.py, which every schedule runs), from
#          one cache: the CDFs equal bit for bit, ms a step both ways (host
#          clock), the CUDA kernels each launches and the device's busy
#          time (torch.profiler), against the least time a step could take
#          (bytes over HBM, flops over bf16).
# Phase 5  windowed LM coding, blocks past the model context (slice 12; no
#          TPU kernel, so K1-K12 must not launch): (a) the CLI's compress
#          --model lm with the shipped byte-16l checkpoint at full width
#          (d 512, 16 layers, context 1024), block 4096, 64 lanes, overlap
#          8 (so slide, slide_seg 512) on the held-out slice
#          (smoke.heldout_slice(), 256 KiB: 64 blocks, one wave, 4,096
#          steps a side), then decompress: bytes equal, the header's mode,
#          bits/byte within 1 % of smoke.GOLDEN_SLIDE16_BPB (lac_tpu's on
#          the CPU), encode and decode tokens/s; (b) byte-6l at
#          smoke.WINDOW_CODING (block 2048 past its context 768, 32 lanes)
#          on the slice's first 64 KiB, reprime and slide, each round trip
#          equal and within 1 % of smoke.GOLDEN_WINDOW_BPB; (c) graph
#          against eager at byte-16l on the ring, 1024 wide, from a cache
#          that a prefill of 1024 tokens filled (pos past the first window),
#          32 steps at 64 lanes and at 4: CDFs equal bit for bit, ms a step,
#          kernels a step, device busy and idle share, and the step's bound.
# Phase 6  the int8 LM modes, kv8 (int8 KV cache) and w8 (int8 weights)
#          (slice 13; no TPU kernel, so K1-K12 must not launch): (a) byte-6l
#          through the CLI at smoke.LM_CODING on the corpus's first 32 KiB
#          with --kv8, --w8 and --kv8 --w8: round trip, the header's flags,
#          bits/byte within 1 % of smoke.GOLDEN_Q8_BPB (lac_tpu's on the
#          CPU); (b) phase 5 (a)'s byte-16l run through the CLI with --kv8
#          --w8: round trip, bits/byte within 1 % of phase 5 (a)'s float
#          figure, tokens/s a side; (c) TinyLlama-1.1B at full width
#          (prng:tinyllama:0's preset, 22 layers, d 2048, GQA 32/4, vocab
#          32000) with w8 (init_params_w8) and kv8: lm_encode / lm_decode
#          at 64 lanes x 512 tokens of the corpus, cache_grow 128, the round
#          trip exact; (d) graph against eager, 32 steps' CDFs equal bit for
#          bit, at byte-16l kv8+w8 on the 1024-slot ring at 64 and 4 lanes
#          and TinyLlama kv8+w8 at 64 lanes, width 512: ms, kernels, busy,
#          idle and peak memory a step beside the float step at the same
#          shape (phase 5 (c)'s, and TinyLlama's float model here) and the
#          step's bound; no allocation during the replays; (e) the int8
#          products exact on the card: ops.int8.int8_mm through its padding
#          (M 1, 4, 16, 17, 64; N 61, 256, 32000; K 64, 2048, 5632; b row-
#          and column-major) and int8_bmm at W 1024, 1040, 2048, seeded and
#          at every value +-127, against the host's exact products, and
#          int8_bmm refusing TF32; (f) no launch of K1-K12.
# Phase 7  det8, the integer-reduction forward (slice 14; no TPU kernel, so
#          K1-K12 must not launch): (a) byte-6l through the CLI with --det8
#          at smoke.LM_CODING on the corpus's first 32 KiB: round trip, the
#          header's flag, the container equal byte for byte to the port's
#          CPU one (smoke.GOLDEN_DET8_PORT), bits/byte within 0.1 % of
#          lac_tpu's (smoke.GOLDEN_DET8_BPB) and beside phase 4 (b)'s float
#          figure; (b) phase 5 (a)'s byte-16l run through the CLI with
#          --det8: round trip, slide_seg 0, bits/byte within 1 % of phase 5
#          (a)'s float figure, tokens/s a side; (c) the chunked encode
#          against serial steps on byte-16l's 1024-slot ring after a
#          1024-token prefill, 256 positions at 64 lanes, chunks of 128 and
#          of 37: the intervals equal bit for bit; (d) the card against the
#          CPU, bit for bit: each elementwise det8 function on 2^20 values,
#          the bf16 rounding, the det8 CDF, byte-6l's det8 logits for 16
#          positions (a chunk and serial steps), the RoPE tables against
#          smoke.GOLDEN_DET8_ROPE; (e) graph against eager, det8 steps at
#          byte-16l's two ring shapes beside phase 5 (c)'s float steps;
#          (f) no launch of K1-K12.
# Phase 8  the token alphabet and the scan codecs (slice 15; no TPU kernel,
#          so K1-K12 must not launch): (a) Llama-3-8B at full width
#          (prng:llama3-8b:0's preset: 32 layers, d 4096, GQA 32/8, vocab
#          128,256, rope theta 5e5) with w8 (init_params_w8) and kv8 through
#          lm_compress_tokens / lm_decompress_tokens, 64 lanes x 512 seeded
#          Zipf ids through a permutation of the vocab (ids above 65,535 and
#          vocab - 1 among them) at the CLI's LM defaults: the round trip
#          exact, the header's alphabet, vocab, prob_bits 18 and length;
#          then the peak memory of det8's encode chunk (64 lanes x 128
#          positions) at that vocab on a small det8 model; (b) byte-6l at
#          smoke.LM_CODING on the corpus's first 32 KiB with the bytes as
#          ids: the token container's blocks equal the byte container's,
#          float (phase 4 (b)'s) and det8 (smoke.GOLDEN_DET8_PORT, phase 7
#          (a)'s); (c) the CLI's compress --model order0, markov1, order0d,
#          markov1d and markov1c at its defaults (block 4096) on the 32 MiB
#          corpus, then engine.compress_bytes(corpus) at its own (order0,
#          block 65536): decompress, byte compare, crc32 and length against
#          smoke.GOLDEN_SCAN (lac_tpu's on the CPU), MB/s a side, bits/byte,
#          peak memory; (d) on the corpus's first MiB, each of the five
#          models' containers on the card equal to the port's on the CPU
#          (a child process with no card codes them while (a)-(c) run);
#          (e) no launch of K1-K12.
#
# --flagship: the shipped flagship configuration (bench.py: byte-16l, block
# 65536, 4 lanes, overlap 8, slide, slide_seg 512) on the whole held-out
# slice, 65,536 steps a side, through lm_compress_bytes and
# lm_decompress_bytes: the round trip equal, bits/byte beside lac_tpu's
# 0.8032 (a v5e), seconds a side and ms a step; then byte-16l with det8,
# slide, block 16384, 16 lanes, on the whole slice (lac_tpu's
# measurements/r4_slide_det8_b16k.log): the round trip, bits/byte, seconds
# a side and ms a position. It needs about 1500 s on one H100.
#
# It imports the standard library, numpy, torch and lac_tpu_torch only. A
# hang ends in a traceback and a non-zero exit (faulthandler above). Without
# a CUDA device, or without the package beside it, it exits non-zero before
# printing any result. The last line is the JSON result.

import dataclasses
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
# H100 SXM dense peaks (NVIDIA's data sheet): bf16 and int8 tensor cores
# (int8: operations a second), f32 CUDA cores
PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
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
# graph against eager: steps compared, then steps timed a side; the steps a
# graph_vs_eager call runs (the graph also TIMED_STEPS under CUDA events)
GRAPH_STEPS, TIMED_STEPS = 32, 20
STEP_BUDGET = GRAPH_STEPS + 2 * TIMED_STEPS + 2
# phase 5 and --flagship: lac_tpu's bits/byte on a v5e, context only
# (measurements/r3_slide.log: byte-16l slide at block 4096, 64 lanes;
# bench.py SHIPPED_FLAGSHIP_BPB: block 65536, 4 lanes)
V5E_SLIDE16_BPB, V5E_FLAGSHIP_BPB = 0.8758, 0.8032
FLAGSHIP = dict(block_tokens=65536, lanes=4, prob_bits=16, overlap=8, cache_grow=128,
                window_mode="slide", slide_seg=512)
FLAGSHIP_HANG_S = 2400  # the hang guard of a --flagship run
# phase 6: the CLI's flags of each int8 mode (smoke.GOLDEN_Q8_BPB's keys);
# TinyLlama's lanes, tokens a lane and cache bucket
Q8_FLAGS = {"kv8": ["--kv8"], "w8": ["--w8"], "kv8+w8": ["--kv8", "--w8"]}
TL_LANES, TL_TOKENS, TL_GROW = 64, 512, 128
# phase 7, det8: the card's byte-6l container against the port's CPU one
# (smoke.GOLDEN_DET8_PORT) byte for byte, its bits/byte against lac_tpu's
# (smoke.GOLDEN_DET8_BPB); the chunked encode against serial steps from
# DET8_PREFILL tokens on byte-16l's ring, DET8_CHUNK_POS positions at chunk
# 128 and at 37 (a ragged tail); DET8_LOGIT_POS positions of byte-6l's
# logits and DET8_MATH_N values of each elementwise function, card against
# CPU; --flagship's det8 run
DET8_BPB_TOL = 1e-3
DET8_PREFILL, DET8_CHUNK_POS, DET8_CHUNKS = 1024, 256, (128, 37)
DET8_LOGIT_POS, DET8_MATH_N = 16, 1 << 20
DET8_FLAGSHIP = dict(block_tokens=16384, lanes=16, prob_bits=16, overlap=8, cache_grow=128,
                     window_mode="slide")
# lac_tpu's det8 flagship on a v5e, context only (measurements/
# r4_slide_det8_b16k.log): bits/byte, encode and decode seconds
V5E_DET8_FLAGSHIP = (0.8196, 113, 240)
# phase 8: Llama-3-8B's ids (lanes x tokens, Zipf exponent); the scan models
# through the CLI, and the prefix each one codes on the card and the CPU
TOK_REF = "prng:llama3-8b:0"
TOK_LANES, TOK_TOKENS, TOK_ZIPF_A = 64, 512, 1.2
SCAN_MODELS = ("order0", "markov1", "order0d", "markov1d", "markov1c")
SCAN_CPU_BYTES = 1 << 20


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
    ``width``: every weight read once (the embedding table only its b rows;
    under w8 the int8 codes and their f32 scales, the head among them), the
    K/V cache read once and the new K/V written once (under kv8 a byte an
    element and a 4-byte scale a row), over HBM_BYTES_PER_S; against the
    step's operations (2 a multiply-add of every product) over the peak of
    their type: int8 for w8's projections and kv8's cache products, bf16
    for the rest. Under det8 (the model ``ensure_det8`` gives: int8 codes
    and f32 scales, the head among them) every product is int8 and runs
    twice, its dual-int8 operand's high and low bytes."""
    es = torch.finfo(cfg.dtype).bits // 8
    tensors = [*params.named_parameters(), *params.named_buffers()]
    weights = sum(t.numel() * t.element_size() for name, t in tensors
                  if name not in ("embed", "pos_embed"))
    emb = b * cfg.d_model * es * (2 if cfg.pos_embedding == "learned" else 1)
    # a w8 or det8 head is its own buffer
    float_head = cfg.tie_embeddings and not (cfg.w8 or cfg.det8)
    head = cfg.vocab * cfg.d_model * es if float_head else 0
    row = cfg.head_dim + 4 if cfg.kv8 else cfg.head_dim * es
    kv_row = 2 * cfg.n_layers * b * cfg.n_kv_heads * row
    nbytes = weights + emb + head + kv_row * width + kv_row
    proj = sum(t.numel() for name, t in tensors
               if t.dim() == 2 and name not in ("embed", "pos_embed") and not name.endswith(".s"))
    proj = (proj + (cfg.vocab * cfg.d_model if float_head else 0)) * b
    cache = 2 * cfg.n_layers * b * cfg.n_heads * width * cfg.head_dim
    fresh = 2 * cfg.n_layers * b * cfg.n_heads * cfg.head_dim
    int8 = (proj if cfg.w8 else 0) + (cache if cfg.kv8 else 0)
    macs = proj + cache + fresh
    if cfg.det8:
        macs = int8 = 2 * macs
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * 2 * (int8 / PEAK_FLOPS["int8"] + (macs - int8) / PEAK_FLOPS["bf16"])
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "bytes": nbytes, "weights": weights,
            "kv": kv_row * width, "flops": 2 * macs, "t_bytes": t_bytes, "t_ops": t_ops}


def profiled(torch, fn):
    """``fn`` once under torch.profiler: (CUDA kernels, memcpy/memset
    activities, device busy ms, the four kernel names that took the most
    device time, each with its ms and count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mem = [e for e in dev_events if e.name.lower().startswith(("memcpy", "memset"))]
    busy_us = sum(getattr(e, "device_time", 0) or 0 for e in dev_events)
    by_name: dict = {}
    for e in dev_events:
        us, n = by_name.get(e.name[:48], (0.0, 0))
        by_name[e.name[:48]] = (us + (getattr(e, "device_time", 0) or 0), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:4]
    return (len(dev_events) - len(mem), len(mem), busy_us / 1e3,
            [(name, round(us / 1e3, 3), n) for name, (us, n) in top])


def graph_vs_eager(torch, T, lm_engine, step_graph, cfg, params, tokens, width: int,
                   start: int) -> dict:
    """From one cache of ``width`` slots holding ``tokens[:, :start]`` (a
    prefill; pos = start), GRAPH_STEPS coding steps (the model, the integer
    CDF and the intervals: step_graph.SegIntervals) eagerly and through the
    runner's graph (its first step eager, as every schedule runs it): every
    step's CDF and the intervals must be equal. Then TIMED_STEPS more each
    way on the host clock around a synchronize, one more each way under
    torch.profiler, and the graph's TIMED_STEPS under CUDA events (its
    device time, whether or not the profiler sees inside a replay): at most
    STEP_BUDGET steps from ``start``."""
    dev = params.embed.device
    b = tokens.shape[0]
    torch.cuda.reset_peak_memory_stats()
    with lm_engine._coding(dev):
        base = T.init_cache(cfg, b, width, device=dev)
        T.forward(cfg, params, tokens[:, :start], base, prefill=True)
        runs, cdfs = [], []
        for graphed in (False, True):
            run = step_graph.SegIntervals(cfg, params, 16, tokens[:, start:])
            run.prev.copy_(tokens[:, start - 1])
            cache = {k: v.clone() for k, v in base.items()}
            one = (lambda r=run, c=cache: r.steps(c, 1)) if graphed else \
                (lambda r=run, c=cache: r._step(c))
            got = []
            for _ in range(GRAPH_STEPS):
                one()
                got.append(run.cdf.clone())
            runs.append((run, one))
            cdfs.append(torch.stack(got))
        check(torch.equal(cdfs[0], cdfs[1]),
              f"graph-replayed CDFs differ from the eager ones (lanes {b}, width {width})")
        (eager, eager_one), (graph, graph_one) = runs
        n = GRAPH_STEPS
        check(torch.equal(eager.lo[:, :n], graph.lo[:, :n]) and
              torch.equal(eager.f[:, :n], graph.f[:, :n]),
              f"graph-replayed intervals differ (lanes {b}, width {width})")
        out = {"peak": torch.cuda.max_memory_allocated()}
        for name, one in (("eager", eager_one), ("graph", graph_one)):
            held = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
            _, ms = sync_time(torch, lambda: [one() for _ in range(TIMED_STEPS)])
            if name == "graph":  # a replay allocates nothing, cuBLAS(Lt) included
                check((torch.cuda.memory_allocated(), torch.cuda.memory_reserved()) == held,
                      f"graph replays allocated (lanes {b}, width {width})")
            kernels, mem, busy, top = profiled(torch, one)
            out[name] = {"ms": ms / TIMED_STEPS, "kernels": kernels, "mem": mem,
                         "busy_ms": busy, "idle": 1 - busy / (ms / TIMED_STEPS), "top": top}
        out["graph"]["event_ms"] = event_ms(torch, graph_one, reps=TIMED_STEPS)
    return out


def print_step(smi, what, nums, bound) -> None:
    e, g = nums["eager"], nums["graph"]
    print(f"{what} [{smi}]: {GRAPH_STEPS} steps, eager and graph CDFs equal bit for bit; "
          f"eager {e['ms']:.3f} ms a step ({TIMED_STEPS} steps, host clock), "
          f"{e['kernels']} kernels and {e['mem']} memcpy/memset a step, device busy "
          f"{e['busy_ms']:.3f} ms ({100 * e['idle']:.1f} % idle); graph {g['ms']:.3f} ms a "
          f"step, {g['kernels']} kernels and {g['mem']} memcpy/memset a replay, device busy "
          f"{g['busy_ms']:.3f} ms ({100 * g['idle']:.1f} % idle), {g['event_ms']:.3f} ms a "
          f"replay from CUDA events; bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} (weights "
          f"{bound['weights'] / 1e6:.1f} MB, K/V {bound['kv'] / 1e6:.1f} MB, "
          f"{bound['t_bytes']:.4f} ms; {bound['flops'] / 1e9:.2f} GFLOP, "
          f"{bound['t_ops']:.4f} ms): the graph step is {g['ms'] / bound['bound_ms']:.1f}x "
          f"the bound, {e['ms'] / g['ms']:.2f}x faster than eager; the replay's kernels that "
          f"took the most device time (name, ms, count): {g['top']}; max_memory_allocated "
          f"{nums['peak']} bytes", flush=True)


def phase4_numbers(torch, T, lm_engine, step_graph, container_mod, smoke, c_a, waves, enc,
                   dec, peak, model, corpus, smi):
    """(d): tokens/s of (a) (median of its LM_REPS timed round trips), peak
    memory; a step eagerly and as a graph replay at the schedule's mean
    cache width, against its bound."""
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
    width = int(round(mean_w))
    print(f"lm (d) [{smi}] byte-12l, {b} lanes, block {bt}, cache_grow {kw['cache_grow']}, "
          f"through the cli: encode {LM_CLI_BYTES / (enc_ms / 1e3):.1f} tokens/s ({waves} "
          f"waves, {enc_ms / (waves * bt):.3f} ms a step), decode "
          f"{LM_CLI_BYTES / (dec_ms / 1e3):.1f} tokens/s ({coded_waves} of {waves} waves hold "
          f"a coded block and run, {dec_ms / max(1, coded_waves * bt):.3f} ms a step); median "
          f"of {LM_REPS}; encode ms {[round(x, 1) for x in enc]}, decode ms "
          f"{[round(x, 1) for x in dec]}; max_memory_allocated over (a) {peak} bytes",
          flush=True)
    steps = STEP_BUDGET
    toks = np.frombuffer(corpus[: b * width], dtype=np.uint8).reshape(b, width)
    tokens = torch.from_numpy(toks.astype(np.int64)).to(params.embed.device)
    nums = graph_vs_eager(torch, T, lm_engine, step_graph, cfg, params, tokens, width,
                          width - steps)
    print_step(smi, f"lm (d) byte-12l step, {b} lanes, cache width {width} (the schedule's "
               f"mean)", nums, lm_step_bound(torch, cfg, params, b, width))


# --------------------------------------------------------------------------
# Phase 5: windowed LM coding (slide and reprime past the model context)
# --------------------------------------------------------------------------


def phase5_cli(torch, cli, container_mod, smoke, root, work, flags=(), float_bpb=None):
    """(a): byte-16l through the CLI, slide on the held-out slice; returns
    its bits/byte, held to smoke.GOLDEN_SLIDE16_BPB. With ``flags`` (phase 6
    (b): ``--kv8 --w8``), the same run in those modes, its header's flags
    checked and its bits/byte held to ``float_bpb``, (a)'s from this run."""
    data = smoke.heldout_slice()[: smoke.SLIDE16_BYTES]
    kw = smoke.SLIDE16_CODING
    path = os.path.join(work, "heldout.bin")
    with open(path, "wb") as f:
        f.write(data)
    # relative to the checkout (main runs from its root): the header records
    # the ref, so the container does not depend on where the checkout lies
    ref = "file:" + smoke.SLIDE16_CHECKPOINT
    args = ["--model", "lm", "--model-ref", ref, "--block-tokens", str(kw["block_tokens"]),
            "--lanes", str(kw["lanes"]), "--overlap", str(kw["overlap"]), *flags]
    rc, enc_ms = sync_time(torch, lambda: cli.main(["compress", path, *args, "-o",
                                                    path + ".lac"]))
    check(rc == 0, f"cli compress --model lm {' '.join(flags)}, byte-16l")
    rc, dec_ms = sync_time(torch, lambda: cli.main(["decompress", path + ".lac", "-o",
                                                    path + ".out"]))
    check(rc == 0, "cli decompress of the byte-16l container")
    with open(path + ".out", "rb") as f:
        check(f.read() == data, f"byte-16l {' '.join(flags)}: the cli round trip differs")
    with open(path + ".lac", "rb") as f:
        c = f.read()
    header, blocks = container_mod.read_container(c)
    got = {k: header.config[k] for k in ("window_mode", "slide_seg", "max_seq", "lanes",
                                         "block_tokens", "overlap", "kv8", "w8", "det8")}
    det8 = "--det8" in flags
    want = {"window_mode": "slide", "slide_seg": 0 if det8 else 512, "max_seq": 1024,
            "lanes": kw["lanes"], "block_tokens": kw["block_tokens"], "overlap": kw["overlap"],
            "kv8": "--kv8" in flags, "w8": "--w8" in flags, "det8": det8}
    check(got == want, f"byte-16l container header {got}")
    bpb = 8 * len(c) / len(data)
    if det8:
        what, against = "det8 (b) byte-16l slide --det8", (
            f"the float run's {float_bpb:.6f} from (a) of phase 5 (relative "
            f"{bpb / float_bpb - 1:+.2e}, tolerance {LM_BPB_TOL}; lac_tpu on a v5e: float "
            f"{V5E_SLIDE16_BPB}, det8 0.8758, measurements/r3_slide_det8_seg.log, context only)")
        rel = bpb / float_bpb - 1
    elif flags:
        what, against = f"q8 (b) byte-16l slide {' '.join(flags)}", (
            f"the float run's {float_bpb:.6f} from (a) of phase 5 (relative "
            f"{bpb / float_bpb - 1:+.2e}, tolerance {LM_BPB_TOL}; lac_tpu on a v5e: kv8 +0.16 % "
            f"on byte-16l, measurements/r3_kv8_ratio.log)")
        rel = bpb / float_bpb - 1
    else:
        rel = bpb / smoke.GOLDEN_SLIDE16_BPB - 1
        what, against = "window (a) byte-16l slide", (
            f"lac_tpu {smoke.GOLDEN_SLIDE16_BPB:.6f} on the CPU (relative {rel:+.2e}, "
            f"tolerance {LM_BPB_TOL}; lac_tpu on a v5e: {V5E_SLIDE16_BPB})")
    coded = sum(b.token_count > 0 for b in blocks)
    print(f"{what}, cli: {len(data)} -> {len(c)} bytes, {bpb:.6f} bits/byte, {against}; header "
          f"{got}; {coded} of {len(blocks)} blocks coded; round trip equal; encode "
          f"{len(data) / (enc_ms / 1e3):.1f} tokens/s ({enc_ms / 1e3:.1f} s), decode "
          f"{len(data) / (dec_ms / 1e3):.1f} tokens/s ({dec_ms / 1e3:.1f} s), "
          f"{kw['block_tokens']} steps a side, checkpoint load included", flush=True)
    check(abs(rel) <= LM_BPB_TOL, f"{what}: bits/byte {bpb} off by {rel:+.3e}")
    return bpb


def phase5_byte6l(torch, ttrain, lm_api, smoke, root):
    """(b): byte-6l past its context, reprime and slide."""
    model = ttrain.load_checkpoint(os.path.join(root, smoke.LM_CHECKPOINT))
    data = smoke.heldout_slice()[: smoke.WINDOW_BPB_BYTES]
    for mode in ("reprime", "slide"):
        (c, ms) = sync_time(torch, lambda: lm_api.lm_compress_bytes(
            data, model_ref="file:" + smoke.LM_CHECKPOINT, model=model, window_mode=mode,
            **smoke.WINDOW_CODING))
        out, dms = sync_time(torch, lambda: lm_api.lm_decompress_bytes(c, model=model))
        check(out == data, f"byte-6l {mode}: round trip")
        bpb = 8 * len(c) / len(data)
        rel = bpb / smoke.GOLDEN_WINDOW_BPB[mode] - 1
        print(f"window (b) byte-6l {mode}, block {smoke.WINDOW_CODING['block_tokens']}, "
              f"{smoke.WINDOW_CODING['lanes']} lanes: {len(data)} -> {len(c)} bytes, "
              f"{bpb:.6f} bits/byte, lac_tpu {smoke.GOLDEN_WINDOW_BPB[mode]:.6f} (relative "
              f"{rel:+.2e}, tolerance {LM_BPB_TOL}); round trip equal; encode "
              f"{ms / 1e3:.2f} s, decode {dms / 1e3:.2f} s", flush=True)
        check(abs(rel) <= LM_BPB_TOL,
              f"byte-6l {mode}: bits/byte {bpb} off GOLDEN_WINDOW_BPB by {rel:+.3e}")


def ring_steps(torch, T, lm_engine, step_graph, smoke, cfg, params, smi, what):
    """byte-16l ``cfg`` on the ring, 1024 wide, past the first window: graph
    against eager at 64 lanes and at 4; returns {lanes: (numbers, bound)}."""
    w = cfg.max_seq
    n = w + STEP_BUDGET
    scfg = lm_engine._slide_cfg(cfg, n)  # det8's RoPE tables reach position n
    arr = np.frombuffer(smoke.heldout_slice(), dtype=np.uint8)
    out = {}
    for b in (64, 4):
        toks = np.stack([arr[i * n : (i + 1) * n] for i in range(b)]).astype(np.int64)
        tokens = torch.from_numpy(toks).to(params.embed.device)
        nums = graph_vs_eager(torch, T, lm_engine, step_graph, scfg, params, tokens, w, w)
        bound = lm_step_bound(torch, scfg, params, b, w)
        print_step(smi, f"{what} byte-16l slide step, {b} lanes, ring {w}, pos {w}-{n - 1}",
                   nums, bound)
        out[b] = (nums, bound)
    return out


def phase5_steps(torch, T, ttrain, lm_engine, step_graph, smoke, root, smi):
    """(c): the float byte-16l on the ring (``ring_steps``)."""
    cfg, params = ttrain.load_checkpoint(os.path.join(root, smoke.SLIDE16_CHECKPOINT))
    return ring_steps(torch, T, lm_engine, step_graph, smoke, cfg, params, smi, "window (c)")


# --------------------------------------------------------------------------
# Phase 6: the int8 LM modes (kv8, w8)
# --------------------------------------------------------------------------


def phase6_cli(torch, cli, container_mod, smoke, corpus, work):
    """(a): byte-6l through the CLI at smoke.LM_CODING in each int8 mode."""
    data = corpus[: smoke.LM_BPB_BYTES]
    path = os.path.join(work, "q8.bin")
    with open(path, "wb") as f:
        f.write(data)
    kw = smoke.LM_CODING
    args = ["--model", "lm", "--model-ref", "file:" + smoke.LM_CHECKPOINT, "--block-tokens",
            str(kw["block_tokens"]), "--lanes", str(kw["lanes"]), "--prob-bits",
            str(kw["prob_bits"]), "--cache-grow", str(kw["cache_grow"]), "--window-mode",
            kw["window_mode"]]
    for mode, flags in Q8_FLAGS.items():
        rc, enc_ms = sync_time(torch, lambda: cli.main(["compress", path, *args, *flags, "-o",
                                                        path + ".lac"]))
        check(rc == 0, f"cli compress --model lm {' '.join(flags)}")
        rc, dec_ms = sync_time(torch, lambda: cli.main(["decompress", path + ".lac", "-o",
                                                        path + ".out"]))
        check(rc == 0, f"cli decompress, {mode}")
        with open(path + ".out", "rb") as f:
            check(f.read() == data, f"q8 (a) {mode}: the cli round trip differs")
        with open(path + ".lac", "rb") as f:
            c = f.read()
        header, blocks = container_mod.read_container(c)
        flags_got = (header.config["kv8"], header.config["w8"])
        check(flags_got == ("--kv8" in flags, "--w8" in flags), f"q8 (a) {mode}: header {flags_got}")
        bpb = 8 * len(c) / len(data)
        rel = bpb / smoke.GOLDEN_Q8_BPB[mode] - 1
        print(f"q8 (a) byte-6l {' '.join(flags)}, cli: {len(data)} -> {len(c)} bytes, {bpb:.6f} "
              f"bits/byte, lac_tpu {smoke.GOLDEN_Q8_BPB[mode]:.6f} on the CPU (relative "
              f"{rel:+.2e}, tolerance {LM_BPB_TOL}); header kv8/w8 {flags_got}; "
              f"{sum(b.token_count > 0 for b in blocks)} of {len(blocks)} blocks coded; round "
              f"trip equal; encode {enc_ms / 1e3:.2f} s, decode {dec_ms / 1e3:.2f} s", flush=True)
        check(abs(rel) <= LM_BPB_TOL, f"q8 (a) {mode}: bits/byte {bpb} off by {rel:+.3e}")


def phase6_tinyllama(torch, T, lm_engine, corpus, smi, dev):
    """(c): TinyLlama-1.1B, w8 (staged init) and kv8, lm_encode then
    lm_decode; returns (cfg, params)."""
    cfg = dataclasses.replace(T.TINYLLAMA_1B, w8=True, kv8=True)
    (params, init_ms) = sync_time(torch, lambda: T.init_params_w8(cfg, 0, device=dev))
    toks = np.frombuffer(corpus[: TL_LANES * TL_TOKENS], dtype=np.uint8)
    tokens = torch.from_numpy(toks.reshape(TL_LANES, TL_TOKENS).astype(np.int64)).to(dev)
    lengths = torch.full((TL_LANES,), TL_TOKENS, dtype=torch.int64, device=dev)
    torch.cuda.reset_peak_memory_stats()
    (words, nwords), enc_ms = sync_time(torch, lambda: lm_engine.lm_encode(
        cfg, params, tokens, lengths, 16, TL_GROW))
    out, dec_ms = sync_time(torch, lambda: lm_engine.lm_decode(
        cfg, params, words, lengths, 16, TL_TOKENS, TL_GROW))
    peak = torch.cuda.max_memory_allocated()
    check(torch.equal(out, tokens), "q8 (c) TinyLlama kv8+w8: the round trip differs")
    n = TL_LANES * TL_TOKENS
    print(f"q8 (c) [{smi}] TinyLlama-1.1B w8+kv8 ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads}, vocab {cfg.vocab}; random weights, seed 0, "
          f"init_params_w8 {init_ms / 1e3:.1f} s): {TL_LANES} lanes x {TL_TOKENS} tokens of "
          f"the corpus, cache_grow {TL_GROW}: round trip exact, "
          f"{int(nwords.sum()) * 32 / n:.3f} bits a token; encode {n / (enc_ms / 1e3):.1f} "
          f"tokens/s ({enc_ms / TL_TOKENS:.3f} ms a step), decode {n / (dec_ms / 1e3):.1f} "
          f"tokens/s ({dec_ms / TL_TOKENS:.3f} ms a step); max_memory_allocated {peak} bytes",
          flush=True)
    return cfg, params


def print_beside(what, q8, flt) -> None:
    """The int8 step's graph ms, kernels, busy and peak beside the float
    step's at the same shape, each with its bound."""
    (qn, qb), (fn, fb) = q8, flt
    print(f"{what}: graph {qn['graph']['ms']:.3f} ms a step (float {fn['graph']['ms']:.3f}, "
          f"{qn['graph']['ms'] / fn['graph']['ms']:.2f}x), eager {qn['eager']['ms']:.3f} "
          f"(float {fn['eager']['ms']:.3f}), kernels {qn['graph']['kernels']} (float "
          f"{fn['graph']['kernels']}), device busy {qn['graph']['busy_ms']:.3f} ms (float "
          f"{fn['graph']['busy_ms']:.3f}), idle {100 * qn['graph']['idle']:.1f} % (float "
          f"{100 * fn['graph']['idle']:.1f} %), peak {qn['peak']} bytes (float {fn['peak']}); "
          f"bound {qb['bound_ms']:.4f} ms (float {fb['bound_ms']:.4f})", flush=True)


def phase6_steps(torch, T, ttrain, lm_engine, step_graph, smoke, root, smi, float_ring, tl,
                 corpus, dev):
    """(d): graph against eager, kv8+w8, at byte-16l's two ring shapes
    (beside phase 5 (c)'s float steps) and TinyLlama at 64 lanes, width 512
    (beside its float model's step)."""
    cfg, params = ttrain.load_checkpoint(os.path.join(root, smoke.SLIDE16_CHECKPOINT))
    qcfg = dataclasses.replace(cfg, kv8=True, w8=True)
    ring = ring_steps(torch, T, lm_engine, step_graph, smoke, qcfg, T.ensure_w8(qcfg, params),
                      smi, "q8 (d) kv8+w8")
    for b, nums in ring.items():
        print_beside(f"q8 (d) [{smi}] byte-16l ring 1024, {b} lanes, kv8+w8 against float",
                     nums, float_ring[b])
    toks = np.frombuffer(corpus[: TL_LANES * TL_TOKENS], dtype=np.uint8)
    tokens = torch.from_numpy(toks.reshape(TL_LANES, TL_TOKENS).astype(np.int64)).to(dev)
    start = TL_TOKENS - STEP_BUDGET
    got = {}
    for name, (c, p) in (("kv8+w8", tl), ("float", (
            T.TINYLLAMA_1B, T.init_params(T.TINYLLAMA_1B, 0, device=dev)))):
        nums = graph_vs_eager(torch, T, lm_engine, step_graph, c, p, tokens, TL_TOKENS, start)
        got[name] = (nums, lm_step_bound(torch, c, p, TL_LANES, TL_TOKENS))
        print_step(smi, f"q8 (d) TinyLlama {name} step, {TL_LANES} lanes, width {TL_TOKENS}, "
                   f"pos {start}-{start + STEP_BUDGET - 1}", *got[name])
    print_beside(f"q8 (d) [{smi}] TinyLlama, {TL_LANES} lanes, width {TL_TOKENS}, kv8+w8 "
                 f"against float", got["kv8+w8"], got["float"])


def phase6_exact(torch, int8, lm_engine, dev):
    """(e): the int8 products on the card against the host's exact ones (a
    float64 product of int8 values is exact: every partial sum is below
    2^53), seeded and at every value +-127."""
    rng = np.random.default_rng(SEED)
    cases = 0
    for m in (1, 4, 16, 17, 64):
        for n in (61, 256, 32000):
            for k in (64, 2048, 5632):
                for worst in (False, True):
                    a = (np.full((m, k), 127, np.int8) if worst
                         else rng.integers(-127, 128, (m, k), dtype=np.int8))
                    b = (np.full((k, n), -127, np.int8) if worst
                         else rng.integers(-127, 128, (k, n), dtype=np.int8))
                    want = a.astype(np.float64) @ b.astype(np.float64)
                    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
                    for layout, bb in (("row", bt), ("column", bt.t().contiguous().t())):
                        got = int8.int8_mm(at, bb).cpu().numpy()
                        check(np.array_equal(got.astype(np.float64), want),
                              f"int8_mm M {m} N {n} K {k} {layout}-major b worst {worst}")
                        cases += 1
    for w in (1024, 1040, 2048):
        for worst in (False, True):
            a = (np.full((4, 8, 64, w), 127, np.int8) if worst
                 else rng.integers(-127, 128, (4, 8, 64, w), dtype=np.int8))
            b = (np.full((4, 8, w, 64), 127, np.int8) if worst
                 else rng.integers(-127, 128, (4, 8, w, 64), dtype=np.int8))
            want = np.matmul(a.astype(np.float64), b.astype(np.float64))
            with lm_engine._coding(dev):
                got = int8.int8_bmm(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
            check(np.array_equal(got.cpu().numpy().astype(np.float64), want),
                  f"int8_bmm W {w} worst {worst}")
            cases += 1
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        int8.int8_bmm(torch.zeros(2, 3, dtype=torch.int8, device=dev),
                      torch.zeros(3, 2, dtype=torch.int8, device=dev))
    except RuntimeError as e:
        refusal = str(e)
    else:
        raise RuntimeError("check failed: int8_bmm ran with TF32 on")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"q8 (e): {cases} int8 products on the card equal the host's exact ones "
          f"(int8_mm: M 1-64, N 61-32000, K 64-5632, both layouts of b; int8_bmm: W 1024, "
          f"1040, 2048); seeded and worst case; with TF32 on int8_bmm refuses: {refusal}",
          flush=True)


# --------------------------------------------------------------------------
# Phase 7: det8, the integer-reduction forward
# --------------------------------------------------------------------------


def phase7_cli(torch, cli, container_mod, smoke, corpus, work, float_bpb):
    """(a): byte-6l through the CLI with --det8 at smoke.LM_CODING: the
    round trip, the header's flag, the container against the port's CPU
    one (smoke.GOLDEN_DET8_PORT) byte for byte, bits/byte against lac_tpu's
    (smoke.GOLDEN_DET8_BPB) and beside the float run's (phase 4 (b))."""
    data = corpus[: smoke.LM_BPB_BYTES]
    path = os.path.join(work, "det8.bin")
    with open(path, "wb") as f:
        f.write(data)
    kw = smoke.LM_CODING
    args = ["--model", "lm", "--model-ref", "file:" + smoke.LM_CHECKPOINT, "--block-tokens",
            str(kw["block_tokens"]), "--lanes", str(kw["lanes"]), "--prob-bits",
            str(kw["prob_bits"]), "--cache-grow", str(kw["cache_grow"]), "--window-mode",
            kw["window_mode"], "--det8"]
    rc, enc_ms = sync_time(torch, lambda: cli.main(["compress", path, *args, "-o",
                                                    path + ".lac"]))
    check(rc == 0, "cli compress --model lm --det8")
    rc, dec_ms = sync_time(torch, lambda: cli.main(["decompress", path + ".lac", "-o",
                                                    path + ".out"]))
    check(rc == 0, "cli decompress, det8")
    with open(path + ".out", "rb") as f:
        check(f.read() == data, "det8 (a): the cli round trip differs")
    with open(path + ".lac", "rb") as f:
        c = f.read()
    header, blocks = container_mod.read_container(c)
    check(header.config["det8"] is True, f"det8 (a): header det8 {header.config['det8']}")
    digest = smoke.container_digest(c)
    bpb = 8 * len(c) / len(data)
    rel = bpb / smoke.GOLDEN_DET8_BPB - 1
    print(f"det8 (a) byte-6l --det8, cli: {len(data)} -> {len(c)} bytes, {bpb:.6f} bits/byte, "
          f"lac_tpu {smoke.GOLDEN_DET8_BPB:.6f} on the CPU (relative {rel:+.2e}, tolerance "
          f"{DET8_BPB_TOL}), the float run {float_bpb:.6f} (phase 4 (b)); crc32 and length "
          f"{digest}, the port's CPU container {smoke.GOLDEN_DET8_PORT}; "
          f"{sum(b.token_count > 0 for b in blocks)} of {len(blocks)} blocks coded; round "
          f"trip equal; encode {enc_ms / 1e3:.2f} s, decode {dec_ms / 1e3:.2f} s", flush=True)
    check(digest == smoke.GOLDEN_DET8_PORT,
          f"det8 (a): the card's container {digest} is not the CPU's {smoke.GOLDEN_DET8_PORT}")
    check(abs(rel) <= DET8_BPB_TOL, f"det8 (a): bits/byte {bpb} off by {rel:+.3e}")


def det8_byte16l(T, ttrain, smoke, root):
    """byte-16l's det8 (cfg, model ensure_det8 gives)."""
    cfg, params = ttrain.load_checkpoint(os.path.join(root, smoke.SLIDE16_CHECKPOINT))
    cfg = dataclasses.replace(cfg, det8=True)
    return cfg, T.ensure_det8(cfg, params)


def phase7_chunks(torch, T, lm_engine, step_graph, smoke, model, smi):
    """(c): on byte-16l's 1024-slot ring after a prefill of DET8_PREFILL
    tokens, the chunked encode's intervals over DET8_CHUNK_POS positions (at
    each of DET8_CHUNKS) against the serial steps' (graph replays), bit for
    bit."""
    cfg, params = model
    dev = params.embed.device
    n = DET8_PREFILL + DET8_CHUNK_POS
    scfg = lm_engine._slide_cfg(cfg, n)
    arr = np.frombuffer(smoke.heldout_slice(), dtype=np.uint8)
    b = 64
    toks = np.stack([arr[i * n : (i + 1) * n] for i in range(b)]).astype(np.int64)
    tokens = torch.from_numpy(toks).to(dev)
    with lm_engine._coding(dev):
        base = T.init_cache(scfg, b, device=dev)
        T.forward(scfg, params, tokens[:, :DET8_PREFILL], base, prefill=True)
        got = {}
        for name, chunk in (("serial", 0), *((f"chunk {c}", c) for c in DET8_CHUNKS)):
            cache = {k: v.clone() for k, v in base.items()}
            seg = tokens[:, DET8_PREFILL:]
            run = (step_graph.SegChunks(scfg, params, 16, seg, chunk=chunk) if chunk
                   else step_graph.SegIntervals(scfg, params, 16, seg))
            run.prev.copy_(tokens[:, DET8_PREFILL - 1])
            _, ms = sync_time(torch, lambda r=run, c=cache: r.steps(c, DET8_CHUNK_POS))
            got[name] = (run.lo.clone(), run.f.clone(), ms)
    lo, f, ms = got["serial"]
    for name, (clo, cf, cms) in got.items():
        check(torch.equal(clo, lo) and torch.equal(cf, f),
              f"det8 (c): the {name} intervals differ from the serial steps'")
    print(f"det8 (c) [{smi}] byte-16l ring {scfg.max_seq}, {b} lanes, positions "
          f"{DET8_PREFILL}-{n - 1}: the intervals of chunks of "
          f"{', '.join(str(c) for c in DET8_CHUNKS)} equal the serial steps' bit for bit; "
          + "; ".join(f"{name} {v[2]:.1f} ms ({v[2] / DET8_CHUNK_POS:.3f} ms a position)"
                      for name, v in got.items()), flush=True)


def det8_math_inputs(torch, n):
    """Seeded f32 inputs of each elementwise det8 function: exp's x <= 0
    (with -inf, 0 and the underflow edge), both signs for silu, gelu and the
    logits, positive values for sqrt and rsqrt over 60 binades."""
    rng = np.random.default_rng(SEED)
    neg = -np.abs(rng.standard_normal(n)) * rng.choice([0.01, 1.0, 10.0, 100.0], n)
    neg[:4] = [-np.inf, 0.0, -87.3, -126 * np.log(2)]
    both = rng.standard_normal(n) * rng.choice([0.1, 1.0, 5.0, 30.0], n)
    pos = np.abs(rng.standard_normal(n)) * np.exp2(rng.integers(-30, 30, n))
    logits = rng.standard_normal((n // 256, 256)) * rng.choice([0.1, 3.0, 20.0], (n // 256, 1))
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in
            (("neg", neg), ("both", both), ("pos", pos), ("logits", logits))}


def phase7_card_vs_cpu(torch, T, detmath, quantize, lm_engine, ttrain, smoke, root, dev, smi):
    """(d): the card against the CPU, bit for bit: each elementwise det8
    function on DET8_MATH_N seeded values, the rounding to bf16 (_act), the
    det8 CDF; byte-6l's det8 logits for DET8_LOGIT_POS positions, as one
    cached chunk and as serial steps, from an empty cache; the RoPE tables'
    crc32 against smoke.GOLDEN_DET8_ROPE and the device table's bytes."""
    x = det8_math_inputs(torch, DET8_MATH_N)
    bf16 = T.tiny_config(dtype=torch.bfloat16, det8=True)
    fns = {
        "det_exp": (detmath.det_exp, "neg"), "det_silu": (detmath.det_silu, "both"),
        "det_gelu_tanh": (detmath.det_gelu_tanh, "both"), "det_sqrt": (detmath.det_sqrt, "pos"),
        "det_rsqrt": (detmath.det_rsqrt, "pos"),
        "fma32": (lambda v: detmath.fma32(v, v * 0.75, -v), "both"),
        "_act (bf16)": (lambda v: T._act(bf16, v * 1e3), "both"),
        "quantize_logits(det)": (lambda v: quantize.quantize_logits(v, 16, det=True), "logits"),
    }
    for name, (fn, key) in fns.items():
        want, got = fn(x[key]), fn(x[key].to(dev)).cpu()
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"det8 (d): {name} on the card differs from the CPU in "
              f"{int((got != want).sum())} values")
    arr = np.frombuffer(smoke.smoke_corpus(4 * DET8_LOGIT_POS), dtype=np.uint8)
    toks = torch.from_numpy(arr.reshape(4, DET8_LOGIT_POS).astype(np.int64))
    out = {}
    for where in (torch.device("cpu"), dev):
        cfg, params = ttrain.load_checkpoint(os.path.join(root, smoke.LM_CHECKPOINT),
                                             device=where)
        cfg = dataclasses.replace(cfg, det8=True)
        p = T.ensure_det8(cfg, params)
        t = toks.to(where)
        with lm_engine._coding(where):
            chunk, _ = T.forward(cfg, p, t, T.init_cache(cfg, 4, 128, device=where))
            cache = T.init_cache(cfg, 4, 128, device=where)
            serial = torch.cat([T.forward(cfg, p, t[:, i : i + 1], cache)[0]
                                for i in range(DET8_LOGIT_POS)], 1)
        out[str(where)] = (chunk.cpu(), serial.cpu())
    (c_cpu, s_cpu), (c_dev, s_dev) = out["cpu"], out[str(dev)]
    check(torch.equal(c_cpu, s_cpu), "det8 (d): the CPU's chunk differs from its steps")
    for name, a in (("chunk", c_dev), ("serial steps", s_dev)):
        diff = int((a != c_cpu).sum())
        check(diff == 0, f"det8 (d): byte-6l's logits ({name}) on the card differ from the "
                         f"CPU's in {diff} of {a.numel()}")
    crcs = {}
    for n, crc in smoke.GOLDEN_DET8_ROPE.items():
        cos, sin = T.rope_table(n, 64, 10000.0)
        crcs[n] = zlib.crc32(sin.tobytes(), zlib.crc32(cos.tobytes()))
        on_card = T._rope_table_on(n, 64, 10000.0, dev).cpu().numpy()
        check(crcs[n] == crc and on_card.tobytes() == np.stack([cos, sin]).tobytes(),
              f"det8 (d): the RoPE tables at {n} positions (crc32 {crcs[n]}, golden {crc})")
    print(f"det8 (d) [{smi}]: the card equals the CPU bit for bit: {', '.join(fns)} on "
          f"{DET8_MATH_N} values each; byte-6l's det8 logits for {DET8_LOGIT_POS} positions "
          f"of 4 lanes, as one chunk and as serial steps; the RoPE tables' crc32 {crcs} "
          f"equal smoke.GOLDEN_DET8_ROPE and the device's copy", flush=True)


def phase7_steps(torch, T, lm_engine, step_graph, smoke, model, smi, float_ring):
    """(e): graph against eager, det8 steps at byte-16l's two ring shapes,
    beside phase 5 (c)'s float steps."""
    cfg, params = model
    ring = ring_steps(torch, T, lm_engine, step_graph, smoke, cfg, params, smi, "det8 (e)")
    for b, nums in ring.items():
        if float_ring is not None:
            print_beside(f"det8 (e) [{smi}] byte-16l ring 1024, {b} lanes, det8 against float",
                         nums, float_ring[b])


def flagship_det8(torch, T, ttrain, lm_api, container_mod, smoke, root, smi):
    """--flagship's det8 run: byte-16l, slide, block 16384, 16 lanes, on the
    whole held-out slice (lac_tpu's measurements/r4_slide_det8_b16k.log)."""
    data = smoke.heldout_slice()
    model = ttrain.load_checkpoint(os.path.join(root, smoke.SLIDE16_CHECKPOINT))
    kw = DET8_FLAGSHIP
    c, enc_ms = sync_time(torch, lambda: lm_api.lm_compress_bytes(
        data, model_ref="file:" + smoke.SLIDE16_CHECKPOINT, model=model, det8=True, **kw))
    out, dec_ms = sync_time(torch, lambda: lm_api.lm_decompress_bytes(c, model=model))
    check(out == data, "det8 flagship: round trip")
    header, blocks = container_mod.read_container(c)
    got = {k: header.config[k] for k in ("block_tokens", "lanes", "overlap", "window_mode",
                                         "slide_seg", "det8")}
    check(got == {**{k: kw[k] for k in got if k in kw}, "slide_seg": 0, "det8": True},
          f"det8 flagship header {got}")
    steps = kw["block_tokens"]
    bpb = 8 * len(c) / len(data)
    v5e_bpb, v5e_enc, v5e_dec = V5E_DET8_FLAGSHIP
    print(f"flagship det8 [{smi}] byte-16l, {got}: {len(data)} -> {len(c)} bytes, {bpb:.6f} "
          f"bits/byte (lac_tpu on a v5e: {v5e_bpb}, encode {v5e_enc} s, decode {v5e_dec} s; "
          f"context only); {sum(b.token_count > 0 for b in blocks)} of {len(blocks)} blocks "
          f"coded; round trip equal; encode {enc_ms / 1e3:.1f} s ({enc_ms / steps:.3f} ms a "
          f"position, chunked), decode {dec_ms / 1e3:.1f} s ({dec_ms / steps:.3f} ms a step), "
          f"{steps} positions a side, checkpoint load excluded", flush=True)


def flagship(torch, ttrain, lm_api, container_mod, smoke, root, smi):
    """--flagship: the shipped configuration on the whole held-out slice."""
    data = smoke.heldout_slice()
    model = ttrain.load_checkpoint(os.path.join(root, smoke.SLIDE16_CHECKPOINT))
    c, enc_ms = sync_time(torch, lambda: lm_api.lm_compress_bytes(
        data, model_ref="file:" + smoke.SLIDE16_CHECKPOINT, model=model, **FLAGSHIP))
    out, dec_ms = sync_time(torch, lambda: lm_api.lm_decompress_bytes(c, model=model))
    check(out == data, "flagship: round trip")
    header, blocks = container_mod.read_container(c)
    got = {k: header.config[k] for k in ("block_tokens", "lanes", "overlap", "window_mode",
                                         "slide_seg")}
    want = {k: FLAGSHIP[k] for k in got}
    check(got == want, f"flagship header {got}")
    steps = FLAGSHIP["block_tokens"]
    bpb = 8 * len(c) / len(data)
    print(f"flagship [{smi}] byte-16l, {got}: {len(data)} -> {len(c)} bytes, {bpb:.6f} "
          f"bits/byte (lac_tpu on a v5e: {V5E_FLAGSHIP_BPB}, relative "
          f"{bpb / V5E_FLAGSHIP_BPB - 1:+.2e}); {sum(b.token_count > 0 for b in blocks)} of "
          f"{len(blocks)} blocks coded; round trip equal; encode {enc_ms / 1e3:.1f} s "
          f"({enc_ms / steps:.3f} ms a step, {len(data) / (enc_ms / 1e3):.1f} tokens/s), decode "
          f"{dec_ms / 1e3:.1f} s ({dec_ms / steps:.3f} ms a step, "
          f"{len(data) / (dec_ms / 1e3):.1f} tokens/s), {steps} steps a side", flush=True)


def phase7(torch, T, cli, container, detmath, quantize, lm_engine, step_graph, ttrain, rk, A,
           smoke, root, work, corpus, dev, smi, float_bpb6, float_bpb16, float_ring):
    """Phase 7, det8 (a)-(f); ``float_ring``: phase 5 (c)'s steps, or None."""
    with Phase("phase 7: det8, the integer-reduction forward"):
        rk.reset_launches()
        A.reset_launches()
        phase7_cli(torch, cli, container, smoke, corpus, work, float_bpb6)
        phase5_cli(torch, cli, container, smoke, root, work, ("--det8",), float_bpb16)
        model = det8_byte16l(T, ttrain, smoke, root)
        phase7_chunks(torch, T, lm_engine, step_graph, smoke, model, smi)
        phase7_card_vs_cpu(torch, T, detmath, quantize, lm_engine, ttrain, smoke, root, dev,
                           smi)
        phase7_steps(torch, T, lm_engine, step_graph, smoke, model, smi, float_ring)
        counts = {**rk.launches, **A.launches}
        print(f"det8 (f) det8 path launches of K1-K12: {counts}", flush=True)
        check(set(counts.values()) == {0}, "the det8 path launched a TPU-kernel port")


# --------------------------------------------------------------------------
# Phase 8: the token alphabet and the scan codecs (no TPU kernel on either
# path, so K1-K12 must not launch)
# --------------------------------------------------------------------------


def zipf_ids(vocab: int, n: int, seed: int) -> np.ndarray:
    """Seeded Zipf ranks through a seeded permutation of the vocab, rank 1
    mapped to vocab - 1: int32 ids, many above 65,535 at vocab 128,256."""
    rng = np.random.default_rng(seed)
    ranks = (rng.zipf(TOK_ZIPF_A, n) - 1) % vocab
    perm = rng.permutation(vocab)
    top = int(np.flatnonzero(perm == vocab - 1)[0])
    perm[[1, top]] = perm[[top, 1]]
    return perm[ranks].astype(np.int32)


def phase8_llama3(torch, T, lm_api, lm_engine, container_mod, smi, dev):
    """(a): Llama-3-8B at full width, w8 (staged init) and kv8, through
    lm_compress_tokens / lm_decompress_tokens: 64 lanes x 512 ids, the
    header's alphabet, vocab, prob_bits 18 and length; then the det8 chunk's
    peak memory at Llama-3's vocab on a small det8 model."""
    import resource

    cfg = dataclasses.replace(T.LLAMA3_8B, w8=True, kv8=True)
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = sync_time(torch, lambda: T.init_params_w8(cfg, 0, device=dev))
    init_peak = torch.cuda.max_memory_allocated()
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    n = TOK_LANES * TOK_TOKENS
    ids = zipf_ids(cfg.vocab, n, SEED)
    check(bool((ids > 65535).any()) and bool((ids == cfg.vocab - 1).any()),
          "tokens (a): the ids miss the top of the vocab")
    kw = dict(block_tokens=TOK_TOKENS, lanes=TOK_LANES, prob_bits=16, cache_grow=128,
              window_mode="auto", kv8=True, w8=True)
    torch.cuda.reset_peak_memory_stats()
    c, enc_ms = sync_time(torch, lambda: lm_api.lm_compress_tokens(
        ids, TOK_REF, model=(cfg, params), **kw))
    back, dec_ms = sync_time(torch, lambda: lm_api.lm_decompress_tokens(c, model=(cfg, params)))
    peak = torch.cuda.max_memory_allocated()
    check(back.dtype == np.int32 and np.array_equal(back, ids),
          "tokens (a): the Llama-3-8B round trip differs")
    header, blocks = container_mod.read_container(c)
    got = {k: header.config[k] for k in ("alphabet", "vocab", "kv8", "w8", "det8", "lanes",
                                         "block_tokens", "window_mode")}
    want = {"alphabet": "tokens", "vocab": 128256, "kv8": True, "w8": True, "det8": False,
            "lanes": TOK_LANES, "block_tokens": TOK_TOKENS, "window_mode": "slide"}
    check(got == want and header.prob_bits == 18 and header.original_len == n,
          f"tokens (a): header {got}, prob_bits {header.prob_bits}, "
          f"original_len {header.original_len}")
    coded = sum(b.token_count > 0 for b in blocks)
    payload = sum(len(b.payload) for b in blocks)
    print(f"tokens (a) [{smi}] Llama-3-8B w8+kv8 ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads}, vocab {cfg.vocab}, rope theta "
          f"{cfg.rope_theta:g}; random weights, seed 0): init_params_w8 {init_ms / 1e3:.1f} s, "
          f"max_memory_allocated {init_peak} bytes, host max RSS {host_peak} bytes; "
          f"{TOK_LANES} lanes x {TOK_TOKENS} ids (Zipf a {TOK_ZIPF_A}, "
          f"{int((ids > 65535).sum())} above 65535), lm_compress_tokens at the CLI's LM "
          f"defaults: round trip exact; header {got}, prob_bits {header.prob_bits}, "
          f"original_len {header.original_len}; {n} -> {len(c)} bytes, "
          f"{8 * payload / n:.3f} bits a token (payload), {coded} of {len(blocks)} blocks "
          f"coded (raw >u4 is 32); encode {n / (enc_ms / 1e3):.1f} tokens/s "
          f"({enc_ms / TOK_TOKENS:.3f} ms a step), decode {n / (dec_ms / 1e3):.1f} tokens/s "
          f"({dec_ms / TOK_TOKENS:.3f} ms a step), fingerprint and waves included; "
          f"max_memory_allocated {peak} bytes", flush=True)
    del params
    torch.cuda.empty_cache()
    dcfg = T.tiny_config(vocab=cfg.vocab, det8=True)
    dparams = T.init_params(dcfg, 0, device=dev)
    chunk_ids = zipf_ids(cfg.vocab, TOK_LANES * 128, SEED + 1).reshape(TOK_LANES, 128)
    toks = torch.from_numpy(chunk_ids.astype(np.int64))
    lengths = torch.full((TOK_LANES,), 128, dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, ms = sync_time(torch, lambda: lm_engine.lm_encode(dcfg, dparams, toks.to(dev), lengths,
                                                         18, 128))
    print(f"tokens (a) [{smi}] det8's encode chunk at vocab {cfg.vocab}: one chunk of 128 "
          f"positions x {TOK_LANES} lanes on a det8 model of {dcfg.n_layers} layers, d "
          f"{dcfg.d_model}: peak {torch.cuda.max_memory_allocated() - base} bytes above the "
          f"model ({ms:.1f} ms)", flush=True)


def phase8_tokens_are_bytes(torch, ttrain, lm_api, container_mod, smoke, root, corpus,
                            float_bpb):
    """(b): byte-6l at smoke.LM_CODING on the corpus's first 32 KiB, the
    bytes as ids: the token container's blocks equal the byte container's,
    float (phase 4 (b)'s call) and det8 (phase 7 (a)'s, smoke.
    GOLDEN_DET8_PORT); each token container round-trips."""
    model = ttrain.load_checkpoint(os.path.join(root, smoke.LM_CHECKPOINT))
    data = corpus[: smoke.LM_BPB_BYTES]
    ids = np.frombuffer(data, dtype=np.uint8)
    ref = "file:" + smoke.LM_CHECKPOINT
    for det8 in (False, True):
        what = "det8" if det8 else "float"
        bc = lm_api.lm_compress_bytes(data, model_ref=ref, model=model, det8=det8,
                                      **smoke.LM_CODING)
        tc, enc_ms = sync_time(torch, lambda: lm_api.lm_compress_tokens(
            ids, model_ref=ref, model=model, det8=det8, **smoke.LM_CODING))
        back, dec_ms = sync_time(torch, lambda: lm_api.lm_decompress_tokens(tc, model=model))
        check(np.array_equal(back, ids), f"tokens (b) {what}: the round trip differs")
        (th, tblocks), (bh, bblocks) = (container_mod.read_container(x) for x in (tc, bc))
        check([(b.raw_len, b.token_count, b.payload) for b in tblocks]
              == [(b.raw_len, b.token_count, b.payload) for b in bblocks],
              f"tokens (b) {what}: the token container's blocks are not the byte container's")
        check(th.config == {**bh.config, "alphabet": "tokens", "vocab": 256},
              f"tokens (b) {what}: headers {th.config} / {bh.config}")
        bpb = 8 * len(bc) / len(data)
        if det8:
            against = (f"the byte container's crc32 and length {smoke.container_digest(bc)}, "
                       f"smoke.GOLDEN_DET8_PORT {smoke.GOLDEN_DET8_PORT}")
            check(smoke.container_digest(bc) == smoke.GOLDEN_DET8_PORT,
                  "tokens (b): the det8 byte container is not smoke.GOLDEN_DET8_PORT")
        else:
            against = (f"the byte container's {bpb:.6f} bits/byte, phase 4 (b)'s "
                       f"{'not run' if float_bpb is None else f'{float_bpb:.6f}'}")
            check(float_bpb is None or bpb == float_bpb,
                  f"tokens (b): the float byte container's {bpb} is not phase 4 (b)'s")
        print(f"tokens (b) byte-6l {what}, the bytes as ids (vocab 256, raw >u1): "
              f"{len(tblocks)} blocks ({sum(b.token_count > 0 for b in tblocks)} coded) "
              f"equal the byte container's, block for block; {against}; round trip equal; "
              f"encode {enc_ms / 1e3:.2f} s, decode {dec_ms / 1e3:.2f} s", flush=True)


def phase8_scan_report(torch, container_mod, smoke, smi, what, model, block, data, c, enc_ms,
                       dec_ms):
    """(c)'s check and line of one run: header, crc32 and length against
    smoke.GOLDEN_SCAN, MB/s a side, bits/byte, peak memory since the last
    reset."""
    header, _ = container_mod.read_container(c)
    check(header.model_id == model and header.config == {"block_size": block},
          f"scan (c) {what}: header {header.model_id} {header.config}")
    digest, mb = smoke.container_digest(c), len(data) / 1e6
    print(f"scan (c) [{smi}] {what}: {model}, block {block}, {len(data)} -> {len(c)} bytes, "
          f"{8 * len(c) / len(data):.6f} bits/byte; crc32 and length {digest}, "
          f"smoke.GOLDEN_SCAN {smoke.GOLDEN_SCAN[(model, block)]}; round trip equal; encode "
          f"{mb / (enc_ms / 1e3):.3f} MB/s ({enc_ms / 1e3:.1f} s), decode "
          f"{mb / (dec_ms / 1e3):.3f} MB/s ({dec_ms / 1e3:.1f} s), file I/O included; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes", flush=True)
    check(digest == smoke.GOLDEN_SCAN[(model, block)],
          f"scan (c) {what}: {digest} is not smoke.GOLDEN_SCAN's")


def phase8_scan(torch, cli, engine, container_mod, smoke, corpus, work, smi):
    """(c): the CLI's compress --model X at its defaults (block 4096) on the
    32 MiB corpus for each scan model, then engine.compress_bytes(corpus)
    at its own defaults (order0, block 65536); each decoded and compared."""
    path = os.path.join(work, "scan.bin")
    with open(path, "wb") as f:
        f.write(corpus)
    for model in SCAN_MODELS:
        torch.cuda.reset_peak_memory_stats()
        rc, enc_ms = sync_time(torch, lambda: cli.main(["compress", path, "--model", model,
                                                        "-o", path + ".lac"]))
        check(rc == 0, f"cli compress --model {model}")
        rc, dec_ms = sync_time(torch, lambda: cli.main(["decompress", path + ".lac", "-o",
                                                        path + ".out"]))
        check(rc == 0, f"cli decompress of the {model} container")
        with open(path + ".out", "rb") as f:
            check(f.read() == corpus, f"scan (c) {model}: the cli round trip differs")
        with open(path + ".lac", "rb") as f:
            c = f.read()
        phase8_scan_report(torch, container_mod, smoke, smi, f"cli --model {model}", model,
                           4096, corpus, c, enc_ms, dec_ms)
    torch.cuda.reset_peak_memory_stats()
    c, enc_ms = sync_time(torch, lambda: engine.compress_bytes(corpus))
    out, dec_ms = sync_time(torch, lambda: engine.decompress_bytes(c))
    check(out == corpus, "scan (c): engine.compress_bytes's default round trip differs")
    phase8_scan_report(torch, container_mod, smoke, smi, "engine.compress_bytes(data)",
                       "order0", 1 << 16, corpus, c, enc_ms, dec_ms)


# (d)'s CPU half, a child process with no card that runs while (a)-(c) hold
# the card: argv data path, output directory, threads, the model ids; it
# writes <dir>/<id>.cpu.lac and prints each encode's seconds
SCAN_CPU_CHILD = """
import json, os, sys, time
import torch
torch.set_num_threads(int(sys.argv[3]))
from lac_tpu_torch.runtime import engine
data = open(sys.argv[1], "rb").read()
for model in sys.argv[4:]:
    t0 = time.perf_counter()
    c = engine.compress_bytes(data, model_id=model, block_size=4096, device="cpu")
    seconds = time.perf_counter() - t0
    with open(os.path.join(sys.argv[2], model + ".cpu.lac"), "wb") as f:
        f.write(c)
    print(json.dumps({model: seconds}), flush=True)
"""


def phase8_cpu_start(root, work, corpus):
    """Start (d)'s CPU encodes of the corpus's first MiB in a child process
    that cannot see the card, on 4 of the host's threads."""
    path = os.path.join(work, "scan_head.bin")
    with open(path, "wb") as f:
        f.write(corpus[:SCAN_CPU_BYTES])
    return subprocess.Popen([sys.executable, "-c", SCAN_CPU_CHILD, path, work, "4", *SCAN_MODELS],
                            cwd=root, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                            stdout=subprocess.PIPE, text=True)


def phase8_card_vs_cpu(torch, engine, corpus, work, child):
    """(d): on the corpus's first MiB, each scan model's container on the
    card equals the port's on the CPU (``child``'s), byte for byte."""
    data = corpus[:SCAN_CPU_BYTES]
    out, _ = child.communicate(timeout=600)
    check(child.returncode == 0, f"scan (d): the CPU child exited {child.returncode}")
    cpu_s = {k: v for line in out.splitlines() for k, v in json.loads(line).items()}
    for model in SCAN_MODELS:
        card, card_ms = sync_time(torch, lambda: engine.compress_bytes(
            data, model_id=model, block_size=4096))
        with open(os.path.join(work, model + ".cpu.lac"), "rb") as f:
            cpu = f.read()
        check(card == cpu, f"scan (d) {model}: the card's container is not the CPU's")
        print(f"scan (d) {model}, block 4096, the first {len(data)} bytes: the card's container "
              f"({len(card)} bytes, crc32 {zlib.crc32(card)}) equals the CPU's; encode "
              f"{card_ms / 1e3:.2f} s on the card, {cpu_s[model]:.2f} s on the CPU (4 threads, "
              f"beside (a)-(c))", flush=True)


def phase8(torch, T, cli, container, engine, lm_api, lm_engine, ttrain, rk, A, smoke, root,
           work, corpus, dev, smi, float_bpb6):
    """Phase 8, the token alphabet and the scan codecs, (a)-(e);
    ``float_bpb6``: phase 4 (b)'s bits/byte, or None."""
    with Phase("phase 8: the token alphabet and the scan codecs"):
        rk.reset_launches()
        A.reset_launches()
        child = phase8_cpu_start(root, work, corpus)
        try:
            phase8_llama3(torch, T, lm_api, lm_engine, container, smi, dev)
            phase8_tokens_are_bytes(torch, ttrain, lm_api, container, smoke, root, corpus,
                                    float_bpb6)
            phase8_scan(torch, cli, engine, container, smoke, corpus, work, smi)
            phase8_card_vs_cpu(torch, engine, corpus, work, child)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        counts = {**rk.launches, **A.launches}
        print(f"tokens and scan (e) launches of K1-K12: {counts}", flush=True)
        check(set(counts.values()) == {0},
              "the token or scan path launched a TPU-kernel port")


def path_kernels(codec: str) -> tuple:
    return (f"{codec}_intervals", "rans32_encode", f"{codec}_decode")


def device_line(torch) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    os.chdir(root)  # phase 5's CLI names its checkpoint relative to the checkout
    from lac_tpu_torch import cli, smoke
    from lac_tpu_torch import train as ttrain
    from lac_tpu_torch.models import lm_registry
    from lac_tpu_torch.models import transformer as T
    from lac_tpu_torch.ops import _build
    from lac_tpu_torch.ops import attention as A
    from lac_tpu_torch.ops import detmath, int8, quantize
    from lac_tpu_torch.ops import rans_kernels as rk
    from lac_tpu_torch.runtime import engine, lm_api, lm_engine, step_graph, turbo
    from lac_tpu_torch.stream import container

    if sys.argv[1:] == ["--flagship"]:
        faulthandler.dump_traceback_later(FLAGSHIP_HANG_S, exit=True)
        smi = nvidia_smi_line()
        print(f"nvidia-smi: {smi}")
        with Phase("flagship: byte-16l slide, block 65536, 4 lanes"):
            flagship(torch, ttrain, lm_api, container, smoke, root, smi)
        with Phase("flagship: byte-16l det8, slide, block 16384, 16 lanes"):
            flagship_det8(torch, T, ttrain, lm_api, container, smoke, root, smi)
        print(smi)
        print(device_line(torch))
        return 0
    # one phase alone: --det8 (phase 7, its float comparisons against smoke's
    # goldens) and --phase8
    alone = {
        "--det8": lambda work, smi: phase7(
            torch, T, cli, container, detmath, quantize, lm_engine, step_graph, ttrain, rk, A,
            smoke, root, work, smoke.smoke_corpus(smoke.LM_BPB_BYTES), torch.device("cuda", 0),
            smi, smoke.GOLDEN_LM_BPB, smoke.GOLDEN_SLIDE16_BPB, None),
        "--phase8": lambda work, smi: phase8(
            torch, T, cli, container, engine, lm_api, lm_engine, ttrain, rk, A, smoke, root, work,
            smoke.smoke_corpus(), torch.device("cuda", 0), smi, None),
    }
    if len(sys.argv) == 2 and sys.argv[1] in alone:
        smi = nvidia_smi_line()
        print(f"nvidia-smi: {smi}")
        work = os.path.join(root, "smoke_work")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        try:
            alone[sys.argv[1]](work, smi)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(smi)
        print(device_line(torch))
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
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
            phase4_numbers(torch, T, lm_engine, step_graph, container, smoke, c_lm, waves,
                           enc_ms, dec_ms, lm_peak, lm_model, corpus, smi)
            print(f"lm (d) [{smi}] bits/byte of (b): {bpb_b:.6f}", flush=True)

        with Phase("phase 5: windowed LM coding"):
            rk.reset_launches()
            A.reset_launches()
            bpb16 = phase5_cli(torch, cli, container, smoke, root, work)
            phase5_byte6l(torch, ttrain, lm_api, smoke, root)
            float_ring = phase5_steps(torch, T, ttrain, lm_engine, step_graph, smoke, root, smi)
            window_counts = {**rk.launches, **A.launches}
            print(f"window path launches of K1-K12: {window_counts}", flush=True)
            check(set(window_counts.values()) == {0},
                  "the windowed path launched a TPU-kernel port")

        with Phase("phase 6: the int8 LM modes (kv8, w8)"):
            rk.reset_launches()
            A.reset_launches()
            phase6_cli(torch, cli, container, smoke, corpus, work)
            phase5_cli(torch, cli, container, smoke, root, work, ("--kv8", "--w8"), bpb16)
            tl = phase6_tinyllama(torch, T, lm_engine, corpus, smi, dev)
            phase6_steps(torch, T, ttrain, lm_engine, step_graph, smoke, root, smi, float_ring,
                         tl, corpus, dev)
            phase6_exact(torch, int8, lm_engine, dev)
            q8_counts = {**rk.launches, **A.launches}
            print(f"q8 (f) int8 path launches of K1-K12: {q8_counts}", flush=True)
            check(set(q8_counts.values()) == {0}, "the int8 LM path launched a TPU-kernel port")

        phase7(torch, T, cli, container, detmath, quantize, lm_engine, step_graph, ttrain, rk,
               A, smoke, root, work, corpus, dev, smi, bpb_b, bpb16, float_ring)
        phase8(torch, T, cli, container, engine, lm_api, lm_engine, ttrain, rk, A, smoke, root,
               work, corpus, dev, smi, bpb_b)

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
        print(device_line(torch))
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
