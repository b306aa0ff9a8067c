"""Time the cached step's attention on the card at byte-16l's step shapes.

    python tools/step_attn_bench.py [--layers 16] [--reps 20]

For each cache width W of byte-16l's coding call (128, 256, 384, 512; 64
lanes, 8 heads, head dim 64, bf16) at ``pos = W`` (every slot live), over
``--layers`` distinct cache slices in turn, as a step walks its layers (so
the 50 MB L2 cache holds none of them), captured as one CUDA graph as the
coding step is: the kernel's device ms a layer (``ops/step_attention.py``,
CUDA events over ``--reps`` replays), its bound
(the live K/V bytes over 3.35 TB/s), the plain version's ms (the float
route the kernel replaced) and, as the library yardstick only,
``torch.nn.functional.scaled_dot_product_attention`` on the same K/V
(views with the fresh row appended, no copy timed). Prints the card's name
and power limit first, then one JSON line a width. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lac_tpu_torch.models.transformer import _scale_f32  # noqa: E402
from lac_tpu_torch.ops import step_attention as SA  # noqa: E402

HBM_BYTES_S = 3.35e12
B, H, KVH, DH = 64, 8, 8, 64


def _ms(fn, layers: int, reps: int) -> float:
    """Mean device ms of ``fn(layer)``: one pass over every layer captured
    as a CUDA graph, as the coding step runs, its replays timed with CUDA
    events (so the host's launch work is not timed)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in range(layers):  # eager first, as the step runner does
            fn(i)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(layers):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * layers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    scale = _scale_f32(DH)
    for w in (128, 256, 384, 512):
        def draw(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

        cache, fresh = draw(2, args.layers, B, w, KVH, DH), draw(2, args.layers, B, 1, KVH, DH)
        q, pos = draw(B, 1, H, DH), torch.tensor(w, device=dev)
        keys = torch.cat([cache, fresh], dim=3).transpose(3, 4)  # SDPA's [.., B, H, W + 1, Dh]
        qh = q.transpose(1, 2)

        def kernel(i):
            return SA.step_attention(q, fresh[0, i], fresh[1, i], cache[0, i], cache[1, i], pos,
                                     scale)

        def plain(i):
            return SA.step_attention_plain(q, fresh[0, i], fresh[1, i], cache[0, i],
                                           cache[1, i], pos, scale)

        def sdpa(i):
            return torch.nn.functional.scaled_dot_product_attention(qh, keys[0, i], keys[1, i],
                                                                    scale=scale)

        live = 2 * B * w * KVH * DH * 2
        k_ms = _ms(kernel, args.layers, args.reps)
        print(json.dumps({
            "W": w, "pos": w, "lanes": B, "heads": H, "kernel_ms": round(k_ms, 5),
            "bound_ms": round(live / HBM_BYTES_S * 1e3, 5),
            "roofline_pct": round(100 * live / HBM_BYTES_S * 1e3 / k_ms, 2),
            "plain_ms": round(_ms(plain, args.layers, args.reps), 5),
            "sdpa_ms": round(_ms(sdpa, args.layers, args.reps), 5),
        }), flush=True)
        del cache, fresh, keys
    return 0


if __name__ == "__main__":
    sys.exit(main())
