"""Command-line interface: ``python -m lac_tpu_torch compress|decompress|info|verify|recover|train|bench``.

Ports ``lac_tpu/cli.py``: ``compress`` (:24-70; every ``--model`` id of
:245-246: the turbo models order0n, order1n, order2n and order0c, the
scan models order0, markov1, order0d, markov1d and markov1c, whose
containers decode through ``runtime/engine.py``, and ``lm`` with every
flag of :252-291 and the same defaults: ``prng:byte-12l:0``, block 512,
64 lanes, prob_bits 16, cache_grow 128, window mode auto), ``decompress``
(:73-90, an ``lm`` container to ``lm_decompress_bytes``), ``verify``
(:93-108), ``recover`` (:109-149), ``info`` (:225-237) and ``train``
(:183-222, arguments :310-322) and ``bench`` (:150-182, arguments
:324-328), with the same defaults (order0n, block 4096, rate 4, which
reaches the turbo models only; train: byte-6l, 2000 steps, batch 32, seq
256, lr 3e-4). ``--model-ref hf:<dir-or-id>`` codes with a local
HuggingFace checkpoint (``models/hf_loader.py``).
The ``--device`` option picks the device; its default is ``cuda``, and the
CPU runs only with ``--device cpu``. As in the reference, ``train`` leaves
the fused attention off. ``--kv8`` and ``--w8`` (the int8 KV cache and
int8 weights) code with ``--model lm``, alone or together, and ``--det8``
(the integer-reduction forward, whose containers are the same on the CPU
and on the card) alone. ``--mesh-data`` / ``--mesh-model`` (:13-21, 45)
code an LM on a (data, model) mesh: under ``torchrun`` they take the
launched ranks (every rank runs the same command, rank 0 writes the
output); without a launch, a 1 x 1 mesh starts a one-rank group, and any
other refuses, naming ``torchrun --nproc-per-node``. ``decompress``
rebuilds a float container's mesh the same way. ``--trace FILE`` on
``compress`` and ``decompress`` installs a tracer for the command
(``metrics.tracing``) and appends its spans and counters to FILE as JSON
lines at the end. ``bench`` round-trips a
file through ``compress_bytes`` / ``decompress_bytes`` after one warm
run and prints the reference's JSON keys; each timed region ends with the
result in host bytes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _make_mesh_arg(args):
    """--mesh-data / --mesh-model -> a mesh, or None for the defaults (0 and
    1: no mesh); ``MeshConfig`` resolves the geometry."""
    if args.mesh_model == 1 and args.mesh_data == 0:
        return None
    from .config import MeshConfig

    try:
        return MeshConfig(data=args.mesh_data or -1, model=args.mesh_model).make(device=args.device)
    except ValueError as e:
        raise SystemExit(f"--mesh-data / --mesh-model: {e}") from e


def _is_rank0() -> bool:
    from .parallel.distributed import rank_and_size

    return rank_and_size()[0] == 0


def _write(dst: str, out: bytes) -> None:
    """Rank 0 writes the output (every rank holds the same bytes)."""
    if _is_rank0():
        with open(dst, "wb") as f:
            f.write(out)


def _lm_compress(args, data: bytes) -> bytes:
    from .config import LMCodingConfig
    from .runtime.lm_api import lm_compress_bytes

    cfg = LMCodingConfig(
        model_ref=args.model_ref,
        block_tokens=args.block_tokens,
        lanes=args.lanes,
        prob_bits=args.prob_bits,
        window=args.window,
        overlap=args.overlap,
        det8=args.det8,
        kv8=args.kv8,
        w8=args.w8,
        cache_grow=args.cache_grow,
        window_mode=args.window_mode,
        slide_seg=args.slide_seg,
    )
    return lm_compress_bytes(data, mesh=_make_mesh_arg(args), device=args.device,
                             **cfg.engine_kwargs())


def _cmd_compress(args) -> int:
    with open(args.file, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    if args.model == "lm":
        out = _lm_compress(args, data)
    else:
        from .config import ByteCodingConfig
        from .runtime.engine import compress_bytes

        cfg = ByteCodingConfig(
            model_id=args.model,
            block_size=args.block_size,
            prob_bits=args.prob_bits,
            rate=args.rate,
        )
        out = compress_bytes(data, device=args.device, **cfg.engine_kwargs())
    dt = time.perf_counter() - t0
    dst = args.output or args.file + ".lac"
    _write(dst, out)
    bpb = 8 * len(out) / max(1, len(data))
    if _is_rank0():
        print(
            f"{args.file}: {len(data)} -> {len(out)} bytes "
            f"({bpb:.4f} bpb, {len(data) / dt / 1e6:.2f} MB/s) -> {dst}"
        )
    return 0


def _cmd_decompress(args) -> int:
    from .stream.container import read_container

    with open(args.file, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    header, _ = read_container(data)
    if header.model_id == "lm":
        from .runtime.lm_api import lm_decompress_bytes

        out = lm_decompress_bytes(data, device=args.device)
    else:
        from .runtime.engine import decompress_bytes

        out = decompress_bytes(data, device=args.device)
    dt = time.perf_counter() - t0
    dst = args.output or (
        args.file[:-4] if args.file.endswith(".lac") else args.file + ".out"
    )
    _write(dst, out)
    if _is_rank0():
        print(f"{args.file}: {len(data)} -> {len(out)} bytes "
              f"({len(out) / dt / 1e6:.2f} MB/s) -> {dst}")
    return 0


TRACE_HELP = ("record the program's spans and counters (lac_tpu_torch.metrics) and append them "
              "to FILE as JSON lines at the end (rank 0)")


def _traced(args) -> int:
    """The command under a fresh tracer; rank 0 appends its records to
    ``args.trace``, also when the command raises."""
    from .metrics import JsonlLogger, tracing

    with tracing() as tracer:
        try:
            return args.fn(args)
        finally:
            if _is_rank0():
                logger = JsonlLogger(args.trace)
                try:
                    tracer.write(logger)
                finally:
                    logger.close()


def _cmd_verify(args) -> int:
    from .stream.container import verify_container

    with open(args.file, "rb") as f:
        rep = verify_container(f.read())
    print(
        f"codec={rep['codec']} model={rep['model_id']} blocks={rep['n_blocks']} "
        f"original_len={rep['original_len']}"
    )
    if rep["ok"]:
        print("all block checksums OK")
        return 0
    print(f"CORRUPT blocks (index, byte span): "
          f"{[(i, rep['block_spans'][i]) for i in rep['bad_blocks']]}")
    return 1


def _cmd_recover(args) -> int:
    """Recover the good prefix of a truncated or corrupt container: every
    intact block before the first damaged one. Exit code 1 unless the
    container was whole."""
    import dataclasses

    from .stream.container import scan_container, write_container

    with open(args.file, "rb") as f:
        data = f.read()
    header, blocks, bad = scan_container(data)
    if header.model_id == "lm":
        from .runtime.lm_api import lm_decompress_prefix

        out, rep = lm_decompress_prefix(data, device=args.device)
    else:
        from .runtime.engine import decompress_bytes

        ngood = bad[0] if bad else len(blocks)
        good = blocks[:ngood]
        h2 = dataclasses.replace(header, original_len=sum(b.raw_len for b in good))
        out = decompress_bytes(write_container(h2, good), device=args.device)
        rep = {
            "ok": not bad,
            "recovered_blocks": ngood,
            "total_blocks": len(blocks),
            "bad_blocks": bad,
            "recovered_bytes": len(out),
            "original_len": header.original_len,
        }
    dst = args.output or args.file + ".recovered"
    with open(dst, "wb") as f:
        f.write(out)
    print(
        f"recovered {rep['recovered_blocks']}/{rep['total_blocks']} blocks "
        f"({rep['recovered_bytes']}/{rep['original_len']} bytes) -> {dst}"
        + (f"; bad blocks {rep['bad_blocks']}" if rep["bad_blocks"] else "")
    )
    return 0 if rep["ok"] else 1


def _cmd_train(args) -> int:
    """Train a byte LM on FILE and save a checkpoint for the lm coding path."""
    import dataclasses

    from .models.lm_registry import PRESETS
    from .train import load_checkpoint, save_checkpoint, train_byte_lm

    with open(args.file, "rb") as f:
        corpus = f.read()
    cfg = PRESETS[args.preset]()
    init = None
    if args.init:
        icfg, init = load_checkpoint(args.init, device=args.device)
        # the checkpoint's max_seq may be capped below the preset's; all
        # other architecture fields must match for the params to fit
        if dataclasses.replace(icfg, max_seq=cfg.max_seq) != cfg:
            raise SystemExit(
                f"--init checkpoint architecture does not match preset '{args.preset}'"
            )
    params, losses = train_byte_lm(
        cfg, corpus, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=args.lr, seed=args.seed, log_every=max(1, args.steps // 20),
        init=init, device=args.device,
    )
    # cap the checkpoint's usable context at the training length (RoPE
    # positions past it degrade; lac_tpu/cli.py:205-210)
    save_checkpoint(
        args.output, dataclasses.replace(cfg, max_seq=min(cfg.max_seq, args.seq)), params,
    )
    print(f"saved {args.output} (final loss {losses[-1]:.4f} nats, "
          f"{losses[-1] / 0.6931:.3f} bits/byte train)")
    return 0


def _cmd_bench(args) -> int:
    """Round-trip benchmark on FILE: compress, decompress, verify, report."""
    import json

    from .config import ByteCodingConfig
    from .runtime.engine import compress_bytes, decompress_bytes

    with open(args.file, "rb") as f:
        data = f.read()
    cfg = ByteCodingConfig(model_id=args.model, block_size=args.block_size,
                           prob_bits=args.prob_bits)
    kw = dict(device=args.device, **cfg.engine_kwargs())
    compress_bytes(data, **kw)  # warm: builds, caches and graphs
    t0 = time.perf_counter()
    out = compress_bytes(data, **kw)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = decompress_bytes(out, device=args.device)
    t_dec = time.perf_counter() - t0
    ok = back == data
    print(json.dumps({
        "file": args.file,
        "model": args.model,
        "bytes": len(data),
        "compressed": len(out),
        "bits_per_byte": round(8 * len(out) / max(1, len(data)), 4),
        "encode_MBps": round(len(data) / t_enc / 1e6, 3),
        "decode_MBps": round(len(data) / t_dec / 1e6, 3),
        "roundtrip_ok": ok,
    }))
    return 0 if ok else 1


def _cmd_info(args) -> int:
    from .stream.container import read_container

    with open(args.file, "rb") as f:
        header, blocks = read_container(f.read())
    total_payload = sum(len(b.payload) for b in blocks)
    print(f"codec={header.codec} prob_bits={header.prob_bits} model={header.model_id}")
    print(f"config={header.config}")
    print(f"original_len={header.original_len} blocks={len(blocks)} payload={total_payload}B")
    if header.original_len:
        print(f"ratio={8 * total_payload / header.original_len:.4f} bpb (payload only)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lac_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="compress FILE into a .lac container")
    c.add_argument("file")
    c.add_argument("-o", "--output")
    c.add_argument("--model", default="order0n",
                   help="model id: order0n (fast) / order1n / order2n (ratio; block>=4096) / "
                        "order0c (turbo), order0/markov1[cd] (scan), lm")
    c.add_argument("--block-size", type=int, default=1 << 12)
    c.add_argument("--prob-bits", type=int, default=16)
    c.add_argument("--rate", type=int, default=4,
                   help="adaptation rate base (turbo byte models)")
    c.add_argument("--model-ref", default="prng:byte-12l:0",
                   help="LM predictor ref (prng:<preset>:<seed>, hf:<path> or file:<path>)")
    c.add_argument("--block-tokens", type=int, default=512)
    c.add_argument("--lanes", type=int, default=64)
    c.add_argument("--window", type=int, default=None,
                   help="LM context window cap in tokens (default: model context)")
    c.add_argument("--cache-grow", type=int, default=128, metavar="B",
                   help="KV-cache growth bucket for LM coding (0 = fixed width; "
                        "the schedule is recorded in the container)")
    c.add_argument("--overlap", type=int, default=2,
                   help="window re-prime keep fraction denominator")
    c.add_argument("--window-mode", choices=("auto", "reprime", "slide"), default="auto",
                   help="blocks past the model context: reprime or slide; auto = "
                        "slide for rope models, recorded resolved in the container")
    c.add_argument("--slide-seg", type=int, default=None, metavar="S",
                   help="float slide-mode segment length (recorded in the container)")
    c.add_argument("--w8", action="store_true",
                   help="int8 weights (W8A8 projections; changes the bitstream, recorded in "
                        "the container; combinable with --kv8)")
    c.add_argument("--kv8", action="store_true",
                   help="int8 KV cache (changes the bitstream, recorded in the container)")
    c.add_argument("--det8", action="store_true",
                   help="integer-reduction LM forward: the same container on the CPU and "
                        "the card (recorded in the container; not with --kv8 or --w8)")
    c.add_argument("--mesh-data", type=int, default=0,
                   help="device mesh data-parallel span (0 = no mesh / every rank left; "
                        "lm only; ranks from torchrun --nproc-per-node)")
    c.add_argument("--mesh-model", type=int, default=1,
                   help="device mesh tensor-parallel span (lm only)")
    c.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    c.add_argument("--trace", metavar="FILE", default=None, help=TRACE_HELP)
    c.set_defaults(fn=_cmd_compress)

    d = sub.add_parser("decompress", help="decompress a .lac container")
    d.add_argument("file")
    d.add_argument("-o", "--output")
    d.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    d.add_argument("--trace", metavar="FILE", default=None, help=TRACE_HELP)
    d.set_defaults(fn=_cmd_decompress)

    i = sub.add_parser("info", help="show container metadata")
    i.add_argument("file")
    i.set_defaults(fn=_cmd_info)

    v = sub.add_parser("verify", help="check per-block checksums of a .lac container")
    v.add_argument("file")
    v.set_defaults(fn=_cmd_verify)

    r = sub.add_parser("recover",
                       help="decode the good prefix of a truncated/corrupt container")
    r.add_argument("file")
    r.add_argument("-o", "--output")
    r.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    r.set_defaults(fn=_cmd_recover)

    t = sub.add_parser("train", help="train a byte LM on FILE for the lm coding path")
    t.add_argument("file")
    t.add_argument("-o", "--output", default="byte_lm.npz")
    t.add_argument("--preset", default="byte-6l")
    t.add_argument("--steps", type=int, default=2000)
    t.add_argument("--batch", type=int, default=32)
    t.add_argument("--seq", type=int, default=256)
    t.add_argument("--lr", type=float, default=3e-4)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--init", default=None, metavar="CKPT",
                   help="warm-start from an existing checkpoint "
                        "(continuation/fine-tune; preset must match)")
    t.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    t.set_defaults(fn=_cmd_train)

    b = sub.add_parser("bench", help="round-trip benchmark on FILE")
    b.add_argument("file")
    b.add_argument("--model", default="order0n")
    b.add_argument("--block-size", type=int, default=1 << 12)
    b.add_argument("--prob-bits", type=int, default=16)
    b.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    b.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    import torch.distributed as dist

    from .parallel.distributed import distributed_init

    had_group = dist.is_initialized()
    if not had_group and int(os.environ.get("WORLD_SIZE", "1")) > 1 and hasattr(args, "device"):
        distributed_init(device=args.device)  # a torchrun launch: join its ranks
    try:
        if getattr(args, "trace", None):
            return _traced(args)
        return args.fn(args)
    finally:
        if not had_group and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
