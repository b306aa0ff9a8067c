"""One rank of the port's multi-process tests (``tests/test_torch_dist.py``,
``tests/test_torch_mesh.py``), on the CPU over gloo, and the tests' launcher.

    python tests/torch_dist_worker.py RANK WORLD RENDEZVOUS OUT CKPT

RENDEZVOUS is a file for ``file://`` rendezvous (not a TCP port: several
test workers launch at once), OUT a directory, CKPT a byte-LM checkpoint.
The rank joins a gloo group of WORLD ranks (60 s collective timeout), runs
every scenario of its world size and writes what it got to
``OUT/<name>.r<RANK>``: containers as bytes, arrays as ``.npy``, refusal
messages as text. A scenario that fails raises, so the rank exits
non-zero. It imports torch, numpy and lac_tpu_torch only.
"""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lac_tpu_torch import smoke  # noqa: E402
from lac_tpu_torch.models import transformer as T  # noqa: E402
from lac_tpu_torch.models.lm_registry import resolve_lm  # noqa: E402
from lac_tpu_torch.parallel import make_mesh, shard_params  # noqa: E402
from lac_tpu_torch.parallel.distributed import distributed_init  # noqa: E402
from lac_tpu_torch.runtime import dist as D  # noqa: E402
from lac_tpu_torch.runtime import lm_api  # noqa: E402
from lac_tpu_torch.train import save_checkpoint, train_byte_lm  # noqa: E402

CPU = "cpu"
BYTES = smoke.smoke_corpus(6000)
LM_DATA = smoke.smoke_corpus(1 << 17)[-600:]
# block 60, 4 lanes, growth 16: 10 blocks in waves of 4, 4 and 2
LM_CALL = dict(block_tokens=60, lanes=4, cache_grow=16, device=CPU)
MODES = {"float": {}, "kv8": {"kv8": True}, "w8": {"w8": True}, "det8": {"det8": True}}
CODECS = ("order0n", "order1n", "order2n", "order0c")
TRAIN = dict(steps=3, batch=4, seq=32, lr=3e-3, seed=0, log_every=1, device=CPU)
LOGIT_TOKENS = np.random.default_rng(2).integers(0, 256, (4, 8))


def checkpoint(path: str) -> str:
    """Write the tests' model to ``path``: the tiny f32 config with one layer
    and a 64-token context, trained 60 steps (it codes ``LM_DATA``, where
    random weights would store every block raw); returns its model_ref."""
    torch.manual_seed(0)
    cfg = T.tiny_config(max_seq=64, n_layers=1)
    model, _ = train_byte_lm(cfg, smoke.smoke_corpus(1 << 16), steps=60, batch=8, seq=63,
                             lr=3e-3, seed=0, device=CPU)
    save_checkpoint(path, cfg, model)
    return "file:" + path


class Launch:
    """WORLD ranks of this file, started at once; ``wait`` joins them (180 s
    at most, then kills them) and fails with a rank's output if one failed."""

    TIMEOUT_S = 180

    def __init__(self, world: int, out: str, ref: str):
        self.out = out
        rdv = os.path.join(out, "rendezvous")
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, str(r), str(world), rdv, out, ref[len("file:"):]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
        self.done = None

    def wait(self) -> str:
        if self.done is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=self.TIMEOUT_S)[0].decode())
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in
                   enumerate(zip(self.procs, logs)) if p.returncode != 0]
            self.done = bad
        assert not self.done, f"ranks failed: {self.done}"
        return self.out

    def read(self, name: str, rank: int = 0):
        path = os.path.join(self.wait(), f"{name}.r{rank}")
        if os.path.exists(path + ".npy"):
            return np.load(path + ".npy")
        with open(path, "rb") as f:
            return f.read()


def save(out: str, name: str, rank: int, value) -> None:
    path = os.path.join(out, f"{name}.r{rank}")
    if isinstance(value, np.ndarray):
        np.save(path + ".npy", value)
    else:
        with open(path, "wb") as f:
            f.write(value if isinstance(value, bytes) else str(value).encode())


def refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("not refused")


def spans(out: str, rank: int, ref: str) -> None:
    """The block-span paths over the world: the four byte codecs, then
    float and det8 LM containers."""
    for model in CODECS:
        c = D.compress_distributed(BYTES, block_size=1024, model=model, device=CPU)
        assert D.decompress_distributed(c, device=CPU) == BYTES, model
        save(out, f"bytes-{model}", rank, c)
    for mode in ("float", "det8"):
        c = D.lm_compress_distributed(LM_DATA, model_ref=ref, **MODES[mode], **LM_CALL)
        assert D.lm_decompress_distributed(c, device=CPU) == LM_DATA, mode
        save(out, f"span-{mode}", rank, c)


def meshes(out: str, rank: int, ref: str, geometry: tuple[int, int]) -> None:
    """Every forward mode on a data x model mesh: the container, and its
    round trip with the mesh rebuilt from the header."""
    mesh = make_mesh(*geometry, device=CPU)
    tag = "x".join(map(str, geometry))
    for mode, kw in MODES.items():
        c = lm_api.lm_compress_bytes(LM_DATA, model_ref=ref, mesh=mesh, **kw, **LM_CALL)
        assert lm_api.lm_decompress_bytes(c, device=CPU) == LM_DATA, (tag, mode)
        save(out, f"mesh{tag}-{mode}", rank, c)
    c = D.lm_compress_distributed(LM_DATA, model_ref=ref, mesh=mesh, **LM_CALL)
    assert D.lm_decompress_distributed(c, mesh=mesh, device=CPU) == LM_DATA, tag
    save(out, f"dist-mesh{tag}", rank, c)


def two(out: str, rank: int, ref: str) -> None:
    spans(out, rank, ref)
    meshes(out, rank, ref, (1, 2))
    meshes(out, rank, ref, (2, 1))
    tp, dp = make_mesh(1, 2, device=CPU), make_mesh(2, 1, device=CPU)
    # the refusals: another geometry, and a meshless float container
    c = open(os.path.join(out, f"mesh1x2-float.r{rank}"), "rb").read()
    save(out, "refuse-geometry", rank, refusal(lambda: lm_api.lm_decompress_bytes(
        c, mesh=dp, device=CPU)))
    plain = lm_api.lm_compress_bytes(LM_DATA, model_ref=ref, **LM_CALL)
    save(out, "refuse-meshless", rank, refusal(lambda: lm_api.lm_decompress_bytes(
        plain, mesh=tp, device=CPU)))
    # float logits of the tensor-parallel model: a prefill, then 2 cached steps
    cfg, params = resolve_lm(ref, device=CPU)
    sharded = shard_params(tp, params, cfg)
    toks = torch.from_numpy(LOGIT_TOKENS)
    with torch.inference_mode():
        save(out, "logits-prefill", rank, T.forward(cfg, sharded, toks, prefill=True).numpy())
        cache = T.init_cache(cfg, len(toks), 16, device=CPU, kv_heads=T.kv_heads(cfg, sharded))
        first, _ = T.forward(cfg, sharded, toks[:, :6], cache)
        second, _ = T.forward(cfg, sharded, toks[:, 6:], cache)
    save(out, "logits-cached", rank, torch.cat([first, second], 1).numpy())
    # data-parallel training over the 2 x 1 mesh
    tcfg = T.tiny_config(max_seq=64, n_layers=1)
    model, losses = train_byte_lm(tcfg, smoke.smoke_corpus(1 << 16), mesh=dp, **TRAIN)
    save(out, "train-losses", rank, np.asarray(losses, dtype=np.float64))
    save(out, "train-params", rank, np.concatenate(
        [p.detach().reshape(-1).numpy() for p in model.parameters()]))


def four(out: str, rank: int, ref: str) -> None:
    spans(out, rank, ref)
    meshes(out, rank, ref, (2, 2))


def main() -> None:
    rank, world, rdv, out, ckpt = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    distributed_init("file://" + rdv, world, rank, device=CPU, timeout=60)
    try:
        {2: two, 4: four}[world](out, rank, "file:" + ckpt)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
