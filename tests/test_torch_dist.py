"""The port's multi-process coding (``lac_tpu_torch/runtime/dist.py``,
``parallel/distributed.py``) and its (data, model) mesh at two ranks
(``parallel/mesh.py``, ``parallel/shard.py``, the mesh paths of
``runtime/lm_api.py`` and ``train.py``) against lac_tpu on the CPU.

One process: ``compress_distributed`` against lac_tpu's ``turbo_compress``
for the four codecs, the large-block nibble decode
(``tests/test_distributed.py:155``), ``my_block_span`` against the
reference's formula, the LM entry points against ``lm_compress_bytes``. Two
ranks (one module-scoped launch of ``tests/torch_dist_worker.py`` over
gloo, started before the first test; ``file://`` rendezvous in a
temporary directory, 60 s collective and 180 s process timeouts): the
block-span paths, the 1 x 2 (tensor-parallel) and 2 x 1 (data-parallel)
meshes in every forward mode, the refusals, the tensor-parallel logits
and two data-parallel training steps.

Every container comparison is ``==`` on the bytes (or on every block's
bytes, where the headers differ by the mesh). The tolerances:
- ``LOGIT_TOL``, 2e-5 of max |logit| (floored at 1): the tensor-parallel
  float logits against the unsharded port's and against lac_tpu's on the
  same 1 x 2 geometry (GSPMD). The all-reduce sums the f32 partial
  products of ``wo`` and ``w_down`` in another order (measured 3.5e-7);
  the bound is ``tests/test_torch_transformer.py``'s for f32 models.
- ``TRAIN_TOL``, 1e-6 absolute on the losses (about 6) and the parameters
  (about 1): the gradients' mean over two ranks adds in another order than
  one batch's (measured 6e-8 after 3 steps).
Float and kv8 containers on a tensor-parallel mesh differ from the
meshless ones by design (the geometry is part of the float bitstream);
w8 and det8 reduce in int32 across the ranks and equal them bit for bit.
det8 is also held to lac_tpu's with its ``det_rsqrt`` patched (C4), as
``tests/test_torch_det8.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lac_tpu.models import transformer as JT
from lac_tpu.parallel.distributed import my_block_span as ref_block_span
from lac_tpu.parallel.mesh import make_mesh as j_make_mesh
from lac_tpu.parallel.shard import shard_params as j_shard_params
from lac_tpu.runtime import lm_api as japi
from lac_tpu.runtime.turbo import turbo_compress as j_turbo_compress
from lac_tpu.train import load_checkpoint as j_load_checkpoint
from lac_tpu_torch.models import transformer as T
from lac_tpu_torch.models.lm_registry import resolve_lm
from lac_tpu_torch.parallel import distributed as PD
from lac_tpu_torch.runtime import dist as D
from lac_tpu_torch.runtime import lm_api, turbo
from lac_tpu_torch.smoke import smoke_corpus
from lac_tpu_torch.stream.container import read_container
from lac_tpu_torch.train import train_byte_lm
import torch_dist_worker as W

LOGIT_TOL = 2e-5
TRAIN_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The tests' checkpoint (``W.checkpoint``), as a model_ref."""
    return W.checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny.npz"))


@pytest.fixture(autouse=True, scope="module")
def two(ref, tmp_path_factory):
    """The two-rank launch, started before the module's first test."""
    return W.Launch(2, str(tmp_path_factory.mktemp("two")), ref)


@pytest.fixture(scope="module")
def j_turbo():
    """lac_tpu's single-process turbo containers of ``W.BYTES``."""
    return {m: j_turbo_compress(W.BYTES, block_size=1024, model=m) for m in W.CODECS}


@pytest.fixture(scope="module")
def single(ref):
    """The port's meshless single-process LM containers, by forward mode."""
    return {mode: lm_api.lm_compress_bytes(W.LM_DATA, model_ref=ref, **kw, **W.LM_CALL)
            for mode, kw in W.MODES.items()}


def _two_op_rsqrt(x):
    return jnp.float32(1.0) / jax.lax.optimization_barrier(jnp.sqrt(x.astype(jnp.float32)))


@pytest.fixture(scope="module")
def j_det8(ref):
    """lac_tpu's det8 container of ``W.LM_DATA`` with ``det_rsqrt`` as
    documented (``tests/test_torch_det8.py``'s patch)."""
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "det_rsqrt", _two_op_rsqrt)
        call = {k: v for k, v in W.LM_CALL.items() if k != "device"}
        c = japi.lm_compress_bytes(W.LM_DATA, model_ref=ref,
                                   model=j_load_checkpoint(ref[len("file:"):]), det8=True,
                                   **call)
    jax.clear_caches()
    return c


def _blocks(c: bytes) -> list:
    return [(b.raw_len, b.token_count, b.payload) for b in read_container(c)[1]]


# --------------------------------------------------------------------------
# One process
# --------------------------------------------------------------------------


@pytest.mark.parametrize("model", W.CODECS)
def test_compress_distributed_is_turbo_compress(model, j_turbo):
    """One rank: the container equals lac_tpu's ``turbo_compress`` and
    decodes."""
    c = D.compress_distributed(W.BYTES, block_size=1024, model=model, device="cpu")
    assert c == j_turbo[model]
    assert D.decompress_distributed(c, device="cpu") == W.BYTES


def test_distributed_decode_large_blocks_nibble():
    """The decode grid is sized from the span's payloads (the reference's
    regression at block 4096, ``tests/test_distributed.py:155``)."""
    rng = np.random.default_rng(11)
    data = bytes(rng.integers(32, 120, 5 * 4096 + 777, dtype=np.uint8))
    c = D.compress_distributed(data, block_size=4096, model="order0n", device="cpu")
    assert c == turbo.turbo_compress(data, block_size=4096, model="order0n", device="cpu")
    assert D.decompress_distributed(c, device="cpu") == data


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("n_blocks", [1, 5, 8, 13])
def test_my_block_span_is_the_reference(n_blocks, world):
    spans = [PD.my_block_span(n_blocks, r, world) for r in range(world)]
    assert spans == [ref_block_span(n_blocks, r, world) for r in range(world)]
    assert spans[0][0] == 0 and spans[-1][1] == n_blocks
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_world_of_one():
    """Without a process group: no-op init, the whole span, gathers that
    return their input, and a refusal of a short payload list."""
    PD.distributed_init(num_processes=1, device="cpu")
    assert not torch.distributed.is_initialized()
    assert PD.my_block_span(7) == (0, 7)
    assert PD.allgather_blocks([b"a", b"bc"], 2) == [b"a", b"bc"]
    assert PD.allgather_lists([b"a"], 3) == [[b"a", b"", b""]]
    with pytest.raises(ValueError, match="payloads for"):
        PD.allgather_blocks([b"a"], 2)


@pytest.mark.parametrize("mode", ["float", "det8"])
def test_lm_distributed_one_process(mode, ref, single):
    c = D.lm_compress_distributed(W.LM_DATA, model_ref=ref, **W.MODES[mode], **W.LM_CALL)
    assert c == single[mode]
    assert sum(b[1] > 0 for b in _blocks(c)) == len(_blocks(c))  # the model codes
    assert D.lm_decompress_distributed(c, device="cpu") == W.LM_DATA


# --------------------------------------------------------------------------
# Two ranks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("model", W.CODECS)
def test_two_ranks_byte_container(model, two, j_turbo):
    """Both ranks' containers equal lac_tpu's one-process container (each
    rank checked its round trip)."""
    for rank in range(2):
        assert two.read(f"bytes-{model}", rank) == j_turbo[model]


@pytest.mark.parametrize("mode", ["float", "det8"])
def test_two_ranks_lm_spans(mode, two, single):
    for rank in range(2):
        assert two.read(f"span-{mode}", rank) == single[mode]


@pytest.mark.parametrize("mode", sorted(W.MODES))
@pytest.mark.parametrize("geometry", ["1x2", "2x1"])
def test_two_rank_mesh_containers(geometry, mode, two, single):
    """Each mode's container on the mesh: the same on both ranks, its
    geometry in the header, its other keys and every block as the meshless
    container's where the bits cannot depend on the mesh (w8 and det8: exact
    integer reductions; any mode at model 1: no reduction is split)."""
    c = two.read(f"mesh{geometry}-{mode}")
    assert two.read(f"mesh{geometry}-{mode}", 1) == c
    (h, _), (hs, _) = read_container(c), read_container(single[mode])
    data, model = map(int, geometry.split("x"))
    assert h.config["mesh"] == {"data": data, "model": model}
    keys = set(h.config) - {"mesh", "fingerprint"}
    assert {k: h.config[k] for k in keys} == {k: hs.config[k] for k in keys}
    if mode in ("w8", "det8") or model == 1:
        assert _blocks(c) == _blocks(single[mode])
    assert sum(b[1] > 0 for b in _blocks(c)) == len(_blocks(c))


@pytest.mark.parametrize("geometry", ["1x2", "2x1"])
def test_det8_mesh_container_is_patched_lac_tpus(geometry, two, j_det8):
    assert _blocks(two.read(f"mesh{geometry}-det8")) == _blocks(j_det8)


@pytest.mark.parametrize("geometry", ["1x2", "2x1"])
def test_lm_compress_distributed_on_a_mesh(geometry, two):
    """``lm_compress_distributed`` on a mesh is ``lm_compress_bytes`` on it."""
    assert two.read(f"dist-mesh{geometry}") == two.read(f"mesh{geometry}-float")


@pytest.mark.parametrize("kind,match", [("geometry", "!= encode mesh"),
                                        ("meshless", "encoded without a mesh")])
def test_two_rank_refusals(kind, match, two):
    """A float container refuses another geometry; a meshless float
    container refuses a mesh."""
    assert match in two.read(f"refuse-{kind}").decode()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


@pytest.fixture(scope="module")
def logits_ref(ref):
    """(port unsharded, lac_tpu on a 1 x 2 mesh) logits of ``W.LOGIT_TOKENS``:
    a prefill, and a cache of 16 slots fed 6 tokens then 2."""
    cfg, params = resolve_lm(ref, device="cpu")
    toks = torch.from_numpy(W.LOGIT_TOKENS)
    with torch.inference_mode():
        prefill = T.forward(cfg, params, toks, prefill=True).numpy()
        cache = T.init_cache(cfg, len(toks), 16, device="cpu")
        a, _ = T.forward(cfg, params, toks[:, :6], cache)
        b, _ = T.forward(cfg, params, toks[:, 6:], cache)
    jcfg, jparams = j_load_checkpoint(ref[len("file:"):])
    sharded = j_shard_params(j_make_mesh(data=1, model=2, devices=jax.devices()[:2]), jparams)
    fwd = jax.jit(JT.forward, static_argnums=0, static_argnames=("prefill",))
    jt = jnp.asarray(W.LOGIT_TOKENS)
    jp, _ = fwd(jcfg, sharded, jt, JT.init_cache(jcfg, 4, window=8), prefill=True)
    jc = JT.init_cache(jcfg, 4, window=16)
    ja, jc = fwd(jcfg, sharded, jt[:, :6], jc)
    jb, _ = fwd(jcfg, sharded, jt[:, 6:], jc)
    return {"prefill": (prefill, np.asarray(jp)),
            "cached": (torch.cat([a, b], 1).numpy(), np.concatenate([ja, jb], 1))}


@pytest.mark.parametrize("kind", ["prefill", "cached"])
def test_tensor_parallel_logits(kind, two, logits_ref):
    got = two.read(f"logits-{kind}")
    assert np.array_equal(got, two.read(f"logits-{kind}", 1))
    unsharded, jax_tp = logits_ref[kind]
    assert got.shape == unsharded.shape == jax_tp.shape
    assert _rel(got, unsharded) <= LOGIT_TOL
    assert _rel(got, jax_tp) <= LOGIT_TOL


def test_data_parallel_training(two):
    """Three steps of batch 4 over two data ranks (2 rows each) against one
    process: the losses and parameters within ``TRAIN_TOL``, the ranks'
    parameters equal."""
    cfg = T.tiny_config(max_seq=64, n_layers=1)
    model, losses = train_byte_lm(cfg, smoke_corpus(1 << 16), **W.TRAIN)
    want = np.concatenate([p.detach().reshape(-1).numpy() for p in model.parameters()])
    got = two.read("train-params")
    assert np.array_equal(got, two.read("train-params", 1))
    assert np.abs(got - want).max() <= TRAIN_TOL
    assert np.abs(two.read("train-losses") - np.asarray(losses)).max() <= TRAIN_TOL
