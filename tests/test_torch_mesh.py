"""The port's (data, model) mesh (``lac_tpu_torch/parallel/``, the mesh paths
of ``runtime/lm_api.py``, ``train.py``, ``cli.py`` and ``config.py``) on
one rank and at four, against lac_tpu on the CPU.

One process: ``make_mesh``'s refusals (lac_tpu's messages where the two
say the same), ``MeshConfig`` against lac_tpu's, the 1 x 1 mesh (a
one-rank group the call starts: every forward mode's blocks equal the
meshless container's, the header records the geometry, the decoder
rebuilds it), a float container of a wider mesh refused without its
ranks, the CLI's ``--mesh-data`` / ``--mesh-model``, and training with a
1 x 1 mesh equal to training without one bit for bit. Four ranks (one
module-scoped launch of ``tests/torch_dist_worker.py`` over gloo, started
before the first test; ``file://`` rendezvous in a temporary directory,
60 s collective and 180 s process timeouts): the block-span paths at
world 4 and the 2 x 2 mesh in every forward mode.

Every comparison is ``==`` on the bytes. Float and kv8 containers on the
2 x 2 mesh differ from the meshless ones by design (the tensor-parallel
all-reduce adds in another order; the header records the geometry); w8
and det8 equal them bit for bit, and det8 equals lac_tpu's with its
``det_rsqrt`` patched (C4), as ``tests/test_torch_det8.py`` does.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from lac_tpu import config as jconfig
from lac_tpu.models import transformer as JT
from lac_tpu.parallel.mesh import make_mesh as j_make_mesh
from lac_tpu.runtime import lm_api as japi
from lac_tpu.runtime.turbo import turbo_compress as j_turbo_compress
from lac_tpu.train import load_checkpoint as j_load_checkpoint
from lac_tpu_torch import cli
from lac_tpu_torch.config import MeshConfig
from lac_tpu_torch.models import transformer as T
from lac_tpu_torch.models.lm_registry import resolve_lm
from lac_tpu_torch.parallel import make_mesh, shard_params
from lac_tpu_torch.runtime import lm_api
from lac_tpu_torch.smoke import smoke_corpus
from lac_tpu_torch.stream.container import read_container
from lac_tpu_torch.train import train_byte_lm
import torch_dist_worker as W


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
def four(ref, tmp_path_factory):
    """The four-rank launch, started before the module's first test."""
    return W.Launch(4, str(tmp_path_factory.mktemp("four")), ref)


@pytest.fixture
def one_rank():
    """A test that starts a one-rank group (a 1 x 1 mesh does) ends it."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def single(ref):
    """The port's meshless single-process LM containers, by forward mode."""
    return {mode: lm_api.lm_compress_bytes(W.LM_DATA, model_ref=ref, **kw, **W.LM_CALL)
            for mode, kw in W.MODES.items()}


def _blocks(c: bytes) -> list:
    return [(b.raw_len, b.token_count, b.payload) for b in read_container(c)[1]]


def _ref_error(**kw) -> str:
    with pytest.raises(ValueError) as e:
        j_make_mesh(**kw)
    return str(e.value)


# --------------------------------------------------------------------------
# One process
# --------------------------------------------------------------------------


@pytest.mark.parametrize("data,model", [(2, 1), (-1, 2)])
def test_make_mesh_needs_launched_ranks(data, model):
    """Without a process group only a 1 x 1 mesh starts (its own group)."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
        make_mesh(data, model, device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("data,model", [(3, 1), (-1, 2)])
def test_make_mesh_refusals_are_the_references(one_rank, data, model):
    """On a one-rank group, the geometries one device cannot hold are
    refused with lac_tpu's words (on one of its devices)."""
    make_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError) as e:
        make_mesh(data, model, device="cpu")
    assert str(e.value) == _ref_error(data=data, model=model, devices=jax.devices()[:1])


def test_mesh_config_is_the_references():
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(MeshConfig) == fields(jconfig.MeshConfig)


@pytest.mark.parametrize("mode", sorted(W.MODES))
def test_one_by_one_mesh(one_rank, mode, ref, single):
    """A 1 x 1 mesh cuts nothing and gathers nothing: every block equals the
    meshless container's, the header records the geometry, and the decoder
    rebuilds the mesh from it (a det8 container decodes without one)."""
    mesh = make_mesh(1, 1, device="cpu")
    cfg, params = resolve_lm(ref, device="cpu")
    cfg = dataclasses.replace(cfg, **W.MODES[mode])
    sharded = shard_params(mesh, params, cfg)
    assert all(lyr.tp is None for lyr in sharded.layers)
    assert (sharded is params) == (mode in ("float", "kv8"))  # w8, det8: quantized
    c = lm_api.lm_compress_bytes(W.LM_DATA, model_ref=ref, mesh=mesh, **W.MODES[mode],
                                 **W.LM_CALL)
    assert read_container(c)[0].config["mesh"] == {"data": 1, "model": 1}
    assert _blocks(c) == _blocks(single[mode])
    dist.destroy_process_group()  # the decoder starts its own group
    assert lm_api.lm_decompress_bytes(c, device="cpu") == W.LM_DATA


def test_cli_mesh_flags(one_rank, ref, tmp_path, capsys):
    """--mesh-data 1 --mesh-model 1 codes on a 1 x 1 mesh and decompress
    rebuilds it (each command starts and ends its one-rank group); a wider
    mesh without launched ranks exits naming torchrun."""
    path = str(tmp_path / "data.bin")
    with open(path, "wb") as f:
        f.write(W.LM_DATA)
    args = ["--model", "lm", "--model-ref", ref, "--block-tokens", "60", "--lanes", "4",
            "--cache-grow", "16", "--device", "cpu"]
    assert cli.main(["compress", path, *args, "--mesh-data", "1", "--mesh-model", "1"]) == 0
    assert not dist.is_initialized()
    with open(path + ".lac", "rb") as f:
        assert read_container(f.read())[0].config["mesh"] == {"data": 1, "model": 1}
    os.remove(path)
    assert cli.main(["decompress", path + ".lac", "--device", "cpu"]) == 0
    with open(path, "rb") as f:
        assert f.read() == W.LM_DATA
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node"):
        cli.main(["compress", path, *args, "--mesh-data", "2"])
    assert "bpb" in capsys.readouterr().out


def test_float_mesh_container_needs_its_ranks(four, ref):
    """A 2 x 2 float container decodes only on four ranks; a det8 one on
    any (here, one process and no mesh)."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        lm_api.lm_decompress_bytes(four.read("mesh2x2-float"), device="cpu")
    assert lm_api.lm_decompress_bytes(four.read("mesh2x2-det8"), device="cpu") == W.LM_DATA


def test_training_on_a_one_by_one_mesh(one_rank):
    """One data rank: the meshless steps, bit for bit."""
    cfg = T.tiny_config(max_seq=64, n_layers=1)
    corpus = smoke_corpus(1 << 16)
    with_mesh, want_losses = train_byte_lm(cfg, corpus, mesh=make_mesh(1, 1, device="cpu"),
                                           **W.TRAIN)
    without, losses = train_byte_lm(cfg, corpus, **W.TRAIN)
    assert want_losses == losses
    for a, b in zip(with_mesh.parameters(), without.parameters()):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# Four ranks
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def j_turbo():
    return {m: j_turbo_compress(W.BYTES, block_size=1024, model=m) for m in W.CODECS}


@pytest.mark.parametrize("model", W.CODECS)
def test_four_ranks_byte_container(model, four, j_turbo):
    """Every rank's container equals lac_tpu's one-process container (each
    rank checked its round trip)."""
    for rank in range(4):
        assert four.read(f"bytes-{model}", rank) == j_turbo[model]


@pytest.mark.parametrize("mode", ["float", "det8"])
def test_four_ranks_lm_spans(mode, four, single):
    for rank in range(4):
        assert four.read(f"span-{mode}", rank) == single[mode]


@pytest.mark.parametrize("mode", sorted(W.MODES))
def test_two_by_two_mesh(mode, four, single):
    """Each mode on the 2 x 2 mesh: round trip (each rank decoded it),
    the same container on every rank, the geometry in the header; w8 and
    det8 with every block of the meshless container."""
    c = four.read(f"mesh2x2-{mode}")
    assert all(four.read(f"mesh2x2-{mode}", r) == c for r in range(4))
    assert read_container(c)[0].config["mesh"] == {"data": 2, "model": 2}
    if mode in ("w8", "det8"):
        assert _blocks(c) == _blocks(single[mode])
    assert sum(b[1] > 0 for b in _blocks(c)) == len(_blocks(c))


def test_lm_compress_distributed_on_the_two_by_two_mesh(four):
    """``lm_compress_distributed`` on a mesh is ``lm_compress_bytes`` on it."""
    assert four.read("dist-mesh2x2") == four.read("mesh2x2-float")


def _two_op_rsqrt(x):
    return jnp.float32(1.0) / jax.lax.optimization_barrier(jnp.sqrt(x.astype(jnp.float32)))


def test_two_by_two_det8_is_patched_lac_tpus(four, ref):
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "det_rsqrt", _two_op_rsqrt)
        call = {k: v for k, v in W.LM_CALL.items() if k != "device"}
        want = japi.lm_compress_bytes(W.LM_DATA, model_ref=ref,
                                      model=j_load_checkpoint(ref[len("file:"):]), det8=True,
                                      **call)
    jax.clear_caches()
    assert _blocks(four.read("mesh2x2-det8")) == _blocks(want)
