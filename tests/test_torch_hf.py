"""The port's HuggingFace loader (lac_tpu_torch/models/hf_loader.py) against
transformers and lac_tpu's loader, on random tiny GPT-2 and Llama models
saved with save_pretrained: the config, the parameters bit for bit, the
logits, the safetensors reader, config defaults, the hub cache, hf: refs
and the CLI."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

import jax.numpy as jnp  # noqa: E402

from lac_tpu.models import hf_loader as ref_hf  # noqa: E402
from lac_tpu_torch import cli  # noqa: E402
from lac_tpu_torch.convert import lm_params_from_jax  # noqa: E402
from lac_tpu_torch.models import hf_loader as hf  # noqa: E402
from lac_tpu_torch.models import lm_registry  # noqa: E402
from lac_tpu_torch.models import transformer as T  # noqa: E402
from lac_tpu_torch.smoke import smoke_corpus  # noqa: E402

CPU = "cpu"
TORCH_DTYPE = {"bf16": torch.bfloat16, "f32": torch.float32}
JAX_DTYPE = {"bf16": jnp.bfloat16, "f32": jnp.float32}


def _gpt2():
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=97, n_positions=64, n_embd=48, n_layer=2, n_head=4, bos_token_id=96,
        eos_token_id=96)).eval()


def _llama(tied: bool, vocab: int = 89):
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=vocab, hidden_size=64, intermediate_size=112, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        rms_norm_eps=1e-5, tie_word_embeddings=tied)).eval()


MODELS = {"gpt2": _gpt2, "llama-gqa": lambda: _llama(False), "llama-tied": lambda: _llama(True)}
# save_pretrained's arguments for each layout on disk
LAYOUTS = {
    "safetensors": dict(safe_serialization=True),
    "safetensors-sharded": dict(safe_serialization=True, max_shard_size="40KB"),
    "bin": dict(safe_serialization=False),
}
_FILES = {"safetensors": "model.safetensors",
          "safetensors-sharded": "model.safetensors.index.json", "bin": "pytorch_model.bin"}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(model name, layout) -> (directory, the transformers model), each
    model's weights made from its own seed."""
    out = {}
    for i, (name, make) in enumerate(MODELS.items()):
        torch.manual_seed(i)
        model = make()
        for layout, kw in LAYOUTS.items():
            path = tmp_path_factory.mktemp(f"{name}-{layout}")
            model.save_pretrained(path, **kw)
            assert os.path.isfile(path / _FILES[layout])
            out[name, layout] = (str(path), model)
    return out


def _same_config(ours, theirs) -> None:
    """The port's LMConfig against lac_tpu's, field for field (dtype by name)."""
    a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
    assert str(a.pop("dtype")).split(".")[-1] == np.dtype(b.pop("dtype")).name
    assert a == b


def _assert_bit_equal(ours, theirs) -> None:
    got, want = dict(ours.named_parameters()), dict(theirs.named_parameters())
    assert list(got) == list(want)
    for name, p in got.items():
        q = want[name]
        assert p.dtype == q.dtype and p.shape == q.shape, name
        assert torch.equal(p.view(torch.int16) if p.dtype == torch.bfloat16 else p,
                           q.view(torch.int16) if q.dtype == torch.bfloat16 else q), name


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(MODELS))
def test_load_matches_lac_tpu_bit_for_bit(checkpoints, name, layout, dtype):
    """load_hf_model(dir) gives lac_tpu's config and, carried across with
    convert.lm_params_from_jax, its parameters bit for bit (bf16 by round to
    nearest even from float32, as lac_tpu casts)."""
    path, _ = checkpoints[name, layout]
    cfg, model = hf.load_hf_model(path, dtype=TORCH_DTYPE[dtype], device=CPU)
    rcfg, rparams = ref_hf.load_hf_model(path, dtype=JAX_DTYPE[dtype])
    _same_config(cfg, rcfg)
    tree = {"embed": np.asarray(rparams["embed"]),
            "final_norm": {k: np.asarray(v) for k, v in rparams["final_norm"].items()},
            "layers": {k: ({s: np.asarray(a) for s, a in v.items()} if isinstance(v, dict)
                           else np.asarray(v)) for k, v in rparams["layers"].items()}}
    for k in ("pos_embed", "head"):
        if k in rparams:
            tree[k] = np.asarray(rparams[k])
    _assert_bit_equal(model, lm_params_from_jax(cfg, tree, device=CPU))
    assert model.embed.shape[0] == cfg.vocab + 1 and (model.head is None) == cfg.tie_embeddings


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_transformers(checkpoints, name):
    """The port's forward over the loaded model (f32) against transformers'
    logits, within the reference test's rtol 2e-3, atol 2e-3."""
    path, hf_model = checkpoints[name, "safetensors"]
    cfg, model = hf.load_hf_model(path, dtype=torch.float32, device=CPU)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))
    with torch.no_grad():
        want = hf_model(torch.tensor(tokens)).logits.float().numpy()
        got = T.forward(cfg, model, torch.from_numpy(tokens), prefill=True)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reader_matches_the_library(tmp_path, dtype):
    g = torch.Generator().manual_seed(1)
    tensors = {"a": torch.randn(3, 5, generator=g).to(dtype),
               "b.weight": torch.randn(7, generator=g).to(dtype),
               "scalar": torch.randn((), generator=g).to(dtype),
               "empty": torch.zeros(0, 4, dtype=dtype),
               "ids": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    path = str(tmp_path / "t.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt"})
    got, want = hf.read_safetensors(path), safetensors_torch.load_file(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("body", [
    {"model_type": "llama"},
    {"model_type": "llama", "hidden_size": 64, "num_attention_heads": 8,
     "num_hidden_layers": 3, "intermediate_size": 96, "vocab_size": 300,
     "bos_token_id": None, "eos_token_id": [7, 9]},
    {"model_type": "llama", "num_key_value_heads": None, "tie_word_embeddings": True,
     "rope_theta": 500000.0, "rms_norm_eps": 1e-5, "bos_token_id": None, "eos_token_id": None},
    {"model_type": "gpt2"},
    {"model_type": "gpt2", "n_embd": 64, "n_layer": 3, "n_head": 4, "vocab_size": 300,
     "n_positions": 128, "layer_norm_epsilon": 1e-6, "bos_token_id": 5},
    {"model_type": "gpt2", "hidden_size": 32, "num_attention_heads": 2},
])
def test_minimal_config_json_gives_autoconfig_s_lmconfig(tmp_path, body):
    """A hand-written config.json that leaves keys out: the port's
    config_from_hf on the parsed file equals lac_tpu's on transformers'
    AutoConfig (the class defaults), and so does the BOS rule (the first of
    a list of EOS ids, where lac_tpu would index with the list)."""
    (tmp_path / "config.json").write_text(json.dumps(body))
    auto = transformers.AutoConfig.from_pretrained(str(tmp_path), local_files_only=True)
    _same_config(hf.config_from_hf(body), ref_hf.config_from_hf(auto))
    _same_config(hf.config_from_hf(auto), ref_hf.config_from_hf(auto))
    want = auto.bos_token_id
    if want is None:
        want = getattr(auto, "eos_token_id", 0) or 0
    want = want[0] if isinstance(want, list) else want
    assert hf.bos_token_id(body) == hf.bos_token_id(auto) == want


def test_unsupported_model_type_bos_and_missing_weights_raise(checkpoints, tmp_path):
    """An unknown model type, a BOS id outside the vocab (GPT2Config's
    default 50256 on a small vocab, where lac_tpu leaves the BOS row out)
    and a directory without weights raise."""
    with pytest.raises(ValueError, match="mistral"):
        hf.config_from_hf({"model_type": "mistral"})
    path, hf_model = checkpoints["gpt2", "safetensors"]
    cfg = hf.config_from_hf(hf_model.config, dtype=torch.float32)
    with pytest.raises(ValueError, match="BOS id 50256"):
        hf.params_from_hf_state_dict(cfg, hf_model.state_dict(), 50256)
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "gpt2"}))
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        hf.load_hf_model(str(tmp_path), device=CPU)


def test_model_id_resolves_in_a_hub_cache(checkpoints, tmp_path, monkeypatch):
    """``org/name`` -> $HF_HUB_CACHE/models--org--name/refs/main's
    snapshot; without it, $HF_HOME/hub; an id that is not cached raises,
    naming where it looked."""
    path, _ = checkpoints["llama-gqa", "safetensors"]
    snap = tmp_path / "hub" / "models--org--tiny-llama" / "snapshots" / "abc123"
    snap.mkdir(parents=True)
    for f in os.listdir(path):
        os.symlink(os.path.join(path, f), snap / f)
    (tmp_path / "hub" / "models--org--tiny-llama" / "refs").mkdir()
    (tmp_path / "hub" / "models--org--tiny-llama" / "refs" / "main").write_text("abc123")
    want = hf.load_hf_model(path, device=CPU)[1]
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert hf.resolve_checkpoint_dir("org/tiny-llama") == str(snap)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    cfg, got = hf.load_hf_model("org/tiny-llama", device=CPU)
    _assert_bit_equal(got, want)
    with pytest.raises(FileNotFoundError, match="models--org--absent"):
        hf.load_hf_model("org/absent", device=CPU)


def test_resolve_lm_hf_ref(checkpoints):
    """resolve_lm's hf: branch, and max_seq applied after the load."""
    path, _ = checkpoints["gpt2", "safetensors-sharded"]
    cfg, model = lm_registry.resolve_lm("hf:" + path, device=CPU)
    assert cfg == hf.load_hf_model(path, device=CPU)[0] and cfg.max_seq == 64
    cfg32, model32 = lm_registry.resolve_lm("hf:" + path, max_seq=32, device=CPU)
    assert cfg32 == dataclasses.replace(cfg, max_seq=32)
    _assert_bit_equal(model32, model)


def test_cli_lm_round_trip_with_an_hf_checkpoint(tmp_path):
    """compress --model lm --model-ref hf:<dir> / decompress on the CPU: the
    header names the ref, and the bytes come back."""
    from lac_tpu_torch.stream.container import read_container

    torch.manual_seed(7)
    ckpt = tmp_path / "ckpt"
    _llama(False, vocab=300).save_pretrained(ckpt)
    data = smoke_corpus(700)
    src = tmp_path / "data.bin"
    src.write_bytes(data)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli.main(["compress", str(src), "--model", "lm", "--model-ref", f"hf:{ckpt}",
                         "--block-tokens", "64", "--lanes", "4", "--cache-grow", "16",
                         "--device", CPU]) == 0
        with open(str(src) + ".lac", "rb") as f:
            header, blocks = read_container(f.read())
        assert header.config["model_ref"] == f"hf:{ckpt}" and len(blocks) == 11
        os.remove(src)
        assert cli.main(["decompress", str(src) + ".lac", "--device", CPU]) == 0
    finally:
        torch.set_num_threads(n)
    assert src.read_bytes() == data


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("preset", ["tiny", "tiny-tied", "tiny-gpt2"])
def test_smoke_writer_is_hf_s_layout(tmp_path, preset, shards):
    """smoke.write_hf_checkpoint (the writer of chip_smoke.py's phase 10)
    writes what transformers reads as the same model: its logits equal the
    port's forward over the source; and the port loads the source's bits
    back, the BOS row the checkpoint's."""
    from lac_tpu_torch import smoke

    cfg = lm_registry.PRESETS["tiny-gpt2" if preset == "tiny-gpt2" else "tiny"]()
    cfg = dataclasses.replace(cfg, vocab=300, tie_embeddings=preset != "tiny",
                              d_ff=4 * cfg.d_model if preset == "tiny-gpt2" else cfg.d_ff)
    src = T.init_params(cfg, 5)
    with torch.no_grad():
        src.embed[cfg.vocab] = src.embed[7]
    path = str(tmp_path / "ckpt")
    smoke.write_hf_checkpoint(path, smoke.hf_config_json(cfg, 7), smoke.hf_tensors(cfg, src),
                              shards)
    got_cfg, got = hf.load_hf_model(path, dtype=torch.float32, device=CPU)
    assert got_cfg == cfg
    _assert_bit_equal(got, src)
    theirs = transformers.AutoModelForCausalLM.from_pretrained(path, local_files_only=True).eval()
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 10))
    with torch.no_grad():
        want = theirs(torch.tensor(tokens)).logits.float().numpy()
        ours = T.forward(cfg, src, torch.from_numpy(tokens), prefill=True)
    np.testing.assert_allclose(ours.numpy(), want, rtol=2e-3, atol=2e-3)
