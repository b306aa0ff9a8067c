"""Local HuggingFace checkpoints (GPT-2 and Llama families) -> the port's
``Transformer``.

Ports ``lac_tpu/models/hf_loader.py``: ``config_from_hf`` (:35-73),
``params_from_hf_state_dict`` with its GPT-2 (:91-121) and Llama
(:124-150) maps, and ``load_hf_model`` (:153-167). The reference reads a
checkpoint through ``transformers``; the card's machine has neither
``transformers`` nor ``safetensors``, so this module reads the files
itself, and imports neither:

- ``config.json`` with ``json``. A key the file leaves out takes the value
  ``transformers``' config class gives it (``_DEFAULTS``), as the
  reference's ``AutoConfig`` would;
- the weights from ``model.safetensors``, or ``model.safetensors.index.json``
  and its shards (``read_safetensors``: a little-endian u64 header length,
  the JSON header, ``torch.frombuffer`` over each tensor's
  ``data_offsets``), else from ``pytorch_model.bin`` or its index
  (``torch.load(weights_only=True)``);
- a model id (``org/name``) from the hub cache: ``$HF_HUB_CACHE``, else
  ``$HF_HOME/hub``, else ``~/.cache/huggingface/hub``, then
  ``models--org--name/refs/main`` names the snapshot. Nothing is
  downloaded: a path that is not there raises, naming it.

Conventions, as in the reference: GPT-2's ``Conv1D`` weights are stored
[in, out], the port's layout, and ``attn.c_attn`` is split into q, k and
v; its keys may carry ``transformer.``, and its ``attn.bias`` /
``attn.masked_bias`` buffers are not read. Llama's ``nn.Linear`` weights
are [out, in] and are transposed; its keys may carry ``model.``;
``lm_head.weight`` is read only when the embeddings are untied. The
embedding gets one more row, BOS (``LMConfig.bos_id``), a copy of the
checkpoint's BOS (else EOS) row, the layout ``convert.lm_params_from_jax``
gives.

The reference loads in float32 and casts to the model dtype (bf16 by round
to nearest even); here each tensor is cast on the host the same way (to
f32, then to the dtype) and moved to the device on its own, so no f32 copy
of the whole model is built on the device.
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import torch

from .transformer import LMConfig, Transformer

__all__ = ["config_from_hf", "params_from_hf_state_dict", "load_hf_model",
           "read_safetensors", "resolve_checkpoint_dir"]

# the values transformers' GPT2Config / LlamaConfig give a key that
# config.json leaves out (the keys config_from_hf and the BOS rule read)
_DEFAULTS = {
    "gpt2": {"vocab_size": 50257, "n_positions": 1024, "n_embd": 768, "n_layer": 12,
             "n_head": 12, "layer_norm_epsilon": 1e-5, "bos_token_id": 50256,
             "eos_token_id": 50256},
    "llama": {"vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
              "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": None,
              "max_position_embeddings": 2048, "rms_norm_eps": 1e-6,
              "tie_word_embeddings": False, "rope_theta": 10000.0, "bos_token_id": 1,
              "eos_token_id": 2},
}
# GPT2Config.attribute_map: a config.json may name these keys the generic way
_GPT2_ALIASES = {"n_embd": "hidden_size", "n_positions": "max_position_embeddings",
                 "n_head": "num_attention_heads", "n_layer": "num_hidden_layers"}

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


class _Config:
    """``config.json``'s dict, or a transformers config object, read with
    the config class's defaults."""

    def __init__(self, hf_config):
        self.raw = hf_config
        if isinstance(hf_config, dict):
            self.model_type = hf_config.get("model_type")
        else:
            self.model_type = hf_config.model_type
        if self.model_type not in _DEFAULTS:
            raise ValueError(f"unsupported HF model_type '{self.model_type}'")

    def __getattr__(self, key):
        raw = self.raw
        if not isinstance(raw, dict):
            return getattr(raw, key, _DEFAULTS[self.model_type].get(key))
        if key in raw:
            value = raw[key]
        elif self.model_type == "gpt2" and _GPT2_ALIASES.get(key) in raw:
            value = raw[_GPT2_ALIASES[key]]
        else:
            value = _DEFAULTS[self.model_type][key]
        if key == "num_key_value_heads" and value is None:  # LlamaConfig's rule
            return self.num_attention_heads
        return value


def config_from_hf(hf_config, dtype=torch.bfloat16) -> LMConfig:
    """An ``LMConfig`` from a checkpoint's parsed ``config.json`` or a
    transformers config object."""
    c = _Config(hf_config)
    if c.model_type == "gpt2":
        return LMConfig(
            vocab=c.vocab_size,
            d_model=c.n_embd,
            n_layers=c.n_layer,
            n_heads=c.n_head,
            n_kv_heads=c.n_head,
            d_ff=4 * c.n_embd,
            max_seq=c.n_positions,
            pos_embedding="learned",
            norm="layernorm",
            act="gelu",
            use_bias=True,
            tie_embeddings=True,
            dtype=dtype,
            norm_eps=c.layer_norm_epsilon,
        )
    return LMConfig(
        vocab=c.vocab_size,
        d_model=c.hidden_size,
        n_layers=c.num_hidden_layers,
        n_heads=c.num_attention_heads,
        n_kv_heads=c.num_key_value_heads,
        d_ff=c.intermediate_size,
        max_seq=c.max_position_embeddings,
        pos_embedding="rope",
        norm="rmsnorm",
        act="silu_glu",
        use_bias=False,
        tie_embeddings=c.tie_word_embeddings,
        dtype=dtype,
        rope_theta=c.rope_theta,
        norm_eps=c.rms_norm_eps,
    )


def bos_token_id(hf_config) -> int:
    """The reference's BOS rule (:163-165): ``bos_token_id``, else
    ``eos_token_id``, else 0; of a list of EOS ids (Llama-3's), the first."""
    c = _Config(hf_config)
    bos = c.bos_token_id
    if bos is None:
        bos = c.eos_token_id or 0
    return bos[0] if isinstance(bos, (list, tuple)) else int(bos)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def _cast(t: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    """The reference's cast: the value in float32, then the model dtype
    (round to nearest even), on the host; then to ``device``."""
    return t.detach().to("cpu", torch.float32).to(dtype).to(device)


def _put(module: torch.nn.Module, name: str, value: torch.Tensor) -> None:
    setattr(module, name, torch.nn.Parameter(value.contiguous()))


def params_from_hf_state_dict(cfg: LMConfig, sd, bos_token_id: int, device=None) -> Transformer:
    """``sd``: name -> tensor (a ``state_dict``, or ``load_hf_model``'s views
    of the files). Returns a ``Transformer`` on ``device`` (the CPU when None),
    each tensor cast and moved on its own."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    model = Transformer(cfg, device="meta")
    if cfg.pos_embedding == "learned":
        _gpt2_params(cfg, model, sd, bos_token_id, dev)
    else:
        _llama_params(cfg, model, sd, bos_token_id, dev)
    left = [n for n, p in model.named_parameters() if p.device.type == "meta"]
    if left:
        raise ValueError(f"the checkpoint lacks {left}")
    return model


def _with_bos_row(embed: torch.Tensor, bos_token_id: int) -> torch.Tensor:
    if not 0 <= bos_token_id < embed.shape[0]:
        raise ValueError(f"BOS id {bos_token_id} is outside the vocab of {embed.shape[0]}")
    return torch.cat([embed, embed[bos_token_id : bos_token_id + 1]], dim=0)


def _gpt2_params(cfg, model, sd, bos_token_id, dev) -> None:
    def g(k):
        return sd[k] if k in sd else sd["transformer." + k]

    dt, d = cfg.dtype, cfg.d_model
    _put(model, "embed", _with_bos_row(_cast(g("wte.weight"), dt, dev), bos_token_id))
    _put(model, "pos_embed", _cast(g("wpe.weight")[: cfg.max_seq], dt, dev))
    _put(model.final_norm, "scale", _cast(g("ln_f.weight"), dt, dev))
    _put(model.final_norm, "bias", _cast(g("ln_f.bias"), dt, dev))
    for i, blk in enumerate(model.layers):
        def p(k):
            return _cast(g(f"h.{i}.{k}"), dt, dev)

        _put(blk.ln1, "scale", p("ln_1.weight"))
        _put(blk.ln1, "bias", p("ln_1.bias"))
        _put(blk.ln2, "scale", p("ln_2.weight"))
        _put(blk.ln2, "bias", p("ln_2.bias"))
        qkv_w, qkv_b = p("attn.c_attn.weight"), p("attn.c_attn.bias")  # Conv1D: [D, 3D]
        for j, (w, b) in enumerate((("wq", "bq"), ("wk", "bk"), ("wv", "bv"))):
            _put(blk, w, qkv_w[:, j * d : (j + 1) * d])
            _put(blk, b, qkv_b[j * d : (j + 1) * d])
        for ours, theirs in (("wo", "attn.c_proj.weight"), ("bo", "attn.c_proj.bias"),
                             ("w_up", "mlp.c_fc.weight"), ("b_up", "mlp.c_fc.bias"),
                             ("w_down", "mlp.c_proj.weight"), ("b_down", "mlp.c_proj.bias")):
            _put(blk, ours, p(theirs))


def _llama_params(cfg, model, sd, bos_token_id, dev) -> None:
    def g(k):
        return sd[k] if k in sd else sd["model." + k]

    dt = cfg.dtype
    _put(model, "embed", _with_bos_row(_cast(g("embed_tokens.weight"), dt, dev), bos_token_id))
    _put(model.final_norm, "scale", _cast(g("norm.weight"), dt, dev))
    if not cfg.tie_embeddings:
        _put(model, "head", _cast(sd["lm_head.weight"], dt, dev).t())
    for i, blk in enumerate(model.layers):
        def p(k):
            return _cast(g(f"layers.{i}.{k}"), dt, dev)

        _put(blk.ln1, "scale", p("input_layernorm.weight"))
        _put(blk.ln2, "scale", p("post_attention_layernorm.weight"))
        for ours, theirs in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                             ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"),
                             ("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                             ("w_down", "mlp.down_proj")):
            _put(blk, ours, p(theirs + ".weight").t())


# --------------------------------------------------------------------------
# Reading a checkpoint directory
# --------------------------------------------------------------------------


def read_safetensors(path: str) -> dict:
    """name -> tensor of a ``.safetensors`` file, each a view of the file
    mapped copy-on-write (``__metadata__`` left out)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which is not read")
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        if count == 0:
            t = torch.empty(info["shape"], dtype=dtype)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=count, offset=base + begin)
        out[name] = t.reshape(info["shape"])
    return out


def _read_index(path: str) -> list[str]:
    with open(path) as f:
        weight_map = json.load(f)["weight_map"]
    folder = os.path.dirname(path)
    return [os.path.join(folder, s) for s in sorted(set(weight_map.values()))]


def _state_dict(folder: str) -> dict:
    """The checkpoint's tensors: safetensors first, then ``.bin``, each
    whole or sharded under an index."""
    def at(name):
        return os.path.join(folder, name)

    if os.path.isfile(at("model.safetensors")):
        return read_safetensors(at("model.safetensors"))
    if os.path.isfile(at("model.safetensors.index.json")):
        sd = {}
        for shard in _read_index(at("model.safetensors.index.json")):
            sd.update(read_safetensors(shard))
        return sd
    bins = ([at("pytorch_model.bin")] if os.path.isfile(at("pytorch_model.bin"))
            else _read_index(at("pytorch_model.bin.index.json"))
            if os.path.isfile(at("pytorch_model.bin.index.json")) else [])
    if not bins:
        raise FileNotFoundError(
            f"{folder}: no model.safetensors, model.safetensors.index.json, "
            f"pytorch_model.bin or pytorch_model.bin.index.json")
    sd = {}
    for path in bins:
        try:
            part = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        except RuntimeError:  # a file of torch's legacy format cannot be mapped
            part = torch.load(path, map_location="cpu", weights_only=True)
        sd.update(part)
    return sd


def _hub_cache() -> str:
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    if os.environ.get("HF_HOME"):
        return os.path.join(os.environ["HF_HOME"], "hub")
    return os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub")


def resolve_checkpoint_dir(name_or_path: str) -> str:
    """A checkpoint directory, or a model id's snapshot in the hub cache;
    raises naming the paths it looked at."""
    if os.path.isdir(name_or_path):
        return name_or_path
    repo = os.path.join(_hub_cache(), "models--" + name_or_path.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            snap = os.path.join(repo, "snapshots", f.read().strip())
        if os.path.isdir(snap):
            return snap
    raise FileNotFoundError(
        f"no HF checkpoint at {name_or_path!r}: not a directory, and no snapshot under "
        f"{ref} (nothing is downloaded)")


def load_hf_model(name_or_path: str, dtype=torch.bfloat16, device=None):
    """A local HF checkpoint (a directory or a cached model id) -> (LMConfig,
    Transformer on ``device``, cuda unless the caller passes ``"cpu"``)."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    folder = resolve_checkpoint_dir(name_or_path)
    with open(os.path.join(folder, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(hf_cfg, dtype=dtype)
    model = params_from_hf_state_dict(cfg, _state_dict(folder), bos_token_id(hf_cfg), dev)
    return cfg, model
