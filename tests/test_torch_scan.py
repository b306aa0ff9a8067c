"""The port's scan engine and its byte models (lac_tpu_torch.models.functional,
models.registry and runtime.engine) on the CPU against lac_tpu's.

Every quantity is an integer, so every comparison is exact:
- each of the nine registry models, stepped 64 times over 8 lanes of seeded
  symbols, gives lac_tpu's CDF and state at every step, at prob_bits 16 and
  at 12 (the nibble models refuse 12 in both packages);
- encode_lanes gives lac_tpu's words and word counts for every model, over
  ragged lanes, and decode_lanes gives the symbols back;
- for the five scan ids, compress_bytes writes lac_tpu's container byte for
  byte, and each package decodes the other's (the whole container and
  selected blocks);
- utils.scan, the chunked loop that the engine and the rANS encoder step
  with (a chunk a CUDA graph on the card), equals a plain loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lac_tpu.models.registry import get_scan_model as ref_model
from lac_tpu.runtime import engine as ref_engine
from lac_tpu_torch import cli
from lac_tpu_torch.models.registry import get_scan_model
from lac_tpu_torch.runtime import engine
from lac_tpu_torch.smoke import smoke_corpus
from lac_tpu_torch.stream.container import (CODEC_RANS64, ContainerHeader, read_container,
                                            write_container)
from lac_tpu_torch.utils.scan import CHUNK, scan

CPU = "cpu"
IDS = ("order0", "markov1", "order0d", "markov1d", "markov1c", "order0c", "order0n",
       "order1n", "order2n")
SCAN_IDS = IDS[:5]
B, STEPS = 8, 64
DATA = smoke_corpus(20000)  # block 4096: four whole blocks and one of 3616


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small per-step ops run fastest on one intra-op thread, and stay off
    the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _syms(seed: int, b: int = B, t_len: int = STEPS) -> np.ndarray:
    """[t_len, b]: text, random bytes, a skewed lane and one repeated 255."""
    rng = np.random.default_rng(seed)
    text = np.frombuffer(smoke_corpus(t_len * b), np.uint8).reshape(b, t_len).T.copy()
    text[:, 1] = rng.integers(0, 256, t_len)
    text[:, 2] = rng.integers(0, 4, t_len) * 17 + 64
    text[:, 3] = 255
    return text.astype(np.int64)


def _leaves(state) -> list[np.ndarray]:
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    if isinstance(state, torch.Tensor):
        return [state.numpy()]
    return [np.asarray(state)]


@pytest.mark.parametrize("pb", [16, 12])
@pytest.mark.parametrize("model_id", IDS)
def test_cdf_and_update_equal_lac_tpus(model_id, pb):
    if model_id.endswith("n") and pb != 16:  # the nibble models: 256 and 16 only
        with pytest.raises(ValueError, match="requires vocab=256, prob_bits=16"):
            ref_model(model_id, prob_bits=pb)
        with pytest.raises(ValueError, match="requires vocab=256, prob_bits=16"):
            get_scan_model(model_id, prob_bits=pb)
        return
    ref, ours = ref_model(model_id, prob_bits=pb), get_scan_model(model_id, prob_bits=pb)
    assert ours.vocab == ref.vocab == 256 and ours.prob_bits == ref.prob_bits == pb
    cdf, upd = jax.jit(ref.cdf), jax.jit(ref.update)
    st = ours.init_state(B, CPU)
    syms = _syms(pb)
    with jax.enable_x64(True):  # as lac_tpu's engine runs its models
        rst = ref.init_state(B)
        for t in range(STEPS):
            got = ours.cdf(st).numpy()
            np.testing.assert_array_equal(got, np.asarray(cdf(rst)))
            assert got.dtype == np.int32 and got[:, -1].tolist() == [1 << pb] * B
            rst = upd(rst, jnp.asarray(syms[t], jnp.int32))
            st = ours.update(st, torch.from_numpy(syms[t]))
            for a, b in zip(_leaves(st), jax.tree.leaves(rst), strict=True):
                np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("model_id", ["markov1", "markov1d", "markov1c", "order0"])
def test_pure_update_leaves_its_input_alone(model_id):
    m = get_scan_model(model_id, prob_bits=16)
    st = m.init_state(2, CPU)
    before = [a.copy() for a in _leaves(st)]
    m.update(st, torch.tensor([3, 255]))
    for a, b in zip(_leaves(st), before):
        np.testing.assert_array_equal(a, b)


LENGTHS = np.array([200, 0, 1, 199, 200, 137, 200, 60], np.int32)


@pytest.mark.parametrize("model_id", IDS)
def test_encode_and_decode_lanes_equal_lac_tpus(model_id):
    """Ragged lanes (0, 1 and T-1 symbols): the same words and word counts
    as lac_tpu's encode_lanes, and decode_lanes gives the symbols back, 0
    past each lane's length, as lac_tpu's does."""
    syms = _syms(7, B, 200).T.astype(np.int32).copy()
    ref, ours = ref_model(model_id, prob_bits=16), get_scan_model(model_id, prob_bits=16)
    rw, rn = ref_engine.encode_lanes(syms, LENGTHS, ref)
    w, n = engine.encode_lanes(syms, LENGTHS, ours, device=CPU)
    np.testing.assert_array_equal(n.numpy(), np.asarray(rn))
    np.testing.assert_array_equal(w.numpy(), np.asarray(rw).astype(np.int64))
    back = engine.decode_lanes(w, LENGTHS, ours, 200, device=CPU).numpy()
    want = np.where(np.arange(200)[None, :] < LENGTHS[:, None], syms, 0)
    np.testing.assert_array_equal(back, want)
    np.testing.assert_array_equal(
        back, np.asarray(ref_engine.decode_lanes(np.asarray(rw), LENGTHS, ref, 200)))


@pytest.mark.parametrize("model_id", ["order0", "markov1c"])
def test_decode_lanes_past_the_longest_lane_equal_lac_tpus(model_id):
    """Every lane shorter than t_len: the port's decoder stops at the
    longest lane, lac_tpu's scans all t_len steps; the whole [B, t_len]
    output is the same, zeros past each lane's length included."""
    lengths = LENGTHS.clip(max=150)
    syms = _syms(11, B, 200).T.astype(np.int32).copy()
    ref, ours = ref_model(model_id, prob_bits=16), get_scan_model(model_id, prob_bits=16)
    rw, _ = ref_engine.encode_lanes(syms, lengths, ref)
    w, _ = engine.encode_lanes(syms, lengths, ours, device=CPU)
    np.testing.assert_array_equal(w.numpy(), np.asarray(rw).astype(np.int64))
    back = engine.decode_lanes(w, lengths, ours, 200, device=CPU).numpy()
    assert back.shape == (B, 200)
    np.testing.assert_array_equal(
        back, np.asarray(ref_engine.decode_lanes(np.asarray(rw), lengths, ref, 200)))
    np.testing.assert_array_equal(back, np.where(np.arange(200) < lengths[:, None], syms, 0))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2 * CHUNK, 2 * CHUNK + 1, 3 * CHUNK, 3 * CHUNK + 5])
def test_chunked_scan_equals_a_plain_loop(n, reverse):
    """utils.scan against a loop, at lengths that step eagerly throughout
    and that run the chunks (on the CPU, the recorded chunk runs eagerly
    on the same static buffers): a table written in place, a new tensor
    each step, two outputs; a carry with a number steps eagerly."""
    rng = np.random.default_rng(n + reverse)
    xs = torch.from_numpy(rng.integers(0, 5, (n, 3)))

    def step(carry, x):
        table, acc = carry
        table[torch.arange(3), x[0]] += 1
        acc = acc * 3 + table.sum(1) + x[0]
        return (table, acc), (acc % 7, table[:, 0] * 2)

    def plain():
        table, acc = torch.zeros((3, 5), dtype=torch.int64), torch.zeros(3, dtype=torch.int64)
        ys = [None] * n
        for t in range(n - 1, -1, -1) if reverse else range(n):
            (table, acc), ys[t] = step((table, acc), (xs[t],))
        return table, acc, [torch.stack([y[i] for y in ys]) for i in range(2)]

    table, acc, ys = plain()
    (t2, a2), ys2 = scan(step, (torch.zeros((3, 5), dtype=torch.int64),
                                torch.zeros(3, dtype=torch.int64)), (xs,), reverse=reverse)
    assert torch.equal(t2, table) and torch.equal(a2, acc)
    assert all(torch.equal(a, b) for a, b in zip(ys2, ys, strict=True))
    (count, _), _ = scan(lambda c, x: ((c[0] + 1, c[1]), (x[0],)),
                         (0, torch.zeros(1)), (xs,), reverse=reverse)
    assert count == n


@pytest.mark.parametrize("model_id", SCAN_IDS)
def test_containers_identical_to_lac_tpus_both_ways(model_id):
    ours = engine.compress_bytes(DATA, model_id=model_id, block_size=4096, device=CPU)
    ref = ref_engine.compress_bytes(DATA, model_id=model_id, block_size=4096)
    assert ours == ref
    header, blocks = read_container(ours)
    assert header.model_id == model_id and header.config == {"block_size": 4096}
    assert [b.token_count for b in blocks] == [4096] * 4 + [3616]
    assert engine.decompress_bytes(ref, device=CPU) == DATA
    assert ref_engine.decompress_bytes(ours) == DATA
    got = engine.decompress_blocks(ours, [4, 1], device=CPU)
    assert got == ref_engine.decompress_blocks(ref, [4, 1]) == [DATA[16384:], DATA[4096:8192]]


@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("model_id", SCAN_IDS)
def test_empty_and_one_byte_inputs(model_id, n):
    data = DATA[:n]
    ours = engine.compress_bytes(data, model_id=model_id, block_size=4096, device=CPU)
    assert ours == ref_engine.compress_bytes(data, model_id=model_id, block_size=4096)
    assert engine.decompress_bytes(ours, device=CPU) == data
    assert ref_engine.decompress_bytes(ours) == data


@pytest.mark.parametrize("model_id,kw", [("order0d", {"rate": 2}), ("markov1c", {"rate": 6}),
                                          ("order0", {"inc": 3})])
def test_model_options_and_prob_bits_travel_in_the_header(model_id, kw):
    """A non-default keyword and prob_bits 14 reach the header's config and
    prob_bits, and the decoder rebuilds the model from them."""
    data = DATA[:6000]
    ours = engine.compress_bytes(data, model_id=model_id, block_size=2048, prob_bits=14,
                                 device=CPU, **kw)
    assert ours == ref_engine.compress_bytes(data, model_id=model_id, block_size=2048,
                                             prob_bits=14, **kw)
    header, _ = read_container(ours)
    assert header.prob_bits == 14 and header.config == {"block_size": 2048, **kw}
    assert engine.decompress_bytes(ours, device=CPU) == data
    assert ours != engine.compress_bytes(data, model_id=model_id, block_size=2048,
                                         prob_bits=14, device=CPU)


def test_unknown_model_and_lm_container_are_refused():
    with pytest.raises(KeyError, match="unknown model 'order9'"):
        engine.compress_bytes(DATA[:10], model_id="order9", device=CPU)
    lm = write_container(ContainerHeader(codec=CODEC_RANS64, prob_bits=16, model_id="lm",
                                         config={}, original_len=0), [])
    for call in (lambda: engine.decompress_bytes(lm, device=CPU),
                 lambda: engine.decompress_blocks(lm, [], device=CPU)):
        with pytest.raises(ValueError, match="lm_decompress_bytes"):
            call()


def test_cli_markov1c_round_trip_and_info(tmp_path, capsys):
    path = tmp_path / "in.bin"
    path.write_bytes(DATA[:9000])
    assert cli.main(["compress", str(path), "--model", "markov1c", "--rate", "2",
                     "--device", "cpu"]) == 0
    container = (tmp_path / "in.bin.lac").read_bytes()
    # the CLI's block 4096, and --rate reaches the turbo models only
    assert container == ref_engine.compress_bytes(DATA[:9000], model_id="markov1c",
                                                  block_size=4096)
    path.unlink()
    assert cli.main(["decompress", str(tmp_path / "in.bin.lac"), "--device", "cpu"]) == 0
    assert path.read_bytes() == DATA[:9000]
    assert cli.main(["info", str(tmp_path / "in.bin.lac")]) == 0
    out = capsys.readouterr().out
    assert "codec=1 prob_bits=16 model=markov1c" in out and "{'block_size': 4096}" in out


def test_cli_recover_a_cut_scan_container(tmp_path):
    """recover's non-LM branch: the intact blocks before the cut."""
    c = engine.compress_bytes(DATA, model_id="order0d", block_size=4096, device=CPU)
    _, blocks = read_container(c)
    cut = tmp_path / "cut.lac"
    cut.write_bytes(c[: len(c) - len(blocks[-1].payload) // 2])
    assert cli.main(["recover", str(cut), "--device", "cpu"]) == 1
    assert (tmp_path / "cut.lac.recovered").read_bytes() == DATA[:16384]
