"""The port's public surface against lac_tpu's: names and parameters, walked
with ast, and the names added for it held to lac_tpu's on the same inputs.

The walk (one case per reference module, so that each module counts):

- every name in a reference module's ``__all__`` (a module without one:
  its public top-level functions, classes and constants; a package
  ``__init__``: what it re-exports) has a counterpart in the port's module
  of the same path, defined there or imported into it;
- every parameter of a public reference function, or of a public method of
  a public class, is a parameter of the port's function of that name, and
  the reference's positional parameters open the port's positional ones in
  the same order, so that a reference caller's positional call binds the
  same names (defaults may differ; the port may add parameters after them;
  methods are looked up through the bases that the module itself defines).

``lac_tpu/ops/pallas_rans.py`` is the Pallas kernels' module; its port is
``lac_tpu_torch/ops/rans_kernels.py``, where ``rans32_encode_dense``,
``compact_words`` and the dense grid's ``SENTINEL`` are folded into one
kernel, ``rans32_encode`` (FOLDED). The only names and parameters that
may lack a counterpart are the JAX-only ones of JAX_ONLY, each with its
reason, left out of both checks; the port's docstrings name them too.

Value tests: the NumPy spec holders bit-equal to lac_tpu's; ``from_dict``
round-tripping each config class as lac_tpu's does; ``rans_decode_step``,
``cdf_state_to_coder`` and ``cdf_state_update`` with the reference's
arguments equal to lac_tpu's; the reference's parameters of the mesh and
process-group helpers and of the LM functions taken and checked.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "lac_tpu", ROOT / "lac_tpu_torch"

# reference module -> its port, where the path differs
MIRROR = {"ops/pallas_rans.py": "ops/rans_kernels.py"}
# (reference module, name) -> the port's name that does its work
FOLDED = {
    ("ops/pallas_rans.py", "rans32_encode_dense"): "rans32_encode",
    ("ops/pallas_rans.py", "compact_words"): "rans32_encode",
    ("ops/pallas_rans.py", "SENTINEL"): "rans32_encode",
}
# (reference module, name or "function.parameter") -> why it is JAX-only
JAX_ONLY = {
    ("utils/jaxutil.py", "x64"): "scopes JAX's 64-bit mode; torch has int64 throughout",
    ("utils/jaxutil.py", "force_cpu"): "pins JAX's platform; the port's entry points take "
                                       "device='cpu'",
    ("parallel/shard.py", "param_shardings"): "GSPMD NamedShardings; a rank holds its own "
                                              "slice (shard_params)",
    ("parallel/shard.py", "cache_pspecs"): "GSPMD PartitionSpecs of the cache",
    ("parallel/shard.py", "lane_pspec"): "GSPMD PartitionSpec of the lanes; a rank codes its "
                                         "lane_share",
    ("parallel/__init__.py", "param_shardings"): "the GSPMD placement, re-exported",
    ("models/transformer.py", "stack_layers"): "the stacked leaves of the lax.scan over "
                                               "layers; the port keeps a Block a layer",
    ("models/transformer.py", "init_params.key"): "a JAX PRNG key; the port draws from seed",
    ("models/transformer.py", "init_params_w8.key"): "a JAX PRNG key; the port draws from "
                                                     "seed",
    ("models/transformer.py", "forward.unroll"): "the unroll of XLA's scan over layers",
    ("train.py", "lm_loss.unroll"): "the unroll of XLA's scan over layers",
    ("runtime/lm_api.py", "encode_lm_span.place"): "puts a wave on its NamedSharding; a rank "
                                                   "codes its share",
    ("runtime/lm_api.py", "decode_lm_span.place"): "puts a wave on its NamedSharding; a rank "
                                                   "codes its share",
}
# the order0c wrappers' alphabet and precision: static arguments of the
# Pallas kernels; K8 and K9 are built for the one geometry, 256 at 16 bits
JAX_ONLY.update({("ops/pallas_rans.py", f"{fn}.{p}"): "a static argument of the Pallas "
                 "kernel; K8 and K9 are built for v 256 at prob_bits 16"
                 for fn in ("o0c_encode_intervals", "o0c_encode_fused", "o0c_rans32_decode")
                 for p in ("v", "prob_bits")})


def _params(fn: ast.FunctionDef) -> tuple[list[str], list[str]]:
    """(every parameter, the positional ones in order), without self/cls."""
    a = fn.args
    pos = [x.arg for x in a.posonlyargs + a.args if x.arg not in ("self", "cls")]
    names = pos + [x.arg for x in a.kwonlyargs]
    names += [f"*{a.vararg.arg}"] if a.vararg else []
    names += [f"**{a.kwarg.arg}"] if a.kwarg else []
    return names, pos


def _surface(path: pathlib.Path) -> dict:
    """names: the public names (``__all__``, or the public top-level ones);
    defined: every top-level name, imports included; fns: {name or
    "Class.method": (parameters, positional parameters)} of the public
    functions and methods."""
    tree = ast.parse(path.read_text())
    declared, defined, fns, classes = None, set(), {}, {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    defined.add(t.id)
                    if t.id == "__all__":
                        declared = [e.value for e in node.value.elts]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            defined.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            defined.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defined.add(node.name)
            fns[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            defined.add(node.name)
            classes[node.name] = node
    for name, node in classes.items():
        seen, todo = set(), [node]
        while todo:  # the class, then the bases this module defines
            cls = todo.pop(0)
            for m in cls.body:
                if isinstance(m, ast.FunctionDef) and not m.name.startswith("_"):
                    fns.setdefault(f"{name}.{m.name}", _params(m))
            seen.add(cls.name)
            todo += [classes[b.id] for b in cls.bases
                     if isinstance(b, ast.Name) and b.id in classes and b.id not in seen]
    if path.name == "__init__.py":
        names = sorted({a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom)
                        for a in n.names})
    elif declared is not None:
        names = declared
    else:
        names = sorted(n for n in defined if not n.startswith("_")
                       and not any(isinstance(x, (ast.Import, ast.ImportFrom))
                                   and n in {(a.asname or a.name) for a in x.names}
                                   for x in tree.body))
    return {"names": names, "defined": defined, "fns": fns}


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")
                     if "build" not in p.relative_to(REF).parts)


@pytest.mark.parametrize("module", REF_MODULES)
def test_surface(module):
    ref = _surface(REF / module)
    port_path = PORT / MIRROR.get(module, module)
    missing = []
    if not port_path.exists():
        missing = [n for n in ref["names"] if (module, n) not in JAX_ONLY]
        assert not missing, f"{module} has no port, and these are not JAX-only: {missing}"
        return
    port = _surface(port_path)
    for name in ref["names"]:
        want = FOLDED.get((module, name), name)
        if want not in port["defined"] and (module, name) not in JAX_ONLY:
            missing.append(name)
    lacking, moved = [], []
    for fn, (params, pos) in ref["fns"].items():
        if fn.split(".")[0].startswith("_") or fn not in port["fns"]:
            continue
        got, got_pos = port["fns"][fn]
        lacking += [f"{fn}({p})" for p in params
                    if p not in got and (module, f"{fn}.{p}") not in JAX_ONLY]
        want_pos = [p for p in pos if (module, f"{fn}.{p}") not in JAX_ONLY]
        if got_pos[: len(want_pos)] != want_pos:
            moved.append(f"{fn}({', '.join(want_pos)}) -> ({', '.join(got_pos)})")
    assert not missing and not lacking and not moved, (
        f"{module} -> {port_path.relative_to(ROOT)}: names without a counterpart {missing}; "
        f"parameters the port lacks {lacking}; positional parameters out of the reference's "
        f"order {moved}")


def test_jax_only_table_is_live():
    """Every exemption names a reference item that exists and that the port
    indeed lacks: the table holds nothing stale."""
    for (module, item), why in JAX_ONLY.items():
        assert why
        ref = _surface(REF / module)
        port_path = PORT / MIRROR.get(module, module)
        port = _surface(port_path) if port_path.exists() else {"defined": set(), "fns": {}}
        if "." in item:
            fn, param = item.split(".")
            assert param in ref["fns"][fn][0] and param not in port["fns"].get(fn, [[]])[0]
        else:
            assert item in ref["names"] and item not in port["defined"]


def test_packages_import_no_jax_and_build_nothing(tmp_path):
    """The filled package ``__init__``s import neither jax nor lac_tpu and
    start no build (no nvcc, no g++, nothing written under the build
    directories)."""
    code = (
        "import sys, subprocess\n"
        "calls = []\n"
        "real = subprocess.Popen.__init__\n"
        "def spy(self, *a, **k):\n"
        "    calls.append(a[0] if a else k.get('args'))\n"
        "    return real(self, *a, **k)\n"
        "subprocess.Popen.__init__ = spy\n"
        "import lac_tpu_torch.ops, lac_tpu_torch.runtime, lac_tpu_torch.utils, "
        "lac_tpu_torch.stream\n"
        "from lac_tpu_torch.ops import quantize_logits_np, cdf_from_freq_np, rescale_cdf\n"
        "from lac_tpu_torch.runtime import compress_bytes, decompress_bytes\n"
        "from lac_tpu_torch.utils import BitReader, BitWriter, pack_bits, unpack_bits, "
        "bytes_to_digits, digits_to_bytes\n"
        "from lac_tpu_torch.stream import BlockEntry, ContainerHeader, read_container, "
        "write_container\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'lac_tpu'))\n"
        "print(bad, calls)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] []"


# --------------------------------------------------------------------------
# The added names on the same inputs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("det", [False, True])
@pytest.mark.parametrize("v, pb", [(256, 16), (1000, 17), (32000, 17)])
def test_quantize_logits_np_bit_equal(v, pb, det):
    from lac_tpu.ops import quantize as jq

    from lac_tpu_torch import ops

    rng = np.random.default_rng(v + pb + det)
    logits = (rng.standard_normal((3, 5, v)) * 4).astype(np.float32)
    logits[0, 0, :7] = 60.0  # ties at the argmax, and exp underflow elsewhere
    want = jq.quantize_logits_np(logits, pb, det=det)
    got = ops.quantize_logits_np(logits, pb, det=det)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(ops.cdf_from_freq_np(got), jq.cdf_from_freq_np(want))
    with pytest.raises(ValueError, match="too small"):
        ops.quantize_logits_np(logits, 8)


def test_det_exp_np_bit_equal():
    from lac_tpu.ops import detmath as jd

    from lac_tpu_torch.ops import detmath as td

    rng = np.random.default_rng(3)
    x = np.concatenate([-rng.exponential(8.0, 1 << 16), -rng.uniform(0, 200, 1 << 12),
                        np.array([0.0, -0.0, -1e-30, -87.3, -87.4, -88.0, -1000.0])])
    x = x.astype(np.float32)
    got, want = td.det_exp_np(x), jd.det_exp_np(x)
    assert got.dtype == np.float32 and np.array_equal(got.view(np.int32), want.view(np.int32))
    # the spec holder is the port's own det_exp, bit for bit
    assert np.array_equal(td.det_exp(torch.from_numpy(x)).numpy().view(np.int32),
                          got.view(np.int32))


@pytest.mark.parametrize("cls_name", ["ByteCodingConfig", "LMCodingConfig", "MeshConfig"])
def test_from_dict_round_trips(cls_name):
    import lac_tpu.config as jc

    import lac_tpu_torch.config as tc

    cls, jcls = getattr(tc, cls_name), getattr(jc, cls_name)
    changed = {"ByteCodingConfig": dict(model_id="order1n", block_size=1024, rate=5),
               "LMCodingConfig": dict(block_tokens=300, window=256, det8=True, slide_seg=0),
               "MeshConfig": dict(data=2, model=2)}[cls_name]
    for cfg in (cls(), cls(**changed)):
        d = dataclasses.asdict(cfg)
        assert tc.from_dict(cls, {**d, "unknown": 1}) == cfg
        assert dataclasses.asdict(jc.from_dict(jcls, d)) == d
    if cls is tc.LMCodingConfig:  # the wire's max_seq comes back as window
        lm = cls(**changed)
        wire = {**lm.engine_kwargs()}
        assert tc.from_dict(cls, wire).window == 256
        assert dataclasses.asdict(jc.from_dict(jcls, wire)) == \
            dataclasses.asdict(tc.from_dict(cls, wire))


def test_rans_decode_step_equals_lac_tpu():
    """Seeded words and CDFs: symbols, states and word cursors of each step
    equal lac_tpu's public step, with ``active`` given and left out."""
    import jax
    from lac_tpu.coder import vector as jvec

    from lac_tpu_torch.coder import vector as tvec

    rng = np.random.default_rng(11)
    b, steps, v, pb = 6, 24, 40, 14
    freq = rng.integers(1, 50, (steps, b, v))
    freq = (freq * ((1 << pb) - v) // freq.sum(-1, keepdims=True)) + 1
    freq[..., 0] += (1 << pb) - freq.sum(-1)
    cdfs = np.concatenate([np.zeros((steps, b, 1), np.int64), freq.cumsum(-1)], -1)
    words = rng.integers(0, 1 << 32, (b, steps + 2), dtype=np.uint64)
    words[:, 0] = rng.integers(1, 1 << 31, b)  # a state is in [2**31, 2**63)
    jstate = jvec.rans_decode_init(words.astype(np.uint32))
    tstate = tvec.rans_decode_init(torch.from_numpy(words.astype(np.int64)))
    for t in range(steps):
        active = None if t % 3 else np.arange(b) % 2 == 0
        with jax.enable_x64(True):
            jsym, jstate = jvec.rans_decode_step(
                jstate, cdfs[t].astype(np.int32), pb,
                None if active is None else jax.numpy.asarray(active))
        tsym, tstate = tvec.rans_decode_step(
            tstate, torch.from_numpy(cdfs[t]), pb,
            None if active is None else torch.from_numpy(active))
        assert np.array_equal(tsym.numpy(), np.asarray(jsym)), f"step {t}"
        assert np.array_equal(tstate.x.numpy().astype(np.uint64), np.asarray(jstate.x))
        assert np.array_equal(tstate.pos.numpy(), np.asarray(jstate.pos))


@pytest.mark.parametrize("v, pb", [(256, 16), (37, 12), (1000, 17)])
def test_cdf_state_with_reference_arguments(v, pb):
    import jax.numpy as jnp
    from lac_tpu.models import functional as JF

    from lac_tpu_torch.models import functional as TF

    rng = np.random.default_rng(v)
    jstate = JF.cdf_state_init(5, v, pb)
    tstate = TF.cdf_state_init(5, v, pb, "cpu")
    for step in range(20):
        syms = rng.integers(0, v, 5)
        rate = JF.adaptive_rate(4, step)
        assert np.array_equal(TF.cdf_state_to_coder(tstate, pb, v).numpy(),
                              np.asarray(JF.cdf_state_to_coder(jstate, pb, v)))
        jstate = JF.cdf_state_update(jstate, jnp.asarray(syms, jnp.int32), rate, v, pb)
        tstate = TF.cdf_state_update(tstate, torch.from_numpy(syms), int(rate), v, pb)
        assert np.array_equal(tstate.numpy(), np.asarray(jstate)), f"step {step}"
    out = torch.empty_like(tstate)
    assert TF.cdf_state_update(tstate, torch.zeros(5, dtype=torch.int64), 4, v, pb,
                               out=out) is out
    with pytest.raises(ValueError, match="not one of vocab"):
        TF.cdf_state_to_coder(tstate, pb, v + 1)
    assert TF.CDF_STATE_BITS == JF.CDF_STATE_BITS


def test_reference_parameters_of_the_mesh_and_process_group(monkeypatch):
    """``my_block_span(process_id=, n_processes=)`` is the reference's;
    ``distributed_init(coordinator, num_processes, process_id)`` maps onto
    torch's init_method, world size and rank; ``make_mesh`` and
    ``MeshConfig.make`` take ``devices``, one a rank."""
    from lac_tpu.parallel.distributed import my_block_span as j_span

    import lac_tpu_torch.parallel.distributed as PD
    from lac_tpu_torch.config import MeshConfig
    from lac_tpu_torch.parallel import make_mesh, mesh_geometry

    assert PD.my_block_span(13, process_id=2, n_processes=4) == j_span(13, 2, 4)
    seen = []
    monkeypatch.setattr(PD.dist, "init_process_group", lambda *a, **k: seen.append((a, k)))
    PD.distributed_init("10.0.0.1:1234", 2, 1, device="cpu")
    PD.distributed_init(coordinator="file:///tmp/rdv", num_processes=3, process_id=2,
                        device="cpu")
    PD.distributed_init(num_processes=1)  # one process: no group
    assert [(k["init_method"], k["world_size"], k["rank"]) for _, k in seen] == [
        ("tcp://10.0.0.1:1234", 2, 1), ("file:///tmp/rdv", 3, 2)]
    monkeypatch.undo()
    try:
        mesh = make_mesh(1, 1, devices=["cpu"])
        assert mesh_geometry(mesh) == {"data": 1, "model": 1}
        assert mesh_geometry(MeshConfig(1, 1).make(devices=[torch.device("cpu")])) == \
            {"data": 1, "model": 1}
        with pytest.raises(ValueError, match="one device a rank"):
            make_mesh(1, 1, devices=["cpu", "cpu"])
        with pytest.raises(ValueError, match="not both"):
            make_mesh(1, 1, devices=["cpu"], device="cpu")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_slide_seg_and_o0c_geometry_are_checked():
    """``slide_seg``, taken by the four LM functions, changes no word; a
    value that is not an int >= 0 is refused. The order0c wrappers code
    the one geometry K8 and K9 are built for (v 256, totals 2**16) and take
    no ``v`` or ``prob_bits`` (JAX_ONLY); their other arguments bind by the
    reference's names."""
    from lac_tpu_torch.models import transformer as T
    from lac_tpu_torch.ops import rans_kernels as rk
    from lac_tpu_torch.runtime import lm_api, lm_engine as E

    cfg = T.tiny_config(max_seq=64)
    model = T.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 80)))
    lengths = torch.tensor([80, 57])
    base, nb = E.lm_encode_windowed(cfg, model, toks, lengths, 16, mode="slide")
    seg, ns = E.lm_encode_windowed(cfg, model, toks, lengths, 16, mode="slide", slide_seg=16)
    assert torch.equal(base, seg) and torch.equal(nb, ns)
    back = E.lm_decode_windowed(cfg, model, seg, lengths, 16, 80, mode="slide", slide_seg=16)
    assert torch.equal(back[1, :57], toks[1, :57])
    data = bytes(np.random.default_rng(1).integers(0, 256, 200, dtype=np.uint8))
    blocks = lm_api.encode_lm_span(cfg, model, data, 0, 3, 80, 2, 16, 2, window_mode="slide",
                                   slide_seg=512)
    from lac_tpu_torch.stream import BlockEntry

    out = lm_api.decode_lm_span(cfg, model, [BlockEntry(*b) for b in blocks], 0, 3, 80, 2, 16,
                                2, window_mode="slide", slide_seg=512)
    assert b"".join(out) == data
    for bad in (-1, 1.5, True, "512"):
        with pytest.raises(ValueError, match="slide_seg"):
            E.lm_encode_windowed(cfg, model, toks, lengths, 16, slide_seg=bad)
    from lac_tpu_torch.models.functional import O0C_V

    syms = torch.arange(512).remainder(256).to(torch.uint8).reshape(256, 2)
    lo, fr = rk.o0c_encode_intervals(syms_tb=syms, rate=4)
    assert O0C_V == 256 and torch.equal(lo, rk.o0c_encode_intervals(syms, 4)[0])
    assert int(fr.min()) > 0 and int((lo + fr).max()) <= 1 << 16
    for fn, args in ((rk.o0c_encode_intervals, (syms, 4)),
                     (rk.o0c_rans32_decode, (torch.zeros((2, 8), dtype=torch.uint16),
                                             torch.zeros(2, dtype=torch.int32), 8, 4))):
        with pytest.raises(TypeError, match="prob_bits"):
            fn(*args, prob_bits=16)
