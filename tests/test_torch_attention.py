"""The plain versions of K10-K12 (lac_tpu_torch/ops/attention.py), which the
CPU runs and the card's kernels are held to, against the JAX library's
attention that lac_tpu's training reaches: flash attention's own plain
reference ``mha_reference`` with its custom VJP, and the splash Pallas
kernel itself in interpret mode, each through ``jax.vjp``; and against
torch autograd through a naive attention.

Inputs are made with numpy from a seed and handed to both. bf16 inputs go
to the JAX side as their exact f32 values, so both sides compute the same
function in f32 and the port's one rounding of its outputs to bf16 is what
differs.

Tolerances, as max |port - reference| / max(max |reference|, 1) per output
(the floor of 1 is for S = 1, where dQ and dK are 0 and both sides'
dS = P (dP - di) cancel to rounding of terms of size ~|dO| |V| > 1):
- f32: 2e-5 for o, 1e-4 for the gradients. Both sides sum in f32 in
  different orders; dS = P (dP - di) subtracts two sums of S terms, which
  costs the gradients a few more ulps of the larger terms.
- bf16 outputs: 8e-3, one bf16 rounding (2^-8 of the largest value) after
  the f32 result.
- lse: 1e-5 absolute against log-sum-exp of the same f32 scores."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as fa
from jax.experimental.pallas.ops.tpu.splash_attention import (
    splash_attention_kernel as sk,
    splash_attention_mask as sm,
)

from lac_tpu_torch.ops import attention as A

TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (8e-3, 8e-3)}


def _inputs(b, h, s, d, dtype, seed=0, amp=2.0):
    """q, k, v, dO as numpy f32 holding values exact in ``dtype``, and the
    torch tensors [B, H, S, D]. ``amp`` sharpens the softmax."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, s, d)).astype(np.float32) * amp for _ in range(4)]
    ts = [torch.from_numpy(a).to(dtype) for a in arrs]
    return [t.float().numpy() for t in ts], ts


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    if want.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


def _jax_reference(q, k, v, do, scale):
    """(o, (dq, dk, dv)) of mha_reference, causal, via jax.vjp, in f32. Its
    custom VJP takes only sm_scale 1, so the scale multiplies q first and
    jax.vjp carries it into dq."""
    fn = lambda a, b, c: fa.mha_reference(a * np.float32(scale), b, c, None, causal=True)  # noqa: E731
    o, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 7, 130, 256])
def test_plain_matches_mha_reference(s, d, dtype):
    b, h = 2, 2
    scale = 1.0 / d ** 0.5
    (qn, kn, vn, don), (q, k, v, do) = _inputs(b, h, s, d, dtype, seed=s + d)
    o, lse = A.attention_plain_fwd(q, k, v, scale)
    ro, (rdq, rdk, rdv) = _jax_reference(qn, kn, vn, don, scale)
    assert o.dtype == dtype and lse.dtype == torch.float32
    t_o, t_g = TOL[dtype]
    assert _rel(o, ro) <= t_o
    # lse against log-sum-exp of the masked f32 scores
    sc = np.einsum("bhqd,bhkd->bhqk", qn, kn) * np.float32(scale)
    sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    rlse = (m + np.log(np.exp(sc - m).sum(-1, keepdims=True)))[..., 0]
    assert np.abs(lse.numpy() - rlse).max() <= 1e-5 * max(1.0, np.abs(rlse).max())
    dq, dk, dv = A.attention_plain_bwd(q, k, v, o, lse, do, scale)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == dtype
        assert _rel(got, want) <= t_g


@pytest.mark.parametrize("d", [64, 128])
def test_plain_matches_splash_kernel_interpreted(d):
    """splash folds the scale into q (lac_tpu/models/transformer.py:715);
    the port runs the same function at scale 1."""
    h, s = 2, (256 if d == 64 else 128)
    scale = np.float32(1.0 / d ** 0.5)
    (qn, kn, vn, don), _ = _inputs(1, h, s, d, torch.float32, seed=d)
    qn = qn * scale
    mask = sm.MultiHeadMask([sm.CausalMask((s, s)) for _ in range(h)])
    kernel = sk.make_splash_mha_single_device(mask=mask, interpret=True)
    ro, vjp = jax.vjp(kernel, *(jnp.asarray(x[0]) for x in (qn, kn, vn)))
    rgrads = vjp(jnp.asarray(don[0]))
    q, k, v, do = (torch.from_numpy(x) for x in (qn, kn, vn, don))
    o, lse = A.attention_plain_fwd(q, k, v, 1.0)
    assert _rel(o[0], ro) <= 2e-5
    for got, want in zip(A.attention_plain_bwd(q, k, v, o, lse, do, 1.0), rgrads):
        assert _rel(got[0], want) <= 1e-4


@pytest.mark.parametrize("d", [64, 128])
def test_plain_matches_splash_kernel_interpreted_bf16(d):
    """The splash kernel on bf16 inputs rounds P and dS to bf16 before its
    second products, where the card's tensor-core K10-K12 round them. Its
    O, dQ, dK and dV stay within the card's bf16 tolerance (chip_smoke.py's
    ATTN_TOL["bf16"], 1e-2 of max(max |plain|, 1)) of the plain versions,
    which the card holds K10-K12 to: so that tolerance admits the
    reference's rounding points."""
    h, s = 2, (256 if d == 64 else 128)
    (qn, kn, vn, don), _ = _inputs(1, h, s, d, torch.bfloat16, seed=d + 1)
    # splash takes q pre-scaled, in the model's type (transformer.py:715)
    qn = torch.from_numpy(qn * np.float32(1.0 / d ** 0.5)).to(torch.bfloat16).float().numpy()
    mask = sm.MultiHeadMask([sm.CausalMask((s, s)) for _ in range(h)])
    kernel = sk.make_splash_mha_single_device(mask=mask, interpret=True)
    ro, vjp = jax.vjp(kernel, *(jnp.asarray(x[0], jnp.bfloat16) for x in (qn, kn, vn)))
    rdq, rdk, rdv = vjp(jnp.asarray(don[0], jnp.bfloat16))
    assert ro.dtype == rdq.dtype == rdk.dtype == jnp.bfloat16
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in (qn, kn, vn, don))
    o, lse = A.attention_plain_fwd(q, k, v, 1.0)
    dq, dk, dv = A.attention_plain_bwd(q, k, v, o, lse, do, 1.0)
    for got, want in ((o, ro), (dq, rdq), (dk, rdk), (dv, rdv)):
        assert _rel(got[0], np.asarray(want, np.float32)) <= 1e-2


@pytest.mark.parametrize("s", [1, 7, 130])
def test_plain_backward_matches_autograd(s):
    """The recompute-from-lse backward against torch autograd through a
    naive f32 attention with -inf masking."""
    b, h, d, scale = 2, 3, 16, 0.25
    (_, _, _, _), (q, k, v, do) = _inputs(b, h, s, d, torch.float32, seed=7)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    sc = torch.matmul(qr, kr.transpose(-1, -2)) * scale
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    ref = torch.matmul(torch.softmax(sc.masked_fill(~keep, float("-inf")), -1), vr)
    ref.backward(do)
    o, lse = A.attention_plain_fwd(q, k, v, scale)
    assert _rel(o, ref.detach()) <= 2e-5
    for got, want in zip(A.attention_plain_bwd(q, k, v, o, lse, do, scale),
                         (qr.grad, kr.grad, vr.grad)):
        assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_autograd_function_on_cpu_runs_plain_versions(layout):
    """causal_attention on CPU tensors: the plain versions through autograd,
    whatever the storage order, and no kernel launch is counted."""
    (_, _, _, _), (q, k, v, do) = _inputs(2, 2, 70, 8, torch.float32, seed=3)
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    A.reset_launches()
    o = A.causal_attention(qr, kr, vr, 0.3)
    o.backward(do)
    assert set(A.launches.values()) == {0}
    po, lse = A.attention_plain_fwd(q, k, v, 0.3)
    assert torch.equal(o.detach(), po)
    for got, want in zip((qr.grad, kr.grad, vr.grad), A.attention_plain_bwd(q, k, v, po, lse, do, 0.3)):
        assert torch.equal(got, want)


def test_wrappers_check_their_arguments():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="no GQA"):
        A.causal_attn_fwd(q, torch.zeros(1, 1, 8, 16), torch.zeros(1, 1, 8, 16), 1.0)
    with pytest.raises(TypeError):
        A.causal_attn_fwd(q, q.double(), q, 1.0)
    with pytest.raises(ValueError, match="B, H, S, D"):
        A.causal_attn_fwd(q[0], q[0], q[0], 1.0)


def test_kernel_layouts_are_recognised():
    """The two storage orders the kernels take without a copy."""
    x = torch.zeros(3, 5, 4, 64)  # [B, S, H, D]
    assert A._strides(x.transpose(1, 2)) == (64, 4 * 64)
    assert A._strides(x.transpose(1, 2).contiguous()) == (5 * 64, 64)
    assert A._strides(torch.zeros(3, 4, 64, 5).transpose(2, 3)) is None


def test_tma_strides_of_both_storage_orders():
    """Byte strides (position, head, batch) of the TMA maps that the
    tensor-core K10 and K11 read through, from the storage order that
    ``_strides`` finds, and the refusals TMA needs."""
    def strides(t, *ts):
        return A.tma_strides(A._strides(t), t, *ts)

    x = torch.zeros(3, 5, 4, 64, dtype=torch.bfloat16)  # [B, S, H, D]
    assert strides(x.transpose(1, 2)) == (4 * 64 * 2, 64 * 2, 5 * 4 * 64 * 2)
    assert strides(x.transpose(1, 2).contiguous()) == (64 * 2, 5 * 64 * 2, 4 * 5 * 64 * 2)
    y = torch.zeros(1, 7, 2, 128, dtype=torch.bfloat16)  # a batch of one: H S D elements
    assert strides(y.transpose(1, 2)) == (2 * 128 * 2, 128 * 2, 2 * 7 * 128 * 2)
    with pytest.raises(ValueError, match="multiples of 16"):
        strides(torch.zeros(1, 2, 8, 4, dtype=torch.bfloat16))  # 8-byte rows
    off = torch.zeros(2 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 1, 2, 64)  # 2 bytes off
    with pytest.raises(ValueError, match="16-byte-aligned"):
        strides(off)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        strides(x.transpose(1, 2), off)
