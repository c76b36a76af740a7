"""The port's plain attention kernels against the JAX package's pure-jnp
twins (``repro.kernels.ref``), on the same seeded numpy inputs.

f32 runs hold the algorithm (atol 1e-5: only the summation order
differs); bf16 runs hold the rounding points (atol 2e-2: bf16 has an
8-bit mantissa, and p is rounded relative to a different running max).
The CUDA kernels themselves are checked against these plain versions on
the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode  # noqa: E402

torch.set_num_threads(2)

TOL = {"f32": 1e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
GEOMS = [(4, 4), (8, 1), (8, 2), (16, 4)]          # (H, K): MHA, MQA, GQA
# every geometry plain; the masking variants on MQA (gemma) and GQA (qwen3)
DECODE_CASES = [(H, K, "plain") for H, K in GEOMS] + [
    (H, K, v) for H, K in [(8, 1), (8, 2)]
    for v in ("ragged_holes", "window", "softcap")]
FORWARD_CASES = [(H, K, "plain") for H, K in GEOMS] + [
    (H, K, v) for H, K in [(8, 1), (8, 2)]
    for v in ("chunked", "pad_rows", "window", "softcap")]
_STATIC = ("causal", "softcap", "chunk")
j_decode = jax.jit(jref.flash_decode_ref, static_argnames=_STATIC[:2])
j_forward = jax.jit(jref.flash_attention_ref, static_argnames=_STATIC)


def _both(x, dt):
    """The same array as a jnp and a torch tensor of dtype ``dt``."""
    return jnp.asarray(x).astype(JDT[dt]), torch.from_numpy(x).to(TDT[dt])


def _pos_both(x):
    x = np.asarray(x, np.int32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32), atol=tol,
                               rtol=0)


def _decode_case(seed, B, H, K, d, T, lengths, holes=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, d)).astype(np.float32)
    k = rng.standard_normal((B, T, K, d)).astype(np.float32)
    v = rng.standard_normal((B, T, K, d)).astype(np.float32)
    k_pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    for b, n in enumerate(lengths):
        k_pos[b, n:] = -1
    if holes:                                  # -1 ring slots
        k_pos[rng.integers(0, B, holes), rng.integers(0, T, holes)] = -1
    q_pos = np.asarray([max(n, 1) for n in lengths], np.int32)
    return q, k, v, q_pos, k_pos


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("H,K,variant", DECODE_CASES)
def test_flash_decode_matches_jax_ref(dt, H, K, variant):
    T = 37 if variant == "ragged_holes" else 48
    lengths = [T, 20, 0]                       # full, mixed, empty row
    kw = {"window": 9} if variant == "window" else (
        {"softcap": 2.0} if variant == "softcap" else {})
    q, k, v, q_pos, k_pos = _decode_case(
        1, 3, H, K, 16, T, lengths, holes=8 if variant == "ragged_holes" else 0)
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dt), _both(k, dt), _both(v, dt)
    (jqp, tqp), (jkp, tkp) = _pos_both(q_pos), _pos_both(k_pos)
    want = j_decode(jq, jk, jv, jqp, jkp, **kw)
    got = tref.flash_decode_ref(tq, tk, tv, tqp, tkp, **kw)
    _close(got, want, TOL[dt])
    assert (got[2] == 0).all()                 # no valid key: zeros


@pytest.mark.parametrize("splits", [2, 3, 7, 48])
def test_flash_decode_split_count_invariance(splits):
    """Per-split partials + the log-sum-exp combine equal one pass."""
    q, k, v, q_pos, k_pos = _decode_case(2, 4, 8, 2, 16, 45, [45, 30, 3, 0],
                                         holes=6)
    t = [torch.from_numpy(x) for x in (q, k, v, q_pos, k_pos)]
    one = tref.flash_decode_ref(*t)
    many = tref.flash_decode_ref(*t, splits=splits)
    np.testing.assert_allclose(many.numpy(), one.numpy(), atol=1e-6)
    acc, m, l = tref.flash_decode_partials(*t, splits=splits)
    dead = (l == 0)
    assert (m[dead] == tref.NEG_INF).all()     # dead splits drop out


def test_combine_partials_matches_jax():
    from repro.kernels.flash_decode import combine_partials
    rng = np.random.default_rng(3)
    o = rng.standard_normal((2, 3, 5, 4, 16)).astype(np.float32)
    m = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    l = rng.random((2, 3, 5, 4)).astype(np.float32)
    m[0, 0, 1], l[0, 0, 1] = tref.NEG_INF, 0.0          # a dead split
    m[1, 2, :, 0], l[1, 2, :, 0] = tref.NEG_INF, 0.0    # a dead row
    o[1, 2, :, 0] = 0.0                        # (its partials are empty)
    want = jax.jit(combine_partials)(jnp.asarray(o), jnp.asarray(m),
                                     jnp.asarray(l))
    got = tref.combine_partials(*(torch.from_numpy(x) for x in (o, m, l)))
    _close(got, want, 1e-5)
    assert (got[1, 2, 0] == 0).all()


def _fwd_case(seed, B, S, H, K, d, T, pad_from=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    k = rng.standard_normal((B, T, K, d)).astype(np.float32)
    v = rng.standard_normal((B, T, K, d)).astype(np.float32)
    q_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    k_pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    if pad_from is not None:                   # right-padded last row
        q_pos[-1, pad_from:] = -1
        k_pos[-1, pad_from:] = -1
    return q, k, v, q_pos, k_pos


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("H,K,variant", FORWARD_CASES)
def test_flash_forward_matches_jax_ref(dt, H, K, variant):
    """Grouped K/V in the port; the reference takes them expanded
    (``_expand_kv``).  Pad rows (q_pos = -1) have no valid key and come
    out as the mean of V in both."""
    q, k, v, q_pos, k_pos = _fwd_case(
        4, 2, 48, H, K, 16, 48, pad_from=40 if variant == "pad_rows" else None)
    kw = {"window": 7} if variant == "window" else (
        {"softcap": 3.0} if variant == "softcap" else {})
    chunk = 16 if variant == "chunked" else 1024
    G = H // K
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dt), _both(k, dt), _both(v, dt)
    (jqp, tqp), (jkp, tkp) = _pos_both(q_pos), _pos_both(k_pos)
    want = j_forward(jq, jnp.repeat(jk, G, 2),
                     jnp.repeat(jv, G, 2), jqp, jkp, chunk=chunk, **kw)
    got = tref.flash_attention_ref(tq, tk, tv, tqp, tkp, chunk=chunk, **kw)
    _close(got, want, TOL[dt])
    if variant == "pad_rows":
        mean_v = tv[-1].float().mean(0).repeat_interleave(G, 0)   # (H, d)
        np.testing.assert_allclose(got[-1, 40:].float().numpy(),
                                   np.broadcast_to(mean_v.numpy(),
                                                   (8, H, 16)),
                                   atol=TOL[dt])


@pytest.mark.parametrize("T", [37, 61])
def test_flash_forward_ragged_matches_oracle(T):
    """Any T: the last key chunk may be ragged (the reference's chunked
    path needs T % chunk == 0; the naive oracle does not)."""
    q, k, v, q_pos, k_pos = _fwd_case(5, 2, T, 8, 2, 16, T)
    want = jax.jit(jref.attention_oracle)(*(jnp.asarray(x) for x in (
        q, np.repeat(k, 4, 2), np.repeat(v, 4, 2), q_pos, k_pos)))
    got = tref.flash_attention_ref(*(torch.from_numpy(x) for x in (
        q, k, v, q_pos, k_pos)), chunk=16)
    _close(got, want, 1e-5)


def test_ops_dispatch_cpu_takes_plain_versions():
    """CPU tensors go to the plain versions; the CUDA wrappers refuse them
    and their launch counts stay 0."""
    q, k, v, q_pos, k_pos = (torch.from_numpy(x) for x in _decode_case(
        6, 2, 8, 1, 64, 40, [40, 10]))
    flash_decode.launches = flash_attention_fwd.launches = 0
    out = ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                              q_pos[:, None], k_pos)
    assert out.shape == (2, 1, 8, 64)
    qf, kf, vf, qpf, kpf = (torch.from_numpy(x) for x in _fwd_case(
        7, 1, 20, 8, 1, 64, 20))
    out = ops.flash_attention(qf, kf, vf, qpf, kpf)
    np.testing.assert_allclose(
        out.numpy(), tref.flash_attention_ref(qf, kf, vf, qpf, kpf).numpy())
    assert flash_decode.launches == 0 and flash_attention_fwd.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q.bfloat16(), k.bfloat16(), v.bfloat16(), q_pos, k_pos)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(qf.bfloat16(), kf.bfloat16(), vf.bfloat16(),
                            qpf, kpf)
