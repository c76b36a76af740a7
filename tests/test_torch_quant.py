"""The port's quantized KV cache against ``repro.kernels.quant`` and the
JAX ``DecoderModel``/``Engine`` with ``kv_dtype`` "int8" and "fp8".

Inputs are made from numpy seeds and handed to both sides.  What must be
exact, and is: ``quantize_kv`` (values and scales, bit for bit, against
the function run eagerly), the quantized cache a prefill stores (byte for
byte wherever the two frameworks' bf16 K/V agree, which includes all of
layer 0), the prefill logits against the port's own bf16 prefill, and
greedy tokens against the JAX engine.  Tolerances: the plain quantized
decode against the JAX twin 1e-5 in f32 (summation order only) and 2e-2
in bf16; decode-step logits atol = rtol = 2e-2, as ``test_torch_model.py``.

A jitted JAX ``quantize_kv`` computes its scale as amax * fl(1/127) (XLA
rewrites a division by a constant), the function run eagerly as amax / 127;
the port divides.  So the model-level cache checks run the JAX prefill
eagerly, and the decode checks start both sides from the same cache.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:                      # clean env: deterministic fallback
    from _hyp_fallback import given, settings, strategies as st

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.kernels import quant as JQ  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant as TQ  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode_quant  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.lm import DecoderModel  # noqa: E402
from repro_torch.models.param import params_from_jax  # noqa: E402
from repro_torch.serving import Engine, SamplingParams  # noqa: E402

torch.set_num_threads(2)
QUANT = ["int8", "fp8"]
TOL = {"f32": 1e-5, "bf16": 2e-2}
MODEL_TOL = dict(atol=2e-2, rtol=2e-2)
_STATIC = ("causal", "softcap")
j_decode_quant = jax.jit(JQ.flash_decode_quant_ref, static_argnames=_STATIC)
_PAIRS = {}


def _pair(arch):
    """(jax model, jax params, port model, port params), built once."""
    if arch not in _PAIRS:
        jm = j_build(j_reduced(arch), remat="none")
        jp = jax.jit(jm.init)(jax.random.key(0))
        tm = DecoderModel(reduced_config(arch), device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, "cpu")
        _PAIRS[arch] = (jm, jp, tm, tp)
    return _PAIRS[arch]


@pytest.fixture
def pair(request):
    """The models of ``request.param`` with kv_dtype bf16 again after the
    test (the engines pin the model's kv_dtype, as in the reference)."""
    jm, jp, tm, tp = _pair(request.param)
    yield jm, jp, tm, tp
    jm.kv_dtype = tm.kv_dtype = "bf16"


def _bytes(x):
    """Bit pattern of a jnp or torch array, as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view({1: torch.uint8, 2: torch.int16,
                       4: torch.int32}[x.element_size()]).numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.itemsize])


def _to_torch(x):
    """A jnp leaf as a torch tensor of the same dtype and bits."""
    a = np.array(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# quantize / dequantize
def _edge_vectors(kv_dtype):
    """Vectors whose quantization is decided by rounding edge cases: zero,
    flat, exactly ±amax, and with amax on the grid's max (scale 1) exact
    ties -- half-to-even for int8, and e4m3 subnormals (step 2^-9) with
    their ties for fp8."""
    top = 127.0 if kv_dtype == "int8" else 448.0
    x = np.zeros((6, 32), np.float32)
    x[1] = 3.0                                          # flat
    x[2] = np.linspace(-1.0, 1.0, 32)                  # ±amax exactly
    x[3, 0] = -top
    x[4, 0] = x[5, 0] = top
    if kv_dtype == "int8":
        x[3, 1:] = np.arange(31) - 15.5                # .5 ties
        x[4, 1:] = np.linspace(-126.5, 126.5, 31)
        x[5, 1:] = (np.arange(31) - 15) * 0.25
    else:
        x[3, 1:] = (np.arange(31) - 15) * 2.0 ** -10   # subnormal ties
        x[4, 1:] = (np.arange(31) - 15) * 2.0 ** -7
        x[5, 1:] = np.geomspace(2.0 ** -12, 440.0, 31)
    return x.reshape(3, 2, 1, 32)


@pytest.mark.parametrize("case", ["edges", "tiny", "unit", "large", "bf16"])
@pytest.mark.parametrize("kv_dtype", QUANT)
def test_quantize_kv_bit_equal_to_jax(kv_dtype, case):
    rng = np.random.default_rng(0)
    if case == "edges":
        x = _edge_vectors(kv_dtype)
    else:
        mag = {"tiny": 1e-6, "unit": 1.0, "large": 1e4, "bf16": 1.0}[case]
        x = (mag * rng.standard_normal((4, 16, 2, 32))).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if case == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    jq, js = JQ.quantize_kv(jx, kv_dtype)
    tq, ts = TQ.quantize_kv(tx, kv_dtype)
    assert tq.dtype == TQ.kv_cache_dtype(kv_dtype) and ts.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(_bytes(ts), _bytes(js))
    np.testing.assert_array_equal(
        TQ.dequantize_kv(tq, ts).numpy(), np.asarray(JQ.dequantize_kv(jq, js)))
    np.testing.assert_array_equal(
        TQ.quant_error_bound(tx, kv_dtype).numpy(),
        np.asarray(JQ.quant_error_bound(jx, kv_dtype)))


@settings(max_examples=20, deadline=None)
@given(st.sampled_from(QUANT), st.integers(0, 2 ** 16),
       st.sampled_from([0.05, 1.0, 40.0]))
def test_roundtrip_error_within_bound(kv_dtype, seed, mag):
    """|x - dequantize(quantize(x))| <= quant_error_bound per vector, as
    ``test_quant.py``'s property, plus four f32 roundings at amax's scale
    (the division x / scale, the scale, the dequantizing multiply and the
    bound itself, each <= 2^-24 amax): near a rounding tie the f32 error
    of x / scale alone reaches 127 or 448 ulps of the grid index, i.e.
    about 2^-24 amax, so the reference's slack of 1e-6 x bound is met only
    where no element sits that close to a tie (seed 10066, mag 0.05, int8
    has one: 0.89 x 2^-24 amax over the bound)."""
    x = torch.from_numpy((mag * np.random.default_rng(seed).standard_normal(
        (3, 16, 2, 32))).astype(np.float32))
    q, scale = TQ.quantize_kv(x, kv_dtype)
    assert scale.shape == x.shape[:-1]
    err = (x - TQ.dequantize_kv(q, scale)).abs()
    bound = TQ.quant_error_bound(x, kv_dtype)
    amax = x.abs().amax(-1)
    assert bool((err <= (bound + 4 * 2.0 ** -24 * amax)[..., None]).all())


@pytest.mark.parametrize("hd", [16, 64, 128, 256])
def test_kv_bytes_per_vector_and_dtypes_match_jax(hd):
    for kv_dtype in TQ.KV_DTYPES:
        assert TQ.kv_bytes_per_vector(hd, kv_dtype) == \
            JQ.kv_bytes_per_vector(hd, kv_dtype)
        assert np.dtype(JQ.kv_cache_dtype(kv_dtype)).itemsize == \
            TQ.kv_cache_dtype(kv_dtype).itemsize
        assert TQ.kv_dtype_of(TQ.kv_cache_dtype(kv_dtype)) == kv_dtype
    assert TQ.KV_DTYPES == JQ.KV_DTYPES
    assert TQ.QUANTIZED_KV_DTYPES == JQ.QUANTIZED_KV_DTYPES


def test_kv_dtype_validation():
    with pytest.raises(ValueError):
        TQ.kv_cache_dtype("int4")
    with pytest.raises(ValueError):
        TQ.quantize_kv(torch.zeros(1, 8), "bf16")
    with pytest.raises(ValueError):
        DecoderModel(reduced_config("gemma-2b"), kv_dtype="int4",
                     device="cpu")


# ---------------------------------------------------------------------------
# the plain quantized decode
def _quant_case(seed, kv_dtype, B, H, K, d, T, lengths, holes=0, ring=None):
    """q (f32), quantized K/V and scales (made by the JAX function), and
    positions: rows of ``lengths`` keys, -1 holes, or a ring wrapped
    ``ring`` tokens past T."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, d)).astype(np.float32)
    k = rng.standard_normal((B, T, K, d)).astype(np.float32)
    v = rng.standard_normal((B, T, K, d)).astype(np.float32)
    k_pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    for b, n in enumerate(lengths):
        k_pos[b, n:] = -1
    if holes:
        k_pos[rng.integers(0, B, holes), rng.integers(0, T, holes)] = -1
    q_pos = np.asarray([max(n, 1) for n in lengths], np.int32)
    if ring is not None:                       # slot s holds the newest s
        slots = np.arange(T)
        k_pos[:] = np.where(slots < ring % T, slots + (ring // T) * T,
                            slots + (ring // T - 1) * T)
        q_pos[:] = ring
    kq, ks = JQ.quantize_kv(jnp.asarray(k), kv_dtype)
    vq, vs = JQ.quantize_kv(jnp.asarray(v), kv_dtype)
    return q, (kq, vq, ks, vs), q_pos, k_pos


def _both_decode(q, quant, q_pos, k_pos, dt, **kw):
    kq, vq, ks, vs = quant
    jq = jnp.asarray(q).astype(jnp.float32 if dt == "f32" else jnp.bfloat16)
    tq = torch.from_numpy(q).to(torch.float32 if dt == "f32"
                                else torch.bfloat16)
    want = j_decode_quant(jq, kq, vq, jnp.asarray(q_pos)[:, None],
                          jnp.asarray(k_pos), ks, vs, **kw)
    tquant = [_to_torch(x) for x in quant]
    got = TQ.flash_decode_quant_ref(
        tq, tquant[0], tquant[1], torch.from_numpy(q_pos),
        torch.from_numpy(k_pos), tquant[2], tquant[3], **kw)
    return got, want


DECODE_CASES = [(H, K, "plain") for H, K in [(8, 2), (8, 1)]] + [
    (8, 2, v) for v in ("ring_holes", "window", "softcap")]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("H,K,variant", DECODE_CASES)
@pytest.mark.parametrize("kv_dtype", QUANT)
def test_flash_decode_quant_ref_matches_jax(kv_dtype, H, K, variant, dt):
    """GQA and MQA; ring wraparound with holes, a window, softcap; the f32
    query holds the algorithm, the bf16 one the rounding points."""
    T = 32
    kw = {"window": 8} if variant == "window" else (
        {"softcap": 20.0} if variant == "softcap" else {})
    q, quant, q_pos, k_pos = _quant_case(
        4, kv_dtype, 3, H, K, 16, T, [T, 20, 0],
        holes=6 if variant == "ring_holes" else 0,
        ring=52 if variant == "ring_holes" else None)
    if variant == "ring_holes":
        k_pos[1, 3:9] = -1
    got, want = _both_decode(q, quant, q_pos, k_pos, dt, **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dt],
                               rtol=0)
    if variant != "ring_holes":
        assert (got[2] == 0).all()             # no valid key: zeros


@pytest.mark.parametrize("splits", [2, 5, 16])
def test_flash_decode_quant_split_invariance(splits):
    q, quant, q_pos, k_pos = _quant_case(6, "int8", 2, 8, 2, 32, 128,
                                         [128, 70])
    t = [_to_torch(x) for x in quant]
    args = (torch.from_numpy(q), t[0], t[1], torch.from_numpy(q_pos),
            torch.from_numpy(k_pos), t[2], t[3])
    one = TQ.flash_decode_quant_ref(*args)
    many = TQ.flash_decode_quant_ref(*args, splits=splits)
    np.testing.assert_allclose(many.numpy(), one.numpy(), atol=2e-6,
                               rtol=2e-6)


def test_ops_dispatch_quant_on_cpu():
    """Scales send a CPU decode to the plain quantized version; a
    multi-token query with scales is refused; the CUDA wrapper refuses CPU
    tensors and never counts a launch."""
    q, quant, q_pos, k_pos = _quant_case(10, "int8", 2, 8, 2, 16, 32,
                                         [32, 11])
    kq, vq, ks, vs = (_to_torch(x) for x in quant)
    tq, qp, kp = (torch.from_numpy(x) for x in (q, q_pos, k_pos))
    flash_decode_quant.launches = 0
    out = ops.flash_attention(tq.bfloat16(), kq, vq, qp[:, None], kp,
                              k_scale=ks, v_scale=vs)
    want = TQ.flash_decode_quant_ref(tq.bfloat16(), kq, vq, qp, kp, ks, vs)
    assert torch.equal(out, want)
    with pytest.raises(NotImplementedError, match="S == 1"):
        ops.flash_attention(tq.repeat(1, 2, 1, 1), kq, vq, qp[:, None]
                            .repeat(1, 2), kp, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_quant(tq.bfloat16(), kq, vq, qp, kp, ks, vs)
    assert flash_decode_quant.launches == 0


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_attention_multi_token_dequantizes_first(kv_dtype):
    """S > 1 over a quantized cache attends the cache dequantized to the
    compute dtype: equal to the bf16 branch on that dequantized cache."""
    cfg = reduced_config("qwen3-32b")
    _, _, tm, tp = _pair("qwen3-32b")
    p = tlm._layer(tp["layers"], 0)["attn"]
    rng = np.random.default_rng(3)
    B, S, T = 2, 3, 10
    x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                         .astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal(
        (B, T, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32))
    kq, ks = TQ.quantize_kv(k, kv_dtype)
    vq, vs = TQ.quantize_kv(-k, kv_dtype)
    pos = torch.tensor([[7, 8, 9], [2, 3, -1]], dtype=torch.int32)
    kp = torch.arange(T, dtype=torch.int32).repeat(B, 1)
    got, _ = tlayers.attention(p, x, cfg, positions=pos,
                               cache_kv=(kq, vq, kp, ks, vs))
    deq = [TQ.dequantize_kv(a, s).bfloat16() for a, s in ((kq, ks), (vq, vs))]
    want, _ = tlayers.attention(p, x, cfg, positions=pos,
                                cache_kv=(*deq, kp))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the cache
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("pair", ["qwen3-32b"], indirect=True)
def test_init_cache_matches_cache_spec(pair, kv_dtype):
    jm, _, tm, _ = pair
    spec = jm.cache_spec(2, 24, kv_dtype=kv_dtype)
    cache = tm.init_cache(2, 24, kv_dtype=kv_dtype)
    assert set(cache) == set(spec)
    for key, s in spec.items():
        if key == "len":
            continue
        assert tuple(cache[key].shape) == s.shape, key
        assert cache[key].element_size() == np.dtype(s.dtype).itemsize, key
        want = jm.init_cache(2, 24, kv_dtype=kv_dtype)[key]
        np.testing.assert_array_equal(_bytes(cache[key]), _bytes(want))
    assert cache["k"].dtype == TQ.kv_cache_dtype(kv_dtype)
    tm.kv_dtype = kv_dtype                     # the model's is the default
    assert tm.init_cache(1, 8)["v"].dtype == TQ.kv_cache_dtype(kv_dtype)
    if kv_dtype != "bf16":
        with pytest.raises(NotImplementedError, match="slice 4"):
            tm.init_cache(2, 24, paged=(8, 4))


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_cache_write_quant_matches_jax(kv_dtype):
    """The in-place quantizing write equals the reference's functional one
    (run eagerly), at one shared position and at per-row positions that
    wrap the ring."""
    B, T, K, hd = 3, 8, 2, 16
    rng = np.random.default_rng(5)
    k_new = rng.standard_normal((B, 1, K, hd)).astype(np.float32)
    v_new = rng.standard_normal((B, 1, K, hd)).astype(np.float32)
    kc, ks = JQ.quantize_kv(jnp.asarray(rng.standard_normal(
        (B, T, K, hd)).astype(np.float32)), kv_dtype)
    vc, vs = JQ.quantize_kv(jnp.asarray(rng.standard_normal(
        (B, T, K, hd)).astype(np.float32)), kv_dtype)
    pc = jnp.asarray(rng.integers(0, 5, (B, T)).astype(np.int32))
    for pos in (5, np.asarray([3, 11, 0], np.int32)):
        want = jlm._cache_write_quant(kc, vc, pc, ks, vs, jnp.asarray(k_new),
                                      jnp.asarray(v_new), jnp.asarray(pos),
                                      kv_dtype)
        got = [_to_torch(x).clone() for x in (kc, vc, pc, ks, vs)]
        tpos = pos if isinstance(pos, int) else torch.from_numpy(pos)
        tlm._cache_write_quant(*got, torch.from_numpy(k_new),
                               torch.from_numpy(v_new), tpos)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bytes(g), _bytes(w))


# ---------------------------------------------------------------------------
# the model
def _padded_batch(toks, S, Sp):
    B = toks.shape[0]
    tp = np.zeros((B, Sp), np.int32)
    tp[:, :S] = toks[:, :S]
    pos = np.broadcast_to(np.where(np.arange(Sp) < S, np.arange(Sp), -1),
                          (B, Sp)).astype(np.int32)
    return {"tokens": tp, "positions": pos,
            "length": np.full((B,), S, np.int32)}


@pytest.mark.parametrize("kv_dtype", QUANT)
@pytest.mark.parametrize("pair", ["gemma-2b", "qwen3-32b"], indirect=True)
def test_prefill_logits_bit_equal_and_cache_equal_to_jax(pair, kv_dtype):
    """Prefill computes in bf16 whatever the cache: its logits equal the
    bf16 prefill's bit for bit.  Its quantized cache equals the JAX
    prefill's (run eagerly: see the module docstring) byte for byte in
    every vector whose bf16 K/V the two frameworks compute alike -- all of
    layer 0 -- and elsewhere dequantizes to within the quantization bound
    of JAX's bf16 K/V, plus bf16 rounding."""
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    batch = _padded_batch(toks, 12, 16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_logits_bf, t_bf = tm.prefill(tp, tb)
    _, j_bf = jm.prefill(jp, jb)
    jm.kv_dtype = tm.kv_dtype = kv_dtype
    t_logits, tc = tm.prefill(tp, tb)
    _, jc = jm.prefill(jp, jb)
    assert torch.equal(t_logits, t_logits_bf)
    assert set(tc) == set(jc)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        assert tc[key].dtype == TQ.kv_cache_dtype(kv_dtype)
        same = (_bytes(t_bf[key]) == _bytes(j_bf[key])).all(-1)
        assert same[0].all()
        q_eq = (_bytes(tc[key]) == _bytes(jc[key])).all(-1)
        s_eq = _bytes(tc[key + "_scale"]) == _bytes(jc[key + "_scale"])
        assert q_eq[same].all() and s_eq[same].all()
        deq = TQ.dequantize_kv(tc[key], tc[key + "_scale"]).numpy()
        ref = np.asarray(j_bf[key], np.float32)
        bound = TQ.quant_error_bound(torch.from_numpy(ref), kv_dtype).numpy()
        assert (np.abs(deq - ref) <= bound[..., None] * 1.01
                + 2e-2 * np.abs(ref).max(-1, keepdims=True)).all()


@pytest.mark.parametrize("kv_dtype", QUANT)
@pytest.mark.parametrize("pair", ["gemma-2b", "qwen3-32b"], indirect=True)
def test_decode_steps_match_jax(pair, kv_dtype):
    """Six decode steps from the JAX prefill's quantized cache (bridged
    bit for bit), each quantizing its K/V into the cache: logits within
    2e-2 of JAX's at every step, positions identical."""
    jm, jp, tm, tp = pair
    jm.kv_dtype = tm.kv_dtype = kv_dtype
    toks = np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (2, 18)).astype(np.int32)
    batch = _padded_batch(toks, 12, 24)
    _, jc = jax.jit(jm.prefill)(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    tc = {k: (int(v) if k == "len" else _to_torch(v)) for k, v in jc.items()}
    jdecode = jax.jit(jm.decode_step)
    for s in range(12, 18):
        step = {"tokens": toks[:, s:s + 1],
                "positions": np.full((2, 1), s, np.int32),
                "pos_row": np.full((2,), s, np.int32)}
        jl, jc = jdecode(jp, {k: jnp.asarray(v) for k, v in step.items()},
                         jc)
        tl, tc = tm.decode_step(tp, {k: torch.from_numpy(v)
                                     for k, v in step.items()}, tc)
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, np.float32), **MODEL_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert tc["k"].dtype == TQ.kv_cache_dtype(kv_dtype)


# ---------------------------------------------------------------------------
# serving
def _golden_prompts():
    rng = np.random.default_rng(42)
    return [rng.integers(2, 500, n).astype(np.int32) for n in (6, 14)]


@pytest.mark.parametrize("kv_dtype", QUANT)
@pytest.mark.parametrize("pair", ["gemma-2b", "qwen3-32b"], indirect=True)
def test_engine_greedy_matches_jax_engine(pair, kv_dtype):
    """The mixed-length golden of ``test_torch_serving.py`` (prompts of 6
    and 14 tokens, 2 slots, prefill_len 16, cache_len 48): greedy tokens
    identical to ``repro.serving.Engine(kv_dtype=...)``."""
    jm, jp, tm, tp = pair
    prompts = _golden_prompts()
    je = JEngine(jm, jp, slots=2, prefill_len=16, cache_len=48,
                 kv_dtype=kv_dtype)
    want = [r.tokens for r in je.generate(prompts, max_ticks=50)]
    te = Engine(tm, tp, slots=2, prefill_len=16, cache_len=48,
                kv_dtype=kv_dtype, device="cpu")
    got = [r.tokens for r in te.generate(prompts, max_ticks=50)]
    assert got == want
    assert te.cache["k"].dtype == TQ.kv_cache_dtype(kv_dtype)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("pair", ["gemma-2b"], indirect=True)
def test_engine_kv_bytes_and_stats(pair, kv_dtype):
    """Byte-true ``kv_bytes_per_token`` equal to the reference engine's;
    ``stats()`` names the dtype; ``kv_utilization`` counts the narrow
    bytes; an explicit kv_dtype pins the model's, as in the reference."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    je = JEngine(jm, jp, slots=1, prefill_len=16, cache_len=32,
                 kv_dtype=kv_dtype)
    te = Engine(tm, tp, slots=1, prefill_len=16, cache_len=32,
                kv_dtype=kv_dtype, device="cpu")
    assert te.kv_bytes_per_token == je.kv_bytes_per_token == (
        cfg.num_layers * 2 * cfg.num_kv_heads
        * TQ.kv_bytes_per_vector(cfg.head_dim, kv_dtype))
    assert tm.kv_dtype == te.kv_dtype == kv_dtype
    res = te.generate([_golden_prompts()[0]],
                      SamplingParams(max_new_tokens=4, eos_token=None))[0]
    s = te.stats()
    assert s["kv_dtype"] == kv_dtype
    used = (res.metrics.prompt_tokens + 4 - 1) * te.kv_bytes_per_token
    assert res.metrics.kv_used_bytes == used       # the last is not cached
    assert s["kv_used_mb"] == pytest.approx(used / 1e6)
    assert s["kv_allocated_mb"] == pytest.approx(
        32 * te.kv_bytes_per_token / 1e6)
    assert s["kv_utilization"] == pytest.approx(
        used / (32 * te.kv_bytes_per_token))


def test_engine_rejects_paged_quantized_and_unknown_dtypes():
    _, _, tm, tp = _pair("gemma-2b")
    for kv_dtype in QUANT:
        with pytest.raises(NotImplementedError, match="slice 4"):
            Engine(tm, tp, block_size=16, kv_dtype=kv_dtype, device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        Engine(tm, tp, kv_dtype="int4", device="cpu")
    assert tm.kv_dtype == "bf16"               # refused: the model untouched


@pytest.mark.parametrize("kv_dtype", QUANT)
@pytest.mark.parametrize("pair", ["gemma-2b"], indirect=True)
def test_reused_slot_shows_no_stale_scale(pair, kv_dtype):
    """A long request, then a short one in the same slot: right after the
    short one's join and first tick, every cache leaf (K/V, positions and
    scales) equals a fresh engine's, and its tokens equal it alone."""
    _, _, tm, tp = pair
    long_p, short_p = _golden_prompts()[1], _golden_prompts()[0]
    sp = SamplingParams(max_new_tokens=6, eos_token=None)
    kw = dict(slots=1, prefill_len=16, cache_len=32, kv_dtype=kv_dtype,
              device="cpu")
    reused, fresh = Engine(tm, tp, **kw), Engine(tm, tp, **kw)
    reused.generate([long_p], sp)
    assert (reused.cache["k_scale"][:, 0, len(short_p):] > 0).any()
    for e in (reused, fresh):
        e.submit(short_p, sp)
        e.step()
    for key in ("k", "v", "pos", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_bytes(reused.cache[key]),
                                      _bytes(fresh.cache[key]), err_msg=key)
    assert reused.run()[1].tokens == fresh.run()[0].tokens
