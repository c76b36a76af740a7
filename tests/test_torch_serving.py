"""The port's serving engine against ``repro.serving.Engine``.

Greedy token streams must equal the reference's on the mixed-length
golden of ``test_serving.py`` (reduced gemma-2b, seed 42, prompts of 6
and 14 tokens, prefill_len=16, cache_len=48).  Where the reference's
top-2 logit margin at a step is under the bf16 tolerance, the two
frameworks may legitimately pick different tokens: the test compares
the logits there instead, and stops comparing tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import sample_tokens as j_sample  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import params_from_jax  # noqa: E402
from repro_torch.serving import (Engine, SamplingParams, keep_mask,  # noqa: E402
                                 sample_tokens)

torch.set_num_threads(2)
TOL = 2e-2


@pytest.fixture(scope="module")
def models():
    cfg = j_reduced("gemma-2b")
    jm = j_build(cfg, remat="none")
    jp = jax.jit(jm.init)(jax.random.key(0))
    tm = build_model(reduced_config("gemma-2b"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, "cpu")
    return jm, jp, tm, tp


def _golden_prompts():
    rng = np.random.default_rng(42)
    return [rng.integers(2, 500, n).astype(np.int32) for n in (6, 14)]


def _teacher_forced_logits(prefill, decode, prompt, toks, to_arr):
    """Per-step next-token logits of one request fed ``toks``."""
    S = len(prompt)
    logits, cache = prefill(prompt)
    out = [to_arr(logits)[0]]
    for j, t in enumerate(toks[:-1]):
        logits, cache = decode(t, S + j, cache)
        out.append(to_arr(logits)[0])
    return out


def test_engine_greedy_matches_jax_engine_mixed_lengths(models):
    jm, jp, tm, tp = models
    prompts = _golden_prompts()
    je = JEngine(jm, jp, slots=2, prefill_len=16, cache_len=48)
    want = [r.tokens for r in je.generate(prompts, max_ticks=50)]
    te = Engine(tm, tp, slots=2, prefill_len=16, cache_len=48, device="cpu")
    got = [r.tokens for r in te.generate(prompts, max_ticks=50)]

    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    full = True
    for p, w, g in zip(prompts, want, got):
        j_logits = _teacher_forced_logits(
            lambda pr: jprefill(jp, {"tokens": jnp.asarray(pr)[None]}),
            lambda t, pos, c: jdecode(jp, {
                "tokens": jnp.asarray([[t]], jnp.int32),
                "positions": jnp.asarray([[pos]], jnp.int32),
                "pos_row": jnp.asarray([pos], jnp.int32)}, c),
            p, w, lambda x: np.asarray(x, np.float32))
        t_logits = _teacher_forced_logits(
            lambda pr: tm.prefill(tp, {"tokens": torch.from_numpy(pr)[None]}),
            lambda t, pos, c: tm.decode_step(tp, {
                "tokens": torch.tensor([[t]]),
                "positions": torch.tensor([[pos]], dtype=torch.int32),
                "pos_row": torch.tensor([pos], dtype=torch.int32)}, c),
            p, w, lambda x: x.float().numpy())
        for j, (jl, tl) in enumerate(zip(j_logits, t_logits)):
            top2 = np.sort(jl)[-2:]
            if top2[1] - top2[0] < TOL:
                # a near-tie: compare logits, and stop comparing tokens
                np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)
                full = False
                break
            assert g[j] == w[j], (j, g, w)
        else:
            assert g == w
    if full:
        # identical streams: identical cache rows (positions exact, keys
        # within bf16 rounding)
        np.testing.assert_array_equal(te.cache["pos"].numpy(),
                                      np.asarray(je.cache["pos"]))
        np.testing.assert_allclose(te.cache["k"].float().numpy(),
                                   np.asarray(je.cache["k"], np.float32),
                                   atol=TOL, rtol=TOL)


def _jax_keep(logits, temperature, top_k, top_p):
    """The keep-mask of ``repro.serving.sampling.sample_tokens`` (lines
    61-82 there, which the function does not return), in jnp."""
    V = logits.shape[-1]
    t = jnp.maximum(temperature, 1e-6)[:, None]
    scaled = logits.astype(jnp.float32) / t
    sorted_desc = jnp.flip(jnp.sort(scaled, axis=-1), axis=-1)
    k = jnp.where(top_k > 0, jnp.clip(top_k, 1, V), V).astype(jnp.int32)
    kth = jnp.take_along_axis(sorted_desc, (k - 1)[:, None], axis=-1)
    keep = scaled >= kth
    probs = jax.nn.softmax(sorted_desc, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    keep_sorted = (cum - probs) < top_p[:, None]
    pth = jnp.min(jnp.where(keep_sorted, sorted_desc, jnp.inf), axis=-1)
    return keep & (scaled >= pth[:, None])


def test_keep_mask_matches_jax():
    rng = np.random.default_rng(0)
    B, V = 6, 64
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    temp = np.asarray([0.5, 1.0, 2.0, 1.0, 0.7, 1.3], np.float32)
    top_k = np.asarray([0, 5, 1, 0, 10, 64], np.int32)
    top_p = np.asarray([1.0, 1.0, 1.0, 0.5, 0.9, 0.2], np.float32)
    want = np.asarray(_jax_keep(*(jnp.asarray(x) for x in
                                  (logits, temp, top_k, top_p))))
    _, got = keep_mask(torch.from_numpy(logits), torch.from_numpy(temp),
                       torch.from_numpy(top_k), torch.from_numpy(top_p))
    np.testing.assert_array_equal(got.numpy(), want)
    # every token the reference draws lies inside the port's keep-mask
    seeds, draw = jnp.arange(B, dtype=jnp.uint32), jax.jit(j_sample)
    for step in range(8):
        drawn = np.asarray(draw(
            jnp.asarray(logits), seeds, jnp.full((B,), step, jnp.int32),
            jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p)))
        assert got.numpy()[np.arange(B), drawn].all()


def test_greedy_takes_first_maximal_index():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [2.0, 2.0, 2.0, 2.0]])
    z = np.zeros(2)
    out = sample_tokens(logits, z, z, z, z.astype(np.int64), np.ones(2))
    assert out.tolist() == [1, 0]


def test_seeded_draws_repeat_across_engines_and_slots(models):
    _, _, tm, tp = models
    prompt = _golden_prompts()[1]
    def run(slot_filler, seed=5):
        sp = SamplingParams(temperature=5.0, top_k=50, seed=seed,
                            max_new_tokens=8, eos_token=None)
        e = Engine(tm, tp, slots=2, prefill_len=16, cache_len=48,
                   device="cpu")
        if slot_filler:                        # request lands in slot 1
            e.submit(_golden_prompts()[0], SamplingParams(max_new_tokens=8))
        rid = e.submit(prompt, sp)
        return e.run(max_ticks=50)[rid].tokens

    a, b, c = run(False), run(False), run(True)
    assert a == b == c
    assert run(False, seed=6) != a             # the seed drives the stream


def test_engine_lifecycle_cancel_and_stats(models):
    _, _, tm, tp = models
    e = Engine(tm, tp, slots=1, prefill_len=16, cache_len=48, device="cpu")
    r0 = e.submit(_golden_prompts()[0], SamplingParams(max_new_tokens=4,
                                                       eos_token=None))
    r1 = e.submit(_golden_prompts()[1])
    assert e.cancel(r1) and not e.cancel(r1)
    res = e.run()
    assert res[r0].tokens and len(res[r0].tokens) == 4
    assert res[r1].state.value == "cancelled"
    s = e.stats()
    assert s["finished"] == 1 and s["cancelled"] == 1
    assert s["output_tokens"] == 4
    with pytest.raises(NotImplementedError):
        Engine(tm, tp, device="cpu", plan="auto")
    try:
        assert Engine(tm, tp, device="cpu", kv_dtype="int8").kv_dtype == "int8"
    finally:
        tm.kv_dtype = "bf16"          # the engine pins the model's kv_dtype
    assert Engine(tm, tp, device="cpu", block_size=16).paged
