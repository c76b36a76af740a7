"""The port's dense decoder against ``repro.models.lm.DecoderModel`` on
the same parameters (bridged with ``params_from_jax``) and the same
seeded tokens, on the reduced gemma-2b (MQA, tied, sqrt(D) embedding
scale), qwen3-32b (GQA, qk-norm, untied) and gpt3-175b (MHA, GELU)
configs.  Prompts of 12 tokens take the dense attention path, 3072
tokens the flash path (keys past 2048), on both sides.  Tolerance: atol
= rtol = 2e-2 in bf16, as the reference's own decode-vs-prefill test.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.models.lm import DecoderModel as JModel  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import init_params, params_from_jax  # noqa: E402

torch.set_num_threads(2)
ARCHS = ["gemma-2b", "qwen3-32b", "gpt3-175b"]
TOL = dict(atol=2e-2, rtol=2e-2)
_CACHE = {}


def _pair(arch):
    """(jax model, jax params, jitted prefill, jitted decode, port model,
    port params), built once per arch."""
    if arch not in _CACHE:
        jm = JModel(j_reduced(arch))
        jp = jax.jit(jm.init)(jax.random.key(0))
        tm = build_model(reduced_config(arch), device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, "cpu")
        _CACHE[arch] = (jm, jp, jax.jit(jm.prefill), jax.jit(jm.decode_step),
                        tm, tp)
    return _CACHE[arch]


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _tokens(B, S, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _padded(toks, Sp):
    """Right-pad to Sp as the engine's bucketed prefill does."""
    B, S = toks.shape
    tp = np.zeros((B, Sp), np.int32)
    tp[:, :S] = toks
    pos = np.where(np.arange(Sp) < S, np.arange(Sp), -1).astype(np.int32)
    return tp, np.broadcast_to(pos, (B, Sp)).copy()


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_round_trips_every_leaf(arch):
    jm, jp, *_, tm, tp = _pair(arch)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    n = 0
    for path, leaf in jleaves:
        node = tp
        for key in path:
            node = node[key.key]
        want = np.asarray(leaf).astype(jnp.bfloat16).astype(np.float32)
        np.testing.assert_array_equal(node.float().numpy(), want)
        assert node.dtype == torch.bfloat16
        n += 1
    assert n == len(jax.tree.leaves(tp)) == len(jleaves)
    f32 = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, "cpu",
                          dtype=torch.float32)
    for (path, leaf), got in zip(jleaves, jax.tree.leaves(f32)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))


def test_params_from_jax_rejects_mismatched_tree():
    jm, jp, *_, tm, tp = _pair("gemma-2b")
    tree = jax.tree.map(np.asarray, jp)
    del tree["layers"]["attn"]["wq"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tree, tm.cfg, "cpu")
    tree = jax.tree.map(np.asarray, jp)
    tree["final_norm"]["scale"] = tree["final_norm"]["scale"][:-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, tm.cfg, "cpu")


def test_seeded_init_distributions():
    cfg = reduced_config("qwen3-32b")
    a, b = init_params(cfg, 7, "cpu"), init_params(cfg, 7, "cpu")
    c = init_params(cfg, 8, "cpu")
    for x, y, z in zip(jax.tree.leaves(a), jax.tree.leaves(b),
                       jax.tree.leaves(c)):
        assert x.dtype == torch.bfloat16
        assert torch.equal(x, y)
    wq = a["layers"]["attn"]["wq"].float()
    L, D, H, _ = wq.shape
    # truncated normal on [-2, 2]: std 0.8796 x 1/sqrt(fan_in of the
    # stacked shape), as the reference's _materialize
    std = 0.8796 / math.sqrt(L * D * H)
    assert abs(wq.std().item() / std - 1) < 0.1
    assert wq.abs().max().item() <= 2 * std / 0.8796 * 1.01
    assert torch.equal(a["layers"]["ln1"]["scale"],
                       torch.ones_like(a["layers"]["ln1"]["scale"]))
    assert abs(a["embed"]["embedding"].float().std().item() - 1) < 0.05
    assert not torch.equal(a["embed"]["embedding"], c["embed"]["embedding"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["S12", "bucket", "S3072"])
def test_prefill_matches_jax(arch, case):
    jm, jp, jprefill, _, tm, tp = _pair(arch)
    B, S = (1, 3072) if case == "S3072" else (2, 12)
    toks = _tokens(B, S, tm.cfg.vocab_size)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if case == "bucket":
        tpad, pos = _padded(toks, 16)
        length = np.full((B,), S, np.int32)
        jb = {"tokens": jnp.asarray(tpad), "positions": jnp.asarray(pos),
              "length": jnp.asarray(length)}
        tb = {"tokens": torch.from_numpy(tpad),
              "positions": torch.from_numpy(pos),
              "length": torch.from_numpy(length)}
    j_logits, j_cache = jprefill(jp, jb)
    t_logits, t_cache = tm.prefill(tp, tb)
    np.testing.assert_allclose(_np(t_logits), _np(j_logits), **TOL)
    np.testing.assert_array_equal(t_cache["pos"].numpy(),
                                  np.asarray(j_cache["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(t_cache[key]), _np(j_cache[key]),
                                   **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax_and_prefill(arch):
    """One decode_step after a bucketed prefill matches the reference's
    decode_step and the port's own prefill over the S + 1 tokens."""
    jm, jp, jprefill, jdecode, tm, tp = _pair(arch)
    B, S, Sp = 2, 12, 16
    toks = _tokens(B, S + 1, tm.cfg.vocab_size, seed=3)
    tpad, pos = _padded(toks[:, :S], Sp)
    length = np.full((B,), S, np.int32)
    _, j_cache = jprefill(jp, {"tokens": jnp.asarray(tpad),
                               "positions": jnp.asarray(pos),
                               "length": jnp.asarray(length)})
    _, t_cache = tm.prefill(tp, {"tokens": torch.from_numpy(tpad),
                                 "positions": torch.from_numpy(pos),
                                 "length": torch.from_numpy(length)})
    nxt = toks[:, S:]
    prow = np.full((B,), S, np.int32)
    j_logits, j_cache = jdecode(jp, {"tokens": jnp.asarray(nxt),
                                     "positions": jnp.asarray(prow[:, None]),
                                     "pos_row": jnp.asarray(prow)}, j_cache)
    t_logits, t_cache = tm.decode_step(
        tp, {"tokens": torch.from_numpy(nxt),
             "positions": torch.from_numpy(prow[:, None].copy()),
             "pos_row": torch.from_numpy(prow)}, t_cache)
    np.testing.assert_allclose(_np(t_logits), _np(j_logits), **TOL)
    np.testing.assert_array_equal(t_cache["pos"].numpy(),
                                  np.asarray(j_cache["pos"]))
    np.testing.assert_allclose(_np(t_cache["k"]), _np(j_cache["k"]), **TOL)
    full, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(t_logits), _np(full), **TOL)
