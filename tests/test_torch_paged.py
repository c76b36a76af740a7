"""The port's paged-KV serving path against the JAX package's.

Kernels: the plain ``flash_decode_paged_ref`` against
``repro.kernels.ref.flash_decode_paged_ref`` and ``repro.kernels.ops``
(default CPU dispatch) on the same seeded numpy inputs: pools read
through shuffled tables with shared blocks and -1 entries, block sizes 4,
8 and 16, window, softcap and GQA.  f32 at 1e-5 (only the summation
order differs), bf16 at 2e-2 (an 8-bit mantissa; p is rounded to bf16
before the PV sum on both sides).

Model and engine: reduced gemma-2b with weights from ``params_from_jax``.
``prefix_prefill`` and the paged ``decode_step`` logits against JAX on a
fresh pool; the paged engine against the JAX paged engine token for token
(greedy) on the mixes of ``test_paged.py``, and against the port's own
contiguous engine under seeded sampling (the port draws its noise from a
``torch.Generator``, so sampled tokens are compared within the port).
``cache_len`` stays at or under 1024: the JAX paged prefill fails on the
CPU for T > 1024 unless T % 1024 == 0.

The reference recycles pool blocks without clearing their positions, so
a request can attend keys of the request that held the block before it
(ROADMAP.md, queue 3).  The port clears them; the recycled-block tests
hold it to the contiguous semantics, not to the reference's leak.

BlockPool and engine lifecycle tests are ported from ``test_paged.py``
onto the port's own classes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import gather_paged_kv as j_gather  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode_paged  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.layers import gather_paged_kv  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import params_from_jax  # noqa: E402
from repro_torch.serving import BlockPool, Engine, SamplingParams  # noqa: E402

torch.set_num_threads(2)
TOL = {"f32": 1e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


# ---------------------------------------------------------------------------
# kernels: the plain paged decode against the reference's
def _paged_case(seed, B, H, K, d, BS, MAXB, lengths, *, unmap_live=False):
    """A pool behind shuffled tables: row b holds positions 0..len-1; row 1
    shares row 0's first block (a prefix hit); entries past a row's length
    are -1, and with ``unmap_live`` one entry inside row 0's live range is
    -1 too.  Unused pool blocks hold random keys at live positions, so a
    kernel that read an unmapped entry as block 0 would see them."""
    rng = np.random.default_rng(seed)
    NB = B * MAXB + 3
    q = rng.standard_normal((B, 1, H, d)).astype(np.float32)
    k_pool = rng.standard_normal((NB, BS, K, d)).astype(np.float32)
    v_pool = rng.standard_normal((NB, BS, K, d)).astype(np.float32)
    kp_pool = rng.integers(0, MAXB * BS, (NB, BS)).astype(np.int32)
    bt = rng.permutation(NB)[:B * MAXB].reshape(B, MAXB).astype(np.int32)
    for b, n in enumerate(lengths):
        bt[b, -(-n // BS):] = -1
        for j in range(-(-n // BS)):
            p = np.arange(j * BS, (j + 1) * BS)
            kp_pool[bt[b, j]] = np.where(p < n, p, -1)
    if B > 1 and lengths[1] > BS and lengths[0] > BS:
        bt[1, 0] = bt[0, 0]
    if unmap_live:
        bt[0, 1] = -1
    q_pos = np.asarray([max(n, 1) for n in lengths], np.int32)
    return q, k_pool, v_pool, q_pos, kp_pool, bt


PAGED_CASES = [  # (H, K, BS, MAXB, lengths, kwargs)
    (8, 1, 4, 12, [48, 30, 0], {}),
    (8, 2, 8, 6, [48, 17, 9], {"unmap_live": True}),
    (8, 2, 16, 4, [64, 33], {"window": 20}),
    (16, 4, 8, 5, [40, 25], {"softcap": 30.0}),
    (4, 4, 16, 3, [48, 48, 1], {}),
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(PAGED_CASES)))
def test_flash_decode_paged_ref_matches_jax(dt, case):
    H, K, BS, MAXB, lens, kw = PAGED_CASES[case]
    kw = dict(kw)
    unmap = kw.pop("unmap_live", False)
    q, kpl, vpl, qp, kpp, bt = _paged_case(case, len(lens), H, K, 32, BS,
                                           MAXB, lens, unmap_live=unmap)
    jq, jk, jv = (jnp.asarray(x).astype(JDT[dt]) for x in (q, kpl, vpl))
    tq, tk, tv = (torch.from_numpy(x).to(TDT[dt]) for x in (q, kpl, vpl))
    jargs = (jq, jk, jv, jnp.asarray(qp)[:, None], jnp.asarray(kpp),
             jnp.asarray(bt))
    targs = (tq, tk, tv, torch.from_numpy(qp), torch.from_numpy(kpp),
             torch.from_numpy(bt))
    want = np.asarray(jref.flash_decode_paged_ref(*jargs, **kw), np.float32)
    got = tref.flash_decode_paged_ref(*targs, **kw)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dt],
                               rtol=0)
    if "window" not in kw:       # the port's dispatch takes no window
        via_ops = ops.flash_decode_paged(*targs, **kw)
        j_ops = np.asarray(jops.flash_decode_paged(*jargs, **kw), np.float32)
        np.testing.assert_allclose(via_ops.float().numpy(), j_ops,
                                   atol=TOL[dt], rtol=0)
        assert torch.equal(via_ops, got)
    # the plain paged decode IS the contiguous one on the gathered view
    k, v, kp = gather_paged_kv(tk, tv, targs[4], targs[5])
    assert torch.equal(got, tref.flash_decode_ref(tq, k, v, targs[3], kp,
                                                  **kw))


def test_gather_masks_unmapped_entries():
    """An unmapped entry reads block 0 for the gather only, and all its
    keys come out at position -1, as the reference's gather."""
    q, kpl, vpl, qp, kpp, bt = _paged_case(3, 2, 8, 2, 32, 8, 6, [48, 17],
                                           unmap_live=True)
    k, v, kp = gather_paged_kv(*(torch.from_numpy(x)
                                 for x in (kpl, vpl, kpp, bt)))
    want = j_gather(*(jnp.asarray(x) for x in (kpl, vpl, kpp, bt)))
    for got, w in zip((k, v, kp), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    assert (kp[0, 8:16] == -1).all() and (kp[1, 24:] == -1).all()


def test_flash_decode_paged_launches_only_on_cuda():
    """The kernel's wrapper refuses CPU tensors; the dispatch sends them
    to the plain version and launches nothing."""
    q, kpl, vpl, qp, kpp, bt = (torch.from_numpy(x) for x in _paged_case(
        4, 2, 8, 1, 64, 16, 2, [20, 5]))
    args = (q.bfloat16(), kpl.bfloat16(), vpl.bfloat16(), qp, kpp, bt)
    flash_decode_paged.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_paged(*args)
    out = ops.flash_decode_paged(*args)
    assert out.shape == (2, 1, 8, 64) and torch.isfinite(out.float()).all()
    assert flash_decode_paged.launches == 0


def test_ctypes_signatures_match_the_cuda_entry_points():
    """The argtypes the wrapper gives ctypes match the extern "C"
    declarations in the source (a mismatch only shows on the card)."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as fd
    src = (_build.CSRC / "flash_decode.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(decls) == set(fd._ARGTYPES)
    for name, (ptrs, ints) in fd._ARGTYPES.items():
        params = [p.strip() for p in decls[name].split(",")]
        kinds = ["ptr" if "*" in p else p.split()[0] for p in params]
        assert kinds == ["ptr"] * ptrs + ["int"] * ints + ["float", "ptr"], \
            (name, kinds)


# ---------------------------------------------------------------------------
# the paged cache write
def test_paged_cache_write_touches_only_valid_targets():
    """Pads, an unmapped table entry and a position past the table are
    not written; every other pool entry, the last block included, stays
    byte-identical, and the written entries equal the reference's."""
    NB, BS, K, hd, MAXB = 6, 4, 2, 8, 3
    rng = np.random.default_rng(0)
    kc = rng.standard_normal((NB, BS, K, hd)).astype(np.float32)
    vc = rng.standard_normal((NB, BS, K, hd)).astype(np.float32)
    pc = rng.integers(0, 50, (NB, BS)).astype(np.int32)
    bt = np.asarray([[2, -1, 4], [0, 3, -1]], np.int32)
    # row 0: 0,1 valid (block 2), 4 unmapped, 9 valid (block 4), -1 pad
    # row 1: 5 valid (block 3), 12 past the table, -1 pads
    pos = np.asarray([[0, 1, 4, 9, -1], [5, 12, -1, -1, -1]], np.int32)
    k_new = rng.standard_normal((2, 5, K, hd)).astype(np.float32)
    v_new = rng.standard_normal((2, 5, K, hd)).astype(np.float32)

    t = [torch.from_numpy(x.copy()) for x in (kc, vc, pc)]
    targets = tlm.paged_targets(torch.from_numpy(pos), torch.from_numpy(bt),
                                NB, BS)
    with pytest.raises(ValueError, match="beyond the pool"):
        tlm.paged_targets(torch.from_numpy(pos),
                          torch.from_numpy(np.where(bt == 4, NB, bt)), NB, BS)
    tlm._paged_cache_write(*t, torch.from_numpy(k_new),
                           torch.from_numpy(v_new), targets)
    want = jlm._paged_cache_write(*(jnp.asarray(x) for x in (
        kc, vc, pc, k_new, v_new, pos, bt)))
    for got, w in zip(t, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    written = {(2, 0), (2, 1), (4, 1), (3, 1)}
    assert {(int(b), int(o)) for b, o in zip(targets[2], targets[3])} \
        == written
    for blk in range(NB):
        for off in range(BS):
            if (blk, off) not in written:
                assert np.array_equal(t[0][blk, off].numpy(), kc[blk, off])
                assert np.array_equal(t[1][blk, off].numpy(), vc[blk, off])
                assert t[2][blk, off] == pc[blk, off]
    # the block a -1 index would wrap to is no target and stays as it was
    assert np.array_equal(t[0][NB - 1].numpy(), kc[NB - 1])
    assert np.array_equal(t[2][NB - 1].numpy(), pc[NB - 1])


# ---------------------------------------------------------------------------
# model: prefix_prefill and the paged decode_step against JAX
@pytest.fixture(scope="module")
def models():
    cfg = j_reduced("gemma-2b")
    jm = j_build(cfg, remat="none")
    jp = jax.jit(jm.init)(jax.random.key(0))
    tm = build_model(reduced_config("gemma-2b"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, "cpu")
    return jm, jp, tm, tp


def _to_np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def test_prefix_prefill_and_paged_decode_match_jax(models):
    """A 13-token prompt prefilled through a fresh pool (table with a hole
    past its blocks), then a second prompt sharing its first block that
    prefills only its suffix, then one paged decode tick for both rows:
    logits against JAX at the bf16 tolerance, pools equal."""
    jm, jp, tm, tp = models
    BS, NB, MAXB = 8, 10, 4
    rng = np.random.default_rng(1)
    prompt = rng.integers(2, 500, 13).astype(np.int32)
    second = np.concatenate([prompt[:8], rng.integers(2, 500, 6)]
                            ).astype(np.int32)
    bt = np.asarray([[3, 7, -1, -1], [3, 1, -1, -1]], np.int32)
    jc = jm.init_cache(2, MAXB * BS, paged=(NB, BS))
    tc = tm.init_cache(2, MAXB * BS, paged=(NB, BS))
    jpre, jdec = jax.jit(jm.prefix_prefill), jax.jit(jm.decode_step)

    def both_prefill(row, toks, start, Sp):
        pos = np.full(Sp, -1, np.int32)
        pos[:len(toks)] = np.arange(start, start + len(toks))
        padded = np.zeros(Sp, np.int32)
        padded[:len(toks)] = toks
        jb = {"tokens": jnp.asarray(padded)[None],
              "positions": jnp.asarray(pos)[None],
              "length": jnp.asarray([len(toks)], jnp.int32),
              "block_tables": jnp.asarray(bt[row:row + 1])}
        tb = {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}
        tb["tokens"] = tb["tokens"].long()
        return jpre(jp, jb, jc), tm.prefix_prefill(tp, tb, tc)

    (jl, jc), (tl, tc) = both_prefill(0, prompt, 0, 16)       # padded
    np.testing.assert_allclose(_to_np(tl), _to_np(jl), atol=TOL["bf16"],
                               rtol=TOL["bf16"])
    (jl, jc), (tl, tc) = both_prefill(1, second[8:], 8, 6)    # suffix only
    np.testing.assert_allclose(_to_np(tl), _to_np(jl), atol=TOL["bf16"],
                               rtol=TOL["bf16"])
    toks = np.asarray([[11], [12]], np.int32)
    pos = np.asarray([13, 14], np.int32)
    jb = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)[:, None],
          "pos_row": jnp.asarray(pos), "block_tables": jnp.asarray(bt)}
    jl, jc = jdec(jp, jb, jc)
    tb = {"tokens": torch.from_numpy(toks).long(),
          "positions": torch.from_numpy(pos)[:, None],
          "pos_row": torch.from_numpy(pos), "block_tables":
              torch.from_numpy(bt)}
    tl, tc = tm.decode_step(tp, tb, tc)
    np.testing.assert_allclose(_to_np(tl), _to_np(jl), atol=TOL["bf16"],
                               rtol=TOL["bf16"])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_allclose(_to_np(tc["k"]), _to_np(jc["k"]),
                               atol=TOL["bf16"], rtol=TOL["bf16"])


# ---------------------------------------------------------------------------
# engine: paged against JAX and against the port's contiguous engine
def _prompt(rng, n, vocab=500):
    return rng.integers(2, vocab, n).astype(np.int32)


def _mix(name):
    if name == "mixed":        # test_paged.py: paged == contiguous tokens
        rng = np.random.default_rng(42)
        return ([_prompt(rng, n) for n in (5, 23, 12, 7, 31, 4)],
                dict(slots=3, prefill_len=32, cache_len=48, block_size=16))
    rng = np.random.default_rng(3)     # test_paged.py: shared prefix
    sys_prompt = _prompt(rng, 16)
    return ([np.concatenate([sys_prompt, _prompt(rng, n)])
             for n in (5, 9, 3, 7)],
            dict(slots=2, prefill_len=32, cache_len=48, block_size=8))


@pytest.mark.parametrize("mix", ["mixed", "shared_prefix"])
def test_paged_engine_greedy_matches_jax_paged_engine(models, mix):
    jm, jp, tm, tp = models
    prompts, kw = _mix(mix)
    sp = SamplingParams(max_new_tokens=6)
    want = [r.tokens for r in JEngine(jm, jp, **kw).generate(
        prompts, sp, max_ticks=120)]
    e = Engine(tm, tp, device="cpu", **kw)
    got = [r.tokens for r in e.generate(prompts, sp, max_ticks=120)]
    assert got == want
    assert e.pool.free_blocks + e.pool.cached_blocks == e.pool.num_blocks
    if mix == "shared_prefix":
        st = e.pool.prefix_stats()
        assert st["hits"] == 3 and st["hit_tokens"] == 3 * 16
        assert all(r.metrics.prefilled_tokens == r.metrics.prompt_tokens - 16
                   for r in e.finished.values() if r.rid > 0)


@pytest.mark.parametrize("mix", ["mixed", "shared_prefix"])
def test_paged_engine_sampled_matches_contiguous_engine(models, mix):
    _, _, tm, tp = models
    prompts, kw = _mix(mix)
    sp = SamplingParams(temperature=0.8, top_k=20, seed=7, max_new_tokens=6)
    paged = Engine(tm, tp, device="cpu", **kw)
    kw.pop("block_size")
    contig = Engine(tm, tp, device="cpu", **kw)
    a = [r.tokens for r in contig.generate(prompts, sp, max_ticks=120)]
    b = [r.tokens for r in paged.generate(prompts, sp, max_ticks=120)]
    assert a == b


def _logits_of(model, fn_names=("prefix_prefill", "decode_step")):
    """Record every logits row the engine's model calls return."""
    seen = []
    for name in fn_names:
        fn = getattr(model, name)

        def wrapped(*a, _fn=fn, **kw):
            logits, cache = _fn(*a, **kw)
            seen.append(logits[0].clone())
            return logits, cache
        setattr(model, name, wrapped)
    return seen


def _unwrap(model, fn_names=("prefix_prefill", "decode_step")):
    for name in fn_names:
        delattr(model, name)


@pytest.mark.parametrize("clear", [True, False])
def test_recycled_block_shows_no_stale_keys(models, monkeypatch, clear):
    """A (20 tokens, 2 new), then B (20 tokens) on a 1-slot engine without
    prefix reuse, block_size 8: B gets A's block 0 at table index 2.  With
    the fresh-block clear, B's logits are bit-equal to B alone on a fresh
    engine and B's blocks hold only B's positions; without it (the
    reference's behaviour) B sees A's positions 5..7 and its logits move."""
    _, _, tm, tp = models
    rng = np.random.default_rng(11)
    a, b = _prompt(rng, 20), _prompt(rng, 20)
    kw = dict(slots=1, prefill_len=32, cache_len=48, block_size=8,
              prefix_cache=False, device="cpu")
    sp = SamplingParams(max_new_tokens=3, eos_token=None)
    if not clear:
        monkeypatch.setattr(Engine, "_clear_fresh_blocks", lambda self: None)
    seen = _logits_of(tm)
    try:
        alone = Engine(tm, tp, **kw)
        alone.generate([b], sp)
        n = len(seen)
        e = Engine(tm, tp, **kw)
        e.generate([a], SamplingParams(max_new_tokens=2, eos_token=None))
        del seen[n:]
        rid = e.submit(b, sp)
        e.step()                          # B joins and decodes one token
        bt = e.pool.block_tables[0].copy()
        pos = e.cache["pos"][:, torch.from_numpy(bt[bt >= 0]).long()]
        e.run()
    finally:
        _unwrap(tm)
    after, fresh = seen[n:], seen[:n]
    assert bt[2] == 0                     # A's first block, recycled
    assert e.finished[rid].tokens == alone.finished[0].tokens or not clear
    # B wrote positions 16..19 at offsets 0..3 of that block in its
    # prefill and 20 at offset 4 in its first tick; 5..7 are unwritten
    assert (pos[:, 2, :5] == torch.arange(16, 21, dtype=torch.int32)).all()
    stale = pos[:, 2, 5:]
    if clear:
        assert (stale == -1).all()
        assert ((pos == -1) | (pos < 21)).all()
        assert all(torch.equal(x, y) for x, y in zip(after, fresh))
    else:
        assert (stale == torch.arange(5, 8, dtype=torch.int32)).all()
        assert not all(torch.equal(x, y) for x, y in zip(after, fresh))


# ---------------------------------------------------------------------------
# BlockPool unit behaviour (ported from test_paged.py)
def test_blockpool_mapping_and_reservation():
    pool = BlockPool(2, num_blocks=8, block_size=4, max_blocks_per_slot=4)
    rng = np.random.default_rng(0)
    p = _prompt(rng, 6)                     # 2 blocks of prompt
    assert pool.acquire_blocks(0, rid=1, prompt=p, max_new=5) == 0
    assert pool.allocated_blocks(0) == 2
    # ceil((6+5)/4) = 3 blocks in all -> 1 growth block reserved, unmapped
    assert pool._total_reserved == 1
    assert pool.available_blocks() == 8 - 2 - 1
    pool.lengths[0] = 8                     # decode reaches the boundary
    assert pool.ensure_block(0)
    assert pool.allocated_blocks(0) == 3 and pool._total_reserved == 0
    pool.lengths[0] = 16                    # the table's cap
    assert not pool.ensure_block(0)
    assert sorted(pool.drain_fresh()) == sorted(
        int(x) for x in pool.block_tables[0] if x >= 0)
    assert pool.drain_fresh() == []
    pool.release(0)
    assert pool.free_blocks == 8 and pool.num_active == 0


def test_blockpool_prefix_sharing_refcounts_and_cow():
    BS = 4
    pool = BlockPool(3, num_blocks=12, block_size=BS, max_blocks_per_slot=4)
    rng = np.random.default_rng(1)
    prompt = _prompt(rng, 10)               # 2 full blocks + partial tail
    pool.acquire_blocks(0, rid=1, prompt=prompt, max_new=1)
    pool.register_prefix(0, prompt)
    assert len(pool._index) == 2            # only FULL blocks published
    tail_blk = int(pool.block_tables[0, 2])
    assert tail_blk >= 0 and tail_blk not in pool._block_hash
    pool.drain_fresh()

    assert pool.acquire_blocks(1, rid=2, prompt=prompt, max_new=1) == 2 * BS
    assert pool.prefix_hits == 1 and pool.prefix_hit_tokens == 2 * BS
    for j in range(2):
        shared = int(pool.block_tables[0, j])
        assert int(pool.block_tables[1, j]) == shared
        assert pool.refcount[shared] == 2
    assert int(pool.block_tables[1, 2]) != tail_blk   # private tails
    # a shared block is not fresh: its positions must be kept
    assert pool.drain_fresh() == [int(pool.block_tables[1, 2])]

    p2 = prompt.copy()
    p2[BS] += 1                             # differs in block 1
    assert pool.probe_prefix(p2) == 1
    assert pool.probe_prefix(prompt[:2 * BS]) == 1     # capped
    pool.release(0)
    for j in range(2):
        assert pool.refcount[int(pool.block_tables[1, j])] == 1
    pool.release(1)
    assert pool.cached_blocks == 2 and pool.free_blocks == 12 - 2
    assert pool.probe_prefix(prompt) == 2


def test_blockpool_lru_reclaim_and_exhaustion():
    BS = 4
    pool = BlockPool(1, num_blocks=4, block_size=BS, max_blocks_per_slot=4)
    rng = np.random.default_rng(2)
    a, b = _prompt(rng, 8), _prompt(rng, 8)
    for rid, p in enumerate((a, b)):
        pool.acquire_blocks(0, rid=rid, prompt=p, max_new=0)
        pool.register_prefix(0, p)
        pool.release(0)
    assert pool.free_blocks == 0 and pool.cached_blocks == 4
    pool.drain_fresh()
    pool.acquire_blocks(0, rid=3, prompt=_prompt(rng, 8), max_new=0)
    assert pool.probe_prefix(a) == 0        # a was evicted (LRU) ...
    assert pool.probe_prefix(b) == 1        # ... b survived (cap at 1)
    assert len(pool.drain_fresh()) == 2     # reclaimed blocks are fresh
    with pytest.raises(RuntimeError, match="exhausted"):
        for _ in range(5):
            pool._alloc()


@pytest.mark.parametrize("prompt_len,max_new,fits", [
    (8, 8, True), (4, 1, False)])
def test_blockpool_admission_accounting(prompt_len, max_new, fits):
    """A pool of 4 blocks: 8 + 8 tokens need all 4; once a request holds 2
    and reserves 2, a 1-block request does not fit until it is released."""
    pool = BlockPool(4, num_blocks=4, block_size=4, max_blocks_per_slot=4)
    rng = np.random.default_rng(3)
    p = _prompt(rng, prompt_len)
    if fits:
        assert pool.can_admit(p, max_new=max_new)
        return
    pool.acquire_blocks(0, rid=1, prompt=_prompt(rng, 8), max_new=8)
    assert pool.free_blocks == 2
    assert not pool.can_admit(p, max_new=max_new)
    pool.release(0)
    assert pool.can_admit(p, max_new=max_new)


def test_blockpool_leak_regression_1000_cycles():
    """1000 acquire/release cycles over varied prompts (some shared, some
    evicting) conserve every block: free + cached == num_blocks and no
    refcount survives."""
    BS = 4
    pool = BlockPool(4, num_blocks=16, block_size=BS, max_blocks_per_slot=4)
    rng = np.random.default_rng(4)
    prompts = [_prompt(rng, int(rng.integers(1, 13))) for _ in range(17)]
    for i in range(1000):
        slot = int(rng.integers(4))
        if pool.owner[slot] is not None:
            pool.release(slot)
        p = prompts[int(rng.integers(len(prompts)))]
        if not pool.can_admit(p, max_new=3):
            continue
        pool.acquire_blocks(slot, rid=i, prompt=p, max_new=3)
        if rng.random() < 0.5:
            pool.register_prefix(slot, p)
        if rng.random() < 0.5:
            pool.lengths[slot] = min(len(p) + 3, 16)
            pool.ensure_block(slot)
    for slot in range(4):
        if pool.owner[slot] is not None:
            pool.release(slot)
    assert pool.free_blocks + pool.cached_blocks == 16
    assert pool._total_reserved == 0
    live = {blk for blk, _ in pool._index.values()}
    for blk in range(16):
        assert pool.refcount[blk] == 0
        assert (blk in live) == (blk in pool._block_hash)


# ---------------------------------------------------------------------------
# engine lifecycle (ported from test_paged.py)
def test_engine_admission_blocks_on_blocks_not_slots(models):
    _, _, tm, tp = models
    rng = np.random.default_rng(5)
    e = Engine(tm, tp, slots=4, prefill_len=16, cache_len=32, block_size=16,
               num_blocks=2, prefix_cache=False, device="cpu")
    for _ in range(3):     # ceil((12 + 8) / 16) = 2 blocks: one fits
        e.submit(_prompt(rng, 12), SamplingParams(max_new_tokens=8))
    e.step()
    assert e.pool.num_active == 1 and len(e.queue) == 2
    done = e.run(max_ticks=120)
    assert len(done) == 3 and all(len(r.tokens) == 8 for r in done.values())


def test_engine_cancel_returns_blocks_leak_regression(models):
    _, _, tm, tp = models
    rng = np.random.default_rng(7)
    e = Engine(tm, tp, slots=2, prefill_len=16, cache_len=32, block_size=8,
               device="cpu")
    sys_prompt = _prompt(rng, 8)            # 1 shareable block
    for i in range(12):
        p = np.concatenate([sys_prompt, _prompt(rng, 1 + i % 6)])
        ra = e.submit(p, SamplingParams(max_new_tokens=8))
        rb = e.submit(_prompt(rng, 4), SamplingParams(max_new_tokens=8))
        if i % 3 == 0:
            e.cancel(rb)                    # still queued
            e.step()
            e.cancel(ra)                    # mid-decode
        else:
            e.step()
            e.cancel(ra)
            e.cancel(rb)
        e.run(max_ticks=30)
        assert e.pool.num_active == 0
        assert e.pool.free_blocks + e.pool.cached_blocks == e.num_blocks
        assert e.pool._total_reserved == 0
    assert (e.pool.refcount == 0).all()
    cancelled = [r for r in e.finished.values()
                 if r.done_reason == "cancelled" and r.tokens]
    assert cancelled
    assert all(r.metrics.kv_allocated_bytes >= r.metrics.kv_used_bytes > 0
               for r in cancelled)


def test_engine_paged_capacity_retires_as_length(models):
    _, _, tm, tp = models
    rng = np.random.default_rng(9)
    e = Engine(tm, tp, slots=1, prefill_len=32, cache_len=32, block_size=16,
               device="cpu")
    res = e.generate([_prompt(rng, 30)], SamplingParams(max_new_tokens=50),
                     max_ticks=60)[0]
    assert res.done_reason == "length"
    assert len(res.tokens) == 32 - 30 + 1   # tok0 + decode to the cap
    assert e.pool.free_blocks + e.pool.cached_blocks == e.pool.num_blocks


def test_engine_paged_kv_accounting_and_stats(models):
    _, _, tm, tp = models
    cfg = tm.cfg
    rng = np.random.default_rng(11)
    e = Engine(tm, tp, slots=2, prefill_len=16, cache_len=64, block_size=16,
               device="cpu")
    res = e.generate([_prompt(rng, 5), _prompt(rng, 12)],
                     SamplingParams(max_new_tokens=3), max_ticks=40)
    bpt = e.kv_bytes_per_token
    assert bpt == cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 2
    for r in res:
        m = r.metrics
        used = (m.prompt_tokens + len(r.tokens) - 1) * bpt   # last not cached
        assert m.kv_used_bytes == used
        assert m.kv_allocated_bytes % (e.block_size * bpt) == 0
        assert used <= m.kv_allocated_bytes < used + e.block_size * bpt
        assert m.prefilled_tokens == m.prompt_tokens
    s = e.stats()
    assert s["block_size"] == 16 and s["num_blocks"] == 8
    assert s["free_blocks"] == 8
    assert 0 < s["kv_utilization"] <= 1.0
    assert s["kv_used_mb"] <= s["kv_allocated_mb"]
    assert s["prefix"]["misses"] == 2
    assert "prefix_cached_tokens" not in s   # no hit, no sum


def test_engine_paged_rejects_quantized_kv(models):
    _, _, tm, tp = models
    with pytest.raises(NotImplementedError, match="slice 4"):
        Engine(tm, tp, block_size=16, kv_dtype="int8", device="cpu")
