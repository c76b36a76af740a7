"""Dense decoder-only LM with global attention (``Family.DENSE``).

Port of the dense path of ``repro.models.lm.DecoderModel``: embed ->
L x [RMSNorm -> attention with RoPE -> RMSNorm -> MLP] -> final norm ->
unembed.  The reference scans over the stacked layer axis; here a Python
loop walks it (``params["layers"][...][l]`` are views).

Entry points, with the reference's functional signatures:
  * ``prefill(params, batch)``            -> (last-token logits (B, V), cache)
  * ``decode_step(params, batch, cache)`` -> (logits (B, V), cache)
  * ``prefix_prefill(params, batch, cache)`` -> (last-token logits, cache),
    a prompt suffix prefilled through a paged cache's block pool

``decode_step`` takes a contiguous cache, or a paged one (``init_cache(...,
paged=(num_blocks, block_size))``) with ``batch["block_tables"]``.  With
``kv_dtype`` "int8" or "fp8" the contiguous cache stores K/V quantized
with f32 scales per (token, kv head): prefill computes in bf16 and
quantizes what it stores, and each decode step quantizes the new K/V as
it writes them (``kernels.quant``).  Unlike
the reference, ``decode_step`` and ``prefix_prefill`` write the new K/V
into the cache tensors IN PLACE and return the same dict: the cache is
the largest tensor of a serving run and a copy per tick would double its
traffic.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.config import Family, ModelConfig
from repro_torch.kernels import quant as Q
from repro_torch.models import layers as L
from repro_torch.models.param import init_params


def _layer(tree: Dict, l: int) -> Dict:
    return {k: (_layer(v, l) if isinstance(v, dict) else v[l])
            for k, v in tree.items()}


def _cache_write(kc, vc, pc, k_new, v_new, pos):
    """Write the new K/V of every row at its own position, in place.

    kc, vc: (B, T, K, hd); pc: (B, T); k_new, v_new: (B, 1, K, hd); pos:
    an int (all rows at one column) or (B,) per-row positions (slot-pool
    serving, where rows at different lengths land in different columns).
    Positions wrap modulo T, as in the reference."""
    _write_slots(((kc, k_new), (vc, v_new)), pc, pos)


def _cache_write_quant(kc, vc, pc, ksc, vsc, k_new, v_new, pos):
    """``_cache_write`` over a quantized cache: the new K/V are quantized
    per (token, head) vector (one ``quantize_kv`` over both) and written
    with their scales, in place.  kc, vc: (B, T, K, hd) int8 or fp8; ksc,
    vsc: (B, T, K) f32; an appended row never requantizes the rest of the
    cache."""
    q, s = Q.quantize_kv(torch.stack((k_new, v_new)), Q.kv_dtype_of(kc.dtype))
    _write_slots(((kc, q[0]), (vc, q[1]), (ksc, s[0]), (vsc, s[1])), pc, pos)


def _write_slots(pairs, pc, pos):
    """Write each ``(cache (B, T, ...), new (B, 1, ...))`` pair and the
    positions at every row's slot ``pos % T``, in place."""
    B, T = pc.shape
    if isinstance(pos, int):
        slot = pos % T
        for c, new in pairs:
            c[:, slot] = new[:, 0]
        pc[:, slot] = pos
        return
    rows = torch.arange(B, device=pc.device)
    slot = torch.remainder(pos.long(), T)
    for c, new in pairs:
        c[rows, slot] = new[:, 0]
    pc[rows, slot] = pos.to(pc.dtype)


def paged_targets(pos, bt, num_blocks: int, block_size: int):
    """Where tokens at ``pos`` are written through block tables.

    pos: (B,) or (B, S) absolute positions with -1 = pad; bt: (B, MAXB)
    with -1 = unmapped and every other entry below ``num_blocks`` (checked
    here, once for the whole call: the paged decode kernel reads through
    the same table unchecked).  Token (b, s) goes to offset pos %
    block_size of pool block bt[b, pos // block_size].  Only valid targets
    are kept: a pad, a position past the table and an unmapped entry are
    left out (a boolean mask, one device sync), since a -1 used as an
    index would write into the last pool block, which may hold another
    request's K/V.  Returns index tensors (rows, cols, blocks, offsets)
    and the positions, one entry per valid token."""
    over = (bt >= num_blocks).any()
    p = pos.long()
    if p.dim() == 1:
        p = p[:, None]
    maxb = bt.shape[1]
    j = torch.div(p, block_size, rounding_mode="floor")
    blk = torch.gather(bt.long(), 1, j.clamp(0, maxb - 1))   # read only
    ok = (p >= 0) & (j < maxb) & (blk >= 0)
    rows, cols = ok.nonzero(as_tuple=True)
    if bool(over):
        raise ValueError(f"block table entry beyond the pool of {num_blocks} "
                         "blocks")
    p = p[rows, cols]
    return rows, cols, blk[rows, cols], p % block_size, p


def _paged_cache_write(kc, vc, pc, k_new, v_new, targets):
    """Write new K/V into the global block pool, in place, at the valid
    targets of ``paged_targets``; every other pool entry is untouched.

    kc, vc: (NB, BS, K, hd); pc: (NB, BS); k_new, v_new: (B, S, K, hd)."""
    rows, cols, blk, off, p = targets
    kc[blk, off] = k_new[rows, cols]
    vc[blk, off] = v_new[rows, cols]
    pc[blk, off] = p.to(pc.dtype)


class DecoderModel:
    """Config + parameter init + the serving entry points, on ``device``
    (the card unless the caller asks for ``"cpu"``).  ``kv_dtype`` is the
    cache's storage: "bf16", or "int8" / "fp8" quantized."""

    def __init__(self, cfg: ModelConfig, *, kv_dtype: str = "bf16",
                 device="cuda"):
        if cfg.family != Family.DENSE or cfg.sliding_window is not None \
                or cfg.local_global_pattern or cfg.m_rope_sections:
            raise NotImplementedError(
                f"{cfg.name}: the port runs dense global-attention decoders; "
                "windowed, MoE, SSM, hybrid and VLM models are queued in "
                "ROADMAP.md")
        if kv_dtype not in Q.KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r} not in {Q.KV_DTYPES}")
        self.cfg = cfg
        self.kv_dtype = kv_dtype
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16          # compute and storage dtype

    def init(self, seed: int = 0) -> Dict:
        return init_params(self.cfg, seed, self.device, self.dtype)

    def init_cache(self, batch_size: int, cache_len: int,
                   paged: Optional[Tuple[int, int]] = None,
                   kv_dtype: Optional[str] = None) -> Dict:
        """Contiguous cache: k, v (L, B, T, K, hd) in the compute dtype;
        pos (L, B, T) int32 with -1 = empty.  With ``paged = (num_blocks,
        block_size)`` the cache is a global block pool instead: k, v
        (L, NB, BS, K, hd) and pos (L, NB, BS), addressed through block
        tables.  A quantized ``kv_dtype`` (the model's by default) stores
        k, v in int8 or fp8 and adds f32 k_scale, v_scale (L, B, T, K)."""
        cfg = self.cfg
        kv_dtype = self.kv_dtype if kv_dtype is None else kv_dtype
        quant = kv_dtype in Q.QUANTIZED_KV_DTYPES
        if quant and paged is not None:
            raise NotImplementedError(
                "a paged quantized cache is not ported yet: it is slice 4 "
                "(ROADMAP.md queue 1, item 7)")
        store = Q.kv_cache_dtype(kv_dtype)
        rows = (batch_size, cache_len) if paged is None else tuple(paged)
        kv = (cfg.num_layers, *rows, cfg.num_kv_heads, cfg.head_dim)
        cache = {"len": 0,
                 "k": torch.zeros(kv, dtype=store, device=self.device),
                 "v": torch.zeros(kv, dtype=store, device=self.device),
                 "pos": torch.full(kv[:3], -1, dtype=torch.int32,
                                   device=self.device)}
        if quant:
            for key in ("k_scale", "v_scale"):
                cache[key] = torch.zeros(kv[:4], dtype=torch.float32,
                                         device=self.device)
        return cache

    def _block(self, p, h, positions, cache_kv=None, target=None):
        """One layer.  With ``cache_kv = (k, v, pos)`` (decode) the new K/V
        are projected from the same normed input and written at ``target``
        (``pos_row``) before attention reads the cache; with ``(k, v, pos,
        k_scale, v_scale)`` they are quantized as they are written; with
        ``cache_kv = (k_pool, v_pool, pos_pool, block_tables)`` they are
        written at ``target`` (``paged_targets``) in the pool."""
        cfg = self.cfg
        x = L.rms_norm(h, p["ln1"]["scale"], cfg.rms_eps)
        if cache_kv is not None:
            k_new, v_new = L.project_kv(p["attn"], x, cfg, positions)
            if len(cache_kv) == 4:
                _paged_cache_write(*cache_kv[:3], k_new, v_new, target)
            elif len(cache_kv) == 5:
                _cache_write_quant(*cache_kv, k_new, v_new, target)
            else:
                _cache_write(*cache_kv, k_new, v_new, target)
        a, kv = L.attention(p["attn"], x, cfg, positions=positions,
                            cache_kv=cache_kv)
        h = h + a
        h = h + L.mlp(p["mlp"], L.rms_norm(h, p["ln2"]["scale"], cfg.rms_eps),
                      cfg)
        return h, kv

    @torch.no_grad()
    def prefill(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence forward that also builds the cache.

        batch: tokens (B, S); optional positions (B, S) int32 with -1 for
        right-padding, and length (B,) real tokens per row (logits are
        read at each row's last real token).  Returns (logits (B, V),
        cache with k, v (L, B, S, K, hd) and pos (L, B, S)).  With a
        quantized ``kv_dtype`` the layers compute in bf16 as without, and
        the cache holds their K/V quantized, with k_scale, v_scale
        (L, B, S, K)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device).expand(B, S)
        positions = positions.to(torch.int32).contiguous()
        x = L.embed(params["embed"], tokens, cfg)
        ks, vs = [], []
        for l in range(cfg.num_layers):
            x, (k, v) = self._block(_layer(params["layers"], l), x, positions)
            ks.append(k)
            vs.append(v)
        cache = {"len": S, "k": torch.stack(ks), "v": torch.stack(vs),
                 "pos": positions.expand(cfg.num_layers, B, S).contiguous()}
        if self.kv_dtype in Q.QUANTIZED_KV_DTYPES:
            cache["k"], cache["k_scale"] = Q.quantize_kv(cache["k"],
                                                         self.kv_dtype)
            cache["v"], cache["v_scale"] = Q.quantize_kv(cache["v"],
                                                         self.kv_dtype)
        return self._last_logits(params, x, batch.get("length")), cache

    def _last_logits(self, params, x, length=None):
        """Final norm and logits (B, V) of each row's last real token
        (``length`` (B,) real tokens; the last column without it)."""
        cfg = self.cfg
        x = L.rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
        if length is None:
            last = x[:, -1:]
        else:
            idx = torch.clamp(length.long() - 1, 0, x.shape[1] - 1)
            last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
        return L.unembed(params["embed"], last, cfg)[:, 0]

    @torch.no_grad()
    def prefix_prefill(self, params, batch, cache) -> Tuple[torch.Tensor,
                                                             Dict]:
        """Multi-token prefill THROUGH a paged cache's block pool.

        Only a prompt's suffix is forwarded: its leading blocks may already
        hold K/V (prefix-cache hits).  Per layer the suffix K/V are written
        into the row's blocks first, then attention reads the gathered
        pool, so each suffix token sees the cached prefix and its own
        predecessors as a full prefill would.

        batch: tokens (B, S) right-padded suffix; positions (B, S) absolute
        positions with -1 pads; block_tables (B, MAXB); length (B,) real
        suffix tokens.  Writes the pool in place; returns (logits of each
        row's last real token (B, V), cache)."""
        cfg = self.cfg
        bt = batch["block_tables"].to(torch.int32).contiguous()
        positions = batch["positions"].to(torch.int32).contiguous()
        targets = paged_targets(positions, bt, *cache["pos"].shape[1:])
        x = L.embed(params["embed"], batch["tokens"], cfg)
        for l in range(cfg.num_layers):
            x, _ = self._block(
                _layer(params["layers"], l), x, positions,
                cache_kv=(cache["k"][l], cache["v"][l], cache["pos"][l], bt),
                target=targets)
        cache["len"] = max(int(cache["len"]), int(positions.max()) + 1)
        return self._last_logits(params, x, batch["length"]), cache

    @torch.no_grad()
    def decode_step(self, params, batch, cache) -> Tuple[torch.Tensor, Dict]:
        """One token per row.  batch: tokens (B, 1); optional positions
        (B, 1) and pos_row (B,) per-row write positions (slot-pool
        serving); without them every row advances at ``cache["len"]``.
        With block_tables (B, MAXB) the cache is paged: writes go through
        the tables into the pool and attention reads it through the paged
        decode kernel.  A cache with k_scale is quantized: the new K/V are
        quantized as they are written and attention reads the cache
        through the quantized decode kernel.  Writes the cache in place;
        returns (logits (B, V), cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B = tokens.shape[0]
        cur = int(cache["len"])
        pos_row = batch.get("pos_row", cur)
        positions = batch.get("positions")
        if positions is None:
            positions = torch.full((B, 1), cur, dtype=torch.int32,
                                   device=tokens.device)
        positions = positions.to(torch.int32).contiguous()
        bt = batch.get("block_tables")
        quant = ("k_scale", "v_scale") if "k_scale" in cache else ()
        if bt is not None:
            bt = bt.to(torch.int32).contiguous()
            if isinstance(pos_row, int):
                pos_row = torch.full((B,), pos_row, dtype=torch.int32,
                                     device=tokens.device)
            target = paged_targets(pos_row, bt, *cache["pos"].shape[1:])
        else:
            target = pos_row
        x = L.embed(params["embed"], tokens, cfg)
        for l in range(cfg.num_layers):
            layer_kv = (cache["k"][l], cache["v"][l], cache["pos"][l],
                        *(cache[key][l] for key in quant))
            x, _ = self._block(
                _layer(params["layers"], l), x, positions,
                cache_kv=layer_kv if bt is None else (*layer_kv, bt),
                target=target)
        cache["len"] = cur + 1
        return self._last_logits(params, x), cache
