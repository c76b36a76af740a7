"""Dense decoder-only LM with global attention (``Family.DENSE``).

Port of the dense path of ``repro.models.lm.DecoderModel``: embed ->
L x [RMSNorm -> attention with RoPE -> RMSNorm -> MLP] -> final norm ->
unembed.  The reference scans over the stacked layer axis; here a Python
loop walks it (``params["layers"][...][l]`` are views).

Entry points, with the reference's functional signatures:
  * ``prefill(params, batch)``            -> (last-token logits (B, V), cache)
  * ``decode_step(params, batch, cache)`` -> (logits (B, V), cache)

Unlike the reference, ``decode_step`` writes the new K/V into the cache
tensors IN PLACE and returns the same dict: the cache is the largest
tensor of a serving run and a copy per tick would double its traffic.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.config import Family, ModelConfig
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
    B, T = pc.shape
    if isinstance(pos, int):
        slot = pos % T
        kc[:, slot] = k_new[:, 0]
        vc[:, slot] = v_new[:, 0]
        pc[:, slot] = pos
        return
    rows = torch.arange(B, device=pc.device)
    slot = torch.remainder(pos.long(), T)
    kc[rows, slot] = k_new[:, 0]
    vc[rows, slot] = v_new[:, 0]
    pc[rows, slot] = pos.to(pc.dtype)


class DecoderModel:
    """Config + parameter init + the serving entry points, on ``device``
    (the card unless the caller asks for ``"cpu"``)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        if cfg.family != Family.DENSE or cfg.sliding_window is not None \
                or cfg.local_global_pattern or cfg.m_rope_sections:
            raise NotImplementedError(
                f"{cfg.name}: the port runs dense global-attention decoders; "
                "windowed, MoE, SSM, hybrid and VLM models are queued in "
                "ROADMAP.md")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16          # compute and storage dtype

    def init(self, seed: int = 0) -> Dict:
        return init_params(self.cfg, seed, self.device, self.dtype)

    def init_cache(self, batch_size: int, cache_len: int) -> Dict:
        """Contiguous cache: k, v (L, B, T, K, hd) in the compute dtype;
        pos (L, B, T) int32 with -1 = empty."""
        cfg = self.cfg
        kv = (cfg.num_layers, batch_size, cache_len, cfg.num_kv_heads,
              cfg.head_dim)
        return {"len": 0,
                "k": torch.zeros(kv, dtype=self.dtype, device=self.device),
                "v": torch.zeros(kv, dtype=self.dtype, device=self.device),
                "pos": torch.full(kv[:3], -1, dtype=torch.int32,
                                  device=self.device)}

    def _block(self, p, h, positions, cache_kv=None, pos_row=None):
        """One layer.  With ``cache_kv = (k, v, pos)`` (decode) the new K/V
        are projected from the same normed input and written at
        ``pos_row`` before attention reads the cache."""
        cfg = self.cfg
        x = L.rms_norm(h, p["ln1"]["scale"], cfg.rms_eps)
        if cache_kv is not None:
            k_new, v_new = L.project_kv(p["attn"], x, cfg, positions)
            _cache_write(*cache_kv, k_new, v_new, pos_row)
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
        cache with k, v (L, B, S, K, hd) and pos (L, B, S))."""
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
        x = L.rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
        if "length" in batch:
            idx = torch.clamp(batch["length"].long() - 1, 0, S - 1)
            last = x[torch.arange(B, device=x.device), idx][:, None]
        else:
            last = x[:, -1:]
        return L.unembed(params["embed"], last, cfg)[:, 0], cache

    @torch.no_grad()
    def decode_step(self, params, batch, cache) -> Tuple[torch.Tensor, Dict]:
        """One token per row.  batch: tokens (B, 1); optional positions
        (B, 1) and pos_row (B,) per-row write positions (slot-pool
        serving); without them every row advances at ``cache["len"]``.
        Writes the cache in place; returns (logits (B, V), cache)."""
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
        x = L.embed(params["embed"], tokens, cfg)
        for l in range(cfg.num_layers):
            x, _ = self._block(
                _layer(params["layers"], l), x, positions,
                cache_kv=(cache["k"][l], cache["v"][l], cache["pos"][l]),
                pos_row=pos_row)
        cache["len"] = cur + 1
        x = L.rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
        return L.unembed(params["embed"], x, cfg)[:, 0], cache
