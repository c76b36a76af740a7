"""Parameters of the dense decoder: layout, seeded init, and the bridge
from a JAX parameter tree.

The tree has the reference's layout exactly: nested dicts with every
per-layer weight stacked along a leading ``layers`` axis (``wq`` is
``(L, D, H, hd)``), so the port and ``repro.models.lm.DecoderModel``
compare like with like.  ``params["layers"]["attn"]["wq"][l]`` is a
contiguous view of layer l.

Weights are kept in the compute dtype (bf16) on the device.  That is
exact, not an approximation: the reference keeps f32 parameters but
casts each one to the activation dtype at every use
(``p["wq"].astype(x.dtype)`` in ``repro/models/layers.py``), so the
values that enter every product are the bf16 ones stored here.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.config import Activation, ModelConfig

# one leaf: (stacked shape, initializer, scale), as the reference's PDef
Spec = Tuple[Tuple[int, ...], str, float]


def param_specs(cfg: ModelConfig) -> Dict:
    """Nested dict of (shape, init, scale) leaves of a dense decoder."""
    L, D, V, F = cfg.num_layers, cfg.d_model, cfg.padded_vocab, cfg.d_ff
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = {"wq": ((L, D, H, hd), "fan_in", 1.0),
            "wk": ((L, D, K, hd), "fan_in", 1.0),
            "wv": ((L, D, K, hd), "fan_in", 1.0),
            "wo": ((L, H, hd, D), "fan_in", 1.0)}
    if cfg.qk_norm:
        attn["q_norm"] = ((L, hd), "ones", 1.0)
        attn["k_norm"] = ((L, hd), "ones", 1.0)
    mlp = {"w1": ((L, D, F), "fan_in", 1.0), "w2": ((L, F, D), "fan_in", 1.0)}
    if cfg.activation in (Activation.SWIGLU, Activation.GEGLU):
        mlp["w3"] = ((L, D, F), "fan_in", 1.0)
    embed = {"embedding": ((V, D), "normal", 1.0)}
    if not cfg.tie_embeddings:
        embed["unembed"] = ((D, V), "fan_in", 1.0)
    return {"embed": embed,
            "layers": {"ln1": {"scale": ((L, D), "ones", 1.0)},
                       "attn": attn,
                       "ln2": {"scale": ((L, D), "ones", 1.0)},
                       "mlp": mlp},
            "final_norm": {"scale": ((D,), "ones", 1.0)}}


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def _materialize(spec: Spec, gen: torch.Generator, device, dtype):
    shape, init, scale = spec
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if init == "normal":
        t.normal_(0.0, 1.0, generator=gen).mul_(scale)
    else:
        # truncated normal on [-2, 2] times scale / sqrt(fan_in).  As in the
        # reference, fan_in is the product of all dims but the last of the
        # STACKED shape, so it includes the layers axis.
        fan_in = max(1, math.prod(shape[:-1]))
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.mul_(scale / math.sqrt(fan_in))
    return t.to(dtype)


def init_params(cfg: ModelConfig, seed: int, device,
                dtype=torch.bfloat16) -> Dict:
    """Seeded parameters with the reference's distributions (normal
    embedding, truncated-normal 1/sqrt(fan_in) projections, unit norm
    scales), drawn from one ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def walk(node):
        if _is_spec(node):
            return _materialize(node, gen, device, dtype)
        return {k: walk(node[k]) for k in sorted(node)}
    return walk(param_specs(cfg))


def params_from_jax(tree, cfg: ModelConfig, device,
                    dtype=torch.bfloat16) -> Dict:
    """Map a ``repro`` DecoderModel parameter tree (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, params)``) onto the port's layout.
    Raises if a leaf is missing, extra or of another shape."""
    def walk(spec, node, path):
        if _is_spec(spec):
            arr = np.array(node, dtype=np.float32)
            if arr.shape != spec[0]:
                raise ValueError(f"{path}: shape {arr.shape} != {spec[0]}")
            return torch.from_numpy(arr).to(device=device, dtype=dtype)
        if set(spec) != set(node):
            raise ValueError(f"{path or 'params'}: keys {sorted(node)} != "
                             f"{sorted(spec)}")
        return {k: walk(spec[k], node[k], f"{path}/{k}") for k in sorted(spec)}
    return walk(param_specs(cfg), tree, "")
