"""Model registry: config -> LM instance + per-shape input specs.

Port of ``repro.models.registry``. ``input_specs`` gives each input's
shape and torch dtype (``Spec`` records; nothing is allocated) where the
reference gives ``jax.ShapeDtypeStruct``s. The sharding rules
(``input_shardings``, ``dynamic_rules``) wait for the distributed slice
(ROADMAP A10).

``mrope_grid_positions`` lays out the (3, B, S) M-RoPE positions of a
prompt that opens with one image, as Qwen2-VL does: a model input the
reference takes from its caller.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..configs.base import SHAPES, ModelConfig
from .blueprint import tree_map
from .transformer import LM

MODEL_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


class Spec(NamedTuple):
    """An input's shape and dtype."""

    shape: tuple
    dtype: torch.dtype


def get_model(cfg: ModelConfig) -> LM:
    return LM(cfg)


def _spec(shape, dtype) -> Spec:
    return Spec(tuple(int(s) for s in shape), dtype)


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """Step-function inputs for one (arch x shape) cell, the reference's:
    train (an encoder-decoder's tokens and frames split S in half; a
    VLM's frames cover at most 256 positions, its M-RoPE positions all
    S), prefill (tokens, and an encoder-decoder's frames) and decode
    (one token, positions, the cache as ``LM.init_cache`` makes it, and
    an encoder-decoder's ``enc_out`` over 4096 source positions)."""
    sh = SHAPES[shape_name]
    B = sh.global_batch
    S = sh.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    if sh.kind == "train":
        out: Dict[str, Any] = {}
        if cfg.enc_dec:
            out["tokens"] = _spec((B, S // 2), i32)
            out["frontend_embeds"] = _spec((B, S // 2, cfg.d_model), bf16)
        else:
            out["tokens"] = _spec((B, S), i32)
            if cfg.frontend_embeds:
                out["frontend_embeds"] = _spec((B, min(256, S), cfg.d_model),
                                               bf16)
            if cfg.pos == "mrope":
                out["mrope_positions"] = _spec((3, B, S), i32)
        return out

    if sh.kind == "prefill":
        out = {"tokens": _spec((B, S // 2 if cfg.enc_dec else S), i32)}
        if cfg.enc_dec:
            out["frontend_embeds"] = _spec((B, S // 2, cfg.d_model), bf16)
        return out

    # decode shapes: one new token against a cache of length S
    cache = LM(cfg).init_cache(B, S, device="meta")
    out = {"tokens": _spec((B, 1), i32), "pos": _spec((B,), i32),
           "cache": tree_map(lambda t: _spec(t.shape, t.dtype), cache)}
    if cfg.enc_dec:
        out["enc_out"] = _spec((B, 4096, cfg.d_model), bf16)
    return out


def mrope_grid_positions(B: int, S: int, grid_h: int, grid_w: int,
                         device=None) -> torch.Tensor:
    """(3, B, S) int32 M-RoPE positions (temporal, height, width) of a
    prompt that opens with one image of grid_h x grid_w patches and goes
    on with text, as Qwen2-VL lays them out (arXiv:2409.12191, section
    2.1): the patches at t = 0 with their row and column, then the text
    from one past the largest index so far, the same on all three axes."""
    n = grid_h * grid_w
    if n > S:
        raise ValueError(f"{n} patches for {S} positions")
    idx = torch.arange(n, device=device)
    img = torch.stack([torch.zeros_like(idx), idx // grid_w, idx % grid_w])
    start = max(grid_h, grid_w)
    text = torch.arange(start, start + S - n, device=device)
    pos = torch.cat([img, text.expand(3, -1)], dim=1)
    return pos[:, None, :].expand(3, B, S).to(torch.int32).contiguous()
