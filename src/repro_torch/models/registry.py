"""Model registry: config -> LM instance + per-shape input specs.

Port of ``repro.models.registry``. ``input_specs`` gives each input's
shape and torch dtype (``Spec`` records; nothing is allocated) where the
reference gives ``jax.ShapeDtypeStruct``s; ``input_shardings`` the
matching ``PSpec``s and ``dynamic_rules`` the rules adapted to a mesh,
both the reference's.

``mrope_grid_positions`` lays out the (3, B, S) M-RoPE positions of a
prompt that opens with one image, as Qwen2-VL does: a model input the
reference takes from its caller.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..configs.base import SHAPES, ModelConfig
from .blueprint import DEFAULT_RULES, PSpec, tree_map
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


def batch_spec(shape_name: str, data_axes=("data",),
               axis_sizes: Optional[Dict[str, int]] = None):
    """The mesh axes the shape's batch dim shards over (a name or a tuple
    of names), or None where the global batch does not divide them."""
    axis_sizes = axis_sizes or {"data": 16, "model": 16}
    B = SHAPES[shape_name].global_batch
    da = tuple(data_axes)
    da_size = 1
    for a in da:
        da_size *= axis_sizes.get(a, 1)
    dspec = da if len(da) > 1 else da[0]
    return dspec if B % da_size == 0 and B >= da_size else None


def input_shardings(cfg: ModelConfig, shape_name: str,
                    data_axes=("data",),
                    axis_sizes: Optional[Dict[str, int]] = None
                    ) -> Dict[str, Any]:
    """PSpecs matching input_specs. Batch shards over the data axes when
    divisible; batch-1 long-decode shards the KV/sequence dim instead
    (sequence parallelism)."""
    axis_sizes = axis_sizes or {"data": 16, "model": 16}
    sh = SHAPES[shape_name]
    da = tuple(data_axes)
    bspec = batch_spec(shape_name, da, axis_sizes)
    model_size = axis_sizes.get("model", 1)

    if sh.kind in ("train", "prefill"):
        out = {"tokens": PSpec(bspec, None)}
        has_frontend = (cfg.enc_dec if sh.kind == "prefill"
                        else (cfg.enc_dec or cfg.frontend_embeds))
        if has_frontend:
            out["frontend_embeds"] = PSpec(bspec, None, None)
        if cfg.pos == "mrope" and sh.kind == "train":
            out["mrope_positions"] = PSpec(None, bspec, None)
        return out

    # decode: per-layer-kind cache specs from the model
    model = LM(cfg)
    if bspec is not None:
        seq_axes: Any = "model"          # heads unshardable -> SP on model
    else:
        seq_axes = tuple(list(da) + ["model"])  # batch-1: SP over all axes
    cache = model.cache_pspecs(bspec=bspec, seq_axes=seq_axes,
                               model_size=model_size)
    out = {
        "tokens": PSpec(bspec, None),
        "pos": PSpec(bspec),
        "cache": cache,
    }
    if cfg.enc_dec:
        out["enc_out"] = PSpec(bspec, None, None)
    return out


def dynamic_rules(cfg: ModelConfig, axis_sizes: Dict[str, int],
                  base: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Adapt the logical->mesh rules to this (arch, mesh): a logical axis
    whose size does not divide its mesh axis falls back to replication
    (e.g. starcoder2's 36 heads on a 16-way model axis, GQA kv=8 heads)."""
    rules = dict(base or DEFAULT_RULES)
    m = axis_sizes.get("model", 1)

    def fits(n: int) -> bool:
        return n % m == 0

    if not fits(cfg.n_heads):
        rules["heads"] = None
    if not fits(cfg.n_kv_heads):
        rules["kv_heads"] = None
    if not fits(cfg.padded_vocab):
        rules["vocab"] = None
    if cfg.d_ff and not fits(cfg.d_ff):
        rules["ff"] = None
    if cfg.family == "ssm" and cfg.d_ff == 0:
        # xlstm: "ff" axis carries 4*d_model gate blocks
        if not fits(4 * cfg.d_model):
            rules["ff"] = None
    if cfg.moe_experts and not fits(cfg.moe_experts):
        rules["experts"] = None
    if not fits(cfg.ssm_d_inner):
        rules["d_inner"] = None
    return rules


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
