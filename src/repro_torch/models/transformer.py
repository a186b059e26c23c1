"""Unified LM assembly: the attention and mamba paths of the reference's
LM, with dense or MoE feed-forward.

Port of ``repro.models.transformer``. A model is a stack of identical
*periods*; a period is a short list of layers. Params of a period are
stacked on a leading axis, as in the reference, and a Python loop over
that axis takes the place of ``lax.scan``.

Decode carries a per-period cache tree (KV pages for attention layers,
the conv and SSM states for mamba layers), stacked the same way. Unlike
the reference, ``decode_step`` updates the cache in place and returns
the same cache object: it writes the new keys and values (one indexed
store per layer instead of a one-hot select over the whole cache) and
advances the recurrent states. A step that fails part-way and is run
again with the same tokens and positions writes the same KV rows, so for
KV pages a retry is idempotent; a recurrent state it advanced is not
rolled back.

The config's ``attn_impl``, ``attn_chunk``, ``attn_skip_masked_blocks``
and ``attn_unroll_kv`` are the reference's XLA lowering choices; the
port reads none of them, and prefill's attention always goes through the
flash_attention kernel.

Ported: attention and mamba mixers (``models/ssm.py``, jamba-style
hybrids) with dense feed-forward (granite-style) or MoE feed-forward
(olmoe-style, ``models/moe.py``, with an optional shared MLP), and the
training loss ``loss_fn``. As in the reference, an MoE layer runs
sequentially even under ``parallel_block``, and its load-balancing loss
is carried through the stack in training and dropped in decode. Under
``remat`` each period is a ``torch.utils.checkpoint`` region, whose
activations are recomputed in the backward: the reference's
``jax.checkpoint`` with ``nothing_saveable``. The stacked params are
unbound once a call (one view a period), so the backward stacks each
leaf's period gradients once. The xLSTM mixers, the encoder-decoder
stack and VLM inputs raise ``NotImplementedError`` naming their ROADMAP
item; on the card, training an MoE or mamba layer raises too, since
their kernels have no backward yet (ROADMAP A13, A14).

Like the port's fixes of ROADMAP C6, C9 and C10, its decode departs
from the reference's on purpose in one place: under ``parallel_block``
a dense layer decodes as prefill computes it, ``x + attn(h) + mlp(h)``
from one normed input (command-r-plus). The reference's
``_decode_layer`` never reads ``parallel_block`` and decodes such a
layer sequentially, so its decode does not reproduce its own prefill
(ROADMAP C11); the port's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers as L
from . import moe as MOE
from . import ssm as SSM
from .blueprint import Leaf, leaf, tree_map

Params = Any


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


# --------------------------------------------------------------------------
# layer descriptors
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str          # attn | attn_cross | mamba | mlstm | slstm
    ff: str             # dense | moe | none


def _stack_bp(bp, n: int):
    """Add a leading period axis to every blueprint leaf."""
    return tree_map(
        lambda l: Leaf((n,) + l.shape, ("layers",) + l.axes, l.dtype,
                       l.init, None if l.scale_dim is None
                       else l.scale_dim + 1), bp)


_MIXER_ITEM = {"mlstm": "A6 (models/xlstm.py)",
               "slstm": "A6 (models/xlstm.py)",
               "attn_cross": "A11 (encoder-decoder)"}


class LM:
    """See configs/base.py:ModelConfig for the knob list."""

    def __init__(self, cfg) -> None:
        self.cfg = cfg
        assert cfg.n_layers % len(cfg.layer_pattern()) == 0, \
            f"{cfg.name}: pattern does not tile n_layers"
        self.period = cfg.layer_pattern()
        self.n_periods = cfg.n_layers // len(self.period)

    # -- blueprints -----------------------------------------------------------
    def _layer_bp(self, kind: LayerKind):
        c = self.cfg
        bp: Dict[str, Any] = {"ln1": L.rmsnorm_bp(c.d_model)}
        if kind.mixer == "attn":
            bp["attn"] = L.attn_bp(c.d_model, c.n_heads, c.n_kv_heads,
                                   c.head_dim)
        elif kind.mixer == "mamba":
            bp["mamba"] = SSM.mamba_bp(c.d_model, c.ssm_d_inner,
                                       c.ssm_d_state, c.ssm_d_conv)
        else:
            raise _not_ported(f"the {kind.mixer} mixer",
                              _MIXER_ITEM.get(kind.mixer, "A6"))
        if kind.ff == "dense":
            bp["ln2"] = L.rmsnorm_bp(c.d_model)
            bp["mlp"] = L.mlp_bp(c.d_model, c.d_ff, c.gated_mlp)
        elif kind.ff == "moe":
            bp["ln2"] = L.rmsnorm_bp(c.d_model)
            bp["moe"] = MOE.moe_bp(c.d_model, c.moe_experts, c.moe_d_ff)
            if c.moe_shared_ff:
                bp["shared_mlp"] = L.mlp_bp(c.d_model, c.moe_d_ff,
                                            c.gated_mlp)
        return bp

    def blueprint(self):
        c = self.cfg
        if c.enc_dec:
            raise _not_ported("the encoder-decoder stack",
                              _MIXER_ITEM["attn_cross"])
        period_bp = [self._layer_bp(k) for k in self.period]
        bp: Dict[str, Any] = {
            "embed": leaf((c.padded_vocab, c.d_model), ("vocab", "embed"),
                          scale_dim=1),
            "stack": _stack_bp(period_bp, self.n_periods),
            "ln_f": L.rmsnorm_bp(c.d_model),
        }
        if not c.tie_embeddings:
            bp["unembed"] = leaf((c.d_model, c.padded_vocab),
                                 ("embed", "vocab"), scale_dim=0)
        return bp

    def _unembed(self, params) -> torch.Tensor:
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["unembed"])

    # -- one period of layers ---------------------------------------------------
    def _apply_layer(self, kind: LayerKind, p, x, positions, *,
                     causal: bool, aux: Optional[List] = None):
        c = self.cfg
        h = L.rmsnorm(p["ln1"], x)
        if kind.mixer == "mamba":
            mix = SSM.mamba_scan_chunked(p["mamba"], h,
                                         d_state=c.ssm_d_state,
                                         chunk=c.ssm_chunk)
        else:
            mix = L.gqa_attention(
                p["attn"], h, positions, n_heads=c.n_heads,
                n_kv=c.n_kv_heads, causal=causal, rope_theta=c.rope_theta,
                use_rope=(c.pos != "none"))
        if c.parallel_block and kind.ff == "dense":
            # Cohere-style: attn and FF read the same normed input
            return x + mix + L.mlp(p["mlp"], h, c.gated_mlp)
        x = x + mix
        return self._ff(kind, p, x, aux)

    def _ff(self, kind: LayerKind, p, x, aux: Optional[List] = None):
        """The layer's feed-forward residual, sequential after the
        mixer; an MoE layer appends its load-balancing loss to ``aux``
        where given."""
        c = self.cfg
        if kind.ff == "dense":
            x = x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x), c.gated_mlp)
        elif kind.ff == "moe":
            h2 = L.rmsnorm(p["ln2"], x)
            y, a = MOE.moe_ff(p["moe"], h2, n_experts=c.moe_experts,
                              top_k=c.moe_top_k,
                              capacity_factor=c.moe_capacity)
            if c.moe_shared_ff:
                y = y + L.mlp(p["shared_mlp"], h2, c.gated_mlp)
            x = x + y
            if aux is not None:
                aux.append(a)
        return x

    def _run_stack(self, stack_params, x, positions, *, kinds, causal,
                   remat: bool = False):
        """The periods in turn -> (x, the MoE layers' aux losses summed,
        float32). ``remat``: each period is a checkpoint region."""
        def period_fn(x, auxs, pparams):
            aux: List = []
            for k, kind in enumerate(kinds):
                x = self._apply_layer(kind, pparams[k], x, positions,
                                      causal=causal, aux=aux)
            for a in aux:
                auxs = auxs + a
            return x, auxs

        auxs = torch.zeros((), dtype=torch.float32, device=x.device)
        for pparams in _unstack(stack_params, self.n_periods):
            if remat:
                x, auxs = checkpoint(period_fn, x, auxs, pparams,
                                     use_reentrant=False)
            else:
                x, auxs = period_fn(x, auxs, pparams)
        return x, auxs

    # -- training forward ---------------------------------------------------------
    def loss_fn(self, params, batch, *, remat: bool = True):
        """batch: tokens (B, S) int. Returns the scalar loss, float32: the
        mean next-token NLL (the last position has no label) plus 0.01
        times the MoE aux loss a period, as the reference's. The logits are
        float32 with the padded vocab columns masked; ``loss_chunk`` takes
        them a chunk of positions at a time."""
        c = self.cfg
        if c.enc_dec:
            raise _not_ported("training an encoder-decoder",
                              _MIXER_ITEM["attn_cross"])
        if c.frontend_embeds or (c.pos == "mrope" and batch.get(
                "mrope_positions") is not None):
            raise _not_ported("frontend embeddings and M-RoPE positions "
                              "in training", "A11 (VLM inputs)")
        tokens = batch["tokens"].long()
        B, S = tokens.shape
        x = params["embed"][tokens].to(torch.bfloat16)
        positions = torch.arange(S, device=tokens.device)[None, :]
        x, aux = self._run_stack(params["stack"], x, positions,
                                 kinds=self.period, causal=True,
                                 remat=remat)
        x = L.rmsnorm(params["ln_f"], x)
        unembed = self._unembed(params)
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        valid = torch.ones(B, S, dtype=torch.float32, device=x.device)
        valid[:, -1] = 0.0
        if c.loss_chunk and S > c.loss_chunk:
            n, C = S // c.loss_chunk, c.loss_chunk
            xs = x.reshape(B, n, C, c.d_model)
            ls, vs = labels.reshape(B, n, C), valid.reshape(B, n, C)
            tot = torch.zeros((), dtype=torch.float32, device=x.device)
            for i in range(n):
                tot = tot + self._nll_sum(xs[:, i], unembed, ls[:, i],
                                          vs[:, i])
        else:
            tot = self._nll_sum(x, unembed, labels, valid)
        nll = tot / valid.sum().clamp_min(1.0)
        return nll + 0.01 * aux / max(1, self.n_periods)

    def _nll_sum(self, x, unembed, labels, valid) -> torch.Tensor:
        """The summed NLL of ``labels`` under the float32 logits of x,
        counting the ``valid`` positions only."""
        logits = torch.einsum("bsd,dv->bsv", x, unembed).float()
        logits = _mask_vocab_pad(logits, self.cfg.vocab)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels[..., None])[..., 0]
        return ((lse - ll) * valid).sum()

    # -- decode -----------------------------------------------------------------
    def _layer_cache(self, kind: LayerKind, B: int, S_max: int, device):
        c = self.cfg
        n = self.n_periods
        if kind.mixer == "mamba":
            return {"conv": torch.zeros((n, B, c.ssm_d_conv - 1,
                                         c.ssm_d_inner),
                                        dtype=torch.bfloat16, device=device),
                    "ssm": torch.zeros((n, B, c.ssm_d_inner, c.ssm_d_state),
                                       dtype=torch.float32, device=device)}
        if kind.mixer != "attn":
            raise _not_ported(f"the {kind.mixer} decode cache",
                              _MIXER_ITEM.get(kind.mixer, "A6"))
        shape = (n, B, S_max, c.n_kv_heads, c.head_dim)
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}

    def init_cache(self, B: int, S_max: int, device=None):
        """Stacked (n_periods, ...) cache tree, on the card unless
        ``device`` says otherwise."""
        dev = resolve_device(device)
        return [self._layer_cache(k, B, S_max, dev) for k in self.period]

    def recurrent_state(self, cache):
        """The cache's recurrent leaves (those of mamba layers), each
        (n_periods, B, ...): state that a decode step advances for every
        slot it runs, where KV pages only gain a row. Empty for a model
        of attention layers only."""
        return [t for kind, layer in zip(self.period, cache)
                if kind.mixer == "mamba" for t in layer.values()]

    def decode_step(self, params, cache, tokens, pos, enc_out=None):
        """tokens: (B,1) int; pos: (B,) current lengths.
        Returns (logits (B,1,V) float32, cache updated in place)."""
        if enc_out is not None:
            raise _not_ported("decode against an encoder",
                              _MIXER_ITEM["attn_cross"])
        x = params["embed"][tokens].to(torch.bfloat16)
        positions = pos[:, None]
        for i in range(self.n_periods):
            pparams = tree_map(lambda a: a[i], params["stack"])
            pcache = tree_map(lambda a: a[i], cache)
            for k, kind in enumerate(self.period):
                x = self._decode_layer(kind, pparams[k], pcache[k], x,
                                       positions, pos)
        x = L.rmsnorm(params["ln_f"], x)
        logits = (x @ self._unembed(params)).float()
        return _mask_vocab_pad(logits, self.cfg.vocab), cache

    def _decode_layer(self, kind: LayerKind, p, cache, x, positions, pos):
        c = self.cfg
        h = L.rmsnorm(p["ln1"], x)
        if kind.mixer == "mamba":
            mix, _ = SSM.mamba_decode_step(p["mamba"], h, cache,
                                           d_state=c.ssm_d_state)
            return self._ff(kind, p, x + mix)
        q = torch.einsum("bsd,dhk->bshk", h, p["attn"]["wq"])
        k = torch.einsum("bsd,dhk->bshk", h, p["attn"]["wk"])
        v = torch.einsum("bsd,dhk->bshk", h, p["attn"]["wv"])
        if c.pos != "none":
            q = L.apply_rope(q, positions, c.rope_theta)
            k = L.apply_rope(k, positions, c.rope_theta)
        kc = _insert_at(cache["k"], k, pos)
        vc = _insert_at(cache["v"], v, pos)
        o = L.attention_decode(q, kc, vc, pos + 1)
        mix = torch.einsum("bshk,hkd->bsd", o, p["attn"]["wo"])
        if c.parallel_block and kind.ff == "dense":
            # as prefill computes it (the reference decodes it
            # sequentially: ROADMAP C11)
            return x + mix + L.mlp(p["mlp"], h, c.gated_mlp)
        return self._ff(kind, p, x + mix)

    # -- prefill ------------------------------------------------------------------
    def prefill(self, params, tokens):
        """Full-sequence forward that returns last-position logits (the
        inference-prefill shape), float32 (B, V)."""
        B, S = tokens.shape
        x = params["embed"][tokens].to(torch.bfloat16)
        positions = torch.arange(S, device=tokens.device)[None, :]
        x, _ = self._run_stack(params["stack"], x, positions,
                               kinds=self.period, causal=True)
        x = L.rmsnorm(params["ln_f"], x)
        return (x[:, -1] @ self._unembed(params)).float()


def _unstack(stack_params, n: int) -> list:
    """The (n, ...) stacked leaves as n trees of their period's views,
    from one ``unbind`` a leaf: its backward stacks the n gradients once,
    where indexing ``a[i]`` n times would add n full-size gradients."""
    parts = tree_map(lambda a: a.unbind(0), stack_params)
    return [tree_map(lambda a, u: u[i], stack_params, parts)
            for i in range(n)]


def _mask_vocab_pad(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Padded vocab columns (Megatron-style padding) get -1e30."""
    if logits.shape[-1] == vocab:
        return logits
    keep = torch.arange(logits.shape[-1], device=logits.device) < vocab
    return logits.masked_fill(~keep, -1e30)


def _insert_at(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor
               ) -> torch.Tensor:
    """cache (B,S,H,D), new (B,1,H,D), pos (B,): writes row ``pos[b]`` of
    every batch entry in place and returns the cache."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos.long()] = new[:, 0].to(cache.dtype)
    return cache
