"""Unified LM assembly: the attention, mamba and xLSTM paths of the
reference's LM, with dense, MoE or no feed-forward.

Port of ``repro.models.transformer``. A model is a stack of identical
*periods*; a period is a short list of layers. Params of a period are
stacked on a leading axis, as in the reference, and a Python loop over
that axis takes the place of ``lax.scan``.

Decode carries a per-period cache tree (KV pages for attention layers,
the conv and SSM states for mamba layers, the mLSTM's (C, n, m) and the
sLSTM's (h, c, n, m) for xLSTM layers), stacked the same way. Unlike
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

Ported: attention, mamba (``models/ssm.py``, jamba-style hybrids) and
xLSTM mixers (``models/xlstm.py``, xlstm-1.3b: no feed-forward) with
dense feed-forward (granite-style) or MoE feed-forward (olmoe-style,
``models/moe.py``, with an optional shared MLP), the encoder-decoder
stack (seamless-m4t: an encoder of ``enc_layers`` non-causal attention
layers over the frames ``frontend_embeds``, and a decoder whose
``attn_cross`` layers attend to the encoder's output, non-causal and
without RoPE, through the same flash_attention kernel), the VLM inputs
(qwen2-vl: ``frontend_embeds`` written over the first embeddings and
the (3, B, S) ``mrope_positions`` of M-RoPE), and the training loss
``loss_fn``. As in the reference, an MoE layer runs
sequentially even under ``parallel_block``, and its load-balancing loss
is carried through the stack in training and dropped in decode. Under
``remat`` each period is a ``torch.utils.checkpoint`` region, whose
activations are recomputed in the backward: the reference's
``jax.checkpoint`` with ``nothing_saveable``; the encoder's output and
the M-RoPE positions enter each region as arguments. The stacked params
are unbound once a call (one view a period), so the backward stacks each
leaf's period gradients once. On the card every layer kind trains
through hand-written backward kernels: rmsnorm's and attention's, the
expert FF's (``models/moe.py``, with the fixed-order combine) and the
selective scan's reverse scan (``models/ssm.py``, a
checkpoint region a chunk inside the period's).

As the reference's, an encoder-decoder's ``loss_fn`` writes the frames
over the decoder's token embeddings as well as encoding them, so at
the reference's train split (as many frames as tokens) the decoder reads
the frames alone and the tokens only give the labels; more frames than
tokens raise ``ValueError`` (ROADMAP C16). ``prefill`` runs no encoder
and no cross-attention; ``decode_step`` takes the encoder's output from
its caller and projects its keys and values again in every layer at
every step, as the reference does.

Like the port's fixes of ROADMAP C6, C9 and C10, its xLSTM prefill is
causal where the reference's chunked mLSTM reads the rest of its chunk
(ROADMAP C14): the port's prefill and ``loss_fn`` equal its decode
recurrence, the reference's decode. Its decode departs from the
reference's on purpose in one place: under ``parallel_block``
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
from . import xlstm as XL
from .blueprint import Leaf, leaf, leaves, tree_map

Params = Any


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


#: the encoder's one layer kind: self-attention, dense feed-forward
ENC_KIND = LayerKind("attn", "dense")


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
        if kind.mixer in ("attn", "attn_cross"):
            bp["attn"] = L.attn_bp(c.d_model, c.n_heads, c.n_kv_heads,
                                   c.head_dim)
            if kind.mixer == "attn_cross":
                bp["xattn"] = L.attn_bp(c.d_model, c.n_heads,
                                        c.n_kv_heads, c.head_dim)
                bp["lnx"] = L.rmsnorm_bp(c.d_model)
        elif kind.mixer == "mamba":
            bp["mamba"] = SSM.mamba_bp(c.d_model, c.ssm_d_inner,
                                       c.ssm_d_state, c.ssm_d_conv)
        elif kind.mixer == "mlstm":
            bp["mlstm"] = XL.mlstm_bp(c.d_model, c.n_heads)
        elif kind.mixer == "slstm":
            bp["slstm"] = XL.slstm_bp(c.d_model, c.n_heads)
        else:
            raise ValueError(kind.mixer)
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
        if c.enc_dec:
            bp["enc_stack"] = _stack_bp([self._layer_bp(ENC_KIND)],
                                        c.enc_layers)
            bp["enc_ln_f"] = L.rmsnorm_bp(c.d_model)
        return bp

    def _unembed(self, params) -> torch.Tensor:
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["unembed"])

    # -- one period of layers ---------------------------------------------------
    def _apply_layer(self, kind: LayerKind, p, x, positions, *,
                     causal: bool, enc_out=None, mrope=None,
                     aux: Optional[List] = None):
        c = self.cfg
        h = L.rmsnorm(p["ln1"], x)
        if kind.mixer == "mamba":
            mix = SSM.mamba_scan_chunked(p["mamba"], h,
                                         d_state=c.ssm_d_state,
                                         chunk=c.ssm_chunk)
        elif kind.mixer == "mlstm":
            mix = XL.mlstm_chunked(p["mlstm"], h, n_heads=c.n_heads,
                                   chunk=c.xlstm_chunk)
        elif kind.mixer == "slstm":
            mix = XL.slstm_seq(p["slstm"], h)
        else:
            mix = L.gqa_attention(
                p["attn"], h, positions, n_heads=c.n_heads,
                n_kv=c.n_kv_heads, causal=causal, rope_theta=c.rope_theta,
                use_rope=(c.pos != "none"), mrope_positions=mrope)
        if c.parallel_block and kind.ff == "dense":
            # Cohere-style: attn and FF read the same normed input
            return x + mix + L.mlp(p["mlp"], h, c.gated_mlp)
        x = self._cross(kind, p, x + mix, enc_out)
        return self._ff(kind, p, x, aux)

    def _cross(self, kind: LayerKind, p, x, enc_out):
        """An ``attn_cross`` layer's cross-attention residual against the
        encoder's output (none without one): non-causal, no RoPE."""
        if kind.mixer != "attn_cross" or enc_out is None:
            return x
        c = self.cfg
        hx = L.rmsnorm(p["lnx"], x)
        return x + L.gqa_attention(p["xattn"], hx, None, n_heads=c.n_heads,
                                   n_kv=c.n_kv_heads, causal=False,
                                   use_rope=False, kv_in=enc_out)

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
                   enc_out=None, mrope=None, remat: bool = False):
        """The periods in turn -> (x, the MoE layers' aux losses summed,
        float32). ``remat``: each period is a checkpoint region, which
        takes the encoder's output and the M-RoPE positions as arguments
        (the encoder's gradient flows back through every region)."""
        def period_fn(x, auxs, enc_out, mrope, pparams):
            aux: List = []
            for k, kind in enumerate(kinds):
                x = self._apply_layer(kind, pparams[k], x, positions,
                                      causal=causal, enc_out=enc_out,
                                      mrope=mrope, aux=aux)
            for a in aux:
                auxs = auxs + a
            return x, auxs

        auxs = torch.zeros((), dtype=torch.float32, device=x.device)
        for pparams in _unstack(stack_params):
            if remat:
                x, auxs = checkpoint(period_fn, x, auxs, enc_out, mrope,
                                     pparams, use_reentrant=False)
            else:
                x, auxs = period_fn(x, auxs, enc_out, mrope, pparams)
        return x, auxs

    def _encode(self, params, frames, *, remat: bool = False):
        """The encoder over frames (B, S_src, d): its ``enc_layers``
        layers non-causal, RoPE on the source positions, then
        ``enc_ln_f``; bf16 (B, S_src, d)."""
        src = frames.to(torch.bfloat16)
        spos = torch.arange(src.shape[1], device=src.device)[None, :]
        enc, _ = self._run_stack(params["enc_stack"], src, spos,
                                 kinds=[ENC_KIND], causal=False, remat=remat)
        return L.rmsnorm(params["enc_ln_f"], enc)

    def _decoder_forward(self, params, tokens, enc_out):
        """The decoder's full causal forward over ``tokens`` (B, S)
        against the encoder's output, with no frames written over the
        token embeddings: float32 logits (B, S, V) at every position, the
        sequence that teacher-forced ``decode_step``s reproduce."""
        x = params["embed"][tokens.long()].to(torch.bfloat16)
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x, _ = self._run_stack(params["stack"], x, pos, kinds=self.period,
                               causal=True, enc_out=enc_out)
        return (L.rmsnorm(params["ln_f"], x) @ self._unembed(params)).float()

    # -- training forward ---------------------------------------------------------
    def loss_fn(self, params, batch, *, remat: bool = True):
        """batch: tokens (B, S) int, plus the modality's extras:
        ``frontend_embeds`` (B, Sf, d) where the config has them (an
        encoder-decoder's source frames, a VLM's patch embeddings), and
        ``mrope_positions`` (3, B, S) int for M-RoPE. Returns the scalar
        loss, float32: the mean next-token NLL (the last position has no
        label) plus 0.01 times the MoE aux loss a period, as the
        reference's. The logits are float32 with the padded vocab columns
        masked; ``loss_chunk`` takes them a chunk of positions at a time.

        The frames are written over the first Sf token embeddings, for an
        encoder-decoder too, as the reference does (ROADMAP C16): Sf > S
        raises ``ValueError``."""
        c = self.cfg
        tokens = batch["tokens"].long()
        B, S = tokens.shape
        x = params["embed"][tokens].to(torch.bfloat16)
        positions = torch.arange(S, device=tokens.device)[None, :]
        mrope = batch.get("mrope_positions") if c.pos == "mrope" else None
        if c.frontend_embeds:
            fe = batch["frontend_embeds"]
            if fe.shape[1] > S:
                raise ValueError(
                    f"{fe.shape[1]} frontend frames for {S} tokens: the "
                    "frames are written over the token embeddings and "
                    "cannot outnumber them (ROADMAP C16)")
            x = torch.cat([fe.to(x.dtype), x[:, fe.shape[1]:]], dim=1)
        enc_out = (self._encode(params, batch["frontend_embeds"],
                                remat=remat) if c.enc_dec else None)
        x, aux = self._run_stack(params["stack"], x, positions,
                                 kinds=self.period, causal=True,
                                 enc_out=enc_out, mrope=mrope, remat=remat)
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
        if kind.mixer == "mlstm":
            st = XL.mlstm_init_state(n * B, c.n_heads,
                                     c.d_model // c.n_heads, device)
            return {k: t.reshape((n, B) + t.shape[1:])
                    for k, t in st.items()}
        if kind.mixer == "slstm":
            return tuple(t.reshape(n, B, c.d_model)
                         for t in XL.slstm_init_state(n * B, c.d_model,
                                                      device=device))
        if kind.mixer not in ("attn", "attn_cross"):
            raise ValueError(kind.mixer)
        shape = (n, B, S_max, c.n_kv_heads, c.head_dim)
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}

    def init_cache(self, B: int, S_max: int, device=None):
        """Stacked (n_periods, ...) cache tree, on the card unless
        ``device`` says otherwise."""
        dev = resolve_device(device)
        return [self._layer_cache(k, B, S_max, dev) for k in self.period]

    def recurrent_state(self, cache):
        """The cache's recurrent leaves (those of mamba and xLSTM layers),
        each (n_periods, B, ...), as (leaf, its initial value) pairs:
        state that a decode step advances for every slot it runs, where
        KV pages only gain a row. Every leaf starts at 0 but the
        stabilisers ``m`` of the mLSTM and sLSTM, which start at
        ``XL.M_INIT``. Empty for a model of attention layers only."""
        out = []
        for kind, layer in zip(self.period, cache):
            if kind.mixer == "mamba":
                out += [(t, 0.0) for t in layer.values()]
            elif kind.mixer == "mlstm":
                out += [(t, XL.M_INIT if k == "m" else 0.0)
                        for k, t in layer.items()]
            elif kind.mixer == "slstm":
                out += [(t, XL.M_INIT if i == 3 else 0.0)
                        for i, t in enumerate(layer)]
        return out

    def decode_step(self, params, cache, tokens, pos, enc_out=None):
        """tokens: (B,1) int; pos: (B,) current lengths; ``enc_out``
        (B, S_src, d), the encoder's output, for an encoder-decoder's
        cross-attention (none without it, as in the reference).
        Returns (logits (B,1,V) float32, cache updated in place)."""
        x = params["embed"][tokens].to(torch.bfloat16)
        positions = pos[:, None]
        for i in range(self.n_periods):
            pparams = tree_map(lambda a: a[i], params["stack"])
            pcache = tree_map(lambda a: a[i], cache)
            for k, kind in enumerate(self.period):
                x = self._decode_layer(kind, pparams[k], pcache[k], x,
                                       positions, pos, enc_out)
        x = L.rmsnorm(params["ln_f"], x)
        logits = (x @ self._unembed(params)).float()
        return _mask_vocab_pad(logits, self.cfg.vocab), cache

    def _decode_layer(self, kind: LayerKind, p, cache, x, positions, pos,
                      enc_out=None):
        c = self.cfg
        h = L.rmsnorm(p["ln1"], x)
        if kind.mixer == "mamba":
            mix, _ = SSM.mamba_decode_step(p["mamba"], h, cache,
                                           d_state=c.ssm_d_state)
            return self._ff(kind, p, x + mix)
        if kind.mixer == "mlstm":
            mix, _ = XL.mlstm_decode_step(p["mlstm"], h, cache,
                                          n_heads=c.n_heads)
            return self._ff(kind, p, x + mix)
        if kind.mixer == "slstm":
            mix, _ = XL.slstm_decode_step(p["slstm"], h, cache)
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
        return self._ff(kind, p, self._cross(kind, p, x + mix, enc_out))

    # -- prefill ------------------------------------------------------------------
    def prefill(self, params, tokens):
        """Full-sequence forward that returns last-position logits (the
        inference-prefill shape), float32 (B, V). An encoder-decoder's
        prefill runs the decoder alone, without cross-attention, as the
        reference's does (it passes no encoder output)."""
        B, S = tokens.shape
        x = params["embed"][tokens].to(torch.bfloat16)
        positions = torch.arange(S, device=tokens.device)[None, :]
        x, _ = self._run_stack(params["stack"], x, positions,
                               kinds=self.period, causal=True)
        x = L.rmsnorm(params["ln_f"], x)
        return (x[:, -1] @ self._unembed(params)).float()


def _unstack(stack_params) -> list:
    """The (n, ...) stacked leaves as n trees of their period's views,
    from one ``unbind`` a leaf: its backward stacks the n gradients once,
    where indexing ``a[i]`` n times would add n full-size gradients."""
    parts = tree_map(lambda a: a.unbind(0), stack_params)
    return [tree_map(lambda a, u: u[i], stack_params, parts)
            for i in range(leaves(stack_params)[0].shape[0])]


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
