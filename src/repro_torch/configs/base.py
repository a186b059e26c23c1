"""ModelConfig: every knob an assigned architecture needs, plus the input
shape table and reduced smoke variants."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode | long_decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "long_decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # position encoding
    pos: str = "rope"              # rope | mrope | none
    rope_theta: float = 10000.0

    # block structure
    parallel_block: bool = False   # Cohere-style parallel attn+FF
    gated_mlp: bool = True
    tie_embeddings: bool = False

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_every_k: int = 1           # MoE FF on layers where idx % k == k-1
    moe_shared_ff: bool = False
    moe_capacity: float = 1.25

    # SSM (mamba)
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every_k: int = 0          # hybrid: attention on idx % k == k//2

    # xLSTM
    xlstm_slstm_every: int = 0     # 1 sLSTM per this many layers (0 = none)
    xlstm_chunk: int = 128

    # encoder-decoder
    enc_dec: bool = False
    enc_layers: int = 0
    frontend_embeds: bool = False  # audio/vision stub inputs

    # lowering knobs
    unroll_stack: bool = False     # python-unroll periods (costing variants)
    seq_shard_activations: bool = False  # SP: residual stream sharded over
                                         # (data, model) between blocks

    # attention lowering (perf knobs; see EXPERIMENTS.md §Perf)
    attn_impl: str = "chunked"     # naive | chunked
    attn_chunk: int = 512
    attn_skip_masked_blocks: bool = False
    attn_unroll_kv: bool = False   # exact-cost mode (dry-run costing only)
    loss_chunk: int = 0            # 0 = full logits

    # applicability
    supports_long: bool = False    # sub-quadratic path exists
    notes: str = ""

    # vocab padding (Megatron-style) so the vocab axis shards evenly
    vocab_pad_multiple: int = 256

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    # -- layer pattern ---------------------------------------------------------
    def layer_pattern(self) -> List["LayerKind"]:
        from ..models.transformer import LayerKind
        if self.family == "ssm" and self.xlstm_slstm_every:
            period = []
            for i in range(self.xlstm_slstm_every):
                mixer = "slstm" if i == 0 else "mlstm"
                period.append(LayerKind(mixer, "none" if self.d_ff == 0
                                        else "dense"))
            return period
        if self.family == "hybrid" and self.attn_every_k:
            period = []
            for i in range(self.attn_every_k):
                mixer = ("attn" if i == self.attn_every_k // 2 else "mamba")
                ff = ("moe" if self.moe_experts and
                      i % self.moe_every_k == self.moe_every_k - 1
                      else "dense")
                period.append(LayerKind(mixer, ff))
            return period
        if self.moe_experts:
            ff = "moe"
            if self.moe_every_k > 1:
                period = []
                for i in range(self.moe_every_k):
                    period.append(LayerKind(
                        "attn", "moe" if i % self.moe_every_k ==
                        self.moe_every_k - 1 else "dense"))
                return period
            return [LayerKind("attn", ff)]
        mixer = "attn_cross" if self.enc_dec else "attn"
        return [LayerKind(mixer, "dense")]

    # -- shape applicability ------------------------------------------------------
    def applicable_shapes(self) -> List[str]:
        out = ["train_4k", "prefill_32k", "decode_32k"]
        if self.supports_long:
            out.append("long_500k")
        return out

    # -- reduced smoke variant ------------------------------------------------------
    def smoke(self) -> "ModelConfig":
        pat = len(self.layer_pattern())
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(pat, 2 * pat if self.n_layers >= 2 * pat else pat),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=32,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab=512,
            moe_experts=min(self.moe_experts, 8) if self.moe_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            enc_layers=min(self.enc_layers, 2),
            ssm_expand=2,
            ssm_chunk=16,
            xlstm_chunk=16,
            attn_chunk=32,
            loss_chunk=0,
        )
