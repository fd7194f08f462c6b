"""Architecture configuration of the language-model zoo, the port of
``repro.models.config``: the same dataclasses, fields and defaults, so a
configuration carries across field by field.

Fields that only steer XLA or a device mesh (``attn_bp_axes``,
``attn_batch_parallel``) are kept for that equality and read by nothing
here. ``attn_logits_bf16`` is read by ``models.layers._sdpa``: it keeps the
materialized (decode and chunked-prefill) attention scores in the
activations' dtype, as the reference's; ``block_attention`` ignores it. So is ``use_pallas_ssd``: the port's Mamba2 mixer
always calls ``repro_torch.kernels.ssd_scan.ssd_chunked``, which launches
the hand-written kernel on a CUDA tensor and takes its plain version on a
CPU tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["MoEConfig", "MLAConfig", "SSMConfig", "ArchConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0          # shared (always-on) experts, deepseek-style
    d_expert: int = 0          # expert FFN hidden dim (0 => use d_ff)
    capacity_factor: float = 1.0
    router_aux_weight: float = 0.01
    group_size: int = 0        # >0: dispatch in token groups of this size.
                               # The one-hot dispatch einsum costs
                               # O(L * C) ~ O(L^2 * topk / E) per batch row;
                               # grouping makes it O(L * group_size * topk / E).


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128       # N
    head_dim: int = 64         # P
    n_groups: int = 1          # B/C groups (GVA-style)
    chunk: int = 256           # SSD chunk length
    d_conv: int = 4
    expand: int = 2            # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # Layer pattern within one scanned block; the model is `block_pattern`
    # repeated n_layers/len(block_pattern) times. Entries: "attn" | "mamba".
    block_pattern: Sequence[str] = ("attn",)
    # Which pattern slots are MoE ("moe") vs dense ("dense"); same length as
    # block_pattern, or a single-element tuple broadcast to all slots.
    ffn_pattern: Sequence[str] = ("dense",)
    attn_type: str = "gqa"             # "gqa" | "mla"
    qkv_bias: bool = False
    head_dim: int = 0                   # 0 => d_model // n_heads
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    enc_dec: bool = False               # seamless: encoder-decoder
    n_enc_layers: int = 0               # encoder layers when enc_dec
    frontend: str = "none"              # "none" | "vision" | "audio" (stubs)
    frontend_tokens: int = 256          # patches/frames prepended (stub)
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    sliding_window: int = 0             # 0 = full attention
    tie_embeddings: bool = False
    use_pallas_ssd: bool = False        # kept equal to the reference's; the
                                        # port reads it nowhere: the SSD always
                                        # runs the kernel on the card
    attn_logits_bf16: bool = False      # beyond-paper perf option: keep the
                                        # (L x L) attention logits in bf16
                                        # (max-subtraction still exact),
                                        # halving the dominant score bytes
    attn_bp_axes: tuple = ("data", "model")  # axes for batch-parallel attention
    attn_batch_parallel: bool = False   # beyond-paper perf option: when
                                        # n_heads % model-axis != 0, compute
                                        # attention batch-parallel over
                                        # (data, model) and keep only FFN
                                        # tensor-parallel (see dist/sharding)
    citation: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_blocks(self) -> int:
        if self.n_layers % len(self.block_pattern):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} not divisible by "
                             f"pattern {len(self.block_pattern)}")
        return self.n_layers // len(self.block_pattern)

    @property
    def is_ssm_only(self) -> bool:
        return all(k == "mamba" for k in self.block_pattern)

    @property
    def has_attention(self) -> bool:
        return any(k == "attn" for k in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True when long-context decode is natively cheap: SSM/hybrid (the
        cache does not grow with context for mamba layers) or an explicit
        sliding window."""
        return self.is_ssm_only or ("mamba" in self.block_pattern) or self.sliding_window > 0

    def with_sliding_window(self, window: int) -> "ArchConfig":
        return dataclasses.replace(self, sliding_window=window)

    def ffn_kind(self, slot: int) -> str:
        if len(self.ffn_pattern) == 1:
            return self.ffn_pattern[0]
        return self.ffn_pattern[slot]

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs and memory napkin)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim_
        total = v * d  # embed
        if not self.tie_embeddings:
            total += d * v  # lm head
        kinds = list(self.block_pattern)
        for slot, kind in enumerate(kinds):
            per = 0
            if kind == "attn":
                if self.attn_type == "mla":
                    m = self.mla
                    qd = self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                    per += d * qd
                    per += d * (m.kv_lora_rank + m.qk_rope_dim)
                    per += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                    per += self.n_heads * m.v_head_dim * d
                else:
                    per += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    per += self.n_heads * hd * d
            else:  # mamba
                s = self.ssm
                d_in = s.expand * d
                n_h = d_in // s.head_dim
                per += d * (2 * d_in + 2 * s.n_groups * s.state_dim + n_h)  # in_proj
                per += d_in * d  # out_proj
                per += s.d_conv * (d_in + 2 * s.n_groups * s.state_dim)
                per += 3 * n_h  # A_log, D, dt_bias
            fk = self.ffn_kind(slot)
            if fk == "none":
                per += d  # only norm1
                total += per * self.n_blocks
                continue
            if fk == "moe":
                mo = self.moe
                de = mo.d_expert or ff
                per += d * mo.n_experts  # router
                per += (mo.n_experts + mo.n_shared) * 3 * d * de
            elif fk == "dense":
                per += 3 * d * ff  # swiglu
            per += 2 * d  # norms
            total += per * self.n_blocks
        if self.enc_dec:
            # encoder layers: attn + dense ffn (+ cross-attn in decoder counted above? keep simple)
            per = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
            per += 3 * d * ff + 2 * d
            total += per * self.n_enc_layers
            # decoder cross-attention
            total += (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                      + self.n_heads * hd * d + d) * self.n_layers
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        mo = self.moe
        de = mo.d_expert or self.d_ff
        n_moe_slots = sum(1 for s in range(len(self.block_pattern)) if self.ffn_kind(s) == "moe")
        inactive = (mo.n_experts - mo.top_k) * 3 * self.d_model * de
        return int(full - inactive * n_moe_slots * self.n_blocks)
