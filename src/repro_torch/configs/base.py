"""Model/config schema — a copy of ``repro.configs.base.ModelConfig``.

The port keeps its own copy (it imports nothing of ``repro``); the fields and
defaults are identical so a config built here equals the reference's field
for field (``tests/test_torch_model.py`` checks that). The ``dense``, ``ssm``
and ``hybrid`` families have a model in this package so far.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    # attention (0s for attention-free families)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope: str = "full"                # full | half | none
    rope_theta: float = 10_000.0
    window: Optional[int] = None      # sliding-window size (SWA layers)
    global_layers: Tuple[int, ...] = ()   # layer ids with full attention
    attn_logit_softcap: float = 0.0
    # mlp
    d_ff: int = 0
    mlp: str = "swiglu"               # swiglu | gelu | sqrelu
    norm: str = "rms"                 # rms | ln
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    experts_top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    router_aux_coef: float = 0.001
    moe_capacity_factor: float = 1.25
    moe_block_tokens: int = 4096
    # MLA (deepseek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0
    # hybrid (hymba)
    hybrid: bool = False
    # audio (musicgen)
    num_codebooks: int = 0
    # vlm (internvl)
    num_patches: int = 0
    # numerics: activations in ``dtype``; parameters stored in
    # ``param_dtype`` and cast to ``dtype`` at every use
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # training-memory policy
    remat: bool = True
    loss_chunk: int = 2048
    attn_scale_in_q: bool = False
    attn_probs_bf16: bool = False
    unroll: bool = False

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def uses_moe(self) -> bool:
        return self.num_experts > 0

    def scaled(self, **overrides) -> "ModelConfig":
        """A copy with fields replaced (smoke sizes, dtype, remat)."""
        return replace(self, **overrides)
