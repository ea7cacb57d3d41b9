"""chatglm3-6b [dense] — GLM block with 2d (half-dim) RoPE, GQA kv=2.

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024 [arXiv:2406.12793].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, vocab_size=65024,
    num_heads=32, num_kv_heads=2, head_dim=128,
    d_ff=13696, rope="half", rope_theta=10_000.0, qkv_bias=True,
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, vocab_size=128,
                      num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128)
