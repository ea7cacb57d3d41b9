"""nemotron-4-15b [dense] — squared-ReLU MLP, LayerNorm, GQA.

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000 [arXiv:2402.16819].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, vocab_size=256000,
    num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=24576, mlp="sqrelu", norm="ln", rope="full", rope_theta=10_000.0,
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, vocab_size=256,
                      num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128)
