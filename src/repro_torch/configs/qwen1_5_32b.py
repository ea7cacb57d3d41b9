"""qwen1.5-32b [dense] — QKV bias, MHA-ish GQA (kv=40 == heads).

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064 [hf:Qwen/Qwen1.5].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    num_layers=64, d_model=5120, vocab_size=152064,
    num_heads=40, num_kv_heads=40, head_dim=128,
    d_ff=27392, qkv_bias=True, rope="full", rope_theta=1_000_000.0,
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, vocab_size=128,
                      num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128)
