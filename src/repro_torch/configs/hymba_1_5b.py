"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16
[arXiv:2411.13676]. SWA (1024) everywhere except 3 full-attention layers
(first / middle / last) -> sub-quadratic, long_500k RUNS.
25 heads do not divide the 16-way model axis -> uneven head sharding.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", hybrid=True,
    num_layers=32, d_model=1600, vocab_size=32001,
    num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504, window=1024, global_layers=(0, 15, 31),
    ssm_state=16, ssm_conv=4, ssm_expand=2, dt_rank=100,
    rope="full", rope_theta=10_000.0,
)

SMOKE = CONFIG.scaled(num_layers=4, d_model=64, vocab_size=128,
                      num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                      window=32, global_layers=(0, 3), dt_rank=8)
