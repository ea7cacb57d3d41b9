"""falcon-mamba-7b [ssm] — attention-free Mamba-1 LM.

64L d_model=4096 d_ff=0 vocab=65024, ssm_state=16 [arXiv:2410.05355].
Pure SSM decode is O(1)/token, so the long_500k cell RUNS for this arch.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, vocab_size=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2, dt_rank=256,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(num_layers=4, d_model=64, vocab_size=128, dt_rank=8)
