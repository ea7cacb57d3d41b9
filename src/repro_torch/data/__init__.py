"""Host-side data for the training launcher: copies of the reference's
JAX-free ``repro.data.synthetic.token_dataset`` and
``repro.data.sampler.GlobalUniformSampler`` (the port imports nothing of
``repro``). The rest of ``repro.data`` (the prefetch loader over the host
FanStore engine) is ROADMAP Queue 1 item 5."""
from repro_torch.data.sampler import GlobalUniformSampler, SamplerState
from repro_torch.data.synthetic import token_dataset

__all__ = ["GlobalUniformSampler", "SamplerState", "token_dataset"]
