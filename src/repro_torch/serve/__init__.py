from repro_torch.serve.serve_step import (generate, make_decode_step,
                                         make_prefill_step)

__all__ = ["generate", "make_decode_step", "make_prefill_step"]
