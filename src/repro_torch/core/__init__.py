"""Device-resident FanStore tier on one card.

  * ``device_store`` — the dataset as fixed-size records in device memory.
  * ``fetch``        — batched, capacity-bounded gather of records by index,
    plus the record decoders (token bitcast, block dequant).
  * ``codec``        — host-side block quantization and its NumPy oracle.
"""
from repro_torch.core.codec import block_dequantize_host, block_quantize
from repro_torch.core.device_store import DeviceStore, DeviceStoreConfig
from repro_torch.core.fetch import (decode_records, make_fetch_fn,
                                    tokens_from_payload)

__all__ = ["DeviceStore", "DeviceStoreConfig", "make_fetch_fn",
           "tokens_from_payload", "decode_records", "block_quantize",
           "block_dequantize_host"]
