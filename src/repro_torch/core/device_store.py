"""The device-resident dataset — FanStore's "local SSD" tier on one card.

Counterpart of ``repro.core.device_store``. ``DeviceStore`` holds a dataset
of fixed-size sample records as one (num_samples, sample_bytes) uint8
tensor in device memory, plus the fetch function that gathers a batch of
records by index. Records must be fixed-rate: variable-size files are padded
at pack time or block-quantized by ``repro_torch.core.codec`` first.

One card holds the whole store (the reference shards it over a mesh; the
multi-card exchange is a later slice, see ``core.fetch``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.fetch import make_fetch_fn

Records = Union[np.ndarray, torch.Tensor]


@dataclass(frozen=True)
class DeviceStoreConfig:
    num_samples: int
    sample_bytes: int
    capacity_factor: float = 2.0

    def __post_init__(self):
        if self.sample_bytes % 4:
            raise ValueError("sample_bytes must be a multiple of 4 "
                             "(records are bitcast to 4-byte words)")


class DeviceStore:
    """Owns the placement of the dataset tensor and its fetch function."""

    def __init__(self, config: DeviceStoreConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.fetch = make_fetch_fn(num_samples=config.num_samples,
                                   sample_bytes=config.sample_bytes,
                                   capacity_factor=config.capacity_factor)

    def place(self, records: Records) -> torch.Tensor:
        """Move (num_samples, sample_bytes) uint8 records onto the device.

        A tensor already on the device is used as it is (no copy), so a
        store generated on the card is placed for free.
        """
        cfg = self.config
        if tuple(records.shape) != (cfg.num_samples, cfg.sample_bytes):
            raise ValueError(f"records shape {tuple(records.shape)} != "
                             f"{(cfg.num_samples, cfg.sample_bytes)}")
        if isinstance(records, np.ndarray):
            records = torch.from_numpy(np.ascontiguousarray(records, dtype=np.uint8))
        if records.dtype != torch.uint8:
            raise ValueError(f"records must be uint8, got {records.dtype}")
        return records.to(self.device).contiguous()

    def place_tokens(self, tokens: Records) -> torch.Tensor:
        """Place an int32 (num_samples, seq_len) token dataset as records."""
        if isinstance(tokens, np.ndarray):
            tokens = torch.from_numpy(np.ascontiguousarray(tokens, dtype="<i4"))
        if tokens.dtype != torch.int32:
            raise ValueError(f"tokens must be int32, got {tokens.dtype}")
        recs = tokens.contiguous().view(torch.uint8).reshape(tokens.shape[0], -1)
        return self.place(recs)

    @property
    def device_bytes(self) -> int:
        """Bytes of device memory the store occupies."""
        return self.config.num_samples * self.config.sample_bytes
