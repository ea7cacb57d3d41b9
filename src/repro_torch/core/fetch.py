"""Batched sample fetch from the device-resident store.

Counterpart of ``repro.core.fetch``. The dataset is an (S, B) uint8 tensor
of fixed-size records; a step's global batch is a vector of G record
indices; ``fetch`` returns the (G, B) payload batch in index order plus an
overflow flag.

Routing keeps the reference's MoE-style dispatch with storage shards as
"experts" (``repro/core/fetch.py:80-110``): each owner scatters the records
it holds for every requester into a (D, capacity, B) send buffer with
``capacity = ceil(cf * G / D)``, the buffers are exchanged, and each
requester scatters what it received back into batch order. A record past
capacity is dropped: its batch row stays zero and ``overflow`` is set.

This slice runs one card, D = 1, where the exchange is the identity. The
4-card exchange (``torch.distributed.all_to_all_single``) is ROADMAP Queue 1
item M2b.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops


def required_capacity(local_batch: int, num_shards: int,
                      capacity_factor: float) -> int:
    """Per-(owner,requester) record slots: ceil(cf * G_local / D)."""
    return max(1, math.ceil(capacity_factor * local_batch / num_shards))


def make_fetch_fn(*, num_samples: int, sample_bytes: int,
                  capacity_factor: float = 2.0):
    """Build ``fetch(store, idx) -> (batch, overflow)`` for one card.

    store: (S, B) uint8; idx: (G,) integer record ids on the store's device.
    batch: (G, B) uint8; overflow: (1,) bool — one flag per shard.
    """
    D, d = 1, 0                                # shards; this shard's id
    s_local = num_samples // D

    def exchange(t: torch.Tensor) -> torch.Tensor:
        return t                               # all_to_all over D = 1 shard

    def fetch(store: torch.Tensor, idx: torch.Tensor):
        if tuple(store.shape) != (s_local, sample_bytes):
            raise ValueError(f"store shape {tuple(store.shape)} != "
                             f"{(s_local, sample_bytes)}")
        dev = store.device
        idx = idx.to(device=dev, dtype=torch.int64)
        g = idx.shape[0]
        cap = required_capacity(g, D, capacity_factor)
        all_req = idx.reshape(D, g)            # all_gather over D = 1 shard
        owner = all_req // s_local
        mine = owner == d
        local_row = torch.where(mine, all_req - d * s_local, 0)
        payload = store.index_select(0, local_row.reshape(-1))
        payload = payload.reshape(D, g, sample_bytes)
        pos = torch.cumsum(mine.to(torch.int64), dim=1) - 1
        slot = torch.where(mine & (pos < cap), pos, cap)      # cap = drop
        rows = torch.arange(D, device=dev)[:, None].expand(D, g)
        send = torch.zeros((D, cap + 1, sample_bytes), dtype=store.dtype,
                           device=dev)
        send[rows, slot] = payload
        col = torch.arange(g, device=dev)[None].expand(D, g)
        send_slots = torch.full((D, cap + 1), -1, dtype=torch.int64, device=dev)
        send_slots[rows, slot] = col
        recv = exchange(send[:, :cap])
        recv_slots = exchange(send_slots[:, :cap])
        out = torch.zeros((g + 1, sample_bytes), dtype=store.dtype, device=dev)
        tgt = torch.where(recv_slots >= 0, recv_slots, g).reshape(-1)
        out[tgt] = recv.reshape(-1, sample_bytes)
        overflow = (mine.sum(dim=1) > cap).any()
        return out[:g], overflow.reshape(1)

    return fetch


def tokens_from_payload(batch_u8: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Bitcast fetched uint8 records to int32 token sequences (little-endian)."""
    b = batch_u8.shape[0]
    return batch_u8.contiguous().view(torch.int32).reshape(b, seq_len)


def decode_records(batch_u8: torch.Tensor, feature_dim: int, *,
                   qblock: int = 256, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Decode fetched block-quantized records to (G, feature_dim) floats.

    A record is ``feature_dim`` int8 payload bytes followed by
    ``feature_dim // qblock`` f16 scales (as ``codec.block_quantize`` makes
    them); trailing pad bytes are ignored. The decode is the dequant kernel
    on a card (``kernels.ops.dequant``).
    """
    nb = feature_dim // qblock
    q = batch_u8[:, :feature_dim].contiguous().view(torch.int8)
    scales = batch_u8[:, feature_dim:feature_dim + 2 * nb].contiguous()
    return ops.dequant(q, scales.view(torch.float16), qblock=qblock,
                       out_dtype=out_dtype)
