"""The schedule of the bf16 attention backward kernel (K2b), on the CPU.

``kernels/flash_attn_bwd.py`` holds a twin of the kernel's index
arithmetic: the order in which the work counter hands out items (128 keys
of one kv head and batch row and one slice of its group's query heads, by
ascending key tile), the 64-row query tiles each item walks, and the chain
of key tiles that add to each dQ tile in a fixed order (the first stores,
the last converts to bf16). These tests hold it, over the card tests'
backward shapes and the two training-size shapes, to a brute-force reading
of the attention mask, and check that no chain can deadlock and that the
items balance over the card's 132 SMs.
"""
import heapq

import numpy as np
import pytest

from repro_torch.kernels import flash_attn_bwd as k2b

# b, t, h, kv, window, causal: BWD_SHAPES of tests/test_torch_cuda.py (the
# head dim plays no part in the schedule), then chatglm3-6b's and
# hymba-1.5b's training-size shapes
SHAPES = [
    (1, 64, 4, 4, None, True),
    (2, 80, 4, 2, 24, True),
    (1, 300, 10, 2, 100, True),
    (1, 200, 32, 2, None, True),
    (1, 1500, 25, 5, 1024, True),
    (2, 129, 16, 1, 50, True),
    (1, 100, 4, 2, None, False),
    (1, 100, 4, 2, 30, False),
    (1, 2048, 32, 2, None, True),
    (2, 333, 8, 2, 40, True),
    (2, 37, 8, 2, None, True),
    (4, 2048, 8, 4, None, True),
    (4, 2048, 32, 2, None, True),
    (4, 2048, 25, 5, 1024, True),
]
SMS = 132


def live_tiles(t, causal, window):
    """(query tile, key tile) -> whether any (q, k) pair in it is live, by
    the mask itself."""
    q = np.arange(t)[:, None]
    k = np.arange(t)[None, :]
    mask = np.ones((t, t), dtype=bool)
    if causal:
        mask &= k <= q
    if window:
        mask &= q - k < window
    nq, nk = k2b.n_tiles(t, k2b.TILE_Q), k2b.n_tiles(t, k2b.TILE_K)
    pad = np.zeros((nq * k2b.TILE_Q, nk * k2b.TILE_K), dtype=bool)
    pad[:t, :t] = mask
    return pad.reshape(nq, k2b.TILE_Q, nk, k2b.TILE_K).any(axis=(1, 3))


def contributions(b, t, h, kv, window, causal):
    """{(batch, head, query tile): [(key tile, item index), ...]} in the
    order the items are handed out."""
    out = {}
    for w, (kt, bi, kvh, sl) in enumerate(k2b.items(b, t, kv, h // kv)):
        for qt, head in k2b.item_steps(kt, kvh, sl, h // kv, t, causal, window):
            out.setdefault((bi, head, qt), []).append((kt, w))
    return out


@pytest.mark.parametrize("b,t,h,kv,window,causal", SHAPES)
def test_items_walk_exactly_the_live_tiles(b, t, h, kv, window, causal):
    live = live_tiles(t, causal, window)
    g = h // kv
    assert sorted(i for sl in k2b.slices(g) for i in sl) == list(range(g))
    order = k2b.items(b, t, kv, g)
    assert [kt for kt, _, _, _ in order] == sorted(kt for kt, _, _, _ in order)
    assert len(set(order)) == len(order) == (k2b.n_tiles(t, k2b.TILE_K) * b * kv
                                             * len(k2b.slices(g)))
    for kt, _, kvh, sl in order:
        steps = k2b.item_steps(kt, kvh, sl, g, t, causal, window)
        assert sorted(steps) == sorted((qt, kvh * g + i) for qt in np.flatnonzero(live[:, kt])
                                       for i in k2b.slices(g)[sl])
        qts = [qt for qt, _ in steps]
        assert qts == sorted(qts, reverse=True)          # the last query tile first


@pytest.mark.parametrize("b,t,h,kv,window,causal", SHAPES)
def test_dq_chains_are_ordered_and_cannot_deadlock(b, t, h, kv, window, causal):
    live = live_tiles(t, causal, window)
    chains = contributions(b, t, h, kv, window, causal)
    assert len(chains) == b * h * k2b.n_tiles(t, k2b.TILE_Q)   # every dQ tile has one
    for (_, _, qt), links in chains.items():
        lo, hi = k2b.dq_chain(qt, t, causal, window)
        kts = [kt for kt, _ in links]
        # each live key tile adds once; the first stores, the last converts
        assert sorted(kts) == list(range(lo, hi + 1)) == list(np.flatnonzero(live[qt]))
        # every link waits only for an item the counter handed out earlier
        handed = dict(links)
        for kt in range(lo + 1, hi + 1):
            assert handed[kt - 1] < handed[kt]


def lpt_share(works, machines):
    """Share of the ideal time that list scheduling in the given order
    reaches: total / (machines x makespan)."""
    free = [0] * machines
    for w in works:
        heapq.heappush(free, heapq.heappop(free) + w)
    return sum(works) / (machines * max(free))


@pytest.mark.parametrize("b,t,h,kv,window,causal,least", [
    (4, 2048, 32, 2, None, True, 0.95),         # chatglm3-6b training
    (4, 2048, 25, 5, 1024, True, 0.95),         # hymba-1.5b's shape
])
def test_items_balance_over_the_card(b, t, h, kv, window, causal, least):
    g = h // kv
    works = [len(k2b.item_steps(kt, kvh, sl, g, t, causal, window))
             for kt, _, kvh, sl in k2b.items(b, t, kv, g)]
    assert lpt_share(works, SMS) >= least


def test_whole_group_items_would_not_balance():
    """The reason an item takes one slice of the group's heads: 128-key
    items over all 16 heads of chatglm3-6b's group give 128 items for 132
    SMs, and the longest is ~2x the mean."""
    works = [16 * (32 - 2 * kt) for kt in range(16) for _ in range(8)]
    assert lpt_share(works, SMS) < 0.6
