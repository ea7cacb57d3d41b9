"""The launch plan of the selective scan's backward kernel (K3b), on the CPU.

``kernels/ssm_scan_bwd.py`` holds the plan the wrapper passes to the kernel
(the grid, what a block and a lane take, the shared memory, the checkpoints
of h it reads and the scratch the wrapper allocates) and a twin of the
kernel's index arithmetic: the states a lane's registers hold, the
(quantity, state) a lane keeps after the dB, dC shuffle rounds, and where
the checkpoints of h and the per-block dB, dC lie. These tests hold them,
over the card tests' K3b shapes and the two training shapes, to a
brute-force reading: every (b, d, s) is held by one register of one lane,
each shuffle round pairs registers that hold the same state, the partial
sums land on distinct places inside what the wrapper allocates and cover
it, a lane's checkpoints are read from distinct places that cover what the
forward kernel writes, and the waves at the training shapes are those
``PERF.md`` states.
"""
import numpy as np
import pytest

from repro_torch.kernels import ssm_scan as k3
from repro_torch.kernels import ssm_scan_bwd as k3b

# b, t, d, s: SSM_BWD_SHAPES and the other K3b shapes of
# tests/test_torch_cuda.py, then falcon-mamba-7b's and hymba-1.5b's training
# shapes
SHAPES = [
    (2, 64, 64, 16),
    (1, 100, 200, 5),
    (2, 33, 3200, 16),
    (1, 1, 8, 16),
    (1, 517, 70, 1),
    (2, 50, 77, 16),
    (2, 40, 96, 3),
    (1, 70, 130, 7),
    (1, 20, 8192, 16),
    (2, 45, 64, 16),
    (2, 300, 200, 16),
    (1, 100, 77, 5),
    (2, 70, 96, 16),
    (1, 8, 16, 16),
    (4, 2048, 8192, 16),
    (4, 2048, 3200, 16),
]
SMS = 132                   # an H100 SXM
SMEM_LIMIT = 232_448        # shared memory one block may take on it


def holders(b, d, s):
    """(row, channel, state) of every register of every lane of the grid that
    holds one inside the shape, as an (n, 3) array."""
    pl = k3b.plan(b, 1, d, s)
    lanes = np.arange(32)
    regs = np.array([k3b.lane_states(int(ln))[1] for ln in lanes])    # (32, 4)
    blk, warp = np.meshgrid(np.arange(pl.grid[0]), np.arange(k3b.WARPS), indexing="ij")
    ch = (blk[..., None] * k3b.BLOCK_CHANNELS + warp[..., None] * k3b.CHANNELS_PER_WARP
          + lanes // k3b.LANES_PER_CHANNEL)                          # (blk, warp, 32)
    assert np.array_equal(ch[0, 0], [k3b.channel(0, 0, int(ln)) for ln in lanes])
    ch = np.broadcast_to(ch[..., None], ch.shape + (k3b.STATES_PER_LANE,))
    st = np.broadcast_to(regs, ch.shape)
    keep = (ch < d) & (st < s)
    out = [np.stack([np.full(keep.sum(), row), ch[keep], st[keep]], 1) for row in range(b)]
    return np.concatenate(out)


@pytest.mark.parametrize("b,t,d,s", SHAPES)
def test_every_state_is_held_by_one_register(b, t, d, s):
    h = holders(b, d, s)
    key = (h[:, 0] * d + h[:, 1]) * s + h[:, 2]
    assert len(key) == b * d * s and len(np.unique(key)) == b * d * s
    pl = k3b.plan(b, t, d, s)
    assert pl.grid == (-(-d // k3b.BLOCK_CHANNELS), b) and pl.threads == 32 * k3b.WARPS
    assert pl.block_channels == k3b.CHANNELS_PER_WARP * k3b.WARPS
    assert pl.lanes_per_channel * pl.states_per_lane == k3b.MAX_STATE


def test_shuffle_rounds_pair_registers_of_one_state():
    st = {ln: k3b.lane_states(ln) for ln in range(32)}
    for ln, (c, regs) in st.items():
        assert sorted(st[4 * c + q][1][j] for q in range(4) for j in range(4)) == list(range(16))
        # dB, dC round 1 (lane ^ 8): registers 0, 1 keep, 2, 3 of the partner come in
        assert [regs[0], regs[1]] == [st[ln ^ 8][1][2], st[ln ^ 8][1][3]]
        assert st[ln ^ 8][0] == c ^ 2
        # round 2 (lane ^ 4): register 0 keeps, register 1 of the partner comes in
        assert regs[0] == st[ln ^ 4][1][1] and st[ln ^ 4][0] == c ^ 1
        # round 3 (lane ^ 16): the partner holds the same state in register 0
        assert regs[0] == st[ln ^ 16][1][0] and st[ln ^ 16][0] == c ^ 4
        assert k3b.reduced_state(ln) == (c >> 2, regs[0])
        # du, ddt: lanes ^ 2 and ^ 1 hold the other states of the channel
        assert st[ln ^ 2][0] == st[ln ^ 1][0] == c
    assert sorted(k3b.reduced_state(ln) for ln in range(32)) == [
        (q, s) for q in range(2) for s in range(16)]


@pytest.mark.parametrize("b,t,d,s", SHAPES)
def test_partials_and_checkpoints_fill_the_scratch_once(b, t, d, s):
    pl = k3b.plan(b, t, d, s)
    nblk = pl.grid[0]
    # dB, dC: block blk writes every (row, step, state) of its channels' sum
    hit = np.zeros(pl.part_bc, np.uint8)
    rows, steps, states = np.meshgrid(np.arange(b), np.arange(t), np.arange(s),
                                      indexing="ij")
    for q in range(2):
        for blk in range(nblk):
            o = k3b.part_bc_offset(q, blk, rows, steps, states, nblk, b, t, s).ravel()
            assert o.min() >= 0 and o.max() < pl.part_bc
            assert not hit[o].any()
            hit[o] = 1
    assert hit.all()
    # da_log and dD: one place each per (row, channel, state) and (row, channel)
    h = holders(b, d, s)
    da = (h[:, 0] * d + h[:, 1]) * s + h[:, 2]
    assert np.array_equal(np.sort(da), np.arange(pl.part_da))
    assert pl.part_dd == b * d
    # checkpoints, as the forward kernel returns them: every H-th step that
    # a step follows, each lane's 4 registers; slab m holds checkpoint m of
    # every row and channel
    assert k3b.CKPT == k3.CKPT and k3b.MAX_STATE == k3.MAX_STATE
    ckpts = (t - 1) // k3b.CKPT
    slab = b * d * k3b.MAX_STATE
    assert pl.ck == ckpts * slab
    lanes = np.arange(32)
    for m in sorted({0, ckpts // 2, ckpts - 1} & set(range(ckpts))):
        hit = np.zeros(slab, np.uint8)
        for row in range(b):
            for ch0 in range(0, d, k3b.CHANNELS_PER_WARP):
                ch = ch0 + lanes // k3b.LANES_PER_CHANNEL
                ok = ch < d
                o = np.array([k3b.ck_offset(m, row, int(c), int(ln), b, d)
                              for c, ln in zip(ch[ok], lanes[ok])]) - m * slab
                o = (o[:, None] + np.arange(k3b.STATES_PER_LANE)).ravel()
                assert o.min() >= 0 and o.max() < slab and not hit[o].any()
                hit[o] = 1
        assert hit.all()


@pytest.mark.parametrize("shape,blocks,waves", [
    ((4, 2048, 8192, 16), 512, 4),          # falcon-mamba-7b
    ((4, 2048, 3200, 16), 200, 2),          # hymba-1.5b
])
def test_waves_at_the_training_shapes(shape, blocks, waves):
    pl = k3b.plan(*shape)
    assert k3b.BLOCKS_PER_SM == 1
    assert pl.blocks == blocks and pl.waves(SMS) == waves


def test_shared_memory_fits_a_block():
    assert k3b.SMEM_BYTES % 16 == 0 and k3b.SMEM_BYTES <= SMEM_LIMIT
