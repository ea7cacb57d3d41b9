"""Backward of the Mamba-1 selective scan (K3b) for ssm and hybrid training.

Wrapper of ``csrc/ssm_scan_bwd.cu``. It has no TPU twin: the JAX package
differentiates its lax scan (``repro.models.mamba.selective_scan``) with
``jax.grad``. It launches the CUDA kernels on CUDA tensors and refuses
anything else; the plain version is ``kernels.ref.ssm_scan_bwd_ref``, and
``kernels.ops.SelectiveScan`` picks between them by the tensors' device.
``ssm_scan_bwd.launches`` counts calls that launch (each call is the main
kernel and the small kernel that sums its partials).

Contract: K3's inputs (u, dt (B, T, D) and b_in, c_in (B, T, S) in one
dtype, bf16 or f32; a_log (D, S) and d_skip (D,) in one dtype, bf16 or f32;
1 <= S <= 16), dy (B, T, D) f32, the cotangent of K3's f32 y, and dh_final
(B, D, S) f32 or None (a zero cotangent of h_final); ``h_checkpoints``,
what ``kernels.ssm_scan.ssm_scan(..., checkpoints=True)`` returned for these
inputs (h after every 8th step that a step follows), from which the kernel
recomputes the states in between. Every tensor is contiguous and 16-byte
aligned. Returns (du, ddt, dB, dC) in u's dtype and (da_log, dD) in a_log's.
Two calls on the same inputs give the same bits (no atomics).

The design (the source's header has the numbers): past its exps, what
bounds a backward scan on an H100 is the instruction rate and the queue of
shared-memory and shuffle instructions its sums go through. So a lane holds
4 states of one channel in registers (4 lanes a channel, 8 channels a warp,
8 warps a block), sums over states (du, ddt) and over a warp's channels (dB,
dC) are shuffles, and the warps' dB, dC meet in shared memory once a chunk
of 16 steps, the blocks' in a second kernel. The walk recomputes each half
chunk's ā and h from the forward kernel's checkpoints into registers (one
exp an update) and walks it backwards. Each warp stages its own inputs and
syncs with itself; the one wait across warps is an mbarrier on the block's
dB, dC. ``plan`` is the
launch: the grid, what a block and a lane take, the shared memory and the
f32 scratch the wrapper allocates; the kernel refuses a plan that does not
match its source. ``lane_states``, ``channel``, ``reduced_state``,
``ck_offset`` and ``part_bc_offset`` are the kernel's index arithmetic,
which ``tests/test_torch_ssm_bwd_plan.py`` holds on the CPU.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

MAX_STATE = 16
CHUNK = 16                  # steps a chunk of the reverse walk stages (csrc: K)
CKPT = 8                    # steps between the checkpoints of h (csrc: H)
STATES_PER_LANE = 4         # csrc: NJ
LANES_PER_CHANNEL = MAX_STATE // STATES_PER_LANE
CHANNELS_PER_WARP = 32 // LANES_PER_CHANNEL
WARPS = 8
THREADS = 32 * WARPS
BLOCK_CHANNELS = CHANNELS_PER_WARP * WARPS      # csrc: CB
BLOCKS_PER_SM = 1           # the main kernel's registers (255 a thread)
NRED = 3                    # chunks of the warps' dB, dC in flight (csrc: NRED)
# csrc: sizeof(Smem): each warp's staging, the warps' dB, dC, their du, ddt
# and the mbarriers, in bytes
_WARP_STAGE = CHUNK * CHANNELS_PER_WARP * 16 + CHUNK * (8 * MAX_STATE + 4) * 4
SMEM_BYTES = -(-(WARPS * _WARP_STAGE
                 + NRED * WARPS * CHUNK * 2 * MAX_STATE * 4
                 + WARPS * CHUNK * 2 * CHANNELS_PER_WARP * 4 + NRED * 8) // 16) * 16
_IS_BF16 = {torch.bfloat16: 1, torch.float32: 0}


@dataclass(frozen=True)
class Plan:
    """The main kernel's launch for (B, T, D, S) and its f32 buffers (in
    elements): ``ck``, the checkpoints it reads, h after every CKPT-th step
    that a step follows (16 states a channel); the scratch the wrapper
    allocates, ``part_bc`` each block's dB and dC of every step, ``part_da``
    and ``part_dd`` each batch row's da_log and dD sums."""
    grid: Tuple[int, int]           # (blocks along D, batch rows)
    threads: int
    smem_bytes: int
    block_channels: int
    lanes_per_channel: int
    states_per_lane: int
    ck: int
    part_bc: int
    part_da: int
    part_dd: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    def waves(self, sms: int = 132, blocks_per_sm: int = BLOCKS_PER_SM) -> int:
        """Rounds of blocks the card runs, ``blocks_per_sm`` at a time on
        each of ``sms`` SMs (an H100 SXM has 132)."""
        return -(-self.blocks // (sms * blocks_per_sm))


def plan(b: int, t: int, d: int, s: int) -> Plan:
    """The launch plan of ``ssm_scan_bwd`` for u of shape (b, t, d) and S = s."""
    nblk = -(-d // BLOCK_CHANNELS)
    return Plan(grid=(nblk, b), threads=THREADS, smem_bytes=SMEM_BYTES,
                block_channels=BLOCK_CHANNELS,
                lanes_per_channel=LANES_PER_CHANNEL,
                states_per_lane=STATES_PER_LANE,
                ck=(t - 1) // CKPT * b * d * MAX_STATE, part_bc=2 * nblk * b * t * s,
                part_da=b * d * s, part_dd=b * d)


def lane_states(lane: int) -> Tuple[int, Tuple[int, ...]]:
    """(channel of the warp, the state of each register) of ``lane``: lane
    4 c + ls holds channel c and, in register j, state 4 ls + (j ^ (c & 3))."""
    c, ls = divmod(lane, LANES_PER_CHANNEL)
    return c, tuple(STATES_PER_LANE * ls + (j ^ (c & 3))
                    for j in range(STATES_PER_LANE))


def channel(block: int, warp: int, lane: int) -> int:
    """The channel (index into D) that ``lane`` of ``warp`` of a block holds."""
    return block * BLOCK_CHANNELS + warp * CHANNELS_PER_WARP + lane // LANES_PER_CHANNEL


def ck_offset(m: int, row: int, ch: int, lane: int, b: int, d: int) -> int:
    """Where the 4 states of ``lane`` (of channel ``ch``, batch row ``row``)
    of h after step CKPT (m + 1) - 1 go, in floats (state order)."""
    return ((m * b + row) * d + ch) * MAX_STATE + STATES_PER_LANE * (
        lane % LANES_PER_CHANNEL)


def reduced_state(lane: int) -> Tuple[int, int]:
    """(quantity, state) that ``lane`` holds after the dB, dC shuffle rounds
    (quantity 0 is dB, 1 is dC)."""
    c, ls = divmod(lane, LANES_PER_CHANNEL)
    return c >> 2, STATES_PER_LANE * ls + (c & 3)


def part_bc_offset(q: int, block: int, row: int, step: int, state: int,
                   nblk: int, b: int, t: int, s: int) -> int:
    """Where ``block`` writes its sum of quantity ``q`` (0 dB, 1 dC) of
    (``row``, ``step``, ``state``), in floats."""
    return (q * nblk + block) * b * t * s + (row * t + step) * s + state


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssm_scan_bwd")
    fn = lib.ssm_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    occ = lib.ssm_scan_bwd_blocks_per_sm
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    return lib


def blocks_per_sm(in_bf16: bool = True, vec: bool = True) -> int:
    """Blocks of the main kernel one SM of the current card holds (the CUDA
    occupancy calculator, for the instance that bf16 or f32 inputs and D a
    multiple of 4 or not select)."""
    n = ctypes.c_int(0)
    _build.check(_lib().ssm_scan_bwd_blocks_per_sm(int(in_bf16), int(vec),
                                                   ctypes.byref(n)),
                 "ssm_scan_bwd occupancy")
    return n.value


def ssm_scan_bwd(u: torch.Tensor, dt: torch.Tensor, b_in: torch.Tensor,
                 c_in: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
                 dy: torch.Tensor, dh_final: Optional[torch.Tensor] = None, *,
                 h_checkpoints: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Returns (du, ddt, dB, dC, da_log, dD); see the module's contract."""
    args = (u, dt, b_in, c_in, a_log, d_skip, dy, h_checkpoints)
    every = args + (() if dh_final is None else (dh_final,))
    if not (u.is_cuda and all(x.device == u.device for x in every)):
        raise ValueError("ssm_scan_bwd kernel needs every input on one CUDA "
                         f"device (got {[str(x.device) for x in every]})")
    if (u.dtype not in _IS_BF16 or any(x.dtype != u.dtype for x in args[1:4])
            or a_log.dtype not in _IS_BF16 or d_skip.dtype != a_log.dtype
            or any(x.dtype != torch.float32 for x in every[6:])):
        raise ValueError("u, dt, b_in, c_in must share dtype bf16 or f32, "
                         "a_log, d_skip likewise, and dy, dh_final, h_checkpoints "
                         "be f32; got "
                         f"{[str(x.dtype) for x in every]}")
    if u.dim() != 3 or b_in.dim() != 3:
        raise ValueError("u and b_in must be 3-D (B, T, D) and (B, T, S)")
    b, t, d = u.shape
    s = b_in.shape[-1]
    want = [(b, t, d), (b, t, d), (b, t, s), (b, t, s), (d, s), (d,), (b, t, d),
            (max(t - 1, 0) // CKPT, b, d, MAX_STATE), (b, d, s)]
    if any(tuple(x.shape) != w for x, w in zip(every, want)):
        raise ValueError(f"shapes {[tuple(x.shape) for x in every]} do not "
                         f"match u {(b, t, d)} with S={s}")
    if not 1 <= s <= MAX_STATE:
        raise ValueError(f"S must be in 1..{MAX_STATE}, got {s}")
    if not all(x.is_contiguous() for x in every):
        raise ValueError("ssm_scan_bwd inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in every):
        raise ValueError("ssm_scan_bwd inputs must be 16-byte aligned")
    dev = u.device
    outs = (torch.empty_like(u), torch.empty_like(dt), torch.empty_like(b_in),
            torch.empty_like(c_in), torch.empty_like(a_log),
            torch.empty_like(d_skip))
    if u.numel() == 0:                  # nothing to launch: no step, no channel
        for x in outs:
            x.zero_()
        return outs
    pl = plan(b, t, d, s)
    f32 = dict(dtype=torch.float32, device=dev)
    part_bc, part_da, part_dd = (torch.empty(max(1, n), **f32) for n in (
        pl.part_bc, pl.part_da, pl.part_dd))
    err = _lib().ssm_scan_bwd_launch(
        *(x.data_ptr() for x in args[:7]),
        None if dh_final is None else dh_final.data_ptr(),
        *(x.data_ptr() for x in outs),
        h_checkpoints.data_ptr() if h_checkpoints.numel() else None,
        part_bc.data_ptr(), part_da.data_ptr(), part_dd.data_ptr(), b, t, d, s,
        _IS_BF16[u.dtype], _IS_BF16[a_log.dtype], pl.grid[0], pl.threads,
        pl.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ssm_scan_bwd")
    ssm_scan_bwd.launches += 1
    return outs


ssm_scan_bwd.launches = 0
