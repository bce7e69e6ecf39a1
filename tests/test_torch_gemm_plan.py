"""Grouped GEMM on the CPU: the launch the wrapper's library makes, chosen from
the shapes alone (never from ``group_sizes``), and the persistent kernel's
walk over the output written out in numpy (a mirror kept here, not in the
package) to show that every element of ``y`` is written exactly once: by a
live tile's epilogue or by the zero warps.

The mirror follows ``csrc/grouped_gemm.cu``: live m-tiles counted per expert
from the group sizes, tile ``t`` of the walk taken by block ``t % blocks``,
an expert's m-tiles cut into raster groups, within a group the 256-column
panel outer and the 128-row tile inner, and the rows of an expert from its last live m-tile's end to ``C`` zeroed.  The
GPU cases in ``test_torch_gpu_kernels.py`` hold the kernel itself."""
import math

import numpy as np
import pytest

from repro_torch.kernels.grouped_gemm import (SMEM_MAX, WGMMA_BM, WGMMA_BN,
                                              grouped_plan)

N_SM = 132                 # one H100 SXM
F32, BF16 = 0, 1


# ------------------------------------------------------------------- plan --
@pytest.mark.parametrize("E,C,din,dout", [(8, 2416, 4096, 14336),
                                          (8, 112, 4096, 14336),
                                          (8, 9136, 14336, 4096),
                                          (384, 64, 7168, 2048)])
def test_mixtral_and_kimi_widths_fill_the_card(E, C, din, dout):
    plan = grouped_plan(BF16, E, C, din, dout, N_SM)
    assert plan.path == "wgmma"
    assert plan.blocks == N_SM          # one persistent block per SM
    assert (plan.bm, plan.bn) == (WGMMA_BM, WGMMA_BN)
    assert plan.smem <= SMEM_MAX


@pytest.mark.parametrize("E,C,dout", [(1, 16, 256), (2, 128, 512), (4, 300, 264)])
def test_small_problems_launch_no_more_blocks_than_tiles(E, C, dout):
    plan = grouped_plan(BF16, E, C, 64, dout, N_SM)
    tiles = E * math.ceil(C / WGMMA_BM) * math.ceil(dout / WGMMA_BN)
    assert plan.blocks == tiles < N_SM


@pytest.mark.parametrize("code,din,dout,aligned,why", [
    (F32, 4096, 14336, True, "f32 stays true f32 on FMA"),
    (BF16, 100, 64, True, "din no multiple of 8: TMA's 16-byte strides"),
    (BF16, 64, 70, True, "dout no multiple of 8"),
    (BF16, 0, 64, True, "nothing to multiply"),
    (BF16, 64, 64, False, "a pointer off a 16-byte boundary"),
])
def test_fma_grid_where_tma_cannot_go(code, din, dout, aligned, why):
    plan = grouped_plan(code, 3, 50, din, dout, N_SM, aligned)
    assert plan.path == "fma", why
    assert plan.blocks == math.ceil(dout / 64) * math.ceil(50 / 64) * 3
    assert plan.smem == 0 and plan.mgroup == 0


def test_too_many_experts_for_shared_memory_take_the_fma_grid():
    # the per-expert tile counts live in shared memory beside the ring
    fits = (SMEM_MAX - grouped_plan(BF16, 0, 16, 64, 64, N_SM).smem) // 4
    assert grouped_plan(BF16, fits, 16, 64, 64, N_SM).path == "wgmma"
    assert grouped_plan(BF16, fits + 1, 16, 64, 64, N_SM).path == "fma"


def test_plan_follows_the_sm_count():
    assert grouped_plan(BF16, 8, 2416, 4096, 14336, 114).blocks == 114
    assert grouped_plan(BF16, 8, 2416, 4096, 14336, 7).blocks == 7


# ---------------------------------------------------------- walk mirror --
def mtiles(sizes, C):
    """Live m-tiles per expert."""
    return (np.clip(np.asarray(sizes), 0, C) + WGMMA_BM - 1) // WGMMA_BM


def walk(sizes, C, dout, block, blocks, mgroup):
    """The live tiles one block takes, in its order: (expert, m0, n0).  The
    kernel's gg_tile."""
    mt_end = np.cumsum(mtiles(sizes, C))
    n_tiles = math.ceil(dout / WGMMA_BN)
    ex = 0
    for t in range(block, int(mt_end[-1]) * n_tiles, blocks):
        while mt_end[ex] * n_tiles <= t:
            ex += 1
        first = int(mt_end[ex - 1]) if ex else 0
        mt = int(mt_end[ex]) - first
        local = t - first * n_tiles
        grp = local // (mgroup * n_tiles)
        gsz = min(mgroup, mt - grp * mgroup)
        rem = local - grp * mgroup * n_tiles
        yield ex, (grp * mgroup + rem % gsz) * WGMMA_BM, (rem // gsz) * WGMMA_BN


def walk_coverage(sizes, C, dout, blocks, mgroup):
    """How many times the persistent kernel writes each element of y
    (E, C, dout); also the live tiles per block."""
    E = len(sizes)
    mts = mtiles(sizes, C)
    cover = np.zeros((E, C, dout), np.int32)
    per_block = []
    for b in range(blocks):
        tiles = list(walk(sizes, C, dout, b, blocks, mgroup))
        for e, m0, n0 in tiles:
            cover[e, m0:m0 + WGMMA_BM, n0:n0 + WGMMA_BN] += 1
        per_block.append(len(tiles))
    for e in range(E):                    # the zero warps' spans
        cover[e, min(C, int(mts[e]) * WGMMA_BM):] += 1
    return cover, per_block


@pytest.mark.parametrize("seed", range(6))
def test_walk_writes_every_element_once(seed):
    rng = np.random.default_rng(seed)
    E = int(rng.integers(1, 9))
    C = int(rng.integers(1, 700))
    dout = 8 * int(rng.integers(1, 100))
    sizes = rng.integers(-3, C + 40, E)       # negative, empty, past C
    sizes[0] = C if seed % 2 else 0
    blocks = grouped_plan(BF16, E, C, 64, dout, int(rng.integers(1, 20))).blocks
    mgroup = int(rng.integers(1, 5))          # groups that cut experts unevenly
    cover, per_block = walk_coverage(sizes, C, dout, blocks, mgroup)
    assert (cover == 1).all()
    assert max(per_block) - min(per_block) <= 1       # round robin over blocks


def test_walk_keeps_a_panel_across_a_groups_m_tiles():
    """In walk order, a raster group's m-tiles come together under one W
    column panel, so the tiles in flight at once read each panel from HBM
    together, and the group's rows of x stay in L2 while the panels go by."""
    sizes, C, dout = [1000, 37], 1024, 1024       # 8 m-tiles and 1, 4 panels
    order = list(walk(sizes, C, dout, 0, 1, 3))   # groups of 3, 3 and 2
    assert order[:3] == [(0, m * WGMMA_BM, 0) for m in range(3)]
    assert order[3] == (0, 0, WGMMA_BN)
    assert order[12] == (0, 3 * WGMMA_BM, 0)
    assert order[24:26] == [(0, 6 * WGMMA_BM, 0), (0, 7 * WGMMA_BM, 0)]
    assert order[32:] == [(1, 0, n * WGMMA_BN) for n in range(4)]


@pytest.mark.parametrize("din,mgroup", [(4096, 16), (14336, 4), (64, 1024),
                                        (131072, 1)])
def test_raster_group_keeps_its_x_within_16_mb(din, mgroup):
    plan = grouped_plan(BF16, 8, 2416, din, 4096, N_SM)
    assert plan.mgroup == mgroup
    assert plan.mgroup == 1 or plan.mgroup * WGMMA_BM * din * 2 <= 16 << 20
