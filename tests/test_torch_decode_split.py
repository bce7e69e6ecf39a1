"""Split-KV decode on the CPU: the split count the wrapper picks from the
shapes alone, and the kernel's split-and-combine arithmetic written out in
plain torch (a mirror kept here, not in the package) against the reference's
Pallas decode kernel in interpret mode, in f32 at the reference tests' 2e-5.

The mirror follows ``csrc/decode_attention.cu`` step by step: scores in the
log2 domain, 16 KB tiles cut into four warp slices that each keep their own
online softmax, the slices merged at the end of a split, a split that starts
at or past ``lengths[b]`` giving ``(m, l) = (NEG_INF, 0)``, and the splits
combined in order."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels.decode_attention import (BLOCKS_PER_SM, SPLIT_MIN_KEYS,
                                                  decode_splits, split_span)

RNG = np.random.default_rng(0)
NEG_INF = -1.0e38          # the kernels' sentinel
LOG2E = 1.4426950408889634
N_SM = 132                 # one H100 SXM


def arr(*s, scale=0.5):
    return RNG.normal(size=s, scale=scale).astype(np.float32)


# ------------------------------------------------------------ split count --
@pytest.mark.parametrize("K,T,extra", [(8, 8192, 0), (8, 4688, 1), (1, 300, 7),
                                       (32, 100_000, 0)])
def test_one_split_when_rows_fill_the_card(K, T, extra):
    B = BLOCKS_PER_SM * N_SM // K + extra
    assert decode_splits(B, K, T, N_SM) == 1
    assert decode_splits(B - 1 - extra, K, T, N_SM) > 1      # one row short of it


@pytest.mark.parametrize("K,T", [(8, 9136), (8, 4096), (1, 65536), (4, 8192)])
def test_batch_of_one_fills_the_card(K, T):
    n = decode_splits(1, K, T, N_SM)
    assert n * K >= N_SM
    assert (n - 1) * split_span(T, n) < T      # no split is empty by capacity


@pytest.mark.parametrize("seed", range(4))
def test_split_grid_is_never_empty_nor_finer_than_the_least_span(seed):
    rng = np.random.default_rng(seed)
    for _ in range(250):
        B, K = int(rng.integers(1, 300)), int(rng.choice([1, 2, 4, 8, 16]))
        T = int(rng.integers(0, 20_000))
        n = decode_splits(B, K, T, N_SM)
        span = split_span(T, n)
        assert n >= 1 and B * K * n >= 1
        assert n <= max(1, math.ceil(T / SPLIT_MIN_KEYS))
        assert n * span >= T and (n - 1) * span < max(T, 1)
        assert span % 64 == 0 or n == 1


# --------------------------------------------------- split-and-combine mirror --
def _tile_keys(hd, itemsize=4):
    return 16384 // (hd * itemsize)


def split_combine(q, k, v, lengths, splits, span, nw=4):
    """The kernel's arithmetic on f32 tensors: q (B,H,hd), k/v (B,T,K,hd).

    A copy of ``csrc/decode_attention.cu``'s split and combine passes, held
    here to the Pallas kernel.  Nothing ties this copy to the CUDA kernel:
    the split cases of ``tests/test_torch_gpu_kernels.py`` (on the card) are
    what hold the ``.cu`` file.  A change to the kernel's arithmetic updates
    this copy in the same change, or drops it for those GPU cases."""
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    bk = _tile_keys(hd)
    kw = bk // nw
    qs = q.reshape(B, K, G, hd) * (hd ** -0.5 * LOG2E)
    lens = lengths.clamp(max=T)
    ms, ls, os_ = [], [], []
    for s in range(splits):
        start = s * span
        end = torch.minimum(torch.full_like(lens, start + span), lens)   # (B,)
        # per warp slice: running (m, l, acc)
        m = torch.full((nw, B, K, G), NEG_INF)
        l = torch.zeros((nw, B, K, G))
        acc = torch.zeros((nw, B, K, G, hd))
        for t in range(math.ceil(max(0, int(end.max()) - start) / bk)):
            for w in range(nw):
                k0 = start + t * bk + w * kw
                pos = torch.arange(k0, k0 + kw)
                idx = pos.clamp(max=T - 1)
                kt, vt = k[:, idx], v[:, idx]                      # (B,kw,K,hd)
                sc = torch.einsum("bkgd,btkd->bkgt", qs, kt)
                ok = pos[None, :] < end[:, None]                   # (B,kw)
                sc = torch.where(ok[:, None, None, :], sc, torch.tensor(NEG_INF))
                m_new = torch.maximum(m[w], sc.max(-1).values)
                p = torch.where((m_new == NEG_INF)[..., None], torch.tensor(0.0),
                                torch.exp2(sc - m_new[..., None]))
                alpha = torch.where(m[w] == NEG_INF, torch.tensor(0.0),
                                    torch.exp2(m[w] - m_new))
                l[w] = l[w] * alpha + p.sum(-1)
                acc[w] = acc[w] * alpha[..., None] + torch.einsum(
                    "bkgt,btkd->bkgd", p, torch.where(ok[:, :, None, None], vt,
                                                      torch.tensor(0.0)))
                m[w] = m_new
        # merge the warp slices
        M = m.max(0).values
        wt = torch.where(m == NEG_INF, torch.tensor(0.0), torch.exp2(m - M))
        L = (wt * l).sum(0)
        A = (wt[..., None] * acc).sum(0)
        empty = (end <= start)[:, None, None]
        ms.append(torch.where(empty, torch.tensor(NEG_INF), M))
        ls.append(torch.where(empty, torch.tensor(0.0), L))
        os_.append(A)
    # combine the splits in order
    M = torch.stack(ms).max(0).values
    L = torch.zeros_like(M)
    A = torch.zeros_like(os_[0])
    for m, l, a in zip(ms, ls, os_):
        w = torch.where(m == NEG_INF, torch.tensor(0.0), torch.exp2(m - M))
        L = L + w * l
        A = A + w[..., None] * a
    out = torch.where((L == 0)[..., None], torch.tensor(0.0), A / torch.where(
        L == 0, torch.tensor(1.0), L)[..., None])
    return out.reshape(B, H, hd)


@pytest.mark.parametrize("B,T,H,K,hd,lens", [
    (2, 600, 8, 2, 128, [600, 1]),                  # the second row: all but split 0 empty
    (3, 700, 4, 4, 128, [127, 128, 129]),           # on and around the split edge
    (1, 1000, 8, 1, 128, [700]),                    # B = 1 over many splits
    (4, 520, 16, 4, 256, [520, 300, 17, 256]),      # hd 256: 16-key tiles
    (5, 400, 28, 4, 128, [5, 400, 64, 200, 399]),   # G = 7
])
def test_split_and_combine_match_the_pallas_kernel(B, T, H, K, hd, lens):
    q, k, v = arr(B, H, hd), arr(B, T, K, hd), arr(B, T, K, hd)
    lengths = np.asarray(lens, np.int32)
    splits = decode_splits(B, K, T, N_SM)
    span = split_span(T, splits)
    assert splits > 1
    assert any(s * span >= n for n in lens for s in range(splits))  # some split empty
    got = split_combine(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        torch.from_numpy(lengths), splits, span)
    want = ref_ops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(lengths), bk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_split_count_does_not_change_the_result(splits):
    """The same rows through 1, 3 and 8 splits agree at f32 rounding."""
    B, T, H, K, hd = 2, 900, 8, 2, 128
    q, k, v = (torch.from_numpy(a) for a in (arr(B, H, hd), arr(B, T, K, hd),
                                             arr(B, T, K, hd)))
    lengths = torch.tensor([900, 333], dtype=torch.int32)
    one = split_combine(q, k, v, lengths, 1, T)
    got = split_combine(q, k, v, lengths, splits, split_span(T, splits))
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=2e-6, rtol=2e-6)
