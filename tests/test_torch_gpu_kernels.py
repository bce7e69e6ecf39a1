"""The CUDA kernels against their plain PyTorch versions, on the card, at the
reference tests' shapes and tolerances.  These need an NVIDIA GPU and nvcc (a
CUDA kernel has no interpret mode) and skip elsewhere; ``chip_smoke.py`` holds
the same kernels at full width.  Run with ``python -m pytest -m gpu``.

This file imports the port only, so it also runs where jax is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.wkv_chunk import wkv_chunked_plain

pytestmark = pytest.mark.gpu
RNG = np.random.default_rng(0)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the CUDA kernels have no "
                    "interpret mode")
    return "cuda"


def arr(*s, scale=0.5):
    return RNG.normal(size=s, scale=scale).astype(np.float32)


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bf16" \
        else dict(atol=2e-5, rtol=2e-5)


def close(got, want, name):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol(name))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window", [
    (1, 16, 16, 4, 4, 32, True, 0),
    (2, 48, 48, 8, 2, 64, True, 0),
    (1, 33, 33, 4, 1, 64, True, 0),
    (2, 32, 32, 4, 2, 64, True, 12),
    (1, 24, 24, 8, 8, 112, True, 0),
    (1, 16, 16, 4, 4, 32, False, 0),
    (1, 32, 32, 8, 8, 112, True, 8),
    (1, 16, 48, 4, 2, 64, True, 0),
    (1, 200, 333, 4, 2, 256, True, 70),
    (2, 300, 517, 8, 2, 128, True, 0),      # S no multiple of 128, S != T, B = 2
    (1, 400, 400, 4, 2, 128, True, 100),    # window across q-tile and KV-tile edges
    (2, 333, 333, 4, 1, 128, True, 130),
    (1, 400, 400, 4, 1, 256, True, 0),      # hd 256 over 4 q-tiles
    (1, 300, 300, 8, 2, 256, False, 0),
])
def test_flash_attention_kernel(cuda, B, S, T, H, K, hd, causal, window, dtype):
    q, k, v = (from_numpy(a, cuda, DTYPES[dtype]) for a in
               (arr(B, S, H, hd), arr(B, T, K, hd), arr(B, T, K, hd)))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.launch_counts()["flash_attention"] == before + 1
    close(got, ref.flash_attention_ref(q, k, v, causal=causal, window=window),
          dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,T,H,K,hd", [
    (2, 64, 8, 2, 64),
    (1, 100, 4, 4, 32),
    (3, 48, 8, 8, 112),
    (2, 300, 28, 4, 128),
    (2, 130, 16, 1, 256),
])
def test_decode_attention_kernel(cuda, B, T, H, K, hd, dtype):
    q, k, v = (from_numpy(a, cuda, DTYPES[dtype]) for a in
               (arr(B, H, hd), arr(B, T, K, hd), arr(B, T, K, hd)))
    lens = torch.from_numpy(RNG.integers(1, T + 1, B).astype(np.int32)).to(cuda)
    close(ops.decode_attention(q, k, v, lens),
          ref.decode_attention_ref(q, k, v, lens), dtype)
    for fill in (T, 1):                      # whole cache valid; single token
        lens = torch.full((B,), fill, dtype=torch.int32, device=cuda)
        close(ops.decode_attention(q, k, v, lens),
              ref.decode_attention_ref(q, k, v, lens), dtype)


def _split_lengths(case, B, T, K):
    """Lengths that put the edge of a row on and around the split edges."""
    from repro_torch.kernels.decode_attention import decode_splits, split_span
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    splits = decode_splits(B, K, T, n_sm)
    span = split_span(T, splits)
    assert splits > 1, "every case here must run the combine pass"
    if case == "edges":
        base = [span - 1, span, span + 1, 2 * span, T - 1, T]
        return np.resize(np.asarray(base), B)
    if case == "one":
        return np.full(B, 1)
    if case == "full":
        return np.full(B, T)
    if case == "skewed":        # one long row, many of 16-128
        lens = RNG.integers(16, 129, B)
        lens[0] = T - 5
        return lens
    return RNG.integers(1, T + 1, B)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case,B,T,H,K,hd", [
    ("random", 1, 5000, 32, 8, 128),     # B = 1 over many splits
    ("edges", 6, 3000, 32, 8, 128),
    ("one", 2, 6000, 16, 4, 128),        # every split but the first empty
    ("full", 2, 2000, 8, 1, 256),
    ("skewed", 16, 7000, 32, 8, 128),
    ("edges", 3, 1500, 28, 4, 128),      # G = 7
])
def test_decode_attention_kernel_splits(cuda, case, B, T, H, K, hd, dtype):
    """Split-KV decode: the combine pass, empty splits and rows whose end
    falls on, before and after a split edge."""
    q, k, v = (from_numpy(a, cuda, DTYPES[dtype]) for a in
               (arr(B, H, hd), arr(B, T, K, hd), arr(B, T, K, hd)))
    lens = torch.from_numpy(_split_lengths(case, B, T, K).astype(np.int32)).to(cuda)
    before = ops.launch_counts()["decode_attention"]
    got = ops.decode_attention(q, k, v, lens)
    assert ops.launch_counts()["decode_attention"] == before + 1
    close(got, ref.decode_attention_ref(q, k, v, lens), dtype)
    assert torch.equal(got, ops.decode_attention(q, k, v, lens))   # no atomics


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("E,C,din,dout", [
    (2, 32, 64, 64),
    (5, 40, 96, 128),
    (1, 16, 128, 256),
    (3, 24, 32, 48),
    (3, 50, 100, 70),        # widths that are no multiple of 8
    (2, 300, 264, 200),      # several m-tiles, ragged against every tile
])
def test_grouped_gemm_kernel(cuda, E, C, din, dout, dtype):
    x = from_numpy(arr(E, C, din), cuda, DTYPES[dtype])
    w = from_numpy(arr(E, din, dout, scale=0.2), cuda, DTYPES[dtype])
    for sizes in (RNG.integers(0, C + 1, E), np.zeros(E), np.full(E, C)):
        gs = torch.from_numpy(sizes.astype(np.int32)).to(cuda)
        got = ops.grouped_gemm(x, w, gs)
        close(got, ref.grouped_gemm_ref(x, w, gs), dtype)
        for e in range(E):      # rows beyond group size must be exactly zero
            assert bool((got[e, int(sizes[e]):] == 0).all())


def wkv_inputs(B, T, H, hs):
    """r, k, v, decays in the reference test's (0.35, 0.95) band, u."""
    r, k, v = arr(B, T, H, hs), arr(B, T, H, hs), arr(B, T, H, hs)
    w = (1 / (1 + np.exp(-RNG.normal(size=(B, T, H, hs)))) * 0.6
         + 0.35).astype(np.float32)
    return r, k, v, w, arr(H, hs, scale=0.3)


WKV_TOL = {"f32": dict(atol=5e-5, rtol=5e-5), "bf16": dict(atol=5e-2, rtol=5e-2)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,T,H,hs,chunk", [
    (1, 16, 2, 16, 8),
    (2, 32, 3, 16, 8),
    (1, 48, 2, 32, 16),
    (2, 64, 2, 64, 16),       # the served head size
    (1, 40, 3, 24, 8),        # a ragged column tile
])
def test_wkv_chunked_kernel(cuda, B, T, H, hs, chunk, dtype):
    r, k, v, w, u = (from_numpy(a, cuda, DTYPES[dtype])
                     for a in wkv_inputs(B, T, H, hs))
    before = ops.launch_counts()["wkv_chunked"]
    got = ops.wkv_chunked(r, k, v, w, u, chunk=chunk)
    assert ops.launch_counts()["wkv_chunked"] == before + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.wkv_ref(r, k, v, w, u).float().cpu().numpy(),
                               **WKV_TOL[dtype])


@pytest.mark.parametrize("B,T,H,hs,chunk", [(2, 32, 3, 16, 8), (1, 64, 2, 64, 16)])
def test_wkv_chunked_kernel_state_and_strides(cuda, B, T, H, hs, chunk):
    """A non-zero initial state, the final state, inputs read through the
    strides of views, and f32 decays and output beside bf16 streams."""
    r, k, v, w, u = (from_numpy(a, cuda) for a in wkv_inputs(B, T, H, hs))
    s0 = from_numpy(arr(B, H, hs, hs, scale=0.3), cuda)
    wide = torch.cat([r, k, v], dim=-1)             # views with a row stride of 3*hs
    rv, kv, vv = wide[..., :hs], wide[..., hs:2 * hs], wide[..., 2 * hs:]
    y, s = ops.wkv_chunked(rv, kv, vv, w, u, chunk=chunk, state0=s0,
                           return_state=True)
    want_y, want_s = ref.wkv_ref(r, k, v, w, u, state0=s0, return_state=True)
    for got, want in ((y, want_y), (s, want_s)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **WKV_TOL["f32"])
    rb, kb, vb = (x.to(torch.bfloat16) for x in (r, k, v))
    y, s = ops.wkv_chunked(rb, kb, vb, w, u, chunk=chunk, state0=s0,
                           return_state=True, out_dtype=torch.float32)
    assert y.dtype == torch.float32
    want_y, want_s = wkv_chunked_plain(rb, kb, vb, w, u, chunk=chunk, state0=s0,
                                       return_state=True, out_dtype=torch.float32)
    for got, want in ((y, want_y), (s, want_s)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **WKV_TOL["f32"])


def test_misaligned_input_raises(cuda):
    q = torch.zeros((1, 16, 4, 129), device=cuda)[..., 1:]   # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        from repro_torch.kernels.flash_attention import flash_attention
        flash_attention(q, q, q)


def test_empty_shapes_launch_nothing(cuda):
    """No rows, no launch: the counters count launches, not calls."""
    before = ops.launch_counts()
    q = torch.zeros((1, 0, 4, 128), device=cuda)
    kv = torch.zeros((1, 8, 4, 128), device=cuda)
    assert ops.flash_attention(q, kv, kv).shape == (1, 0, 4, 128)
    lens = torch.zeros((0,), dtype=torch.int32, device=cuda)
    assert ops.decode_attention(torch.zeros((0, 4, 128), device=cuda),
                                torch.zeros((0, 8, 4, 128), device=cuda),
                                torch.zeros((0, 8, 4, 128), device=cuda),
                                lens).shape == (0, 4, 128)
    gs = torch.zeros((2,), dtype=torch.int32, device=cuda)
    assert ops.grouped_gemm(torch.zeros((2, 0, 16), device=cuda),
                            torch.zeros((2, 16, 8), device=cuda),
                            gs).shape == (2, 0, 8)
    assert ops.launch_counts() == before
