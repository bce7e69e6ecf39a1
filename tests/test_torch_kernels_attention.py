"""The port's attention wrappers on CPU (their plain PyTorch versions, behind
the same pad-and-rescale as on the card) against the reference's Pallas
kernels in interpret mode and the reference's jnp oracles, at the reference's
own shape lists.  Inputs come from numpy and go to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.convert import from_numpy
from repro_torch.kernels import ops, ref

RNG = np.random.default_rng(0)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def arr(*s, scale=0.5):
    return RNG.normal(size=s, scale=scale).astype(np.float32)


def tol(name):
    # the reference tests' gate: tests/test_kernels.py::tol
    return dict(atol=2e-2, rtol=2e-2) if name == "bf16" \
        else dict(atol=2e-5, rtol=2e-5)


def both(name, *arrays):
    jd, td = DTYPES[name]
    return ([jnp.asarray(a, jd) for a in arrays],
            [from_numpy(a, "cpu", td) for a in arrays])


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window", [
    (1, 16, 16, 4, 4, 32, True, 0),      # MHA causal
    (2, 48, 48, 8, 2, 64, True, 0),      # GQA
    (1, 33, 33, 4, 1, 64, True, 0),      # MQA, ragged seq vs block
    (2, 32, 32, 4, 2, 64, True, 12),     # sliding window
    (1, 24, 24, 8, 8, 112, True, 0),     # kimi head_dim 112 (pad path)
    (1, 16, 16, 4, 4, 32, False, 0),     # bidirectional (encoder)
    (1, 32, 32, 8, 8, 112, True, 8),     # pad path + sliding window
    (1, 16, 48, 4, 2, 64, True, 0),      # S != T (q chunk over longer KV)
])
def test_flash_attention_matches_reference(B, S, T, H, K, hd, causal, window,
                                           dtype):
    (jq, jk, jv), (tq, tk, tv) = both(dtype, arr(B, S, H, hd),
                                      arr(B, T, K, hd), arr(B, T, K, hd))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              bq=16, bk=16)
    assert got.shape == (B, S, H, hd) and got.dtype == tq.dtype
    kernel = ref_ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                     bq=16, bk=16)
    oracle = ref_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                         window=window)
    np.testing.assert_allclose(f32(got), f32(kernel), **tol(dtype))
    np.testing.assert_allclose(f32(got), f32(oracle), **tol(dtype))
    plain = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(f32(plain), f32(oracle), **tol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,T,H,K,hd", [
    (2, 64, 8, 2, 64),
    (1, 100, 4, 4, 32),
    (3, 48, 8, 8, 112),
])
def test_decode_attention_matches_reference(B, T, H, K, hd, dtype):
    (jq, jk, jv), (tq, tk, tv) = both(dtype, arr(B, H, hd), arr(B, T, K, hd),
                                      arr(B, T, K, hd))
    lens = RNG.integers(1, T + 1, B).astype(np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens), bk=32)
    assert got.shape == (B, H, hd) and got.dtype == tq.dtype
    kernel = ref_ops.decode_attention(jq, jk, jv, jnp.asarray(lens), bk=32)
    oracle = ref_ref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    np.testing.assert_allclose(f32(got), f32(kernel), **tol(dtype))
    np.testing.assert_allclose(f32(got), f32(oracle), **tol(dtype))


@pytest.mark.parametrize("fill", ["full", "one"])
def test_decode_attention_length_edges(fill):
    """lengths == T (whole cache valid) and lengths == 1 (single token)."""
    B, T, H, K, hd = 2, 48, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = both("f32", arr(B, H, hd), arr(B, T, K, hd),
                                      arr(B, T, K, hd))
    lens = np.full((B,), T if fill == "full" else 1, np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens), bk=16)
    kernel = ref_ops.decode_attention(jq, jk, jv, jnp.asarray(lens), bk=16)
    oracle = ref_ref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    np.testing.assert_allclose(f32(got), f32(kernel), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(f32(got), f32(oracle), atol=2e-5, rtol=2e-5)


def test_flash_vs_decode_consistency():
    """decode(q over cache) == last row of causal flash with same data."""
    B, T, H, K, hd = 1, 32, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = both("f32", arr(B, T, H, hd),
                                      arr(B, T, K, hd), arr(B, T, K, hd))
    full = ops.flash_attention(tq, tk, tv, causal=True)
    got = ops.decode_attention(tq[:, -1], tk, tv,
                               torch.tensor([T], dtype=torch.int32), bk=16)
    np.testing.assert_allclose(f32(got), f32(full[:, -1]), atol=2e-5, rtol=2e-5)
    want = ref_ref.flash_attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(f32(got), f32(want[:, -1]), atol=2e-5, rtol=2e-5)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A wrapper picks the plain version by the tensor's device alone: for a
    tensor that is not on the CPU it goes for the kernel, and where that
    cannot be built or launched it raises instead of stepping down."""
    from repro_torch.kernels import flash_attention as fa

    def boom(*a, **k):
        raise AssertionError("plain version used for a non-CPU tensor")
    monkeypatch.setattr(fa, "flash_attention_plain", boom)
    q = torch.zeros((1, 16, 4, 128), device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    assert fa.flash_attention.launches == 0
