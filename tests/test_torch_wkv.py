"""The port's chunked-WKV6 wrapper on CPU (its plain PyTorch version) against
the reference's Pallas kernel in interpret mode, the reference's sequential
oracle and the reference model's own ``_wkv_chunked``, at the reference's
shape list.  Inputs come from numpy and go to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import rwkv6 as ref_rwkv6
from repro_torch.convert import from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.wkv_chunk import wkv_chunked_plain
from repro_torch.models import rwkv6

RNG = np.random.default_rng(0)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# the reference kernel test's gate: tests/test_kernels.py
TOL = {"f32": dict(atol=5e-5, rtol=5e-5), "bf16": dict(atol=5e-2, rtol=5e-2)}


def inputs(B, T, H, hs):
    """r, k, v, decays in the reference test's (0.35, 0.95) band, u."""
    r, k, v = (RNG.normal(size=(B, T, H, hs), scale=0.5).astype(np.float32)
               for _ in range(3))
    w = (1 / (1 + np.exp(-RNG.normal(size=(B, T, H, hs)))) * 0.6
         + 0.35).astype(np.float32)
    u = RNG.normal(size=(H, hs), scale=0.3).astype(np.float32)
    return r, k, v, w, u


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,T,H,hs,chunk", [
    (1, 16, 2, 16, 8),
    (2, 32, 3, 16, 8),
    (1, 48, 2, 32, 16),
])
def test_wkv_chunked_matches_reference(B, T, H, hs, chunk, dtype):
    arrays = inputs(B, T, H, hs)
    jd, td = DTYPES[dtype]
    jr, jk, jv, jw, ju = (jnp.asarray(a, jd) for a in arrays)
    tr, tk, tv, tw, tu = (from_numpy(a, "cpu", td) for a in arrays)
    got = ops.wkv_chunked(tr, tk, tv, tw, tu, chunk=chunk)
    assert got.shape == (B, T, H, hs) and got.dtype == td
    kernel = ref_ops.wkv_chunked(jr, jk, jv, jw, ju, chunk=chunk)
    oracle = ref_ref.wkv_ref(jr, jk, jv, jw, ju)
    np.testing.assert_allclose(f32(got), f32(kernel), **TOL[dtype])
    np.testing.assert_allclose(f32(got), f32(oracle), **TOL[dtype])
    seq = ref.wkv_ref(tr, tk, tv, tw, tu)
    np.testing.assert_allclose(f32(seq), f32(oracle), **TOL[dtype])


@pytest.mark.parametrize("B,T,H,hs,chunk", [(2, 32, 3, 16, 8), (1, 48, 2, 32, 16)])
def test_wkv_state_in_and_out_match_reference_model(B, T, H, hs, chunk):
    """A non-zero initial state and the final state, against the reference
    model's ``_wkv_chunked`` (the function the Pallas kernel implements,
    which carries the state the decode cache needs)."""
    r, k, v, w, u = inputs(B, T, H, hs)
    s0 = RNG.normal(size=(B, H, hs, hs), scale=0.3).astype(np.float32)
    want_y, want_s = ref_rwkv6._wkv_chunked(
        *(jnp.asarray(a) for a in (r, k, v, w, u, s0)), chunk=chunk)
    t = [from_numpy(a, "cpu") for a in (r, k, v, w, u, s0)]
    y, s = ops.wkv_chunked(*t[:5], chunk=chunk, state0=t[5], return_state=True)
    np.testing.assert_allclose(f32(y), f32(want_y), **TOL["f32"])
    np.testing.assert_allclose(f32(s), f32(want_s), **TOL["f32"])
    # the sequential oracle, run from the same state, ends in the same place
    ys, ss = ref.wkv_ref(*t[:5], state0=t[5], return_state=True)
    np.testing.assert_allclose(f32(ys), f32(want_y), **TOL["f32"])
    np.testing.assert_allclose(f32(ss), f32(want_s), **TOL["f32"])
    # and so does the port model's own twin of _wkv_chunked
    yt, st = rwkv6._wkv_chunked(*t, chunk=chunk)
    np.testing.assert_allclose(f32(yt), f32(want_y), **TOL["f32"])
    np.testing.assert_allclose(f32(st), f32(want_s), **TOL["f32"])


def test_wkv_output_dtype_and_unclamped_carry():
    """``out_dtype`` keeps f32 out of bf16 inputs; dropping the carry clamp
    changes nothing while a chunk's summed -log w stays under 60."""
    r, k, v, w, u = (from_numpy(a, "cpu") for a in inputs(1, 32, 2, 16))
    rb, kb, vb = (x.to(torch.bfloat16) for x in (r, k, v))
    y = ops.wkv_chunked(rb, kb, vb, w, u, chunk=8, out_dtype=torch.float32)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(
        f32(y), f32(wkv_chunked_plain(rb.float(), kb.float(), vb.float(), w, u,
                                      chunk=8)), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        f32(wkv_chunked_plain(r, k, v, w, u, chunk=8, clamp_carry=False)),
        f32(ops.wkv_chunked(r, k, v, w, u, chunk=8)), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("T,chunk", [(20, 8), (30, 16)])
def test_wkv_chunk_must_divide_length(T, chunk):
    r, k, v, w, u = (from_numpy(a, "cpu") for a in inputs(1, T, 2, 16))
    with pytest.raises(ValueError, match="T % chunk"):
        ops.wkv_chunked(r, k, v, w, u, chunk=chunk)


def test_wkv_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """The plain version is for CPU tensors only: any other device goes for
    the kernel, and where that cannot run the wrapper raises."""
    from repro_torch.kernels import wkv_chunk

    def boom(*a, **k):
        raise AssertionError("plain version used for a non-CPU tensor")
    monkeypatch.setattr(wkv_chunk, "wkv_chunked_plain", boom)
    x = torch.zeros((1, 16, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        wkv_chunk.wkv_chunked(x, x, x, x, torch.zeros((2, 16), device="meta"))
    assert wkv_chunk.wkv_chunked.launches == 0
