"""The port's grouped-GEMM wrapper on CPU (its plain PyTorch version) against
the reference's Pallas kernel in interpret mode and the reference's jnp
oracle, at the reference's own shape lists; plus ``convert.from_numpy``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.convert import from_numpy
from repro_torch.kernels import ops

RNG = np.random.default_rng(0)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def arr(*s, scale=0.5):
    return RNG.normal(size=s, scale=scale).astype(np.float32)


def tol(name):
    # the reference tests' gate: tests/test_kernels.py::tol
    return dict(atol=2e-2, rtol=2e-2) if name == "bf16" \
        else dict(atol=2e-5, rtol=2e-5)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("E,C,din,dout", [
    (2, 32, 64, 64),
    (5, 40, 96, 128),
    (1, 16, 128, 256),
])
def test_grouped_gemm_matches_reference(E, C, din, dout, dtype):
    jd, td = DTYPES[dtype]
    x, w = arr(E, C, din), arr(E, din, dout)
    gs = RNG.integers(0, C + 1, E).astype(np.int32)
    got = ops.grouped_gemm(from_numpy(x, "cpu", td), from_numpy(w, "cpu", td),
                           torch.from_numpy(gs))
    assert got.shape == (E, C, dout) and got.dtype == td
    jx, jw, jg = jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(gs)
    kernel = ref_ops.grouped_gemm(jx, jw, jg, bm=16, bn=64, bkk=32)
    oracle = ref_ref.grouped_gemm_ref(jx, jw, jg)
    np.testing.assert_allclose(f32(got), f32(kernel), **tol(dtype))
    np.testing.assert_allclose(f32(got), f32(oracle), **tol(dtype))


@given(st.integers(1, 6).flatmap(
    lambda e: st.tuples(st.just(e),
                        st.lists(st.integers(0, 24), min_size=e, max_size=e))))
@settings(max_examples=10, deadline=None)
def test_grouped_gemm_ragged_property(e_and_sizes):
    E, sizes = e_and_sizes
    C = 24
    x, w = arr(E, C, 32), arr(E, 32, 48)
    gs = np.asarray(sizes, np.int32)
    got = f32(ops.grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(gs)))
    kernel = ref_ops.grouped_gemm(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(gs), bm=8, bn=48, bkk=32)
    np.testing.assert_allclose(got, f32(kernel), atol=2e-5, rtol=2e-5)
    # rows beyond group size must be exactly zero
    for e in range(E):
        assert np.all(got[e, sizes[e]:] == 0.0)


def test_grouped_gemm_all_empty_groups():
    E, C, din, dout = 3, 16, 32, 48
    x, w = arr(E, C, din), arr(E, din, dout)
    gs = torch.zeros((E,), dtype=torch.int32)
    got = ops.grouped_gemm(torch.from_numpy(x), torch.from_numpy(w), gs)
    assert np.all(f32(got) == 0.0)


def test_from_numpy_keeps_structure_and_casts_floats_only():
    tree = {"w": arr(3, 4), "layers": [{"b": arr(2)}, {"ids": np.arange(3)}],
            "pair": (arr(1), "name"), "n": 7}
    out = from_numpy(tree, "cpu", torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16 and out["w"].shape == (3, 4)
    assert out["layers"][0]["b"].dtype == torch.bfloat16
    assert out["layers"][1]["ids"].dtype == torch.int64
    assert isinstance(out["pair"], tuple) and out["pair"][1] == "name"
    assert out["n"] == 7
    same = from_numpy(tree, "cpu")
    np.testing.assert_array_equal(same["w"].numpy(), tree["w"])


def test_launch_counters_count_kernel_launches_only():
    """On the CPU the plain versions run, and no launch is counted."""
    ops.reset_launch_counts()
    x, w = arr(2, 8, 16), arr(2, 16, 8)
    ops.grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                     torch.tensor([8, 3], dtype=torch.int32))
    r = torch.from_numpy(arr(1, 16, 2, 8))
    ops.wkv_chunked(r, r, r, torch.full_like(r, 0.5), torch.zeros((2, 8)))
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "grouped_gemm": 0, "wkv_chunked": 0}
