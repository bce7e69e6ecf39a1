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



def _library_plan(dtype_code, E, C, din, dout, n_sm, aligned=True):
    """The launch the C side makes, as frontier_grouped_gemm_plan reports it."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.grouped_gemm import GemmPlan
    out = (ctypes.c_int * 6)()
    _build.load().frontier_grouped_gemm_plan(dtype_code, E, C, din, dout, n_sm,
                                             int(aligned), out)
    return GemmPlan("wgmma" if out[0] == 1 else "fma", *out[1:])


def test_grouped_gemm_plan_matches_the_library(cuda):
    """The Python mirror of the launch plan is the C launcher's own."""
    from repro_torch.kernels.grouped_gemm import grouped_plan
    for code in (0, 1):
        for E, C, din, dout in ((8, 2416, 4096, 14336), (8, 112, 4096, 14336),
                                (8, 9136, 14336, 4096), (3, 50, 100, 70),
                                (1, 16, 128, 256), (384, 64, 7168, 2048),
                                (9000, 16, 64, 64), (2, 32, 0, 64)):
            for n_sm in (132, 7):
                for aligned in (True, False):
                    assert (_library_plan(code, E, C, din, dout, n_sm, aligned)
                            == grouped_plan(code, E, C, din, dout, n_sm, aligned))


@pytest.mark.parametrize("case,E,C,din,dout,sizes", [
    ("more tiles than SMs", 8, 512, 256, 2048, None),
    ("din % 64 != 0", 3, 130, 200, 264, [130, 64, 1]),
    ("last m-tile partly live", 2, 200, 128, 512, [200, 150]),
    ("full expert beside an empty one", 4, 256, 64, 256, [256, 0, 256, 0]),
    ("odd m-tile counts", 3, 384, 64, 512, [384, 129, 1]),
    ("dout past the last panel", 2, 96, 64, 328, [96, 17]),
])
def test_grouped_gemm_kernel_persistent(cuda, case, E, C, din, dout, sizes):
    """The persistent bf16 kernel: tiles walked by fewer blocks than tiles,
    TMA's zero fill past din, C and dout, rows past the group size exactly 0,
    the dead region zeroed, and the same bits from two calls (no atomics)."""
    from repro_torch.kernels.grouped_gemm import grouped_plan
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = grouped_plan(1, E, C, din, dout, n_sm)
    assert plan.path == "wgmma"
    if sizes is None:
        assert E * -(-C // plan.bm) * -(-dout // plan.bn) > n_sm == plan.blocks
        sizes = RNG.integers(C // 2, C + 1, E)
    x = from_numpy(arr(E, C, din), cuda, torch.bfloat16)
    w = from_numpy(arr(E, din, dout, scale=0.2), cuda, torch.bfloat16)
    gs = torch.from_numpy(np.asarray(sizes, np.int32)).to(cuda)
    before = ops.launch_counts()["grouped_gemm"]
    got = ops.grouped_gemm(x, w, gs)
    assert ops.launch_counts()["grouped_gemm"] == before + 1
    close(got, ref.grouped_gemm_ref(x, w, gs), "bf16")
    for e, n in enumerate(sizes):
        assert bool((got[e, int(n):] == 0).all())
    assert torch.equal(got, ops.grouped_gemm(x, w, gs))


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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T,chunk", [(512, 8), (768, 16), (512, 32), (1024, 64)])
def test_wkv_chunked_kernel_long(cuda, T, chunk, dtype):
    """Many chunks through the prep ring at the served head size, every chunk
    length the wrapper takes, from a non-zero state to the final one."""
    B, H, hs = 1, 3, 64
    r, k, v, w, u = (from_numpy(a, cuda) for a in wkv_inputs(B, T, H, hs))
    s0 = from_numpy(arr(B, H, hs, hs, scale=0.3), cuda)
    r, k, v = (x.to(DTYPES[dtype]) for x in (r, k, v))
    before = ops.launch_counts()["wkv_chunked"]
    y, s = ops.wkv_chunked(r, k, v, w, u, chunk=chunk, state0=s0,
                           return_state=True, out_dtype=torch.float32)
    assert ops.launch_counts()["wkv_chunked"] == before + 1
    want = {"plain": wkv_chunked_plain(r, k, v, w, u, chunk=chunk, state0=s0,
                                       return_state=True, out_dtype=torch.float32),
            "sequential": ref.wkv_ref(r, k, v, w, u, state0=s0, return_state=True)}
    for got, (want_y, want_s) in ((y, want["plain"]), (y, want["sequential"])):
        for g, wnt in ((got, want_y), (s, want_s)):
            np.testing.assert_allclose(g.float().cpu().numpy(),
                                       wnt.float().cpu().numpy(), **WKV_TOL[dtype])


@pytest.mark.parametrize("hs,chunk", [(128, 16), (100, 64), (8, 1)])
def test_wkv_chunked_kernel_widths(cuda, hs, chunk):
    """The wrapper's limits (hs 128, chunk 64), a head size that is no
    multiple of the column tile, and chunks of one step."""
    B, T, H = 2, 128, 2
    r, k, v, w, u = (from_numpy(a, cuda) for a in wkv_inputs(B, T, H, hs))
    y, s = ops.wkv_chunked(r, k, v, w, u, chunk=chunk, return_state=True)
    want_y, want_s = ref.wkv_ref(r, k, v, w, u, return_state=True)
    for got, want in ((y, want_y), (s, want_s)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **WKV_TOL["f32"])


@pytest.mark.parametrize("dtype,offset", [("f32", 1), ("bf16", 2), ("bf16", 1)])
def test_wkv_chunked_kernel_unaligned_views(cuda, dtype, offset):
    """Views that start off a 16-byte boundary (one or two elements in): the
    kernel reads them by plain loads instead of staging them by cp.async."""
    B, T, H, hs = 1, 96, 2, 32
    r, k, v, w, u = (from_numpy(a, cuda) for a in wkv_inputs(B, T, H, hs))
    wide = torch.cat([torch.zeros_like(r[..., :offset]), r, k, v], dim=-1).to(DTYPES[dtype])
    rv, kv, vv = (wide[..., offset + i * hs:offset + (i + 1) * hs] for i in range(3))
    y, s = ops.wkv_chunked(rv, kv, vv, w, u, chunk=16, return_state=True,
                           out_dtype=torch.float32)
    want_y, want_s = wkv_chunked_plain(rv, kv, vv, w, u, chunk=16,
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


def test_wrappers_never_synchronise(cuda):
    """The oracle times these calls back to back: neither wrapper may read a
    device tensor (group_sizes) on the host."""
    E, C, din, dout = 4, 64, 128, 256
    x = from_numpy(arr(E, C, din), cuda, torch.bfloat16)
    w = from_numpy(arr(E, din, dout, scale=0.2), cuda, torch.bfloat16)
    gs = torch.tensor([64, 3, 0, 40], dtype=torch.int32, device=cuda)
    r, k, v, wd, u = (from_numpy(a, cuda) for a in wkv_inputs(1, 64, 2, 64))
    rb, kb, vb = (t.to(torch.bfloat16) for t in (r, k, v))
    s0 = torch.zeros((1, 2, 64, 64), device=cuda)
    ops.grouped_gemm(x, w, gs)                   # the build, outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = ops.grouped_gemm(x, w, gs)
        yw, s = ops.wkv_chunked(rb, kb, vb, wd, u, chunk=16, state0=s0,
                                return_state=True, out_dtype=torch.float32)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    close(y, ref.grouped_gemm_ref(x, w, gs), "bf16")
    want_y, want_s = wkv_chunked_plain(rb, kb, vb, wd, u, chunk=16, state0=s0,
                                       return_state=True, out_dtype=torch.float32)
    np.testing.assert_allclose(yw.cpu().numpy(), want_y.cpu().numpy(), **WKV_TOL["bf16"])
    np.testing.assert_allclose(s.cpu().numpy(), want_s.cpu().numpy(), **WKV_TOL["bf16"])


def grad_cases(cuda):
    """Each wrapper with small f32 inputs on the card, beside its plain
    version: (call, inputs that may require grad)."""
    gs = torch.tensor([5, 0], dtype=torch.int32, device=cuda)
    lens = torch.tensor([9, 4], dtype=torch.int32, device=cuda)
    q, kv = arr(1, 12, 4, 128), arr(1, 12, 2, 128)
    return {
        "flash_attention": (lambda q, k, v: ops.flash_attention(q, k, v),
                            lambda q, k, v: ref.flash_attention_ref(q, k, v, causal=True),
                            [from_numpy(a, cuda) for a in (q, kv, kv)]),
        "decode_attention": (lambda q, k, v: ops.decode_attention(q, k, v, lens),
                             lambda q, k, v: ref.decode_attention_ref(q, k, v, lens),
                             [from_numpy(a, cuda) for a in (arr(2, 4, 128),
                                                            arr(2, 16, 2, 128),
                                                            arr(2, 16, 2, 128))]),
        "grouped_gemm": (lambda x, w: ops.grouped_gemm(x, w, gs),
                         lambda x, w: ref.grouped_gemm_ref(x, w, gs),
                         [from_numpy(a, cuda) for a in (arr(2, 8, 16), arr(2, 16, 8))]),
        "wkv_chunked": (lambda *t: ops.wkv_chunked(*t, chunk=8),
                        lambda *t: ref.wkv_ref(*t),
                        [from_numpy(a, cuda) for a in wkv_inputs(1, 16, 2, 16)]),
    }


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "grouped_gemm", "wkv_chunked"])
def test_wrappers_refuse_inputs_that_require_grad(cuda, name):
    """No kernel has a backward: with grad enabled, an input that requires
    grad raises instead of giving a result detached from the graph; under
    ``torch.no_grad()`` the same call launches and equals the plain version."""
    call, plain, inputs = grad_cases(cuda)[name]
    before = ops.launch_counts()[name]
    for i in range(len(inputs)):
        args = [t.clone().requires_grad_(j == i) for j, t in enumerate(inputs)]
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel has no backward"):
            call(*args)
    assert ops.launch_counts()[name] == before
    args = [t.clone().requires_grad_(True) for t in inputs]
    with torch.no_grad():
        got = call(*args)
    assert ops.launch_counts()[name] == before + 1
    np.testing.assert_allclose(
        got.cpu().numpy(), plain(*inputs).cpu().numpy(),
        **(WKV_TOL["f32"] if name == "wkv_chunked" else tol("f32")))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wkv_chunked_kernel_sharded_over_heads(cuda, dtype):
    """rwkv6's chunked WKV on a mesh: under ``local_map`` each rank of a
    threaded (1, 2) world on the card launches the kernel once on its own
    half of the heads (u and the state split with them), and the gathered
    output and state equal the kernel's on all heads."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import threaded_world
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import AxisRules
    from repro_torch.models.rwkv6 import _wkv

    B, T, H, hs = 2, 64, 4, 64
    r, k, v, w, u = (from_numpy(a, cuda) for a in wkv_inputs(B, T, H, hs))
    r, k, v = (x.to(DTYPES[dtype]) for x in (r, k, v))
    s0 = from_numpy(arr(B, H, hs, hs, scale=0.3), cuda)
    want = _wkv(r, k, v, w, u, s0, AxisRules(None), impl="chunked", chunk=16)
    before = ops.launch_counts()["wkv_chunked"]

    def rank_fn(rank):
        ax = AxisRules(make_mesh((1, 2), ("data", "model"), "cuda"))
        y, s = _wkv(*(ax.replicated(t) for t in (r, k, v, w, u, s0)), ax,
                    impl="chunked", chunk=16)
        return y.full_tensor(), s.full_tensor(), y.to_local().shape[2]

    out = threaded_world(2, rank_fn, cuda)
    assert ops.launch_counts()["wkv_chunked"] == before + 2
    for y, s, heads in out:
        assert heads == H // 2
        for got, wnt in ((y, want[0]), (s, want[1])):
            np.testing.assert_allclose(got.cpu().numpy(), wnt.cpu().numpy(),
                                       **WKV_TOL["f32"])
