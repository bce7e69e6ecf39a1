"""The port's cost extraction (``repro_torch.launch.hlo_cost``) against the
reference's.

Half (a), the HLO text parser, is the reference's copied: the reference's
fixture tests run through it, and on compiled text of the reference's own
test functions it gives the reference's totals to the byte.  Half (b), the
counter, runs torch functions once on fake tensors: its flops for the three
reference ops equal ``analyze`` of the same ops compiled by XLA, to 1e-9.
Its bytes follow its own model (eager ops, none fused), so they are held to
the band measured on a CPU at the reference's f32 shapes, ``BYTES_BAND``:
naive attention writes its score matrices at every step, which XLA fuses,
and the grouped GEMM's einsum is one op either way.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R_ref
from repro.launch import hlo_cost as R
from repro_torch.kernels import ops, ref as T_ref, wkv_chunk
from repro_torch.launch import hlo_cost as T
from repro_torch.models.common import TensorSpec

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny.hlo")


@pytest.fixture(scope="module")
def tiny_hlo():
    with open(FIXTURE) as f:
        return f.read()


# --------------------------------------------- (a) the parser, the fixture --
def test_fixture_parse_structure(tiny_hlo):
    comps = T.parse_hlo(tiny_hlo)
    assert set(comps) == {"main", "body", "cond", "add", "fused_add"}
    by_op = {i.op: i for i in comps["main"].instrs}
    assert by_op["while"].trip_count == 5
    assert sorted(by_op["while"].called) == ["body", "cond"]
    assert by_op["fusion"].called == ["fused_add"]
    assert by_op["all-reduce"].called == ["add"]
    root = [i for i in comps["main"].instrs if i.is_root]
    assert len(root) == 1 and root[0].op == "copy"
    dot = [i for i in comps["body"].instrs if i.op == "dot"][0]
    assert dot.out_shapes == [("f32", [8, 16])]


def test_fixture_analyze_totals(tiny_hlo):
    costs = T.analyze(tiny_hlo)
    assert costs["flops"] == pytest.approx(5 * 4096)
    assert costs["collective_bytes"] == pytest.approx(512)
    assert costs["coll_all-reduce"] == pytest.approx(512)
    assert costs["bytes"] == pytest.approx(5 * 2048 + 1536 + 1024 + 1024)
    assert costs == R.analyze(tiny_hlo)


def test_fixture_entry_selection_and_override(tiny_hlo):
    full = T.analyze(tiny_hlo)
    body_only = T.analyze(tiny_hlo, entry="body")
    assert body_only["flops"] == pytest.approx(4096)
    assert body_only["collective_bytes"] == 0.0
    assert full["flops"] == pytest.approx(5 * body_only["flops"])


def test_fixture_roofline_terms(tiny_hlo):
    costs = T.analyze(tiny_hlo)
    terms = T.roofline_terms(costs, n_chips=1, peak_flops=1e12,
                             hbm_bw=1e11, ici_bw=1e10)
    assert terms["t_compute_s"] == pytest.approx(20480 / 1e12)
    assert terms["t_memory_s"] == pytest.approx(13824 / 1e11)
    assert terms["t_collective_s"] == pytest.approx(512 / 1e10)
    assert terms["bottleneck"] == "memory"
    assert terms == R.roofline_terms(costs, n_chips=1, peak_flops=1e12,
                                     hbm_bw=1e11, ici_bw=1e10)


def _scan(x, ws):
    y, _ = jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)
    return y


def _nested(x):
    def outer(c, _):
        y, _ = jax.lax.scan(lambda c, _: (jnp.tanh(c @ c), None), c, None, length=3)
        return y, None
    return jax.lax.scan(outer, x, None, length=4)[0]


def _ys(x):
    return jax.lax.scan(lambda c, _: (jnp.tanh(c), jnp.tanh(c)), x, None, length=64)[1]


@pytest.mark.parametrize("fn,shapes", [
    (_scan, [(64, 128), (6, 128, 128)]),
    (_nested, [(16, 16)]),
    (_ys, [(256, 256)]),
    (lambda a, b: a @ b, [(32, 64), (64, 48)]),
], ids=["scan", "nested_scan", "dus_ys", "dot"])
def test_parser_equals_reference_on_compiled_text(fn, shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    text = jax.jit(fn).lower(*args).compile().as_text()
    assert T.analyze(text) == R.analyze(text)


# ------------------------------------------------------- (b) the counter --
def _specs(*shapes, dtype=torch.float32):
    return [TensorSpec(s, dtype) for s in shapes]


def test_dot_flops_exact():
    c = T.count(lambda a, b: a @ b, *_specs((32, 64), (64, 48)), device="cpu")
    assert c["flops"] == 2 * 32 * 64 * 48
    # reads both operands, writes the product
    assert c["bytes"] == 4 * (32 * 64 + 64 * 48 + 32 * 48)
    assert c["collective_bytes"] == 0


def test_python_loop_counts_every_iteration():
    """The torch analogue of ``test_scan_flops_match_unrolled``: eager runs
    each iteration, so N products count N times with no correction."""
    N = 6

    def f(x, ws):
        for i in range(N):
            x = torch.tanh(x @ ws[i])
        return x
    c = T.count(f, *_specs((64, 128), (N, 128, 128)), device="cpu")
    assert c["flops"] == N * 2 * 64 * 128 * 128
    assert c["transcendentals"] == N * 64 * 128


def test_nested_loops_multiply_trip_counts():
    """The analogue of ``test_nested_scan_multiplies_trip_counts``."""
    def f(x):
        for _ in range(4):
            for _ in range(3):
                x = torch.tanh(x @ x)
        return x
    c = T.count(f, *_specs((16, 16)), device="cpu")
    assert c["flops"] == 12 * 2 * 16 * 16 * 16


def test_slice_writes_not_quadratic():
    """The analogue of ``test_dus_bytes_not_quadratic``: N slices written
    into a preallocated (N, D, D) buffer are charged per slice."""
    N, D = 64, 256

    def f(x):
        buf = torch.empty((N, D, D))
        for i in range(N):
            x = torch.tanh(x)
            buf[i] = x
        return buf
    c = T.count(f, *_specs((D, D)), device="cpu")
    whole = N * D * D * 4
    assert c["bytes"] < 8 * whole
    # each write: 3x the slice, as a dynamic-update-slice; each tanh 2x
    assert c["bytes"] == N * (3 + 2) * D * D * 4


def test_byte_rules():
    def f(x, idx):
        v = x.t().unsqueeze(0)[0, :8]         # views: free
        e = torch.empty((64, 64))             # an allocation: free
        g = x[idx]                            # a gather: 2x its output
        return v, e, g, x.clone()             # a copy: read + write
    c = T.count(f, TensorSpec((64, 64), torch.float32),
                TensorSpec((16,), torch.int64), device="cpu")
    assert c["bytes"] == 2 * 16 * 64 * 4 + 2 * 64 * 64 * 4
    assert c["flops"] == 0


def test_real_tensors_are_taken_in_as_fake():
    a, b = torch.ones(8, 4), torch.ones(4, 2)
    seen = []
    T.count(lambda a, b: seen.append(type(a @ b).__name__), a, b, device="cpu")
    assert seen == ["FakeTensor"]


def test_peak_bytes_follow_storage_lifetimes():
    mode = T.fake_mode()
    with mode:
        x = torch.empty((256, 256))
        with T.Counter() as c:
            y = x * 2              # 256 KiB live
            z = y * 2              # 512 KiB
            del y                  # 256 KiB
            w = z + 1              # 512 KiB again
            del z, w
    assert c.peak_bytes == 2 * 256 * 256 * 4
    assert c.live_bytes == 0


def test_sharded_matmul_counts_an_eighth_per_device():
    """On a fake world of 8, (2, 4): (M, K) rows over "data" times (K, N)
    columns over "model" is one local product of 1/8 the flops.  The ops
    DTensor runs on global shapes to learn the output's metadata are not
    counted, and a replicated product counts whole, once."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    M, K, N = 64, 32, 128
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        mode = T.fake_mode()
        with mode:
            a = DTensor.from_local(torch.empty(M // 2, K), mesh, (Shard(0), Replicate()),
                                   run_check=False)
            b = DTensor.from_local(torch.empty(K, N // 4), mesh, (Replicate(), Shard(1)),
                                   run_check=False)
            ra = DTensor.from_local(torch.empty(M, K), mesh, (Replicate(),) * 2,
                                    run_check=False)
            rb = DTensor.from_local(torch.empty(K, N), mesh, (Replicate(),) * 2,
                                    run_check=False)
            with T.Counter() as sharded:
                y = a @ b
            with T.Counter() as replicated:
                ra @ rb
    assert tuple(y.to_local().shape) == (M // 2, N // 4)
    assert sharded.flops == 2 * M * K * N / 8
    assert replicated.flops == 2 * M * K * N
    assert sharded.totals()["collective_bytes"] == 0


def test_collectives_by_kind():
    """A redistribution is counted at its output's bytes under ``analyze``'s
    kind names; the wait on it costs nothing."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    with fake_world(4):
        mesh = make_mesh((4,), ("model",), "cpu")
        with T.fake_mode():
            x = DTensor.from_local(torch.empty(8, 16), mesh, (Shard(0),),
                                   run_check=False)
            with T.Counter() as c:
                x.redistribute(mesh, (Replicate(),))
    assert c.totals()["coll_all-gather"] == 32 * 16 * 4
    assert c.totals()["collective_bytes"] == 32 * 16 * 4


# ------------------------------------------- the three reference ops --
# (port bytes / reference bytes), measured on the CPU (torch 2.13, jax 0.9)
# at these f32 shapes: 0.94, 1.48 and 1.56 for prefill (at the smallest
# shape XLA's module moves more than the port's ops), 1.61 and 1.63 for
# decode, 1.0003 and 1.0021 for the grouped GEMM (the port's mask is an op of
# its own, which XLA fuses into the product's consumer).
BYTES_BAND = {"prefill": (0.9, 1.6), "decode": (1.6, 1.7), "grouped": (1.0, 1.003)}
OPS = [
    ("prefill", (1, 64, 4, 16), (1, 64, 4, 16), True, 0),
    ("prefill", (1, 256, 8, 64), (1, 256, 2, 64), True, 0),
    ("prefill", (1, 128, 4, 32), (1, 256, 2, 32), True, 64),
    ("decode", (16, 32, 128), (16, 256, 8, 128), None, None),
    ("decode", (4, 8, 64), (4, 128, 2, 64), None, None),
    ("grouped", (8, 64, 256), (8, 256, 512), None, None),
    ("grouped", (4, 32, 64), (4, 64, 128), None, None),
]


def _both(kind, a, b, causal, window):
    f32 = jnp.float32
    if kind == "prefill":
        args = [jax.ShapeDtypeStruct(s, f32) for s in (a, b, b)]
        rfn = lambda q, k, v: R_ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        tfn = lambda q, k, v: T_ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        specs = _specs(a, b, b)
    elif kind == "decode":
        args = [jax.ShapeDtypeStruct(s, f32) for s in (a, b, b)] + [
            jax.ShapeDtypeStruct((a[0],), jnp.int32)]
        rfn, tfn = R_ref.decode_attention_ref, T_ref.decode_attention_ref
        specs = _specs(a, b, b) + [TensorSpec((a[0],), torch.int32)]
    else:
        args = [jax.ShapeDtypeStruct(s, f32) for s in (a, b)] + [
            jax.ShapeDtypeStruct((a[0],), jnp.int32)]
        rfn, tfn = R_ref.grouped_gemm_ref, T_ref.grouped_gemm_ref
        specs = _specs(a, b) + [TensorSpec((a[0],), torch.int32)]
    ref = R.analyze(jax.jit(rfn).lower(*args).compile().as_text())
    return ref, T.count(tfn, *specs, device="cpu")


@pytest.mark.parametrize("kind,a,b,causal,window", OPS,
                         ids=[f"{o[0]}-{o[1]}-{o[2]}" for o in OPS])
def test_reference_ops_flops_equal_and_bytes_in_band(kind, a, b, causal, window):
    ref, port = _both(kind, a, b, causal, window)
    assert port["flops"] == pytest.approx(ref["flops"], rel=1e-9)
    lo, hi = BYTES_BAND[kind]
    assert lo <= port["bytes"] / ref["bytes"] <= hi


# ------------------------------------------------ the kernel's fake path --
def _wkv_fake(device):
    B, T_, H, hs = 1, 64, 4, 16
    mode = T.fake_mode()
    with mode:
        r, k, v = (torch.empty((B, T_, H, hs), dtype=torch.bfloat16, device=device)
                   for _ in range(3))
        w = torch.empty((B, T_, H, hs), device=device)
        u = torch.empty((H, hs), device=device)
        s0 = torch.empty((B, H, hs, hs), device=device)
        before = ops.launch_counts()
        with T.Counter() as c:
            y, s = ops.wkv_chunked(r, k, v, w, u, chunk=16, state0=s0,
                                   return_state=True, out_dtype=torch.float32)
    nbytes = sum(t.numel() * t.element_size() for t in (r, k, v, w, u, s0, y, s))
    return c, before, (y, s), nbytes


def test_kernel_on_fake_cuda_tensors_is_one_op_charged_as_the_kernel():
    """A fake CUDA tensor (a dry run) reaches the op ``repro_torch::wkv_chunked``
    in the kernel's place: nothing runs, no launch is counted, and the
    counter charges the operations the kernel's roofline bound counts and
    the bytes of its inputs and outputs."""
    c, before, (y, s), nbytes = _wkv_fake("cuda")
    assert dict(c.kernels) == {"wkv_chunked": 1}
    assert c.flops == wkv_chunk.operations(1, 64, 4, 16, 16)
    assert c.bytes == nbytes
    assert ops.launch_counts() == before
    assert y.shape == (1, 64, 4, 16) and y.dtype == torch.float32
    assert s.shape == (1, 4, 16, 16)


def test_kernel_on_fake_cpu_tensors_runs_the_plain_version():
    """On a CPU tensor, fake or not, the wrapper's choice is the plain
    version, and the counter counts its ops."""
    c, _, _, nbytes = _wkv_fake("cpu")
    assert not c.kernels
    assert c.flops > 0 and c.bytes > nbytes


def test_kernel_op_on_real_cpu_tensors_is_the_wrapper():
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn((1, 32, 2, 16), generator=g) for _ in range(3))
    w = torch.rand((1, 32, 2, 16), generator=g) * 0.6 + 0.35
    u = torch.randn((2, 16), generator=g)
    y, s = torch.ops.repro_torch.wkv_chunked(r, k, v, w, u, None, 16, torch.float32)
    want_y, want_s = ops.wkv_chunked(r, k, v, w, u, chunk=16, return_state=True,
                                     out_dtype=torch.float32)
    np.testing.assert_array_equal(y.numpy(), want_y.numpy())
    np.testing.assert_array_equal(s.numpy(), want_s.numpy())
