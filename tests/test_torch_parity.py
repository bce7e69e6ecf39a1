"""Helpers shared by the port's model parity tests (this file holds no tests
of its own): the reference's weights carried across by ``convert``, the
reference smoke test's batches as numpy, the whole-model check (loss and
metrics, prefill logits, prefill + teacher-forced decode) of
``tests/test_torch_models*.py``, and the gradient helpers of
``tests/test_torch_training*.py``."""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import AxisRules as RefAxisRules
from repro.models import build_model as ref_build_model
from repro.models import init_tree as ref_init_tree
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy, lm_params_from_reference
from repro_torch.models import AxisRules, build_model
from repro_torch.models.common import tree_leaves, tree_map

B = 2
TOL = dict(atol=2e-5, rtol=2e-5)
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)   # tests/test_models_smoke.py's gate


def batch_for(cfg, rng, S):
    """The reference smoke test's batches, as numpy."""
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.encoder_layers:
        frames = rng.normal(size=(B, S, cfg.frontend_dim)).astype(np.float32)
        return {"frames": frames, "tokens": toks, "labels": toks}
    if cfg.frontend == "patch":
        emb = rng.normal(size=(B, 4, cfg.d_model)).astype(np.float32)
        return {"tokens": toks[:, 4:], "embeds": emb, "labels": toks}
    return {"tokens": toks, "labels": toks}


@functools.lru_cache(maxsize=None)
def ref_params(arch, seed=1):
    """The reference's init_tree(PRNGKey(seed)) for the smoke config, made once
    per arch (eager jax init is the slow part of these tests)."""
    rmodel = ref_build_model(ref_get_config(arch, smoke=True), RefAxisRules(None))
    return ref_init_tree(jax.random.PRNGKey(seed), rmodel.pds(), jnp.float32)


def both(arch, options=None):
    """(port cfg, port model, reference model, reference params, params as
    numpy) for the smoke config, on the same weights."""
    cfg, rcfg = get_config(arch, smoke=True), ref_get_config(arch, smoke=True)
    rmodel = ref_build_model(rcfg, RefAxisRules(None, options))
    rparams = ref_params(arch)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    model = build_model(cfg, AxisRules(None, options),
                        params=lm_params_from_reference(cfg, tree, "cpu"))
    return cfg, model, rmodel, rparams, tree


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def case_id(arch, options):
    o = options or {}
    return f"{arch}-{o.get('rwkv_impl') or o.get('attn_impl') or 'base'}"


@torch.no_grad()
def check_model_matches_reference(arch, options):
    """Loss and every metric, all prefill logits, and a prefilled prefix
    decoded teacher-forced, against the reference at 2e-5; the decoded logits
    against the port's own full prefill at 2e-3."""
    cfg, model, rmodel, rparams, _ = both(arch, options)
    rng = np.random.default_rng(1)
    # chunked WKV needs lengths its chunk divides: 16 tokens, 8 prefilled
    S_all = 16 if options and "rwkv_chunk" in options else 12
    batch = batch_for(cfg, rng, S_all)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = from_numpy(batch, "cpu")
    toks = batch["tokens"]
    S_txt = toks.shape[1]
    k = S_txt - 3 if S_all == 12 else 8
    off = 4 if cfg.frontend == "patch" else 0
    inputs = {n: v for n, v in batch.items() if n != "labels"}

    # forward loss and every metric
    want_loss, want_m = jax.jit(rmodel.loss)(rparams, jb)
    got_loss, got_m = model.loss(tb)
    np.testing.assert_allclose(f32(got_loss), f32(want_loss), **TOL)
    assert set(got_m) == set(want_m)
    for name in want_m:
        np.testing.assert_allclose(f32(got_m[name]), f32(want_m[name]), **TOL,
                                   err_msg=name)

    # prefill, all logits
    want_full, _ = jax.jit(functools.partial(rmodel.prefill, all_logits=True))(
        rparams, {n: jb[n] for n in inputs})
    got_full, _ = model.prefill({n: tb[n] for n in inputs}, all_logits=True)
    np.testing.assert_allclose(f32(got_full), f32(want_full), **TOL)

    # prefill a prefix, then decode the rest teacher-forced
    pre = dict(inputs, tokens=toks[:, :k])
    _, rcache = jax.jit(functools.partial(rmodel.prefill, cache_len=S_txt + off))(
        rparams, {n: jnp.asarray(v) for n, v in pre.items()})
    _, cache = model.prefill(from_numpy(pre, "cpu"), cache_len=S_txt + off)
    decode = jax.jit(rmodel.decode)
    for t in range(k, S_txt):
        want, rcache = decode(rparams, rcache, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t + off))
        got, cache = model.decode(cache, torch.from_numpy(toks[:, t:t + 1]), t + off)
        np.testing.assert_allclose(f32(got), f32(want), **TOL)
        np.testing.assert_allclose(f32(got[:, 0]), f32(got_full[:, t + off]),
                                   **DECODE_TOL)


# ------------------------------------------------------------- gradients --
def leaf_paths(tree, prefix=""):
    """(``/a/0/b``, leaf) over nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def leaf_errors(got_tree, want_tree):
    """{leaf: (max|got - want|, max|want|)} over matching leaves."""
    want = dict(leaf_paths(want_tree))
    got = dict(leaf_paths(got_tree))
    assert set(got) == set(want)
    return {path: (float(np.abs(f32(got[path]) - f32(w)).max()),
                   float(np.abs(f32(w)).max())) for path, w in want.items()}


def assert_grads_close(got_tree, want_tree, spread=None):
    """Every leaf within 2e-5 of that leaf's largest reference gradient.

    ``spread``, where given, is the reference's own f32 spread at each leaf
    (the distance between its gradients through two implementations of the
    same function).  A leaf past 2e-5 then passes only within twice that
    spread, and is named in a warning."""
    bad, shown = [], []
    for path, (err, scale) in leaf_errors(got_tree, want_tree).items():
        if err <= TOL["atol"] * scale:
            continue
        line = f"{path}: max|dg| {err:.3e}, max|g| {scale:.3e}"
        if spread is not None and err <= 2 * spread[path]:
            shown.append(f"{line}, reference's own spread {spread[path]:.3e}")
        else:
            bad.append(line)
    assert not bad, "\n".join(bad)
    if shown:
        warnings.warn("gradients past 2e-5 at the reference's own rounding "
                      "spread:\n" + "\n".join(shown))


def port_grads(model, batch):
    """(loss, metrics, gradient tree in the layout of ``model.pds()``)."""
    model.requires_grad_(True)
    for p in tree_leaves(model.param_tree()):
        p.grad = None
    loss, metrics = model.loss(batch)
    loss.backward()
    return loss, metrics, tree_map(lambda p: p.grad, model.param_tree())


def ref_grads(rmodel, rparams, batch):
    """(loss, metrics, gradient tree) of the reference on numpy ``batch``."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), g = jax.jit(jax.value_and_grad(rmodel.loss, has_aux=True))(
        rparams, jb)
    return loss, metrics, g


def as_port_tree(cfg, ref_tree):
    """A tree in the reference's layout (parameters, or their gradients) in
    the port's, as ``convert`` carries parameters across."""
    return lm_params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, ref_tree), "cpu")
