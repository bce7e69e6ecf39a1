"""Helpers shared by the port's model parity tests (this file holds no tests
of its own): the reference's weights carried across by ``convert``, the
reference smoke test's batches as numpy, and the whole-model check (loss and
metrics, prefill logits, prefill + teacher-forced decode) of
``tests/test_torch_models*.py``."""
import functools

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
