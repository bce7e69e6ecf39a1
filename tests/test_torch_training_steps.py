"""The port's AdamW, data and moment descriptors against the JAX trainer's,
in f32 at smoke size: three ``make_train_step``s from the same weights
(``test_torch_parity.both``) on the same numpy batches equal the reference's
on loss, metrics and parameters; ``SyntheticLM`` batches equal the
reference's byte for byte; ``_zero1_pd`` extends a moment's axes as the
reference's does (``tests/test_training.py``'s cases and two more).

Tolerances: 2e-5 (``TOL``) on loss and metrics, 2e-5 absolute on parameters
after the steps, except entries whose gradient was at rounding level
(below).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import (
    TOL, batch_for, both, case_id, f32, as_port_tree, leaf_paths)
from repro.models.common import PD as RefPD
from repro.training.data import DataConfig as RefDataConfig
from repro.training.data import SyntheticLM as RefSyntheticLM
from repro.training.optimizer import AdamW as RefAdamW
from repro.training.optimizer import AdamWConfig as RefAdamWConfig
from repro.training.optimizer import _zero1_pd as ref_zero1_pd
from repro.training.optimizer import make_train_step as ref_make_train_step
from repro_torch.convert import from_numpy
from repro_torch.models.common import PD, tree_leaves
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import (
    AdamW, AdamWConfig, _zero1_pd, make_train_step)

S = 24

STEP_CASES = [("yi-9b", None), ("mixtral-8x7b", None), ("rwkv6-1.6b", None),
              ("seamless-m4t-large-v2", None)]


@pytest.mark.parametrize("arch,options", STEP_CASES,
                         ids=[case_id(a, o) for a, o in STEP_CASES])
def test_three_adamw_steps_match_reference(arch, options):
    """Adam's first steps are nearly ``lr * sign(g)``, so an entry whose
    gradient is at rounding level may step the other way in one package.
    Such entries (the reference's ``|g|`` within the two packages' distance
    at that leaf, at some step) are named in a warning; every other entry
    is held at 2e-5."""
    cfg, model, rmodel, rparams, _ = both(arch, options)
    opt_cfg = dict(lr=1e-3, zero1=False)
    ropt = RefAdamW(RefAdamWConfig(**opt_cfg), rmodel.ax)
    rstep = jax.jit(ref_make_train_step(rmodel, ropt))
    rgrad = jax.jit(jax.grad(lambda p, b: rmodel.loss(p, b)[0]))
    rstate = ropt.init(rparams)
    opt = AdamW(AdamWConfig(**opt_cfg), model.ax)
    model.requires_grad_(True)
    params = model.param_tree()
    state = opt.init(params)
    step = make_train_step(model, opt)
    rng = np.random.default_rng(5)
    unsettled = {}      # leaf -> entries whose gradient sign rounding decides
    for i in range(3):
        batch = batch_for(cfg, rng, S)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want_g = dict(leaf_paths(as_port_tree(cfg, rgrad(rparams, jb))))
        rparams, rstate, want_m = rstep(rparams, rstate, jb)
        params, state, got_m = step(params, state, from_numpy(batch, "cpu"))
        assert set(got_m) == set(want_m)
        for name in want_m:
            np.testing.assert_allclose(f32(got_m[name]), f32(want_m[name]),
                                       **TOL, err_msg=f"step {i}: {name}")
        # make_train_step leaves this step's gradients on the parameters
        for path, p in leaf_paths(params):
            w = f32(want_g[path])
            near = np.abs(w) <= np.abs(f32(p.grad) - w).max()
            unsettled[path] = unsettled.get(path, False) | near
    assert int(state["step"]) == int(rstate["step"]) == 3
    want = dict(leaf_paths(as_port_tree(cfg, rparams)))
    bad, shown = [], []
    for path, p in leaf_paths(params):
        off = np.abs(f32(p.detach()) - f32(want[path])) > TOL["atol"]
        for idx in zip(*np.nonzero(off)):
            (shown if unsettled[path][idx] else bad).append(
                f"{path}{[int(j) for j in idx]}")
    assert not bad, f"parameters off by more than 2e-5: {bad}"
    if shown:
        warnings.warn(f"entries stepped apart by a rounding-level gradient: {shown}")
    # the model holds the updated tensors
    assert all(a is b for a, b in zip(tree_leaves(params),
                                      tree_leaves(model.param_tree())))


@pytest.mark.parametrize("seed,vocab,seq,batch,step,rank,size", [
    (0, 512, 32, 2, 0, 0, 1),
    (7, 512, 32, 2, 13, 0, 1),
    (3, 256, 16, 8, 5, 1, 2),
    (1, 64000, 64, 4, 2, 3, 4),
])
def test_synthetic_batches_equal_reference(seed, vocab, seq, batch, step, rank, size):
    got = SyntheticLM(DataConfig(vocab, seq, batch, seed)).batch(step, rank, size)
    want = RefSyntheticLM(RefDataConfig(vocab, seq, batch, seed)).batch(step, rank, size)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()


@pytest.mark.parametrize("shape,axes,size,want", [
    ((64, 32), ("embed", "mlp"), 16, ("zero", "mlp")),
    ((10,), (None,), 16, (None,)),
    ((8, 64), ("vocab", None), 16, ("vocab", "zero")),
    ((64, 32), ("embed", "mlp"), 1, ("embed", "mlp")),
])
def test_zero1_extends_moment_specs(shape, axes, size, want):
    got = _zero1_pd(PD(shape, axes), size)
    assert got.axes == want == ref_zero1_pd(RefPD(shape, axes), size).axes
