"""The port's training step on fixed tensors (``StaticTrainStep``), which the
card captures in a CUDA graph and the CPU runs uncaptured, against the JAX
trainer: five steps, each batch copied into the same buffers, give the
reference's loss and metrics at every step (2e-5, ``TOL``, the gate of
``test_torch_training_steps.py::test_three_adamw_steps_match_reference``).
Also: AdamW advances its step counter in place, since a replayed graph reads
the captured tensor again; and the trainer's switch refuses a graph on a
mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import TOL, batch_for, both, case_id, f32
from repro.training.optimizer import AdamW as RefAdamW
from repro.training.optimizer import AdamWConfig as RefAdamWConfig
from repro.training.optimizer import make_train_step as ref_make_train_step
from repro_torch.launch.train import run
from repro_torch.models import AxisRules
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.training.optimizer import AdamW, AdamWConfig, StaticTrainStep

S, STEPS = 24, 5
CASES = [("yi-9b", None), ("mixtral-8x7b", None), ("rwkv6-1.6b", None)]


@pytest.mark.parametrize("arch,options", CASES,
                         ids=[case_id(a, o) for a, o in CASES])
def test_static_train_step_matches_reference_over_five_steps(arch, options):
    cfg, model, rmodel, rparams, _ = both(arch, options)
    opt_cfg = dict(lr=1e-3, zero1=False)
    ropt = RefAdamW(RefAdamWConfig(**opt_cfg), rmodel.ax)
    rstep = jax.jit(ref_make_train_step(rmodel, ropt))
    rstate = ropt.init(rparams)
    opt = AdamW(AdamWConfig(**opt_cfg), model.ax)
    model.requires_grad_(True)
    params = model.param_tree()
    step = StaticTrainStep(model, opt, params, opt.init(params))
    rng = np.random.default_rng(6)
    buffers = None
    for i in range(STEPS):
        batch = batch_for(cfg, rng, S)
        rparams, rstate, want = rstep(rparams, rstate,
                                      {k: jnp.asarray(v) for k, v in batch.items()})
        got = step(batch)
        if buffers is None:
            buffers = {k: v.data_ptr() for k, v in step.batch.items()}
        assert {k: v.data_ptr() for k, v in step.batch.items()} == buffers
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(f32(got[name]), f32(want[name]), **TOL,
                                       err_msg=f"step {i}: {name}")
    assert int(step.opt_state["step"]) == int(rstate["step"]) == STEPS
    # the step wrote the model's own tensors
    assert all(a is b for a, b in zip(tree_leaves(step.params),
                                      tree_leaves(model.param_tree())))


def test_static_train_step_refuses_another_shape():
    cfg, model, _, _, _ = both("yi-9b")
    model.requires_grad_(True)
    opt = AdamW(AdamWConfig(zero1=False), model.ax)
    params = model.param_tree()
    step = StaticTrainStep(model, opt, params, opt.init(params))
    rng = np.random.default_rng(0)
    step(batch_for(cfg, rng, 8))
    with pytest.raises(ValueError, match="one shape"):
        step(batch_for(cfg, rng, 12))


def test_adamw_advances_its_step_in_place():
    """Three updates on one state keep ``state["step"]`` as one tensor,
    which reads 3, and return that tensor."""
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 3, generator=gen), "b": torch.randn(3, generator=gen)}
    opt = AdamW(AdamWConfig(zero1=False), AxisRules(None))
    state = opt.init(params)
    counter, ptr = state["step"], state["step"].data_ptr()
    for _ in range(3):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
        params, new = opt.update(params, grads, state)
        assert new["step"] is counter
        assert all(a is b for a, b in zip(tree_leaves(new["m"]), tree_leaves(state["m"])))
        state = new
    assert state["step"] is counter and counter.data_ptr() == ptr
    assert counter.dtype == torch.int32 and int(counter) == 3


def test_adamw_in_place_step_equals_a_fresh_count():
    """The bias corrections read the counter as before: three updates on
    one state equal three updates each handed a fresh state of the same
    moments and a counter made anew."""
    gen = torch.Generator().manual_seed(1)
    p0 = {"w": torch.randn(5, 2, generator=gen)}
    grads = [{"w": torch.randn(5, 2, generator=gen)} for _ in range(3)]
    opt = AdamW(AdamWConfig(zero1=False, lr=1e-2), AxisRules(None))
    a = tree_map(torch.clone, p0)
    state = opt.init(a)
    for g in grads:
        a, state = opt.update(a, g, state)
    b = tree_map(torch.clone, p0)
    fresh = opt.init(b)
    for i, g in enumerate(grads):
        fresh = {"m": fresh["m"], "v": fresh["v"],
                 "step": torch.tensor(i, dtype=torch.int32)}
        b, fresh = opt.update(b, g, fresh)
    assert torch.equal(a["w"], b["w"])


def test_graph_on_a_mesh_is_refused():
    """A mesh step runs eagerly; asking for its graph raises at once, before
    any process group is needed."""
    with pytest.raises(ValueError, match="eagerly"):
        run("yi-9b", steps=1, mesh_shape=(2, 1), device="cpu", eager=False)


def test_eager_and_default_agree_on_the_cpu():
    """On the CPU nothing is captured: ``eager=True`` and the default run
    the same static step, to the bit."""
    kw = dict(steps=4, seq_len=16, global_batch=2, layers=1, device="cpu",
              log_every=100)
    assert run("qwen3-8b", **kw)["losses"] == run("qwen3-8b", eager=True, **kw)["losses"]
