"""APG's v2 physics gradients on the CPU: `generalized.kernels.GenStep`.

The Function (the kernel's plain version forward here, the kernel on the
card; the backward the VJP of n_frames pipeline steps) on the v2 ant (4
envs, 5 frames) is held bit for bit to autograd through the pipeline's
steps, and to `jax.vjp` of the JAX package's `jnp_path` (reproduced in
tests/apg_parity.py: `_with_vjp`'s backward, brax_tpu/v2/generalized/kernels.py:1323-1331) on
the same State, for a fixed random cotangent on every float leaf of the
State it returns (tests/apg_parity.py states the tolerance).  Both from a
fresh State (`pipeline.init`) and from a stale one: 3 kernel-route steps
on, whose CoM terms, Jacobian and smooth forces are still the reset's, as
the JAX kernel route leaves them.  The gap between the VJP at the stale
State and at the same State freshly refreshed is a fault of the reference
that the port follows (ROADMAP.md, queue C); it is printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_torch import maths
from brax_torch.tools import grad_parity as gp
from brax_torch.v2 import envs as v2_envs
from brax_torch.v2.generalized import kernels as gen_kernels

from tests import apg_faults
from tests import apg_parity as ap
from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401

N_FRAMES = ap.V2_FRAMES


@pytest.fixture(scope="module")
def scene():
    return ap.v2_scene()


def assert_function_matches_pipeline(scene, state):
    got = gp.gen_grads(scene["sys"], state, scene["act"], N_FRAMES, scene["ws"], "function")
    want = gp.gen_grads(scene["sys"], state, scene["act"], N_FRAMES, scene["ws"], "pipeline")
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"input {i}: max diff {(g - w).abs().max()}"


def test_function_gradients_equal_the_pipelines_bit_for_bit(scene):
    for label in ("fresh", "stale"):
        assert_function_matches_pipeline(scene, scene[label])


@pytest.mark.parametrize("label", ["fresh", "stale"])
def test_function_vjp_matches_jax_jnp_path(scene, label):
    got = gp.gen_grads(scene["sys"], scene[label], scene["act"], N_FRAMES, scene["ws"],
                       "function")
    want = ap.jax_v2_vjp(scene, gen_kernels.float_leaves(scene[label]))
    assert len(got) == len(want) == 1 + len(scene["ws"])
    ap.assert_grads_close({i: g for i, g in enumerate(got)}, dict(enumerate(want)),
                          f"{label} input ")


def test_stale_cache_gap_is_measured(scene):
    """The reference's VJP at the stale State against the VJP at that State
    freshly refreshed: printed, per input, relative to the refreshed VJP's
    largest entry."""
    stale, fresh = (gp.gen_grads(scene["sys"], scene[k], scene["act"], N_FRAMES, scene["ws"],
                                 "function") for k in ("stale", "refreshed"))
    gaps = {name: float((s - f).abs().max() / f.abs().max())
            for name, s, f in zip(("act", "q", "qd"), stale, fresh)}
    print(f"v2 ant, {ap.V2_STALE_STEPS} kernel-route steps: |VJP(stale) - VJP(refreshed)| / "
          f"max|VJP(refreshed)|: {gaps}")
    assert all(np.isfinite(list(gaps.values())))
    assert gaps["q"] > ap.GRAD_RTOL  # the reference's fault shows


def test_env_routes_the_kernel_step_through_the_function_only_under_autograd():
    env = v2_envs.get_environment("ant", batch_size=ap.N, device="cpu")
    state = env.reset(torch.Generator().manual_seed(0))
    act = torch.from_numpy(tp.v2_inputs()[2][:ap.N].copy())
    with torch.no_grad():
        nxt, saved = gp.saved_tensors(lambda: env.step(state, act.requires_grad_()))
    assert saved == 0 and nxt.pipeline_state.q.grad_fn is None
    calls = gen_kernels.GenStep.backward_calls
    nxt = env.step(state, act)
    assert type(nxt.pipeline_state.q.grad_fn).__name__ == "GenStepBackward"
    grad = torch.autograd.grad(nxt.reward.sum(), act)[0]
    assert gen_kernels.GenStep.backward_calls == calls + 1
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0


def test_planted_fault_fails(scene):
    with apg_faults.planted("v2_backward_through_gen_step_plain"):
        with pytest.raises(AssertionError):
            assert_function_matches_pipeline(scene, scene["fresh"])


def test_jnp_abs_has_jnp_abs_gradient():
    x = np.array([-2.0, -0.0, 0.0, 3.0], np.float32)
    t = torch.tensor(x, requires_grad=True)
    y = maths.jnp_abs(t)
    torch.testing.assert_close(y.detach(), torch.abs(torch.tensor(x)), rtol=0, atol=0)
    g = torch.autograd.grad(y.sum(), t)[0].numpy()
    np.testing.assert_array_equal(g, np.asarray(jax.vmap(jax.grad(jnp.abs))(x)))
