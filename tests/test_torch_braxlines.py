"""brax_torch's braxlines against the JAX package's, on the CPU: the skill
and IRL discriminators, the skill wrapper and the evaluators.

The discriminators run on JAX-initialised parameters carried across
(`networks.flax_param_dict`) and the same numpy inputs: log q(z|s), the
reward and the loss of every skill-discriminator variant, the logits,
each reward transform and the loss (on shared target rows) of the IRL one,
within 1e-5 (their MLPs are f32 here).  The wrapper's observation (the env's,
then z) and its step against the JAX wrapper's from a shared state; the
evaluators' mutual information and energy distance against the JAX ones
on shared data, and their plots written.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tpu import envs as jax_envs
from brax_tpu.braxlines import discriminators as jax_disc
from brax_tpu.braxlines import evaluators as jax_evaluators
from brax_tpu.braxlines import obs_indices as jax_obs_indices
from brax_tpu.braxlines import wrappers as jax_wrappers
from brax_torch import envs
from brax_torch.braxlines import discriminators, evaluators, obs_indices, wrappers
from brax_torch.training import networks

from tests.torch_parity import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
# (q_fn, dist_q, dist_p) of the skill discriminator's variants: diayn,
# cdiayn and gcrl (q by indexing)
SKILL_VARIANTS = (("mlp", "categorical", "categorical"), ("mlp", "normal", "uniform"),
                  ("indexing", "normal", "normal"))


def _skill_pair(q_fn, dist_q, dist_p):
    kw = dict(obs_indices=(1, 3) if q_fn == "mlp" else (0, 2), obs_scale=5.0, z_size=2,
              q_fn=q_fn, dist_q=dist_q, dist_p=dist_p, q_scale=0.7)
    jd = jax_disc.SkillDiscriminator(**kw)
    jp = jd.init(jax.random.PRNGKey(3))
    return jd, jp, discriminators.SkillDiscriminator(**kw, device="cpu"), \
        networks.flax_param_dict(jp)


@pytest.mark.parametrize("variant", SKILL_VARIANTS, ids=lambda v: "-".join(v))
def test_skill_discriminator_matches_jax(variant):
    jd, jp, d, p = _skill_pair(*variant)
    rs = np.random.RandomState(1)
    obs = rs.normal(size=(7, 5, 6)).astype(np.float32) * 3
    if variant[1] == "categorical":
        z = np.eye(2, dtype=np.float32)[rs.randint(0, 2, (7, 5))]
    else:
        z = rs.uniform(-1, 1, (7, 5, 2)).astype(np.float32)
    tobs, tz = torch.from_numpy(obs), torch.from_numpy(z)
    for name in ("ll_q", "reward", "loss"):
        got = getattr(d, name)(p, tobs, tz)
        want = getattr(jd, name)(jp, jnp.asarray(obs), jnp.asarray(z))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=name, **TOL)
    draws = d.sample_p(torch.Generator().manual_seed(0), 64)
    assert draws.shape == (64, 2)
    if variant[2] == "categorical":
        assert bool((draws.sum(-1) == 1).all()) and bool(((draws == 0) | (draws == 1)).all())
    else:
        assert float(draws.abs().max()) <= 5.0


def test_irl_discriminator_matches_jax():
    """The logits, the four reward transforms, obs_act2data and the loss on
    shared target rows; the loss's gradient of every parameter."""
    rs = np.random.RandomState(2)
    target = rs.normal(size=(40, 3)).astype(np.float32)
    policy = (rs.normal(size=(11, 3)) + 0.5).astype(np.float32)
    idx = rs.randint(0, 40, (11,))
    for reward_type in ("gail", "gail2", "airl", "fairl"):
        kw = dict(input_size=3, reward_type=reward_type, obs_indices=(0, 2), include_action=True)
        jd = jax_disc.IRLDiscriminator(**kw, target_data=jnp.asarray(target))
        jp = jd.init(jax.random.PRNGKey(4))
        d = discriminators.IRLDiscriminator(**kw, target_data=torch.from_numpy(target),
                                            device="cpu")
        p = {k: v.requires_grad_(True) for k, v in networks.flax_param_dict(jp).items()}
        np.testing.assert_allclose(d.reward(p, torch.from_numpy(policy)).detach().numpy(),
                                   np.asarray(jd.reward(jp, jnp.asarray(policy))),
                                   err_msg=reward_type, **TOL)
    obs, act = rs.normal(size=(4, 5)).astype(np.float32), rs.normal(size=(4, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        d.obs_act2data(torch.from_numpy(obs), torch.from_numpy(act)).numpy(),
        np.asarray(jd.obs_act2data(jnp.asarray(obs), jnp.asarray(act))))

    def jax_loss(params):
        # JAX's loss with its target rows given: its body, rows `idx`
        logits_t = jd.logits(params, jnp.asarray(target)[idx])
        logits_p = jd.logits(params, jnp.asarray(policy))
        ll = jax_disc._bernoulli_log_prob(logits_t, jnp.ones_like(logits_t)).mean()
        ll += jax_disc._bernoulli_log_prob(logits_p, jnp.zeros_like(logits_p)).mean()
        return -ll

    jloss, jgrads = jax.value_and_grad(jax_loss)(jp)
    loss = d.loss_at(p, torch.from_numpy(policy), torch.from_numpy(idx))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    grads = torch.autograd.grad(loss, list(p.values()))
    want = networks.flax_param_dict(jgrads)
    for (name, _), g in zip(p.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    drawn = d.loss(p, torch.from_numpy(policy), torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(drawn))


def test_skill_wrapper_matches_jax():
    """tests/test_braxlines.py::test_skill_wrapper_appends_z on the port:
    the observation is the env's and then z, z one-hot and kept over the
    steps; a step from a shared state gives the JAX wrapper's observation."""
    disc = discriminators.SkillDiscriminator(obs_indices=(0,), z_size=2, q_fn="mlp",
                                             dist_q="categorical", dist_p="categorical",
                                             device="cpu")
    env = wrappers.SkillWrapper(envs.create("fast", batch_size=5, device="cpu"), disc)
    assert env.observation_size == 2 + 2
    state = env.reset(torch.Generator().manual_seed(0))
    assert state.obs.shape == (5, 4)
    z0 = state.info["skill_z"]
    torch.testing.assert_close(state.obs[:, 2:], z0, rtol=0, atol=0)
    assert bool((z0.sum(-1) == 1).all())
    act = torch.rand((5, 1), generator=torch.Generator().manual_seed(1)) * 2 - 1
    nxt = env.step(state, act)
    torch.testing.assert_close(nxt.info["skill_z"], z0, rtol=0, atol=0)

    jdisc = jax_disc.SkillDiscriminator(obs_indices=(0,), z_size=2, q_fn="mlp",
                                        dist_q="categorical", dist_p="categorical")
    jenv = jax_wrappers.SkillWrapper(jax_envs._envs["fast"](), jdisc)
    jstate = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), 5))
    jstate = jstate.replace(obs=jnp.asarray(state.obs.numpy()),
                            info={**jstate.info, "skill_z": jnp.asarray(z0.numpy())})
    jnxt = jax.vmap(jenv.step)(jstate, jnp.asarray(act.numpy()))
    np.testing.assert_allclose(nxt.obs.numpy(), np.asarray(jnxt.obs), **TOL)


def test_obs_indices_are_a_copy():
    assert obs_indices.OBS_INDICES == jax_obs_indices.OBS_INDICES
    assert obs_indices.get_indices("ant") == ((13, 14), 10.0)
    with pytest.raises(KeyError, match="known"):
        obs_indices.get_indices("no_such_env")


def test_evaluators_match_jax(tmp_path):
    """The binned mutual information (categorical skills and a grid), the
    diversity summary and the energy distance on shared data; the skill
    basis; both plots written (tests/test_braxlines.py's evaluator tests)."""
    rs = np.random.RandomState(5)
    obs = rs.normal(size=(3, 32, 4)).astype(np.float32)
    obs[1, :, 1] += 2.0
    np.testing.assert_allclose(evaluators.estimate_skill_mi(torch.from_numpy(obs), (1, 2)),
                               jax_evaluators.estimate_skill_mi(jnp.asarray(obs), (1, 2)),
                               **TOL)
    d = discriminators.SkillDiscriminator(obs_indices=(1,), obs_scale=5.0, z_size=3, q_fn="mlp",
                                          dist_q="categorical", dist_p="categorical",
                                          device="cpu")
    jd = jax_disc.SkillDiscriminator(obs_indices=(1,), obs_scale=5.0, z_size=3, q_fn="mlp",
                                     dist_q="categorical", dist_p="categorical")
    jp = jd.init(jax.random.PRNGKey(1))
    zs = evaluators.skill_basis(d)
    np.testing.assert_array_equal(zs.numpy(), np.asarray(jax_evaluators.skill_basis(jd)))
    got = evaluators.skill_metrics(d, networks.flax_param_dict(jp), zs, torch.from_numpy(obs))
    want = jax_evaluators.skill_metrics(jd, jp, jnp.asarray(zs.numpy()), jnp.asarray(obs))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], float(v), err_msg=k, **TOL)
    grid = discriminators.SkillDiscriminator(obs_indices=(0, 1), z_size=2, q_fn="indexing",
                                             q_scale=0.5, device="cpu")
    np.testing.assert_allclose(
        evaluators.skill_basis(grid, 5).numpy(),
        np.asarray(jax_evaluators.skill_basis(jax_disc.SkillDiscriminator(
            obs_indices=(0, 1), z_size=2, q_fn="indexing", q_scale=0.5), 5)), **TOL)
    t = np.linspace(-1, 1, 64)
    target = np.stack([t, np.sin(t)], -1).astype(np.float32)
    pol = np.zeros((64, 2), np.float32)
    for a, b in ((target, target), (target, pol)):
        np.testing.assert_allclose(
            evaluators.energy_distance(torch.from_numpy(a), torch.from_numpy(b)),
            jax_evaluators.energy_distance(jnp.asarray(a), jnp.asarray(b)), rtol=1e-4, atol=1e-5)
    evaluators.visualize_skills(zs, torch.from_numpy(obs), (1, 2), output_path=str(tmp_path))
    irl = discriminators.IRLDiscriminator(input_size=2, reward_type="gail", device="cpu")
    evaluators.visualize_disc(irl, irl.init(torch.Generator().manual_seed(0)),
                              torch.from_numpy(target), torch.from_numpy(pol),
                              output_path=str(tmp_path))
    assert (tmp_path / "skills.png").is_file() and (tmp_path / "disc.png").is_file()


@functools.lru_cache(maxsize=None)
def _fast_policy():
    """A fixed policy on fast's observation and z: a push of the skill's
    sign, so that the two skills visit different states."""
    return lambda obs, gen: (torch.tanh(obs[:, 2:3] - obs[:, 3:4]), {})


def test_rollout_skills_on_fast():
    """Each skill rolls out in its own env: (Z, T, obs) of the env's own
    observation, z fixed per row."""
    d = discriminators.SkillDiscriminator(obs_indices=(0,), obs_scale=5.0, z_size=2, q_fn="mlp",
                                          dist_q="categorical", dist_p="categorical",
                                          device="cpu")
    zs, obs, rew = evaluators.rollout_skills("fast", d, _fast_policy(),
                                             torch.Generator().manual_seed(0), episode_length=16)
    assert zs.shape == (2, 2) and obs.shape == (2, 16, 2) and rew.shape == (2, 16)
    assert float(obs[0, -1, 0]) > float(obs[1, -1, 0])
    m = evaluators.skill_metrics(d, d.init(torch.Generator().manual_seed(0)), zs, obs)
    assert 0.0 <= m["mi"] <= np.log(2) + 1e-6 and np.isfinite(m["disc_reward_mean"])
