"""brax_torch's MAPPO against the JAX package's, on the CPU.

The joint policy and the MAPPO loss are fed the same numpy inputs (from
seeds) and the same JAX-initialised parameters of every agent
(`mappo.load_flax_params`); the joint policy's draws are shared (the JAX
distribution samples the port's per-agent generator draws, in agent
order).  f32 paths are held to tests/test_torch_ppo.py's tolerances: the
policy 1e-5, the loss rtol/atol 2e-5 and its gradients rtol 2e-4 / atol
2e-5.  A short CPU `train` on the two-pointmass follow runs end to end; the
JAX package's learning gate there (tests/test_composer.py::
test_mappo_learns_pointmass_follow, 65,536 steps) is mirrored, marked slow.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tpu.composer.training import mappo as jax_mappo
from brax_tpu.training import distribution as jax_distribution
from brax_tpu.training import running_statistics as jax_rs
from brax_tpu.training.agents.ppo import losses as jax_losses
from brax_tpu.training.agents.ppo import networks as jax_ppo_networks
from brax_torch.composer import envs as cenvs
from brax_torch.composer.training import mappo
from brax_torch.training import running_statistics, types
from brax_torch.training.agents.ppo import networks as ppo_networks

from tests.torch_parity import one_torch_thread  # noqa: F401

OBS, ACT = 21, 3
AGENTS = ("agent0", "agent1")
# the agents' slices of the joint action, interleaved
SLICES = {"agent0": (0, 2, 4), "agent1": (1, 3, 5)}
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The JAX networks (normalising) and every agent's params, drawn as the
    JAX trainer draws them (fold_in of the agent's index)."""
    nets = jax_ppo_networks.make_ppo_networks(OBS, ACT, preprocess_observations_fn=jax_rs.normalize)
    params = {}
    for i, agent in enumerate(AGENTS):
        kp, kv = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), i))
        params[agent] = jax_losses.PPONetworkParams(policy=nets.policy_network.init(kp),
                                                    value=nets.value_network.init(kv))
    return nets, params


def _port():
    nets = ppo_networks.make_ppo_networks(
        OBS, ACT, preprocess_observations_fn=running_statistics.normalize, device="cpu")
    params = mappo.load_flax_params(_jax_params()[1])
    for p in params.values():
        for t in (*p.policy.values(), *p.value.values()):
            t.requires_grad_(True)
    return nets, params


def _normalizer(seed=0):
    rs = np.random.RandomState(seed)
    count = np.float32(50.0)
    mean = (rs.normal(size=OBS) * 0.1).astype(np.float32)
    std = rs.uniform(0.5, 2.0, OBS).astype(np.float32)
    var = (std * std * count).astype(np.float32)
    jax_state = jax_rs.RunningStatisticsState(
        count=jnp.asarray(count), mean=jnp.asarray(mean), std=jnp.asarray(std),
        summed_variance=jnp.asarray(var))
    return jax_state, running_statistics.RunningStatisticsState.from_numpy(
        count, mean, std, var, device="cpu")


def test_joint_policy_matches_jax_on_shared_draws():
    """Each agent's action in its slice, its raw action and log-prob, from
    the port's per-agent generators and the JAX policy fed the same draws;
    the deterministic policy's modes and zero log-probs."""
    jn, tn = _normalizer()
    obs = np.random.RandomState(1).normal(size=(9, OBS)).astype(np.float32)
    nets, params = _port()
    gens = [torch.Generator().manual_seed(10 + i) for i in range(len(AGENTS))]
    replay = [torch.Generator().manual_seed(10 + i) for i in range(len(AGENTS))]
    noise = iter([jnp.asarray(torch.randn((9, ACT), generator=g).numpy()) for g in replay])

    class GivenNoise(jax_distribution.NormalTanhDistribution):
        def sample_no_postprocessing(self, parameters, seed):
            dist = self.create_dist(parameters)
            return next(noise) * dist.scale + dist.loc

    jnets, jparams = _jax_params()
    jnets = dataclasses.replace(jnets, parametric_action_distribution=GivenNoise(ACT))
    for deterministic in (False, True):
        policy = mappo.make_joint_inference_fn(nets, AGENTS, SLICES, 2 * ACT)(
            (tn, params), deterministic=deterministic)
        jpolicy = jax_mappo.make_joint_inference_fn(jnets, AGENTS, SLICES, 2 * ACT)(
            (jn, jparams), deterministic=deterministic)
        with torch.no_grad():
            act, extras = policy(torch.from_numpy(obs), gens)
        jact, jextras = jpolicy(jnp.asarray(obs), jax.random.PRNGKey(0))
        np.testing.assert_allclose(act.numpy(), np.asarray(jact), rtol=1e-5, atol=1e-5)
        assert sorted(extras) == sorted(jextras)
        for k, v in jextras.items():
            np.testing.assert_allclose(extras[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def _batch(nets, params, normalizer, b=12, t=5, seed=5):
    """A [B, T] Transition (numpy) with a reward column per agent and
    behaviour log-probs near each agent's own."""
    rs = np.random.RandomState(seed)
    f = lambda x: np.asarray(x, dtype=np.float32)
    obs = f(rs.normal(size=(b, t, OBS)))
    extras = {}
    for agent in AGENTS:
        raw = f(rs.normal(size=(b, t, ACT)))
        with torch.no_grad():
            logits = nets.policy_network(normalizer, params[agent].policy, torch.tensor(obs))
            log_prob = nets.parametric_action_distribution.log_prob(logits, torch.tensor(raw))
        extras[f"{agent}_raw_action"] = raw
        extras[f"{agent}_log_prob"] = f(log_prob.numpy() + rs.normal(size=(b, t)) * 0.3)
    done = f(rs.uniform(size=(b, t)) < 0.1)
    return types.Transition(
        observation=obs, action=f(rs.uniform(-1, 1, (b, t, 2 * ACT))),
        reward=f(rs.normal(size=(b, t, len(AGENTS)))), discount=1 - done,
        next_observation=f(rs.normal(size=(b, t, OBS))),
        extras={"policy_extras": extras,
                "state_extras": {"truncation": f(done * (rs.uniform(size=(b, t)) < 0.5))}})


def test_mappo_loss_and_grads_match_jax():
    """The summed loss, each agent's policy and value losses, and the
    gradient of every agent's every parameter."""
    kw = dict(entropy_cost=0.0, discounting=0.97, reward_scaling=10.0, gae_lambda=0.95,
              clipping_epsilon=0.3)
    jn, tn = _normalizer()
    nets, params = _port()
    data = _batch(nets, params, tn)
    jnets, jparams = _jax_params()

    def jax_loss(p):
        return jax_mappo.compute_mappo_loss(p, jn, data, jax.random.PRNGKey(0),
                                            ppo_network=jnets, agent_names=AGENTS, **kw)

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jparams)
    loss, metrics = mappo.compute_mappo_loss(
        params, tn, types.tree_map(torch.tensor, data), torch.Generator().manual_seed(0),
        ppo_network=nets, agent_names=AGENTS, **kw)
    assert sorted(metrics) == sorted(jmetrics)
    for name, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[name].detach()), float(v), rtol=2e-5, atol=2e-5,
                                   err_msg=name)
    leaves = [(a, side, name, t) for a, p in params.items()
              for side, named in (("policy", p.policy), ("value", p.value))
              for name, t in named.items()]
    grads = torch.autograd.grad(loss, [t for *_, t in leaves])
    for (agent, side, name, _), g in zip(leaves, grads):
        layer, leaf = name.split(".")
        want = getattr(jgrads[agent], side)["params"][layer][leaf]
        np.testing.assert_allclose(g.numpy(), np.asarray(want), err_msg=f"{agent} {side} {name}",
                                   **GRAD_TOL)


def _follow(batch_size, device):
    return cenvs.create_ma_env(task="follow", main_agent="pointmass", other_agent="pointmass",
                               num_agents=2, episode_length=None, batch_size=batch_size,
                               auto_reset=False, device=device).unwrapped


def test_mappo_trains_pointmass_follow_short():
    """One training step and an evaluation on the CPU: the metrics are
    finite, each agent's losses reported, and the joint policy emits the
    env's whole action (each agent's slice of 3)."""
    seen = []
    make_policy, params, metrics = mappo.train(
        _follow, num_timesteps=64, episode_length=8, num_envs=8, num_eval_envs=4,
        unroll_length=4, batch_size=8, num_minibatches=2, num_updates_per_batch=1, num_evals=2,
        normalize_observations=True, learning_rate=1e-3, device="cpu",
        progress_fn=lambda step, m: seen.append(step))
    assert seen == [64]
    for key in ("eval/episode_reward", "training/total_loss", "training/agent0/policy_loss",
                "training/agent1/v_loss"):
        assert np.isfinite(metrics[key]), key
    normalizer, agent_params = params
    assert sorted(agent_params) == ["agent0", "agent1"]
    env = _follow(3, "cpu")
    act, extras = make_policy(params, deterministic=True)(
        torch.zeros((3, env.observation_size)), torch.Generator())
    assert act.shape == (3, env.action_size) == (3, 6)
    assert extras["agent1_log_prob"].shape == (3,)


@pytest.mark.slow  # 65,536 env steps of the CPU twin
def test_mappo_learns_pointmass_follow():
    """tests/test_composer.py::test_mappo_learns_pointmass_follow's gate."""
    _, _, metrics = mappo.train(
        _follow, num_timesteps=65536, episode_length=64, num_envs=32, num_eval_envs=16,
        unroll_length=8, batch_size=32, num_minibatches=4, num_updates_per_batch=2, num_evals=2,
        normalize_observations=True, learning_rate=1e-3, device="cpu")
    assert float(metrics["eval/episode_reward_dist__agent0__agent1"]) > 1100
