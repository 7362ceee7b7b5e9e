"""braxlines' training path on the CPU: the PPO trainer's auxiliary-learner
hooks and the DIAYN and GAIL entry points, against the JAX package.

- Without a hook, `ppo.train` is the parent commit's bit for bit: a short
  run on `fast` gives the parent's parameters and evaluation (PARENT_RUN,
  recorded from the parent's trainer on this CPU).
- With the hooks, from train_vgcrl and train_irl: the discriminator's loss
  runs once a training step on the whole [B, T] batch, before the SGD
  epochs, and its gradient and the relabelled reward equal the JAX
  package's hooks (taken from the JAX train_vgcrl / train_irl with its PPO
  trainer stubbed) on the same batch and parameters (gradients rtol 2e-4 /
  atol 2e-5, rewards 1e-5); the relabelling reads the parameters after the
  discriminator's Adam step.
- DIAYN and GAIL on `fast`, mirroring tests/test_braxlines.py: DIAYN's run
  and the per-skill rollouts and evaluators; GAIL for one training step
  (its learning gate, 2^15 steps, is marked slow).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tpu import envs as jax_envs
from brax_tpu.braxlines import discriminators as jax_disc
from brax_tpu.braxlines import train as jax_train
from brax_tpu.training import types as jax_types
from brax_torch import envs
from brax_torch.braxlines import discriminators, evaluators
from brax_torch.braxlines import train as bl_train
from brax_torch.training import networks
from brax_torch.training.agents.ppo import train as ppo

from tests.torch_parity import one_torch_thread  # noqa: F401

# the parent commit's ppo.train on fast at RUN_KW, on this CPU: sha256[:16]
# of the normaliser's and the policy's float32 bytes, and the eval reward
PARENT_RUN = ("f5b8f09546fd3b2f", 1.2247498035430908)
RUN_KW = dict(num_timesteps=2**11, episode_length=32, num_envs=8, batch_size=8,
              num_minibatches=2, unroll_length=4, num_updates_per_batch=2, num_evals=2,
              num_eval_envs=8, normalize_observations=True, learning_rate=3e-4,
              entropy_cost=1e-2, seed=3, device="cpu")
# one training step on fast: 8 envs x 4 steps x 2 minibatches
SHORT_KW = dict(num_timesteps=64, episode_length=16, num_envs=8, batch_size=8,
                num_minibatches=2, unroll_length=4, num_updates_per_batch=1, num_evals=2,
                num_eval_envs=8, normalize_observations=True, learning_rate=3e-4,
                device="cpu")
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def test_ppo_without_hooks_is_the_parents():
    _, (norm, policy), metrics = ppo.train("fast", **RUN_KW)
    h = hashlib.sha256()
    for t in [norm.count, norm.mean, norm.std, norm.summed_variance] + [
            policy[k] for k in sorted(policy)]:
        h.update(t.detach().numpy().astype(np.float32).tobytes())
    assert (h.hexdigest()[:16], metrics["eval/episode_reward"]) == PARENT_RUN


def _skill_disc(cls):
    return cls(obs_indices=(0,), obs_scale=5.0, z_size=2, q_fn="mlp", dist_q="categorical",
               dist_p="categorical", **({"device": "cpu"} if cls is
                                        discriminators.SkillDiscriminator else {}))


def _irl_target():
    """States the always-forward policy visits on fast (64 steps)."""
    env = envs.create("fast", batch_size=1, device="cpu")
    s = env.reset(torch.Generator().manual_seed(0))
    target = []
    for _ in range(64):
        s = env.step(s, torch.ones((1, 1)))
        target.append(s.obs[0])
    return torch.stack(target)


def _jax_hooks(entry, disc, **kw):
    """The hooks the JAX entry point hands its PPO trainer (stubbed)."""
    seen = {}
    real = jax_train.ppo.train
    jax_train.ppo.train = lambda *a, **k: seen.update(k)
    try:
        entry(jax_envs._envs["fast"](), disc, **kw)
    finally:
        jax_train.ppo.train = real
    return seen["extra_loss_fn"], seen["reward_relabel_fn"]


def _port_calls(monkeypatch, entry, disc, **kw):
    """Runs the port's entry point one training step, recording each hook
    call: ("loss", params, data, gradient) and ("relabel", params, data,
    rewards)."""
    calls = []
    real = ppo.train

    def spy(*args, extra_loss_fn, reward_relabel_fn, **kwargs):
        def loss(params, data, gen):
            out = extra_loss_fn(params, data, gen)
            grads = torch.autograd.grad(out, list(params.values()), retain_graph=True)
            calls.append(("loss", {k: v.detach().clone() for k, v in params.items()}, data,
                          dict(zip(params, grads))))
            return out

        def relabel(params, data):
            out = reward_relabel_fn(params, data)
            calls.append(("relabel", {k: v.detach().clone() for k, v in params.items()}, data,
                          out))
            return out

        return real(*args, extra_loss_fn=loss, reward_relabel_fn=relabel, **kwargs)

    monkeypatch.setattr(bl_train.ppo, "train", spy)
    result = entry("fast", disc, **SHORT_KW, **kw)
    return calls, result


def _jax_batch(data):
    num = lambda x: jnp.asarray(x.detach().numpy())
    return jax_types.Transition(observation=num(data.observation), action=num(data.action),
                                reward=num(data.reward), discount=num(data.discount),
                                next_observation=num(data.next_observation))


def _flax(params):
    layers = {}
    for name, v in params.items():
        layer, leaf = name.split(".")
        layers.setdefault(layer, {})[leaf] = jnp.asarray(v.numpy())
    return {"params": layers}


def _check_hooks(calls, jloss_fn, jrelabel_fn, lr):
    """One loss call then one relabel call; the gradient and the rewards
    against the JAX hooks on the same batch; the relabel's parameters one
    Adam step (lr) from the loss call's."""
    assert [c[0] for c in calls] == ["loss", "relabel"]
    (_, p0, data, grads), (_, p1, data1, rewards) = calls
    assert data1 is data and data.observation.shape[:2] == (16, 4)
    batch = _jax_batch(data)
    jgrads = jax.grad(jloss_fn)(_flax(p0), batch, jax.random.PRNGKey(0))
    want = networks.flax_param_dict(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)
    np.testing.assert_allclose(rewards.detach().numpy(),
                               np.asarray(jrelabel_fn(_flax(p1), batch)), rtol=1e-5, atol=1e-5)
    stepped = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    adam = torch.optim.Adam(list(stepped.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for k, v in stepped.items():
        v.grad = grads[k]
    adam.step()
    for k, v in stepped.items():
        torch.testing.assert_close(v.detach(), p1[k], rtol=0, atol=0)


def test_vgcrl_hooks_match_jax(monkeypatch):
    calls, (_, params, _) = _port_calls(monkeypatch, bl_train.train_vgcrl,
                                        _skill_disc(discriminators.SkillDiscriminator),
                                        env_reward_multiplier=0.5, extra_learning_rate=1e-2)
    jloss, jrelabel = _jax_hooks(jax_train.train_vgcrl, _skill_disc(jax_disc.SkillDiscriminator),
                                 env_reward_multiplier=0.5)
    # the JAX skill loss draws nothing: any key
    _check_hooks(calls, jloss, jrelabel, 1e-2)
    assert len(params) == 3 and sorted(params[2]) == sorted(calls[1][1])


def test_irl_hooks_match_jax(monkeypatch):
    """GAIL's hooks: the IRL loss draws its target rows from the trainer's
    generator, so the JAX loss is fed the same rows (its body, rows given)."""
    target = _irl_target()
    disc = discriminators.IRLDiscriminator(input_size=2, reward_type="gail2",
                                           target_data=target, device="cpu")
    rows = []
    real_loss = disc.loss

    def loss(params, policy_data, generator):
        idx = torch.randint(0, target.shape[0], (policy_data.shape[0],), generator=generator)
        rows.append(idx)
        return disc.loss_at(params, policy_data, idx)

    disc.loss = loss
    calls, _ = _port_calls(monkeypatch, bl_train.train_irl, disc, env_reward_multiplier=0.1)
    disc.loss = real_loss
    jd = jax_disc.IRLDiscriminator(input_size=2, reward_type="gail2",
                                   target_data=jnp.asarray(target.numpy()))
    _, jrelabel = _jax_hooks(jax_train.train_irl, jd, env_reward_multiplier=0.1)

    def jloss(params, batch, rng):
        data = jd.obs_act2data(batch.observation, batch.action).reshape(-1, 2)
        logits_t = jd.logits(params, jd.target_data[jnp.asarray(rows[0].numpy())])
        logits_p = jd.logits(params, data)
        ll = jax_disc._bernoulli_log_prob(logits_t, jnp.ones_like(logits_t)).mean()
        ll += jax_disc._bernoulli_log_prob(logits_p, jnp.zeros_like(logits_p)).mean()
        return -ll

    _check_hooks(calls, jloss, jrelabel, 3e-4)


def test_diayn_trains_on_fast():
    """tests/test_braxlines.py::test_diayn_trains_on_fast and
    test_skill_evaluators on the port: the run, each skill rolled out by the
    trained policy, the discriminator's log-posterior and the evaluators'
    metrics finite."""
    disc = _skill_disc(discriminators.SkillDiscriminator)
    make_policy, params, metrics = bl_train.train_vgcrl(
        "fast", disc, num_timesteps=2**13, episode_length=64, num_envs=16, unroll_length=4,
        batch_size=16, num_minibatches=2, num_updates_per_batch=1, num_evals=2,
        normalize_observations=True, learning_rate=3e-4, num_eval_envs=16, device="cpu")
    normalizer, policy_params, disc_params = params
    assert np.isfinite(metrics["eval/episode_reward"])
    zs, obs, _ = evaluators.rollout_skills("fast", disc, make_policy(params[:2]),
                                           torch.Generator().manual_seed(3), episode_length=32)
    ll = disc.ll_q(disc_params, obs[:, -1], zs)
    assert ll.shape == (2,) and bool(torch.isfinite(ll).all())
    m = evaluators.skill_metrics(disc, disc_params, zs, obs)
    assert 0.0 <= m["mi"] <= np.log(2) + 1e-6 and np.isfinite(m["disc_reward_mean"])


def test_gail_runs_on_fast():
    disc = discriminators.IRLDiscriminator(input_size=2, reward_type="gail2",
                                           target_data=_irl_target(), device="cpu")
    make_policy, params, metrics = bl_train.train_irl("fast", disc, **SHORT_KW)
    assert len(params) == 3 and np.isfinite(metrics["eval/episode_reward"])
    assert np.isfinite(metrics["training/total_loss"])


@pytest.mark.slow  # 2^15 env steps and 4 updates a batch: ~1 min on the CPU
def test_gail_trains_on_fast():
    """tests/test_braxlines.py::test_gail_trains_on_fast's gate: the
    imitator moves forward like its target."""
    disc = discriminators.IRLDiscriminator(input_size=2, reward_type="gail2",
                                           target_data=_irl_target(), device="cpu")
    make_policy, params, _ = bl_train.train_irl(
        "fast", disc, num_timesteps=2**15, episode_length=64, num_envs=16, unroll_length=4,
        batch_size=16, num_minibatches=2, num_updates_per_batch=4, num_evals=3, seed=0,
        normalize_observations=True, learning_rate=1e-3, num_eval_envs=16, device="cpu")
    policy = make_policy(params[:2], deterministic=True)
    env = envs.create("fast", batch_size=1, device="cpu")
    s = env.reset(torch.Generator().manual_seed(1))
    for _ in range(32):
        act, _ = policy(s.obs, None)
        s = env.step(s, act)
    assert float(s.obs[0, 0]) > 0.01
