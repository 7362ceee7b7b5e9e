"""brax_torch's SAC losses and SGD step against the JAX package's, on the
CPU, at humanoid's shapes (240-wide observation, 17 actions).

Both sides take the same numpy transitions, JAX-initialised parameters
(carried across) and noise: the port's generator draws, handed to the JAX
distribution (`tests/sac_parity.py::GivenNoise`).  Losses within rtol
2e-5; gradients within tests/test_fused_mlp.py's backward tolerance (rtol
2e-4, atol 2e-5 of each gradient's largest entry); after two SGD steps
(each three Adam steps and the Polyak update) the parameters within atol 1e-6, as
tests/test_torch_ppo.py holds an Adam step to optax's, but for at most one
entry in 10,000 of a parameter, held to 1e-5: Adam moves an entry whose
gradient is near 0 by up to the learning rate whatever the gradient's
size, so the packages' rounding of such a gradient shows there (1.3e-6 in
one of 65,792 entries of a critic's first kernel, the largest measured).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_torch.training import gradients, types
from brax_torch.training.agents.sac import losses as sac_losses
from brax_torch.training.agents.sac import train as sac

from tests import sac_parity as sp
from tests.torch_parity import one_torch_thread  # noqa: F401

OBS, ACT = sp.SHAPES["humanoid"]
BATCH = 32
SEED = 11
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
ADAM_ATOL, ADAM_FEW, ADAM_ATOL_FEW = 1e-6, 1e-4, 1e-5


def _grad_close(got, want, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5 * max(np.abs(want).max(), 1.0),
                               err_msg=msg)


def _setup():
    nets, policy, q = sp.port_networks_from_jax(OBS, ACT)
    target = {k: (v.detach() * 0.9).clone() for k, v in q.items()}
    jn, tn = sp.normalizer(OBS)
    tr = sp.transitions(OBS, ACT, BATCH)
    return nets, policy, q, target, jn, tn, tr


def _jax_target(target):
    tree = {"params": {}}
    for name, t in target.items():
        c, layer, leaf = name.split(".")
        tree["params"].setdefault(c, {}).setdefault(layer, {})[leaf] = jnp.asarray(t.numpy())
    return tree


def _port_losses(nets):
    return sac_losses.make_losses(nets, reward_scaling=sp.REWARD_SCALING,
                                  discounting=sp.DISCOUNTING, action_size=ACT)


def test_three_losses_and_gradients_match_jax():
    nets, policy, q, target, jn, tn, tr = _setup()
    _, jp, jq = sp.jax_networks(OBS, ACT)
    log_alpha, alpha = np.float32(-0.3), np.float32(np.exp(-0.4))
    noises = sp.draws(SEED, (BATCH, ACT), 3)
    (ja, jga), (jc, jgc), (jact, jgact) = sp.jax_loss_grads(OBS, ACT)(
        noises, jnp.asarray(log_alpha), jp, jq, _jax_target(target), jnp.asarray(alpha), jn,
        sp.to_jax(tr))
    alpha_loss, critic_loss, actor_loss = _port_losses(nets)
    ttr, gen = sp.to_torch(tr), torch.Generator().manual_seed(SEED)
    la = torch.tensor(log_alpha, requires_grad=True)
    a, ga = gradients.loss_and_grads(alpha_loss, la, policy, tn, ttr, gen)
    c, gc = gradients.loss_and_grads(critic_loss, q, policy, tn, target, torch.tensor(alpha),
                                     ttr, gen)
    p, gp = gradients.loss_and_grads(actor_loss, policy, tn, q, torch.tensor(alpha), ttr, gen)
    for got, want, name in ((a, ja, "alpha"), (c, jc, "critic"), (p, jact, "actor")):
        np.testing.assert_allclose(float(got), float(want), err_msg=name, **LOSS_TOL)
    _grad_close(ga.numpy(), jga, "d log_alpha")
    for name, g in gc.items():
        _grad_close(g.numpy(), sp.flax_leaf(jgc, name), f"critic {name}")
    for name, g in gp.items():
        _grad_close(g.numpy(), sp.flax_leaf(jgact, name), f"actor {name}")


def test_critic_loss_masks_truncated_td_errors():
    """Truncated rows contribute nothing; their targets are not looked at."""
    nets, policy, q, target, _, tn, tr = _setup()
    _, critic_loss, _ = _port_losses(nets)
    trunc = tr.extras["state_extras"]["truncation"]
    assert 0 < trunc.sum() < BATCH
    alpha = torch.tensor(0.5)
    base = critic_loss(q, policy, tn, target, alpha, sp.to_torch(tr),
                       torch.Generator().manual_seed(0))
    moved = tr._replace(reward=np.where(trunc > 0, 1e6, tr.reward).astype(np.float32))
    again = critic_loss(q, policy, tn, target, alpha, sp.to_torch(moved),
                        torch.Generator().manual_seed(0))
    assert float(base.detach()) == float(again.detach())


def test_losses_differentiate_their_first_argument_only():
    """No `.grad` on any network; the policy's forward in the alpha and
    critic losses and the target critics' are not recorded."""
    nets, policy, q, target, _, tn, tr = _setup()
    alpha_loss, critic_loss, actor_loss = _port_losses(nets)
    ttr, gen = sp.to_torch(tr), torch.Generator().manual_seed(0)
    la = torch.tensor(0.0, requires_grad=True)
    loss = alpha_loss(la, policy, tn, ttr, gen)
    assert loss.grad_fn is not None and len(torch.autograd.grad(loss, [la])) == 1
    with pytest.raises(RuntimeError):  # the policy is not in the alpha loss's graph
        torch.autograd.grad(alpha_loss(la, policy, tn, ttr, gen),
                            [policy["hidden_0.kernel"]])
    with pytest.raises(RuntimeError):  # nor in the critic loss's
        torch.autograd.grad(critic_loss(q, policy, tn, target, torch.tensor(0.5), ttr, gen),
                            [policy["hidden_0.kernel"]])
    gradients.loss_and_grads(critic_loss, q, policy, tn, target, torch.tensor(0.5), ttr, gen)
    gradients.loss_and_grads(actor_loss, policy, tn, q, torch.tensor(0.5), ttr, gen)
    assert all(t.grad is None for t in (*policy.values(), *q.values(), la))


def test_one_sgd_step_matches_the_jax_sequence():
    """alpha, the critic with the alpha before its update, the actor with
    the critics before theirs, the Polyak update: against the JAX
    trainer's sgd_step built from its losses and optax, twice in a row."""
    nets, policy, q, _, jn, tn, tr = _setup()
    _, jp, jq = sp.jax_networks(OBS, ACT)
    tau, lr = 0.005, 6e-4
    ts = sac.init_training_state(policy, q, lr)
    with torch.no_grad():
        ts.log_alpha.fill_(-0.2)
    init, jstep = sp.jax_sgd_step(OBS, ACT, lr, tau)
    jstate = init(jnp.asarray(np.float32(-0.2)), jp, jq)
    gen = torch.Generator().manual_seed(SEED)
    noises = sp.draws(SEED, (BATCH, ACT), 6)
    losses = _port_losses(nets)
    for k in range(2):
        trk = sp.transitions(OBS, ACT, BATCH, seed=20 + k)
        metrics = sac.sgd_step(ts, losses, sp.to_torch(trk), tn, gen, tau)
        jstate, jmetrics = jstep(noises[3 * k:3 * k + 3], jstate, jn, sp.to_jax(trk))
        for name in ("critic_loss", "actor_loss", "alpha_loss", "alpha"):
            np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]),
                                       err_msg=f"step {k} {name}", **LOSS_TOL)
    log_alpha, jpolicy, jq2, jtarget = jstate[:4]

    def close(got, want, msg):
        err = np.abs(got.detach().numpy() - np.asarray(want))
        assert err.max() <= ADAM_ATOL_FEW, (msg, err.max())
        assert (err > ADAM_ATOL).mean() <= ADAM_FEW, (msg, (err > ADAM_ATOL).sum())

    close(ts.log_alpha, log_alpha, "log_alpha")
    for name, t in ts.policy_params.items():
        close(t, sp.flax_leaf(jpolicy, name), f"policy {name}")
    for name, t in ts.q_params.items():
        close(t, sp.flax_leaf(jq2, name), f"q {name}")
    for name, t in ts.target_q_params.items():
        close(t, sp.flax_leaf(jtarget, name), f"target {name}")
    assert all(t.grad is None for t in (*ts.policy_params.values(), *ts.q_params.values()))
    assert not any(t.requires_grad for t in ts.target_q_params.values())
    assert types.Transition is sac.Transition
