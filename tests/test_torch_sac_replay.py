"""brax_torch's replay buffers against the JAX package's, on the CPU.

Both buffers take the same numpy Transitions (humanoid's SAC rows: 500
floats).  The port's flat ring must hold the JAX ring's bits after inserts
that run past its end (the roll), the FIFO `Queue`'s samples must be the
JAX ones bit for bit, and the uniform sampler, whose indices come from a
torch generator, must gather what JAX gathers at the same indices.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import flatten_util

from brax_tpu.training import replay_buffers as jax_rb
from brax_tpu.training import types as jax_types
from brax_torch.training import replay_buffers, types
from brax_torch.training.agents.sac import train as sac

from tests.torch_parity import one_torch_thread  # noqa: F401

OBS, ACT = 240, 17
MAX = 10


def _batch(n, seed):
    rs = np.random.RandomState(seed)
    f = lambda *shape: rs.normal(size=shape).astype(np.float32)
    return types.Transition(observation=f(n, OBS), action=f(n, ACT), reward=f(n),
                            discount=f(n), next_observation=f(n, OBS),
                            extras={"state_extras": {"truncation": f(n)}, "policy_extras": {}})


def _jax_dummy():
    d = sac.dummy_transition(OBS, ACT)
    return jax_types.Transition(*d)


@functools.lru_cache(maxsize=None)
def _jax_buffer(kind, batch):
    buf = getattr(jax_rb, kind)(max_replay_size=MAX, dummy_data_sample=_jax_dummy(),
                                sample_batch_size=batch)
    return buf, jax.jit(buf.insert), jax.jit(buf.sample)


def _port_buffer(kind, batch):
    buf = getattr(replay_buffers, kind)(MAX, sac.dummy_transition(OBS, ACT), batch, device="cpu")
    return buf, buf.init(torch.Generator().manual_seed(0))


def test_flatten_is_ravel_pytree_order():
    b = _batch(3, 0)
    buf, _ = _port_buffer("UniformSamplingQueue", 2)
    flat = buf.flatten(types.tree_map(torch.tensor, b)).numpy()
    want = np.stack([np.asarray(flatten_util.ravel_pytree(
        jax.tree_util.tree_map(lambda x: x[i], jax_types.Transition(*b)))[0]) for i in range(3)])
    assert flat.shape == (3, 500)
    np.testing.assert_array_equal(flat, want)
    back = buf.unflatten(torch.tensor(flat))
    for got, orig in zip(jax.tree_util.tree_leaves(tuple(back)), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(got), orig)
    assert back.extras["policy_extras"] == {}


@pytest.mark.parametrize("sizes", [(4, 4, 4, 3, 7), (10, 6, 9), (1, 9, 2)])
def test_inserts_roll_like_jax_bit_for_bit(sizes):
    """Inserts that run past the end roll the ring before writing."""
    jbuf, jinsert, _ = _jax_buffer("UniformSamplingQueue", 2)
    jstate = jbuf.init(jax.random.PRNGKey(0))
    buf, state = _port_buffer("UniformSamplingQueue", 2)
    for k, n in enumerate(sizes):
        b = _batch(n, k + 1)
        jstate = jinsert(jstate, jax_types.Transition(*b))
        state = buf.insert(state, types.tree_map(torch.tensor, b))
        np.testing.assert_array_equal(state.data.numpy(), np.asarray(jstate.data))
        assert state.current_position == int(jstate.current_position)
        assert state.current_size == int(jstate.current_size)
    with pytest.raises(ValueError, match="exceeds max replay size"):
        buf.insert(state, types.tree_map(torch.tensor, _batch(MAX + 1, 9)))


@pytest.mark.parametrize("batch", [3, 8])
def test_fifo_queue_samples_like_jax_bit_for_bit(batch):
    jbuf, jinsert, jsample = _jax_buffer("Queue", batch)
    jstate = jbuf.init(jax.random.PRNGKey(0))
    buf, state = _port_buffer("Queue", batch)
    for k, n in enumerate((6, 7)):
        b = _batch(n, k + 1)
        jstate = jinsert(jstate, jax_types.Transition(*b))
        state = buf.insert(state, types.tree_map(torch.tensor, b))
    for _ in range(3):  # past the last row: zeros, as JAX masks them
        jstate, jout = jsample(jstate)
        state, out = buf.sample(state)
        for got, want in zip(jax.tree_util.tree_leaves(tuple(out)),
                             jax.tree_util.tree_leaves(jout)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert state.current_size == int(jstate.current_size)


def test_uniform_sampler_gathers_what_jax_gathers():
    """The port's indices (its generator's draw over [position - size,
    position)) handed to both: the same samples, bit for bit, wrapped
    around the ring's end."""
    jbuf, jinsert, _ = _jax_buffer("UniformSamplingQueue", 64)
    jstate = jbuf.init(jax.random.PRNGKey(0))
    buf, state = _port_buffer("UniformSamplingQueue", 64)
    for k, n in enumerate((7, 6, 5)):
        b = _batch(n, k + 1)
        jstate = jinsert(jstate, jax_types.Transition(*b))
        state = buf.insert(state, types.tree_map(torch.tensor, b))
    idx = buf.indices(state)
    assert int(idx.min()) >= state.current_position - state.current_size
    assert int(idx.max()) < state.current_position and int(idx.min()) < 0  # wraps
    got = buf.sample_at(state, idx)
    flat = jnp.take(jstate.data, jnp.asarray(idx.numpy()), axis=0, mode="wrap")
    want = jax.vmap(flatten_util.ravel_pytree(_jax_dummy())[1])(flat)
    for g, w in zip(jax.tree_util.tree_leaves(tuple(got)), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # sample() is indices() then sample_at() on the state's generator
    state.generator.manual_seed(5)
    first = buf.sample(state)[1]
    state.generator.manual_seed(5)
    again = buf.sample_at(state, buf.indices(state))
    torch.testing.assert_close(first.observation, again.observation, rtol=0, atol=0)
