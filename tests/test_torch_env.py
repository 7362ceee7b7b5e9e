"""brax_torch.envs: registry, wrapper stack, episode bookkeeping, and the
rule that the port imports nothing of JAX or brax_tpu."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from brax_torch import envs
from brax_torch.envs import wrappers

from tests.torch_parity import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "brax_tpu")


def _env(**kw):
    return envs.create("ant", batch_size=4, device="cpu", **kw)


def test_create_builds_the_wrapper_stack():
    env = _env(eval_metrics=True)
    layers = []
    while isinstance(env, wrappers.base.Wrapper):
        layers.append(type(env).__name__)
        env = env.env
    assert layers == ["EvalWrapper", "AutoResetWrapper", "VmapWrapper", "EpisodeWrapper"]
    assert type(env).__name__ == "Ant"
    wrapped = _env()
    assert wrapped.action_size == 8 and wrapped.observation_size == 87


def test_create_names_envs_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        envs.create("humanoid", device="cpu")


def test_reset_draws_its_noise_from_the_generator():
    """reset(rng) is reset_from_noise of two uniform draws in +-0.1."""
    env = _env()
    a = env.reset(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    qpos, qvel = [torch.rand((4, 8), generator=gen) * 0.2 - 0.1 for _ in range(2)]
    b = env.unwrapped.reset_from_noise(qpos, qvel)
    torch.testing.assert_close(a.obs, b.obs, rtol=0, atol=0)
    assert a.obs.shape == (4, 87) and a.reward.shape == (4,)
    assert a.info["steps"].shape == (4,) and not a.done.any()


def test_episode_truncation_and_auto_reset():
    """episode_length=5: steps count 1..5, done and truncation rise at 5,
    and the next step restarts the count from the first observation."""
    env = _env(episode_length=5)
    state = env.reset(torch.Generator().manual_seed(0))
    first_obs = state.info["first_obs"]
    act = torch.zeros((4, 8))
    seen = []
    for i in range(12):
        state = env.step(state, act)
        seen.append(int(state.info["steps"][0]))
        truncated = (i + 1) % 5 == 0
        assert bool(state.done.all()) == truncated
        assert bool((state.info["truncation"] == 1).all()) == truncated
        if truncated:
            torch.testing.assert_close(state.obs, first_obs, rtol=0, atol=0)
    assert seen == [1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 1, 2]


def test_eval_wrapper_accumulates_episode_metrics():
    env = _env(episode_length=3, eval_metrics=True)
    state = env.reset(torch.Generator().manual_seed(0))
    rewards = []
    for _ in range(5):
        state = env.step(state, torch.zeros((4, 8)))
        rewards.append(state.reward)
    em = state.info["eval_metrics"]
    torch.testing.assert_close(em.episode_metrics["reward"], sum(rewards[:3]))
    # the first episode ends at step 3; later steps no longer accumulate
    assert torch.equal(em.episode_steps, torch.full((4,), 3.0))
    assert not em.active_episodes.any()
    assert em.episode_metrics["reward"].shape == (4,)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "brax_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 50
    for module in ("v2/generalized/kernels.py", "v2/envs/hopper.py", "v2/envs/reacher.py",
                   "tools/probe_overhead.py"):
        assert REPO / "brax_torch" / module in files, module
    bad = [
        (str(f.relative_to(REPO)), name)
        for f in files
        for name in _imports(f)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_importing_the_port_loads_no_brax_tpu():
    code = (
        "import sys, brax_torch.envs, brax_torch.sim.kernels, brax_torch.braxlines.defaults, "
        "brax_torch.training.agents.ppo.train, brax_torch.v2.envs, brax_torch.v2.mjcf, "
        "brax_torch.v2.generalized.kernels, brax_torch.v2.envs.walker2d, "
        "brax_torch.tools.probe_overhead; "
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('brax_tpu', 'flax', 'optax')))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
