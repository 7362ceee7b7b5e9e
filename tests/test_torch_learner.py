"""`python -m brax_torch.training.learner` on the CPU (`--device cpu`): its
parser against the JAX CLI's (brax_tpu/training/learner.py), each trainer
of the JAX CLI run through `main` at a tiny size on `fast` (the params
file, the event file's eval scalars), and the options that wait on other
modules raising."""

import argparse

import pytest
import torch

from brax_torch.io import metrics, model
from brax_torch.training import learner

from tests.torch_parity import one_torch_thread  # noqa: F401


def _actions(parser):
    """{dest and flags: (default, choices, type, const, nargs)} of a parser's
    options but --help."""
    return {(a.dest, tuple(a.option_strings)): (a.default, a.choices, a.type, a.const, a.nargs)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_parser_is_the_jax_clis_plus_device():
    from brax_tpu.training import learner as jax_learner

    port, jax = _actions(learner.build_parser()), _actions(jax_learner.build_parser())
    assert set(port) - set(jax) == {("device", ("--device",))}
    assert {k: v for k, v in port.items() if k[0] != "device"} == jax
    assert port["device", ("--device",)][0] == "cuda"
    assert learner.build_parser().parse_args([]).device == "cuda"


TINY = ["--env", "fast", "--device", "cpu", "--num_envs", "16", "--batch_size", "16",
        "--num_minibatches", "2", "--unroll_length", "4", "--total_env_steps", "512",
        "--num_evals", "2", "--episode_length", "16", "--min_replay_size", "32",
        "--max_replay_size", "256", "--population_size", "4", "--number_of_directions", "4",
        "--top_directions", "2", "--truncation_length", "4"]


@pytest.mark.parametrize("name", ["ppo", "sac", "apg", "es", "ars"])
def test_main_runs_each_trainer(name, tmp_path):
    out = learner.main(TINY + ["--learner", name, "--logdir", str(tmp_path)])
    assert out["params"] == str(tmp_path / f"fast_{name}.pkl")
    normalizer, policy = model.load_params(out["params"])
    assert float(normalizer.count) > 0
    leaves = policy.values() if isinstance(policy, dict) else [policy]
    assert all(isinstance(v, torch.Tensor) and bool(torch.isfinite(v).all()) for v in leaves)
    scalars = metrics.read_scalars(out["events"])
    steps = sorted({s for tag, s, _ in scalars if tag == "eval/episode_reward"})
    # two evaluations (at env steps; APG counts its epochs, as the JAX trainer does)
    assert len(steps) == 2 and steps[1] > 0
    # fast has no scene to render: a rollout of 16 steps, and no page
    assert out["rollout_steps"] == [16] and out["videos"] == []


def test_options_that_wait_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        learner.main(["--sweep", "pro_ant", "--device", "cpu", "--logdir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        learner.main(TINY[2:] + ["--engine", "v2", "--env", "inverted_pendulum",
                                  "--backend", "spring", "--logdir", str(tmp_path)])
