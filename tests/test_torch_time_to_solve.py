"""`python -m brax_torch.tools.time_to_solve` at a tiny size on the CPU:
PPO on `fast` with the recipe's widths cut by overrides; it prints each
evaluation, one CURVE line and, last, one well-formed RESULT line."""

import json

from brax_torch.tools import time_to_solve

from tests.torch_parity import one_torch_thread  # noqa: F401


def test_time_to_solve_prints_result(capsys):
    out = time_to_solve.main(
        ["--env", "fast", "--threshold", "5", "--num_timesteps", "4096", "--num_evals", "3",
         "--device", "cpu"],
        num_envs=16, batch_size=16, num_minibatches=4, unroll_length=8, episode_length=64,
        num_eval_envs=16)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("RESULT ") and lines[-2].startswith("CURVE ")
    result = json.loads(lines[-1][len("RESULT "):])
    assert result == out
    assert set(result) >= {"threshold", "solved", "solve_steps", "solve_walltime_s",
                           "final_reward", "setup_s"}
    curve = json.loads(lines[-2][len("CURVE "):])["curve"]
    assert [c[0] for c in curve] == [0, 2048, 4096]
    assert curve[0][2] == 0.0 and all(a[2] <= b[2] for a, b in zip(curve, curve[1:]))
    assert result["final_reward"] == curve[-1][1]
    # fast's eval reward after 64 steps is far above 5: solved at the first eval
    assert result["solved"] and result["solve_steps"] == 0
    assert result["solve_walltime_s"] == 0.0 and result["threshold"] == 5.0
