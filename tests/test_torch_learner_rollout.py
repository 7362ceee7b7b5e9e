"""The learner CLI's artifacts on the CPU: a v1 run's rollout page and npy
trajectory (inverted_pendulum, whose scene renders), a v2 run's page, the
`brax_training` tool's params and page, `aot.prebuild` (nothing to build
on the CPU), and the new modules importing no JAX."""

import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from brax_torch import aot
from brax_torch.io import model, npy_file
from brax_torch.training import learner

from tests.torch_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--num_envs", "16", "--batch_size", "16", "--num_minibatches", "2",
        "--unroll_length", "4", "--total_env_steps", "256", "--num_evals", "2",
        "--episode_length", "16"]


def _system(page: str) -> dict:
    """The scene/trajectory JSON a viewer page embeds."""
    assert "brax-tpu-viewer" in page and "function mat4Identity" in page
    return json.loads(re.search(r"<script>const system = (.*);</script>", page).group(1))


def test_v1_rollout_page_and_npy(tmp_path):
    out = learner.main(TINY + ["--env", "inverted_pendulum", "--learner", "ppo", "--logdir",
                               str(tmp_path), "--num_videos", "2", "--num_trajectories_npy", "1"])
    assert out["videos"] == [str(tmp_path / f"saved_videos/trajectory_{i:04d}.html")
                             for i in range(2)]
    assert out["trajectories"] == [str(tmp_path / "saved_qps/trajectory_0000.npy")]
    steps = out["rollout_steps"][0]
    assert len(out["rollout_steps"]) == 2 and 0 < steps <= 16
    system = _system(Path(out["videos"][0]).read_text())
    assert len(system["pos"]) == steps and len(system["pos"][0]) == 2
    assert [b["name"] for b in system["config"]["bodies"]] == ["cart", "pole"]
    qps = npy_file.load(out["trajectories"][0])
    assert qps["pos"].shape == (steps, 2, 3) and qps["rot"].shape == (steps, 2, 4)
    assert qps["pos"].tolist() == system["pos"]
    assert isinstance(model.load_params(out["params"])[1]["hidden_0.kernel"], torch.Tensor)


def test_v2_run_writes_its_page(tmp_path):
    out = learner.main(TINY + ["--engine", "v2", "--env", "inverted_pendulum", "--learner",
                               "ppo", "--logdir", str(tmp_path), "--num_trajectories_npy", "1"])
    assert out["videos"] == [str(tmp_path / "saved_videos/trajectory_0000.html")]
    assert out["trajectories"] == []  # v2 rollouts go to pages only, as in the JAX CLI
    system = _system(Path(out["videos"][0]).read_text())
    assert len(system["pos"]) == out["rollout_steps"][0] > 0
    assert [b["name"] for b in system["config"]["bodies"]] == ["cart", "pole"]


def test_brax_training_saves_params_and_a_rollout_page(tmp_path):
    from brax_torch.tools import brax_training

    brax_training.main(["--env", "inverted_pendulum", "--num_timesteps", "64", "--num_envs",
                        "8", "--batch_size", "2", "--device", "cpu", "--logdir", str(tmp_path)],
                       num_minibatches=4, unroll_length=2, num_updates_per_batch=1,
                       num_eval_envs=2, episode_length=6)
    normalizer, policy = model.load_params(str(tmp_path / "inverted_pendulum_params.pkl"))
    assert float(normalizer.count) > 0 and "hidden_0.kernel" in policy
    system = _system((tmp_path / "inverted_pendulum_rollout.html").read_text())
    assert len(system["pos"]) == 6


def test_aot_prebuild_on_the_cpu_builds_nothing():
    assert aot.prebuild("ant", device="cpu") == {"seconds": 0.0, "built": [], "libraries": []}
    assert sorted(aot.libraries("ant", device="cpu")) == ["fused_mlp", "pbd_step"]
    v2 = aot.libraries("inverted_pendulum", engine="v2", device="cpu")
    assert list(v2) == ["gen_step", "fused_mlp"]
    assert v2["gen_step"].source.name.startswith("gen_step_")


def test_new_modules_import_no_jax():
    code = ("import sys, brax_torch.training.learner, brax_torch.aot, brax_torch.io.json, "
            "brax_torch.io.html, brax_torch.io.metrics, brax_torch.io.model, "
            "brax_torch.io.npy_file, brax_torch.io.file, brax_torch.v2.io, "
            "brax_torch.training.spectral_norm, brax_torch.training.checkpoint; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'brax_tpu', 'flax', 'optax', 'tensorboardX', 'tensorboard')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
