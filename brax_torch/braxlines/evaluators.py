"""Skill and IRL evaluators: rollouts per skill, diversity metrics, plots.

Counterpart of `brax_tpu/braxlines/evaluators.py`, batch-first: every
skill rolls out in one batched episode (an env per skill), the mutual
information estimate is a binned histogram, and the plots are
matplotlib/Agg files; matplotlib is imported inside the plotting
functions, so that nothing else needs it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from brax_torch import envs
from brax_torch.braxlines.discriminators import IRLDiscriminator, SkillDiscriminator
from brax_torch.braxlines.wrappers import SkillWrapper

Tensor = torch.Tensor


def skill_basis(disc: SkillDiscriminator, num_skills: Optional[int] = None,
                device="cpu") -> Tensor:
    """A deterministic spread of skills: one-hot rows for a categorical
    prior, a [-1, 1] grid (times q_scale) for a continuous one."""
    if disc.dist_p == "categorical":
        return torch.eye(disc.z_size, device=device)
    n = num_skills or 8
    col = torch.linspace(-1.0, 1.0, n, device=device) * disc.q_scale
    return torch.stack([col] * disc.z_size, dim=-1)


@torch.no_grad()
def rollout_skills(environment: Union[str, envs.EnvFactory], disc: SkillDiscriminator,
                   policy_fn, generator: torch.Generator, episode_length: int = 128,
                   num_skills: Optional[int] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Rolls out every skill at once: an env per skill, built on the
    generator's device by `environment` (an env name or a factory).

    policy_fn(obs, generator) -> (action, extras), the trainer's policy.
    Returns (zs (Z, z_size), obs (Z, T, obs_size), reward (Z, T)), obs the
    env's own observation (no z tail).
    """
    device = generator.device
    zs = skill_basis(disc, num_skills, device)
    env = SkillWrapper(envs.factory(environment)(zs.shape[0], device), disc)
    obs_size = env.env.observation_size
    state = env.reset(generator)
    # one fixed skill per env
    state = state.replace(obs=torch.cat([state.obs[:, :obs_size], zs], dim=-1),
                          info=dict(state.info, skill_z=zs))
    obs, reward = [], []
    for _ in range(episode_length):
        act, _ = policy_fn(state.obs, generator)
        state = env.step(state, act)
        obs.append(state.obs[:, :obs_size])
        reward.append(state.reward)
    return zs, torch.stack(obs, dim=1), torch.stack(reward, dim=1)


def estimate_skill_mi(obs: Tensor, obs_indices: Sequence[int], bins: int = 16) -> float:
    """Binned mutual information I(skill; s[obs_indices]) in nats, averaged
    over the indexed dims; obs is (Z, T, obs_size), the skill its row.  At
    most log(Z) for categorical skills."""
    mis = []
    for dim in obs_indices:
        x = obs[:, :, dim]
        lo, hi = torch.min(x), torch.max(x)
        edges = torch.linspace(float(lo), float(hi + 1e-6), bins + 1, device=x.device)
        b = torch.clamp(torch.searchsorted(edges, x.contiguous()) - 1, 0, bins - 1)
        joint = torch.stack([torch.bincount(row, minlength=bins) for row in b]).to(torch.float32)
        joint = joint / torch.sum(joint)
        pz = torch.sum(joint, dim=1, keepdim=True)
        pb = torch.sum(joint, dim=0, keepdim=True)
        ratio = torch.where(joint > 0, joint / (pz * pb + 1e-12), torch.ones_like(joint))
        mis.append(torch.sum(joint * torch.log(ratio)))
    return float(torch.mean(torch.stack(mis)))


@torch.no_grad()
def skill_metrics(disc: SkillDiscriminator, disc_params, zs: Tensor, obs: Tensor,
                  bins: int = 16) -> dict:
    """Diversity summary: the binned MI, the mean discriminator reward, and
    the spread of the visited indexed-obs means across skills."""
    z = zs[:, None, :].expand(obs.shape[:2] + zs.shape[-1:])
    rewards = disc.reward(disc_params, obs, z)  # (Z, T)
    per_skill_mean = torch.mean(obs[:, :, list(disc.obs_indices)], dim=1)
    return {
        "mi": estimate_skill_mi(obs, tuple(disc.obs_indices), bins),
        "disc_reward_mean": float(torch.mean(rewards)),
        "skill_mean_spread": float(torch.std(per_skill_mean, correction=0)),
    }


def _save(fig, output_path: Optional[str], output_name: str):
    if output_path:
        import os

        os.makedirs(output_path, exist_ok=True)
        fig.savefig(f"{output_path}/{output_name}.png", dpi=110)
    return fig


def visualize_skills(zs: Tensor, obs: Tensor, obs_indices: Sequence[int],
                     output_path: Optional[str] = None, output_name: str = "skills"):
    """A 2D scatter of the visited states coloured by skill, the first two
    indexed dims (a single index plots against time)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    obs = obs.detach().cpu().numpy()
    fig, ax = plt.subplots(figsize=(5, 4))
    idx = list(obs_indices)
    for z in range(obs.shape[0]):
        if len(idx) >= 2:
            ax.plot(obs[z, :, idx[0]], obs[z, :, idx[1]], ".", ms=2, label=f"z={z}")
            ax.set(xlabel=f"obs[{idx[0]}]", ylabel=f"obs[{idx[1]}]")
        else:
            ax.plot(obs[z, :, idx[0]], ".", ms=2, label=f"z={z}")
            ax.set(xlabel="t", ylabel=f"obs[{idx[0]}]")
    ax.legend(fontsize=7)
    fig.tight_layout()
    return _save(fig, output_path, output_name)


def energy_distance(x: Tensor, y: Tensor, max_samples: int = 512) -> float:
    """The energy distance between two state samples:
    2 E||X-Y|| - E||X-X'|| - E||Y-Y'||."""
    x = x.reshape(-1, x.shape[-1])[:max_samples]
    y = y.reshape(-1, y.shape[-1])[:max_samples]
    mean_pdist = lambda a, b: torch.mean(torch.linalg.norm(a[:, None, :] - b[None, :, :], dim=-1))
    return float(2 * mean_pdist(x, y) - mean_pdist(x, x) - mean_pdist(y, y))


@torch.no_grad()
def visualize_disc(disc: IRLDiscriminator, disc_params, target_data: Tensor,
                   policy_data: Optional[Tensor] = None, dims: Tuple[int, int] = (0, 1),
                   grid_n: int = 64, output_path: Optional[str] = None,
                   output_name: str = "disc"):
    """The discriminator's reward as a heatmap over a 2D slice of the data
    space, with the target (and policy) samples on it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    td = target_data.reshape(-1, target_data.shape[-1]).detach().cpu().numpy()
    lo, hi = td.min(axis=0) - 0.5, td.max(axis=0) + 0.5
    gx = np.linspace(lo[dims[0]], hi[dims[0]], grid_n)
    gy = np.linspace(lo[dims[1]], hi[dims[1]], grid_n)
    base = np.tile(td.mean(axis=0), (grid_n * grid_n, 1))
    xx, yy = np.meshgrid(gx, gy)
    base[:, dims[0]] = xx.ravel()
    base[:, dims[1]] = yy.ravel()
    device = next(iter(disc_params.values())).device
    r = disc.reward(disc_params, torch.tensor(base, dtype=torch.float32, device=device))
    r = r.reshape(grid_n, grid_n).cpu().numpy()

    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.pcolormesh(gx, gy, r, shading="auto")
    fig.colorbar(im, ax=ax, label="disc reward")
    ax.plot(td[:, dims[0]], td[:, dims[1]], "w.", ms=2, label="target")
    if policy_data is not None:
        pd = policy_data.reshape(-1, policy_data.shape[-1]).detach().cpu().numpy()
        ax.plot(pd[:, dims[0]], pd[:, dims[1]], "r.", ms=2, label="policy")
    ax.legend(fontsize=7)
    ax.set(xlabel=f"data[{dims[0]}]", ylabel=f"data[{dims[1]}]")
    fig.tight_layout()
    return _save(fig, output_path, output_name)
