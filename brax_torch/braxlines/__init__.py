"""Counterpart of `brax_tpu/braxlines`: RL beyond rewards, skill discovery
(VGCRL/DIAYN) and adversarial IRL (GAIL/AIRL/FAIRL) on the PPO trainer's
auxiliary-learner hooks (`train`, `discriminators`, `wrappers`,
`evaluators`, `obs_indices`), and the published PPO presets (`defaults`)."""
