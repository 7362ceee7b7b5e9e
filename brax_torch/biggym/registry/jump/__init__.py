"""Example BIG-Gym submission: an open-ended jumping task."""

AUTHORS = ("brax_torch maintainers",)
CONTACTS = ("github.com/brax-tpu/issues",)
AFFILIATIONS = ("brax_torch",)
DESCRIPTIONS = ("halfcheetah rewarded for vertical takeoff instead of running",)

ENVS = {
    "cheetah": {
        "module": "cheetah:JumpCheetah",
        "tracks": ["rl", "mimax"],
        # root z-velocity obs dim (see envs/cheetah.py), for skill discovery
        "obs_indices": {"vel": ((10,), 5.0)},
    },
}
COMPONENTS = {}
