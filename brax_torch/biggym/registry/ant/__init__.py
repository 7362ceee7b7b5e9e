"""Example BIG-Gym submission: the standard four-legged ant component,
entered into every goal-oriented track including the match-making ones."""

AUTHORS = ("brax_torch maintainers",)
CONTACTS = ("github.com/brax-tpu/issues",)
AFFILIATIONS = ("brax_torch",)
DESCRIPTIONS = ("ant with four legs",)

ENVS = {}
COMPONENTS = {
    "ant": {
        "module": "ant:get_specs",
        "tracks": (
            "race",
            "race_ma",
            "sumo",
            "onigokko_predator",
            "onigokko_prey",
        ),
    },
}
