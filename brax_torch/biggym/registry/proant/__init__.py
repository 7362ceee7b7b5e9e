"""Example BIG-Gym submission: the procedural-legged ant as a component.
Registering the component creates its race/chase/sumo track envs."""

AUTHORS = ("brax_torch maintainers",)
CONTACTS = ("github.com/brax-tpu/issues",)
AFFILIATIONS = ("brax_torch",)
DESCRIPTIONS = ("ant with a configurable number of procedurally-placed legs",)

ENVS = {}
COMPONENTS = {
    "ant": {"module": "ant:get_specs"},
}
