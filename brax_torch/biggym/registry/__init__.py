"""Registry of BIG-Gym submission packages (counterpart of
`brax_tpu/biggym/registry/__init__.py`): the list of directory submissions
register_all() loads, plus the namespacing helpers."""

# keep alphabetical ordering
REGISTRIES = [
    "ant",
    "jump",
    "proant",
]


def get_comp_name(registry_name: str, comp_name: str) -> str:
    return f"{registry_name}_{comp_name}"


def get_env_name(registry_name: str, env_name: str) -> str:
    return f"{registry_name}_{env_name}"
