"""BIG-Gym: a crowd-sourced registry of environments, components and tasks.

Counterpart of `brax_tpu/biggym/__init__.py`.  Contributors register (a)
plain envs, (b) composer components, which are then entered into
goal-oriented task tracks (race/sumo/chase) built on the port's composer.
Submissions are single calls (`register`) or whole packages
(`register_module`) in the submission format: AUTHORS / CONTACTS /
AFFILIATIONS / DESCRIPTIONS tuples plus ENVS / COMPONENTS dicts.

`create(name, batch_size=..., device=...)` builds a registered env on
`device` (CUDA unless asked otherwise): a task env through
`brax_torch.composer.create` (episode, vmap and auto-reset wrappers), a
plain env (jump_cheetah) as its class builds it.  Every scene steps
through the PBD kernel on CUDA tensors; a System the kernel does not cover
raises NotImplementedError naming the feature at its first step
(`kernels.pbd_step_launch`).
"""

from __future__ import annotations

import difflib
import functools
import importlib
import inspect
import itertools
from typing import Any, Callable, Dict, Optional

from brax_torch import envs as base_envs
from brax_torch.biggym import tasks
from brax_torch.composer import components as composer_components

ENVS: Dict[str, Callable] = {}
COMPONENTS: Dict[str, str] = {}
REGISTRIES: Dict[str, dict] = {}
ENVS_BY_TRACKS: Dict[str, list] = {
    "open_ended": [],
    "mimax": [],
    **{k: [] for k in tasks.TASKS},
}
SUBMISSION_FIELDS = ("AUTHORS", "CONTACTS", "AFFILIATIONS", "DESCRIPTIONS")
ROOT_PATH = "brax_torch.biggym.registry"


def register(
    registry_name: str,
    env_fn: Optional[Callable] = None,
    component_fn: Optional[Callable] = None,
    track: str = "open_ended",
    tracks: Optional[tuple] = None,
):
    """Registers a contributed env and/or composer component.

    Registering a component creates one task env per entered goal-oriented
    track (e.g. race_<name>) and enters the component into that track's
    match-making pool (see register_matches).  `tracks` defaults to every
    single-agent track; match tracks (race_ma/sumo/onigokko_*) only enter
    the pool: their envs are created pairwise by register_matches().
    """
    created = []
    if env_fn is not None:
        name = registry_name
        ENVS[name] = env_fn
        base_envs.register(name, env_fn)
        ENVS_BY_TRACKS["open_ended"].append(name)
        created.append(name)
    if component_fn is not None:
        comp_name = registry_name
        composer_components.register_component(comp_name, component_fn)
        COMPONENTS[comp_name] = comp_name
        entered = tuple(tracks) if tracks is not None else tuple(tasks.TASKS)
        valid = set(tasks.TASKS) | set(tasks.MATCH_TASKS)
        unknown = sorted(set(entered) - valid)
        assert not unknown, f"unknown tracks {unknown}; valid: {sorted(valid)}"
        for track_name in entered:
            if track_name in tasks.TASKS:
                env_name = tasks.get_task_env_name(track_name, comp_name)
                ENVS[env_name] = tasks.TASKS[track_name](comp_name)
                ENVS_BY_TRACKS[track_name].append(env_name)
                created.append(env_name)
                if comp_name not in COMPONENTS_BY_TRACKS[track_name]:
                    COMPONENTS_BY_TRACKS[track_name].append(comp_name)
            else:
                # match track: enter the pool of its single-agent feeder
                pool = _match_pool_track(track_name)
                if comp_name not in COMPONENTS_BY_TRACKS[pool]:
                    COMPONENTS_BY_TRACKS[pool].append(comp_name)
    return created


def list_env():
    return sorted(base_envs._envs) + sorted(ENVS)


def exists(env_name: str) -> bool:
    return env_name in list_env()


def assert_exists(env_name: str):
    if not exists(env_name):
        closest = difflib.get_close_matches(env_name, list_env(), n=3)
        raise AssertionError(f"{env_name} not found. Closest={closest}")


def create(env_name: str, **kwargs):
    """Creates a registered (task) environment."""
    assert_exists(env_name)
    if env_name in ENVS:
        return ENVS[env_name](**kwargs)
    return base_envs.create(env_name, **kwargs)


def _validate_metadata(lib, path: str) -> Dict[str, tuple]:
    """Submission-format check: every field is a non-empty tuple of strings."""
    meta = {}
    for field in SUBMISSION_FIELDS:
        values = getattr(lib, field, None)
        if not (isinstance(values, tuple) and values and all(isinstance(v, str) for v in values)):
            raise AssertionError(f"{path}.{field} must be a non-empty tuple of strs, got "
                                 f"{values!r}")
        meta[field] = values
    return meta


def _resolve(path: str, sub_path: str, spec):
    """Resolves 'mod:Attr' module specs relative to a registry package."""
    if not isinstance(spec, str):
        return spec
    mod_path, attr = spec.split(":", 1)
    lib = importlib.import_module(f"{path}.{sub_path}.{mod_path}")
    return getattr(lib, attr)


def register_module(registry_name: str, assert_format: bool = True):
    """Registers a whole submission package: the module defines metadata
    tuples plus ENVS / COMPONENTS dicts whose 'module' entries are
    factories or 'file:Attr' paths.

    Returns (env_names, component_names, task_env_names, metadata).
    """
    if registry_name in REGISTRIES:
        r = REGISTRIES[registry_name]
        return r["envs"], r["components"], r["task_envs"], r["metadata"]

    path = registry_name if "." in registry_name else f"{ROOT_PATH}.{registry_name}"
    lib = importlib.import_module(path)
    metadata = _validate_metadata(lib, path) if assert_format else {}

    env_names, comp_names, task_env_names = [], [], []
    for name, info in sorted(getattr(lib, "ENVS", {}).items() or []):
        env_name = f"{registry_name.rsplit('.', 1)[-1]}_{name}"
        env_fn = _resolve(path, "envs", info["module"])
        register(env_name, env_fn=env_fn)
        env_names.append(env_name)
        for tr in info.get("tracks", ["rl"]):
            if tr == "mimax":
                ENVS_BY_TRACKS["mimax"].append(env_name)
                from brax_torch.braxlines import obs_indices as oi

                for itype, (idx, scale) in info.get("obs_indices", {}).items():
                    oi.register_indices(env_name, itype, idx, scale)
    for name, info in sorted(getattr(lib, "COMPONENTS", {}).items() or []):
        comp_name = f"{registry_name.rsplit('.', 1)[-1]}_{name}"
        comp_fn = _resolve(path, "components", info["module"])
        created = register(comp_name, component_fn=comp_fn, tracks=info.get("tracks"))
        comp_names.append(comp_name)
        task_env_names.extend(created)

    REGISTRIES[registry_name] = {
        "envs": env_names,
        "components": comp_names,
        "task_envs": task_env_names,
        "metadata": metadata,
    }
    return env_names, comp_names, task_env_names, metadata


def register_all(verbose: bool = False, **kwargs):
    """Registers every submission package listed in registry.REGISTRIES."""
    from brax_torch.biggym import registry as registry_pkg

    out = {}
    for registry_name in registry_pkg.REGISTRIES:
        env_names, comp_names, task_env_names, _ = register_module(registry_name, **kwargs)
        if verbose:
            print(f"Registered {registry_name}: {len(env_names)} envs, {len(comp_names)} comps, "
                  f"{len(task_env_names)} task_envs")
        out[registry_name] = (env_names, comp_names, task_env_names)
    return out


# components entered per goal-oriented track, for match-making
COMPONENTS_BY_TRACKS: Dict[str, list] = {k: [] for k in tasks.TASKS}
ENVS_BY_TRACKS["goal_oriented_matches"] = []


def register_match(track: str, comp1: str, comp2: str, assert_override: bool = True) -> str:
    """Registers a head-to-head match env between two contributed components
    on a match track."""
    assert track in tasks.MATCH_TASKS, (track, sorted(tasks.MATCH_TASKS))
    env_name = tasks.get_match_env_name(track, comp1, comp2)
    if assert_override:
        assert not exists(env_name), f"{env_name} already registered"
    ENVS[env_name] = tasks.MATCH_TASKS[track](comp1, opponent=comp2)
    ENVS_BY_TRACKS["goal_oriented_matches"].append(env_name)
    return env_name


def register_matches(assert_override: bool = True):
    """Match-makes every pair of components entered per track: symmetric
    tracks get each unordered pair once, asymmetric tracks get ordered
    pairs (prey/predator roles differ)."""
    task_envs = []
    for track in tasks.SYMMETRIC_MA_TASKS:
        pool = COMPONENTS_BY_TRACKS.get(_match_pool_track(track), [])
        for comp1, comp2 in itertools.combinations(pool, 2):
            task_envs.append(register_match(track, comp1, comp2, assert_override))
    for track in tasks.ASYMMETRIC_MA_TASKS:
        pool = COMPONENTS_BY_TRACKS.get(_match_pool_track(track), [])
        for comp1, comp2 in itertools.product(pool, pool):
            if comp1 == comp2:
                continue
            task_envs.append(register_match(track, comp1, comp2, assert_override))
    return task_envs


def _match_pool_track(match_track: str) -> str:
    """Maps a match track to the single-agent track whose entrants feed it
    (race_ma <- race, sumo <- sumo, onigokko_* <- chase)."""
    return {
        "race_ma": "race",
        "sumo": "sumo",
        "onigokko_prey": "chase",
        "onigokko_predator": "chase",
    }[match_track]


def create_fn(env_name: str, **kwargs) -> Callable:
    """Returns a constructor of the env with `kwargs` bound."""
    return functools.partial(create, env_name, **kwargs)


def inspect_env(env_name: str):
    """Returns (supported_params, accepts_kwargs) of an env constructor."""
    assert_exists(env_name)
    fn = ENVS.get(env_name) or base_envs._envs.get(env_name)
    partial_params: Dict[str, Any] = {}
    while isinstance(fn, functools.partial):
        partial_params.update(fn.keywords)
        fn = fn.func
    params = inspect.signature(fn).parameters
    accepts_kwargs = any(v.kind == inspect.Parameter.VAR_KEYWORD for v in params.values())
    supported = {
        k: v.default
        for k, v in params.items()
        if v.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD
        and v.default is not inspect.Parameter.empty
    }
    supported.update(partial_params)
    return supported, accepts_kwargs


def assert_env_params(env_name: str, env_params: Dict[str, Any], ignore_kwargs: bool = True):
    """Asserts env_params are constructor-supported."""
    supported, accepts_kwargs = inspect_env(env_name)
    if accepts_kwargs and ignore_kwargs:
        return
    unknown = sorted(set(env_params) - set(supported))
    assert not unknown, f"{env_name}: unsupported params {unknown}; supported: {sorted(supported)}"
