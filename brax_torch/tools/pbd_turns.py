"""The v1 PBD kernel built from another `pbd_step.cu` held against this
package's, per scene, on the card.

    python -m brax_torch.tools.pbd_turns OTHER_PBD_STEP_CU [scene ...]

OTHER_PBD_STEP_CU is, for example, a parent commit's source unpacked by
`git archive` into a directory that `.gitignore` lists.  It is compiled with
this package's scene header in front (`kernels.scene_header`), as this
package compiles its own, so it must read the same header and export the
same C interface (`brax_pbd_step`, `brax_pbd_step_sizes`,
`brax_pbd_step_occupancy`).  For each scene (default: the sixteen PBD
Systems of the registry: ant, humanoid (humanoid_legacy builds the same
System), humanoidstandup, halfcheetah, pusher, inverted_pendulum,
inverted_double_pendulum, swimmer, reacherangle, reacher, grasp, acrobot,
ur5e, fetch, hopper, walker2d) both builds' SASS instructions are
compared (cuobjdump; the same code when equal), and both kernels step the
same 4096 envs, 10 twin steps after a reset (in contact), and the first
2048 and 128 of them: the largest difference of their outputs (0: the
same bits), and their time per launch replayed from a CUDA graph of CALLS
launches, in turns (other, this, this, other).  Prints a line per scene
and batch, the card's name and power limit, and a last line
`RESULT {...}`.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import sys
from pathlib import Path

import torch

from brax_torch import cuda_build, envs
from brax_torch.sim import kernels
from brax_torch.tools import probe_overhead as probe

SCENES = ("ant", "humanoid", "humanoidstandup", "halfcheetah", "pusher", "inverted_pendulum",
          "inverted_double_pendulum", "swimmer", "reacherangle", "reacher", "grasp", "acrobot",
          "ur5e", "fetch", "hopper", "walker2d")
BATCHES = (4096, 2048, 128)
CALLS = 20
OUTPUTS = ("pos", "rot", "vel", "ang", "contact_vel", "contact_ang")


def other_source(sys_, source: Path) -> Path:
    """`source` with the scene header of `sys_` in front, written under
    the build directory (named by the text's hash)."""
    text = kernels.scene_header(sys_) + '#line 1 "pbd_step.cu"\n' + source.read_text()
    key = hashlib.sha256(text.encode()).hexdigest()[:16]
    path = kernels.BUILD_DIR / f"pbd_step_other_{key}.cu"
    if not path.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return path


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_build.build(path)[path]))
    kernels._setup(lib, path)
    return lib


def launch(lib: ctypes.CDLL, ins, outs) -> None:
    """One launch of a library's kernel; ins (pos, rot, vel, ang, act)."""
    n, n_act = ins[0].shape[0], ins[4].shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.brax_pbd_step(*[t.data_ptr() for t in ins + outs], n, n_act, stream)
    if err != 0:
        raise RuntimeError(f"pbd_step launch failed: CUDA error {err}")


def scene_state(name: str, n: int):
    """n envs of `name`, 10 twin steps after a reset, and an action."""
    env = envs.create(name, episode_length=1000, batch_size=n)
    gen = torch.Generator(device="cuda").manual_seed(0)
    act = lambda: torch.rand((n, env.action_size), generator=gen, device="cuda") * 2 - 1
    qp = env.reset(gen).qp
    for _ in range(10):
        qp, _ = kernels.pbd_step_plain(env.sys, qp, act())
    return env.sys, (qp.pos, qp.rot, qp.vel, qp.ang, act())


def main(argv) -> dict:
    if not torch.cuda.is_available():
        sys.exit("pbd_turns needs a CUDA device; torch.cuda.is_available() is False")
    other = Path(argv[0]).resolve()
    scenes = argv[1:] or SCENES
    card = cuda_build.card()
    print(card)
    states = {name: scene_state(name, max(BATCHES)) for name in scenes}
    pairs = {name: (kernels.kernel_source(s), other_source(s, other))
             for name, (s, _) in states.items()}
    cuda_build.build(*(p for pair in pairs.values() for p in pair))
    result = {"card": card, "other": str(other), "calls_per_graph": CALLS, "scenes": {}}
    for name, (sys_, ins_all) in states.items():
        libs = {"this": kernels._loaded(sys_), "other": load(pairs[name][1])}
        for side, src in zip(("this", "other"), pairs[name]):
            report = cuda_build.library_path(src).with_suffix(".ptxas.txt").read_text()
            print(f"{name} {side}: " + " ".join(line.strip() for line in report.splitlines()
                                               if "registers" in line or "spill" in line))
        same_sass = (cuda_build.sass(cuda_build.library_path(pairs[name][0]))
                     == cuda_build.sass(cuda_build.library_path(pairs[name][1])))
        print(f"{name}: the same SASS instructions in both builds: {same_sass}")
        result["scenes"][name] = rec = {"same_sass": same_sass}
        for n in BATCHES:
            ins = tuple(t[:n].contiguous() for t in ins_all)
            outs = {side: tuple(torch.empty((n, sys_.num_bodies, c), device="cuda")
                                for c in (3, 4, 3, 3, 3, 3)) for side in libs}
            for side, lib in libs.items():
                launch(lib, ins, outs[side])
            torch.cuda.synchronize()
            diff = {k: float((a - b).abs().max())
                    for k, a, b in zip(OUTPUTS, outs["this"], outs["other"])}
            ms = {"other": [], "this": []}
            for side in ("other", "this", "this", "other"):
                ms[side].append(probe.graph_us(
                    lambda i, lib=libs[side], o=outs[side]: launch(lib, ins, o), CALLS) / 1e3)
            rec[n] = {"max_abs_diff": diff, "same_bits": not any(diff.values()), "ms": ms}
            print(f"{name} at {n} envs: max|this - other| {diff}; ms graph-replayed in turns "
                  f"other {ms['other'][0]:.5f}, this {ms['this'][0]:.5f}, this "
                  f"{ms['this'][1]:.5f}, other {ms['other'][1]:.5f} [{card}]")
    print("RESULT " + json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
