"""brax_torch.v2.io against brax_tpu/v2/io.py on the CPU: v2 ant pipeline
States from the JAX package (its generalized pipeline.init and one step of
16 ants, tests/torch_parity.py's shared jits), carried across env by env
into the port's State, give the same viewer JSON over the port's own v2 ant
System, and the same page."""

import json

import numpy as np
import torch

from brax_torch.v2 import envs as v2_envs
from brax_torch.v2 import io as v2_io
from brax_torch.v2.base import Motion, State, Transform

from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401


def _trajectory():
    """Six JAX States of one env each (envs 0-2 at reset and a step on),
    and the port's States holding their numbers."""
    import jax

    s0, s1 = tp.jax_v2_states(0)
    jax_states = [jax.tree_util.tree_map(lambda x: x[i], s) for s in (s0, s1) for i in range(3)]
    t = lambda x: torch.from_numpy(np.array(x))
    port_states = [State(q=t(s.q), qd=t(s.qd), x=Transform(pos=t(s.x.pos), rot=t(s.x.rot)),
                         xd=Motion(ang=t(s.xd.ang), vel=t(s.xd.vel)), contact=None)
                   for s in jax_states]
    return jax_states, port_states


def test_v2_dumps_and_page_equal_jax(tmp_path):
    from brax_tpu.v2 import io as jax_v2_io

    jax_states, port_states = _trajectory()
    sys = v2_envs.get_environment("ant", device="cpu").sys
    got = v2_io.dumps(sys, port_states)
    assert got == jax_v2_io.dumps(tp.jax_v2_ant().sys, jax_states)
    d = json.loads(got)
    assert len(d["pos"]) == 6 and [b["name"] for b in d["config"]["bodies"]][-1] == "world"
    # a batch of one env per State serializes alike
    batched = [State(q=s.q[None], qd=s.qd[None], x=Transform(pos=s.x.pos[None],
                                                              rot=s.x.rot[None]),
                     xd=s.xd, contact=None) for s in port_states]
    assert v2_io.dumps(sys, batched) == got
    v2_io.save_html(str(tmp_path / "v" / "page.html"), sys, port_states)
    jax_v2_io.save_html(str(tmp_path / "jax.html"), tp.jax_v2_ant().sys, jax_states)
    assert (tmp_path / "v" / "page.html").read_bytes() == (tmp_path / "jax.html").read_bytes()
