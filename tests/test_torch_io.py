"""brax_torch.io against brax_tpu.io on the CPU: an ant trajectory of 6
states from the JAX package (its reset and five zero-action physics steps,
as tests/test_io_and_interop.py makes one, through the shared jits of
tests/torch_parity.py), carried into the port's QP, gives the same viewer
JSON (with and without the contact overlay) and the same HTML page, byte
for byte, and the same npy arrays; params files round-trip."""

import collections
import dataclasses
import functools
import json
import types

import numpy as np
import torch

from brax_torch.envs.ant import Ant
from brax_torch.io import file as io_file
from brax_torch.io import html, model, npy_file
from brax_torch.io import json as io_json
from brax_torch.sim.types import QP
from brax_torch.training import running_statistics

from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401


@functools.lru_cache(maxsize=None)
def jax_trajectory():
    """Env 0's JAX QPs and Infos over a reset and five zero-action steps."""
    import jax

    qp, _, info = tp.jax_reset()(*tp.noise())
    act = np.zeros((tp.N_ENVS, 8), np.float32)
    qps, infos = [qp], [info]
    for _ in range(5):
        qp, info = tp.jax_raw_step()(qp, act)
        qps.append(qp)
        infos.append(info)
    first = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x[0]), tree)
    return [first(q) for q in qps], [first(i) for i in infos]


def port_trajectory():
    qps, infos = jax_trajectory()
    port_qps = [QP.from_numpy(*tp.qp_numpy(q), device="cpu") for q in qps]
    port_infos = [types.SimpleNamespace(**{k: torch.from_numpy(np.array(getattr(i, k)))
                                           for k in ("contact_pos", "contact_normal",
                                                     "contact_penetration")})
                  for i in infos]
    return port_qps, port_infos


def test_json_dumps_equals_jax():
    from brax_tpu.io import json as jax_json

    qps, infos = jax_trajectory()
    port_qps, port_infos = port_trajectory()
    config = Ant(batch_size=1, device="cpu").art.config
    got = io_json.dumps(config, port_qps)
    assert got == jax_json.dumps(tp.jax_ant().art.config, qps)
    d = json.loads(got)
    assert len(d["pos"]) == 6 and d["config"]["bodies"][0]["name"] == "$ Torso"
    # the contact overlay
    assert (io_json.dumps(config, port_qps, port_infos)
            == jax_json.dumps(tp.jax_ant().art.config, qps, infos))


def test_html_page_equals_jax(tmp_path):
    from brax_tpu.io import html as jax_html

    qps, _ = jax_trajectory()
    port_qps, _ = port_trajectory()
    html.save_html(str(tmp_path / "port" / "view.html"),
                   Ant(batch_size=1, device="cpu").art.config, port_qps)
    jax_html.save_html(str(tmp_path / "jax.html"), tp.jax_ant().art.config, qps)
    page = (tmp_path / "port" / "view.html").read_bytes()
    assert page == (tmp_path / "jax.html").read_bytes()
    assert b"brax-tpu-viewer" in page and b"const system" in page


def test_npy_file_writes_the_same_arrays(tmp_path):
    from brax_tpu.io import npy_file as jax_npy

    qps, _ = jax_trajectory()
    port_qps, _ = port_trajectory()
    npy_file.save(str(tmp_path / "port.npy"), port_qps)
    jax_npy.save(str(tmp_path / "jax.npy"), qps)
    got, want = npy_file.load(str(tmp_path / "port.npy")), jax_npy.load(str(tmp_path / "jax.npy"))
    assert sorted(got) == sorted(want) == ["ang", "pos", "rot", "vel"]
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
        np.testing.assert_array_equal(got[key], want[key])
    assert got["pos"].shape == (6, 10, 3)


Pair = collections.namedtuple("Pair", "a b")


def test_model_round_trip(tmp_path):
    """The nested structure comes back with its types; every tensor is on
    the CPU and detached, whatever device and autograd state it had."""
    norm = running_statistics.init_state((3,), device="cpu")
    w = torch.arange(4.0, requires_grad=True)
    params = (norm, {"hidden_0.kernel": w * 2, "n": 3}, Pair(torch.ones(2), [torch.zeros(1)]))
    path = str(tmp_path / "sub" / "params.pkl")
    model.save_params(path, params)
    loaded = model.load_params(path)
    assert isinstance(loaded[0], running_statistics.RunningStatisticsState)
    assert isinstance(loaded[2], Pair) and loaded[1]["n"] == 3
    for f in dataclasses.fields(norm):
        assert torch.equal(getattr(loaded[0], f.name), getattr(norm, f.name))
    k = loaded[1]["hidden_0.kernel"]
    assert torch.equal(k, w.detach() * 2) and not k.requires_grad and k.device.type == "cpu"
    assert torch.equal(loaded[2].b[0], torch.zeros(1))
    # the JAX package reads the port's file as a pickle, and the port the JAX one's
    from brax_tpu.io import model as jax_model

    jax_model.save_params(str(tmp_path / "jax.pkl"), {"w": np.arange(3.0)})
    np.testing.assert_array_equal(model.load_params(str(tmp_path / "jax.pkl"))["w"],
                                  np.arange(3.0))
    assert torch.equal(jax_model.load_params(path)[1]["hidden_0.kernel"], k)


def test_file_seam(tmp_path):
    path = str(tmp_path / "a" / "b" / "f.txt")
    with io_file.File(path, "w") as f:
        f.write("x")
    assert io_file.Exists(path) and io_file.Glob(str(tmp_path / "a" / "*" / "*.txt")) == [path]
    io_file.MakeDirs(str(tmp_path / "c"))
    assert io_file.Exists(str(tmp_path / "c"))
