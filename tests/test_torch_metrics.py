"""brax_torch.io.metrics against brax_tpu.io.metrics (tensorboardX) on the
CPU: the same scalars through both Writers decode, with tensorboardX's own
Event protobuf, to the same (tag, step, value) records; every record's
CRCs check out by tensorboardX's CRC-32C; the port's reader reads both
files alike."""

import glob
import json
import os
import struct

import pytest

from brax_torch.io import metrics

from tests.torch_parity import one_torch_thread  # noqa: F401

SCALARS = [
    (0, {"eval/episode_reward": -115.5, "eval/avg_episode_length": 1000.0}),
    (163840, {"eval/episode_reward": 972.125, "training/sps": 151234.56789,
              "training/total_loss": 0.1 + 1e-9, "eval/odd tag!": 3}),
    (2 ** 40, {"eval/episode_reward": float("inf"), "training/walltime": 1e-30}),
]


def _records(path):
    """tensorboardX's Events of a file, each record's two CRCs checked."""
    from tensorboardX.proto import event_pb2
    from tensorboardX.record_writer import masked_crc32c

    raw = open(path, "rb").read()
    events, at = [], 0
    while at < len(raw):
        header = raw[at:at + 8]
        (length,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", raw[at + 8:at + 12])[0] == masked_crc32c(header)
        data = raw[at + 12:at + 12 + length]
        assert struct.unpack("<I", raw[at + 12 + length:at + 16 + length])[0] == \
            masked_crc32c(data)
        event = event_pb2.Event()
        event.ParseFromString(data)
        events.append(event)
        at += 16 + length
    return events


def _scalars(events):
    return [(v.tag, e.step, v.simple_value) for e in events if e.HasField("summary")
            for v in e.summary.value]


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    from brax_tpu.io import metrics as jax_metrics

    out = {}
    for name, writer_cls in (("port", metrics.Writer), ("jax", jax_metrics.Writer)):
        logdir = str(tmp_path_factory.mktemp(name))
        with writer_cls(logdir) as writer:
            writer.write_hparams({"num_evals": 2, "num_envs": 16, "total_env_steps": 4096})
            for step, scalars in SCALARS:
                writer.write_scalars(step, scalars)
        files = sorted(glob.glob(os.path.join(logdir, "events.out.tfevents.*")))
        assert len(files) == 1, files
        out[name] = (logdir, files[0])
    return out


def test_scalars_decode_to_the_jax_writers_records(logs):
    port, jax = (_records(logs[k][1]) for k in ("port", "jax"))
    assert port[0].file_version == jax[0].file_version == "brain.Event:2"
    assert _scalars(port) == _scalars(jax)
    assert len(_scalars(port)) == sum(len(s) for _, s in SCALARS)
    assert ("eval/odd_tag_", 163840, 3.0) in _scalars(port)
    assert all(e.wall_time > 0 for e in port)


def test_port_reader_reads_both_files(logs):
    port, jax = (metrics.read_scalars(logs[k][1]) for k in ("port", "jax"))
    assert port == jax == _scalars(_records(logs["jax"][1]))
    assert metrics.read_events(logs["port"][1])[0]["file_version"] == "brain.Event:2"


def test_hparams_json_and_a_bad_crc(logs, tmp_path):
    with open(os.path.join(logs["port"][0], "hparams.json")) as f:
        assert json.load(f) == {"num_evals": 2, "num_envs": 16, "total_env_steps": 4096}
    raw = bytearray(open(logs["port"][1], "rb").read())
    raw[-5] ^= 1
    bad = tmp_path / "events.out.tfevents.bad"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="bad CRC"):
        metrics.records(str(bad))
