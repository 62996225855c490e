"""Two-process distributed ingest + sharded receive on CPU (SURVEY §5.8).

Exercises the real multi-host code path — ``jax.distributed.initialize`` +
``jax.make_array_from_process_local_data`` (`parallel/ingest.py`) + cross-
process collectives (Gloo) — without accelerators: 2 processes x 4 virtual
CPU devices = the same 8-device {channel:2, time:4} mesh the single-process
tests use, but with each "host" contributing only its own channel's capture.
"""

import json
import os
import socket
import subprocess
import sys


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_ingest():
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    worker = os.path.join(os.path.dirname(__file__), "_mp_worker.py")

    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), str(port)],
        env=env, cwd=repo, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for pid in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=560)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-2000:]}"
        outs.append(out)

    for pid, out in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, out
        res = json.loads(lines[-1][len("RESULT "):])
        assert res["pid"] == pid
        frames = res["frames"]
        # each host decodes exactly its own channel's 3 frames (incl. the
        # shard-boundary straddler), CRC-clean, payload-exact
        assert sorted(f["seq"] for f in frames) == [0, 1, 2], frames
        assert all(f["crc_ok"] and f["payload_ok"] for f in frames), frames
        # phase 2: distributed CONTINUOUS streaming — 2 buffers with a
        # device-resident channel-sharded carry state; the frame straddling
        # the buffer boundary decodes exactly once via the halo
        sframes = res["stream_frames"]
        assert sorted(f["seq"] for f in sframes) == [0, 1, 2], sframes
        assert all(f["crc_ok"] and f["payload_ok"] for f in sframes), sframes
        assert res["stream_seen"] == 3    # this host's channel, 2 buffers
