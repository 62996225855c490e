"""Binary I/O round-trips, metrics, and the loopback app CLI."""

import os
import subprocess
import sys

import numpy as np

from c_ofdm.io import binio
from c_ofdm.io.trace import StageTrace, link_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_binio_roundtrips(tmp_path):
    rng = np.random.default_rng(0)
    c = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    p = str(tmp_path / "c.bin")
    binio.write_complex64f(p, c)
    assert np.allclose(binio.read_complex64f(p), c)
    i = (rng.standard_normal(64) * 100).astype(np.float64) + \
        1j * (rng.standard_normal(64) * 100)
    p2 = str(tmp_path / "i.bin")
    binio.write_complex_int16(p2, i)
    back = binio.read_complex_int16(p2)
    assert np.allclose(back.real, np.trunc(i.real), atol=0)
    d = rng.standard_normal(10)
    p3 = str(tmp_path / "d.bin")
    binio.write_doubles(p3, d)
    assert np.allclose(binio.read_doubles(p3), d)


def test_binio_reads_reference_artifacts(golden):
    cap = binio.read_complex64f(golden("data/data.bin"))
    assert cap.shape == (246656,)
    src = binio.read_complex_int16(golden("data/source.bin"))
    assert src.shape == (6016,)


def test_stage_trace(tmp_path):
    tr = StageTrace()
    for i in range(3):
        tr.iter_start(ITER=i)
        tr.point("T2SIN")
        tr.value("SEQ", i * 2)
        tr.point("MAC")
    s = tr.summary()
    assert "T2SIN" in s and s["SEQ"] == 2.0
    tr.to_jsonl(str(tmp_path / "t.jsonl"))
    tr.to_log_txt(str(tmp_path / "LOG.txt"))
    txt = open(tmp_path / "LOG.txt").read()
    assert "ITER:0" in txt and "SEQ:4" in txt


def test_link_metrics_golden(golden):
    con = binio.read_complex64f(golden("data/constell.bin"))
    m = link_metrics(con, 4)
    # the committed OTA capture measures ~9.3% EVM (BASELINE.md)
    assert 0.07 < m["evm_rms"] < 0.12
    ref = np.array([0xAB, 0xCD], dtype=np.uint8)
    dec = np.array([0xAB, 0xCC], dtype=np.uint8)
    m2 = link_metrics(con, 4, ref, dec)
    assert m2["byte_acc"] == 0.5 and abs(m2["ber"] - 1 / 16) < 1e-9


def test_loopback_app_cli(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "from c_ofdm.apps.loopback import main; import sys;"
         f"sys.exit(main(['--dump', '{tmp_path}', '--snr-db', '28']))"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ACCURACY: 1.0" in out.stdout
    assert (tmp_path / "constell.bin").exists()
    assert (tmp_path / "source.bin").exists()


def test_loopback_app_replay_golden(tmp_path, golden):
    data, text = golden("data/data.bin"), golden("WARANDPEACE.txt")
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "jax.config.update('jax_enable_x64', True);"
         "from c_ofdm.apps.loopback import main; import sys;"
         f"sys.exit(main(['--replay', '{data}', '--f64',"
         f" '--payload', '{text}']))"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    # payload differs from the head of WARANDPEACE only via MAC framing; the
    # app reports header fields + EVM; accuracy vs file is 1.0 because the
    # same file fed the reference TX
    assert out.returncode == 0, out.stdout + out.stderr
    assert "FRAME FROM 1 TO 0 SEQ 0" in out.stdout
    assert "ACCURACY: 1.0" in out.stdout


def test_unified_cli_dispatch():
    from c_ofdm.__main__ import main, APPS
    import importlib
    assert main([]) == 0
    assert main(["nosuch"]) == 2
    # every registered app resolves to a module with a main(argv) entry
    for target, _ in APPS.values():
        mod = importlib.import_module(f"c_ofdm.{target}")
        assert callable(mod.main)
