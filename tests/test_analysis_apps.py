"""Dashboard and BER-sweep app smoke tests (CPU)."""

import json
import os
import subprocess
import sys


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, timeout=400):
    return subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');" + code],
        capture_output=True, text=True, cwd=REPO, timeout=timeout)


def test_dashboard(tmp_path):
    m = tmp_path / "m.jsonl"
    m.write_text('\n'.join(json.dumps(r) for r in [
        {"buf": 0, "slot": 0, "pos": 1, "seq": 0, "cfo": 1e-4, "crc_ok": True},
        {"buf": 0, "slot": 1, "pos": 2, "seq": 1, "cfo": 1e-4, "crc_ok": True},
    ]))
    png = tmp_path / "d.png"
    r = _run(f"from c_ofdm.apps.dashboard import main;"
             f"main(['--metrics','{m}','--png','{png}'])")
    assert r.returncode == 0, r.stderr
    assert "frames=2 crc_ok=2" in r.stdout
    assert png.exists()


def test_ber_sweep(tmp_path):
    out = tmp_path / "ber.jsonl"
    r = _run(f"from c_ofdm.apps.ber_sweep import main;"
             f"main(['--mods','4','--snrs','12:29:8','--frames','4',"
             f"'--out','{out}'])")
    assert r.returncode == 0, r.stderr
    rows = [json.loads(l) for l in out.read_text().splitlines()]
    assert len(rows) == 3
    by_snr = {r["snr_db"]: r for r in rows}
    # monotone: higher SNR, lower EVM; clean at 28 dB
    assert by_snr[28.0]["evm_rms"] < by_snr[12.0]["evm_rms"]
    assert by_snr[28.0]["ber"] == 0.0


def test_ber_sweep_soft(tmp_path):
    """--soft sweeps MAC-spread logical BER, hard majority vote vs LLR
    combining; soft must be no worse at the noisy point."""
    out = tmp_path / "soft.jsonl"
    r = _run(f"from c_ofdm.apps.ber_sweep import main;"
             f"main(['--mods','4','--snrs','9:20:9','--frames','8','--soft',"
             f"'--out','{out}'])")
    assert r.returncode == 0, r.stderr
    rows = [json.loads(l) for l in out.read_text().splitlines()]
    assert len(rows) == 2
    noisy = min(rows, key=lambda x: x["snr_db"])
    assert noisy["ber_hard"] > 0, "SNR point too clean to compare"
    assert noisy["ber_soft"] <= noisy["ber_hard"]
