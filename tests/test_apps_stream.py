"""End-to-end CLI pipeline: txstream -> file -> rxstream, plus checkpoint/
resume of the streaming state mid-capture."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, timeout=400):
    return subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');" + code],
        capture_output=True, text=True, cwd=REPO, timeout=timeout)


def test_txstream_rxstream_cli(tmp_path):
    payload = (b"The quick brown fox jumps over the lazy dog. " * 40)[:1200]
    src = tmp_path / "payload.txt"
    src.write_bytes(payload)
    stream = tmp_path / "stream.bin"
    decoded = tmp_path / "decoded.bin"
    log = tmp_path / "LOG.txt"
    metrics = tmp_path / "m.jsonl"

    r = _run(f"from c_ofdm.apps.txstream import main; import sys;"
             f"sys.exit(main(['--in','{src}','--out','{stream}','--gap','500']))")
    assert r.returncode == 0, r.stderr
    assert "transmitted" in r.stderr

    r = _run(f"from c_ofdm.apps.rxstream import main; import sys;"
             f"sys.exit(main(['--in','{stream}','--format','i16',"
             f"'--out','{decoded}','--log','{log}','--metrics','{metrics}']))")
    assert r.returncode == 0, r.stderr
    got = decoded.read_bytes()
    assert payload in got[: len(payload) + 16]
    assert log.exists() and "RX_STEP" in log.read_text()
    rows = [json.loads(l) for l in metrics.read_text().splitlines()]
    assert len(rows) >= 1 and all(r["crc_ok"] for r in rows)
    assert [r["seq"] for r in rows] == list(range(len(rows)))


def test_stream_state_checkpoint_resume(tmp_path, spec64, cfg):
    """Split a capture at a buffer boundary; resume from a saved checkpoint;
    frames straddling the split must still decode exactly once."""
    import jax.numpy as jnp
    from c_ofdm.mac.mac import Mac
    from c_ofdm.models import streaming, tx as txm

    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(3)
    n_frames = 6
    payloads = rng.integers(0, 256, (n_frames, mac.payload), dtype=np.uint8)
    wire = mac.write(jnp.asarray(payloads), jnp.arange(n_frames, dtype=jnp.uint32))
    frames = np.asarray(txm.transmit(spec64, wire))

    buf_len = cfg.rx_buf_size * cfg.frame_len
    sig = np.zeros(2 * buf_len, dtype=np.complex64)
    pos = buf_len - 3 * cfg.frame_len  # last frames straddle the buffer split
    for f in frames:
        sig[pos:pos + cfg.frame_len] = f
        pos += cfg.frame_len + 11

    rx1 = streaming.StreamingReceiver(spec64, max_frames=10)
    out1 = rx1.feed(sig[:buf_len])
    ckpt = str(tmp_path / "state")
    streaming.save_state(ckpt, rx1.state)

    # resume in a fresh receiver
    rx2 = streaming.StreamingReceiver(spec64, max_frames=10)
    rx2.state = streaming.load_state(ckpt)
    out2 = rx2.feed(sig[buf_len:])

    seqs = []
    for out in (out1, out2):
        for k in np.nonzero(np.asarray(out.valid))[0]:
            fr = mac.read_soft(out.diag[k])
            seqs.append(int(np.asarray(fr.seq)))
            assert np.array_equal(np.asarray(fr.payload),
                                  payloads[seqs[-1]])
    assert seqs == list(range(n_frames)), seqs


def test_rxstream_metadata_drain(tmp_path):
    """--drain metadata must count the same frames/CRC results as the full
    drain while never reading payloads back (the summary JSON is the only
    output), and the summary must carry the drain mode."""
    payload = (b"metadata drain e2e proof " * 64)[:1200]
    src = tmp_path / "payload.txt"
    src.write_bytes(payload)
    stream = tmp_path / "stream.bin"
    summary = tmp_path / "s.json"

    r = _run(f"from c_ofdm.apps.txstream import main; import sys;"
             f"sys.exit(main(['--in','{src}','--out','{stream}','--gap','777']))")
    assert r.returncode == 0, r.stderr

    full = tmp_path / "full.json"
    r = _run(f"from c_ofdm.apps.rxstream import main; import sys;"
             f"sys.exit(main(['--in','{stream}','--format','i16',"
             f"'--out','{tmp_path}/d.bin','--summary-json','{full}']))")
    assert r.returncode == 0, r.stderr
    sf = json.loads(full.read_text())

    r = _run(f"from c_ofdm.apps.rxstream import main; import sys;"
             f"sys.exit(main(['--in','{stream}','--format','i16',"
             f"'--out','{tmp_path}/d2.bin','--drain','metadata',"
             f"'--summary-json','{summary}']))")
    assert r.returncode == 0, r.stderr
    sm = json.loads(summary.read_text())
    assert sm["drain"] == "metadata"
    assert sm["frames"] == sf["frames"] >= 1
    assert sm["crc_failures"] == sf["crc_failures"] == 0
    assert os.path.getsize(tmp_path / "d2.bin") == 0   # nothing read back
    # the device-side verification tallies are surfaced (round-3 advisor
    # finding): highest accepted MAC seq and the uint32 payload checksum
    assert sm["max_seq"] == sm["frames"] - 1           # seqs 0..n-1
    assert sm["payload_checksum_u32"] > 0


def test_rxstream_metadata_chunked(tmp_path):
    """--chunk N (lax.scan over N buffers per dispatch) must tally exactly
    what per-buffer metadata mode tallies, including zero-padded tail
    chunks."""
    payload = (b"chunked dispatch proof " * 80)[:1500]
    src = tmp_path / "p.txt"
    src.write_bytes(payload)
    stream = tmp_path / "s.bin"
    r = _run(f"from c_ofdm.apps.txstream import main; import sys;"
             f"sys.exit(main(['--in','{src}','--out','{stream}','--gap','900']))")
    assert r.returncode == 0, r.stderr
    outs = {}
    for chunk in ("1", "2"):
        sj = tmp_path / f"s{chunk}.json"
        r = _run(f"from c_ofdm.apps.rxstream import main; import sys;"
                 f"sys.exit(main(['--in','{stream}','--format','i16',"
                 f"'--out','{tmp_path}/o{chunk}.bin','--drain','metadata',"
                 f"'--chunk','{chunk}','--summary-json','{sj}']))")
        assert r.returncode == 0, r.stderr
        outs[chunk] = json.loads(sj.read_text())
    assert outs["1"]["frames"] == outs["2"]["frames"] >= 1
    assert outs["1"]["crc_failures"] == outs["2"]["crc_failures"] == 0
    # the mod-2^32 payload checksum must be invariant to dispatch chunking
    assert (outs["1"]["payload_checksum_u32"]
            == outs["2"]["payload_checksum_u32"] > 0)
    assert outs["1"]["max_seq"] == outs["2"]["max_seq"]
