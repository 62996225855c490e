"""Native C++ ingest runtime: build, replay correctness, EOF, stats,
conversion parity, and the full native-ingest -> streaming-RX path."""

import numpy as np
import pytest

pytest.importorskip("ctypes")

from c_ofdm.io.ingest import (NativeIngest, SRC_FD_STREAM,  # noqa: E402
                                  SRC_FILE_REPLAY, SRC_SYNTH_ZERO,
                                  convert_i16_to_f32, load_library)


def test_build_and_load():
    assert load_library() is not None


def test_file_replay_matches_and_loops(golden):
    src = golden("data/source.bin")
    ref = np.fromfile(src, dtype=np.int16)
    ref_c = ref.astype(np.float32)
    ref_c = ref_c[::2] + 1j * ref_c[1::2]
    with NativeIngest(SRC_FILE_REPLAY, src, 6016, 4) as ing:
        assert np.array_equal(ing.pop_complex64(), ref_c)
        assert np.array_equal(ing.pop_complex64(), ref_c)  # loops
        assert np.array_equal(ing.pop_i16(), ref)
        st = ing.stats()
        assert st.buffers_consumed == 3


def test_fd_stream_eof(tmp_path):
    import os
    data = np.arange(-100, 100, dtype=np.int16)
    p = tmp_path / "s.bin"
    data.tofile(p)
    fd = os.open(p, os.O_RDONLY)
    with NativeIngest(SRC_FD_STREAM, str(fd), 50, 2) as ing:
        first = ing.pop_f32()
        assert np.array_equal(first, data[:100].astype(np.float32))
        second = ing.pop_f32()  # 100 remaining int16 = full buffer
        assert np.array_equal(second, data[100:200].astype(np.float32))
        assert ing.pop_f32(timeout_ms=2000) is None  # EOF
    os.close(fd)


def test_convert_parity():
    rng = np.random.default_rng(0)
    x = rng.integers(-32768, 32768, 10001, dtype=np.int16)
    assert np.array_equal(convert_i16_to_f32(x), x.astype(np.float32))


def test_native_ingest_feeds_streaming_rx(tmp_path, spec64, cfg):
    """File-replayed int16 frames through the native ring into the streaming
    receiver: payload recovered."""
    import jax.numpy as jnp
    from c_ofdm.mac.mac import Mac
    from c_ofdm.models import tx as txm
    from c_ofdm.models.streaming import StreamingReceiver

    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 256, mac.payload, dtype=np.uint8)
    frame = txm.transmit(spec64, mac.write(jnp.asarray(payload), jnp.uint32(2)))
    i16 = np.asarray(txm.to_int16(spec64, frame))
    # a stream of 3 frames with silence between, as int16 IQ
    sil = np.zeros(2 * 2000, dtype=np.int16)
    stream = np.concatenate([sil, i16, sil, i16, sil, i16, sil])
    p = tmp_path / "stream.bin"
    stream.tofile(p)

    buf_len = cfg.rx_buf_size * cfg.frame_len
    rxr = StreamingReceiver(spec64, max_frames=8)
    got = []
    with NativeIngest(SRC_FILE_REPLAY, str(p), buf_len, 3) as ing:
        cap = ing.pop_complex64() / cfg.mult  # one buffer is enough (loops file)
        out = rxr.feed(cap)
        for k in np.nonzero(np.asarray(out.valid))[0]:
            fr = mac.read_soft(out.diag[k])
            got.append((np.asarray(fr.payload), bool(np.asarray(fr.valid))))
    assert len(got) >= 3
    for pl, ok in got[:3]:
        assert ok and np.array_equal(pl, payload)
