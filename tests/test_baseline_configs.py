"""The BASELINE.json benchmark configurations, as CI-runnable tests."""

import numpy as np
import jax
import jax.numpy as jnp

from c_ofdm.channel.sim import ChannelParams, apply_channel
from c_ofdm.mac.mac import Mac
from c_ofdm.models import rx as rxm
from c_ofdm.models import tx as txm
from c_ofdm.models.streaming import StreamingReceiver


def test_config4_64_parallel_streams_one_chip(spec64, cfg):
    """BASELINE config #4: 64 independent OFDM streams batched on one chip."""
    rng = np.random.default_rng(64)
    B = 64
    payload = rng.integers(0, 256, (B, cfg.frame_bytes), dtype=np.uint8)
    frames = txm.transmit(spec64, jnp.asarray(payload))
    assert frames.shape == (B, cfg.frame_len)
    # cfo large enough for the coarse estimator (resolution ~1/preamble_len
    # of a bin: ~1.6e-3 cycles/sample)
    params = ChannelParams(snr_db=28.0, cfo=2.5e-3, amplitude=1.0)
    cap = apply_channel(params, jax.random.PRNGKey(0), frames)
    res = rxm.demod_frames_jit(spec64, cap)
    got = np.asarray(res.mac_bytes)
    assert (got == payload).mean() > 0.9999
    # per-stream coarse CFO estimates near the injected value
    assert np.allclose(np.asarray(res.cfo), 2.5e-3, atol=1e-3)


def test_config2_payload_file_over_multipath_streaming(spec64, cfg, golden):
    """BASELINE config #2: file payload end-to-end over a simulated multipath
    channel, through the streaming pipeline (the committed wav is absent from
    the reference snapshot; any byte stream is equivalent)."""
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    with open(golden("WARANDPEACE.txt"), "rb") as f:
        data = np.frombuffer(f.read(mac.payload * 5), dtype=np.uint8)
    chunks = data.reshape(5, mac.payload)
    wire = mac.write(jnp.asarray(chunks), jnp.arange(5, dtype=jnp.uint32))
    frames = txm.transmit(spec64, wire)
    stream = jnp.concatenate([f for f in frames])[None, :].reshape(-1)
    buf_len = cfg.rx_buf_size * cfg.frame_len
    params = ChannelParams(snr_db=24.0, cfo=1.5e-4, timing_offset=2048,
                           multipath=(0.12 + 0.08j, -0.05j),
                           capture_len=buf_len, quantize_mult=cfg.mult,
                           amplitude=60.0)
    cap = apply_channel(params, jax.random.PRNGKey(7), stream)
    rxr = StreamingReceiver(spec64, max_frames=8)
    out = rxr.feed(cap)
    recovered = bytearray()
    for k in np.nonzero(np.asarray(out.valid))[0]:
        fr = mac.read_soft(out.diag[k])
        assert bool(np.asarray(fr.valid))
        recovered += np.asarray(fr.payload).tobytes()
    assert bytes(recovered) == data.tobytes()
