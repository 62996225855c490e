"""MAC codec + channel simulator + full synchronized loopback under impairments."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from c_ofdm.mac.mac import Mac, MacFrame
from c_ofdm.channel.sim import ChannelParams, apply_channel
from c_ofdm.models import rx as rxm
from c_ofdm.models import tx as txm


def test_mac_roundtrip_spread4():
    mac = Mac(tx_id=3, rx_id=9, frame_bytes=1024, spread=4)
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, (2, mac.payload), dtype=np.uint8)
    wire = mac.write(jnp.asarray(payload), jnp.asarray([5, 6], dtype=jnp.uint32))
    assert wire.shape == (2, 1024)
    back = mac.read_bytes(wire)
    assert np.array_equal(np.asarray(back.payload), payload)
    assert np.asarray(back.tx_id).tolist() == [3, 3]
    assert np.asarray(back.seq).tolist() == [5, 6]
    assert np.asarray(back.valid).all()


def test_mac_roundtrip_spread1_crc_detects_corruption():
    mac = Mac(frame_bytes=1024, spread=1)
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 256, mac.payload, dtype=np.uint8)
    wire = np.asarray(mac.write(jnp.asarray(payload), jnp.uint32(0))).copy()
    ok = mac.read_bytes(jnp.asarray(wire))
    assert bool(ok.valid) and np.array_equal(np.asarray(ok.payload), payload)
    wire[100] ^= 0x40
    bad = mac.read_bytes(jnp.asarray(wire))
    assert not bool(bad.valid)


def test_mac_majority_fixes_bit_errors():
    mac = Mac(frame_bytes=1024, spread=4)
    rng = np.random.default_rng(2)
    payload = rng.integers(0, 256, mac.payload, dtype=np.uint8)
    wire = np.asarray(mac.write(jnp.asarray(payload), jnp.uint32(1)))
    bits = np.unpackbits(wire)
    flip = rng.choice(bits.size, 200, replace=False)  # < 1 flip per group of 4 usually
    # only flip at most one bit per group of spread
    groups = np.unique(flip // 4, return_index=True)[1]
    bits[flip[groups]] ^= 1
    out = mac.read_bytes(jnp.asarray(np.packbits(bits)))
    assert np.array_equal(np.asarray(out.payload), payload)
    assert bool(out.valid)


def test_golden_capture_through_mac(spec128, ref_capture, ref_decoded_text):
    res, s = rxm.receive_capture_jit(spec128, jnp.asarray(ref_capture))
    mac = Mac(frame_bytes=spec128.cfg.frame_bytes, spread=spec128.cfg.mod_type)
    diag = res.constellation.real + res.constellation.imag
    frame = mac.read_soft(diag)
    assert bool(frame.valid)  # tail is the 0x7E57 magic
    assert np.asarray(frame.payload).tobytes() == ref_decoded_text
    assert int(frame.tx_id) == 1 and int(frame.rx_id) == 0 and int(frame.seq) == 0


@pytest.mark.parametrize("snr_db,cfo,timing", [
    (25.0, 0.0, 0),
    (20.0, 3e-4, 1234),
    (15.0, -2e-4, 4096),
])
def test_impaired_loopback_end_to_end(spec64, cfg, snr_db, cfo, timing):
    """TX -> channel (noise+CFO+timing) -> full sync RX -> MAC: payload exact."""
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(42)
    payload = rng.integers(0, 256, mac.payload, dtype=np.uint8)
    wire = mac.write(jnp.asarray(payload), jnp.uint32(17))
    frame = txm.transmit(spec64, wire).astype(jnp.complex64)
    params = ChannelParams(snr_db=snr_db, cfo=cfo, timing_offset=timing,
                           capture_len=cfg.frame_len + timing + 2048,
                           quantize_mult=cfg.mult, amplitude=80.0)
    cap = apply_channel(params, jax.random.PRNGKey(timing), frame)
    res, s = rxm.receive_capture_jit(spec64, cap)
    assert bool(s.found)
    # frame start must land exactly at the injected timing offset
    assert abs(int(s.frame_start) - timing) <= 0
    diag = res.constellation.real + res.constellation.imag
    out = mac.read_soft(diag)
    assert np.array_equal(np.asarray(out.payload), payload)
    assert bool(out.valid) and int(out.seq) == 17


def test_multipath_loopback(spec64, cfg):
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(9)
    payload = rng.integers(0, 256, mac.payload, dtype=np.uint8)
    wire = mac.write(jnp.asarray(payload), jnp.uint32(3))
    frame = txm.transmit(spec64, wire).astype(jnp.complex64)
    params = ChannelParams(snr_db=25.0, cfo=1e-4, timing_offset=500,
                           capture_len=cfg.frame_len + 4000,
                           multipath=(0.15 + 0.1j,), amplitude=50.0)
    cap = apply_channel(params, jax.random.PRNGKey(1), frame)
    res, s = rxm.receive_capture_jit(spec64, cap)
    assert bool(s.found)
    out = mac.read_soft(res.constellation.real + res.constellation.imag)
    assert np.array_equal(np.asarray(out.payload), payload)


@pytest.mark.parametrize("sco_ppm", [20.0, -20.0])
def test_sco_multiframe_stream(spec64, cfg, sco_ppm):
    """Sample-clock offset robustness (a real AD9361 link always drifts a few
    ppm): a 12-frame back-to-back stream resampled at +-20 ppm must decode
    every frame CRC-clean — per-frame preamble sync re-acquires the
    accumulated drift, and the linear-phase channel estimator absorbs the
    sub-sample residual."""
    from c_ofdm.models.streaming import StreamingReceiver

    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(7)
    n_frames = 12
    payloads = rng.integers(0, 256, (n_frames, mac.payload), dtype=np.uint8)
    wire = mac.write(jnp.asarray(payloads),
                     jnp.arange(n_frames, dtype=jnp.uint32))
    frames = np.asarray(txm.transmit(spec64, wire))
    stream = np.concatenate([np.zeros(900, frames.dtype), frames.reshape(-1)])

    buf_len = cfg.rx_buf_size * cfg.frame_len
    total = ((stream.size + buf_len - 1) // buf_len) * buf_len
    params = ChannelParams(snr_db=24.0, cfo=1.5e-4, sco_ppm=sco_ppm,
                           capture_len=total, amplitude=60.0)
    cap = np.asarray(apply_channel(params, jax.random.PRNGKey(3),
                                   jnp.asarray(stream)))

    rxr = StreamingReceiver(spec64, max_frames=16)
    got = []
    for i in range(total // buf_len):
        out = rxr.feed(cap[i * buf_len:(i + 1) * buf_len])
        for k in np.nonzero(np.asarray(out.valid))[0]:
            fr = mac.read_soft(out.diag[k])
            got.append((int(np.asarray(fr.seq)), np.asarray(fr.payload),
                        bool(np.asarray(fr.valid))))
    assert len(got) == n_frames, f"decoded {len(got)} of {n_frames}"
    for i, (seq, pl, ok) in enumerate(got):
        assert seq == i and ok, (i, seq, ok)
        assert np.array_equal(pl, payloads[i])


def test_mac_soft_llr_combining_beats_majority_vote():
    """The soft-decision path (soft_llrs + Mac.read_llr) must beat the hard
    majority vote on the spread-repetition scheme in AWGN — the measurable
    form of the ~1.5 dB repetition-combining gain (new capability vs the
    hard-decision-only reference, `OFDM/modulation.cpp:53-87`)."""
    import jax
    import jax.numpy as jnp
    from c_ofdm.mac.mac import Mac
    from c_ofdm.ops import bits as bitops
    from c_ofdm.ops import modulation

    mod, B = 4, 64
    mac = Mac(frame_bytes=1024, spread=mod)
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 256, (B, mac.payload), dtype=np.uint8)
    wire = mac.write(jnp.asarray(payload), jnp.arange(B, dtype=jnp.uint32))
    pts = modulation.map_bytes(wire, mod)
    es = float(np.mean(np.abs(modulation.constellation(mod)) ** 2))
    snr_db = 8.0                       # measurable-BER region for QAM16
    nvar = es * 10 ** (-snr_db / 10)
    key = jax.random.PRNGKey(0)
    noise = (jax.random.normal(key, pts.shape) +
             1j * jax.random.normal(jax.random.split(key)[0], pts.shape))
    rx = pts + noise * np.sqrt(nvar / 2)

    hard = mac.read_bytes(modulation.demap_bytes(rx, mod))
    soft = mac.read_llr(modulation.soft_llrs(rx, mod, noise_var=nvar))
    ber = lambda fr: float(np.unpackbits(  # noqa: E731
        np.asarray(fr.payload) ^ payload, axis=-1).mean())
    bh, bs = ber(hard), ber(soft)
    assert bs > 0, "SNR too high for a meaningful comparison"
    assert bs < 0.6 * bh, (
        f"soft combining gave no gain: hard {bh:.2e} vs soft {bs:.2e}")
