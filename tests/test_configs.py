"""Geometry generalization: larger FFTs (1k-8k), other QAM orders, different
pilot counts — full synchronized loopback for each (BASELINE.json config #3)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from c_ofdm.config import ModemConfig
from c_ofdm.models.frame import make_frame_spec
from c_ofdm.models import rx as rxm
from c_ofdm.models import tx as txm
from c_ofdm.channel.sim import ChannelParams, apply_channel

CONFIGS = [
    # 1k FFT, QAM16, 16 pilots
    ModemConfig(fft_size=1024, num_data_subc=512, num_pilot_subc=16,
                cp_size=256, num_symb=8, pr_sin_len=256),
    # 2k FFT, QAM64
    ModemConfig(fft_size=2048, num_data_subc=1024, num_pilot_subc=16,
                cp_size=512, num_symb=4, pr_sin_len=256, mod_type=6),
    # 4k FFT, QAM16, long symbols
    ModemConfig(fft_size=4096, num_data_subc=2048, num_pilot_subc=32,
                cp_size=512, num_symb=2, pr_sin_len=256),
    # 8k FFT, QAM64 wideband
    ModemConfig(fft_size=8192, num_data_subc=4096, num_pilot_subc=32,
                cp_size=1024, num_symb=2, pr_sin_len=512, mod_type=6),
    # QAM256 on the default geometry
    ModemConfig(mod_type=8),
    # QPSK (qam4)
    ModemConfig(mod_type=2),
]


@pytest.mark.parametrize("cfg2", CONFIGS,
                         ids=[f"fft{c.fft_size}_q{1 << c.mod_type}_p{c.num_pilot_subc}"
                              for c in CONFIGS])
def test_synchronized_loopback(cfg2):
    spec = make_frame_spec(cfg2, dtype=jnp.complex64)
    rng = np.random.default_rng(cfg2.fft_size)
    payload = rng.integers(0, 256, cfg2.frame_bytes, dtype=np.uint8)
    frame = txm.transmit(spec, jnp.asarray(payload))
    # mild impairments: noise + small CFO + timing offset
    snr = 30.0 if cfg2.mod_type >= 8 else 25.0
    params = ChannelParams(snr_db=snr, cfo=1e-5, timing_offset=701,
                           capture_len=cfg2.frame_len + 4096, amplitude=10.0)
    cap = apply_channel(params, jax.random.PRNGKey(0), frame)
    res, s = rxm.receive_capture_jit(spec, cap)
    assert bool(s.found)
    got = np.asarray(res.mac_bytes)
    ber = np.unpackbits(got ^ payload).mean()
    assert ber < 1e-3, f"BER {ber}"


def test_ideal_loopback_all_configs():
    for cfg2 in CONFIGS:
        spec = make_frame_spec(cfg2, dtype=jnp.complex64)
        rng = np.random.default_rng(1)
        payload = rng.integers(0, 256, (2, cfg2.frame_bytes), dtype=np.uint8)
        frames = txm.transmit(spec, jnp.asarray(payload))
        res = rxm.demod_frame(spec, frames)
        assert np.array_equal(np.asarray(res.mac_bytes), payload), cfg2.fft_size


def test_ct_backend_wideband_impaired():
    """The wideband 8k geometry with fft_backend='ct' (the production
    wideband transform since round 5) under noise + CFO + timing offset:
    synchronized loopback decodes with BER < 1e-3, and the ct constellation
    matches the xla backend's closely (both exact transforms)."""
    cfg2 = ModemConfig(fft_size=8192, num_data_subc=4096, num_pilot_subc=32,
                       cp_size=1024, num_symb=2, pr_sin_len=512, mod_type=6)
    rng = np.random.default_rng(82)
    payload = rng.integers(0, 256, cfg2.frame_bytes, dtype=np.uint8)
    params = ChannelParams(snr_db=30.0, cfo=1e-5, timing_offset=701,
                           capture_len=cfg2.frame_len + 4096, amplitude=10.0)
    consts = {}
    for be in ("ct", "xla"):
        spec = make_frame_spec(cfg2, dtype=jnp.complex64, fft_backend=be)
        frame = txm.transmit(spec, jnp.asarray(payload))
        cap = apply_channel(params, jax.random.PRNGKey(0), frame)
        res, s = rxm.receive_capture_jit(spec, cap)
        assert bool(s.found), be
        got = np.asarray(res.mac_bytes)
        ber = np.unpackbits(got ^ payload).mean()
        assert ber < 1e-3, f"{be}: BER {ber}"
        consts[be] = np.asarray(res.constellation)
    np.testing.assert_allclose(consts["ct"], consts["xla"], atol=2e-3)


@pytest.mark.parametrize("backend", ["pallas", "fftw"])
def test_make_frame_spec_rejects_unknown_fft_backend(backend):
    with pytest.raises(ValueError, match="fft_backend"):
        make_frame_spec(ModemConfig(), fft_backend=backend)
