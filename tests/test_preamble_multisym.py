"""Multi-symbol preamble coverage (round-4 verdict task 4).

The reference geometry admits ``num_pr_symb`` > 1
(`/root/reference/config/config.txt:8`, `OFDM/Frame.cpp:217-218`), but its
`chan_char_lq` fits only the FIRST preamble symbol's lower half
(`OFDM/Frame.hpp:402-405`: phase.size() = num_data_subc/2 over the flattened
P*D preamble points) while `chan_char` averages all P symbols
(`OFDM/Frame.hpp:376-383`).  This module pins the repo's documented choices:

  * `oracle.chan_est_lq` keeps the reference's exact first-symbol semantics;
  * production `chanest.chan_est_lq` averages the complex rx/ref ratio over
    all P preamble symbols before the phase fit (an SNR improvement the
    reference forfeits), bit-identical to the oracle at P=1;
  * `chan_est_full` P-averages in both, matching the reference;
  * the full TX->impairments->RX chain and the production gated streaming
    path decode byte-exact at P=2.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from c_ofdm import ModemConfig, make_frame_spec
from c_ofdm.mac.mac import Mac
from c_ofdm.models import rx as rxm, streaming, tx as txm
from c_ofdm.ops import chanest
from c_ofdm.oracle import reference as oracle

CFG_P2 = ModemConfig(num_pr_symb=2)


@pytest.fixture(scope="module")
def spec_p2():
    return make_frame_spec(CFG_P2, dtype=jnp.complex128)


def _noisy_preamble(spec, seed, snr_db=20.0, slope=3e-3):
    """Clean P-symbol preamble span through a linear-phase channel + AWGN."""
    cfg = spec.cfg
    pre = np.asarray(oracle.preamble_time(cfg))
    # linear phase in time = subcarrier-dependent rotation after the FFT;
    # apply as a small integer-sample-free time rotation
    n = np.arange(pre.size)
    sig = pre * np.exp(1j * slope * n)
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(pre.size) + 1j * rng.standard_normal(pre.size)
    p = (np.abs(pre) ** 2).mean()
    return sig + noise * np.sqrt(p * 10 ** (-snr_db / 10) / 2)


def test_geometry_p2(spec_p2):
    cfg = spec_p2.cfg
    assert cfg.preamble_len == 2 * cfg.ofdm_len
    assert cfg.frame_len == (cfg.t2sin_size + 2 * cfg.ofdm_len
                             + cfg.num_symb * cfg.ofdm_len)
    assert spec_p2.preamble_points.shape == (2 * cfg.num_data_subc,)
    iq = np.asarray(txm.transmit(spec_p2, jnp.zeros(
        (cfg.frame_bytes,), jnp.uint8)))
    assert iq.shape == (cfg.frame_len,)
    # the P preamble symbols carry DISTINCT known PRNG content (the seeded
    # byte stream draws P*D points, reference `Frame.cpp:269-273` /
    # `chan_char`'s mod_preamble[i] over i < num_data_subc*num_symb), so the
    # two time symbols must differ
    s0 = iq[cfg.t2sin_size:cfg.t2sin_size + cfg.ofdm_len]
    s1 = iq[cfg.t2sin_size + cfg.ofdm_len:cfg.t2sin_size + 2 * cfg.ofdm_len]
    assert np.abs(s0 - s1).max() > 1e-3


def test_chan_est_full_p2_matches_oracle(spec_p2):
    sig = _noisy_preamble(spec_p2, seed=1)
    got = np.asarray(chanest.chan_est_full(spec_p2, jnp.asarray(sig)))
    want = oracle.chan_est_full(spec_p2.cfg, sig)
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_chan_est_lq_p1_bitexact_oracle(spec128):
    sig = _noisy_preamble(spec128, seed=2)
    got = np.asarray(chanest.chan_est_lq(spec128, jnp.asarray(sig),
                                         exact_unwrap=True))
    want = oracle.chan_est_lq(spec128.cfg, sig)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_chan_est_lq_p2_averages_all_symbols(spec_p2):
    """Production lq at P=2 = the reference fit applied to the P-averaged
    ratio (recomputed in numpy here); the oracle keeps first-symbol-only
    semantics, so the two differ under per-symbol noise."""
    cfg = spec_p2.cfg
    sig = _noisy_preamble(spec_p2, seed=3, snr_db=15.0)
    got = np.asarray(chanest.chan_est_lq(spec_p2, jnp.asarray(sig),
                                         exact_unwrap=True))

    pr = oracle.ofdm_demodulate(
        cfg, sig.reshape(cfg.num_pr_symb, cfg.ofdm_len)[:, cfg.cp_size:])
    ratio = (pr / oracle.preamble_points(cfg)).reshape(
        cfg.num_pr_symb, cfg.num_data_subc).mean(axis=0)
    half = cfg.num_data_subc // 2
    phase = oracle.unwrap_one_step(np.angle(ratio[:half]))
    i = np.arange(half, dtype=np.float64)
    sx, sy = i.sum(), phase.sum()
    sxy, sxx = (phase * i).sum(), (i * i).sum()
    b = (sxy - sx * sy) / (sxx - sx * sx)
    a = sy - b * sx
    n = cfg.num_data_subc
    k = np.arange(n, dtype=np.float64)
    want = np.exp(1j * np.where(k < half, b * k + a,
                                b * (k - n) + a + b * (n - 2 * half)))
    np.testing.assert_allclose(got, want, rtol=1e-9)

    # the oracle (reference semantics: first symbol only) differs under noise
    first_only = oracle.chan_est_lq(cfg, sig)
    assert np.abs(got - first_only).max() > 1e-4


def test_chan_est_lq_p2_noise_gain(spec_p2):
    """Averaging both preamble symbols estimates the true linear-phase
    channel better than the reference's first-symbol fit (median over
    seeds — the point of paying 2x preamble airtime)."""
    cfg = spec_p2.cfg
    slope = 2e-3
    true = np.asarray(oracle.chan_est_lq(
        cfg, np.asarray(_noisy_preamble(spec_p2, seed=0, snr_db=300.0,
                                        slope=slope))))
    err_avg, err_first = [], []
    for seed in range(10):
        sig = _noisy_preamble(spec_p2, seed=100 + seed, snr_db=10.0,
                              slope=slope)
        avg = np.asarray(chanest.chan_est_lq(spec_p2, jnp.asarray(sig)))
        first = oracle.chan_est_lq(cfg, sig)
        err_avg.append(np.abs(avg - true).mean())
        err_first.append(np.abs(first - true).mean())
    assert np.median(err_avg) < np.median(err_first)


@pytest.mark.parametrize("estimator", ["lq", "full"])
def test_e2e_p2_decodes(estimator):
    """Full chain at P=2: TX -> timing offset + CFO + AWGN -> sync + demod
    -> byte-exact payload."""
    spec = make_frame_spec(CFG_P2, dtype=jnp.complex64)
    cfg = spec.cfg
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, (1, mac.payload), dtype=np.uint8)
    wire = mac.write(jnp.asarray(payload), jnp.asarray([5], jnp.uint32))
    frame = np.asarray(txm.transmit(spec, wire))[0]
    off = 777
    cap = np.zeros(cfg.rx_buf_size * cfg.frame_len, dtype=np.complex64)
    cap[off:off + cfg.frame_len] = frame
    n = np.arange(cap.size)
    cap = cap * np.exp(2j * np.pi * 1e-4 * n) * 60.0
    noise = rng.standard_normal(cap.size) + 1j * rng.standard_normal(cap.size)
    cap = cap + noise * np.sqrt((np.abs(frame) ** 2).mean() * 3600
                                * 10 ** (-30.0 / 10) / 2)
    res, s = rxm.receive_capture_jit(spec, jnp.asarray(cap), estimator)
    assert bool(s.found)
    got = np.asarray(res.mac_bytes)
    assert got.tolist() == np.asarray(wire)[0].tolist()


def test_streaming_p2_decodes():
    """Production gated streaming path at P=2: planted frames at random
    offsets decode byte-exact, in order."""
    spec = make_frame_spec(CFG_P2, dtype=jnp.complex64)
    cfg = spec.cfg
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(11)
    n_frames = 3
    total = cfg.rx_buf_size * cfg.frame_len
    payloads = rng.integers(0, 256, (n_frames, mac.payload), dtype=np.uint8)
    wire = mac.write(jnp.asarray(payloads),
                     jnp.arange(n_frames, dtype=jnp.uint32))
    frames = np.asarray(txm.transmit(spec, wire))
    slack = total - n_frames * cfg.frame_len
    gaps = rng.multinomial(slack, np.ones(n_frames + 1) / (n_frames + 1))
    sig = np.zeros(total, dtype=np.complex64)
    pos = 0
    for i in range(n_frames):
        pos += gaps[i]
        sig[pos:pos + cfg.frame_len] = frames[i]
        pos += cfg.frame_len
    n = np.arange(total)
    sig = sig * np.exp(2j * np.pi * 1e-4 * n) * 50.0
    noise = rng.standard_normal(total) + 1j * rng.standard_normal(total)
    sig = sig + noise * np.sqrt((np.abs(frames) ** 2).mean() * 2500
                                * 10 ** (-28.0 / 10) / 2)
    st0 = streaming.init_state(spec)
    _, out = streaming.process_buffer(spec, st0, jnp.asarray(sig),
                                      cfg.rx_buf_size + 1)
    v = np.asarray(out.valid)
    assert v.sum() == n_frames
    got = np.asarray(out.mac_bytes)[v]
    assert got.tolist() == np.asarray(wire).tolist()
