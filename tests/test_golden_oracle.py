"""Numpy-oracle parity against the reference's committed golden artifacts.

These tests pin the *algorithms*: if the oracle matches the C++ outputs
bit-/pattern-exactly, the JAX path only has to match the oracle.
"""

import numpy as np

from c_ofdm.oracle import reference as oracle
from c_ofdm.utils.mt19937 import uniform_bytes


def test_mt19937_preamble_bytes(cfg):
    # First bytes of std::mt19937(42) through libstdc++ uniform_int(0,255),
    # verified against the committed source.bin preamble (full-chain check below).
    b = uniform_bytes(cfg.pr_seed, 8)
    assert b.tolist() == [95, 203, 243, 46, 187, 199, 153, 152]


def test_tx_t2_and_preamble_bit_exact(cfg, ref_source_int16):
    src = ref_source_int16.astype(np.float64)
    src = src[::2] + 1j * src[1::2]
    frame = oracle.tx_frame(cfg, np.zeros(cfg.frame_bytes, dtype=np.uint8))
    mine = oracle.to_int16(cfg, frame)
    n_fixed = cfg.t2sin_size + cfg.preamble_len
    assert np.array_equal(mine[:n_fixed], src[:n_fixed])


def test_t2_corr_track_matches(cfg, ref_capture, ref_t2_corr):
    ratio = oracle.t2_ratio_track(cfg, ref_capture)
    mine = np.where(ratio > cfg.t2_sin_level, ratio, 0.0)
    assert np.allclose(mine[: ref_t2_corr.size], ref_t2_corr, atol=1e-12)


def test_golden_capture_full_chain(cfg, ref_capture, ref_constell, ref_phases,
                                   ref_decoded_text):
    out = oracle.rx_capture(cfg, ref_capture)
    assert out is not None
    mac_bytes, const, chan, t2_begin, pr_begin = out
    assert t2_begin == 10752 and pr_begin == 11040
    assert np.allclose(chan, ref_phases, atol=1e-12)
    assert np.allclose(const, ref_constell, atol=1e-9)
    # MAC payload: 8-byte header + bit-spread x4 payload, decoded re+im>0
    bits = (const.real + const.imag > 0).astype(np.uint8)
    by = np.packbits(bits).tobytes()
    assert by[8:8 + len(ref_decoded_text)] == ref_decoded_text


def test_tx_rx_loopback_ideal_channel(cfg):
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, cfg.frame_bytes, dtype=np.uint8)
    frame = oracle.tx_frame(cfg, payload)
    mac_bytes, const, chan = oracle.rx_frame(cfg, frame)
    assert np.array_equal(mac_bytes, payload)


def test_modulation_roundtrip_all_orders(cfg):
    rng = np.random.default_rng(1)
    for mod in (1, 2, 4, 6, 8):
        n = 24  # bytes; 24*8 divisible by 1,2,4,6,8
        data = rng.integers(0, 256, n, dtype=np.uint8)
        pts = oracle.modulate(data, mod)
        back = oracle.demodulate_bytes(pts, mod)
        assert np.array_equal(back[:n], data), f"mod_type={mod}"


def test_detection_sentinels(cfg):
    silent = np.zeros(cfg.ring_len, dtype=np.complex128)
    assert oracle.find_t2sin(cfg, silent, 0) == -1
    assert oracle.find_preamble(cfg, silent, 0) == -10
