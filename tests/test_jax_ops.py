"""JAX op parity vs the numpy oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from c_ofdm.ops import bits as bitops
from c_ofdm.ops import modulation, sync, cfo, chanest
from c_ofdm.oracle import reference as oracle


def test_bits_roundtrip():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (3, 24), dtype=np.uint8)
    for bps in (1, 2, 4, 6, 8):
        sym = bitops.bytes_to_symbols(jnp.asarray(data), bps)
        ref = np.stack([oracle.bytes_to_symbols(d, bps) for d in data])
        assert np.array_equal(np.asarray(sym), ref), bps
        back = bitops.symbols_to_bytes(sym, bps)
        assert np.array_equal(np.asarray(back), data), bps


def test_map_demap_matches_oracle():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (2, 24), dtype=np.uint8)
    for mod in (1, 2, 4, 6, 8):
        pts = modulation.map_bytes(jnp.asarray(data), mod, dtype=jnp.complex128)
        ref = np.stack([oracle.modulate(d, mod) for d in data])
        assert np.allclose(np.asarray(pts), ref)
        if mod > 1:
            noisy = ref + 0.05 * (rng.standard_normal(ref.shape)
                                  + 1j * rng.standard_normal(ref.shape))
            got = modulation.demap_bytes(jnp.asarray(noisy), mod)
            want = np.stack([oracle.demodulate_bytes(n, mod) for n in noisy])
            assert np.array_equal(np.asarray(got), want)


def test_soft_llr_sign_matches_hard_decision():
    rng = np.random.default_rng(2)
    for mod in (2, 4, 6):
        data = rng.integers(0, 256, 24, dtype=np.uint8)
        pts = oracle.modulate(data, mod)
        llr = modulation.soft_llrs(jnp.asarray(pts), mod)
        # noiseless: LLR sign must recover the exact bits (positive => bit 0)
        bits_hat = (np.asarray(llr) < 0).astype(np.uint8).reshape(-1)
        bits_ref = np.unpackbits(data)[: bits_hat.size]
        assert np.array_equal(bits_hat, bits_ref), mod


def test_ofdm_mod_demod_roundtrip(spec128, cfg):
    rng = np.random.default_rng(3)
    pts = oracle.modulate(rng.integers(0, 256, cfg.frame_bytes, dtype=np.uint8),
                          cfg.mod_type)
    time_ref = oracle.ofdm_modulate(cfg, pts, cfg.num_symb)
    time_jax = chanest.ofdm_modulate(spec128, jnp.asarray(pts), cfg.num_symb)
    assert np.allclose(np.asarray(time_jax), time_ref, atol=1e-12)
    demod_ref = oracle.ofdm_demodulate(cfg, time_ref[:, cfg.cp_size:])
    demod_jax = chanest.ofdm_demodulate(spec128, time_jax[..., cfg.cp_size:])
    assert np.allclose(np.asarray(demod_jax), demod_ref, atol=1e-12)


def test_t2_track_backends_match_oracle(spec128, cfg, ref_capture, ref_t2_corr):
    cap = jnp.asarray(ref_capture)
    for backend in ("fft", "partial"):
        track = np.asarray(sync.t2_ratio_track(spec128, cap, backend=backend))
        mine = np.where(track > cfg.t2_sin_level, track, 0.0)
        assert np.allclose(mine[: ref_t2_corr.size], ref_t2_corr, atol=1e-9), backend
    pos, found = sync.find_t2sin(spec128, cap, 0)
    assert bool(found) and int(pos) == 10752


def test_preamble_track_matches_oracle(spec128, cfg, ref_capture):
    t2 = 10752
    track_ref = oracle.preamble_corr_track(cfg, ref_capture, t2)
    track_jax = np.asarray(sync.preamble_corr_track(
        spec128, jnp.asarray(ref_capture), jnp.asarray(t2)))
    assert np.allclose(track_jax, track_ref, atol=1e-10)
    pos, found = sync.find_preamble(spec128, jnp.asarray(ref_capture), jnp.asarray(t2))
    assert bool(found) and int(pos) + 1 == 11040


def test_cfo_estimators_match_oracle(spec128, cfg, ref_capture):
    pr_begin = 11040
    frame = ref_capture[pr_begin - cfg.t2sin_size:
                        pr_begin - cfg.t2sin_size + cfg.frame_len]
    sig = frame[cfg.t2sin_size:]
    shift_ref = oracle.pilot_freq_shift(cfg, sig)
    shift_jax = float(cfo.pilot_freq_shift(spec128, jnp.asarray(sig)))
    assert abs(shift_jax - shift_ref) < 1e-12
    d_ref = oracle.apply_freq_shift(sig, shift_ref)
    d_jax = np.asarray(cfo.apply_freq_shift(jnp.asarray(sig), jnp.asarray(shift_ref)))
    assert np.allclose(d_jax, d_ref, atol=1e-10)
    c_ref = oracle.cp_freq_correct(cfg, d_ref)
    c_jax = np.asarray(cfo.cp_freq_correct(spec128, jnp.asarray(d_ref)))
    assert np.allclose(c_jax, c_ref, atol=1e-10)
    p_ref = oracle.common_phase_correct(cfg, c_ref)
    p_jax = np.asarray(cfo.common_phase_correct(spec128, jnp.asarray(c_ref)))
    assert np.allclose(p_jax, p_ref, atol=1e-10)
    chan_ref = oracle.chan_est_lq(cfg, p_ref[: cfg.preamble_len])
    chan_jax = np.asarray(chanest.chan_est_lq(spec128,
                                              jnp.asarray(p_ref[: cfg.preamble_len])))
    assert np.allclose(chan_jax, chan_ref, atol=1e-10)


def test_window_ops_match_dynamic_slice(spec128):
    """aligned_window (block-aligned one-hot contraction) and dynamic_window
    (one-hot + 16x16 fine shift) must equal lax.dynamic_slice semantics —
    they are the gather-free forms of the sync/extract windows."""
    rng = np.random.default_rng(7)
    n = 6016
    x = jnp.asarray(rng.normal(size=n) + 1j * rng.normal(size=n))
    for st in (0, 256, 2560, 5632):
        a = np.asarray(sync.aligned_window(x, jnp.int32(st), 768, 256))
        b = np.asarray(sync.jax_dynamic_window(x, jnp.int32(st), 768))
        assert np.array_equal(a, b), st
    for st in (0, 1, 17, 255, 257, 4321, n - 1, n + 5):
        a = np.asarray(sync.dynamic_window(x, jnp.int32(st), 640))
        b = np.asarray(jax.lax.dynamic_slice_in_dim(x, jnp.int32(st), 640))
        assert np.array_equal(a, b), st
    # batched under vmap (the production shape)
    xb = jnp.asarray(np.stack([np.asarray(x), 2 * np.asarray(x)]))
    sts = jnp.asarray([513, 5632], dtype=jnp.int32)
    a = np.asarray(jax.vmap(lambda c, t: sync.dynamic_window(c, t, 768))(xb, sts))
    b = np.asarray(jax.vmap(
        lambda c, t: jax.lax.dynamic_slice_in_dim(c, t, 768))(xb, sts))
    assert np.array_equal(a, b)


def test_matched_filter_toeplitz_matches_fft(spec128):
    """The short-window Toeplitz-matmul correlation must bit-match the
    FFT-correlation statistic the long path uses."""
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.normal(size=(3, 768)) + 1j * rng.normal(size=(3, 768)))
    L = spec128.cfg.pr_sin_len
    got = np.asarray(sync.matched_filter_scores(spec128, x))
    corr = np.abs(np.asarray(sync._corr_fft(spec128, x, 1024)))[..., :768]
    e = np.abs(np.asarray(x)) ** 2
    ce = np.concatenate([np.zeros((3, 1)), np.cumsum(e, -1)], -1)
    norm = np.pad(ce[:, L:] - ce[:, :768 + 1 - L], ((0, 0), (0, L - 1)))[:, :768]
    ref = np.where(norm > 1.0, corr / np.sqrt(np.maximum(norm, 1e-30)), 0.0)
    assert np.abs(got - ref).max() < 1e-12


def test_first_above_peak_semantics():
    """Crossing-at-peak vs crossing-before-peak (the round-4 sweep find):
    first_above_peak returns the local score maximum in both regimes, and
    the config's auto rule engages it exactly above the reference's
    calibration point."""
    import jax.numpy as jnp
    from c_ofdm.config import ModemConfig

    # calibrated regime: crossing one lag before the peak -> peak = c+1
    t = jnp.asarray([0.1, 0.2, 0.6, 0.9, 0.4, 0.1])
    idx, found = sync.first_above(t, 0.5)
    pidx, pfound = sync.first_above_peak(t, 0.5)
    assert bool(found) and int(idx) == 2
    assert bool(pfound) and int(pidx) == 3          # == crossing + 1
    # raised threshold: crossing lands ON the peak -> blind +1 would be late
    idx2, _ = sync.first_above(t, 0.85)
    pidx2, _ = sync.first_above_peak(t, 0.85)
    assert int(idx2) == 3 and int(pidx2) == 3       # peak, not 4
    # no hit
    pidx3, pfound3 = sync.first_above_peak(t, 0.95)
    assert not bool(pfound3) and int(pidx3) == -1
    # batch axis
    tb = jnp.stack([t, t[::-1]])
    pb, fb = sync.first_above_peak(tb, 0.5)
    assert fb.tolist() == [True, True] and pb.tolist() == [3, 2]

    # config auto rule: the +1 quirk is calibrated for pr_level 0.5
    assert ModemConfig().peak_refine is False
    assert ModemConfig(pr_level=0.65).peak_refine is True
    assert ModemConfig(sync_peak_refine=True).peak_refine is True
    assert ModemConfig(pr_level=0.7, sync_peak_refine=False).peak_refine is False


def test_ct_dft_matches_fft():
    """Two-stage Cooley-Tukey backend (wideband matmul path, ops/fft.py::ct_dft)
    is exact vs the reference transform at several power-of-two sizes and in
    both directions/dtypes."""
    import numpy as np
    import jax.numpy as jnp
    from c_ofdm.ops import fft as fftops

    rng = np.random.default_rng(5)
    for n in (64, 512, 8192):
        x = jnp.asarray(rng.standard_normal((3, n))
                        + 1j * rng.standard_normal((3, n)))
        np.testing.assert_allclose(
            np.asarray(fftops.ct_dft(x, -1)), np.asarray(jnp.fft.fft(x)),
            rtol=0, atol=1e-10 * n)
        np.testing.assert_allclose(
            np.asarray(fftops.ct_dft(x, +1)),
            np.asarray(jnp.fft.ifft(x) * n), rtol=0, atol=1e-10 * n)


def test_ct_backend_end_to_end():
    """Full TX->RX chain with fft_backend='ct' decodes byte-exact and its
    constellation matches the xla backend closely (both are exact DFTs)."""
    import numpy as np
    import jax.numpy as jnp
    from c_ofdm import ModemConfig, make_frame_spec
    from c_ofdm.models import rx as rxm, tx as txm

    cfg = ModemConfig()
    rng = np.random.default_rng(6)
    payload = jnp.asarray(rng.integers(0, 256, (2, cfg.frame_bytes),
                                       dtype=np.uint8))
    outs = {}
    for be in ("xla", "ct"):
        spec = make_frame_spec(cfg, dtype=jnp.complex64, fft_backend=be)
        frames = txm.transmit(spec, payload)
        res = rxm.demod_frames_jit(spec, frames)
        outs[be] = (np.asarray(res.mac_bytes), np.asarray(res.constellation))
    assert (outs["ct"][0] == np.asarray(payload)).all()
    assert (outs["ct"][0] == outs["xla"][0]).all()
    np.testing.assert_allclose(outs["ct"][1], outs["xla"][1], atol=1e-3)


def _dot_precisions(jaxpr, acc):
    """Precision of every dot_general in ``jaxpr``, nested jaxprs included."""
    from jax.extend import core as jcore

    def subs(v):
        if isinstance(v, jcore.ClosedJaxpr):
            yield v.jaxpr
        elif isinstance(v, jcore.Jaxpr):
            yield v
        elif isinstance(v, (tuple, list)):
            for x in v:
                yield from subs(x)

    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            acc.append(e.params["precision"])
        for v in e.params.values():
            for sj in subs(v):
                _dot_precisions(sj, acc)
    return acc


@pytest.mark.parametrize("backend", ["matmul", "ct"])
@pytest.mark.parametrize("stage", ["transmit", "demod_sig", "gated_hits",
                                   "receive_batch"])
def test_chain_dots_pin_precision(stage, backend, cfg):
    """Every f32 dot on the chain carries ops.fft.PRECISION explicitly: an
    accelerator whose default f32 dot is TF32 would otherwise round the IQ
    samples (aligned_window) and the DFTs to ~3 decimal digits."""
    from c_ofdm.models import rx as rxm, streaming, tx as txm
    from c_ofdm.models.frame import make_frame_spec
    from c_ofdm.ops import fft as fftops

    spec = make_frame_spec(cfg, dtype=jnp.complex64, fft_backend=backend)
    sig_len = cfg.preamble_len + cfg.message_len
    fns = {
        "transmit": (lambda x: txm.transmit(spec, x),
                     jnp.zeros((2, cfg.frame_bytes), jnp.uint8)),
        "demod_sig": (lambda x: rxm.demod_sig(spec, x),
                      jnp.zeros((2, sig_len), jnp.complex64)),
        "gated_hits": (lambda x: streaming.gated_hits(
            spec, x, jnp.int32(0), 4),
            jnp.zeros((2, 3 * cfg.frame_len), jnp.complex64)),
        "receive_batch": (lambda x: rxm.receive_batch(spec, x),
                          jnp.zeros((2, cfg.frame_len + 512), jnp.complex64)),
    }
    fn, arg = fns[stage]
    precs = _dot_precisions(jax.make_jaxpr(fn)(arg).jaxpr, [])
    assert precs, f"{stage}: no dot_general traced"
    want = (fftops.PRECISION, fftops.PRECISION)
    assert all(p == want for p in precs), (stage, precs)


def test_ct_rejects_non_power_of_two():
    from c_ofdm.ops import fft as fftops
    with pytest.raises(ValueError, match="power-of-two"):
        fftops.ct_dft(jnp.zeros((1, 768), jnp.complex64), sign=-1)
