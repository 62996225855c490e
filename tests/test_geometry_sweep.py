"""Randomized config-geometry parity sweep (round-4 verdict task 7).

The reference's parser admits any integer geometry (`config/parser.cpp:4-33`);
rather than hand-picking regression geometries, this sweep samples ~20 valid
``ModemConfig`` points across the space (fft 256-2048, cp, pilot counts, mod
orders 1-8, t2sin 128-512, matched-filter lengths) and asserts, per config,
that the gated streaming sync (production path) and the dense matched-filter
fallback decode a short impaired stream identically — positions, validity,
and payload bytes.

The stream per config carries AWGN + CFO + random frame offsets, i.e. the
same impairment family as `bench.py --streaming` and `dryrun_multichip`, so
a geometry whose gate-track hop math, candidate-region margin
(``gated_search_lags``), or advance-rule closure breaks off the default
geometry fails here instead of in the field.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from c_ofdm import ModemConfig, make_frame_spec
from c_ofdm.mac.mac import Mac
from c_ofdm.models import streaming, tx as txm

# CI default 20 (~85 s); deeper sweeps via GEOM_SWEEP_N=60 etc. for
# out-of-CI verification passes
N_CONFIGS = int(os.environ.get("GEOM_SWEEP_N", "20"))
SEED = 20250821


def _sample_cfg(rng) -> ModemConfig:
    """One valid random geometry; rejection-samples the constraint set the
    config validates (divisibility, guard band, whole-byte payload, ...)."""
    while True:
        fft = int(rng.choice([256, 512, 1024, 2048]))
        npil = int(rng.choice([4, 8, 16]))
        seg = int(rng.choice([8, 16, 32, 64]))
        ndata = npil * seg
        if ndata + npil >= fft:
            continue
        cp = fft // int(rng.choice([4, 8]))
        mod = int(rng.choice([1, 2, 4, 6, 8]))
        nsym = int(rng.choice([2, 4]))
        t2 = int(rng.choice([128, 256, 512]))
        prs = int(rng.choice([64, 128, 256]))
        # effective matched-filter length = taps x band occupancy: a sparse
        # band oversamples the time signal, so a 64-tap MF over a
        # 1/16-occupied band has ~4 independent samples — its normalized
        # correlation fluctuates with sigma ~0.5 and NO threshold separates
        # preamble from data (100-config deep-sweep find; the reference's
        # own design has 128 x 266/512 = 66 effective taps).  A valid sync
        # design keeps >= 16 effective taps.
        if prs * (ndata + npil + 2) / fft < 16:
            continue
        # pr_level above the pilot-lattice sidelobe floor: the pilot
        # lattice — identical in every OFDM symbol including the preamble —
        # correlates with the known-preamble matched filter at
        # symbol-aligned lags INSIDE data symbols, with a floor that scales
        # with the pilot power fraction (~pf + short-window variance; a
        # pf=0.58 geometry measured a 0.652 sidelobe).  A *valid* config at
        # such a geometry needs a threshold that separates that floor from
        # the true preamble peak (~0.95 at these SNRs), exactly as the
        # reference's fixed 0.5 separates them at its own geometry.  Found
        # by this sweep in round 4 (two ways): at pr_level=0.5 the dense
        # fallback accepts a sidelobe mid-frame; and at sparse low-band
        # geometries the OFDM data aliases into the t2 tone mask, giving
        # the GATED path candidate regions inside data symbols whose
        # sidelobes must also fall below pr_level.
        # threshold = sidelobe floor (pilot-power fraction) + a ~3-sigma
        # short-filter variance term (normalized correlation over L taps
        # fluctuates ~1/sqrt(L); a 64-tap MF at a sparse-band geometry
        # measured sidelobe spikes to ~0.68, found at the 100-config depth)
        pf_est = (npil * 2.5 ** 2) / (npil * 2.5 ** 2 + ndata * 0.6)
        prl = min(0.85, max(0.65, pf_est + 0.2 + 2.5 / np.sqrt(prs)))
        # num_pr_symb (round-5: the one config dimension with zero sweep
        # coverage) via a DERIVED rule rather than an rng draw — consuming
        # the shared stream would reshuffle the whole committed config set;
        # this tags ~1/3 of geometries with a 2-symbol preamble
        prsym = 2 if (fft // 64 + npil + seg + mod + nsym) % 3 == 0 else 1
        kw = dict(fft_size=fft, num_data_subc=ndata, num_pilot_subc=npil,
                  cp_size=cp, num_symb=nsym, t2sin_size=t2, pr_sin_len=prs,
                  mod_type=mod, rx_buf_size=4, pr_level=prl,
                  num_pr_symb=prsym)
        try:
            cfg = ModemConfig(**kw)
            # the frame must be able to carry a MAC header + payload
            Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
            return cfg
        except ValueError:
            continue


def _impaired_stream(spec, rng, n_frames=3):
    """Frames at random offsets in noise with CFO; returns (iq, wire)."""
    cfg = spec.cfg
    total = cfg.rx_buf_size * cfg.frame_len
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
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
    # SNR scaled to the constellation order so every planted frame decodes
    # byte-exact (the sweep asserts payload == planted): dense QAM needs
    # ~6 dB per 2 extra bits for the same symbol-error margin.  The noise
    # is sized against TOTAL signal power (pilots included), so the
    # per-DATA-subcarrier SNR is boosted by the pilot power fraction to
    # keep the data constellation margin comparable across geometries
    # (pilot-heavy configs otherwise run their data 3-5 dB hotter in noise)
    # q8 at 44 dB: the per-segment pilot-ratio division adds ~1% noise per
    # equalized symbol, which eats into QAM256's 4.7% decision margin —
    # 40 dB left occasional 1-2 byte errors at few-data-bin geometries
    snr_db = {1: 22.0, 2: 24.0, 4: 28.0, 6: 34.0, 8: 44.0}[cfg.mod_type]
    snr_db += -10.0 * np.log10(1.0 - _pilot_power_fraction(cfg))
    sig = sig + noise * np.sqrt((np.abs(frames) ** 2).mean() * 2500
                                * 10 ** (-snr_db / 10) / 2)
    return sig.astype(np.complex64), np.asarray(wire)


def _cfgs():
    rng = np.random.default_rng(SEED)
    seen = set()
    out = []
    while len(out) < N_CONFIGS:
        cfg = _sample_cfg(rng)
        key = (cfg.fft_size, cfg.num_data_subc, cfg.num_pilot_subc,
               cfg.cp_size, cfg.num_symb, cfg.t2sin_size, cfg.pr_sin_len,
               cfg.mod_type)
        if key in seen:
            continue
        seen.add(key)
        out.append(cfg)
    return out


def _pilot_power_fraction(cfg) -> float:
    """Fraction of per-symbol frequency-domain power carried by the pilot
    lattice.  The lattice is identical in EVERY symbol (preamble included),
    so the dense matched filter's sidelobe floor at symbol-aligned in-frame
    lags scales with this fraction — above ~0.35 no threshold separates the
    true preamble (~0.95) from the sidelobes plus short-window variance, and
    dense-lag correlation is non-discriminative by physics.  The reference
    is immune for the same reason the gated path is: it only correlates in
    a short window right after a t2 detect (`rx.cpp:133,158`)."""
    from c_ofdm.ops import modulation
    p_pilot = cfg.num_pilot_subc * cfg.pilot_ampl ** 2
    e_data = float(np.mean(np.abs(modulation.constellation(cfg.mod_type)) ** 2))
    return p_pilot / (p_pilot + cfg.num_data_subc * e_data)


@pytest.mark.parametrize("cfg", _cfgs(),
                         ids=lambda c: (f"fft{c.fft_size}_d{c.num_data_subc}"
                                        f"_p{c.num_pilot_subc}_cp{c.cp_size}"
                                        f"_s{c.num_symb}_t{c.t2sin_size}"
                                        f"_m{c.pr_sin_len}_q{c.mod_type}"
                                        f"_P{c.num_pr_symb}"))
def test_gated_matches_dense_across_geometries(cfg):
    spec = make_frame_spec(cfg, dtype=jnp.complex64)
    rng = np.random.default_rng(cfg.fft_size * 1000 + cfg.mod_type)
    sig, wire = _impaired_stream(spec, rng)
    max_frames = cfg.rx_buf_size + 1
    # dense-lag parity only where the matched filter is discriminative:
    # the sidelobe floor scales with the pilot power fraction AND with the
    # matched filter's shortness (variance ~ 1/sqrt(pr_sin_len) — the
    # 60-config deep sweep caught false accepts at pf 0.26-0.34 with
    # 64-tap filters), so dense parity is asserted for pf <= 0.30 and
    # pr_sin_len >= 128; every geometry is still held to
    # gated-vs-planted-truth below
    dense_ok = (_pilot_power_fraction(cfg) <= 0.30
                and cfg.pr_sin_len >= 128)
    outs = {}
    for mode in ("gated", "dense") if dense_ok else ("gated",):
        st0 = streaming.init_state(spec)
        _, out = streaming.process_buffer(spec, st0, jnp.asarray(sig),
                                          max_frames, mode)
        v = np.asarray(out.valid)
        outs[mode] = (v.tolist(),
                      np.asarray(out.positions)[v].tolist(),
                      np.asarray(out.mac_bytes)[v].tolist())
    if dense_ok:
        assert outs["gated"][0] == outs["dense"][0], "validity mask diverged"
        # the two paths refine the crossing with different granularity in
        # peak_refine mode (gated suppresses sub-peak crossings within its
        # candidate region; dense has no region structure), so positions
        # may differ by a few lags — the payloads must still be identical
        # and equal to the planted truth
        assert all(abs(a - b) <= 3 for a, b in
                   zip(outs["gated"][1], outs["dense"][1])),             "positions diverged beyond refinement granularity"
        assert outs["dense"][2] == [list(w) for w in wire],             "dense payload != planted"
    # the stream plants 3 decodable frames; the production (gated) path must
    # find them byte-exact and in order at EVERY geometry — including the
    # pilot-heavy ones where dense-lag matched filtering cannot work
    assert sum(outs["gated"][0]) == 3
    assert outs["gated"][2] == [list(w) for w in wire], "payload != planted"
