"""Long-run streaming soak (round-4 verdict task 5).

The reference's production loop runs 10 000 iterations over a live ring
(`/root/reference/rx.cpp:128-234`); the repo's short streaming tests cover
2-4 buffers.  This soak drives >=1000 consecutive ingest buffers through
``streaming.process_buffer`` on a small geometry (CPU, seeded, planted
truth) and asserts ZERO missed, duplicated, or corrupted frames.  What only
length exercises:

  * carry-state threading across thousands of slides (carry halo,
    ``next_min_pos`` translation at every ring tail, frames straddling
    buffer boundaries hundreds of times);
  * MAC seq beyond toy ranges: the planted sequence starts below the uint32
    wrap and crosses it mid-run (and crosses the int32 sign boundary region
    on the way), so any signed/narrow seq handling corrupts the tail of the
    run;
  * frame accounting: ``frames_seen`` monotonic growth equal to the planted
    count;
  * sample-clock offset: the whole stream is resampled at +12 ppm, so
    frame timing drifts ~70 samples across the run — the per-frame matched
    filter must keep re-acquiring (SCO within one frame is negligible;
    the drift ACROSS the run is what only a soak can exercise).
"""

import numpy as np
import jax.numpy as jnp

from c_ofdm import ModemConfig, make_frame_spec
from c_ofdm.mac.mac import Mac
from c_ofdm.models import streaming, tx as txm

N_BUFFERS = 1200
SEQ_START = (1 << 32) - 1500        # wraps to 0 mid-run

CFG = ModemConfig(fft_size=256, num_data_subc=128, num_pilot_subc=4,
                  cp_size=64, num_symb=2, t2sin_size=128, pr_sin_len=128,
                  mod_type=2, rx_buf_size=4)


def _planted_stream(spec, rng):
    """Frames back-to-back with random gaps over N_BUFFERS buffers of
    signal + CFO + mild AWGN.  Returns (buffers [N, buf_len] c64, wire,
    seqs)."""
    cfg = spec.cfg
    buf_len = cfg.rx_buf_size * cfg.frame_len
    total = N_BUFFERS * buf_len
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)

    # positions first (cheap), then one batched TX over all frames
    positions = []
    pos = int(rng.integers(0, cfg.frame_len))
    while pos + 2 * cfg.frame_len <= total:   # margin: last frame decodable
        positions.append(pos)
        pos += cfg.frame_len + int(rng.integers(0, int(0.8 * cfg.frame_len)))
    n_frames = len(positions)
    assert n_frames > 2000, n_frames

    payloads = rng.integers(0, 256, (n_frames, mac.payload), dtype=np.uint8)
    seqs = (SEQ_START + np.arange(n_frames, dtype=np.uint64)).astype(np.uint32)
    wire = np.asarray(mac.write(jnp.asarray(payloads), jnp.asarray(seqs)))
    frames = np.asarray(txm.transmit(spec, jnp.asarray(wire)))

    sig = np.zeros(total, dtype=np.complex64)
    for i, p in enumerate(positions):
        sig[p:p + cfg.frame_len] = frames[i]
    n = np.arange(total)
    sig = sig * np.exp(2j * np.pi * 1e-4 * n) * 50.0
    # +12 ppm sample-clock offset: resample the whole stream so timing
    # drifts ~70 samples end-to-end (linear interp; in-band signal)
    t = n * (1.0 + 12e-6)
    t = np.clip(t, 0, total - 1)
    sig = np.interp(t, n, sig.real) + 1j * np.interp(t, n, sig.imag)
    noise = rng.standard_normal(total) + 1j * rng.standard_normal(total)
    sig = (sig + noise * np.sqrt((np.abs(frames) ** 2).mean() * 2500
                                 * 10 ** (-30.0 / 10) / 2)).astype(np.complex64)
    return sig.reshape(N_BUFFERS, buf_len), payloads, seqs, mac


def test_soak_1000_buffers_exactly_once():
    spec = make_frame_spec(CFG, dtype=jnp.complex64)
    cfg = spec.cfg
    rng = np.random.default_rng(20260821)
    buffers, payloads, seqs, mac = _planted_stream(spec, rng)
    n_frames = len(seqs)

    state = streaming.init_state(spec)
    max_frames = cfg.rx_buf_size + 1
    got_payload = []
    got_seq = []
    prev_seen = 0
    for b in range(N_BUFFERS):
        state, out = streaming.process_buffer(
            spec, state, jnp.asarray(buffers[b]), max_frames)
        v = np.asarray(out.valid)
        if v.any():
            frames_mac = mac.read_soft(jnp.asarray(np.asarray(out.diag)[v]))
            ok = np.asarray(frames_mac.valid)
            assert ok.all(), f"CRC-invalid frame in buffer {b}"
            got_payload.append(np.asarray(frames_mac.payload))
            got_seq.append(np.asarray(frames_mac.seq))
        seen = int(np.asarray(state.frames_seen))
        assert seen == prev_seen + int(v.sum())     # monotonic accounting
        prev_seen = seen

    got_payload = np.concatenate(got_payload, axis=0)
    got_seq = np.concatenate(got_seq, axis=0)

    # exactly once, in order: counts equal, sequences equal elementwise
    assert got_seq.shape[0] == n_frames, (
        f"{got_seq.shape[0]} decoded != {n_frames} planted "
        f"(missed or duplicated frames)")
    np.testing.assert_array_equal(got_seq, seqs)      # incl. the uint32 wrap
    np.testing.assert_array_equal(got_payload, payloads)
    # the wrap actually happened inside the run
    assert seqs[0] > seqs[-1]
