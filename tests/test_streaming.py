"""Streaming receiver: multi-frame buffers, boundary-straddling frames,
exactly-once decode, golden-capture replay."""

import numpy as np
import jax
import jax.numpy as jnp

from c_ofdm.mac.mac import Mac
from c_ofdm.models import streaming, tx as txm
from c_ofdm.models.streaming import StreamingReceiver


def _make_stream(spec, cfg, n_frames, gap, seed=0, snr_db=28.0, cfo=1e-4,
                 lead=777):
    """n_frames back-to-back (plus `gap` noise samples between) frames with
    seq-stamped MAC payloads, embedded in a noisy stream."""
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (n_frames, mac.payload), dtype=np.uint8)
    wire = mac.write(jnp.asarray(payloads),
                     jnp.arange(n_frames, dtype=jnp.uint32))
    frames = np.asarray(txm.transmit(spec, wire))
    sig_parts = [np.zeros(lead, dtype=frames.dtype)]
    for i in range(n_frames):
        sig_parts.append(frames[i])
        if gap:
            sig_parts.append(np.zeros(gap, dtype=frames.dtype))
    sig = np.concatenate(sig_parts)
    n = np.arange(sig.size)
    sig = sig * np.exp(2j * np.pi * cfo * n) * 60.0
    noise_pow = (np.abs(frames) ** 2).mean() * 60.0 ** 2 * 10 ** (-snr_db / 10)
    noise = (rng.standard_normal(sig.size) + 1j * rng.standard_normal(sig.size))
    sig = sig + noise * np.sqrt(noise_pow / 2)
    return sig.astype(np.complex64), payloads, mac


def _run_stream(spec, cfg, sig, mac, max_frames=8):
    buf_len = cfg.rx_buf_size * cfg.frame_len
    pad = (-sig.size) % buf_len
    sig = np.concatenate([sig, np.zeros(pad, dtype=sig.dtype)])
    rxr = StreamingReceiver(spec, max_frames=max_frames)
    got = []
    for i in range(sig.size // buf_len):
        out = rxr.feed(sig[i * buf_len:(i + 1) * buf_len])
        valid = np.asarray(out.valid)
        for k in np.nonzero(valid)[0]:
            frame = mac.read_soft(out.diag[k])
            got.append((int(np.asarray(frame.seq)),
                        np.asarray(frame.payload),
                        bool(np.asarray(frame.valid))))
    return got


def test_stream_multiframe_one_buffer(spec64, cfg):
    sig, payloads, mac = _make_stream(spec64, cfg, n_frames=5, gap=3000)
    got = _run_stream(spec64, cfg, sig, mac)
    assert len(got) == 5
    for i, (seq, pl, ok) in enumerate(got):
        assert seq == i and ok
        assert np.array_equal(pl, payloads[i])


def test_stream_boundary_straddling_frames(spec64, cfg):
    """Frames placed so several straddle ingest-buffer boundaries; every frame
    must be decoded exactly once, in order (reference carry-over semantics,
    rx.cpp:147-156)."""
    buf_len = cfg.rx_buf_size * cfg.frame_len
    # gap chosen so frame k starts at lead + k*(frame_len+gap); with gap such
    # that some frame crosses each multiple of buf_len
    sig, payloads, mac = _make_stream(spec64, cfg, n_frames=90, gap=17,
                                      lead=buf_len - 2 * cfg.frame_len - 351)
    got = _run_stream(spec64, cfg, sig, mac, max_frames=45)
    assert len(got) == 90, f"decoded {len(got)} of 90"
    for i, (seq, pl, ok) in enumerate(got):
        assert seq == i and ok, (i, seq, ok)
        assert np.array_equal(pl, payloads[i])


def test_stream_back_to_back_frames(spec64, cfg):
    sig, payloads, mac = _make_stream(spec64, cfg, n_frames=12, gap=0,
                                      snr_db=30.0, cfo=-2e-4)
    got = _run_stream(spec64, cfg, sig, mac, max_frames=45)
    assert len(got) == 12
    assert all(ok for _, _, ok in got)
    assert [s for s, _, _ in got] == list(range(12))


def test_stream_golden_capture(spec128, cfg, ref_capture, ref_decoded_text):
    """Feed the committed OTA ring through the streaming path: the known frame
    (present twice in the ring) must decode with the War-and-Peace payload."""
    cap = ref_capture
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    buf_len = cfg.rx_buf_size * cfg.frame_len
    pad = (-cap.size) % buf_len
    cap = np.concatenate([cap, np.zeros(pad, dtype=cap.dtype)])
    rxr = StreamingReceiver(spec128, max_frames=8)
    decoded = []
    for i in range(cap.size // buf_len):
        out = rxr.feed(cap[i * buf_len:(i + 1) * buf_len])
        for k in np.nonzero(np.asarray(out.valid))[0]:
            frame = mac.read_soft(out.diag[k])
            decoded.append(np.asarray(frame.payload).tobytes())
    assert len(decoded) >= 1
    assert decoded[0] == ref_decoded_text


def test_stream_silence_no_frames(spec64, cfg):
    rxr = StreamingReceiver(spec64)
    out = rxr.feed(np.zeros(cfg.rx_buf_size * cfg.frame_len, dtype=np.complex64))
    assert int(np.asarray(out.num_found)) == 0
    assert not np.asarray(out.valid).any()


def test_stream_sync_loss_and_recovery(spec64, cfg):
    """A dropout (pure noise) mid-stream must not derail the receiver: frames
    after the outage decode normally and the seq gap is observable
    (reference behavior: sync-loss -> refill -> resync, rx.cpp:137-166)."""
    from c_ofdm.models.streaming import StreamingReceiver
    sig_a, payloads_a, mac = _make_stream(spec64, cfg, n_frames=3, gap=1000,
                                          seed=10)
    sig_b, payloads_b, _ = _make_stream(spec64, cfg, n_frames=3, gap=1000,
                                        seed=11)
    rng = np.random.default_rng(12)
    buf_len = cfg.rx_buf_size * cfg.frame_len
    noise = (rng.standard_normal(buf_len) + 1j * rng.standard_normal(buf_len)
             ).astype(np.complex64) * 0.5
    sig = np.concatenate([sig_a, noise, sig_b])
    got = _run_stream(spec64, cfg, sig, mac, max_frames=10)
    assert len(got) == 6
    assert [s for s, _, _ in got] == [0, 1, 2, 0, 1, 2]
    for i, (seq, pl, ok) in enumerate(got):
        assert ok
        assert np.array_equal(pl, (payloads_a if i < 3 else payloads_b)[seq])


def test_gated_matches_dense_sync(spec64, cfg):
    """The t2-gated production sync must find the same frames at the same
    positions as the dense every-lag matched filter on realistic streams
    (random offsets, noise, CFO), across buffer boundaries."""
    sig, payloads, mac = _make_stream(spec64, cfg, n_frames=40, gap=2111,
                                      seed=13, snr_db=22.0, cfo=-1.2e-4,
                                      lead=50_000)
    buf_len = cfg.rx_buf_size * cfg.frame_len
    pad = (-sig.size) % buf_len
    sig = np.concatenate([sig, np.zeros(pad, dtype=sig.dtype)])
    outs = {}
    for mode in ("gated", "dense"):
        rxr = StreamingReceiver(spec64, max_frames=24, sync_mode=mode)
        rows = []
        for i in range(sig.size // buf_len):
            out = rxr.feed(sig[i * buf_len:(i + 1) * buf_len])
            v = np.asarray(out.valid)
            rows.append((np.asarray(out.positions)[v],
                         np.asarray(out.mac_bytes)[v]))
        outs[mode] = rows
    for (pg, bg), (pd, bd) in zip(outs["gated"], outs["dense"]):
        np.testing.assert_array_equal(pg, pd)
        np.testing.assert_array_equal(bg, bd)
    total = sum(len(p) for p, _ in outs["gated"])
    assert total == 40


def test_gated_recall_all_alignments(spec64, cfg):
    """The overlapping-window gate must fire for a burst at ANY sample
    alignment relative to the 256-sample detector blocks (the failure mode
    the 50% hop exists for)."""
    from c_ofdm.models.streaming import gated_hits, init_state
    import jax.numpy as jnp

    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, mac.payload, dtype=np.uint8)
    wire = mac.write(jnp.asarray(payload), jnp.uint32(0))
    frame = np.asarray(txm.transmit(spec64, wire))
    n = 4 * cfg.frame_len
    noise = (rng.standard_normal((8, n)) + 1j * rng.standard_normal((8, n))) \
        * 0.02
    offs = [0, 37, 64, 101, 128, 191, 213, 255]   # all alignment classes
    ring = noise.astype(np.complex64)
    for r, off in enumerate(offs):
        s = 3000 + off
        ring[r, s:s + cfg.frame_len] += frame * 60.0
    pos, valid = jax.vmap(
        lambda x: gated_hits(spec64, x, jnp.asarray(0, jnp.int32), 4))(
            jnp.asarray(ring))
    pos, valid = np.asarray(pos), np.asarray(valid)
    assert valid[:, 0].all(), (valid, pos)
    starts = pos[:, 0] - cfg.t2sin_size
    for r, off in enumerate(offs):
        assert abs(int(starts[r]) - (3000 + off)) <= 1, (r, off, starts[r])


def test_extract_sigs_match_numpy_slices(spec64, cfg):
    """The batched, single-ring and multi-ring window gathers equal plain
    numpy slices of the post-burst span, including clamp-at-edge starts."""
    from c_ofdm.models import rx as rxm

    rng = np.random.default_rng(4)
    n = 3 * cfg.frame_len
    ln = cfg.preamble_len + cfg.message_len
    caps = (rng.standard_normal((5, n))
            + 1j * rng.standard_normal((5, n))).astype(np.complex64)
    starts = np.asarray([0, 100, cfg.frame_len, 2 * cfg.frame_len,
                         n - cfg.frame_len], dtype=np.int32)

    def want(cap, s):
        s0 = min(max(int(s) + cfg.t2sin_size, 0), n - ln)
        return cap[s0:s0 + ln]

    got = np.asarray(rxm.extract_sigs_rows(spec64, jnp.asarray(caps),
                                           jnp.asarray(starts)))
    np.testing.assert_array_equal(
        got, np.stack([want(c, s) for c, s in zip(caps, starts)]))
    got1 = np.asarray(rxm.extract_sigs_ring(spec64, jnp.asarray(caps[0]),
                                            jnp.asarray(starts)))
    np.testing.assert_array_equal(
        got1, np.stack([want(caps[0], s) for s in starts]))
    st2 = np.stack([starts, starts[::-1]])
    got2 = np.asarray(rxm.extract_sigs_ring(spec64, jnp.asarray(caps[:2]),
                                            jnp.asarray(st2)))
    np.testing.assert_array_equal(
        got2, np.stack([[want(caps[c], s) for s in st2[c]]
                        for c in range(2)]))


def test_multichannel_process_buffer_matches_per_channel(spec64, cfg):
    """Batch-first multi-channel streaming (leading [C] axis on blocks and
    state) must decode exactly what C independent single-channel receivers
    decode, including carry state across buffers."""
    C = 3
    streams, payload_sets, mac = [], [], None
    for c in range(C):
        sig, payloads, mac = _make_stream(spec64, cfg, n_frames=6,
                                          gap=503 + 97 * c, seed=30 + c,
                                          cfo=(c - 1) * 1e-4,
                                          lead=900 + 411 * c)
        streams.append(sig)
        payload_sets.append(payloads)
    buf_len = cfg.rx_buf_size * cfg.frame_len
    n_bufs = 2
    total = n_bufs * buf_len
    blocks = np.zeros((C, total), dtype=np.complex64)
    for c, sig in enumerate(streams):
        blocks[c, :sig.size] = sig[:total]

    # multi-channel: one fused step per buffer over [C, buf_len]
    state = streaming.init_state(spec64, channels=C)
    multi = [[] for _ in range(C)]
    for b in range(n_bufs):
        state, out = streaming.process_buffer(
            spec64, state, jnp.asarray(blocks[:, b * buf_len:(b + 1) * buf_len]),
            8)
        for c in range(C):
            for k in np.nonzero(np.asarray(out.valid[c]))[0]:
                fr = mac.read_soft(out.diag[c, k])
                multi[c].append((int(np.asarray(fr.seq)),
                                 np.asarray(fr.payload),
                                 bool(np.asarray(fr.valid)),
                                 int(np.asarray(out.positions)[c, k])))

    # reference: C separate single-channel receivers
    for c in range(C):
        single = []
        st = streaming.init_state(spec64)
        for b in range(n_bufs):
            st, out = streaming.process_buffer(
                spec64, st, jnp.asarray(blocks[c, b * buf_len:(b + 1) * buf_len]),
                8)
            for k in np.nonzero(np.asarray(out.valid))[0]:
                fr = mac.read_soft(out.diag[k])
                single.append((int(np.asarray(fr.seq)),
                               np.asarray(fr.payload),
                               bool(np.asarray(fr.valid)),
                               int(np.asarray(out.positions)[k])))
        assert len(multi[c]) == len(single) == 6, (c, len(multi[c]), len(single))
        for (sa, pa, oa, qa), (sb, pb, ob, qb) in zip(multi[c], single):
            assert sa == sb and oa == ob and qa == qb
            assert np.array_equal(pa, pb)
        for i, (seq, pl, ok, _) in enumerate(single):
            assert seq == i and ok
            assert np.array_equal(pl, payload_sets[c][i])


def test_gated_matches_dense_nondefault_t2sin():
    """Round-2 advisor finding: with a config-file-settable T2sin_size=512
    the searched-lag window used to be a constant sized for 256, silently
    missing every frame.  The lag count now derives from the config geometry
    (ModemConfig.gated_search_lags); gated must match dense at the
    non-default size."""
    from c_ofdm.config import ModemConfig
    from c_ofdm.models.frame import make_frame_spec

    cfg = ModemConfig(t2sin_size=512)
    assert cfg.gated_search_lags >= 2 * cfg.t2sin_size + cfg.pr_sin_len
    spec = make_frame_spec(cfg, dtype=jnp.complex64)
    sig, payloads, mac = _make_stream(spec, cfg, n_frames=6, gap=1511,
                                      seed=6, lead=40_000)
    outs = {}
    for mode in ("gated", "dense"):
        got = []
        buf_len = cfg.rx_buf_size * cfg.frame_len
        pad = (-sig.size) % buf_len
        s = np.concatenate([sig, np.zeros(pad, dtype=sig.dtype)])
        rxr = StreamingReceiver(spec, max_frames=8, sync_mode=mode)
        for i in range(s.size // buf_len):
            out = rxr.feed(s[i * buf_len:(i + 1) * buf_len])
            v = np.asarray(out.valid)
            got.append((np.asarray(out.positions)[v],
                        np.asarray(out.mac_bytes)[v]))
        outs[mode] = got
    total = 0
    for (pg, bg), (pd, bd) in zip(outs["gated"], outs["dense"]):
        np.testing.assert_array_equal(pg, pd)
        np.testing.assert_array_equal(bg, bd)
        total += len(pg)
    assert total == 6


def test_gate_candidates_survive_spurious_peaks(spec64, cfg):
    """Candidate slots are max_frames + t2_gate_slack, filled by the
    STRONGEST track peaks (top-K), not the first K in position order — so
    burst-like interference above the gate but below a real burst's ~0.97
    energy ratio cannot evict real frames no matter how much of it precedes
    them.  10 weak spurious peaks + 3 real frames with zero slack (K = 8)
    must still decode all 3 (the old positional-edge rule would decode 0)."""
    from c_ofdm.config import ModemConfig
    from c_ofdm.models.frame import make_frame_spec

    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(7)
    payloads = rng.integers(0, 256, (3, mac.payload), dtype=np.uint8)
    wire = mac.write(jnp.asarray(payloads), jnp.arange(3, dtype=jnp.uint32))
    frames = np.asarray(txm.transmit(spec64, wire))
    burst = frames[0, :cfg.t2sin_size]          # t2 burst alone = spurious
    buf_len = cfg.rx_buf_size * cfg.frame_len
    sig = np.zeros(buf_len, dtype=np.complex64)
    noise_amp = np.sqrt((np.abs(frames) ** 2).mean() * 3600
                        * 10 ** (-26 / 10) / 2)
    # spurious bursts near the noise floor: the energy RATIO is scale-
    # invariant for a clean burst, so weakness must come from the noise --
    # amplitude ~2.2x noise sigma puts the track peak ~0.5-0.8 (above the
    # 0.4 gate, below a real burst's ~0.97)
    burst_w = burst / np.sqrt((np.abs(burst) ** 2).mean()) * 2.2 * noise_amp
    pos = 5000
    for _ in range(10):                          # 10 spurious peaks first
        sig[pos:pos + cfg.t2sin_size] = burst_w
        pos += 4 * cfg.t2sin_size
    starts = []
    for i in range(3):
        sig[pos:pos + cfg.frame_len] = frames[i] * 60.0
        starts.append(pos)
        pos += cfg.frame_len + 3000
    noise = (rng.standard_normal(buf_len)
             + 1j * rng.standard_normal(buf_len)).astype(np.complex64)
    sig = sig + noise * noise_amp

    cfg_s = ModemConfig(t2_gate_slack=0)
    spec_s = make_frame_spec(cfg_s, dtype=jnp.complex64)
    rxr = StreamingReceiver(spec_s, max_frames=8)
    out = rxr.feed(sig)
    v = np.asarray(out.valid)
    # ring = [carry | block], so ring positions sit one frame_len after
    # the block-relative ones
    got = np.asarray(out.positions)[v] - cfg.t2sin_size - cfg.frame_len
    assert len(got) == 3, (got, starts)
    for g, s in zip(got, starts):
        assert abs(int(g) - s) <= 1, (got, starts)


def test_stream_low_snr_gate_recall(cfg):
    """Streaming recall at 12 dB SNR with a low-SNR config
    (T2_sin_level=300, gate defaulting to 150 — the round-2 advisor's
    previously-rejected operating point): every frame must be detected at
    the right position; payloads may carry bit errors at this SNR but CRC
    validation must pass for most frames."""
    from c_ofdm.config import ModemConfig
    from c_ofdm.models.frame import make_frame_spec

    lcfg = ModemConfig(t2_sin_level=0.3)
    assert abs(lcfg.t2_gate_level - 0.15) < 1e-9
    spec = make_frame_spec(lcfg, dtype=jnp.complex64)
    sig, payloads, mac = _make_stream(spec, lcfg, n_frames=8, gap=2000,
                                      seed=8, snr_db=12.0, cfo=5e-5,
                                      lead=10_000)
    got = _run_stream(spec, lcfg, sig, mac, max_frames=12)
    assert len(got) == 8, f"detected {len(got)}/8 at 12 dB"
    seqs = [s for s, _, _ in got]
    assert seqs == list(range(8)), seqs
    n_ok = sum(ok for _, _, ok in got)
    assert n_ok >= 6, f"only {n_ok}/8 frames CRC-clean at 12 dB"


def test_multichannel_gated_matches_dense_per_channel(spec64, cfg):
    """V9 (round-2 verdict): the C>1 gated path needs a detector-independent
    oracle — each channel of the batch-first gated output must equal the
    single-channel DENSE receiver run on that channel's stream."""
    C = 2
    streams = []
    mac = None
    for c in range(C):
        sig, _, mac = _make_stream(spec64, cfg, n_frames=5,
                                   gap=700 + 301 * c, seed=40 + c,
                                   cfo=(2 * c - 1) * 1e-4,
                                   lead=1200 + 811 * c)
        streams.append(sig)
    buf_len = cfg.rx_buf_size * cfg.frame_len
    n_bufs = 2
    blocks = np.zeros((C, n_bufs * buf_len), dtype=np.complex64)
    for c, sig in enumerate(streams):
        blocks[c, :sig.size] = sig[:n_bufs * buf_len]

    state = streaming.init_state(spec64, channels=C)
    gated = [[] for _ in range(C)]
    for b in range(n_bufs):
        state, out = streaming.process_buffer(
            spec64, state, jnp.asarray(blocks[:, b * buf_len:(b + 1) * buf_len]),
            8)
        for c in range(C):
            v = np.asarray(out.valid[c])
            gated[c].append((np.asarray(out.positions[c])[v],
                             np.asarray(out.mac_bytes[c])[v]))

    for c in range(C):
        st = streaming.init_state(spec64)
        for b in range(n_bufs):
            st, out = streaming.process_buffer(
                spec64, st,
                jnp.asarray(blocks[c, b * buf_len:(b + 1) * buf_len]),
                8, "dense")
            v = np.asarray(out.valid)
            pd, bd = np.asarray(out.positions)[v], np.asarray(out.mac_bytes)[v]
            pg, bg = gated[c][b]
            np.testing.assert_array_equal(pg, pd)
            np.testing.assert_array_equal(bg, bd)
    assert sum(len(p) for c in range(C) for p, _ in gated[c]) == C * 5
