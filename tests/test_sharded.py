"""Sharded {channel, time} receiver on the 8-device virtual CPU mesh:
parity with the single-device streaming path, exactly-once across shard
boundaries, and channel-axis independence."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from c_ofdm.mac.mac import Mac
from c_ofdm.models import tx as txm
from c_ofdm.parallel.mesh import make_modem_mesh
from c_ofdm.parallel.sharded import make_sharded_receiver, global_positions


def _build_capture(spec, cfg, n_frames, total_len, starts, seed=0, cfo=1e-4,
                   snr_db=26.0):
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (n_frames, mac.payload), dtype=np.uint8)
    wire = mac.write(jnp.asarray(payloads), jnp.arange(n_frames, dtype=jnp.uint32))
    frames = np.asarray(txm.transmit(spec, wire))
    sig = np.zeros(total_len, dtype=np.complex128)
    for f, s in zip(frames, starts):
        sig[s:s + cfg.frame_len] += f
    n = np.arange(total_len)
    sig = sig * np.exp(2j * np.pi * cfo * n) * 60.0
    noise_pow = (np.abs(frames) ** 2).mean() * 3600 * 10 ** (-snr_db / 10)
    sig += (rng.standard_normal(total_len) + 1j * rng.standard_normal(total_len)) \
        * np.sqrt(noise_pow / 2)
    return sig.astype(np.complex64), payloads, mac


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return make_modem_mesh(n_channel=2, n_time=4)


def test_sharded_exactly_once_boundary_frames(spec64, cfg, mesh8):
    """Frames deliberately placed across every time-shard boundary must each
    be decoded exactly once by the owning shard."""
    n_time = 4
    block_len = 4 * cfg.frame_len
    total = n_time * block_len
    # one frame per block interior + one straddling each boundary
    starts = []
    for b in range(n_time):
        starts.append(b * block_len + 8000)
        if b < n_time - 1:
            starts.append((b + 1) * block_len - cfg.frame_len // 3)  # straddles
    starts = sorted(starts)
    sig, payloads, mac = _build_capture(spec64, cfg, len(starts), total, starts)

    captures = np.stack([sig, np.zeros_like(sig)])  # channel 1 silent
    recv = make_sharded_receiver(spec64, mesh8, max_frames_per_block=6)
    out = recv(jnp.asarray(captures))
    gpos = np.asarray(global_positions(spec64, out, block_len))

    valid = np.asarray(out.valid)
    assert valid[1].sum() == 0, "silent channel must produce nothing"
    got_starts = np.sort(gpos[0][valid[0]]) - cfg.t2sin_size
    assert got_starts.size == len(starts), (got_starts, starts)
    # +-1 sample jitter is inherent to the threshold-crossing detector (the
    # reference's own "+1" fudge exists for the same reason); the linear-phase
    # equalizer absorbs it.
    assert np.abs(got_starts - np.asarray(starts)).max() <= 1, (got_starts, starts)

    # payload parity: decode every valid frame, map by seq
    diag = np.asarray(out.diag[0])
    seqs, oks = [], []
    for t in range(n_time):
        for k in np.nonzero(valid[0, t])[0]:
            fr = mac.read_soft(jnp.asarray(diag[t, k]))
            seqs.append(int(np.asarray(fr.seq)))
            oks.append(bool(np.asarray(fr.valid)))
            assert np.array_equal(np.asarray(fr.payload),
                                  payloads[int(np.asarray(fr.seq))])
    assert sorted(seqs) == list(range(len(starts))) and all(oks)


def test_sharded_capture_tail_semantics(spec64, cfg, mesh8):
    """Global capture-end edge: a frame ending exactly at the capture end
    decodes; a frame cut off by the capture end is dropped (not demodulated
    into CRC garbage) — matching the single-device extract_hits rule."""
    n_time = 4
    block_len = 4 * cfg.frame_len
    total = n_time * block_len
    # ch0: frame 0 mid-capture, frame 1 ends exactly at the capture end
    starts_full = [8000, total - cfg.frame_len]
    sig_a, pl_a, mac = _build_capture(spec64, cfg, 2, total, starts_full,
                                      seed=5)
    # ch1: frame 0 mid-capture, frame 1 cut off by the capture end
    start_cut = total - cfg.frame_len + 2048   # 2048 samples run past the end
    sig_b, pl_b, _ = _build_capture(
        spec64, cfg, 2, total + cfg.frame_len, [8000, start_cut], seed=6)
    sig_b = sig_b[:total]                      # hard capture boundary
    captures = np.stack([sig_a, sig_b])
    recv = make_sharded_receiver(spec64, mesh8, max_frames_per_block=4)
    out = recv(jnp.asarray(captures))
    valid = np.asarray(out.valid)
    gpos = np.asarray(global_positions(spec64, out, block_len))

    # ch0: both frames decode, incl. the exact-tail one
    got_a = np.sort(gpos[0][valid[0]]) - cfg.t2sin_size
    assert got_a.size == 2, (got_a, starts_full)
    assert np.abs(got_a - np.asarray(starts_full)).max() <= 1
    diag = np.asarray(out.diag)
    seqs = []
    for t in range(n_time):
        for k in np.nonzero(valid[0, t])[0]:
            fr = mac.read_soft(jnp.asarray(diag[0, t, k]))
            assert bool(np.asarray(fr.valid))
            seqs.append(int(np.asarray(fr.seq)))
            assert np.array_equal(np.asarray(fr.payload),
                                  pl_a[int(np.asarray(fr.seq))])
    assert sorted(seqs) == [0, 1]

    # ch1: the cut frame is dropped (no garbage decode), the mid one survives
    got_b = np.sort(gpos[1][valid[1]]) - cfg.t2sin_size
    assert got_b.size == 1, (got_b, start_cut)
    assert abs(int(got_b[0]) - 8000) <= 1


def test_sharded_channel_axis_independent(spec64, cfg, mesh8):
    """Different payload sets per channel decode independently."""
    block_len = 2 * cfg.frame_len
    total = 4 * block_len
    starts = [500, 2 * cfg.frame_len + 3000, 5 * cfg.frame_len + 100]
    sig_a, pl_a, mac = _build_capture(spec64, cfg, 3, total, starts, seed=1)
    sig_b, pl_b, _ = _build_capture(spec64, cfg, 3, total, starts, seed=2,
                                    cfo=-2e-4)
    recv = make_sharded_receiver(spec64, mesh8, max_frames_per_block=4)
    out = recv(jnp.asarray(np.stack([sig_a, sig_b])))
    valid = np.asarray(out.valid)
    assert valid[0].sum() == 3 and valid[1].sum() == 3
    for ch, pls in ((0, pl_a), (1, pl_b)):
        for t in range(4):
            for k in np.nonzero(valid[ch, t])[0]:
                fr = mac.read_soft(jnp.asarray(np.asarray(out.diag)[ch, t, k]))
                assert np.array_equal(np.asarray(fr.payload),
                                      pls[int(np.asarray(fr.seq))])


def test_make_global_capture_sharding(spec64, cfg, mesh8):
    """parallel.ingest places a host-local capture with the canonical
    (channel, time) sharding; receiver output matches an unsharded input."""
    from c_ofdm.parallel.ingest import capture_sharding, make_global_capture

    block_len = 4 * cfg.frame_len
    total_len = 4 * block_len
    starts = [3000, block_len + 100, 2 * block_len + cfg.frame_len]
    sig, payloads, mac = _build_capture(spec64, cfg, len(starts), total_len,
                                        starts, seed=11)
    caps = np.stack([sig, sig])
    arr = make_global_capture(mesh8, caps)
    assert arr.sharding == capture_sharding(mesh8)
    recv = make_sharded_receiver(spec64, mesh8, max_frames_per_block=4)
    out_sharded = recv(arr)
    out_plain = recv(jnp.asarray(caps))
    for a, b in zip(jax.tree.leaves(out_sharded), jax.tree.leaves(out_plain)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(out_sharded.num_found.sum()) == 2 * len(starts)


def test_sharded_streaming_matches_unsharded(spec64, cfg):
    """Channel-sharded CONTINUOUS streaming (make_sharded_streaming): 4
    channel streams over a 4-device channel mesh, two consecutive buffers
    with a boundary-straddling frame per channel — state threading and
    decode must match the unsharded [C]-batched process_buffer exactly."""
    from c_ofdm.models import streaming
    from c_ofdm.parallel.sharded import make_sharded_streaming

    C = 4
    mesh = make_modem_mesh(n_channel=4, n_time=1)
    buf_len = 6 * cfg.frame_len
    # per channel: one frame mid-buffer-0, one straddling the buffer
    # boundary, one mid-buffer-1
    starts = [500, buf_len - cfg.frame_len // 2, buf_len + 2 * cfg.frame_len]
    sigs, payloads = [], []
    for c in range(C):
        sig, pls, mac = _build_capture(spec64, cfg, len(starts), 2 * buf_len,
                                       starts, seed=100 + c)
        sigs.append(sig)
        payloads.append(pls)
    blocks = np.stack(sigs).reshape(C, 2, buf_len).transpose(1, 0, 2)

    max_frames = 8
    step = make_sharded_streaming(spec64, mesh, max_frames)
    st_sh = streaming.init_state(spec64, channels=C)
    st_pl = streaming.init_state(spec64, channels=C)
    for b in range(2):
        blk = jnp.asarray(blocks[b])
        st_sh, out_sh = step(st_sh, blk)
        st_pl, out_pl = streaming.process_buffer(spec64, st_pl, blk,
                                                 max_frames)
        v_sh = np.asarray(out_sh.valid)
        v_pl = np.asarray(out_pl.valid)
        assert np.array_equal(v_sh, v_pl), f"buffer {b} validity"
        assert np.array_equal(np.asarray(out_sh.positions)[v_sh],
                              np.asarray(out_pl.positions)[v_pl])
        assert np.array_equal(np.asarray(out_sh.mac_bytes),
                              np.asarray(out_pl.mac_bytes))
    # all 3 frames per channel decoded across the two buffers (incl. the
    # straddler via the carry halo), threading sharded state exactly once
    assert int(np.asarray(st_sh.frames_seen).sum()) == 3 * C
    assert np.array_equal(np.asarray(st_sh.frames_seen),
                          np.asarray(st_pl.frames_seen))
