"""64-channel streaming correctness (round-4 verdict task 3; BASELINE
config #4's stated scale: "64 parallel OFDM streams batched on one chip").

Previously C=64 existed only as a demod-at-known-positions case
(test_baseline_configs); this drives the PRODUCTION streaming path — gated
sync, [C]-batched state threading, carry halo — at C=64 over consecutive
buffers with per-channel random frame offsets, asserting byte-exact
exactly-once decode per channel.  rx_buf_size=4 keeps the CPU cost down;
the C-axis machinery under test is size-generic.
"""

import numpy as np
import jax.numpy as jnp

from c_ofdm import ModemConfig, make_frame_spec
from c_ofdm.mac.mac import Mac
from c_ofdm.models import streaming, tx as txm

C = 64
N_BUFFERS = 2


def test_streaming_64_channels_exactly_once():
    cfg = ModemConfig(rx_buf_size=4)
    spec = make_frame_spec(cfg, dtype=jnp.complex64)
    buf_len = cfg.rx_buf_size * cfg.frame_len
    total = N_BUFFERS * buf_len
    n_per_c = 3
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(64)

    payloads = rng.integers(0, 256, (C, n_per_c, mac.payload), dtype=np.uint8)
    seqs = np.arange(C * n_per_c, dtype=np.uint32).reshape(C, n_per_c)
    wire = np.asarray(mac.write(
        jnp.asarray(payloads.reshape(C * n_per_c, -1)),
        jnp.asarray(seqs.reshape(-1)))).reshape(C, n_per_c, cfg.frame_bytes)
    frames = np.asarray(txm.transmit(
        spec, jnp.asarray(wire.reshape(C * n_per_c, -1)))).reshape(
            C, n_per_c, cfg.frame_len)

    sig = np.zeros((C, total), dtype=np.complex64)
    for c in range(C):
        slack = total - n_per_c * cfg.frame_len - cfg.frame_len  # tail margin
        gaps = rng.multinomial(slack, np.ones(n_per_c + 1) / (n_per_c + 1))
        pos = 0
        for i in range(n_per_c):
            pos += gaps[i]
            sig[c, pos:pos + cfg.frame_len] = frames[c, i]
            pos += cfg.frame_len
    n = np.arange(total)
    sig *= np.exp(2j * np.pi * 1e-4 * n)[None, :] * 50.0
    noise = rng.standard_normal(sig.shape) + 1j * rng.standard_normal(sig.shape)
    sig = (sig + noise * np.sqrt((np.abs(frames) ** 2).mean() * 2500
                                 * 10 ** (-28.0 / 10) / 2)).astype(np.complex64)

    state = streaming.init_state(spec, channels=C)
    max_frames = cfg.rx_buf_size + 1
    per_c = [[] for _ in range(C)]
    for b in range(N_BUFFERS):
        blocks = jnp.asarray(sig[:, b * buf_len:(b + 1) * buf_len])
        state, out = streaming.process_buffer(spec, state, blocks, max_frames)
        valid = np.asarray(out.valid)
        mb = np.asarray(out.mac_bytes)
        for c in range(C):
            for k in range(max_frames):
                if valid[c, k]:
                    per_c[c].append(mb[c, k])

    for c in range(C):
        got = np.asarray(per_c[c])
        assert got.shape[0] == n_per_c, (
            f"channel {c}: {got.shape[0]} != {n_per_c} frames")
        np.testing.assert_array_equal(got, wire[c],
                                      err_msg=f"channel {c} payload mismatch")
