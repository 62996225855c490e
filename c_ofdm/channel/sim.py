"""Deterministic channel simulator — the hardware-free loop the reference
never had (its only 'channel' is two physical PlutoSDRs, `python_code/channel.py`).

Implements the impairments of the real AD9361 link in composable, jittable,
batch-first form:

* complex AWGN at a target SNR,
* carrier frequency offset (cycles/sample) + random initial phase,
* integer timing offset (frame placed at an arbitrary position in a longer
  capture window, embedded in noise),
* sample-clock offset (fractional resampling — TX and RX converter clocks
  drift by ~ppm on a real AD9361 link),
* multipath: static FIR with complex taps,
* amplitude scale + int16 quantization (models the SDR's fixed-point path).

All randomness flows from an explicit `jax.random` key: a given (key, params)
pair is reproducible across runs, hosts, and device counts.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class ChannelParams:
    snr_db: float = 30.0
    cfo: float = 0.0             # cycles/sample, e.g. 2e-4
    timing_offset: int = 0       # samples of delay before the frame
    capture_len: int = 0         # total output length (0 = frame length + offset)
    multipath: tuple = ()        # complex FIR taps after the direct tap, e.g. (0.2+0.1j,)
    amplitude: float = 1.0       # channel gain
    quantize_mult: int = 0       # if >0: int16 round-trip at this scale (e.g. 200)
    sco_ppm: float = 0.0         # RX sample-clock offset vs TX, parts/million


def apply_channel(params: ChannelParams, key: jax.Array,
                  frames: jnp.ndarray) -> jnp.ndarray:
    """frames [..., n] -> impaired capture [..., capture_len or n+offset]."""
    x = frames
    dtype = x.dtype
    rdtype = x.real.dtype
    k_noise, k_phase = jax.random.split(key)

    # multipath FIR (direct tap 1.0 + echoes)
    if params.multipath:
        taps = np.concatenate([[1.0], np.asarray(params.multipath)]).astype(np.complex128)
        y = jnp.zeros_like(x)
        for d, t in enumerate(taps):
            y = y + jnp.asarray(t, dtype=dtype) * jnp.roll(x, d, axis=-1) * \
                (jnp.arange(x.shape[-1]) >= d)
        x = y

    # CFO + random initial phase (the phase is always random — a real LO
    # never starts at zero phase, CFO or not)
    n = jnp.arange(x.shape[-1], dtype=rdtype)
    phi0 = jax.random.uniform(k_phase, x.shape[:-1], dtype=rdtype,
                              minval=0.0, maxval=2 * np.pi)
    ang = 2 * np.pi * params.cfo * n + phi0[..., None]
    x = x * jnp.exp(1j * ang).astype(dtype)

    x = x * jnp.asarray(params.amplitude, dtype=dtype)

    # timing offset + capture window
    n_in = x.shape[-1]
    total = params.capture_len or (n_in + params.timing_offset)
    pad_front = params.timing_offset
    pad_back = max(0, total - n_in - pad_front)
    x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad_front, pad_back)])
    x = x[..., :total]

    # sample-clock offset: the RX converter samples the continuous waveform
    # at (1 + ppm*1e-6) x the TX rate — cubic-free linear interpolation is
    # plenty at ppm-scale fractional delays (worst-case interp error ~ -60 dB
    # for delta <= 0.5 sample at this oversampling).  Interp indices are
    # numpy constants (params is static), so XLA sees static gathers.
    if params.sco_ppm:
        total_now = x.shape[-1]
        t = np.arange(total_now) * (1.0 + params.sco_ppm * 1e-6)
        i0 = np.minimum(t.astype(np.int64), total_now - 2)
        frac = (t - i0).astype(np.float64)
        w = jnp.asarray(frac, dtype=rdtype)
        x = x[..., i0] * (1 - w) + x[..., i0 + 1] * w

    # AWGN at SNR relative to the *frame* signal power
    sig_pow = (jnp.abs(frames) ** 2).mean() * params.amplitude ** 2
    noise_pow = sig_pow * 10.0 ** (-params.snr_db / 10.0)
    nr = jax.random.normal(k_noise, (*x.shape, 2), dtype=rdtype)
    noise = (nr[..., 0] + 1j * nr[..., 1]) * jnp.sqrt(noise_pow / 2).astype(rdtype)
    x = x + noise.astype(dtype)

    # int16 quantization round-trip (SDR fixed-point path)
    if params.quantize_mult:
        m = params.quantize_mult
        q = jnp.clip(jnp.round(x.real * m), -32768, 32767) / m
        qi = jnp.clip(jnp.round(x.imag * m), -32768, 32767) / m
        x = (q + 1j * qi).astype(dtype)

    return x


class PlantedStream(NamedTuple):
    iq: np.ndarray          # [total] complex64 capture
    starts: np.ndarray      # [n_frames] first sample of each planted frame
    wire: np.ndarray        # [n_frames, frame_bytes] MAC frames (seq = index)
    payloads: np.ndarray    # [n_frames, payload] MAC payload bytes


def planted_stream(spec, total: int, seed: int, fill: float = 0.8,
                   snr_db: float = 26.0, cfo: float = 1e-4,
                   amplitude: float = 60.0) -> PlantedStream:
    """A continuous capture of ``total`` samples with MAC frames (seq 0..n-1)
    at random offsets: ``fill`` of the samples are frame samples, the rest
    are random noise-only gaps; CFO over the whole stream and AWGN at
    ``snr_db`` relative to the frame power.  Frames straddle any later
    buffer split of the stream.  Deterministic in ``seed``."""
    from ..mac.mac import Mac
    from ..models import tx as txm

    cfg = spec.cfg
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(seed)
    n_frames = int(fill * total / cfg.frame_len)
    payloads = rng.integers(0, 256, (n_frames, mac.payload), dtype=np.uint8)
    wire = mac.write(jnp.asarray(payloads),
                     jnp.arange(n_frames, dtype=jnp.uint32))
    frames = np.asarray(txm.transmit(spec, wire))
    # random gaps summing to the slack
    slack = total - n_frames * cfg.frame_len
    gaps = rng.multinomial(slack, np.ones(n_frames + 1) / (n_frames + 1))
    sig = np.zeros(total, dtype=np.complex64)
    starts = np.zeros(n_frames, dtype=np.int64)
    pos = 0
    for i in range(n_frames):
        pos += gaps[i]
        starts[i] = pos
        sig[pos:pos + cfg.frame_len] = frames[i]
        pos += cfg.frame_len
    n = np.arange(total)
    sig = sig * np.exp(2j * np.pi * cfo * n) * amplitude
    noise = (rng.standard_normal(total) + 1j * rng.standard_normal(total))
    sig = sig + noise * np.sqrt((np.abs(frames) ** 2).mean() * amplitude ** 2
                                * 10 ** (-snr_db / 10) / 2)
    return PlantedStream(sig.astype(np.complex64), starts, np.asarray(wire),
                         payloads)
