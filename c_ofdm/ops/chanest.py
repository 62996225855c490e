"""Channel estimation and equalization.

Two estimators matching the reference's pair (`OFDM/Frame.hpp:375-434`):

* ``chan_est_lq``   — linear-phase least-squares fit over the unwrapped phase
  of the lower half-band (timing-offset equalizer; the reference's production
  choice, `main.cpp:66`).
* ``chan_est_full`` — mean per-subcarrier complex ratio (full channel).

Plus the OFDM symbol-level pilot equalization that lives in ``FFT_FORM::read``
(`OFDM/Frame.cpp:73-96`), exposed here as ``ofdm_demodulate``.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import fft as fftops


@functools.lru_cache(maxsize=16)
def _rx_partial_basis_np(fft_size: int, pilot_bins: tuple, data_bins: tuple):
    """DFT basis restricted to the bins the demodulator actually reads,
    pilot-major: [fft, P + D].  Same math as the full transform (zero bins
    contribute nothing); half the matmul FLOPs and no bin gathers."""
    rows = np.concatenate([np.asarray(pilot_bins), np.asarray(data_bins)])
    return fftops.dft_rows(fft_size, rows, sign=-1).T.copy()


def bins_transform(spec, time_syms: jnp.ndarray):
    """CP-stripped time symbols [..., nsym, fft] -> raw (pilot, data) bins
    ([..., nsym, P], [..., nsym, D]).

    On the matmul backends the transform is a *partial* DFT over only the
    pilot+data bins (the other bins are guard/DC nulls nobody reads) — exact
    same outputs, ~2x fewer matmul FLOPs, no gathers.
    """
    cfg = spec.cfg
    backend = getattr(spec, 'fft_backend', 'xla')
    P = cfg.num_pilot_subc
    if backend in ("matmul", "matmul_bf16"):
        nbins = P + cfg.num_data_subc
        if cfg.fft_size * nbins >= fftops.DEVICE_BASIS_MIN_ELEMS:
            # wideband: the basis is built on device (fft.dft_basis) —
            # keeps a constant this size out of the program
            rows = np.concatenate([np.asarray(spec.pilot_bins),
                                   np.asarray(spec.data_bins)])
            w = fftops.dft_basis(cfg.fft_size, rows, sign=-1, transpose=True,
                                 rdt=jnp.finfo(time_syms.real.dtype).dtype)
        else:
            w = _rx_partial_basis_np(cfg.fft_size, tuple(spec.pilot_bins),
                                     tuple(spec.data_bins))
        y = fftops.complex_matmul(time_syms, w, bf16=backend.endswith("bf16"))
        return y[..., :P], y[..., P:]
    freq = fftops.fft_fwd(time_syms, backend)
    if _structured(spec):
        # gather-free structured split (slices/reshapes only) in place of
        # an index gather over the bins
        return rx_split_bins(spec, freq)
    return (freq[..., jnp.asarray(spec.pilot_bins)],
            freq[..., jnp.asarray(spec.data_bins)])


def pilot_equalize(spec, pil: jnp.ndarray, data: jnp.ndarray) -> jnp.ndarray:
    """Pilot normalization + per-segment equalization of raw bins
    (`OFDM/Frame.cpp:73-96`): divide by mean |pilot| over ALL symbols of the
    group, then divide each segment by (its pilot / same pilot in symbol 0).
    """
    cfg = spec.cfg
    phys = jnp.abs(pil).mean(axis=(-1, -2)) / cfg.pilot_ampl  # [...]
    data = data / phys[..., None, None].astype(data.dtype)
    pil = pil / phys[..., None, None].astype(pil.dtype)
    coef = pil / pil[..., 0:1, :]                             # vs symbol 0
    lead = data.shape[:-2]
    nsym = data.shape[-2]
    data = data.reshape(*lead, nsym, cfg.num_pilot_subc, cfg.segment_size)
    data = data / coef[..., None]
    return data.reshape(*lead, nsym * cfg.num_data_subc)


def ofdm_demodulate(spec, time_syms: jnp.ndarray) -> jnp.ndarray:
    """CP-stripped time symbols [..., nsym, fft] -> equalized segment-order
    points [..., nsym*num_data_subc] (transform + pilot equalization)."""
    pil, data = bins_transform(spec, time_syms)
    return pilot_equalize(spec, pil, data)


def _tx_bin_maps(spec):
    """Gather-based frequency-bin construction (no scatter): each
    FFT bin reads from index ``src[bin]`` of [pilot_ampl, data..., 0]."""
    cfg = spec.cfg
    src = np.full(cfg.fft_size, 1 + cfg.num_data_subc, dtype=np.int32)  # zero slot
    src[spec.pilot_bins] = 0                                            # pilot slot
    src[spec.data_bins] = 1 + np.arange(cfg.num_data_subc, dtype=np.int32)
    return src


@functools.lru_cache(maxsize=16)
def _layout_is_structured(fft_size: int, seg: int, step: int, half: int,
                          pilot_bins: tuple, data_bins: tuple) -> bool:
    """True when (pilot_bins, data_bins) follow the canonical segment layout
    (`OFDM/Frame.cpp:31-44` semantics, oracle.subcarrier_maps): lower half =
    ``half`` repeats of [seg data | pilot] from bin 1, upper half = ``half``
    repeats of [pilot | seg data] ending at bin fft_size-1, guard between.
    Always true for specs built by make_frame_spec; checked so the
    structured (gather-free) TX/RX bin paths can never silently diverge."""
    p, d = [], []
    pos = 1 + seg
    for _ in range(half):
        p.append(pos)
        d.extend(range(pos - seg, pos))
        pos += step
    pos = fft_size - step * half
    for _ in range(half):
        p.append(pos)
        d.extend(range(pos + 1, pos + 1 + seg))
        pos += step
    return (tuple(p) == tuple(pilot_bins)
            and tuple(d) == tuple(data_bins))


def _structured(spec) -> bool:
    cfg = spec.cfg
    return _layout_is_structured(
        cfg.fft_size, cfg.segment_size, cfg.segment_step,
        cfg.num_pilot_subc // 2, tuple(int(b) for b in spec.pilot_bins),
        tuple(int(b) for b in spec.data_bins))


def tx_assemble_freq(spec, data: jnp.ndarray) -> jnp.ndarray:
    """Segment-order data points [..., nsym, D] -> full TX spectrum
    [..., nsym, fft_size] by pure reshape/concat (no gather).  Exactly
    equal to
    ``lookup[..., _tx_bin_maps(spec)]`` for the canonical layout."""
    cfg = spec.cfg
    lead = data.shape[:-1]
    half = cfg.num_pilot_subc // 2
    seg, step = cfg.segment_size, cfg.segment_step
    dt = data.dtype
    dl = data[..., :half * seg].reshape(*lead, half, seg)
    du = data[..., half * seg:].reshape(*lead, half, seg)
    pil = jnp.full((*lead, half, 1), cfg.pilot_ampl, dtype=dt)
    lower = jnp.concatenate([dl, pil], axis=-1).reshape(*lead, half * step)
    upper = jnp.concatenate([pil, du], axis=-1).reshape(*lead, half * step)
    guard = cfg.fft_size - 1 - 2 * half * step
    z1 = jnp.zeros((*lead, 1), dtype=dt)
    zg = jnp.zeros((*lead, guard), dtype=dt)
    return jnp.concatenate([z1, lower, zg, upper], axis=-1)


def rx_split_bins(spec, freq: jnp.ndarray):
    """Full spectrum [..., fft_size] -> (pilot [..., P], data [..., D] in
    segment order) by pure slicing/reshape — the gather-free inverse of
    ``tx_assemble_freq``."""
    cfg = spec.cfg
    lead = freq.shape[:-1]
    half = cfg.num_pilot_subc // 2
    seg, step = cfg.segment_size, cfg.segment_step
    lower = freq[..., 1:1 + half * step].reshape(*lead, half, step)
    upper = freq[..., cfg.fft_size - half * step:].reshape(*lead, half, step)
    pil = jnp.concatenate([lower[..., seg], upper[..., 0]], axis=-1)
    data = jnp.concatenate([lower[..., :seg].reshape(*lead, half * seg),
                            upper[..., 1:].reshape(*lead, half * seg)],
                           axis=-1)
    return pil, data


@functools.lru_cache(maxsize=16)
def _tx_partial_basis_np(fft_size: int, pilot_bins: tuple, data_bins: tuple,
                         pilot_ampl: float):
    """Inverse-DFT basis over only the data bins [D, fft] (1/sqrt(N)
    normalization folded in) plus the constant pilot-tone waveform [fft] —
    the TX spectrum is zero everywhere else, so the full IFFT is wasted
    FLOPs and the pilot contribution is data-independent."""
    w_data = fftops.dft_rows(fft_size, np.asarray(data_bins), sign=+1)
    w_pil = fftops.dft_rows(fft_size, np.asarray(pilot_bins), sign=+1)
    scale = 1.0 / np.sqrt(fft_size)
    return w_data * scale, pilot_ampl * scale * w_pil.sum(axis=0)


def ofdm_modulate(spec, points: jnp.ndarray, num_symb: int) -> jnp.ndarray:
    """Segment-order points [..., nsym*num_data_subc] -> time [..., nsym, ofdm_len]
    incl. CP (`OFDM/Frame.cpp:54-70,185-198`): pilots at pilot_ampl, backward
    FFT / sqrt(N), CP = copy of the symbol tail.

    Matmul backends synthesize time domain directly from the data points
    (partial inverse DFT + precomputed pilot waveform — the spectrum is zero
    outside pilot/data bins); the xla backend scatters bins via a gather map
    and runs the full IFFT."""
    cfg = spec.cfg
    lead = points.shape[:-1]
    backend = getattr(spec, 'fft_backend', 'xla')
    data = points.reshape(*lead, num_symb, cfg.num_data_subc)
    if backend in ("matmul", "matmul_bf16"):
        if cfg.fft_size * cfg.num_data_subc >= fftops.DEVICE_BASIS_MIN_ELEMS:
            # wideband: device-built inverse basis (see bins_transform); the
            # pilot waveform is tiny and stays a host constant
            scale = 1.0 / np.sqrt(cfg.fft_size)
            w = fftops.dft_basis(cfg.fft_size, np.asarray(spec.data_bins),
                                 sign=+1, scale=scale,
                                 rdt=jnp.finfo(data.real.dtype).dtype)
            pilot_time = (float(cfg.pilot_ampl) * scale *
                          fftops.dft_rows(cfg.fft_size,
                                          np.asarray(spec.pilot_bins),
                                          sign=+1).sum(axis=0))
        else:
            w, pilot_time = _tx_partial_basis_np(
                cfg.fft_size, tuple(spec.pilot_bins), tuple(spec.data_bins),
                float(cfg.pilot_ampl))
        time = fftops.complex_matmul(data, w, bf16=backend.endswith("bf16"))
        time = time + jnp.asarray(pilot_time, dtype=time.dtype)
    else:
        if _structured(spec):
            # gather-free structured spectrum assembly (see tx_assemble_freq)
            freq = tx_assemble_freq(spec, data)
        else:
            pilot = jnp.full((*lead, num_symb, 1), cfg.pilot_ampl,
                             dtype=points.dtype)
            zero = jnp.zeros((*lead, num_symb, 1), dtype=points.dtype)
            lookup = jnp.concatenate([pilot, data, zero], axis=-1)
            freq = lookup[..., jnp.asarray(_tx_bin_maps(spec))]
        time = fftops.ifft_unnorm(freq, backend) / np.sqrt(cfg.fft_size)
    return jnp.concatenate([time[..., -cfg.cp_size:], time], axis=-1)


def unwrap_one_step(phase: jnp.ndarray) -> jnp.ndarray:
    """The reference's non-accumulating unwrap (`OFDM/Frame.hpp:407-414`):
    each element shifted by at most ±2π relative to its corrected predecessor.
    Scans along the last axis; leading dims are vectorized lanes."""
    x = jnp.moveaxis(phase, -1, 0)

    def step(prev, cur):
        d = cur - prev
        cur = jnp.where(d > np.pi, cur - 2 * np.pi,
                        jnp.where(d < -np.pi, cur + 2 * np.pi, cur))
        return cur, cur

    _, out = jax.lax.scan(step, x[0], x[1:])
    out = jnp.concatenate([x[:1], out], axis=0)
    return jnp.moveaxis(out, 0, -1)


def unwrap_fast(phase: jnp.ndarray) -> jnp.ndarray:
    """Standard accumulating unwrap via diff+round+cumsum — fully parallel
    (no sequential 127-step scan).  Identical to ``unwrap_one_step`` whenever
    successive corrected differences stay within 3π, which holds for any
    physical timing offset this modem can sync to."""
    d = jnp.diff(phase, axis=-1)
    k = jnp.round(d / (2 * np.pi))
    corr = jnp.cumsum(k, axis=-1) * (2 * np.pi)
    return jnp.concatenate([phase[..., :1], phase[..., 1:] - corr], axis=-1)


def preamble_demod(spec, preamble_sig: jnp.ndarray) -> jnp.ndarray:
    """Demodulate the preamble span [..., preamble_len] into segment-order
    points [..., num_pr_symb*num_data_subc]."""
    cfg = spec.cfg
    lead = preamble_sig.shape[:-1]
    syms = preamble_sig.reshape(*lead, cfg.num_pr_symb, cfg.ofdm_len)[..., cfg.cp_size:]
    return ofdm_demodulate(spec, syms)


def chan_est_lq(spec, preamble_sig: jnp.ndarray = None,
                exact_unwrap: bool = False,
                pre_points: jnp.ndarray = None) -> jnp.ndarray:
    """Linear-phase LS estimate over the lower half-band, mirrored to the upper
    half (`OFDM/Frame.hpp:389-434`).  Reproduces the reference's exact fit
    formula (sums where a standard LS uses means).

    Multi-symbol preambles (num_pr_symb > 1): the reference fits the FIRST
    preamble symbol's lower half only (`Frame.hpp:402-405`: phase.size() =
    num_data_subc/2 over the flattened P*D points) — extra preamble symbols
    a config pays airtime for are simply discarded.  Here the complex ratio
    rx/ref is averaged across all P preamble symbols before the phase fit
    (~P-fold noise-power reduction on the fitted phases); at P=1 the mean is
    over one element and the arithmetic — hence golden/reference parity — is
    bit-identical.  The float64 oracle (`oracle.chan_est_lq`) keeps the
    reference's exact first-symbol semantics; `tests/test_preamble_multisym.py`
    pins both behaviors.

    preamble_sig [..., preamble_len] -> chan [..., num_data_subc]; callers may
    instead pass already-demodulated ``pre_points`` (shared-transform path)."""
    cfg = spec.cfg
    pr = pre_points if pre_points is not None else preamble_demod(
        spec, preamble_sig)
    mod_pre = jnp.asarray(spec.preamble_points, dtype=pr.dtype)
    half = cfg.num_data_subc // 2
    unwrap = unwrap_one_step if exact_unwrap else unwrap_fast
    lead = pr.shape[:-1]
    ratio = (pr / mod_pre).reshape(*lead, cfg.num_pr_symb,
                                   cfg.num_data_subc).mean(axis=-2)
    phase = unwrap(jnp.angle(ratio[..., :half]))
    i = jnp.asarray(np.arange(half), dtype=phase.dtype)
    sx, sxx = i.sum(), (i * i).sum()
    sy = phase.sum(-1)
    sxy = (phase * i).sum(-1)
    b = (sxy - sx * sy) / (sxx - sx * sx)
    a = sy - b * sx
    n = cfg.num_data_subc
    k = np.arange(n)
    karr = jnp.asarray(np.where(k < half, k, k - n) +
                       (0 if n == 2 * half else n - 2 * half), dtype=phase.dtype)
    ang = b[..., None] * karr + a[..., None]
    return jnp.exp(1j * ang.astype(phase.dtype)).astype(pr.dtype)


def chan_est_full(spec, preamble_sig: jnp.ndarray = None,
                  pre_points: jnp.ndarray = None) -> jnp.ndarray:
    """Mean per-subcarrier complex ratio (`OFDM/Frame.hpp:375-385`)."""
    cfg = spec.cfg
    pr = pre_points if pre_points is not None else preamble_demod(
        spec, preamble_sig)
    lead = pr.shape[:-1]
    mod_pre = jnp.asarray(spec.preamble_points, dtype=pr.dtype)
    ratio = (pr / mod_pre).reshape(*lead, cfg.num_pr_symb, cfg.num_data_subc)
    return ratio.mean(axis=-2)


def equalize(spec, points: jnp.ndarray, chan: jnp.ndarray) -> jnp.ndarray:
    """Divide message points [..., nsym*D] by the channel estimate [..., D]
    (`main.cpp:69-71`), as one reciprocal on D points + a broadcast multiply
    (instead of a tiled nsym*D complex divide)."""
    D = chan.shape[-1]
    nsym = points.shape[-1] // D
    lead = points.shape[:-1]
    inv = 1.0 / chan
    out = points.reshape(*lead, nsym, D) * inv[..., None, :]
    return out.reshape(*lead, nsym * D)
