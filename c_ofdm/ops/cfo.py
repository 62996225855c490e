"""Carrier-frequency-offset and phase recovery, batch-vectorized.

Four estimators applied in the reference RX order (`main.cpp:60-63`):
coarse pilot CFO -> derotation -> per-symbol CP fine CFO -> common phase.

Shapes: ``sig`` is [..., n] with leading batch dims; all returns broadcast.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from . import fft as fftops


def _cfo_window_segments(spec):
    """[(lo, hi)) fftshifted-spectrum ranges actually searched for peaks."""
    borders = spec.cfo_borders
    return [(int(borders[i]), int(borders[i + 1]))
            for i in range(spec.cfg.num_pilot_subc + 1)
            if spec.cfo_window_mask[i]]


def pilot_freq_shift(spec, preamble_sig: jnp.ndarray) -> jnp.ndarray:
    """Coarse CFO from pilot peaks of the fftshifted preamble spectrum
    (`OFDM/Frame.hpp:285-337`).  preamble_sig [..., preamble_len] -> [...].

    Production backends project onto ONLY the bins the peak-search windows
    inspect (~half the spectrum) with a partial-DFT matmul: preamble_len is
    never a power of two (ofdm_len = fft + cp), so the full FFT would be a
    mixed-radix transform at e.g. 640 points.  The xla backend keeps the
    exact reference recipe for f64 golden parity.
    """
    size = spec.cfg.preamble_len
    segs = _cfo_window_segments(spec)
    # the ct backend keeps the XLA FFT here: preamble_len (fft+cp per symbol)
    # is never a power of two, and at wideband sizes the partial-DFT matmul
    # over ~size/2 inspected bins is an O(size^2) contraction per frame
    # where the FFT is O(size log size)
    if spec.fft_backend != "xla" and not spec.fft_backend.startswith("ct"):
        # fftshifted index j reads unshifted DFT bin (j + ceil(size/2)) % size
        shifted = np.concatenate([np.arange(lo, hi) for lo, hi in segs])
        rows = (shifted + (size + 1) // 2) % size
        amp = jnp.abs(fftops.partial_dft(preamble_sig[..., :size], rows))
        peaks = []
        off = 0
        for lo, hi in segs:
            peaks.append(lo + jnp.argmax(amp[..., off:off + (hi - lo)],
                                         axis=-1))
            off += hi - lo
    else:
        amp = jnp.abs(jnp.fft.fftshift(
            fftops.fft_fwd(preamble_sig[..., :size]), axes=-1))
        peaks = [lo + jnp.argmax(amp[..., lo:hi], axis=-1) for lo, hi in segs]

    pk = jnp.stack(peaks, axis=-1)                     # [..., n_windows]
    tol = spec.cfg.cfo_outlier_bins
    if tol > 0:
        # Robustification beyond the reference: at low SNR a single window's
        # argmax landing on a noise bin corrupts the MEAN estimate by up to
        # window_width/n_windows bins — enough to destroy the whole frame.
        # Replace any per-window offset deviating > tol bins from the median
        # offset with the median.  On clean signals the per-window offsets
        # agree within ~2 bins (window spacing truncation), so nothing is
        # rejected and the arithmetic — hence golden parity — is unchanged.
        lo_vec = jnp.asarray([lo for lo, _ in segs], dtype=pk.dtype)
        delta = pk - lo_vec
        med = jnp.sort(delta, axis=-1)[..., delta.shape[-1] // 2]
        keep = jnp.abs(delta - med[..., None]) <= tol
        pk = jnp.where(keep, pk, lo_vec + med[..., None])
    total = pk.sum(axis=-1)
    # reference divides by num_pilot_subc (== number of used windows)
    shift = total.astype(amp.dtype) / spec.cfg.num_pilot_subc
    return (shift - size / 2) / size


def apply_freq_shift(sig: jnp.ndarray, shift: jnp.ndarray) -> jnp.ndarray:
    """Derotate by e^{-2πi·shift·n} (`OFDM/Frame.hpp:340-348`).
    shift broadcasts over leading dims of sig [..., n]."""
    n = np.arange(sig.shape[-1])
    ang = -2 * np.pi * shift[..., None] * jnp.asarray(n, dtype=sig.real.dtype)
    return sig * jnp.exp(1j * ang.astype(sig.real.dtype)).astype(sig.dtype)


def cp_freq_correct(spec, sig: jnp.ndarray) -> jnp.ndarray:
    """Per-symbol fine CFO from CP<->tail correlation with cross-symbol phase
    accumulation (`OFDM/Frame.hpp:238-263`).

    The reference's serial loop is algebraically parallel: the accumulated
    scalar shift cancels inside each symbol's conj product, so all symbol
    phases are estimated independently and the applied ramp is a cumsum.
    sig [..., nsym*ofdm_len].
    """
    ol, fft, cp = spec.cfg.ofdm_len, spec.cfg.fft_size, spec.cfg.cp_size
    lead = sig.shape[:-1]
    nsym = sig.shape[-1] // ol
    sym = sig.reshape(*lead, nsym, ol)
    ph = jnp.angle((jnp.conj(sym[..., :cp]) * sym[..., fft:]).sum(-1))
    theta = ph / fft                                         # [..., nsym]
    acc = jnp.cumsum(theta * ol, axis=-1) - theta * ol       # exclusive cumsum
    j = jnp.asarray(np.arange(ol), dtype=ph.dtype)
    ang = -(acc[..., None] + theta[..., None] * j)
    corr = jnp.exp(1j * ang.astype(sym.real.dtype)).astype(sym.dtype)
    return (sym * corr).reshape(*lead, nsym * ol)


def _pow_ladder(u: jnp.ndarray, m: int) -> jnp.ndarray:
    """Powers u^0..u^{m-1} along a new trailing axis, built by log2(m)
    doublings (vector multiplies only — no per-element transcendentals)."""
    w = jnp.ones_like(u)[..., None]
    p = u[..., None]
    size = 1
    while size < m:
        w = jnp.concatenate([w, w * p], axis=-1)
        p = p * p
        size *= 2
    return w[..., :m]


def phase_ramp(shift: jnp.ndarray, theta: jnp.ndarray, acc: jnp.ndarray,
               nsym: int, ol: int, dtype) -> jnp.ndarray:
    """exp(-i(2π·shift·(s·ol+j) + acc_s + theta_s·j)) as [..., nsym, ol].

    The angle is linear in j within each symbol, so each symbol's rotation is
    a geometric sequence head_s·u_s^j: u_s^j is built from ~log2(ol) vector
    doublings and one outer product (j = 16h + l), replacing ol sincos
    evaluations per symbol with 2.
    """
    rdt = jnp.finfo(jnp.empty((), dtype).real.dtype).dtype
    two_pi = 2 * np.pi
    s_idx = jnp.asarray(np.arange(nsym), dtype=rdt)
    A = (two_pi * ol) * shift[..., None].astype(rdt) * s_idx + acc.astype(rdt)
    B = two_pi * shift[..., None].astype(rdt) + theta.astype(rdt)
    u = jnp.exp(-1j * B).astype(dtype)                   # [..., nsym]
    head = jnp.exp(-1j * A).astype(dtype)                # [..., nsym]
    if ol % 16 == 0:
        lo = _pow_ladder(u, 16)                          # [..., nsym, 16]
        hi = _pow_ladder(lo[..., -1] * u, ol // 16)      # [..., nsym, ol/16]
        ramp = (head[..., None] * hi)[..., None] * lo[..., None, :]
        return ramp.reshape(*u.shape, ol)
    return head[..., None] * _pow_ladder(u, ol)


def recover_fused(spec, sig: jnp.ndarray):
    """All four recovery stages in one pass: coarse pilot CFO + per-symbol CP
    CFO + common phase, applied as a SINGLE complex rotation.

    Algebraically identical to the sequential reference chain
    (`main.cpp:60-63`): the CP phase of a derotated symbol equals the raw CP
    phase rotated by e^{-2πi·f·fft} (the conj product shifts by a constant
    under derotation), and scalar phases cancel inside conj products — so all
    estimates can be made from the raw signal and composed into one per-sample
    angle.  Replaces three full-signal transcendental+memory passes with one.

    Returns (corrected_sig, coarse_shift).
    """
    cfg = spec.cfg
    ol, fft, cp = cfg.ofdm_len, cfg.fft_size, cfg.cp_size
    lead = sig.shape[:-1]
    n = sig.shape[-1]
    nsym = n // ol
    rdt = sig.real.dtype

    shift = pilot_freq_shift(spec, sig)                      # [...]
    sym = sig.reshape(*lead, nsym, ol)
    raw = (jnp.conj(sym[..., :cp]) * sym[..., fft:]).sum(-1)  # [..., nsym]
    # derotation adds a constant -2π·shift·fft to each CP-product's phase
    off = (-2 * np.pi * fft) * shift
    rot = jnp.exp(1j * off.astype(rdt))[..., None].astype(sig.dtype)
    theta = jnp.angle(raw * rot) / fft                       # [..., nsym]
    acc = jnp.cumsum(theta * ol, axis=-1) - theta * ol       # exclusive
    corr = phase_ramp(shift, theta, acc, nsym, ol,
                      sig.dtype).reshape(*lead, n)
    # common phase vs the known preamble, measured on the corrected prefix
    pre = jnp.asarray(np.conj(spec.preamble_time), dtype=sig.dtype)
    L = pre.shape[0]
    p = jnp.angle((pre * sig[..., :L] * corr[..., :L]).sum(-1))
    scalar = jnp.exp(-1j * p.astype(rdt)).astype(sig.dtype)
    return sig * corr * scalar[..., None], shift


def common_phase_correct(spec, sig: jnp.ndarray) -> jnp.ndarray:
    """Common phase vs the known preamble (`OFDM/Frame.hpp:265-274`).
    sig [..., n] with the preamble at the front."""
    pre = jnp.asarray(np.conj(spec.preamble_time), dtype=sig.dtype)
    L = pre.shape[0]
    phase = jnp.angle((pre * sig[..., :L]).sum(-1))
    rot = jnp.exp(-1j * phase.astype(sig.real.dtype)).astype(sig.dtype)
    return sig * rot[..., None]
