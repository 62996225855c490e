"""Time synchronization: two-tone coarse detect + preamble matched filter.

The reference scans serially with early exit (`OFDM/Frame.hpp:150-197`,
`OFDM/Frame.cpp:338-378`).  Here dense tracks are computed in parallel —
elementwise and matmul work — and reduced with a masked argmax, which
reproduces the serial first-hit semantics exactly.

Key algorithmic reshape for the detector: the reference FFTs every 256-sample
block and sums masked-bin energy.  Only ``2*(2*smooth+1)`` bins ever carry mask
weight, so we project onto exactly those bins with a partial DFT (one skinny
matmul) and get total energy from Parseval in the time domain — ~10x less
compute than a full FFT per block, and all of it a matmul.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import fft as fftops


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(a, b, precision=fftops.PRECISION)


def _t2_masked_bins(spec):
    """Bins with nonzero detect-mask weight and their weights."""
    bins = np.nonzero(spec.t2_mask)[0]
    return bins, spec.t2_mask[bins]


def t2_ratio_track(spec, capture: jnp.ndarray, backend: str = "partial") -> jnp.ndarray:
    """Per-block masked/total energy ratio.  capture [..., n]; blocks are
    aligned to the start of the last axis.  Returns [..., n // t2sin_size].

    backend "partial": partial-DFT + Parseval (fast path).
    backend "fft":     full per-block FFT (bit-matches the reference track).
    """
    size = spec.cfg.t2sin_size
    n = capture.shape[-1]
    nblk = n // size
    blocks = capture[..., : nblk * size].reshape(*capture.shape[:-1], nblk, size)
    if backend == "fft":
        s = fftops.fft_fwd(blocks)
        e = jnp.abs(s) ** 2
        total = e.sum(-1)
        masked = (e * jnp.asarray(spec.t2_mask, dtype=e.dtype)).sum(-1)
    else:
        bins, weights = _t2_masked_bins(spec)
        s = fftops.partial_dft(blocks, bins)
        e = jnp.abs(s) ** 2
        masked = (e * jnp.asarray(weights, dtype=e.dtype)).sum(-1)
        # Parseval: sum_k |X_k|^2 == N * sum_n |x_n|^2 for the unnormalized DFT
        total = size * (jnp.abs(blocks) ** 2).sum(-1)
    ratio = jnp.where(total > 0, masked / jnp.maximum(total, 1e-30), 0.0)
    return ratio


def t2_ratio_track_hop(spec, capture: jnp.ndarray) -> jnp.ndarray:
    """Per-window masked/total energy ratio at 50% window overlap
    (hop = t2sin_size/2).  capture [..., n] -> [..., nwin], window w starts at
    sample w*hop.

    The block-aligned track (``t2_ratio_track``) can miss a burst whose start
    falls mid-block (the straddling windows each hold only part of it); with
    50% overlap some window always covers >= 3/4 of the burst, which keeps the
    ratio above a relaxed *gate* threshold at any alignment.

    Fused half-block formulation (one projection pass over the capture — 2x
    less matmul work than two shifted full-window tracks): project each
    HALF-block h onto the masked bins with the truncated ``t2sin_size``-point
    basis, A_h[b] = sum_{m<hop} x[h*hop+m] e^{-2 pi i b m / size}; the second
    half of window w contributes with the half-period phase
    e^{-i pi b} = (-1)^b, so S_w[b] = A_w[b] + (-1)^b A_{w+1}[b] exactly.
    Parseval totals come from per-half-block energies the same way.
    """
    size = spec.cfg.t2sin_size
    hop = size // 2
    n = capture.shape[-1]
    nh = n // hop
    halves = capture[..., : nh * hop].reshape(*capture.shape[:-1], nh, hop)
    bins, weights = _t2_masked_bins(spec)
    w = fftops.dft_rows(size, bins)[:, :hop].T       # [hop, nbins] truncated
    rdt = jnp.finfo(capture.real.dtype).dtype
    wr = jnp.asarray(w.real, dtype=rdt)
    wi = jnp.asarray(w.imag, dtype=rdt)
    xr, xi = halves.real, halves.imag
    ar = _mm(xr, wr) - _mm(xi, wi)
    ai = _mm(xr, wi) + _mm(xi, wr)                   # A_h [..., nh, nbins]
    sgn = jnp.asarray(np.where(bins % 2, -1.0, 1.0), dtype=rdt)
    sr = ar[..., :-1, :] + sgn * ar[..., 1:, :]
    si = ai[..., :-1, :] + sgn * ai[..., 1:, :]      # S_w [..., nh-1, nbins]
    e = sr * sr + si * si
    masked = (e * jnp.asarray(weights, dtype=e.dtype)).sum(-1)
    h = (xr * xr + xi * xi).sum(-1)                  # [..., nh]
    total = size * (h[..., :-1] + h[..., 1:])
    return jnp.where(total > 0, masked / jnp.maximum(total, 1e-30), 0.0)


def first_above(track: jnp.ndarray, level: float) -> tuple[jnp.ndarray, jnp.ndarray]:
    """First index along the last axis where track > level; (-1, False) if none.

    Replicates the serial early-exit semantics of the reference scans.
    """
    hit = track > level
    idx = jnp.argmax(hit, axis=-1)
    found = jnp.any(hit, axis=-1)
    return jnp.where(found, idx, -1), found


# near-peak sidelobe suppression margin: crossings below this fraction of
# the search window's best score are ignored in peak_refine mode (pilot-
# lattice sidelobes reach ~0.75x the true preamble peak at high pilot power
# fractions — round-4 deep-sweep find).  Shared by find_preamble_peak and
# streaming.gated_hits so single-frame and streaming sync accept the same
# crossings.
SIDELOBE_SUPPRESS = 0.85
# local refinement radius of first_above_peak (and the dense-path inline
# equivalent in streaming.extract_hits)
PEAK_REFINE_RADIUS = 2


def peak_radius(cfg) -> int:
    """Geometry-aware refinement radius: a band occupying 1/os of the FFT
    oversamples the time signal ~os-fold, widening the matched-filter
    correlation peak by the same factor -- the suppressed threshold
    crossing can then sit several lags before the true peak, and a fixed
    radius-2 refinement stops short (100-config deep-sweep find: a
    1/14-occupied QAM256 geometry synced 2 samples early, and the
    linear-phase-in-index channel estimator's pilot-jump phase sawtooth
    ate the corner margin).  At the stock geometry this returns the
    classic radius 2, preserving reference position parity."""
    occ = cfg.num_data_subc + cfg.num_pilot_subc + 2
    return max(PEAK_REFINE_RADIUS, round(cfg.fft_size / occ))


def suppress_sidelobes(track: jnp.ndarray) -> jnp.ndarray:
    """Zero every lag scoring below SIDELOBE_SUPPRESS x the window max."""
    tmax = track.max(axis=-1, keepdims=True)
    return jnp.where(track >= SIDELOBE_SUPPRESS * tmax, track, 0.0)


def _shift_left(t: jnp.ndarray, s: int) -> jnp.ndarray:
    if s == 0:
        return t
    pad = jnp.full((*t.shape[:-1], s), -jnp.inf, t.dtype)
    return jnp.concatenate([t[..., s:], pad], axis=-1)


def sliding_max(track: jnp.ndarray, radius: int) -> jnp.ndarray:
    """max over [i-radius, i+radius] along the last axis in O(n log radius):
    sparse-table doubling, then two overlapping power-of-two windows."""
    w = 2 * radius + 1
    lead = track.shape[:-1]
    padded = jnp.concatenate(
        [jnp.full((*lead, radius), -jnp.inf, track.dtype), track], axis=-1)
    k = max(w.bit_length() - 1, 0)          # largest 2^k <= w
    m = padded
    for j in range(k):
        m = jnp.maximum(m, _shift_left(m, 1 << j))
    m = jnp.maximum(m, _shift_left(m, w - (1 << k)))
    return m[..., :track.shape[-1]]


def suppress_sidelobes_local(track: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Windowed form of ``suppress_sidelobes`` for DENSE full-ring tracks:
    zero lags scoring below SIDELOBE_SUPPRESS x the local maximum within
    ``radius`` lags.  The gated path gets this per candidate region for
    free (each region spans one frame neighborhood); a dense track has no
    region structure, and a single global max would let one strong frame
    suppress a weaker frame's legitimate crossing.  Radius message_len
    covers every symbol-aligned pilot-lattice sidelobe of a frame (they
    trail the preamble peak by k*ofdm_len, k <= num_symb) while true
    neighboring peaks — always >= frame_len > message_len apart — never
    suppress each other."""
    return jnp.where(track >= SIDELOBE_SUPPRESS * sliding_max(track, radius),
                     track, 0.0)


def first_above_peak(track: jnp.ndarray, level: float,
                     radius: int = PEAK_REFINE_RADIUS):
    """First threshold crossing, refined to the local score peak within
    ``radius`` lags: returns (peak_idx, found), (-1, False) if none.

    The reference applies an empirical +1 to the crossing lag
    (`rx.cpp:158`, `main.cpp:53`), which calibrates out the fact that at
    the stock pr_level=0.5 the normalized matched filter crosses the
    threshold one lag BEFORE its peak (the peak is exact preamble
    alignment).  At higher thresholds — or high pilot-energy geometries —
    the crossing lands ON the peak, and a blind +1 then syncs one sample
    late: the symbol FFT windows lose cyclicity and QAM64+ frames take
    deterministic corner errors (found by the round-4 geometry sweep).
    Taking the argmax over [crossing, crossing+radius] returns the true
    peak in every regime.  Engaged per-config via ModemConfig.peak_refine
    (auto: pr_level > 0.55) — NOT at the stock threshold, where the
    committed OTA capture's peak sits at 11039 (score 0.68) while the
    reference's crossing+1 lands at 11040 (score 0.45): the reference
    decodes anyway because the linear-phase equalizer absorbs one sample,
    and keeping its exact position preserves artifact-level golden parity
    (constell.bin / phases.bin are tied to the 11040 window).
    """
    idx, found = first_above(track, level)
    return jnp.where(found, refine_to_peak(track, idx, radius), idx), found


def refine_to_peak(track: jnp.ndarray, idx: jnp.ndarray,
                   radius: int) -> jnp.ndarray:
    """argmax of ``track`` over lags [idx, idx+radius] (clipped) — the
    crossing-to-peak refinement shared by ``first_above_peak`` and the
    dense streaming path (``streaming.extract_hits``), so the two cannot
    drift apart.  idx broadcasts over leading dims; scalars work too."""
    c = jnp.maximum(idx, 0)
    n = track.shape[-1]
    vals = jnp.stack(
        [jnp.take_along_axis(track, jnp.clip(c + j, 0, n - 1)[..., None],
                             axis=-1)[..., 0]
         for j in range(radius + 1)], axis=-1)
    best = jnp.argmax(vals, axis=-1).astype(idx.dtype)
    return c + best


def find_t2sin(spec, capture: jnp.ndarray, start: jnp.ndarray = 0,
               backend: str = "partial"):
    """Sample index of the first detected block at/after ``start`` (blocks
    aligned to ``start``), or -1.  ``start`` may be a traced scalar; alignment
    is handled by rolling the capture so block boundaries land on ``start``.

    Matches `T2SIN_FORM::find_t2sin` (`OFDM/Frame.hpp:150-197`) including its
    trailing partial-block truncation.
    """
    size = spec.cfg.t2sin_size
    n = capture.shape[-1]
    if isinstance(start, int) and start == 0:
        shifted = capture          # common static case: no realignment copy
    else:
        shifted = jax_dynamic_window(capture, start, n)
    track = t2_ratio_track(spec, shifted, backend)
    nblk = track.shape[-1]
    # blocks that would run past the original end (wrapped samples) are invalid
    valid_blocks = (jnp.arange(nblk) + 1) * size <= (n - start)
    track = jnp.where(valid_blocks, track, 0.0)
    idx, found = first_above(track, spec.cfg.t2_sin_level)
    return jnp.where(found, idx * size + start, -1), found


def _next_pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(n)))


def _corr_fft(spec, x: jnp.ndarray, m: int) -> jnp.ndarray:
    """Circular correlation of x[..., m_or_less] with the matched filter via
    an m-point FFT pair: ifft(fft(x)*conj(fft(conj(mf)))) — the stored filter
    is already conjugated (Frame.cpp:285-294)."""
    L = spec.cfg.pr_sin_len
    mf_pad = np.zeros(m, dtype=np.complex128)
    mf_pad[:L] = spec.matched_filter
    mf_f = np.conj(np.fft.fft(np.conj(mf_pad)))
    xf = jnp.fft.fft(x, n=m)
    return jnp.fft.ifft(xf * jnp.asarray(mf_f, dtype=xf.dtype))


@functools.lru_cache(maxsize=16)
def _toeplitz_mf_np(mf_bytes: bytes, L: int):
    """Banded-Toeplitz correlation operator for one L-lag chunk, [2L, L]:
    T[i, l] = mf[i-l] for 0 <= i-l < L — (window @ T)[l] = sum_j w[l+j]*mf[j].
    Constant per filter; lives in device memory as a matmul operand."""
    mf = np.frombuffer(mf_bytes, dtype=np.complex128)
    T = np.zeros((2 * L, L), dtype=np.complex128)
    i = np.arange(2 * L)[:, None]
    lag = np.arange(L)[None, :]
    d = i - lag
    band = (d >= 0) & (d < L)
    T[band] = mf[d[band]]
    return T


def _corr_toeplitz(spec, x: jnp.ndarray) -> jnp.ndarray:
    """Correlation at every lag of x [..., n] via chunked banded-Toeplitz
    matmuls — the path for short sync windows, in place of batched small
    FFTs.  Lags are processed L at a time against a constant [2L, L] band
    (a single [n+L, n] Toeplitz matrix is ~85% structural zeros at these
    shapes — chunking cuts the matmul FLOPs ~(n/2L)x).
    The stored filter is already conjugated (Frame.cpp:285-294)."""
    n = x.shape[-1]
    L = spec.cfg.pr_sin_len
    mf = np.asarray(spec.matched_filter, dtype=np.complex128)
    T = _toeplitz_mf_np(mf.tobytes(), L)
    rdt = jnp.finfo(x.real.dtype).dtype
    wr = jnp.asarray(T.real, dtype=rdt)
    wi = jnp.asarray(T.imag, dtype=rdt)
    nchunks = -(-n // L)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, nchunks * L + L - n)]
    xp = jnp.pad(x, pad)
    win = jnp.stack([xp[..., c * L: c * L + 2 * L] for c in range(nchunks)],
                    axis=-2)                       # [..., nchunks, 2L]
    xr, xi = win.real, win.imag
    yr = _mm(xr, wr) - _mm(xi, wi)
    yi = _mm(xr, wi) + _mm(xi, wr)
    mag = jnp.sqrt(yr * yr + yi * yi)              # [..., nchunks, L]
    return mag.reshape(*x.shape[:-1], nchunks * L)[..., :n]


def matched_filter_scores(spec, x: jnp.ndarray) -> jnp.ndarray:
    """Normalized matched-filter score at every lag of x [..., n] -> [..., n].

    score[i] = |sum_j x[i+j] * mf[j]| / sqrt(sum_j |x[i+j]|^2) — the statistic
    of `PREAMBLE_FORM::find_preamble` (`OFDM/Frame.cpp:338-378`) — computed
    for all lags at once.  Short windows (the per-frame sync search) go
    through a constant banded-Toeplitz matmul; long captures go
    through frequency-domain overlap-save correlation.  Lags whose window
    energy is <= 1 or whose window runs past the end score 0.
    """
    n = x.shape[-1]
    L = spec.cfg.pr_sin_len
    m = _next_pow2(n + L)
    if n <= 2048:
        corr = _corr_toeplitz(spec, x)
    elif m <= 8192:
        corr = jnp.abs(_corr_fft(spec, x, m)[..., :n])
    else:
        # segmented overlap-save: batched 4096-pt chunk FFTs instead of one
        # giant FFT (the choice is re-measured in ROADMAP S4)
        C = 4096
        hop = C - L + 1
        nchunks = -(-n // hop)
        pad = [(0, 0)] * (x.ndim - 1) + [(0, nchunks * hop + L - n)]
        xp = jnp.pad(x, pad)
        idx = (np.arange(nchunks)[:, None] * hop + np.arange(C)[None, :])
        chunks = xp[..., idx]                      # [..., nchunks, C]
        cc = _corr_fft(spec, chunks, C)[..., :hop]  # valid lags per chunk
        corr = jnp.abs(cc.reshape(*x.shape[:-1], nchunks * hop)[..., :n])
    e = jnp.abs(x) ** 2
    zero = jnp.zeros((*x.shape[:-1], 1), e.dtype)
    ce = jnp.concatenate([zero, jnp.cumsum(e, axis=-1)], axis=-1)
    norm = ce[..., L:] - ce[..., : n + 1 - L]        # [..., n+1-L]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, L - 1)]
    norm = jnp.pad(norm, pad)[..., :n]
    return jnp.where(norm > 1.0,
                     corr / jnp.sqrt(jnp.maximum(norm, 1e-30)), 0.0)


def preamble_corr_track(spec, capture: jnp.ndarray, start: jnp.ndarray) -> jnp.ndarray:
    """Normalized matched-filter correlation at lags [start, start+sync_window).

    capture [..., n], start scalar (may be traced).  Positions whose window
    energy is <= 1 score 0 (`Frame.cpp:357-364`).

    ``start`` always comes from the block-aligned two-tone detector, so the
    window is taken gather-free via a one-hot block contraction.
    """
    L = spec.cfg.pr_sin_len
    W = spec.cfg.sync_window
    region = aligned_window(capture, start, W + L, spec.cfg.t2sin_size)
    # materialize the window before the matched filter: the Toeplitz MF
    # takes 7 overlapping slices of its input, and XLA re-derives the
    # one-hot window contraction inside EACH slice consumer instead of
    # computing it once.  The barrier is the identity; whether it still
    # pays on the GPU is left to a measurement (ROADMAP S2/S4).
    region = jax.lax.optimization_barrier(region)
    return matched_filter_scores(spec, region)[..., :W]


def aligned_window(x: jnp.ndarray, start: jnp.ndarray, length: int,
                   block: int) -> jnp.ndarray:
    """Window of ``length`` at a traced start that is a multiple of ``block``,
    with out-of-range reads zeroed — computed as a one-hot contraction over
    block rows instead of a dynamic slice (a handful of tiny contractions;
    whether this still beats the vmapped dynamic slice is ROADMAP D3).

    x [..., n]; start scalar broadcasting over leading dims.
    """
    n = x.shape[-1]
    kk = -(-length // block)            # window blocks
    nb = -(-n // block)                 # capture blocks
    pad = [(0, 0)] * (x.ndim - 1) + [(0, (nb + kk) * block - n)]
    xb = jnp.pad(x, pad).reshape(*x.shape[:-1], nb + kk, block)
    sb = jnp.clip(jnp.asarray(start, jnp.int32) // block, 0, nb - 1)
    sb = jnp.broadcast_to(sb, x.shape[:-1])
    rdt = jnp.finfo(x.real.dtype).dtype
    oh = (jnp.arange(nb, dtype=jnp.int32) == sb[..., None]).astype(rdt)
    sel = lambda a, j: jnp.einsum(  # noqa: E731  (real-valued contraction)
        '...n,...nc->...c', oh, a[..., j:j + nb, :],
        precision=fftops.PRECISION)
    xr, xi = xb.real, xb.imag
    parts = [(sel(xr, j) + 1j * sel(xi, j)).astype(x.dtype)
             for j in range(kk)]
    out = jnp.concatenate(parts, axis=-1)
    return out[..., :length]


def jax_dynamic_window(x: jnp.ndarray, start: jnp.ndarray, length: int) -> jnp.ndarray:
    """dynamic_slice along the last axis with out-of-range reads zeroed.

    Zero-pad by ``length`` then slice — one bounded dynamic_slice instead of a
    full-array roll/gather, preserving the reference's "window energy 0 past
    the buffer" behavior.
    """
    n = x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, length)]
    padded = jnp.pad(x, pad)
    start = jnp.clip(jnp.asarray(start, jnp.int32), 0, n)
    return jax.lax.dynamic_slice_in_dim(padded, start, length, axis=-1)


def dynamic_window(x: jnp.ndarray, start: jnp.ndarray, length: int,
                   block: int = 256) -> jnp.ndarray:
    """Window of ``length`` at an ARBITRARY traced start, gather-free.

    Decomposes start = block-aligned part + residual r (< block), then
    r = hi*16 + lo: the aligned part is a one-hot block contraction
    (``aligned_window``); each residual stage is a sum of 16 statically
    shifted slices weighted by a one-hot — XLA fuses the 16-term
    multiply-accumulate into one pass, in place of a vmapped
    dynamic_slice gather.  Out-of-range reads are zero
    (same semantics as ``jax_dynamic_window``).
    """
    assert block == 256, "fine-shift factorization assumes 16*16 residual"
    # clamp like lax.dynamic_slice: the window always fits inside x
    start = jnp.clip(jnp.asarray(start, jnp.int32), 0,
                     max(x.shape[-1] - length, 0))
    coarse = aligned_window(x, (start // block) * block, length + block, block)
    r = start % block
    rdt = jnp.finfo(x.real.dtype).dtype

    def shift16(y: jnp.ndarray, h: jnp.ndarray, step: int, out_len: int):
        # real one-hot weights: complex * real costs 2 real mults, not 6
        lead = y.shape[:-1]
        oh = (jnp.arange(16, dtype=jnp.int32)
              == jnp.broadcast_to(h, lead)[..., None]).astype(rdt)
        acc = oh[..., 0:1] * y[..., :out_len]
        for j in range(1, 16):
            acc = acc + oh[..., j:j + 1] * y[..., j * step: j * step + out_len]
        return acc

    mid = shift16(coarse, r // 16, 16, length + 16)
    return shift16(mid, r % 16, 1, length)


def find_preamble(spec, capture: jnp.ndarray, start: jnp.ndarray):
    """First lag over pr_level, or -10 (`PREAMBLE_FORM::find_preamble`,
    `OFDM/Frame.cpp:338-378`).  Returns (position, found)."""
    track = preamble_corr_track(spec, capture, start)
    idx, found = first_above(track, spec.cfg.pr_level)
    return jnp.where(found, idx + start, -10), found


def find_preamble_peak(spec, capture: jnp.ndarray, start: jnp.ndarray):
    """Like ``find_preamble`` but returns the local correlation PEAK at/after
    the first crossing (``first_above_peak``) — the production timing, equal
    to the reference's crossing+1 in its calibrated regime and one sample
    more accurate outside it.  Crossings below 85% of the window's best
    score are suppressed (pilot-lattice sidelobes reach ~0.75x the true
    peak at high pilot-power fractions — round-4 deep-sweep find).
    Returns (peak position, found); the caller must NOT re-apply the +1
    quirk."""
    track = preamble_corr_track(spec, capture, start)
    idx, found = first_above_peak(suppress_sidelobes(track),
                                  spec.cfg.pr_level,
                                  radius=peak_radius(spec.cfg))
    return jnp.where(found, idx + start, -10), found
