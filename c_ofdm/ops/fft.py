"""Batched FFT primitives for the OFDM chain.

Interchangeable backends (``FFT_BACKENDS``):

* ``xla`` — ``jnp.fft.fft/ifft`` (XLA's native FFT).
* ``matmul`` — explicit DFT-matrix contraction.  For the small transform sizes
  used here (256-4096) with large symbol batches, a dense matmul can beat the
  native FFT; it also enables *partial* DFTs (only the bins we need — see
  ``dft_rows``), which the sync detector exploits.
* ``ct`` — two-stage Cooley-Tukey matmuls (``ct_dft``) for wideband sizes.
* ``*_bf16`` — the matmul backends with bfloat16 operands.

Every float32 contraction of the chain passes ``PRECISION`` explicitly, so
the arithmetic the CPU tests and the float64 oracle validate is the one that
runs on an accelerator whose default f32 dot is reduced-precision (TF32).

Conventions match FFTW (reference `OFDM/Frame.cpp:16-24`): ``fft_fwd`` is the
unnormalized forward transform (== jnp.fft.fft); ``ifft_unnorm`` is the
unnormalized backward transform (== N * jnp.fft.ifft).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

# precision of every f32 dot_general in the chain (DFT matmuls, partial DFTs,
# t2 track, Toeplitz matched filter, window contractions, chain closure)
PRECISION = jax.lax.Precision.HIGHEST

FFT_BACKENDS = ("xla", "matmul", "matmul_bf16", "ct", "ct_bf16")


@functools.lru_cache(maxsize=32)
def _dft_matrix_np(n: int, sign: int) -> np.ndarray:
    k = np.arange(n)
    return np.exp(sign * 2j * np.pi * np.outer(k, k) / n)


def dft_rows(n: int, rows: np.ndarray, sign: int = -1) -> np.ndarray:
    """Selected rows of the (unnormalized) DFT matrix: [len(rows), n]."""
    k = np.arange(n)
    return np.exp(sign * 2j * np.pi * np.outer(np.asarray(rows), k) / n)


# above this element count a host DFT-basis constant would be embedded in the
# program as a literal (a 8192x4128 f32 pair is 270 MB) — build the basis on
# device instead, keeping constants out of the program's size.  Inside a
# fori_loop/scan the construction is loop-invariant and XLA hoists it, so it
# runs once.
DEVICE_BASIS_MIN_ELEMS = 1 << 23


def dft_basis(n: int, rows: np.ndarray, sign: int = -1, scale: float = 1.0,
              transpose: bool = False, rdt=None):
    """DFT-basis rows, host np.ndarray (small) or device (wr, wi) pair
    (large).  The device path computes the phase index r*k mod n exactly in
    int32 (no catastrophic f32 rounding of large products) before one
    cos/sin pass; ``complex_matmul`` accepts either form."""
    rows = np.asarray(rows)
    if n * rows.size < DEVICE_BASIS_MIN_ELEMS:
        w = dft_rows(n, rows, sign) * scale
        return w.T.copy() if transpose else w
    assert n <= 32768, "int32 phase index overflows past 32k-point DFT"
    rdt = rdt or jnp.float32
    r = jnp.asarray(rows % n, dtype=jnp.int32)
    k = jnp.arange(n, dtype=jnp.int32)
    ph = jnp.remainder(r[:, None] * k[None, :], n).astype(rdt)
    ang = ph * np.asarray(sign * 2 * np.pi / n, dtype=rdt)
    wr = jnp.cos(ang) * np.asarray(scale, dtype=rdt)
    wi = jnp.sin(ang) * np.asarray(scale, dtype=rdt)
    if transpose:
        wr, wi = wr.T, wi.T
    return wr, wi


def fft_fwd(x: jnp.ndarray, backend: str = "xla") -> jnp.ndarray:
    """Unnormalized forward FFT along the last axis."""
    if backend in ("matmul", "matmul_bf16"):
        return _matmul_dft(x, sign=-1, bf16=backend.endswith("bf16"))
    if backend in ("ct", "ct_bf16"):
        return ct_dft(x, sign=-1, bf16=backend.endswith("bf16"))
    return jnp.fft.fft(x)


def ifft_unnorm(x: jnp.ndarray, backend: str = "xla") -> jnp.ndarray:
    """Unnormalized backward FFT (FFTW convention) along the last axis."""
    if backend in ("matmul", "matmul_bf16"):
        return _matmul_dft(x, sign=+1, bf16=backend.endswith("bf16"))
    if backend in ("ct", "ct_bf16"):
        return ct_dft(x, sign=+1, bf16=backend.endswith("bf16"))
    return jnp.fft.ifft(x) * x.shape[-1]


def complex_matmul(x: jnp.ndarray, w, bf16: bool = False) -> jnp.ndarray:
    """x [..., k] @ w [k, m] for complex operands as 4 real matmuls.

    ``w`` is a host constant (DFT basis) or a device (wr, wi) pair from
    ``dft_basis``; ``bf16`` casts operands to bfloat16 with float32
    accumulation (~1e-3 relative error)."""
    rdt = jnp.finfo(x.real.dtype).dtype
    mdt = jnp.bfloat16 if bf16 else rdt
    if isinstance(w, tuple):
        wr = w[0].astype(mdt)
        wi = w[1].astype(mdt)
    else:
        wr = jnp.asarray(w.real, dtype=mdt)
        wi = jnp.asarray(w.imag, dtype=mdt)
    xr = x.real.astype(mdt)
    xi = x.imag.astype(mdt)
    dot = lambda a, b: jnp.dot(a, b, precision=PRECISION,  # noqa: E731
                               preferred_element_type=rdt)
    yr = dot(xr, wr) - dot(xi, wi)
    yi = dot(xr, wi) + dot(xi, wr)
    return jax_lax_complex(yr.astype(rdt), yi.astype(rdt))


def _matmul_dft(x: jnp.ndarray, sign: int, bf16: bool = False) -> jnp.ndarray:
    """Complex DFT as 4 real matmuls; preserves complex dtype.

    ``bf16``: operands in bfloat16 with float32 accumulation; per-bin relative error ~1e-3 after the N-term sum, comfortably
    inside the link's EVM budget for QAM16/64 (validated in tests).
    """
    return complex_matmul(x, _dft_matrix_np(x.shape[-1], sign), bf16)


def jax_lax_complex(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    return re + 1j * im


def _ct_factors(n: int) -> tuple:
    """Near-square power-of-two split n = N1 * N2, N1 <= N2."""
    a = n.bit_length() - 1
    if 1 << a != n:
        raise ValueError(f"ct backend needs a power-of-two size, got {n}")
    return 1 << (a // 2), 1 << (a - a // 2)


def ct_dft(x: jnp.ndarray, sign: int, bf16: bool = False) -> jnp.ndarray:
    """Two-stage Cooley-Tukey DFT as batched matmuls: the matmul-shaped
    middle ground between the wideband XLA FFT and the single-matmul DFT,
    whose FLOPs blow up 250x at 8k.

    n = N1*N2 (8192 = 64*128): with input index n = N2*n1 + n2 and output
    k = k1 + N1*k2,
        A[k1, n2]  = sum_{n1} x[N2 n1 + n2] W_{N1}^{n1 k1}      (matmul 1)
        B[k1, n2]  = A * W_N^{n2 k1}                            (twiddle)
        X[k1+N1 k2] = sum_{n2} B[k1, n2] W_{N2}^{n2 k2}         (matmul 2)
    FLOPs per transform: n*(N1 + N2) MACs vs n^2 for the flat DFT —
    45x fewer at 8k — in [*, 64/128]x[64/128, 64/128] matmul shapes.
    Exact (no approximation); bf16 variant casts matmul operands only.
    """
    n = x.shape[-1]
    n1, n2 = _ct_factors(n)
    lead = x.shape[:-1]
    w1 = _dft_matrix_np(n1, sign)                     # [n1, k1]
    w2 = _dft_matrix_np(n2, sign)                     # [n2, k2]
    j2 = np.arange(n2)
    k1 = np.arange(n1)
    tw = np.exp(sign * 2j * np.pi * np.outer(j2, k1) / n)   # [n2, k1]
    xv = x.reshape(*lead, n1, n2)
    a = complex_matmul(jnp.swapaxes(xv, -1, -2), w1, bf16)  # [..., n2, k1]
    b = a * jnp.asarray(tw, dtype=a.dtype)
    y = complex_matmul(jnp.swapaxes(b, -1, -2), w2, bf16)   # [..., k1, k2]
    # flatten with k2 major: k = N1*k2 + k1
    return jnp.swapaxes(y, -1, -2).reshape(*lead, n)


def partial_dft(x: jnp.ndarray, rows: np.ndarray, sign: int = -1) -> jnp.ndarray:
    """Project x[..., n] onto selected DFT bins: returns [..., len(rows)].

    Cost is O(n * len(rows)) as one skinny matmul instead of a full
    O(n log n) FFT — a large win when only a handful of bins matter
    (two-tone detection).  Large
    bases (wideband configs) are built on device via ``dft_basis``.
    """
    n = x.shape[-1]
    rdt = jnp.finfo(x.real.dtype).dtype
    w = dft_basis(n, rows, sign, transpose=True, rdt=rdt)  # [n, n_rows]
    if isinstance(w, tuple):
        wr, wi = w[0].astype(rdt), w[1].astype(rdt)
    else:
        wr = jnp.asarray(w.real, dtype=rdt)
        wi = jnp.asarray(w.imag, dtype=rdt)
    return complex_matmul(x, (wr, wi))
