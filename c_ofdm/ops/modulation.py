"""Constellation mapping / demapping as vectorized JAX ops.

Reference semantics (`OFDM/modulation.cpp`): non-Gray square QAM with the real
index in the low half-bits and imaginary in the high half-bits
(`modulation.cpp:12-20`), diagonal BPSK at 5π/4 (`modulation.cpp:28-30`), and
hard decision by clamp + round to the grid (`modulation.cpp:53-87`).

New capability over the reference: max-log soft LLR output (`soft_llrs`).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from . import bits as bitops

MOD_BPSK, MOD_QAM4, MOD_QAM16, MOD_QAM64, MOD_QAM256 = 1, 2, 4, 6, 8


def constellation(mod_type: int) -> np.ndarray:
    """Lookup table indexed by symbol value (numpy; baked into jit as constant).

    QAM is peak-normalized (|corner| = 1, per-axis levels /sqrt(2)) to match
    the reference TX exactly — verified against `source.bin`'s message
    spectrum and `constell.bin`; see oracle.reference.constellation."""
    if mod_type == 1:
        return np.exp(1j * (np.pi * np.arange(2) + 5 * np.pi / 4))
    side = 1 << (mod_type // 2)
    idx = np.arange(1 << mod_type)
    re = 2.0 / (side - 1) * (idx % side) - 1.0
    im = 2.0 / (side - 1) * (idx >> (mod_type // 2)) - 1.0
    # componentwise division (NOT complex-by-scalar: numpy's complex divide
    # rounds differently for some entries) so the gather-free arithmetic
    # ``map_symbols`` is bit-identical to this LUT in float64
    return re / np.sqrt(2.0) + 1j * (im / np.sqrt(2.0))


def map_symbols(symbols: jnp.ndarray, mod_type: int, dtype=jnp.complex64) -> jnp.ndarray:
    """Symbol indices -> constellation points, gather-free.

    The square-QAM grid is reconstructed arithmetically with the SAME
    operation sequence as ``constellation`` — both divide the re/im
    components separately, so float64 results are bit-identical to the LUT
    for every mod_type (verified 1/2/4/6/8); float32 may differ by 1 ulp
    from a compute-in-f64-then-cast table.  The arithmetic form is pure
    elementwise work in place of a ``table[symbols]`` gather."""
    rdt = jnp.finfo(jnp.dtype(dtype)).dtype
    if mod_type == 1:
        tab = constellation(1)          # 2 points: a select, not a gather
        re = jnp.where(symbols == 0, np.asarray(tab[0].real, rdt),
                       np.asarray(tab[1].real, rdt))
        im = jnp.where(symbols == 0, np.asarray(tab[0].imag, rdt),
                       np.asarray(tab[1].imag, rdt))
        return (re + 1j * im).astype(dtype)
    side = 1 << (mod_type // 2)
    scale = 2.0 / (side - 1)
    re = scale * (symbols % side).astype(rdt) - 1.0
    im = scale * (symbols >> (mod_type // 2)).astype(rdt) - 1.0
    # divide the components separately: numpy's complex-by-real-scalar
    # division is componentwise, while JAX promotes the scalar to complex
    # and uses the full complex-division formula (~1 ulp apart for some
    # mod types) — componentwise keeps the f64 bit-identity to the LUT
    rt2 = np.asarray(np.sqrt(2.0), dtype=rdt)
    return ((re / rt2) + 1j * (im / rt2)).astype(dtype)


def map_bytes(data: jnp.ndarray, mod_type: int, dtype=jnp.complex64) -> jnp.ndarray:
    """uint8 [..., nbytes] -> points [..., nbytes*8/mod_type]."""
    return map_symbols(bitops.bytes_to_symbols(data, mod_type), mod_type, dtype)


def hard_demap(points: jnp.ndarray, mod_type: int) -> jnp.ndarray:
    """Constellation points -> symbol indices (int32): clamp + round on the
    peak-normalized grid (the true TX grid; see oracle.reference.hard_demod
    for why the reference's own unscaled-grid rounding is not replicated)."""
    if mod_type == 1:
        return (points.real + points.imag > 0).astype(jnp.int32)
    s = 1.0 / np.sqrt(2.0)
    side = 1 << (mod_type // 2)
    inv_step = (side - 1) / (2.0 * s)
    re = jnp.clip(points.real, -s, s)
    im = jnp.clip(points.imag, -s, s)
    ire = jnp.floor((re + s) * inv_step + 0.5).astype(jnp.int32)
    iim = jnp.floor((im + s) * inv_step + 0.5).astype(jnp.int32)
    return ire | (iim << (mod_type // 2))


def demap_bytes(points: jnp.ndarray, mod_type: int) -> jnp.ndarray:
    """points [..., nsym] -> uint8 [..., nsym*mod_type/8] via hard decision."""
    return bitops.symbols_to_bytes(hard_demap(points, mod_type), mod_type)


def soft_llrs(points: jnp.ndarray, mod_type: int, noise_var: float = 1.0) -> jnp.ndarray:
    """Max-log LLRs, [..., nsym, mod_type]; positive favors bit 0.

    Not present in the reference (hard-decision only); enables coded operation.
    """
    table = constellation(mod_type)
    nbits = mod_type
    idx = np.arange(table.size)
    # bit b of symbol index, MSB-first to match bytes_to_symbols ordering
    bit_of = ((idx[:, None] >> np.arange(nbits - 1, -1, -1)[None, :]) & 1)  # [S, nbits]
    tbl = jnp.asarray(table, dtype=points.dtype)
    d2 = jnp.abs(points[..., None] - tbl) ** 2  # [..., nsym, S]
    big = jnp.asarray(np.inf, dtype=d2.dtype)
    mask0 = jnp.asarray(bit_of == 0)  # [S, nbits]
    d0 = jnp.min(jnp.where(mask0.T, d2[..., None, :], big), axis=-1)  # [..., nsym, nbits]
    d1 = jnp.min(jnp.where(~mask0.T, d2[..., None, :], big), axis=-1)
    return (d1 - d0) / noise_var
