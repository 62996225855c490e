"""Bit <-> symbol repacking as pure vectorized JAX ops.

Vectorized replacement for the reference's serial ``bit_stream_converter``
(`OFDM/modulation.cpp:90-125`): MSB-first within each block, arbitrary symbol
widths (handles symbols straddling byte boundaries, e.g. QAM64's 6-bit symbols).
All shapes are static; the batch dimension is leading.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def unpack_bits(data: jnp.ndarray) -> jnp.ndarray:
    """uint8 [..., n] -> [..., n*8] bits, MSB first."""
    shifts = np.arange(7, -1, -1, dtype=np.uint8)
    bits = (data[..., None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """[..., n*8] bits -> uint8 [..., n], MSB first."""
    n = bits.shape[-1] // 8
    weights = (1 << np.arange(7, -1, -1)).astype(np.uint8)
    grouped = bits.reshape(*bits.shape[:-1], n, 8).astype(jnp.uint8)
    return (grouped * weights).sum(-1).astype(jnp.uint8)


def bytes_to_symbols(data: jnp.ndarray, bits_per_symbol: int) -> jnp.ndarray:
    """uint8 [..., nbytes] -> int32 [..., nbytes*8//bps] symbol indices, MSB first.

    Fast paths extract symbols with shifts directly on bytes/24-bit words
    (no x8 per-bit intermediate); the generic path falls back to bit
    expansion."""
    bps = bits_per_symbol
    lead = data.shape[:-1]
    if 8 % bps == 0:
        shifts = (np.arange(8 // bps - 1, -1, -1) * bps).astype(np.int32)
        s = (data[..., None].astype(jnp.int32) >> shifts) & ((1 << bps) - 1)
        return s.reshape(*lead, data.shape[-1] * (8 // bps))
    if bps == 6 and data.shape[-1] % 3 == 0:
        b = data.reshape(*lead, -1, 3).astype(jnp.int32)
        word = (b[..., 0] << 16) | (b[..., 1] << 8) | b[..., 2]
        s = jnp.stack([word >> 18, (word >> 12) & 63,
                       (word >> 6) & 63, word & 63], axis=-1)
        return s.reshape(*lead, data.shape[-1] * 8 // 6)
    bits = unpack_bits(data)
    nsym = bits.shape[-1] // bps
    grouped = bits[..., : nsym * bps].reshape(
        *bits.shape[:-1], nsym, bps).astype(jnp.int32)
    weights = (1 << np.arange(bps - 1, -1, -1)).astype(np.int32)
    return (grouped * weights).sum(-1)


def symbols_to_bytes(symbols: jnp.ndarray, bits_per_symbol: int) -> jnp.ndarray:
    """int [..., nsym] -> uint8 [..., nsym*bps//8], MSB first.

    Fast paths assemble bytes with shift-or on symbol groups (no x8 per-bit
    intermediate); the generic path falls back to bit packing."""
    bps = bits_per_symbol
    lead = symbols.shape[:-1]
    nsym = symbols.shape[-1]
    if 8 % bps == 0 and nsym % (8 // bps) == 0:
        g = 8 // bps
        grouped = symbols.reshape(*lead, nsym // g, g).astype(jnp.uint32)
        shifts = (np.arange(g - 1, -1, -1) * bps).astype(np.uint32)
        return (grouped << shifts).sum(-1).astype(jnp.uint8)
    if bps == 6 and nsym % 4 == 0:
        s = symbols.reshape(*lead, nsym // 4, 4).astype(jnp.uint32)
        word = (s[..., 0] << 18) | (s[..., 1] << 12) | (s[..., 2] << 6) | s[..., 3]
        b = jnp.stack([word >> 16, (word >> 8) & 0xFF, word & 0xFF], axis=-1)
        return b.reshape(*lead, nsym * 6 // 8).astype(jnp.uint8)
    shifts = np.arange(bps - 1, -1, -1, dtype=np.int32)
    bits = ((symbols[..., None] >> shifts) & 1)
    flat = bits.reshape(*symbols.shape[:-1], symbols.shape[-1] * bps)
    return pack_bits(flat)
