"""Receive chain: capture IQ -> synchronized, corrected, demodulated bytes.

Mirrors the canonical demod recipe of `main.cpp:46-82` / `rx.cpp:158-221`:
t2sin coarse detect -> preamble fine timing -> coarse pilot CFO -> derotate ->
per-symbol CP CFO -> common phase -> linear-phase channel est -> batched FFT +
pilot equalization -> hard demap.

Everything after timing is batch-parallel over frames; sync produces positions
as traced scalars and frames are gathered with dynamic slices, keeping the
whole chain statically shaped and jittable.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import cfo, chanest, modulation, sync
from .frame import FrameSpec


class RxResult(NamedTuple):
    mac_bytes: jnp.ndarray       # uint8 [..., frame_bytes]
    constellation: jnp.ndarray   # [..., nsym*num_data_subc]
    chan_est: jnp.ndarray        # [..., num_data_subc]
    cfo: jnp.ndarray             # [...] coarse CFO estimate (cycles/sample)


def demod_sig(spec: FrameSpec, sig: jnp.ndarray,
              estimator: str = "lq") -> RxResult:
    """Demodulate the post-burst span [..., preamble_len + message_len]
    (preamble at offset 0) whose exact start is known.

    All preamble+message symbols go through ONE partial-DFT matmul
    (bins_transform), then pilot equalization runs per group — bit-identical
    to transforming the groups separately (the DFT is per-symbol), but a
    single larger matmul.
    """
    cfg = spec.cfg
    # fused recovery: algebraically identical to the sequential
    # pilot_freq_shift -> apply_freq_shift -> cp_freq_correct ->
    # common_phase_correct chain, in one rotation pass (ops/cfo.py)
    sig, shift = cfo.recover_fused(spec, sig)
    lead = sig.shape[:-1]
    nsym_all = cfg.num_pr_symb + cfg.num_symb
    syms = sig.reshape(*lead, nsym_all, cfg.ofdm_len)[..., cfg.cp_size:]
    pil, data = chanest.bins_transform(spec, syms)
    P = cfg.num_pr_symb
    pre_pts = chanest.pilot_equalize(spec, pil[..., :P, :], data[..., :P, :])
    const = chanest.pilot_equalize(spec, pil[..., P:, :], data[..., P:, :])
    chan = (chanest.chan_est_lq if estimator == "lq" else chanest.chan_est_full)(
        spec, pre_points=pre_pts)
    const = chanest.equalize(spec, const, chan)
    mac_bytes = modulation.demap_bytes(const, cfg.mod_type)
    return RxResult(mac_bytes, const, chan, shift)


def demod_frame(spec: FrameSpec, frame_sig: jnp.ndarray,
                estimator: str = "lq") -> RxResult:
    """Demodulate frames whose exact start is known.

    frame_sig [..., frame_len] with the t2sin burst at offset 0.
    """
    return demod_sig(spec, frame_sig[..., spec.cfg.t2sin_size:], estimator)


class SyncResult(NamedTuple):
    frame_start: jnp.ndarray   # [] start of the frame (t2sin burst) in the capture
    t2_begin: jnp.ndarray      # [] first detected t2 block (or -1)
    pr_begin: jnp.ndarray      # [] preamble position (+1 applied, reference quirk)
    found: jnp.ndarray         # [] bool


def synchronize(spec: FrameSpec, capture: jnp.ndarray,
                start: jnp.ndarray = 0) -> SyncResult:
    """Single-frame sync per `main.cpp:50-58`: coarse detect from ``start``,
    preamble search in the following sync window, +1 empirical offset —
    replaced by the actual local correlation peak when the config's
    ``peak_refine`` is in effect (raised thresholds; see
    `sync.first_above_peak` / ModemConfig.sync_peak_refine).
    capture [n] (vmap over leading dims for batches)."""
    t2_begin, t2_found = sync.find_t2sin(spec, capture, start)
    if spec.cfg.peak_refine:
        pr, pr_found = sync.find_preamble_peak(spec, capture,
                                               jnp.maximum(t2_begin, 0))
        pr_begin = jnp.where(pr_found, pr, pr + 1)  # not-found: -9 contract
    else:
        pr, pr_found = sync.find_preamble(spec, capture,
                                          jnp.maximum(t2_begin, 0))
        pr_begin = pr + 1
    found = jnp.logical_and(t2_found, pr_found)
    frame_start = jnp.where(found, pr_begin - spec.cfg.t2sin_size, 0)
    frame_start = jnp.maximum(frame_start, 0)
    return SyncResult(frame_start, t2_begin, pr_begin, found)


def extract_frame(spec: FrameSpec, capture: jnp.ndarray,
                  frame_start: jnp.ndarray) -> jnp.ndarray:
    """Gather one frame window [frame_len] starting at a traced position."""
    return jax.lax.dynamic_slice_in_dim(capture, frame_start, spec.cfg.frame_len)


def extract_sig(spec: FrameSpec, capture: jnp.ndarray,
                frame_start: jnp.ndarray) -> jnp.ndarray:
    """Gather the post-burst span [preamble_len + message_len] of the frame at
    a traced position — demod never reads the t2sin burst, so skip it."""
    cfg = spec.cfg
    return jax.lax.dynamic_slice_in_dim(
        capture, frame_start + cfg.t2sin_size,
        cfg.preamble_len + cfg.message_len)


def extract_sigs_rows(spec: FrameSpec, captures: jnp.ndarray,
                      frame_starts: jnp.ndarray) -> jnp.ndarray:
    """Batched extract_sig: captures [B, n], frame_starts [B] -> [B, sig]."""
    return jax.vmap(lambda c, s: extract_sig(spec, c, s))(
        captures, frame_starts)


def extract_sigs_ring(spec: FrameSpec, ring: jnp.ndarray,
                      frame_starts: jnp.ndarray) -> jnp.ndarray:
    """Streaming-ring gather with an optional channel axis:
    ring [n] + starts [K] -> [K, sig], or ring [C, n] + starts [C, K] ->
    [C, K, sig]."""
    if ring.ndim == 1:
        return jax.vmap(lambda s: extract_sig(spec, ring, s))(frame_starts)
    return jax.vmap(lambda r, s: jax.vmap(
        lambda ss: extract_sig(spec, r, ss))(s))(ring, frame_starts)


def receive_capture(spec: FrameSpec, capture: jnp.ndarray,
                    estimator: str = "lq"):
    """Full single-frame RX on one capture [n]: sync + demod.

    Returns (RxResult, SyncResult); RxResult fields are garbage when
    sync.found is False (mask downstream) — shapes stay static.
    """
    s = synchronize(spec, capture)
    sig = extract_sig(spec, capture, s.frame_start)
    return demod_sig(spec, sig, estimator), s


@functools.partial(jax.jit, static_argnums=(0, 2))
def receive_capture_jit(spec: FrameSpec, capture: jnp.ndarray,
                        estimator: str = "lq"):
    return receive_capture(spec, capture, estimator)


@functools.partial(jax.jit, static_argnums=(0, 2))
def receive_batch_jit(spec: FrameSpec, captures: jnp.ndarray,
                      estimator: str = "lq"):
    """Batched captures [B, n] -> vmapped single-frame RX."""
    return jax.vmap(lambda c: receive_capture(spec, c, estimator))(captures)


def receive_batch(spec: FrameSpec, captures: jnp.ndarray,
                  estimator: str = "lq"):
    """Batched single-frame RX with only the scalar sync under vmap; the
    frame gather and the whole demod chain run batch-native (larger fused
    kernels / matmuls than vmapping the full per-capture pipeline)."""
    s = jax.vmap(lambda c: synchronize(spec, c))(captures)
    sigs = extract_sigs_rows(spec, captures, s.frame_start)
    return demod_sig(spec, sigs, estimator), s


@functools.partial(jax.jit, static_argnums=(0, 2))
def demod_frames_jit(spec: FrameSpec, frames: jnp.ndarray,
                     estimator: str = "lq") -> RxResult:
    return demod_frame(spec, frames, estimator)
