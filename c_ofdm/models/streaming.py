"""Streaming receiver: continuous capture -> stream of decoded frames.

Reference counterpart: the real-time RX loop (`rx.cpp:94-237`) — a serial
pointer walk over a 41-frame ring with carry-over memcpy and early-exit scans.
This formulation keeps its *semantics* (one-frame overlap-save carry, each
frame decoded exactly once, in order) but restructures the work.  Production
path (``sync_mode="gated"``):

1. overlapping-window two-tone energy track over the whole ring (skinny
   partial-DFT matmuls), gating ~41 candidate regions — the reference's
   cheap-detect-then-correlate order (`rx.cpp:133,158`);
2. banded-Toeplitz matmul matched filter over each candidate's ~768 lags, the
   advance rule (next preamble at least ``message_len`` past the previous,
   `rx.cpp:198`) as a scalar scan, cumsum-rank compaction into fixed slots;
3. gather up to ``max_frames`` frame windows (vmapped dynamic slices),
   batch-demod them in one fused pipeline, mask the invalid tail.

The dense fallback (``sync_mode="dense"``) instead matched-filters every ring
lag and walks hits with a fixed-trip ``fori_loop`` (``extract_hits``) —
detector-independent, kept for parity testing.

Everything is batch-first: blocks and state may carry a leading [C] axis for
C independent channel streams demodulated in one fused step per buffer.

State between calls is a small pytree: the carry-over halo (one frame length,
`rx.cpp:147-156`) plus scalar cursors — exactly the resumable state the
reference keeps implicitly in ``pos``/ring/counters (`rx.cpp:69,114-124`).
This same structure is what shards over a {channel, time} mesh (parallel/).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import fft as fftops
from ..ops import sync
from .frame import FrameSpec
from . import rx as rxm


class StreamState(NamedTuple):
    carry: jnp.ndarray        # [frame_len, 2] re/im f32 tail of the previous
    #                           ring, in the interleaved layout of the SDR
    #                           wire format (a complex carry is ROADMAP D4)
    carry_valid: jnp.ndarray  # [] bool — false on the very first buffer
    next_min_pos: jnp.ndarray  # [] int32 — first admissible preamble lag in the
    #                              new ring (suppresses re-detecting carried frames)
    frames_seen: jnp.ndarray  # [] int32 running count of decoded frames


class StreamOut(NamedTuple):
    # all fields gain a leading [C] axis under multi-channel operation
    mac_bytes: jnp.ndarray    # [max_frames, frame_bytes] uint8
    diag: jnp.ndarray         # [max_frames, nsym*ndata] re+im soft metric
    positions: jnp.ndarray    # [max_frames] preamble positions in this ring
    valid: jnp.ndarray        # [max_frames] bool
    num_found: jnp.ndarray    # [] int32
    cfo: jnp.ndarray          # [max_frames]


def init_state(spec: FrameSpec, dtype=None, channels: int = 0) -> StreamState:
    """``channels`` 0 = a single stream (scalar state); C > 0 = C independent
    channel streams processed batch-first per buffer (leading axis [C] on
    every state field and on the blocks fed to ``process_buffer``)."""
    rdt = jnp.finfo(jnp.dtype(dtype or spec.dtype)).dtype
    lead = (channels,) if channels else ()
    return StreamState(
        carry=jnp.zeros((*lead, spec.cfg.frame_len, 2), dtype=rdt),
        carry_valid=jnp.zeros(lead, dtype=bool),
        next_min_pos=jnp.zeros(lead, dtype=jnp.int32),
        frames_seen=jnp.zeros(lead, dtype=jnp.int32),
    )


def dense_preamble_corr(spec: FrameSpec, ring: jnp.ndarray) -> jnp.ndarray:
    """Normalized matched-filter score at every lag of ``ring`` [..., n]
    (see ops.sync.matched_filter_scores)."""
    return sync.matched_filter_scores(spec, ring)


def extract_hits(spec: FrameSpec, score: jnp.ndarray, min_pos: jnp.ndarray,
                 max_frames: int):
    """Greedy first-hit walk: repeatedly take the first lag over pr_level at or
    after the cursor, then advance the cursor by ``message_len``
    (`rx.cpp:158-198` advance rule).  Returns (positions [max_frames],
    valid [max_frames]).  Positions carry the reference's +1 quirk
    (`main.cpp:53`, `rx.cpp:158`), or the local correlation peak when the
    config's ``peak_refine`` is in effect (raised thresholds — see
    sync.first_above_peak)."""
    n = score.shape[-1]
    lags = jnp.arange(n, dtype=jnp.int32)
    refine = spec.cfg.peak_refine
    if refine:
        # match the gated path's sidelobe handling (it suppresses per
        # candidate region): zero sub-peak crossings against the LOCAL
        # window max, so a pilot-lattice sidelobe crossing pr_level inside
        # a data span cannot become a first-hit — windowed, because one
        # strong frame's peak must not suppress a weaker frame's crossing
        # (sync.suppress_sidelobes_local)
        score = sync.suppress_sidelobes_local(score, spec.cfg.message_len)
    hit = score > spec.cfg.pr_level
    # a decodable hit needs a full frame window in the ring:
    # frame spans [p+1-t2sin, p+1-t2sin+frame_len)
    last_ok = n - spec.cfg.frame_len + spec.cfg.t2sin_size - 1
    hit = jnp.logical_and(hit, lags <= last_ok)
    # scores for the peak refinement: decodable lags only, so the refined
    # position can never step past last_ok
    score_ok = jnp.where(lags <= last_ok, score, 0.0)

    def body(k, carry):
        cursor, pos_arr, val_arr = carry
        cand = jnp.logical_and(hit, lags >= cursor)
        idx = jnp.argmax(cand)
        found = jnp.any(cand)
        if refine:
            # crossing -> local peak (shared sync.refine_to_peak; same
            # radius so dense-vs-gated refinement cannot drift apart)
            peak = sync.refine_to_peak(score_ok, idx.astype(jnp.int32),
                                       sync.peak_radius(spec.cfg))
            pos = jnp.where(found, peak, -1).astype(jnp.int32)
        else:
            pos = jnp.where(found, idx + 1, -1).astype(jnp.int32)  # +1 quirk
        new_cursor = jnp.where(found, pos + spec.cfg.message_len, n).astype(jnp.int32)
        pos_arr = pos_arr.at[k].set(pos)
        val_arr = val_arr.at[k].set(found)
        return new_cursor, pos_arr, val_arr

    cursor0 = jnp.maximum(min_pos.astype(jnp.int32), 0)
    init = (cursor0,
            jnp.full((max_frames,), -1, dtype=jnp.int32),
            jnp.zeros((max_frames,), dtype=bool))
    _, positions, valid = jax.lax.fori_loop(0, max_frames, body, init)
    return positions, valid


def gated_hits(spec: FrameSpec, ring: jnp.ndarray, min_pos: jnp.ndarray,
               max_frames: int):
    """Two-tone-gated sync: the reference's cheap-detect-then-correlate order
    (`rx.cpp:133,158`), reshaped as batched dense work.

    1. overlapping-window t2 energy-ratio track over the whole ring (fused
       half-block partial-DFT matmul — ~22 bins per 128-sample hop);
    2. hot local maxima of the track become frame candidates, the strongest
       K kept (lax.top_k) and re-sorted by position — a real burst scores
       ~0.9 on the track while OFDM-data/pilot leakage into the masked bins
       peaks far lower, so candidate flooding near a relaxed gate level
       degrades gracefully (weak spurious peaks lose slots first) instead of
       positionally evicting real frames;
    3. each candidate gathers a ~G+L-sample search region (starts are
       hop-aligned: a one-hot block contraction) and runs the
       banded-Toeplitz matmul matched filter over
       G = cfg.gated_search_lags lags — the burst start lies within
       +-t2sin_size of the peak window, so the preamble lag lies within
       [t2sin_size, 2*t2sin_size] of the region start (G covers that plus a
       hop + pr_sin_len margin; = 768 at the reference geometry);
    4. the reference advance rule (next frame at least message_len past the
       previous, `rx.cpp:198`) is enforced as an exact parallel chain
       closure — one-hot successor matrix + log2(K) boolean matrix
       squarings — replacing a sequential K-step lax.scan; a searchsorted
       then compacts accepted hits into the output slots.

    vs the dense path (`extract_hits`): ~50x less matched-filter work
    (~49 x 768 lags instead of all 252k) and no serial full-ring argmax loop.
    Detection semantics match the reference MORE closely than the dense path:
    a frame whose burst the detector misses is skipped (as the reference
    would), instead of being rescued by its preamble correlation alone.

    Returns (positions [max_frames], valid [max_frames]), positions with
    the reference's +1 quirk (or the local peak under ``peak_refine``) —
    the same contract as ``extract_hits``.
    """
    cfg = spec.cfg
    lead = ring.shape[:-1]            # () or [C] — channel-batched rings
    n = ring.shape[-1]
    hop = cfg.t2sin_size // 2
    L = cfg.pr_sin_len
    G = cfg.gated_search_lags    # searched lags per candidate (see docstring)
    K = max_frames + cfg.t2_gate_slack  # candidate slack for spurious edges

    def first_ge(rank, targets):
        # first index along the last axis where the nondecreasing ``rank``
        # reaches each target (== count of entries below it) — the batch-
        # friendly searchsorted
        return (rank[..., None, :] < targets[..., :, None]).sum(-1)

    track = sync.t2_ratio_track_hop(spec, ring)            # [..., nwin]
    hot = track > cfg.t2_gate_level
    lo = jnp.full((*lead, 1), -jnp.inf, track.dtype)
    prev = jnp.concatenate([lo, track[..., :-1]], axis=-1)
    nxt = jnp.concatenate([track[..., 1:], lo], axis=-1)
    peak = jnp.logical_and(hot, jnp.logical_and(track >= prev, track > nxt))
    vals = jnp.where(peak, track, -1.0)
    _, cand_idx = jax.lax.top_k(vals, K)                   # strongest K peaks
    cand_w = jnp.sort(cand_idx, axis=-1)                   # position order
    cand_valid = jnp.take_along_axis(vals, cand_w, axis=-1) > 0.0
    cand_w = jnp.where(cand_valid, cand_w, 0)
    start = jnp.maximum(cand_w * hop - hop, 0)             # [..., K], aligned

    # gather the K candidate search regions (one-hot block contractions —
    # starts are hop-aligned).  Out-of-range reads at the ring tail are
    # zero; any lag past last_ok is masked below before first_above.
    win = G + L
    regions = jax.vmap(lambda s: sync.aligned_window(
        ring, s, win, hop), in_axes=-1, out_axes=-2)(start)  # [..., K, G+L]
    # materialize before the MF's overlapping Toeplitz slices (same XLA
    # window-recompute pathology as preamble_corr_track)
    regions = jax.lax.optimization_barrier(regions)
    scores = sync.matched_filter_scores(spec, regions)[..., :G]

    lags = start[..., None] + jnp.arange(G, dtype=jnp.int32)
    last_ok = n - cfg.frame_len + cfg.t2sin_size - 1
    min_lag = jnp.maximum(jnp.asarray(min_pos, jnp.int32), 0)
    ok_lag = jnp.logical_and(lags >= min_lag[..., None, None],
                             lags <= last_ok)
    scores = jnp.where(jnp.logical_and(ok_lag, cand_valid[..., None]),
                       scores, 0.0)
    if cfg.peak_refine:
        # crossing refined to the local score peak (sync.first_above_peak):
        # the true alignment when a raised threshold makes the crossing
        # land ON the peak (round-4 geometry-sweep find).  Sub-peak
        # crossings are suppressed first (sync.suppress_sidelobes — the
        # pilot lattice throws sidelobes inside the candidate region);
        # among near-peak lags the EARLIEST still wins, so a region
        # accidentally covering two frames prefers its own.
        rel, found = sync.first_above_peak(sync.suppress_sidelobes(scores),
                                           cfg.pr_level,
                                           radius=sync.peak_radius(cfg))
        pr = jnp.where(found, start + rel, -1).astype(jnp.int32)
    else:
        rel, found = sync.first_above(scores, cfg.pr_level)
        pr = jnp.where(found, start + rel + 1, -1).astype(jnp.int32)  # +1 quirk

    # reference advance rule (next accepted preamble at least message_len
    # past the previous, rx.cpp:198) over the position-ordered candidates.
    # The greedy accept set is exactly the chain i0 -> nxt(i0) -> ... where
    # nxt(i) is the first later candidate with found and p >= p_i + M.  The
    # chain is closed in parallel instead of by a K-step sequential scan:
    # one-hot successor matrix, then ceil(log2 K) boolean matrix squarings
    # (tiny [K, K] matmuls, exact on 0/1 values at the pinned precision).
    idx = jnp.arange(K, dtype=jnp.int32)
    later = idx[None, :] > idx[:, None]
    adm = pr[..., None, :] >= pr[..., :, None] + cfg.message_len
    succ = jnp.logical_and(found[..., None, :],
                           jnp.logical_and(later, adm))    # [..., K, K]
    nxt1 = jnp.logical_and(succ, jnp.cumsum(succ, -1) == 1)  # first True/row
    rdt = jnp.float32
    A = (nxt1.astype(rdt)
         + jnp.eye(K, dtype=rdt))                          # step-or-stay
    for _ in range(max(1, (K - 1).bit_length())):
        A = jnp.minimum(jnp.einsum('...ij,...jk->...ik', A, A,
                                   precision=fftops.PRECISION), 1.0)
    start_ok = jnp.logical_and(found, pr >= min_lag[..., None])
    i0 = jnp.logical_and(start_ok, jnp.cumsum(start_ok, -1) == 1)
    accept = jnp.einsum('...i,...ik->...k', i0.astype(rdt), A,
                        precision=fftops.PRECISION) > 0.5

    arank = jnp.cumsum(accept.astype(jnp.int32), axis=-1)
    slot = first_ge(arank, jnp.broadcast_to(
        jnp.arange(1, max_frames + 1, dtype=jnp.int32), (*lead, max_frames)))
    svalid = slot < K
    slot = jnp.where(svalid, slot, 0)
    positions = jnp.where(svalid, jnp.take_along_axis(pr, slot, axis=-1),
                          -1).astype(jnp.int32)
    return positions, svalid


@functools.partial(jax.jit, static_argnums=(0, 3, 4))
def process_buffer(spec: FrameSpec, state: StreamState, block: jnp.ndarray,
                   max_frames: int = 0, sync_mode: str = "gated"):
    """Consume one ingest buffer of IQ; return (new_state, StreamOut) with up
    to ``max_frames`` decoded frames.

    ``block`` is [..., rx_buf_size * frame_len] complex or [..., n, 2]
    interleaved re/im floats or int16 (the SDR wire formats); an optional
    leading axis carries
    independent channel streams, processed batch-first in one fused step
    (state fields then carry the same leading axis — see ``init_state``).

    The ring is [carry | block] (`rx.cpp:73-91` double-buffer update with the
    one-frame carry in front).  ``sync_mode`` "gated" (default, production)
    gates the matched filter on the two-tone track like the reference;
    "dense" correlates every ring lag (detector-independent fallback,
    single-channel only).
    """
    cfg = spec.cfg
    max_frames = max_frames or (cfg.rx_buf_size + 1)
    if not jnp.issubdtype(block.dtype, jnp.complexfloating):
        if jnp.issubdtype(block.dtype, jnp.integer):
            # raw SDR wire samples (int16 IQ, config ``mult`` staging
            # scale): convert on device — staging integers halves the
            # host->device bytes
            rdt = jnp.finfo(spec.dtype).dtype
            block = block.astype(rdt) / cfg.mult
        block = block[..., 0] + 1j * block[..., 1]
    block = block.astype(spec.dtype)
    lead = block.shape[:-1]
    carry_c = (state.carry[..., 0] + 1j * state.carry[..., 1]).astype(
        spec.dtype)
    carry_c = jnp.where(state.carry_valid[..., None], carry_c,
                        jnp.zeros_like(carry_c))
    ring = jnp.concatenate([carry_c, block], axis=-1)
    n = ring.shape[-1]

    if sync_mode == "gated":
        positions, valid = gated_hits(spec, ring, state.next_min_pos,
                                      max_frames)
    else:
        if lead:
            raise NotImplementedError(
                "dense sync_mode is single-channel only")
        score = dense_preamble_corr(spec, ring)
        positions, valid = extract_hits(spec, score, state.next_min_pos,
                                        max_frames)

    # gather frame windows (invalid slots read position 0 — masked later)
    starts = jnp.where(valid, positions - cfg.t2sin_size, 0).astype(jnp.int32)
    starts = jnp.clip(starts, 0, n - cfg.frame_len)

    sigs = rxm.extract_sigs_ring(spec, ring, starts)
    res = rxm.demod_sig(spec, sigs)
    diag = res.constellation.real + res.constellation.imag

    num_found = valid.sum(-1).astype(jnp.int32)            # [...]

    # carry the ring tail (stored as re/im planes — see StreamState.carry);
    # next admissible lag maps back by the slide amount
    slide = n - cfg.frame_len
    tail = ring[..., slide:]
    new_carry = jnp.stack([tail.real, tail.imag], axis=-1).astype(
        state.carry.dtype)
    # the cursor after the last decoded frame, translated into the next ring
    last_pos = jnp.max(jnp.where(valid, positions, -1), axis=-1)
    cursor_end = jnp.where(num_found > 0, last_pos + cfg.message_len, 0)
    next_min = jnp.maximum(cursor_end - slide, 0).astype(jnp.int32)

    new_state = StreamState(
        carry=new_carry,
        carry_valid=jnp.broadcast_to(jnp.asarray(True), lead),
        next_min_pos=next_min,
        frames_seen=state.frames_seen + num_found,
    )
    out = StreamOut(res.mac_bytes, diag, positions, valid, num_found, res.cfo)
    return new_state, out


def save_state(path: str, state: StreamState) -> None:
    """Checkpoint the resumable stream state (the reference's implicit
    pos/ring/counters, `rx.cpp:69,114-124` — here explicit and tiny)."""
    np.savez(path,
             carry=np.asarray(state.carry),
             carry_valid=np.asarray(state.carry_valid),
             next_min_pos=np.asarray(state.next_min_pos),
             frames_seen=np.asarray(state.frames_seen))


def load_state(path: str) -> StreamState:
    z = np.load(path if path.endswith(".npz") else path + ".npz")
    return StreamState(
        carry=jnp.asarray(z["carry"]),
        carry_valid=jnp.asarray(z["carry_valid"]),
        next_min_pos=jnp.asarray(z["next_min_pos"]),
        frames_seen=jnp.asarray(z["frames_seen"]),
    )


class StreamingReceiver:
    """Host-side convenience wrapper: feed ingest buffers, collect frames.

    Mirrors the role of the rx.cpp main loop; the per-buffer device step is
    one fused jit call.
    """

    def __init__(self, spec: FrameSpec, max_frames: int = 0,
                 sync_mode: str = "gated"):
        self.spec = spec
        self.max_frames = max_frames or (spec.cfg.rx_buf_size + 1)
        self.sync_mode = sync_mode
        self.state = init_state(spec)

    def feed(self, block) -> StreamOut:
        self.state, out = process_buffer(self.spec, self.state,
                                         jnp.asarray(block), self.max_frames,
                                         self.sync_mode)
        return out

    def feed_int16(self, raw) -> StreamOut:
        from . import tx as txm
        return self.feed(txm.from_int16(self.spec, jnp.asarray(raw)))
