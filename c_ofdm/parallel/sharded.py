"""Sharded receiver: shard_map over a {channel, time} mesh.

Long captures are split into contiguous time blocks, one per device along the
``time`` axis; independent streams ride the ``channel`` axis.  Each device
receives its right neighbor's first ``frame_len`` samples via ``ppermute``
(the distributed overlap-save halo — reference counterpart is the
single-process carry-over memcpy, `rx.cpp:147-156`), detects every frame whose
*start* lies inside its own block (exactly-once ownership rule), and demods
locally.  After the one halo exchange, blocks are fully independent — frame
sync/CFO/channel state never crosses a frame boundary (every estimator reads
only within one frame: `OFDM/Frame.hpp:238-337,389-434`), which is what makes
near-linear scaling possible.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..models import rx as rxm
from ..models import streaming
from ..models.frame import FrameSpec
from .mesh import CHANNEL_AXIS, TIME_AXIS


def _local_receive(spec: FrameSpec, block: jnp.ndarray, halo: jnp.ndarray,
                   halo_valid: jnp.ndarray, max_frames: int,
                   sync_mode: str = "gated"):
    """Decode frames starting inside ``block`` [block_len], using ``halo``
    [frame_len] (the right neighbor's head) to complete boundary frames.

    ``halo_valid`` is False on the last time shard, whose halo is zeros (there
    is no right neighbor): frames must then fit entirely inside the block —
    the same "window runs past the buffer end -> not decodable" rule the
    single-device path applies at the capture tail
    (streaming.extract_hits ``last_ok``), so a frame cut off by the global
    capture boundary is dropped instead of demodulating garbage."""
    cfg = spec.cfg
    block_len = block.shape[-1]
    ext = jnp.concatenate([block, halo], axis=-1)
    if sync_mode == "gated":
        positions, valid = streaming.gated_hits(
            spec, ext, jnp.asarray(0, jnp.int32), max_frames)
    else:
        score = streaming.dense_preamble_corr(spec, ext)
        positions, valid = streaming.extract_hits(
            spec, score, jnp.asarray(0, jnp.int32), max_frames)
    starts = positions - cfg.t2sin_size
    # ownership: the frame's first sample lies in this device's block
    valid = jnp.logical_and(valid,
                            jnp.logical_and(starts >= 0, starts < block_len))
    # capture tail: without a real halo the frame must fit inside the block
    fits = starts + cfg.frame_len <= block_len
    valid = jnp.logical_and(valid, jnp.logical_or(halo_valid, fits))
    gather = jnp.clip(jnp.where(valid, starts, 0), 0,
                      ext.shape[-1] - cfg.frame_len)
    sigs = rxm.extract_sigs_ring(spec, ext, gather)
    res = rxm.demod_sig(spec, sigs)
    diag = res.constellation.real + res.constellation.imag
    return streaming.StreamOut(res.mac_bytes, diag, positions, valid,
                               valid.sum().astype(jnp.int32), res.cfo)


def make_sharded_receiver(spec: FrameSpec, mesh, max_frames_per_block: int,
                          sync_mode: str = "gated"):
    """Build a jitted sharded bulk receiver.

    Input  captures [n_channel_total, total_len] sharded (channel, time);
    output StreamOut with leading dims [n_channel_total, n_time, max_frames]
    (positions are block-local; valid masks ownership).  ``sync_mode`` as in
    ``streaming.process_buffer`` ("gated" production / "dense" fallback).
    """

    def step(captures: jnp.ndarray):
        def per_shard(local):                      # [ch_local, block_len]
            heads = local[..., : spec.cfg.frame_len]
            n_time = jax.lax.psum(1, TIME_AXIS)
            # pass each block's head LEFT so device i sees block i+1's head
            halo = jax.lax.ppermute(
                heads, TIME_AXIS,
                perm=[(i, (i - 1) % n_time) for i in range(n_time)])
            # the last device wraps to the first channel-row block, which is
            # wrong data: zero it and mark it invalid, so the tail shard
            # applies the capture-end "frame must fit" rule (see
            # _local_receive)
            t = jax.lax.axis_index(TIME_AXIS)
            halo_valid = t < n_time - 1
            halo = jnp.where(halo_valid, halo, jnp.zeros_like(halo))
            out = jax.vmap(lambda b, h: _local_receive(
                spec, b, h, halo_valid, max_frames_per_block,
                sync_mode))(local, halo)
            # add the n_time axis back for the global view
            return jax.tree.map(lambda x: x[:, None], out)

        return shard_map(
            per_shard, mesh=mesh,
            in_specs=P(CHANNEL_AXIS, TIME_AXIS),
            out_specs=jax.tree.map(lambda _: P(CHANNEL_AXIS, TIME_AXIS),
                                   _out_tree_proto()),
            check_vma=False,
        )(captures)

    return jax.jit(step)


def _out_tree_proto():
    return streaming.StreamOut(0, 0, 0, 0, 0, 0)


def make_sharded_streaming(spec: FrameSpec, mesh, max_frames: int,
                           sync_mode: str = "gated"):
    """Channel-sharded CONTINUOUS streaming: C channel streams distributed
    over the mesh's ``channel`` axis, every device running the same fused
    ``streaming.process_buffer`` step on its local channels with its local
    carry state — the multi-chip form of `bench.py --channels C`.

    Unlike ``make_sharded_receiver`` (bulk decode of one long capture,
    time-sharded with a halo exchange), the streaming step's time dimension
    IS the buffer sequence, so only the channel axis shards; the per-buffer
    overlap-save carry stays device-local inside the sharded state and
    ZERO collectives run per buffer.  Returned callable:
    ``step(state, block) -> (state, StreamOut)`` where every array carries
    a leading [C] axis laid out over the mesh channel axis; thread the
    state exactly as with the unsharded ``process_buffer``
    (``init_state(spec, channels=C)`` then device_put against the channel
    sharding, or let jit lay it out on first call).

    Reference counterpart of the semantics: C concurrent instances of the
    rx.cpp main loop; the distribution itself is green-field (SURVEY §5.7).
    """
    pspec = P(CHANNEL_AXIS)

    def step(state: streaming.StreamState, block: jnp.ndarray):
        def per_shard(st, blk):
            return streaming.process_buffer(spec, st, blk, max_frames,
                                            sync_mode)

        state_specs = jax.tree.map(lambda _: pspec,
                                   streaming.StreamState(0, 0, 0, 0))
        out_specs = (state_specs, jax.tree.map(lambda _: pspec,
                                               _out_tree_proto()))
        return shard_map(per_shard, mesh=mesh,
                         in_specs=(state_specs, pspec),
                         out_specs=out_specs,
                         check_vma=False)(state, block)

    return jax.jit(step)


def global_positions(spec: FrameSpec, out: streaming.StreamOut,
                     block_len: int):
    """Convert block-local preamble positions to capture-global ones."""
    n_time = out.positions.shape[1]
    offs = (jnp.arange(n_time) * block_len)[None, :, None]
    return jnp.where(out.valid, out.positions + offs, -1)
