"""Worker for the 2-process distributed-ingest test (run via subprocess).

Each process plays one host of a 2-host deployment: it ingests ONE channel's
capture locally, contributes it to the globally-sharded array with
``make_global_capture`` (the ``jax.make_array_from_process_local_data``
branch, `parallel/ingest.py`), runs the sharded receiver over the global
{channel:2, time:4} mesh, and prints the frames decoded from its own
(addressable) channel row as JSON.

Usage: _mp_worker.py <process_id> <coordinator_port>
"""

import json
import sys


def main():
    pid = int(sys.argv[1])
    port = int(sys.argv[2])

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 8 and len(jax.local_devices()) == 4

    import numpy as np
    import jax.numpy as jnp

    from c_ofdm import ModemConfig, make_frame_spec
    from c_ofdm.mac.mac import Mac
    from c_ofdm.models import tx as txm
    from c_ofdm.parallel.ingest import make_global_capture
    from c_ofdm.parallel.mesh import make_modem_mesh
    from c_ofdm.parallel.sharded import make_sharded_receiver

    cfg = ModemConfig()
    spec = make_frame_spec(cfg, dtype=jnp.complex64)
    mesh = make_modem_mesh(n_channel=2, n_time=4)

    # deterministic per-channel capture: this host's radio head (channel ==
    # process id), 3 frames incl. one straddling a time-shard boundary
    block_len = 2 * cfg.frame_len
    total = 4 * block_len
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(100 + pid)
    starts = [1000, block_len - cfg.frame_len // 3, 3 * block_len + 777]
    payloads = rng.integers(0, 256, (len(starts), mac.payload), dtype=np.uint8)
    wire = mac.write(jnp.asarray(payloads),
                     jnp.arange(len(starts), dtype=jnp.uint32))
    frames = np.asarray(txm.transmit(spec, wire))
    sig = np.zeros(total, dtype=np.complex128)
    for f, s in zip(frames, starts):
        sig[s:s + cfg.frame_len] += f
    sig = (sig * np.exp(2j * np.pi * 5e-5 * np.arange(total)) * 50.0)
    sig += (rng.standard_normal(total) + 1j * rng.standard_normal(total)) * 0.3
    local = sig.astype(np.complex64)[None, :]           # [1 channel, total]

    arr = make_global_capture(mesh, local, global_shape=(2, total))
    assert not arr.is_fully_addressable                  # truly distributed
    recv = make_sharded_receiver(spec, mesh, max_frames_per_block=4)
    out = recv(arr)

    # this process owns channel row == pid; collect its decoded frames
    got = []
    for shard in out.valid.addressable_shards:
        ch = shard.index[0].start or 0
        assert ch == pid, (ch, pid)
    valid = np.concatenate([np.asarray(s.data)
                            for s in sorted(out.valid.addressable_shards,
                                            key=lambda s: s.index[1].start or 0)],
                           axis=1)[0]                    # [4, K]
    diag = np.concatenate([np.asarray(s.data)
                           for s in sorted(out.diag.addressable_shards,
                                           key=lambda s: s.index[1].start or 0)],
                          axis=1)[0]
    for t in range(valid.shape[0]):
        for k in np.nonzero(valid[t])[0]:
            fr = mac.read_soft(jnp.asarray(diag[t, k]))
            got.append({
                "seq": int(np.asarray(fr.seq)),
                "crc_ok": bool(np.asarray(fr.valid)),
                "payload_ok": bool(np.array_equal(
                    np.asarray(fr.payload),
                    payloads[int(np.asarray(fr.seq))])),
            })
    # ---- phase 2: distributed CONTINUOUS streaming with state threading ----
    # each host feeds its own channel's buffer sequence; the channel-sharded
    # carry state (one frame of overlap-save halo per channel) lives on the
    # devices between steps and never crosses hosts — a frame straddling the
    # buffer boundary must still decode exactly once.
    from c_ofdm.models import streaming
    from c_ofdm.parallel.ingest import (make_global_channel_array,
                                            make_global_stream_state)
    from c_ofdm.parallel.sharded import make_sharded_streaming

    buf_len = 4 * cfg.frame_len
    sstarts = [500, buf_len - cfg.frame_len // 2, buf_len + 2 * cfg.frame_len]
    spayloads = rng.integers(0, 256, (len(sstarts), mac.payload),
                             dtype=np.uint8)
    swire = mac.write(jnp.asarray(spayloads),
                      jnp.arange(len(sstarts), dtype=jnp.uint32))
    sframes = np.asarray(txm.transmit(spec, swire))
    stream = np.zeros(2 * buf_len, dtype=np.complex128)
    for f, s in zip(sframes, sstarts):
        stream[s:s + cfg.frame_len] += f
    stream = stream * np.exp(2j * np.pi * 5e-5 * np.arange(stream.size)) * 50.0
    stream += (rng.standard_normal(stream.size)
               + 1j * rng.standard_normal(stream.size)) * 0.3
    stream = stream.astype(np.complex64)

    step = make_sharded_streaming(spec, mesh, max_frames=6)
    state = make_global_stream_state(
        mesh, streaming.init_state(spec, channels=1), global_channels=2)
    sgot = []
    for b in range(2):
        blk = make_global_channel_array(
            mesh, stream[None, b * buf_len:(b + 1) * buf_len],
            global_channels=2)
        state, out = step(state, blk)
        valid = np.concatenate([np.asarray(s.data) for s in
                                out.valid.addressable_shards], axis=0)[0]
        diag = np.concatenate([np.asarray(s.data) for s in
                               out.diag.addressable_shards], axis=0)[0]
        for k in np.nonzero(valid)[0]:
            fr = mac.read_soft(jnp.asarray(diag[k]))
            sgot.append({
                "seq": int(np.asarray(fr.seq)),
                "crc_ok": bool(np.asarray(fr.valid)),
                "payload_ok": bool(np.array_equal(
                    np.asarray(fr.payload),
                    spayloads[int(np.asarray(fr.seq))])),
            })
    # the channel-sharded state is replicated over the time axis: dedupe
    # addressable shards by index so replicas are counted once
    uniq = {str(sh.index): np.asarray(sh.data)
            for sh in state.frames_seen.addressable_shards}
    seen = sum(int(v.sum()) for v in uniq.values())
    print("RESULT " + json.dumps({"pid": pid, "frames": got,
                                  "stream_frames": sgot,
                                  "stream_seen": seen}),
          flush=True)


if __name__ == "__main__":
    main()
