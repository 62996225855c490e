"""Streaming receiver app — the reference ``rx`` binary's role
(`rx.cpp:94-237`): continuous ingest -> streaming sync/demod -> payload sink,
with per-buffer stage tracing flushed once at exit (LOG.txt pattern).

Usage:
  python -m c_ofdm.apps.rxstream --in capture.bin --format i16 \
      --out decoded.bin [--log LOG.txt] [--metrics metrics.jsonl] \
      [--summary-json summary.json]

Input formats: i16 (interleaved int16 IQ, scaled by config mult) or
f64 (interleaved float64 IQ, reference data.bin layout).

The loop is pipelined like the reference's double-buffer thread
(`rx.cpp:55-66`), but against the accelerator instead of the radio: while the
device demodulates buffer N, the host reads buffer N+1 from the source and
stages it on-device (async ``device_put``), and buffer N-1's results are
materialized (the readback overlaps N's compute — JAX dispatch is
asynchronous).  The end-of-run summary reports host-feed vs device-wait time
so feed-bound operation is visible, like ``st_rx``'s ingest benchmark.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import jax.numpy as jnp


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--in", dest="inp", required=True,
                   help="capture file or '-' for stdin")
    p.add_argument("--format", choices=("i16", "f64"), default="i16")
    p.add_argument("--out", default="decoded.bin")
    p.add_argument("--config", default="")
    p.add_argument("--log", default="", help="stage-trace LOG.txt path")
    p.add_argument("--metrics", default="", help="per-frame metrics jsonl")
    p.add_argument("--native-ingest", action="store_true",
                   help="use the C++ ingest ring for file reads (i16 only; NB the replay source loops the file like the reference's cyclic TX)")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--sync-mode", choices=("gated", "dense"), default="gated",
                   help="gated (default): two-tone-gated matched filter, the "
                        "production path, multi-channel capable.  dense: "
                        "matched-filter every ring lag — detector-independent "
                        "parity fallback, single-channel only (the "
                        "library's process_buffer raises on channel-batched "
                        "state in dense mode) and much slower, since it "
                        "matched-filters every lag")
    p.add_argument("--summary-json", default="",
                   help="write end-of-run throughput summary JSON here "
                        "('-' = stdout)")
    p.add_argument("--drain", choices=("full", "metadata"), default="full",
                   help="'full' drains payloads to --out per buffer; "
                        "'metadata' keeps payloads on device and accumulates "
                        "CRC/seq tallies there, reading back ~32 bytes at "
                        "the end — this measures the true end-to-end "
                        "ingest+compute rate when the host<->device result "
                        "channel (not the device) is the bottleneck")
    p.add_argument("--chunk", type=int, default=1,
                   help="metadata mode: buffers per device dispatch (a "
                        "lax.scan over the chunk) — dispatch batching for "
                        "when per-dispatch latency exceeds the device time "
                        "of one buffer")
    p.add_argument("--profile", default="",
                   help="capture a jax.profiler device trace of the run "
                        "into this directory (view with xprof/tensorboard)")
    args = p.parse_args(argv)

    from c_ofdm import ModemConfig, load_config, make_frame_spec
    from c_ofdm.io.trace import StageTrace
    from c_ofdm.utils.compile_cache import enable_compile_cache
    from c_ofdm.mac.mac import Mac
    from c_ofdm.models.streaming import StreamingReceiver

    enable_compile_cache()
    cfg = load_config(args.config) if args.config else ModemConfig()
    spec = make_frame_spec(cfg, dtype=jnp.complex64, fft_backend="matmul")
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rxr = StreamingReceiver(spec, max_frames=args.max_frames,
                            sync_mode=args.sync_mode)
    trace = StageTrace()

    buf_samples = cfg.rx_buf_size * cfg.frame_len

    def buffers():
        if args.native_ingest and args.format == "i16" and args.inp != "-":
            from c_ofdm.io.ingest import NativeIngest, SRC_FILE_REPLAY
            ing = NativeIngest(SRC_FILE_REPLAY, args.inp, buf_samples, 4)
            # file replay loops forever; stop after covering the file once
            import os
            n_bufs = max(1, -(-os.path.getsize(args.inp) // (buf_samples * 4)))
            for _ in range(n_bufs):
                buf = ing.pop_complex64()
                if buf is None:
                    break
                yield buf / cfg.mult
            ing.close()
            return
        src = sys.stdin.buffer if args.inp == "-" else open(args.inp, "rb")
        itemsize = 4 if args.format == "i16" else 16
        while True:
            raw = src.read(buf_samples * itemsize)
            if not raw:
                break
            if args.format == "i16":
                # keep the SDR wire format: int16 [n, 2] staged as-is and
                # converted/scaled on device (process_buffer) — half the
                # host->device bytes of a f32 stage
                block = np.frombuffer(raw, dtype=np.int16).reshape(-1, 2)
                if block.shape[0] < buf_samples:
                    block = np.pad(block,
                                   ((0, buf_samples - block.shape[0]), (0, 0)))
            else:
                d = np.frombuffer(raw, dtype=np.float64)
                block = (d[0::2] + 1j * d[1::2]).astype(np.complex64)
                if block.size < buf_samples:
                    block = np.pad(block, (0, buf_samples - block.size))
            yield block
        if src is not sys.stdin.buffer:
            src.close()

    import time

    import jax

    out_f = open(args.out, "wb")
    n_frames = 0
    n_crc_bad = 0
    n_bufs = 0
    max_seq = None      # metadata drain only: max MAC seq seen (device max)
    payload_sum = None  # metadata drain only: uint32 payload checksum
    #                     (documented mod-2^32 wraparound on long runs)
    metrics_rows = []
    t_feed = 0.0       # host read + device staging
    t_drain = 0.0      # blocked on device results

    # MAC deframing happens ON DEVICE and only the deframed payload bytes +
    # int32/f32 metadata come back: the soft metrics are 8x the payload
    # size.
    @jax.jit
    def decode_out(o):
        frs = mac.read_soft(o.diag)
        # the uint32 MAC seq rides an int32 bitcast (all 32 bits kept)
        meta_i = jnp.stack([o.valid.astype(jnp.int32),
                            frs.valid.astype(jnp.int32),
                            jax.lax.bitcast_convert_type(frs.seq, jnp.int32),
                            o.positions.astype(jnp.int32)], axis=-1)
        return frs.payload, meta_i, o.cfo.astype(jnp.float32)

    def materialize(i, out):
        """Force buffer i's results off-device and sink them (runs one
        iteration behind the dispatch, overlapping buffer i+1's compute)."""
        nonlocal n_frames, n_crc_bad, t_drain
        t0 = time.perf_counter()
        payloads, meta, cfo = jax.device_get(decode_out(out))
        t_drain += time.perf_counter() - t0
        valid = meta[:, 0] > 0
        seqs = meta[:, 2].view(np.uint32)     # undo the device-side bitcast
        for k in np.nonzero(valid)[0]:
            ok = bool(meta[k, 1] > 0)
            n_crc_bad += (not ok)
            out_f.write(payloads[k].tobytes())
            if args.metrics:
                metrics_rows.append({
                    "buf": i, "slot": int(k), "pos": int(meta[k, 3]),
                    "seq": int(seqs[k]), "cfo": float(cfo[k]),
                    "crc_ok": ok,
                })
            n_frames += 1
        trace.point("MAC")
        trace.value("DET", n_frames)
        trace.value("FR_IN_BUF", int(valid.sum()))

    # --drain metadata: everything stays on device; per buffer we fold the
    # StreamOut into four scalars (frames, CRC failures, max seq, payload
    # checksum) so the only readback of the whole run is ~32 bytes at exit.
    @jax.jit
    def tally(acc, o):
        frs = mac.read_soft(o.diag)
        v = o.valid
        bad = jnp.logical_and(v, jnp.logical_not(frs.valid))
        ok = jnp.logical_and(v, frs.valid)
        psum = jnp.where(ok[..., None], frs.payload, 0).astype(
            jnp.uint32).sum()
        return (acc[0] + v.sum().astype(jnp.int32),
                acc[1] + bad.sum().astype(jnp.int32),
                jnp.maximum(acc[2], jnp.max(jnp.where(ok, frs.seq, 0))),
                acc[3] + psum)

    def staged_blocks():
        """Read the next host buffer and stage it on-device while the device
        is busy with the previous one (rx.cpp:55-66 double-buffer role).
        Complex blocks go up as interleaved f32 [n, 2] (the SDR wire
        format) and are recombined on device inside process_buffer."""
        nonlocal t_feed
        for block in buffers():
            t0 = time.perf_counter()
            if np.iscomplexobj(block):
                block = np.stack([block.real, block.imag],
                                 axis=-1).astype(np.float32)
            dev = jax.device_put(block)
            t_feed += time.perf_counter() - t0
            yield dev

    import contextlib
    prof = (jax.profiler.trace(args.profile) if args.profile
            else contextlib.nullcontext())
    t_wall0 = time.perf_counter()
    t_steady = None    # set after buffer 0 drains (compile excluded)
    from c_ofdm.models import streaming

    @jax.jit
    def chunk_step(state, acc, bufs):
        """lax.scan over a [chunk, n, 2] stack: one dispatch, chunk buffers
        (rx.cpp has no analogue — its SDR hands over one buffer at a
        time)."""
        def body(carry, buf):
            st, a = carry
            st, out = streaming.process_buffer(spec, st, buf,
                                               rxr.max_frames, args.sync_mode)
            return (st, tally(a, out)), None
        (state, acc), _ = jax.lax.scan(body, (state, acc), bufs)
        return state, acc

    acc = None
    with prof:
        if args.drain == "metadata" and args.chunk > 1:
            z = jnp.int32(0)
            acc = (z, z, jnp.uint32(0), jnp.uint32(0))
            state = streaming.init_state(spec)
            pend = []
            first = True

            def flush():
                nonlocal state, acc, t_steady, first, n_bufs
                bufs = jnp.stack(pend) if len(pend) == args.chunk else \
                    jnp.concatenate([jnp.stack(pend), jnp.zeros(
                        (args.chunk - len(pend), *pend[0].shape),
                        pend[0].dtype)])
                state, acc = chunk_step(state, acc, bufs)
                n_bufs += len(pend)
                pend.clear()
                if first:
                    int(acc[0])            # chunk 0 blocks on compile
                    t_steady = time.perf_counter()
                    first = False

            for dev_block in staged_blocks():
                pend.append(dev_block)
                if len(pend) == args.chunk:
                    flush()
            if pend:
                flush()
            vals = jax.device_get(acc)     # THE readback (~32 bytes)
            n_frames, n_crc_bad = int(vals[0]), int(vals[1])
            max_seq, payload_sum = int(vals[2]), int(vals[3])
        elif args.drain == "metadata":
            z = jnp.int32(0)
            acc = (z, z, jnp.uint32(0), jnp.uint32(0))
            for i, dev_block in enumerate(staged_blocks()):
                trace.iter_start(ITER=i)
                out = rxr.feed(dev_block)   # async dispatch
                acc = tally(acc, out)       # stays on device
                trace.point("RX_STEP")
                n_bufs += 1
                if i == 0:
                    int(acc[0])             # buffer 0 blocks on compile
                    t_steady = time.perf_counter()
            if acc is not None:
                vals = jax.device_get(acc)  # THE readback (~32 bytes)
                n_frames, n_crc_bad = int(vals[0]), int(vals[1])
                max_seq, payload_sum = int(vals[2]), int(vals[3])
        else:
            pending = None  # (i, StreamOut) of the buffer still computing
            for i, dev_block in enumerate(staged_blocks()):
                trace.iter_start(ITER=i)
                out = rxr.feed(dev_block)   # async dispatch
                trace.point("RX_STEP")
                n_bufs += 1
                if pending is not None:
                    materialize(*pending)   # overlaps buffer i's compute
                    if t_steady is None:
                        t_steady = time.perf_counter()
                pending = (i, out)
            if pending is not None:
                materialize(*pending)
                if t_steady is None:
                    t_steady = time.perf_counter()
    wall = time.perf_counter() - t_wall0
    out_f.close()

    # buffers processed before t_steady (compile) are excluded from the
    # steady rate: one buffer normally, the whole first chunk when chunking
    excl = args.chunk if (args.drain == "metadata" and args.chunk > 1) else 1
    steady_bufs = max(n_bufs - excl, 0)
    steady_wall = max(time.perf_counter() - (t_steady or t_wall0), 1e-9)
    summary = {
        "drain": args.drain,
        "buffers": n_bufs,
        "frames": n_frames,
        "crc_failures": n_crc_bad,
        "wall_s": round(wall, 4),
        "samples_per_s": round(n_bufs * buf_samples / wall, 1),
        "frames_per_s": round(n_frames / wall, 1),
        # rate excluding the first buffer (which carries jit compilation)
        "steady_samples_per_s": round(steady_bufs * buf_samples
                                      / steady_wall, 1),
        "host_feed_s": round(t_feed, 4),
        "device_drain_s": round(t_drain, 4),
        "feed_bound": t_feed > 0.5 * wall,
    }
    if max_seq is not None:
        # device-side verification tallies (metadata drain): highest MAC seq
        # accepted, and a mod-2^32 checksum over all CRC-clean payload bytes
        # (wraps on long runs by design — it is an equality check against a
        # same-width reference sum, not a byte count).  max_seq is -1 when
        # nothing was decoded (the device accumulator's 0 would be
        # indistinguishable from 'frame with seq 0 arrived')
        # gate on the CRC-OK count: the device accumulator only maxes seq
        # over CRC-clean frames, so a run where every frame fails CRC must
        # report -1 (n_frames alone counts CRC-bad slots too and would
        # resurrect the 'seq 0 accepted' ambiguity)
        summary["max_seq"] = max_seq if (n_frames - n_crc_bad) > 0 else -1
        summary["payload_checksum_u32"] = payload_sum
    if args.summary_json:
        text = __import__("json").dumps(summary)
        if args.summary_json == "-":
            print(text)
        else:
            with open(args.summary_json, "w") as f:
                f.write(text + "\n")

    if args.log:
        trace.to_log_txt(args.log)
    if args.metrics:
        import json
        with open(args.metrics, "w") as f:
            for r in metrics_rows:
                f.write(json.dumps(r) + "\n")
    print(f"decoded {n_frames} frames ({n_crc_bad} CRC failures) "
          f"-> {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
