"""On-card smoke test: the modem's main paths, once, on NVIDIA GPUs.

    python chip_smoke.py [--seed N]      # phases (a)-(f) on one card
    python chip_smoke.py --chips 4       # only the sharded paths, 4 cards

Every phase runs at a real width and checks its result against planted truth
or the float64 oracle:

  (a) served path: a 40-buffer int16 capture (~1,280 frames) decoded by the
      ``rxstream`` app, with and without the native C++ ingest ring;
  (b) batch TX+RX at B=256, reference geometry;
  (c) parity of one impaired capture with the float64 oracle;
  (d) wideband 8k-QAM64 loopback at B=128 for the ``ct`` and ``xla`` FFTs;
  (e) 8 channels x 10 buffers through ``streaming.process_buffer``;
  (f) compiled memory of the batch and ring steps, peak device memory.

Nothing falls back to the CPU: without a GPU the script exits non-zero
before any phase and prints no result line.  All phases run in this one
process (a second JAX process on the card would fail for want of memory).
The last line of stdout is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from __graft_entry__ import check, check_sharded_receiver, impaired_streams

REPO = os.path.dirname(os.path.abspath(__file__))
CARD = "card not named"        # nvidia-smi's "name, power.limit", set in main

# parity limits of phase (c): complex64 arithmetic through about ten stages
# at the pinned matmul precision, against the float64 oracle.  On an H100
# the constellation reads ~1.5e-5 at HIGHEST and ~7e-4 with the chain's
# dots at DEFAULT (TF32): the limit sits between, so it catches TF32
CONST_TOL = 1e-4               # max |constellation delta|, corner |x| = 1
TX_LSB_TOL = 1                 # int16 TX samples


def log(msg: str) -> None:
    print(msg, flush=True)


def secs(t: float) -> str:
    """A time, always with the card it was taken on."""
    return f"{t:.4f} s [{CARD}]"


def ms(t: float) -> str:
    return f"{t * 1e3:.3f} ms [{CARD}]"


def nvidia_smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or f"nvidia-smi failed: {r.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def require_gpu() -> None:
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU; JAX found "
                         f"'{platform}' devices only")


def _spec(cfg=None, fft_backend="matmul"):
    from c_ofdm import ModemConfig, make_frame_spec
    return make_frame_spec(cfg or ModemConfig(), dtype=jnp.complex64,
                           fft_backend=fft_backend)


def _timed(fn, iters: int) -> float:
    """Mean seconds per call of ``fn(i)`` over ``iters`` calls, ending in
    block_until_ready."""
    out = None
    t0 = time.perf_counter()
    for i in range(iters):
        out = fn(i)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def _decoded_frames(out, c=None):
    """Valid (position, wire bytes) rows of one StreamOut (channel ``c``)."""
    valid = np.asarray(out.valid if c is None else out.valid[c])
    pos = np.asarray(out.positions if c is None else out.positions[c])
    mb = np.asarray(out.mac_bytes if c is None else out.mac_bytes[c])
    return [(int(pos[k]), bytes(mb[k])) for k in np.nonzero(valid)[0]]


# ---------------------------------------------------------------- (a) ----

def _to_i16_file(iq: np.ndarray, mult: int, path: str) -> None:
    q = np.stack([np.trunc(iq.real * mult), np.trunc(iq.imag * mult)], -1)
    check(np.abs(q).max() < 32767, "capture overflows int16")
    q.astype(np.int16).tofile(path)


def phase_served(seed: int, n_bufs: int, workdir: str) -> None:
    """The served path: rxstream decodes a seeded int16 capture of
    ``n_bufs`` reference buffers; every planted frame exactly once,
    payload byte-equal, CRC-clean — with and without native ingest."""
    from c_ofdm.apps import rxstream
    from c_ofdm.channel.sim import planted_stream

    spec = _spec()
    cfg = spec.cfg
    buf = cfg.rx_buf_size * cfg.frame_len
    # amplitude 40 keeps the int16 wire samples (x mult) clear of overflow
    ps = planted_stream(spec, n_bufs * buf, seed, amplitude=40.0)
    n = len(ps.starts)
    path = os.path.join(workdir, "capture.i16")
    _to_i16_file(ps.iq, cfg.mult, path)
    log(f"(a) capture: {n_bufs} buffers x {buf} samples, {n} frames, "
        f"AWGN 26 dB, CFO 1e-4")
    for native in (False, True):
        tag = "native ingest" if native else "python ingest"
        out = os.path.join(workdir, "decoded.bin")
        metrics = os.path.join(workdir, "metrics.jsonl")
        summary = os.path.join(workdir, "summary.json")
        argv = ["--in", path, "--format", "i16", "--drain", "full",
                "--out", out, "--metrics", metrics,
                "--summary-json", summary]
        t0 = time.perf_counter()
        rc = rxstream.main(argv + (["--native-ingest"] if native else []))
        wall = time.perf_counter() - t0
        check(rc == 0, f"rxstream ({tag}) exited {rc}")
        with open(summary) as f:
            s = json.load(f)
        with open(metrics) as f:
            rows = [json.loads(line) for line in f]
        with open(out, "rb") as f:
            got = f.read()
        check(s["crc_failures"] == 0, s)
        check(s["frames"] == n, f"{tag}: decoded {s['frames']} of {n}")
        check([r["seq"] for r in rows] == list(range(n)),
              f"{tag}: frames not decoded exactly once, in order")
        check(got == ps.payloads.tobytes(), f"{tag}: payload bytes differ")
        log(f"(a) served path, {tag}: OK {s['frames']}/{n} frames exactly "
            f"once, payloads byte-equal, 0 CRC failures; wall {secs(wall)}, "
            f"steady {s['steady_samples_per_s']:.0f} samples/s [{CARD}]")


# ---------------------------------------------------------------- (b) ----

def _batch_step(spec):
    from c_ofdm.models import rx, tx

    @jax.jit
    def step(wire):
        res, s = rx.receive_batch(spec, tx.transmit(spec, wire))
        return res.mac_bytes, s.found
    return step


def _mac_wire(spec, B: int, seed: int) -> jnp.ndarray:
    from c_ofdm.mac.mac import Mac
    mac = Mac(frame_bytes=spec.cfg.frame_bytes, spread=spec.cfg.mod_type)
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (B, mac.payload), dtype=np.uint8)
    return mac.write(jnp.asarray(payloads), jnp.arange(B, dtype=jnp.uint32))


def phase_batch(seed: int, B: int, iters: int = 20):
    """Batch TX -> RX at the reference geometry: mac_bytes == wire."""
    spec = _spec()
    wire = _mac_wire(spec, B, seed)
    step = _batch_step(spec)
    t0 = time.perf_counter()
    compiled = step.lower(wire).compile()
    t_compile = time.perf_counter() - t0
    got, found = compiled(wire)
    check(bool(np.asarray(found).all()), "batch: sync missed frames")
    check(np.array_equal(np.asarray(got), np.asarray(wire)),
          "batch: decoded bytes != planted wire bytes")
    t = _timed(lambda i: compiled(wire), iters)
    log(f"(b) batch TX+RX B={B}: OK {B}/{B} frames byte-equal; compile "
        f"{secs(t_compile)}, step {ms(t)}")
    return compiled


# ---------------------------------------------------------------- (c) ----

def phase_oracle(seed: int) -> None:
    """One impaired capture at the reference geometry, decoded on the device
    (complex64) and by the float64 oracle on the host."""
    from c_ofdm.models import rx, tx
    from c_ofdm.oracle import reference as oracle

    spec = _spec()
    cfg = spec.cfg
    wire = np.asarray(_mac_wire(spec, 1, seed))[0]
    rng = np.random.default_rng(seed)
    frame = oracle.tx_frame(cfg, wire)
    off = 3000
    n = cfg.frame_len + 2 * off
    amp = 60.0
    noise_std = amp * np.sqrt((np.abs(frame) ** 2).mean()
                              * 10 ** (-26.0 / 10) / 2)
    cap = noise_std * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    cap[off:off + cfg.frame_len] += amp * frame
    cap *= np.exp(2j * np.pi * (1e-4 * np.arange(n) + rng.random()))

    want = oracle.rx_capture(cfg, cap)
    check(want is not None, "oracle found no frame")
    o_bytes, o_const, _, o_t2, o_pr = want
    res, s = rx.receive_capture_jit(spec,
                                    jnp.asarray(cap.astype(np.complex64)))
    check(bool(s.found), "device sync found no frame")
    t2, pr = int(s.t2_begin), int(s.pr_begin)
    check((t2, pr) == (o_t2, o_pr),
          f"sync {(t2, pr)} != oracle {(o_t2, o_pr)}")
    got = np.asarray(res.mac_bytes)
    check(np.array_equal(got, o_bytes) and np.array_equal(got, wire),
          "decoded bytes differ from the oracle or the planted wire")
    d_const = float(np.abs(np.asarray(res.constellation) - o_const).max())
    check(d_const <= CONST_TOL, f"constellation max |delta| {d_const}")

    i16 = np.asarray(tx.to_int16(spec, tx.transmit(spec, jnp.asarray(wire))))
    o16 = oracle.to_int16(cfg, frame)
    o16 = np.stack([o16.real, o16.imag], -1).reshape(-1)
    d_tx = int(np.abs(i16.astype(np.int64) - o16.astype(np.int64)).max())
    check(d_tx <= TX_LSB_TOL, f"TX int16 max |delta| {d_tx} LSB")
    log(f"(c) float64 oracle parity: OK sync (t2 {t2}, preamble {pr}) equal, "
        f"bytes equal; constellation max |delta| {d_const:.3e} "
        f"(limit {CONST_TOL:g}); TX int16 max |delta| {d_tx} LSB "
        f"(limit {TX_LSB_TOL})")


# ---------------------------------------------------------------- (d) ----

def phase_wideband(seed: int, B: int) -> None:
    """8k-QAM64 loopback under AWGN + CFO + timing offset, both FFT backends
    a user can pick at this size: payload byte-equal, BER 0."""
    from c_ofdm import ModemConfig, WIDEBAND_8K
    from c_ofdm.channel.sim import ChannelParams, apply_channel
    from c_ofdm.models import rx, tx

    cfg = ModemConfig(**WIDEBAND_8K)
    rng = np.random.default_rng(seed)
    payload = jnp.asarray(rng.integers(0, 256, (B, cfg.frame_bytes),
                                       dtype=np.uint8))
    params = ChannelParams(snr_db=36.0, cfo=1e-5, timing_offset=701,
                           capture_len=cfg.frame_len + 4096, amplitude=10.0)
    key = jax.random.PRNGKey(seed)
    for be in ("ct", "xla"):
        spec = _spec(cfg, fft_backend=be)

        @jax.jit
        def step(p, k):
            cap = apply_channel(params, k, tx.transmit(spec, p))
            res, s = rx.receive_batch(spec, cap)
            return res.mac_bytes, s.found

        t0 = time.perf_counter()
        got, found = step(payload, key)
        got = np.asarray(got)
        t_first = time.perf_counter() - t0
        check(bool(np.asarray(found).all()), f"wideband {be}: sync missed")
        ber = float(np.unpackbits(got ^ np.asarray(payload)).mean())
        check(ber == 0.0, f"wideband {be}: BER {ber}")
        t = _timed(lambda i: step(payload, key), 5)
        log(f"(d) wideband 8k-QAM64 B={B} fft_backend={be}: OK payloads "
            f"byte-equal, BER 0 (AWGN 36 dB, CFO 1e-5, offset 701); "
            f"first call {secs(t_first)}, step {ms(t)}")


# ---------------------------------------------------------------- (e) ----

def multichannel_streams(seed: int, C: int, n_bufs: int):
    """C planted channel streams of ``n_bufs`` reference buffers each:
    (blocks [n_bufs, C, buf] complex64, per-channel PlantedStream)."""
    from c_ofdm.channel.sim import planted_stream

    spec = _spec()
    buf = spec.cfg.rx_buf_size * spec.cfg.frame_len
    streams = [planted_stream(spec, n_bufs * buf, seed * 1000 + c)
               for c in range(C)]
    blocks = np.stack([s.iq.reshape(n_bufs, buf) for s in streams], axis=1)
    return blocks, streams


def check_streams(decoded, streams, what: str) -> int:
    """decoded[c] = [wire bytes...] in decode order; each planted frame
    exactly once, in order, byte-equal."""
    total = 0
    for c, (got, ps) in enumerate(zip(decoded, streams)):
        want = [bytes(w) for w in ps.wire]
        check(got == want, f"{what}: channel {c} decoded {len(got)} "
                           f"frames, planted {len(want)}; mismatch")
        total += len(got)
    return total


def decode_multichannel(spec, blocks) -> list:
    """Thread [C]-batched state through process_buffer over the buffers."""
    from c_ofdm.models import streaming

    n_bufs, C = blocks.shape[:2]
    state = streaming.init_state(spec, channels=C)
    decoded = [[] for _ in range(C)]
    for i in range(n_bufs):
        state, out = streaming.process_buffer(
            spec, state, jnp.asarray(blocks[i]), spec.cfg.rx_buf_size + 1)
        for c in range(C):
            decoded[c] += [b for _, b in _decoded_frames(out, c)]
    return decoded


def phase_multichannel(seed: int, C: int, n_bufs: int):
    spec = _spec()
    blocks, streams = multichannel_streams(seed, C, n_bufs)
    t0 = time.perf_counter()
    decoded = decode_multichannel(spec, blocks)
    wall = time.perf_counter() - t0
    n = check_streams(decoded, streams, "multi-channel streaming")
    log(f"(e) streaming C={C} x {n_bufs} buffers: OK {n} frames, each "
        f"exactly once, byte-equal to planted truth; wall {secs(wall)} "
        f"(compile included)")
    return blocks, streams, decoded


# ---------------------------------------------------------------- (f) ----

def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis unavailable"
    return (f"args {m.argument_size_in_bytes / 2**20:.1f} MiB, "
            f"out {m.output_size_in_bytes / 2**20:.1f} MiB, "
            f"temp {m.temp_size_in_bytes / 2**20:.1f} MiB, "
            f"code {m.generated_code_size_in_bytes / 2**20:.1f} MiB")


def phase_memory(batch_compiled, B: int) -> None:
    from c_ofdm.models import streaming

    spec = _spec()
    buf = spec.cfg.rx_buf_size * spec.cfg.frame_len
    ring = streaming.process_buffer.lower(
        spec, streaming.init_state(spec), jnp.zeros(buf, jnp.complex64),
        spec.cfg.rx_buf_size + 1, "gated").compile()
    log(f"(f) compiled memory, batch step B={B}: {_mem(batch_compiled)}")
    log(f"(f) compiled memory, 41-frame ring step: {_mem(ring)}")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    log("(f) peak device memory in use: " + (
        f"{peak / 2**30:.3f} GiB [{CARD}]" if peak is not None
        else "not reported by this backend"))


# ----------------------------------------------------------- 4 cards ----

def sharded_streaming(seed: int, C: int, n_bufs: int, n_dev: int) -> int:
    """Channel-sharded continuous streaming over ``n_dev`` devices against
    the single-device process_buffer decode and planted truth."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from c_ofdm.models import streaming
    from c_ofdm.parallel.mesh import CHANNEL_AXIS, make_modem_mesh
    from c_ofdm.parallel.sharded import make_sharded_streaming

    spec = _spec()
    blocks, streams = multichannel_streams(seed, C, n_bufs)
    with jax.default_device(jax.devices()[0]):
        single = decode_multichannel(spec, blocks)
    check_streams(single, streams, "single-device streaming")

    mesh = make_modem_mesh(n_channel=n_dev, n_time=1)
    step = make_sharded_streaming(spec, mesh, spec.cfg.rx_buf_size + 1)
    shard = NamedSharding(mesh, P(CHANNEL_AXIS))
    state = jax.device_put(streaming.init_state(spec, channels=C), shard)
    decoded = [[] for _ in range(C)]
    t0 = time.perf_counter()
    for i in range(n_bufs):
        blk = jax.device_put(jnp.asarray(blocks[i]), shard)
        spread = len({s.device for s in blk.addressable_shards})
        check(spread == n_dev, f"block spread over {spread} devices")
        state, out = step(state, blk)
        for c in range(C):
            decoded[c] += [b for _, b in _decoded_frames(out, c)]
    wall = time.perf_counter() - t0
    spread = len(out.mac_bytes.sharding.device_set)
    check(spread == n_dev, f"outputs on {spread} devices")
    check(decoded == single, "sharded streaming != single-device decode")
    n = check_streams(decoded, streams, "sharded streaming")
    log(f"[4 cards] channel-sharded streaming C={C} ({C // n_dev} per card) "
        f"x {n_bufs} buffers: OK {n} frames == single-device decode == "
        f"planted truth; wall {secs(wall)} (compile included)")
    return n


def sharded_bulk(seed: int, n_dev: int, block_len: int) -> None:
    """Time-sharded bulk receiver on {channel:1, time:n_dev}."""
    from c_ofdm.parallel.mesh import make_modem_mesh

    spec = _spec()
    cfg = spec.cfg
    mesh = make_modem_mesh(n_channel=1, n_time=n_dev)
    total = n_dev * block_len
    # ~80% fill.  The planted gaps are nearly even, so the count decides
    # where frames fall: an even count at 40 frames per shard lays every
    # shard boundary inside a gap, an odd one puts frames across them
    n_frames_c = int(0.8 * total / cfg.frame_len) | 1
    captures, truth, wire = impaired_streams(spec, 2, total, n_frames_c,
                                             seed=seed)
    t0 = time.perf_counter()
    r = check_sharded_receiver(spec, mesh, captures, truth, wire,
                               max_frames_per_block=block_len
                               // cfg.frame_len + 2)
    wall = time.perf_counter() - t0
    log(f"[4 cards] time-sharded bulk receiver {{channel:1, time:{n_dev}}}, "
        f"{block_len} samples per shard, 2 streams: OK {r['found']}/"
        f"{r['planted']} frames (incl. {r['straddling']} across shard "
        f"boundaries) == single-device decode == planted truth, over "
        f"{r['devices']} devices; wall {secs(wall)} (compile included)")


# ----------------------------------------------------------------- main ----

def main(argv=None) -> int:
    global CARD
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chips", type=int, choices=(1, 4), default=1,
                   help="4: run only the sharded paths, on four cards")
    args = p.parse_args(argv)

    smi = nvidia_smi()
    log(f"nvidia-smi: {smi}")
    require_gpu()
    CARD = smi.splitlines()[0].strip()
    devs = jax.devices()
    if len(devs) < args.chips:
        raise SystemExit(f"chip_smoke: --chips {args.chips} needs "
                         f"{args.chips} GPUs; JAX sees {len(devs)}")

    from c_ofdm.ops.fft import PRECISION
    from c_ofdm.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    log(f"device_kind {devs[0].device_kind} x {len(devs)}, jax "
        f"{jax.__version__}, chain matmul precision {PRECISION.name}, "
        f"default {jax.config.jax_default_matmul_precision}, compile cache "
        f"{cache}")

    t0 = time.perf_counter()
    if args.chips == 4:
        buf = 40 * 6016
        sharded_streaming(args.seed, C=8, n_bufs=10, n_dev=4)
        sharded_bulk(args.seed, n_dev=4, block_len=buf)
    else:
        workdir = os.path.join(REPO, ".smoke_work")
        os.makedirs(workdir, exist_ok=True)
        try:
            phase_served(args.seed, n_bufs=40, workdir=workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        batch = phase_batch(args.seed, B=256)
        phase_oracle(args.seed)
        phase_wideband(args.seed, B=128)
        phase_multichannel(args.seed, C=8, n_bufs=10)
        phase_memory(batch, B=256)
    log(f"all phases OK in {secs(time.perf_counter() - t0)}")
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
