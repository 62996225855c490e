"""Loopback validator app — the reference ``main`` binary's role
(`main.cpp:21-113`): one frame TX -> channel -> RX with artifact dumps and
accuracy report.  Hardware is replaced by the channel simulator or file replay.

Usage:
  python -m c_ofdm.apps.loopback                 # simulated channel
  python -m c_ofdm.apps.loopback --replay PATH   # replay a capture (.bin)
  python -m c_ofdm.apps.loopback --dump DIR      # write golden artifacts
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import jax
import jax.numpy as jnp


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="", help="reference-format config file")
    p.add_argument("--replay", default="", help="replay capture .bin (f64 IQ)")
    p.add_argument("--payload", default="",
                   help="payload file (default: built-in deterministic text)")
    p.add_argument("--dump", default="", help="artifact output dir")
    p.add_argument("--snr-db", type=float, default=25.0)
    p.add_argument("--cfo", type=float, default=2e-4)
    p.add_argument("--timing", type=int, default=3000)
    p.add_argument("--f64", action="store_true", help="complex128 (CPU)")
    args = p.parse_args(argv)

    if args.f64:
        # complex128 golden-parity runs on the CPU
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from c_ofdm import ModemConfig, load_config, make_frame_spec
    from c_ofdm.channel.sim import ChannelParams, apply_channel
    from c_ofdm.io import binio
    from c_ofdm.io.trace import link_metrics
    from c_ofdm.mac.mac import Mac
    from c_ofdm.models import rx as rxm
    from c_ofdm.models import tx as txm
    from c_ofdm.ops import sync as syncops
    from c_ofdm.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    cfg = load_config(args.config) if args.config else ModemConfig()
    dtype = jnp.complex128 if args.f64 else jnp.complex64
    spec = make_frame_spec(cfg, dtype=dtype)
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)

    if args.payload:
        with open(args.payload, "rb") as f:
            origin = np.frombuffer(f.read(mac.payload), dtype=np.uint8)
    else:
        text = (b"Well, Prince, so Genoa and Lucca are now just family "
                b"estates of the Buonapartes. ") * 64
        origin = np.frombuffer(text[:mac.payload], dtype=np.uint8)
    origin = np.pad(origin, (0, mac.payload - origin.size))

    wire = mac.write(jnp.asarray(origin), jnp.uint32(0))
    frame = txm.transmit(spec, wire)
    tx_i16 = np.asarray(txm.to_int16(spec, frame))

    if args.replay:
        capture = jnp.asarray(binio.read_complex64f(args.replay).astype(
            np.complex128 if args.f64 else np.complex64))
    else:
        params = ChannelParams(snr_db=args.snr_db, cfo=args.cfo,
                               timing_offset=args.timing,
                               capture_len=cfg.ring_len,
                               quantize_mult=cfg.mult, amplitude=80.0)
        capture = apply_channel(params, jax.random.PRNGKey(0), frame)

    res, s = rxm.receive_capture_jit(spec, capture)
    if not bool(np.asarray(s.found)):
        print("NO FRAME DETECTED", file=sys.stderr)
        return 1

    decoded = mac.read_soft(res.constellation.real + res.constellation.imag)
    payload = np.asarray(decoded.payload)

    t2_track = np.asarray(syncops.t2_ratio_track(spec, capture, backend="fft"))
    t2_corr = np.where(t2_track > cfg.t2_sin_level, t2_track, 0.0)

    if args.dump:
        binio.dump_rx_artifacts(
            args.dump, capture=np.asarray(capture), t2_corr=t2_corr,
            chan_est=np.asarray(res.chan_est),
            constellation=np.asarray(res.constellation), tx_int16=tx_i16)

    byte_acc = float((payload == origin).mean())
    bit_acc = 1.0 - np.unpackbits(payload ^ origin).mean()
    m = link_metrics(res.constellation, cfg.mod_type)
    print(f"FRAME FROM {int(np.asarray(decoded.tx_id))} "
          f"TO {int(np.asarray(decoded.rx_id))} "
          f"SEQ {int(np.asarray(decoded.seq))} "
          f"CRC {'OK' if bool(np.asarray(decoded.valid)) else 'BAD'}")
    print(f"t2_begin {int(np.asarray(s.t2_begin))}  "
          f"pr_begin {int(np.asarray(s.pr_begin))}  "
          f"cfo {float(np.asarray(res.cfo)):+.6f}")
    print(f"ACCURACY: {byte_acc}")
    print(f"Bit-level ACCURACY: {bit_acc}")
    print(f"EVM: {m['evm_rms']*100:.2f}% rms ({m['evm_db']:.1f} dB)")
    return 0 if byte_acc == 1.0 else 2


if __name__ == "__main__":
    sys.exit(main())
