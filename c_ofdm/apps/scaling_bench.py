"""Scaling benchmark: sharded bulk receiver across {channel, time} mesh sizes.

Measures samples/s of the sharded receiver at 1..N devices and reports
scaling efficiency vs the 1-device run.  On several GPUs this is the real
scale-out number; without them it runs on the
virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=N) as the
CI proxy that exercises identical shardings and collectives.

Usage: python -m c_ofdm.apps.scaling_bench [--devices 8] [--cpu]
       [--frames-per-block 4] [--channels 1]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--devices", type=int, default=0,
                   help="max devices (default: all)")
    p.add_argument("--cpu", action="store_true",
                   help="force the virtual CPU mesh")
    p.add_argument("--channels", type=int, default=1)
    p.add_argument("--frames-per-block", type=int, default=4)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)

    import os
    if args.cpu and "xla_force_host_platform_device_count" not in \
            os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   f" --xla_force_host_platform_device_count="
                                   f"{args.devices or 8}").strip()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from c_ofdm import ModemConfig, make_frame_spec
    from c_ofdm.mac.mac import Mac
    from c_ofdm.models import tx as txm
    from c_ofdm.parallel.mesh import make_modem_mesh
    from c_ofdm.parallel.sharded import make_sharded_receiver
    from c_ofdm.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    spec = make_frame_spec(ModemConfig(), dtype=jnp.complex64)
    cfg = spec.cfg
    n_dev_total = args.devices or len(jax.devices())

    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(0)
    block_len = args.frames_per_block * cfg.frame_len

    def build_capture(n_time):
        total = n_time * block_len
        payloads = rng.integers(0, 256, (args.channels, mac.payload),
                                dtype=np.uint8)
        wire = mac.write(jnp.asarray(payloads),
                         jnp.arange(args.channels, dtype=jnp.uint32))
        frame = np.asarray(txm.transmit(spec, wire))
        cap = np.zeros((args.channels, total), dtype=np.complex64)
        for c in range(args.channels):
            for b in range(n_time):
                s = b * block_len + 97
                cap[c, s:s + cfg.frame_len] = frame[c]
        return cap

    results = {}
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev_total]
    for n_time in sizes:
        mesh = make_modem_mesh(n_channel=1, n_time=n_time,
                               devices=jax.devices()[:n_time])
        recv = make_sharded_receiver(spec, mesh,
                                     max_frames_per_block=args.frames_per_block)
        cap = build_capture(n_time)
        total = cap.shape[-1] * args.channels
        out = recv(jnp.asarray(cap))          # compile + correctness
        found = int(np.asarray(out.num_found).sum())
        assert found == args.channels * n_time, (found, n_time)
        best = float("inf")
        for r in range(args.reps):
            capr = cap * np.complex64(1.0 + 1e-6 * r)   # distinct inputs
            x = jnp.asarray(capr)
            x.block_until_ready()
            t0 = time.perf_counter()
            o = recv(x)
            s = float(np.asarray(o.num_found).sum())    # forced readback
            best = min(best, time.perf_counter() - t0)
        results[n_time] = total / best
        print(f"n_time={n_time}: {results[n_time]/1e6:.1f} Msamples/s "
              f"({found} frames)", file=sys.stderr)

    base = results[sizes[0]]
    eff = {n: results[n] / (base * n / sizes[0]) for n in sizes}
    print(json.dumps({
        "metric": "sharded_rx_scaling",
        "samples_per_s": {str(n): round(results[n], 1) for n in sizes},
        "efficiency_vs_linear": {str(n): round(eff[n], 3) for n in sizes},
        "devices": sizes,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
