"""Ingest micro-benchmark — the reference ``st_rx`` binary's role
(`st_rx.cpp:43-114`): measure raw host ingest + int16 conversion throughput
through the native double-buffered ring, separately from device compute.

Usage: python -m c_ofdm.apps.ingest_bench [--buffers N] [--source PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--buffers", type=int, default=500)
    p.add_argument("--samples", type=int, default=246656,
                   help="complex samples per buffer (reference ring size)")
    p.add_argument("--source", default="",
                   help="file to replay (default synthetic)")
    p.add_argument("--to-device", action="store_true",
                   help="include host->device transfer")
    args = p.parse_args(argv)

    from c_ofdm.io.ingest import (NativeIngest, SRC_FILE_REPLAY,
                                      SRC_SYNTH_ZERO)

    kind = SRC_FILE_REPLAY if args.source else SRC_SYNTH_ZERO
    dev_put = None
    if args.to_device:
        import jax
        import jax.numpy as jnp
        dev_put = lambda x: jax.device_put(x).block_until_ready()  # noqa: E731

    with NativeIngest(kind, args.source, args.samples, 4) as ing:
        # warmup
        for _ in range(5):
            ing.pop_f32()
        t0 = time.perf_counter()
        for _ in range(args.buffers):
            buf = ing.pop_f32()
            if dev_put is not None:
                # ship interleaved f32 (the wire format)
                dev_put(buf.reshape(-1, 2))
        dt = time.perf_counter() - t0
        st = ing.stats()

    sps = args.buffers * args.samples / dt
    print(f"{args.buffers} buffers x {args.samples} samples in {dt:.3f}s; "
          f"producer_waits={st.producer_waits} consumer_waits={st.consumer_waits}",
          file=sys.stderr)
    print(json.dumps({
        "metric": "ingest_samples_per_s" + ("_to_device" if args.to_device else ""),
        "value": round(sps, 1),
        "unit": "samples/s",
        "vs_baseline": round(sps / (246656 / 0.0444), 3),  # ref SDR wall: 44.4ms/buffer
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
