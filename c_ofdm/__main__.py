"""Unified CLI: ``python -m c_ofdm <app> [args...]``.

The reference ships four binaries (``main``/``tx``/``rx``/``st_rx``,
Makefile:27-38); here every app is a subcommand of one entry point.  Each app
module is also directly runnable (``python -m c_ofdm.apps.<name>``).
"""

from __future__ import annotations

import importlib
import sys

APPS = {
    "loopback": ("apps.loopback", "single-frame TX->channel->RX validator (main.cpp)"),
    "tx": ("apps.txstream", "streaming transmitter (tx.cpp)"),
    "rx": ("apps.rxstream", "streaming receiver (rx.cpp)"),
    "ingest-bench": ("apps.ingest_bench", "host ingest microbenchmark (st_rx.cpp)"),
    "ber-sweep": ("apps.ber_sweep", "BER/EVM vs SNR sweep"),
    "plots": ("apps.plots", "post-run artifact plots (python_code/ofdm.py)"),
    "dashboard": ("apps.dashboard", "live metrics dashboard (frame_pipe.py)"),
    "scaling-bench": ("apps.scaling_bench", "sharded receiver scaling benchmark"),
}


def _usage() -> str:
    lines = ["usage: python -m c_ofdm <app> [args...]", "", "apps:"]
    lines += [f"  {name:<14} {desc}" for name, (_, desc) in APPS.items()]
    lines.append("\nper-app help: python -m c_ofdm <app> --help")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    name, rest = argv[0], argv[1:]
    if name not in APPS:
        print(f"unknown app: {name!r}\n\n{_usage()}", file=sys.stderr)
        return 2
    mod = importlib.import_module(f"c_ofdm.{APPS[name][0]}")
    return mod.main(rest) or 0


if __name__ == "__main__":
    sys.exit(main())
