"""Post-run artifact plots — the reference `python_code/ofdm.py` counterpart:
2x2 figure of capture magnitude, detect-correlation track, constellation, and
channel estimate, from the artifact directory written by apps.loopback.

Usage: python -m c_ofdm.apps.plots [--dir data] [--out ofdm.png]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", default="data")
    p.add_argument("--out", default="ofdm.png")
    args = p.parse_args(argv)

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available", file=sys.stderr)
        return 1

    from c_ofdm.io import binio

    fig, axs = plt.subplots(2, 2, figsize=(12, 8))
    axs = axs.flatten()

    def maybe(fname, fn):
        path = os.path.join(args.dir, fname)
        if os.path.exists(path):
            fn(path)

    def plot_capture(path):
        import numpy as np
        cap = binio.read_complex64f(path)
        axs[0].plot(np.abs(cap), lw=0.3)
        axs[0].set_title("capture magnitude")

    def plot_corr(path):
        corr = binio.read_doubles(path)
        axs[1].plot(corr)
        axs[1].set_title("t2 detect ratio track")

    def plot_constell(path):
        con = binio.read_complex64f(path)
        axs[2].scatter(con.real, con.imag, s=1)
        axs[2].set_title("equalized constellation")
        axs[2].set_aspect("equal")

    def plot_chan(path):
        import numpy as np
        ch = binio.read_complex64f(path)
        axs[3].plot(np.angle(ch), label="phase")
        axs[3].plot(np.abs(ch), label="abs")
        axs[3].set_title("channel estimate")
        axs[3].legend()

    maybe("data.bin", plot_capture)
    maybe("t2_sin_corr.bin", plot_corr)
    maybe("constell.bin", plot_constell)
    maybe("phases.bin", plot_chan)
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
