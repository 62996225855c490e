"""FrameSpec: every static constant of one modem configuration, precomputed.

The reference scatters this state across five mutable C++ objects wired by raw
pointers (`FRAME_FORM`, `OFDM/Frame.cpp:213-232`).  Here it is a single frozen
object of numpy constants; jitted functions close over it, so XLA bakes the
tables (constellations, index maps, matched filter, DFT rows) into the
executable as literals.  Batch-first, statically-shaped, functionally pure.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax.numpy as jnp

from ..config import ModemConfig
from ..ops import fft as fftops
from ..oracle import reference as oracle


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash, jit-static
class FrameSpec:
    cfg: ModemConfig
    dtype: Any                      # complex dtype of the device pipeline
    # subcarrier maps
    pilot_bins: np.ndarray          # [P] int32
    data_bins: np.ndarray           # [D] int32 (segment order)
    # constants
    t2_mask: np.ndarray             # [t2sin_size] float
    t2_burst: np.ndarray            # [t2sin_size] complex
    preamble_time: np.ndarray       # [preamble_len] complex (incl CP)
    preamble_points: np.ndarray     # [num_pr_symb * num_data_subc] complex
    matched_filter: np.ndarray      # [pr_sin_len] complex, unit norm, conjugated
    cfo_borders: np.ndarray         # [num_pilot_subc+2] int, pilot windows after fftshift
    cfo_window_mask: np.ndarray     # [num_pilot_subc+1] bool, True = use window
    fft_backend: str = "xla"        # "xla" | "matmul[_bf16]" | "ct[_bf16]"
    #                                   (symbol FFTs; ct = two-stage
    #                                   Cooley-Tukey matmuls, wideband path)

    @property
    def rdtype(self):
        return jnp.finfo(jnp.dtype(self.dtype)).dtype if jnp.dtype(
            self.dtype).kind == "c" else jnp.dtype(self.dtype)

    @property
    def real_dtype(self):
        return {np.dtype(np.complex64): np.float32,
                np.dtype(np.complex128): np.float64}[np.dtype(self.dtype)]


def _cfo_borders(cfg: ModemConfig):
    """Pilot-peak search windows in the fftshifted preamble spectrum
    (`OFDM/Frame.hpp:311-322`, with the out-of-bounds write replaced by a
    clamp of the true last border)."""
    size = cfg.preamble_len
    rel_bw = (cfg.num_data_subc + cfg.num_pilot_subc) / cfg.fft_size
    rel_pw = rel_bw / cfg.num_pilot_subc
    pw = int(size * rel_pw)
    j0 = int((1.0 - rel_bw - rel_pw) / 2.0 * size)
    borders = j0 + pw * np.arange(cfg.num_pilot_subc + 2)
    borders[0] = max(0, borders[0])
    borders[-1] = min(size, borders[-1])
    mask = np.ones(cfg.num_pilot_subc + 1, dtype=bool)
    mask[cfg.num_pilot_subc // 2] = False   # skip the DC window
    return borders, mask


def make_frame_spec(cfg: ModemConfig = None, dtype=jnp.complex64,
                    fft_backend: str = "xla") -> FrameSpec:
    if fft_backend not in fftops.FFT_BACKENDS:
        raise ValueError(f"unknown fft_backend {fft_backend!r}; "
                         f"expected one of {fftops.FFT_BACKENDS}")
    cfg = cfg or ModemConfig()
    pilots, data_bins = oracle.subcarrier_maps(cfg)
    borders, wmask = _cfo_borders(cfg)
    return FrameSpec(
        fft_backend=fft_backend,
        cfg=cfg,
        dtype=dtype,
        pilot_bins=pilots.astype(np.int32),
        data_bins=data_bins.astype(np.int32),
        t2_mask=oracle.t2_detect_mask(cfg),
        t2_burst=oracle.t2sin_burst(cfg),
        preamble_time=oracle.preamble_time(cfg),
        preamble_points=oracle.preamble_points(cfg),
        matched_filter=oracle.matched_filter(cfg),
        cfo_borders=borders,
        cfo_window_mask=wmask,
    )
