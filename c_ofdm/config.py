"""Typed modem configuration with the reference's key names and derived geometry.

Mirrors the semantics of the reference config system (`config/parser.cpp:4-33`,
`config/config.txt:1-32`): integer ``key = value`` pairs, ``#`` comments, and the
fixed-point x1000 convention for fractional values (``pr_level``, ``T2_sin_level``,
``pilot_ampl`` — `OFDM/Frame.cpp:105,172,261`).  Unlike the reference, the config is
validated at construction (the reference silently assumes divisibility at
`OFDM/Frame.cpp:9` and has a latent border-indexing bug at `OFDM/Frame.hpp:311-322`).

All shapes derived here are static: under ``jax.jit`` they are trace-time constants.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ModemConfig:
    """Static geometry + thresholds of one OFDM stream."""

    # --- subcarrier geometry ---
    fft_size: int = 512
    num_data_subc: int = 256
    num_pilot_subc: int = 8
    cp_size: int = 128

    num_symb: int = 8            # data symbols / frame
    num_pr_symb: int = 1         # preamble symbols / frame

    # --- preamble / sync ---
    pr_sin_len: int = 128        # matched-filter length (first samples of preamble CP)
    pr_seed: int = 42            # MT19937 seed for preamble bytes
    pr_level: float = 0.5        # preamble correlation threshold (x1000 in file)

    # --- two-tone detect burst ---
    t2sin_size: int = 256
    t2_sin_f1: int = 17
    t2_sin_f2: int = 51
    t2_sin_level: float = 0.8    # detect energy-ratio threshold (x1000 in file)
    smooth: int = 5              # half-width of the detect mask around each tone

    # --- modulation ---
    mod_type: int = 4            # bits/symbol: 1=BPSK 2=QAM4 4=QAM16 6=QAM64 8=QAM256
    pilot_ampl: float = 2.5      # TX pilot amplitude (x1000 in file)

    # --- RX robustness (new vs reference) ---
    cfo_outlier_bins: int = 6    # coarse-CFO per-window outlier rejection
    #                              tolerance (spectrum bins); 0 = exact
    #                              reference mean-of-argmax semantics
    t2_gate_level: Optional[float] = None  # streaming sync gate: relaxed detect-ratio
    #                              threshold for the overlapping-window t2
    #                              track that gates the matched filter (the
    #                              confirm threshold stays pr_level); must sit
    #                              below t2_sin_level to cover window-burst
    #                              misalignment (worst case ~3/4 overlap).
    #                              None (default) tracks the detect threshold:
    #                              min(0.4, t2_sin_level / 2) — so low-SNR
    #                              configs (T2_sin_level < 400) stay valid
    #                              without a file key, and the gate is always
    #                              a true relaxation of the detect level.
    sync_peak_refine: Optional[bool] = None  # preamble timing = local MF
    #                              peak instead of threshold-crossing + 1.
    #                              The reference's empirical +1 (`rx.cpp:158`)
    #                              is calibrated for pr_level=0.5, where the
    #                              crossing lands one lag BEFORE the peak; at
    #                              raised thresholds the crossing lands ON
    #                              the peak and a blind +1 syncs one sample
    #                              late (non-cyclic FFT windows -> QAM64+
    #                              corner errors — round-4 geometry-sweep
    #                              find).  None (default) = auto: refine
    #                              exactly when pr_level > 0.55, so stock
    #                              configs keep bit-exact reference position
    #                              parity on the golden artifacts (preamble
    #                              11040) and raised-threshold configs get
    #                              correct peak timing.
    t2_gate_slack: int = 8       # extra gate-edge candidates beyond
    #                              max_frames in the gated streaming sync:
    #                              spurious rising edges (interference, noise
    #                              near t2_gate_level) occupy candidate slots;
    #                              more than this many between real frames
    #                              would evict real candidates.  Each unit
    #                              costs one extra ~G-lag matched-filter
    #                              region per buffer (cheap).

    # --- radio / staging (kept for config-file compatibility; no radio here) ---
    bw_hz: int = 10_000_000
    fs_hz: int = 5_000_000
    lo_hz: int = 2_800_000_000
    hardwaregain: int = 50
    mult: int = 200              # float -> int16 staging scale
    rx_buf_size: int = 40        # frames per ingest buffer (ring = rx_buf_size+1)
    tx_cycle_buf: int = 0
    tx_time_int: int = 0
    iterations: int = 10_000

    def __post_init__(self):
        # remember whether the gate was auto-derived so to_dict can export
        # the -1 auto sentinel instead of freezing the resolved value on a
        # file round-trip (mirrors sync_peak_refine; note dataclasses.replace
        # reconstructs from the resolved field and pins the value — pass
        # t2_gate_level=None explicitly to keep the auto rule there)
        object.__setattr__(self, "_t2_gate_auto", self.t2_gate_level is None)
        if self.t2_gate_level is None:
            object.__setattr__(self, "t2_gate_level",
                               min(0.4, self.t2_sin_level / 2))
        if self.t2_gate_level == self.t2_sin_level:
            # round-4 tightened the bound from <= to <; keep pre-existing
            # gate-at-detect-level config files loading (they were valid
            # then) by clamping just below with a warning instead of raising
            import warnings
            warnings.warn(
                "t2_gate_level == t2_sin_level: the gate must be a strict "
                "relaxation of the detect level (overlapping gate windows "
                "see at worst ~3/4 of a burst's energy); clamping to "
                "0.999 * t2_sin_level", stacklevel=2)
            object.__setattr__(self, "t2_gate_level",
                               0.999 * self.t2_sin_level)
        if self.num_data_subc % self.num_pilot_subc:
            raise ValueError(
                f"num_data_subc ({self.num_data_subc}) must be divisible by "
                f"num_pilot_subc ({self.num_pilot_subc})")
        if self.num_pilot_subc % 2:
            raise ValueError("num_pilot_subc must be even (half-band split layout)")
        occupied = self.num_data_subc + self.num_pilot_subc
        if occupied >= self.fft_size:
            raise ValueError("data+pilot subcarriers must fit below fft_size (guard band)")
        if self.mod_type not in (1, 2, 4, 6, 8):
            raise ValueError(f"unsupported mod_type {self.mod_type}")
        if self.pr_sin_len > self.ofdm_len:
            raise ValueError("pr_sin_len must fit inside one OFDM symbol")
        if (self.num_data_subc * self.num_symb * self.mod_type) % 8:
            raise ValueError("frame payload must be a whole number of bytes")
        if not 0.0 < self.t2_gate_level < self.t2_sin_level:
            raise ValueError(
                f"t2_gate_level ({self.t2_gate_level}) must be in "
                f"(0, t2_sin_level={self.t2_sin_level}) — strictly below the "
                f"detect level, because the overlapping gate windows see at "
                f"worst ~3/4 of a burst's energy; a gate at or above the "
                f"detect level silently breaks the 'gate is a relaxation' "
                f"invariant")

    @property
    def peak_refine(self) -> bool:
        """Effective sync_peak_refine (None resolves to pr_level > 0.55)."""
        if self.sync_peak_refine is None:
            return self.pr_level > 0.55
        return self.sync_peak_refine

    # ---- derived geometry (reference: OFDM/Frame.cpp:4-29,157-232) ----

    @property
    def segment_step(self) -> int:
        return self.num_data_subc // self.num_pilot_subc + 1

    @property
    def segment_size(self) -> int:
        return self.segment_step - 1

    @property
    def ofdm_len(self) -> int:
        """One OFDM symbol incl. cyclic prefix."""
        return self.fft_size + self.cp_size

    @property
    def preamble_len(self) -> int:
        return self.ofdm_len * self.num_pr_symb

    @property
    def message_len(self) -> int:
        return self.ofdm_len * self.num_symb

    @property
    def frame_len(self) -> int:
        """Samples per frame: burst + preamble + message (= 6016 @ defaults)."""
        return self.t2sin_size + self.preamble_len + self.message_len

    @property
    def frame_bytes(self) -> int:
        """MAC-frame bytes carried per frame (= 1024 @ defaults)."""
        return self.num_data_subc * self.num_symb * self.mod_type // 8

    @property
    def preamble_bytes(self) -> int:
        """Preamble is always BPSK over its data subcarriers."""
        return self.num_data_subc * self.num_pr_symb // 8

    @property
    def ring_len(self) -> int:
        """Ingest ring: rx_buf_size frames + one carry-over frame."""
        return self.frame_len * (self.rx_buf_size + 1)

    @property
    def sync_window(self) -> int:
        """Preamble-search lags after a detect hit (reference cor size,
        `OFDM/Frame.cpp:266`)."""
        return self.t2sin_size * 2 + self.pr_sin_len

    @property
    def num_t2_blocks_ring(self) -> int:
        return self.ring_len // self.t2sin_size

    @property
    def gated_search_lags(self) -> int:
        """Matched-filter lags searched per gate candidate in the gated
        streaming sync (models/streaming.gated_hits).  The candidate region
        starts one hop (= t2sin_size/2) before the first hot window, and the
        first hot window starts within +-hop of the burst start, so the
        preamble lag (burst start + t2sin_size) lies within
        [t2sin_size - ... , 2*t2sin_size] of the region start; the extra
        hop + pr_sin_len is coverage margin.  Rounded up to the 128-lane
        width.  (= 768 at the reference geometry.)"""
        raw = 2 * self.t2sin_size + self.t2sin_size // 2 + self.pr_sin_len
        return -(-raw // 128) * 128

    def to_dict(self) -> Dict[str, int]:
        """Reference-file representation (x1000 fixed point where applicable)."""
        return {
            "fft_size": self.fft_size,
            "num_data_subc": self.num_data_subc,
            "num_pilot_subc": self.num_pilot_subc,
            "cp_size": self.cp_size,
            "num_symb": self.num_symb,
            "num_pr_symb": self.num_pr_symb,
            "pr_sin_len": self.pr_sin_len,
            "pr_seed": self.pr_seed,
            "pr_level": round(self.pr_level * 1000),
            "T2sin_size": self.t2sin_size,
            "T2_sin_f1": self.t2_sin_f1,
            "T2_sin_f2": self.t2_sin_f2,
            "T2_sin_level": round(self.t2_sin_level * 1000),
            # -1 = auto (min(0.4, detect/2) rule): exporting the RESOLVED
            # gate would freeze the auto rule — a round-tripped file whose
            # T2_sin_level is later lowered would then fail the
            # gate-below-detect validation instead of re-deriving
            "T2_gate_level": (-1 if getattr(self, "_t2_gate_auto", False)
                              else round(self.t2_gate_level * 1000)),
            "T2_gate_slack": self.t2_gate_slack,
            # -1 = auto (pr_level rule); 0/1 pin the choice — exporting
            # the RESOLVED value would silently freeze the auto rule on a
            # file round-trip
            "sync_peak_refine": (-1 if self.sync_peak_refine is None
                                 else int(self.sync_peak_refine)),
            "smooth": self.smooth,
            "modType": self.mod_type,
            "pilot_ampl": round(self.pilot_ampl * 1000),
            "bw_hz": self.bw_hz,
            "fs_hz": self.fs_hz,
            "lo_hz": self.lo_hz,
            "hardwaregain": self.hardwaregain,
            "mult": self.mult,
            "rx_buf_size": self.rx_buf_size,
            "tx_cycle_buf": self.tx_cycle_buf,
            "tx_time_int": self.tx_time_int,
            "iterations": self.iterations,
        }


_KEY_MAP = {
    "fft_size": "fft_size",
    "num_data_subc": "num_data_subc",
    "num_pilot_subc": "num_pilot_subc",
    "cp_size": "cp_size",
    "num_symb": "num_symb",
    "num_pr_symb": "num_pr_symb",
    "pr_sin_len": "pr_sin_len",
    "pr_seed": "pr_seed",
    "T2sin_size": "t2sin_size",
    "T2_sin_f1": "t2_sin_f1",
    "T2_sin_f2": "t2_sin_f2",
    "T2_gate_slack": "t2_gate_slack",
    # (sync_peak_refine is handled by its own sentinel branch in
    # load_config, BEFORE the _KEY_MAP lookup — keeping an entry here
    # would be dead code that turns the -1 auto sentinel into True if the
    # branches were ever reordered)
    "smooth": "smooth",
    "modType": "mod_type",
    "bw_hz": "bw_hz",
    "fs_hz": "fs_hz",
    "lo_hz": "lo_hz",
    "hardwaregain": "hardwaregain",
    "mult": "mult",
    "rx_buf_size": "rx_buf_size",
    "tx_cycle_buf": "tx_cycle_buf",
    "tx_time_int": "tx_time_int",
    "iterations": "iterations",
}
_FIXED_POINT_KEYS = {"pr_level": "pr_level", "T2_sin_level": "t2_sin_level",
                     "T2_gate_level": "t2_gate_level",
                     "pilot_ampl": "pilot_ampl"}


def parse_config_text(text: str) -> Dict[str, int]:
    """Parse reference ``key = value`` text (parser.cpp:11-31 semantics)."""
    out: Dict[str, int] = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or "=" not in line:
            continue
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip()
        if key and val:
            out[key] = int(val, 0)
    return out


def load_config(path: str) -> ModemConfig:
    """Load a reference-format config file into a validated ModemConfig."""
    with open(path, "r") as f:
        raw = parse_config_text(f.read())
    kwargs = {}
    for file_key, value in raw.items():
        if file_key in _FIXED_POINT_KEYS:
            if file_key == "T2_gate_level" and value < 0:
                continue                     # -1 sentinel = auto-derive
            kwargs[_FIXED_POINT_KEYS[file_key]] = value / 1000.0
        elif file_key == "sync_peak_refine":
            kwargs["sync_peak_refine"] = None if value < 0 else bool(value)
        elif file_key in _KEY_MAP:
            kwargs[_KEY_MAP[file_key]] = value
        # unknown keys are ignored, matching the reference's tolerant parser
    return ModemConfig(**kwargs)


REFERENCE_CONFIG = ModemConfig()

# BASELINE config #3's largest geometry: 8k-FFT QAM64 wideband
WIDEBAND_8K = dict(fft_size=8192, num_data_subc=4096, num_pilot_subc=32,
                   cp_size=1024, num_symb=2, pr_sin_len=512, mod_type=6)
