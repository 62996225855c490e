"""c_ofdm — an accelerator-native OFDM modem framework in JAX.

Brand-new implementation of the C-OFDM reference modem's capabilities
(see SURVEY.md at the repo root), designed batch-first and statically shaped:
XLA matmul and FFT kernels for the hot DSP, shard_map over {channel, time}
meshes for scale-out.
"""

from .config import (ModemConfig, load_config, REFERENCE_CONFIG,  # noqa: F401
                     WIDEBAND_8K)
from .models.frame import FrameSpec, make_frame_spec            # noqa: F401

__version__ = "0.1.0"
