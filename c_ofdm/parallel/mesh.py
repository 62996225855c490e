"""Device mesh construction for the modem's two parallel axes.

The reference has no multi-device story (one pthread + two semaphores,
`rx.cpp:55-66`); scale-out here is green-field design, with no
topology assumptions (any device list reshapes into the mesh):

* ``channel`` — independent OFDM streams (pure data parallelism, no comms);
* ``time``   — long captures split into contiguous blocks per device, with a
  one-frame overlap-save halo passed left via ``ppermute`` (the distributed
  form of the reference's carry-over memcpy, `rx.cpp:147-156`).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


def make_modem_mesh(n_channel: int = 1, n_time: int = 0,
                    devices=None) -> Mesh:
    """Build a {channel, time} mesh.  ``n_time`` defaults to filling all
    remaining devices."""
    devices = devices if devices is not None else jax.devices()
    total = len(devices)
    if n_time == 0:
        if total % n_channel:
            raise ValueError(f"{total} devices not divisible by n_channel={n_channel}")
        n_time = total // n_channel
    need = n_channel * n_time
    if need > total:
        raise ValueError(f"need {need} devices, have {total}")
    arr = np.asarray(devices[:need]).reshape(n_channel, n_time)
    return Mesh(arr, (CHANNEL_AXIS, TIME_AXIS))
