"""Test environment: CPU backend with 8 virtual devices (sharding tests run
without a multi-device machine) and x64 enabled (float64 golden-parity
oracles).  Tests that need a GPU take the ``gpu`` fixture and are marked
``gpu``; they skip on the CPU with a reason and run on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from c_ofdm.utils.compile_cache import enable_compile_cache  # noqa: E402

# the suite is compile-dominated on CPU
enable_compile_cache(min_compile_secs=0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REF = "/root/reference"


def _golden(rel: str) -> str:
    """Path of a golden artifact of the C++ reference; skips the test when
    the reference snapshot is not present."""
    path = os.path.join(REF, rel)
    if not os.path.exists(path):
        pytest.skip(f"golden artifact {rel} of the C++ reference is not "
                    f"available")
    return path


@pytest.fixture
def golden():
    """``golden(rel)`` -> path of a reference artifact, or skip."""
    return _golden


@pytest.fixture
def gpu():
    """The first GPU device; skips when JAX sees none (the suite runs on the
    CPU — on-card checks run through ``python chip_smoke.py``)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU; this run has CPU devices only")
    return devs[0]


@pytest.fixture(scope="session")
def ref_capture():
    d = np.fromfile(_golden("data/data.bin"), dtype=np.float64)
    return d[::2] + 1j * d[1::2]


@pytest.fixture(scope="session")
def ref_source_int16():
    return np.fromfile(_golden("data/source.bin"), dtype=np.int16)


@pytest.fixture(scope="session")
def ref_constell():
    d = np.fromfile(_golden("data/constell.bin"), dtype=np.float64)
    return d[::2] + 1j * d[1::2]


@pytest.fixture(scope="session")
def ref_phases():
    d = np.fromfile(_golden("data/phases.bin"), dtype=np.float64)
    return d[::2] + 1j * d[1::2]


@pytest.fixture(scope="session")
def ref_t2_corr():
    return np.fromfile(_golden("data/t2_sin_corr.bin"), dtype=np.float64)


@pytest.fixture(scope="session")
def ref_decoded_text():
    with open(_golden("data.txt"), "rb") as f:
        return f.read()


@pytest.fixture(scope="session")
def cfg():
    from c_ofdm.config import ModemConfig
    return ModemConfig()


@pytest.fixture(scope="session")
def spec64(cfg):
    """complex64 spec — the accelerator production dtype."""
    import jax.numpy as jnp
    from c_ofdm.models.frame import make_frame_spec
    return make_frame_spec(cfg, dtype=jnp.complex64)


@pytest.fixture(scope="session")
def spec128(cfg):
    """complex128 spec — golden-parity validation on CPU."""
    import jax.numpy as jnp
    from c_ofdm.models.frame import make_frame_spec
    return make_frame_spec(cfg, dtype=jnp.complex128)
