"""chip_smoke.py on the CPU: the device gate refuses to run, and every phase
is rehearsed at a tiny size with the gate bypassed (the full-size run needs
a GPU: ``python chip_smoke.py [--chips 4]``)."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("phase", ["served", "batch", "oracle", "wideband",
                                   "multichannel"])
def test_phase_rehearsal(phase, tmp_path):
    if phase == "served":
        chip_smoke.phase_served(0, n_bufs=2, workdir=str(tmp_path))
    elif phase == "batch":
        compiled = chip_smoke.phase_batch(0, B=4, iters=1)
        chip_smoke.phase_memory(compiled, B=4)
    elif phase == "oracle":
        chip_smoke.phase_oracle(0)
    elif phase == "wideband":
        chip_smoke.phase_wideband(0, B=2)
    else:
        chip_smoke.phase_multichannel(0, C=2, n_bufs=2)


@pytest.mark.parametrize("path", ["streaming", "bulk"])
def test_four_card_paths_on_virtual_devices(path, cfg):
    """The --chips 4 paths on 4 of the 8 virtual CPU devices."""
    if path == "streaming":
        n = chip_smoke.sharded_streaming(0, C=4, n_bufs=2, n_dev=4)
        assert n > 0
    else:
        chip_smoke.sharded_bulk(0, n_dev=4, block_len=3 * cfg.frame_len)


@pytest.mark.gpu
def test_phases_on_card(gpu, tmp_path):
    """Small-size phases on a real GPU (run with ``-m gpu`` on the card)."""
    chip_smoke.phase_served(1, n_bufs=2, workdir=str(tmp_path))
    chip_smoke.phase_batch(1, B=16, iters=2)
    chip_smoke.phase_oracle(1)
