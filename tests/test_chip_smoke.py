"""chip_smoke.py refuses to run without a GPU; its checks run on the card."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(cwd, script):
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, capture_output=True,
        text=True, timeout=300,
    )


def test_cpu_only_prints_not_ok_and_fails():
    out = _run(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is False
    assert last["device"]["platform"] == "cpu"


@pytest.mark.gpu
def test_edt_on_gpu_matches_scipy(gpu_device):
    """Phase 5 of chip_smoke.py as a test (skips without a card)."""
    import jax
    import jax.numpy as jnp
    import scipy.ndimage as ndi

    from cube_slam_wu_tpu.ops import image as image_ops

    edge = np.random.default_rng(0).random((480, 640)) < 0.01
    with jax.default_device(gpu_device):
        ours = np.asarray(image_ops.distance_transform(jnp.asarray(edge)))
    assert np.abs(ours - ndi.distance_transform_edt(~edge)).max() <= 1e-3
