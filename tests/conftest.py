"""Test harness configuration.

Tests run on the CPU, on a virtual 8-device mesh so multi-device sharding
paths are exercised without several cards (see SURVEY.md section 4).  x64 is
enabled to match the reference's double-precision semantics in golden-value
tests; the accelerator path itself is float32 (exercised via explicit casts
in the f32-marked tests, and on a GPU by chip_smoke.py).  Tests marked `gpu`
need a card; they take the `gpu_device` fixture, which skips them here.
"""

import os

# Force CPU, also for subprocesses (the env var) and for a JAX that was
# configured before this file ran (the jax.config update below).
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pathlib  # noqa: E402

import pytest  # noqa: E402

REFERENCE_ROOT = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_root() -> pathlib.Path:
    if not REFERENCE_ROOT.exists():
        pytest.skip("reference dataset not mounted at /root/reference")
    return REFERENCE_ROOT


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: the suite pins JAX to the CPU, so GPU
    checks run on the card through chip_smoke.py."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run chip_smoke.py on the card)")
    return gpus[0]


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="also run tests marked slow (e2e SLAM runs, heavy BA suites)",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow test: pass --runslow to include")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


# Modules whose compiles are large enough to push the process toward the
# XLA:CPU compiler-state abort (see below) even in the fast suite — the
# round-5 suite aborted at ~92% with every module green standalone.
_HEAVY_MODULES = (
    "test_online_fused",
    "test_online_slam",
    "test_online_full",
    "test_offline_slam",
    "test_pipelined_frontend",
    "test_kitti",
    "test_point_window",
    "test_sharded_ba",
    "test_sharded_proposal",
    "test_ref_oracle_parity",
    "test_wu_fixture",
)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_slow_modules(request):
    """Bound XLA compiler-state accumulation in one long pytest process.

    Running the full slow suite (41 e2e tests) in ONE process segfaults
    deterministically inside XLA:CPU `backend_compile_and_load` at the
    ~26th test (2026-08-19, jax 0.8.x; 125 GB RAM free, so not OOM); every
    sub-chunk of the same tests passes.  Round 5 reproduced the same abort
    in the grown FAST suite (~92%, all modules green standalone).
    Dropping compiled executables between modules keeps per-process
    compiler state at chunk scale: under --runslow after every module,
    in the fast suite after the heavyweight e2e modules only (the rest
    rely on cross-module tracing caches for runtime).
    """
    yield
    if request.config.getoption("--runslow"):
        jax.clear_caches()
    elif any(m in str(request.node.name) for m in _HEAVY_MODULES):
        jax.clear_caches()
