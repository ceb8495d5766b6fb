"""Test configuration: force CPU backend with 8 virtual devices.

Tests always run on the CPU (multi-device sharding on a virtual CPU mesh);
the GPU path is exercised on the card by chip_smoke.py.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

REFERENCE_ROOT = pathlib.Path("/root/reference")
REFERENCE_INPUTS = REFERENCE_ROOT / "go" / "src" / "test" / "inputs"


@pytest.fixture(scope="session")
def reference_inputs():
    if not REFERENCE_INPUTS.exists():
        pytest.skip("reference test inputs not available")
    return REFERENCE_INPUTS


@pytest.fixture(scope="session")
def phix_fasta(reference_inputs):
    p = reference_inputs / "phix" / "PhiX.fa"
    if not p.exists():
        pytest.skip("PhiX fixture not available")
    return p
