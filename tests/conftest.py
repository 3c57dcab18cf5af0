"""Test configuration: force an 8-device virtual CPU mesh.

The tests run on the CPU (run them with ``JAX_PLATFORMS=cpu``; this file also
pins the platform) with 8 virtual devices, so sharding code paths are
exercised without a multi-card host. Setting XLA_FLAGS and jax_platforms
here works because no backend has been initialised yet at conftest time.
The GPU is exercised by ``chip_smoke.py`` instead (README, "Testing").
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu_mesh():
    assert jax.default_backend() == "cpu"
    assert jax.device_count() == 8, jax.devices()


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def make_random_fasta(path, rng, n_records=3, lengths=(50, 200, 120), n_rate=0.05,
                      line_width=17, gzip_out=False, with_n=True):
    """Random-sequence fixture with Ns, lowercase, odd line widths."""
    import gzip as _gzip

    if with_n:
        alphabet = np.array(list("ACGTacgtN"), dtype="U1")
        probs = np.array([1, 1, 1, 1, 0.3, 0.3, 0.3, 0.3, 0.6])
    else:
        alphabet = np.array(list("ACGTacgt"), dtype="U1")
        probs = np.array([1, 1, 1, 1, 0.3, 0.3, 0.3, 0.3])
    probs = probs / probs.sum()
    out = []
    for i in range(n_records):
        n = lengths[i % len(lengths)]
        seq = "".join(rng.choice(alphabet, size=n, p=probs))
        out.append(f">rec-{i} desc text\n")
        for j in range(0, n, line_width):
            out.append(seq[j : j + line_width] + "\n")
    data = "".join(out)
    if gzip_out:
        with _gzip.open(path, "wt") as fh:
            fh.write(data)
    else:
        with open(path, "wt") as fh:
            fh.write(data)
    return path
