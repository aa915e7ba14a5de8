"""Shared set-up of the PyTorch-port tests (tests/test_torch_*.py).

Imported by every port test file: it pins torch to one thread (tier-1
runs pytest-xdist with several workers, each holding JAX and torch) and
builds the same inputs for both packages from __graft_entry__'s synthetic
linear data.  Data moves between the frameworks only as numpy arrays.

JAX is imported only by `jax_batch`, so the kernel tests
(tests/test_torch_kernels.py) also run on a GPU machine without JAX.
`deadline` is the time limit of the worker tests' waits
(tests/test_torch_sharding.py, tests/test_torch_overlap.py).
"""

from __future__ import annotations

import contextlib
import os
import signal

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from redtime_tpu_torch import state  # noqa: E402


def jax_batch(n: int, cfg, nu: bool = True):
    """(cosmos, lins): n stacked JAX cosmologies _cosmo(0..n-1) and n
    copies of the example linear inputs."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _cosmo, _example_inputs

    lin = _example_inputs(cfg, nu)
    cosmos = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                    *[_cosmo(i) for i in range(n)])
    lins = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *([lin] * n))
    return cosmos, lins


def port_inputs(cosmos, lins, device="cpu"):
    """The same batch as the port's (CosmoParams, LinearData) tensors."""
    return (state.cosmo_from_numpy(cosmos, device),
            state.linear_from_numpy(lins, device))


def col_scale_dev(got: np.ndarray, ref: np.ndarray, axes) -> float:
    """max |got - ref| relative to the max |ref| over `axes`."""
    scale = np.max(np.abs(ref), axis=axes, keepdims=True) + 1e-300
    return float(np.max(np.abs(got - ref) / scale))


@pytest.fixture
def cuda_device():
    """A CUDA device for the tests marked `cuda`; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (on the card: python -m pytest "
                    "--noconftest tests/test_torch_kernels.py -m cuda)")
    return torch.device("cuda")


class Deadline(Exception):
    """A test's wait outlived its time limit (see `deadline`)."""


@contextlib.contextmanager
def deadline(seconds: float):
    """Raise Deadline in the block once `seconds` have passed: the time
    limit of a test's wait on worker processes, so a hung worker fails
    the test instead of the suite (pytest runs tests on the main thread,
    where the alarm signal is delivered)."""
    def expire(signum, frame):
        raise Deadline(f"no result within {seconds} s")

    before = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, before)
