"""The port's ``moment_sums`` (plain version on a CPU tensor) against the
JAX package's Pallas kernel in interpret mode, ``moment_sums(impl=
"interpret")``: the same numpy inputs, an N that is not a multiple of the
kernel's row block, fp32 and bf16 inputs (each value widened to fp32
before the abs and the square on both sides). Tolerance 1e-5 relative to
the sum of the absolute terms (fp32 sums in other orders).

The CUDA kernel is held against its plain version on the card by
chip_smoke.py; ``chunking`` (the kernel's split of the rows) is checked
here, and an F that is not a multiple of the kernel's 8-column vector
(``odd_f``) goes through the plain version against JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.ops.stat_sums import moment_sums as jax_moment_sums
from forde_tpu_torch import kernels
from forde_tpu_torch.ops import stat_sums

torch.set_num_threads(1)

SHAPES = {"odd_n_1001x384": (1001, 384), "3d_3x67x256": (3, 67, 256), "n1_1x128": (1, 128),
          "odd_f_77x1001": (77, 1001)}


def _x(shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) + 0.3).astype(np.float32)


def _check(got, want):
    mag = np.abs(want)[[0, 1, 0]]
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-5 * mag + 1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_moment_sums_matches_jax_interpret(name, dtype):
    x = _x(SHAPES[name])
    want = np.asarray(jax_moment_sums(jnp.asarray(x, getattr(jnp, dtype)), impl="interpret"))
    got = stat_sums.moment_sums(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32
    _check(got.numpy(), want)


def test_moment_sums_is_three_plain_sums():
    x = torch.from_numpy(_x((513, 70), seed=1)).double()
    got = stat_sums.moment_sums(x.float()).double()
    want = torch.stack([x.abs().sum(0), (x * x).sum(0), x.sum(0)])
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("n,f", [(25600, 3072), (8192, 2048), (12345, 3072), (1, 5), (63, 2048),
                                 (8192, 2051)])
def test_chunking_covers_every_row(n, f, itemsize):
    """Every row lies in one chunk, each chunk but the last is a whole
    number of the 32-row steps a block walks, and the grid holds about two
    blocks per SM (264) over the column groups of 512 bytes."""
    chunks, rows = stat_sums.chunking(n, f, itemsize)
    assert chunks * rows >= n > (chunks - 1) * rows
    assert rows % 32 == 0
    groups = -(-f * itemsize // 512)
    assert chunks * groups <= 264 + groups


def test_moment_sums_cpu_runs_no_kernel():
    kernels.reset_launches()
    stat_sums.moment_sums(torch.ones(4, 8))
    assert kernels.launches["moment_sums"] == 0


def test_moment_sums_rejects_other_devices():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        stat_sums.moment_sums(torch.empty(4, 8, device="meta"))
