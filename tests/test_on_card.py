"""Checks only the GPU can answer: what XLA's GPU backend does to float32
products and to the error-free transforms. Marked ``chip``: they skip
elsewhere and run on the card as the first phase of
``python chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from pipe_tpu.signal import snr_db

pytestmark = pytest.mark.chip


def test_dd_transforms_exact_on_card(gpu, rng):
    """The GPU backend contracts mul+add into FMA too: the ``_opaque_one``
    guard of the double-f32 biquad must keep every error term exact."""
    from test_ops import test_dd_transforms_exact_under_jit

    test_dd_transforms_exact_under_jit(rng)


def test_highest_products_are_full_f32(gpu, rng):
    """HIGHEST dots and convolutions keep float32 accuracy on the card; a
    TF32 product would miss this bound by two orders of magnitude."""
    a = rng.standard_normal((256, 512)).astype(np.float32)
    b = rng.standard_normal((512, 128)).astype(np.float32)
    hi = lax.Precision.HIGHEST
    y = jax.jit(lambda a, b: jnp.dot(a, b, precision=hi))(a, b)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert snr_db(ref, np.asarray(y)) > 120

    x = rng.standard_normal((4, 128, 64)).astype(np.float32)
    k = rng.standard_normal((128, 128, 3)).astype(np.float32)
    conv = jax.jit(lambda x, k: lax.conv_general_dilated(
        x, k, (1,), "VALID", dimension_numbers=("NCH", "OIH", "NCH"),
        precision=hi))
    ref = np.stack([
        sum(k[:, :, j].astype(np.float64) @ x[n, :, j : j + 62]
            for j in range(3))
        for n in range(4)
    ])
    assert snr_db(ref, np.asarray(conv(x, k))) > 120
