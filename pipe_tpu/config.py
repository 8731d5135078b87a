"""Global numerics knobs.

On an NVIDIA GPU a float32 matmul or convolution runs in TF32 (a 10-bit
mantissa on the tensor cores) unless its precision asks for more, and
``lax.Precision`` selects the algorithm. Measured by ``chip_smoke.py``
(phase numerics) on the flagship chain (64 channels, FIR-255 -> 44.1k/48k
resample -> mix) against float64, on an H100 80GB HBM3 at 700 W:

  ``'highest'``  full f32 products            129.6 dB
  ``'mixed'``    (HIGHEST, HIGH) per operand  129.6 dB (runs as 'highest')
  ``'high'``     TF32                         68.8 dB
  ``'default'``  TF32                         68.8 dB

Only ``'highest'`` clears the framework's 100 dB bar on the card. On the
CPU all four are full f32.

The *non-recursive* linear ops (FIR, polyphase resample, fused bank, OLS
convolution, mixer, channelizer) consult :func:`matmul_precision` at trace
time. Recursive kernels (the biquad's pole feedback and its cross-device
affine prefix) stay pinned at ``HIGHEST`` regardless — their rounding
error compounds per sample, and they are not matmul-bound anyway.

The default is ``'highest'``: the SNR-first setting behind the framework's
130–140 dB golden numbers. The other levels trade that for the tensor
cores' TF32 rate; their speed on the card is not measured yet.

The value is read when a computation is *traced*; set it before building
pipes / jitting chunk functions. Already-compiled executables keep the
precision they were compiled with.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Union

from jax import lax

_NAMED = {
    "default": lax.Precision.DEFAULT,
    "high": lax.Precision.HIGH,
    # per-operand (lhs, rhs); measured equal to 'highest' on the GPU
    "mixed": (lax.Precision.HIGHEST, lax.Precision.HIGH),
    "highest": lax.Precision.HIGHEST,
}

_matmul_precision = lax.Precision.HIGHEST


def set_matmul_precision(p) -> None:
    """Set the matmul/conv precision for non-recursive linear ops.

    Accepts ``'default' | 'high' | 'mixed' | 'highest'``, a
    ``lax.Precision``, or a per-operand ``(lhs, rhs)`` tuple of them.
    Applies to computations traced after the call.
    """
    global _matmul_precision
    if isinstance(p, str):
        try:
            p = _NAMED[p.lower()]
        except KeyError:
            raise ValueError(
                f"unknown precision {p!r}; expected one of {sorted(_NAMED)}"
            ) from None
    if isinstance(p, tuple):
        if len(p) != 2 or not all(isinstance(q, lax.Precision) for q in p):
            raise TypeError(f"precision tuple must be 2 lax.Precision, got {p!r}")
    elif not isinstance(p, lax.Precision):
        raise TypeError(f"expected str or lax.Precision, got {type(p)!r}")
    _matmul_precision = p


def matmul_precision() -> lax.Precision:
    """The current matmul/conv precision for non-recursive linear ops."""
    return _matmul_precision


@contextmanager
def matmul_precision_scope(
    p: Union[str, lax.Precision],
) -> Iterator[None]:
    """Temporarily override the matmul precision (trace-time scope)."""
    old = _matmul_precision
    set_matmul_precision(p)
    try:
        yield
    finally:
        set_matmul_precision(old)
