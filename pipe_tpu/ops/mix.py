"""Channel mixing — matrix routing/downmix.

The reference ecosystem's mixer merges lines via a shared sink; here the
merge is an on-device matrix multiply over the channel axis (BASELINE.json:
'merging multi-line pipes with on-device mixers instead of Go channels').
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
from jax import lax

from pipe_tpu.components import Processor
from pipe_tpu.signal import Signal, SignalProperties

from pipe_tpu import config


def channel_mix_block(x, m):
    """``(C_out, C_in) @ (C_in, B) -> (C_out, B)``, at the precision of
    :func:`pipe_tpu.config.matmul_precision` (``HIGHEST`` by default: an
    unpinned f32 product on the GPU may run in TF32)."""
    return jnp.dot(
        m, x, preferred_element_type=jnp.float32,
        precision=config.matmul_precision(),
    )


class ChannelMix:
    """Matrix mixer processor: ``out = M @ in``. ``matrix`` is a live
    parameter, so routing/levels can be changed mid-stream."""

    def __init__(self, matrix):
        self._init_matrix = jnp.asarray(matrix, jnp.float32)
        if self._init_matrix.ndim != 2:
            raise ValueError("mix matrix must be 2D (out_channels, in_channels)")
        self._component = None
        self._delegate = None  # set by pipe_tpu.optimize.fuse
        self.context = None

    def processor(self):
        out_channels = self._init_matrix.shape[0]
        in_channels = self._init_matrix.shape[1]

        def alloc(mctx, block_size, props: SignalProperties):
            if props.channels != in_channels:
                raise ValueError(
                    f"mix matrix expects {in_channels} input channels, "
                    f"line has {props.channels}"
                )
            self.context = mctx

            def step(state, params, sig: Signal):
                return state, Signal(
                    channel_mix_block(sig.data, params["matrix"]), sig.frames
                )

            self._component = Processor(
                output=SignalProperties(
                    sample_rate=props.sample_rate, channels=out_channels
                ),
                step=step,
                state={},
                params={"matrix": self._init_matrix},
            )
            return self._component

        alloc.fusion_tag = ("mix", self)
        return alloc

    def set_matrix(self, matrix):
        if self._delegate is not None:  # fused away by optimize.fuse
            return self._delegate.set_matrix(matrix)
        m = jnp.asarray(matrix, jnp.float32)

        def fn():
            self._component.set_param("matrix", m)

        return self.context.mutate(fn)
