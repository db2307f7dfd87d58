"""NeRF sin/cos positional encoding.

Behavioral parity with the reference Embedder (/root/reference/networks/dm_nerf.py:8-55):
identity passthrough + per-frequency [sin, cos] at log-spaced frequencies
2**linspace(0, multires-1, multires), applied elementwise to each input channel,
concatenated along the channel axis as [x, sin(x*f0), cos(x*f0), sin(x*f1), ...].

Unlike the reference (a Python list of lambdas concatenated per call), this is a single
vectorized jnp expression: one outer-product broadcast and one reshape — XLA fuses it
into the consumer matmul, so the encoding never round-trips HBM.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def embed_dim(multires: int, input_dims: int = 3) -> int:
    """Output channel count: identity + sin/cos per frequency.

    multires=10 -> 63 for xyz; multires=4 -> 27 for view dirs
    (reference config.py:54-59, SURVEY.md C1). multires<=0 means identity (i_embed=-1).
    """
    if multires <= 0:
        return input_dims
    return input_dims * (1 + 2 * multires)


def freq_bands(multires: int) -> np.ndarray:
    # 2 ** linspace(0, multires-1, multires)  (reference dm_nerf.py:24)
    return 2.0 ** np.linspace(0.0, multires - 1, multires)


def positional_encoding(x: jnp.ndarray, multires: int) -> jnp.ndarray:
    """x: [..., d] -> [..., d*(1+2*multires)].

    Channel order matches the reference exactly: for each frequency f (ascending),
    the full d-channel sin(x*f) block then cos(x*f) block, after the identity block.
    """
    if multires <= 0:
        return x
    freqs = jnp.asarray(freq_bands(multires), dtype=x.dtype)  # [F]
    xb = x[..., None, :] * freqs[:, None]                      # [..., F, d]
    # interleave per frequency: [sin_f, cos_f] -> [..., F, 2, d] -> [..., F*2*d]
    sc = jnp.stack([jnp.sin(xb), jnp.cos(xb)], axis=-2)
    sc = sc.reshape(*x.shape[:-1], -1)
    return jnp.concatenate([x, sc], axis=-1)
