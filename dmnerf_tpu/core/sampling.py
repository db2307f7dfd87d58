"""Depth sampling along rays: stratified coarse bins, jitter, and the hierarchical
inverse-CDF ("importance") sampler.

Behavioral parity:
 * ``z_val_sample``  == reference helpers.py:114-119 — linear near->far bins.
 * ``perturb_z_vals`` == the in-renderer jitter (reference render.py:40-47).
 * ``sample_pdf``    == reference helpers.py:123-155 — +1e-5 weight floor, cdf with
   leading zero, right-searchsorted, clamped gather, denom<1e-5 -> 1 guard, lerp.

Design note: the searchsorted + 4x take_along_axis of the reference is replaced by a
branchless rank-by-comparison + one-hot contraction: counting ``cdf <= u`` over the
bin axis and contracting one-hot masks against cdf/bins is vectorized compare+reduce
work that XLA fuses. Whether it beats searchsorted/take_along_axis on a GPU is not
measured yet (ROADMAP). The rank equals searchsorted(side="right") exactly, ties
included, because cdf is non-decreasing. Everything is static-shape; RNG is threaded
jax.random keys (the reference used impure global torch RNG).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def z_val_sample(n_rays: int, near: float, far: float, n_samples: int, dtype=jnp.float32):
    t = jnp.linspace(0.0, 1.0, n_samples, dtype=dtype)
    z = near + t * (far - near)
    return jnp.broadcast_to(z, (n_rays, n_samples))


def perturb_z_vals(key, z_vals: jnp.ndarray) -> jnp.ndarray:
    """Stratified jitter within midpoint bins (reference render.py:40-47)."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = jnp.concatenate([mids, z_vals[..., -1:]], axis=-1)
    lower = jnp.concatenate([z_vals[..., :1], mids], axis=-1)
    t_rand = jax.random.uniform(key, z_vals.shape, dtype=z_vals.dtype)
    return lower + (upper - lower) * t_rand


def sample_pdf(bins: jnp.ndarray, weights: jnp.ndarray, n_samples: int, key=None):
    """Inverse-CDF sampling of n_samples points from a piecewise-constant pdf.

    bins: [N, M] sorted bin positions; weights: [N, M-1] unnormalized bin mass.
    key=None -> deterministic linspace samples (reference det=True when perturb==0).
    Gradients are NOT blocked here; the caller applies stop_gradient exactly where
    the reference detaches (render.py:68).
    """
    weights = weights + 1e-5
    pdf = weights / jnp.sum(weights, axis=-1, keepdims=True)
    cdf = jnp.cumsum(pdf, axis=-1)
    cdf = jnp.concatenate([jnp.zeros_like(cdf[..., :1]), cdf], axis=-1)  # [N, M]

    if key is None:
        u = jnp.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype)
        u = jnp.broadcast_to(u, cdf.shape[:-1] + (n_samples,))
    else:
        u = jax.random.uniform(key, cdf.shape[:-1] + (n_samples,), dtype=cdf.dtype)

    # rank[n,s] = #{m : cdf[n,m] <= u[n,s]} == searchsorted(cdf[n], u[n], side="right")
    le = (cdf[..., None, :] <= u[..., :, None]).astype(cdf.dtype)  # [N, S, M]
    inds = jnp.sum(le, axis=-1).astype(jnp.int32)
    below = jnp.maximum(inds - 1, 0)
    above = jnp.minimum(inds, cdf.shape[-1] - 1)

    # gathers as one-hot contractions (compare+multiply+reduce, fused by XLA)
    iota = jnp.arange(cdf.shape[-1], dtype=jnp.int32)
    oh_below = (iota == below[..., None]).astype(cdf.dtype)  # [N, S, M]
    oh_above = (iota == above[..., None]).astype(cdf.dtype)
    cdf_below = jnp.einsum("nsm,nm->ns", oh_below, cdf)
    cdf_above = jnp.einsum("nsm,nm->ns", oh_above, cdf)
    bins_below = jnp.einsum("nsm,nm->ns", oh_below, bins)
    bins_above = jnp.einsum("nsm,nm->ns", oh_above, bins)

    denom = cdf_above - cdf_below
    denom = jnp.where(denom < 1e-5, jnp.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
