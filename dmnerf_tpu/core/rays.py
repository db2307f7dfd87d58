"""Pinhole ray generation.

Behavioral parity with the reference ray helpers
(/root/reference/networks/helpers.py:24-61):

 * ``rays_from_K``  == reference get_rays_k: dirs = [(i - cx)/fx, (j - cy)/fy, K22],
   rotated by c2w[:3,:3], origins broadcast from c2w[:3,3]. This is the variant used
   by every reference driver; DM-SR's loader builds K with negative fy and K22 = -1
   (loader_dmsr.py:172) so the same code serves all three datasets.
 * ``rays_from_focal`` == reference get_rays: dirs = [(i-(W-1)/2)/f, (j-(H-1)/2)/f, 1].

Difference: the reference materializes a full HxW ray grid and then gathers
the sampled pixels (helpers.py:99-111). Here ``rays_for_pixels`` computes rays only for
the selected pixel coordinates — a [N,3] fused expression with no HxW intermediate and
no host round trip, so the train step's ray generation is bandwidth-free.
"""

from __future__ import annotations

import jax.numpy as jnp


def _dirs_from_K(px_x: jnp.ndarray, px_y: jnp.ndarray, K: jnp.ndarray) -> jnp.ndarray:
    """px_x = column index i, px_y = row index j (pixel centers, float)."""
    return jnp.stack(
        [
            (px_x - K[0, 2]) / K[0, 0],
            (px_y - K[1, 2]) / K[1, 1],
            K[2, 2] * jnp.ones_like(px_x),
        ],
        axis=-1,
    )


def rays_from_K(H: int, W: int, K: jnp.ndarray, c2w: jnp.ndarray):
    """Full-image rays: returns (rays_o, rays_d), each [H, W, 3]."""
    j, i = jnp.meshgrid(jnp.arange(H, dtype=K.dtype), jnp.arange(W, dtype=K.dtype), indexing="ij")
    dirs = _dirs_from_K(i, j, K)                             # [H, W, 3]
    rays_d = jnp.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    rays_o = jnp.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o, rays_d


def rays_for_pixels(px_y: jnp.ndarray, px_x: jnp.ndarray, K: jnp.ndarray, c2w: jnp.ndarray):
    """Rays for a flat list of pixel (row=px_y, col=px_x) coords: each [N, 3]."""
    dirs = _dirs_from_K(px_x.astype(K.dtype), px_y.astype(K.dtype), K)  # [N, 3]
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = jnp.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o, rays_d


def rays_from_focal(H: int, W: int, focal: float, c2w: jnp.ndarray):
    """Reference get_rays (helpers.py:24-35): centered at (W-1)/2,(H-1)/2, +z forward."""
    K = jnp.array(
        [[focal, 0.0, (W - 1) * 0.5], [0.0, focal, (H - 1) * 0.5], [0.0, 0.0, 1.0]],
        dtype=c2w.dtype,
    )
    return rays_from_K(H, W, K, c2w)
