"""Coarse-to-fine rendering pipeline.

Behavioral parity with the reference full forward
(/root/reference/networks/render.py:31-96):

  normalize viewdirs -> (optional) stratified jitter -> coarse points -> PE -> coarse
  MLP -> composite -> inverse-CDF importance sampling on detached coarse weights
  (render.py:66-68) -> fine z = sort(coarse ∪ fine) -> fine MLP -> composite.

Returns the same 10-tensor bundle as the reference's ``all_info`` (render.py:92-94).
The ScanNet-only suffix slicing of instance maps to the last N_ins rays
(render.py:88-90, driven by mutable args.N_ins in the reference) is the caller's
responsibility here — N_ins is a static per-config constant, and slicing a returned
array keeps this function shape-stable for jit.

Points are kept in [N_rays, S, 3] layout; the MLP consumes them as one batch of
N_rays*S rows per matmul. The query function is a parameter so callers can pass a
wrapped query (e.g. a stubbed-head one) or a test double.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp

from dmnerf_tpu.core.compositor import composite
from dmnerf_tpu.core.embedding import positional_encoding
from dmnerf_tpu.core.mlp import dm_nerf_apply
from dmnerf_tpu.core.sampling import perturb_z_vals, sample_pdf

# query_fn(params, pts [N,S,3], viewdirs [N,3]) -> raw [N,S,4+ins+1]
QueryFn = Callable[[Dict, jnp.ndarray, jnp.ndarray], jnp.ndarray]


def make_xla_query_fn(multires: int = 10, multires_views: int = 4, D: int = 8, skips=(4,)) -> QueryFn:
    """Pure-XLA point query: PE + MLP, fused by the compiler."""

    def query(params, pts, viewdirs):
        emb_pts = positional_encoding(pts, multires)                     # [N, S, Cp]
        emb_dirs = positional_encoding(viewdirs, multires_views)         # [N, Cv]
        emb_dirs = jnp.broadcast_to(emb_dirs[:, None, :], pts.shape[:-1] + emb_dirs.shape[-1:])
        return dm_nerf_apply(params, emb_pts, emb_dirs, D=D, skips=skips)

    return query


def make_query_fn(cfg) -> QueryFn:
    """The point query a config asks for: PE (or the identity embedding for
    i_embed=-1) + MLP as plain XLA ops. Under a mesh-jitted step GSPMD partitions
    it over the ray axis like any other op."""
    mr = cfg.multires if cfg.i_embed == 0 else -1
    mrv = cfg.multires_views if cfg.i_embed == 0 else -1
    return make_xla_query_fn(mr, mrv, cfg.netdepth, tuple(cfg.skips))


def render_rays(
    params_coarse: Dict,
    params_fine: Dict,
    rays_o: jnp.ndarray,        # [N, 3]
    rays_d: jnp.ndarray,        # [N, 3]
    z_vals_coarse: jnp.ndarray, # [N, N_samples]
    query_fn: QueryFn,
    N_importance: int = 128,
    perturb: bool = True,
    key: Optional[jnp.ndarray] = None,
) -> Dict[str, jnp.ndarray]:
    viewdirs = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)

    if perturb and key is not None:
        key_z, key_pdf = jax.random.split(key)
        z_vals_coarse = perturb_z_vals(key_z, z_vals_coarse)
    else:
        key_pdf = None

    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals_coarse[..., :, None]
    raw_coarse = query_fn(params_coarse, pts, viewdirs)
    out_c = composite(raw_coarse, z_vals_coarse, rays_d)

    # hierarchical sampling on detached coarse weights (reference render.py:66-68);
    # det mode exactly when perturb==0.
    z_mids = 0.5 * (z_vals_coarse[..., 1:] + z_vals_coarse[..., :-1])
    z_samples = sample_pdf(
        z_mids,
        jax.lax.stop_gradient(out_c.weights[..., 1:-1]),
        N_importance,
        key=key_pdf if perturb else None,
    )
    z_samples = jax.lax.stop_gradient(z_samples)

    z_vals_fine = jnp.sort(jnp.concatenate([z_vals_coarse, z_samples], axis=-1), axis=-1)
    pts_fine = rays_o[..., None, :] + rays_d[..., None, :] * z_vals_fine[..., :, None]
    raw_fine = query_fn(params_fine, pts_fine, viewdirs)
    out_f = composite(raw_fine, z_vals_fine, rays_d)

    return {
        "rgb_fine": out_f.rgb,
        "ins_fine": out_f.ins,
        "z_vals_fine": z_vals_fine,
        "raw_fine": raw_fine,
        "raw_coarse": raw_coarse,
        "rgb_coarse": out_c.rgb,
        "ins_coarse": out_c.ins,
        "z_vals_coarse": z_vals_coarse,
        "depth_fine": out_f.depth,
        "depth_coarse": out_c.depth,
    }
