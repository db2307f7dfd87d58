"""Full-image rendering by ray micro-batching.

The reference renders test images with a Python chunk loop, one CUDA launch chain and
one host sync per chunk (/root/reference/networks/tester.py:62-76, with a shape-changing
final partial chunk). Here the H*W rays are padded to a multiple of the chunk size
and swept with jax.lax.map inside ONE jit — a single static program, no retrace for
the tail, no per-chunk host round trips. Chunk size = cfg.N_test rays; it bounds the
live [chunk, N_samples+N_importance, C] activations.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from dmnerf_tpu.configs import Config
from dmnerf_tpu.core.compositor import composite, composite_maps
from dmnerf_tpu.core.mlp import sigma_stub_params
from dmnerf_tpu.core.pipeline import QueryFn, make_query_fn, render_rays
from dmnerf_tpu.core.sampling import sample_pdf, z_val_sample


def _pad_to_multiple(x: jnp.ndarray, m: int):
    n = x.shape[0]
    pad = (-n) % m
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
    return x, n


def make_image_renderer(cfg: Config, query_fn: Optional[QueryFn] = None,
                        sigma_only_coarse: bool = True):
    """Returns render_fn(params_coarse, params_fine, rays_o [N,3], rays_d [N,3])
    -> dict(rgb [N,3], ins [N,ins_num], depth [N]), jit-compiled once per ray count.

    sigma_only_coarse (default): the coarse pass exists only to produce
    `sample_pdf` weights (reference tester.py:62-76 discards the coarse render),
    and weights depend on sigma alone — so the coarse query runs with
    `sigma_stub_params` (trunk + density intact, heads stubbed), dropping the head
    branches' matmuls from the coarse query.
    Output-identical to the full pipeline (gated by
    tests/test_data_and_train.py::test_image_renderer_sigma_only_coarse_equivalent)."""
    if query_fn is None:
        query_fn = make_query_fn(cfg)
    chunk = cfg.N_test
    z_coarse = z_val_sample(chunk, cfg.near, cfg.far, cfg.N_samples)

    def _slim_chunk(params_coarse_stub, params_fine, o, d):
        """render_rays' exact z-path (pipeline.py:100-126, perturb=False) with the
        sigma-stub coarse query; only fine outputs are computed.

        The fine maps come from core.compositor.composite_maps (ONE weighted
        reduction over the channel-concat, −8 ms/256² image vs three separate
        reductions; semantics identical — see its docstring)."""
        viewdirs = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        pts = o[..., None, :] + d[..., None, :] * z_coarse[..., :, None]
        raw_c = query_fn(params_coarse_stub, pts, viewdirs)   # [N,S,5]: only sigma valid
        w = composite(raw_c, z_coarse, d).weights
        z_mids = 0.5 * (z_coarse[..., 1:] + z_coarse[..., :-1])
        z_samples = sample_pdf(z_mids, w[..., 1:-1], cfg.N_importance, key=None)
        z_fine = jnp.sort(jnp.concatenate([z_coarse, z_samples], axis=-1), axis=-1)
        pts_fine = o[..., None, :] + d[..., None, :] * z_fine[..., :, None]
        raw_f = query_fn(params_fine, pts_fine, viewdirs)
        rgb, ins, depth = composite_maps(raw_f, z_fine, d, keep_air=False)
        return {"rgb": rgb, "ins": ins, "depth": depth}

    @jax.jit
    def render_fn(params_coarse, params_fine, rays_o, rays_d):
        (ro, n), (rd, _) = _pad_to_multiple(rays_o, chunk), _pad_to_multiple(rays_d, chunk)
        ro = ro.reshape(-1, chunk, 3)
        rd = rd.reshape(-1, chunk, 3)
        pc_stub = sigma_stub_params(params_coarse) if sigma_only_coarse else None

        def one_chunk(args):
            o, d = args
            # avoid 0/0 viewdirs on padding rays
            d = jnp.where(jnp.sum(d * d, -1, keepdims=True) > 0, d, jnp.ones_like(d))
            if sigma_only_coarse:
                return _slim_chunk(pc_stub, params_fine, o, d)
            info = render_rays(
                params_coarse, params_fine, o, d, z_coarse, query_fn,
                N_importance=cfg.N_importance, perturb=False, key=None,
            )
            return {"rgb": info["rgb_fine"], "ins": info["ins_fine"], "depth": info["depth_fine"]}

        out = jax.lax.map(one_chunk, (ro, rd))
        return {k: v.reshape(-1, *v.shape[2:])[:n] for k, v in out.items()}

    return render_fn


def render_image(
    cfg: Config,
    params_coarse: Dict,
    params_fine: Dict,
    rays_o: jnp.ndarray,
    rays_d: jnp.ndarray,
    renderer=None,
):
    """Convenience wrapper: flat rays in, flat maps out (caller reshapes to H, W)."""
    if renderer is None:
        renderer = make_image_renderer(cfg)
    return renderer(params_coarse, params_fine, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3))
