"""Scene manipulation: per-sample raw exchange between original and inverse-
transformed target ray bundles, keyed by predicted instance labels.

Behavioral parity with /root/reference/networks/manipulator.py:18-205:

 * ``exchange``  == reference exchanger (manipulator.py:18-83): per-point labels from
   argmax of the raw instance logits (air included); occlusion fix — points whose
   per-point label says "moved object" but whose ray's accumulated 2D label disagrees
   take the accumulated label; filling mask (accumulated==move but point!=move) pulls
   the target bundle's sample; operation mask from (tar_move - ori_move) encodes
   {-1 keep, 0 eliminate (raw*0), 1 exchange}; applied sequentially over the K moved
   objects, label state carried between iterations.
   (The reference double-sigmoids the already-sigmoided accumulated maps before
   argmax — a monotonic no-op on the argmax; we argmax directly.)
 * ``manipulate_rays`` == reference manipulator (manipulator.py:137-205): pass 1
   queries coarse ori + each target bundle, runs fine-model accumulation for 2D
   labels, exchanges the coarse raws; pass 2 importance-samples the EXCHANGED ori
   weights, forms the union z-set (ori 64 ∪ ori-fine 128 ∪ all K target-fine 128s),
   re-queries ori and each target with the fine model on equal-length sorted z sets,
   re-exchanges, and composites. Like the reference we also return the LAST target
   bundle's coarse rgb and accumulated ins (manipulator.py:205).
   (The reference re-queries the identical ori bundle once per target inside the
   pass-2 loop — manipulator.py:192-194; we query once: outputs are identical.)

Released-code fix (SURVEY.md §4): the reference's eval driver passes a single
un-nested bundle and an int target_label, which crashes exchanger's iteration; here
targets are always a length-K list of bundles with a length-K label tuple, and the
eval driver wraps its single edit as K=1.

All masked in-place writes become jnp.where selects; the whole edit pipeline jits and
chunks over rays with lax.map (``make_manipulator_renderer``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from dmnerf_tpu.configs import Config
from dmnerf_tpu.core.compositor import composite, composite_maps
from dmnerf_tpu.core.pipeline import QueryFn, make_query_fn
from dmnerf_tpu.core.sampling import sample_pdf, z_val_sample


def _point_labels(raw: jnp.ndarray) -> jnp.ndarray:
    """Per-sample instance labels (argmax over sigmoid logits incl. air) [N, S]."""
    return jnp.argmax(raw[..., 4:], axis=-1)


def _accum_labels(accum_ins: jnp.ndarray) -> jnp.ndarray:
    """Per-ray 2D labels from the accumulated (air-kept) instance map [N]."""
    return jnp.argmax(accum_ins[..., :-1], axis=-1)


def exchange(
    ori_raw: jnp.ndarray,                 # [N, S, C]
    tar_raws: Sequence[jnp.ndarray],      # K x [N, S, C]
    ori_accum: jnp.ndarray,               # [N, ins+1] sigmoid accumulated (pass 1)
    tar_accums: Sequence[jnp.ndarray],    # K x [N, ins+1]
    move_labels: Sequence[int],
) -> Tuple[jnp.ndarray, List[jnp.ndarray], jnp.ndarray, jnp.ndarray]:
    n_s = ori_raw.shape[1]
    ori_pred = _point_labels(ori_raw)                       # [N, S]
    ori_acc = jnp.broadcast_to(_accum_labels(ori_accum)[:, None], ori_pred.shape)

    tar_pred_last = None
    for k, move in enumerate(move_labels):
        tar_raw = tar_raws[k]
        tar_acc = jnp.broadcast_to(_accum_labels(tar_accums[k])[:, None], ori_pred.shape)

        # occlusion fix on the original bundle
        ori_occl = (ori_pred == move) & (ori_acc != move)
        ori_pred = jnp.where(ori_occl, ori_acc, ori_pred)

        # fillings: the ray sees the moved object but this sample doesn't
        fillings = (ori_acc == move) & (ori_pred != move)

        tar_pred = _point_labels(tar_raw)
        tar_occl = (tar_pred == move) & (tar_acc != move)
        tar_pred = jnp.where(tar_occl, tar_acc, tar_pred)
        # the reference's tar_pred_label_temp ALIASES the tensor mutated in place
        # by the occlusion fix (manipulator.py:47,59) — the returned labels are
        # the post-fix ones
        tar_pred_last = tar_pred

        # reduced = tar_move(1) - ori_move(-2): 0 neither, 1 tar-only, 2 ori-only, 3 both
        reduced = (tar_pred == move).astype(jnp.int32) + 2 * (ori_pred == move).astype(jnp.int32)
        take_tar = (reduced == 1) | (reduced == 3) | fillings
        eliminate = reduced == 2

        ori_raw = jnp.where(take_tar[..., None], tar_raw, ori_raw)
        ori_raw = jnp.where(eliminate[..., None], jnp.zeros_like(ori_raw), ori_raw)

    return ori_raw, list(tar_raws), ori_pred, tar_pred_last


def _query_at(query_fn: QueryFn, params, rays_o, rays_d, z_vals):
    """MLP query at explicit z (reference manipulator_nerf, manipulator.py:113-134);
    viewdirs are the normalized ray dirs."""
    viewdirs = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return query_fn(params, pts, viewdirs)


def _mani_composite(raw, z_vals, rays_d):
    """Manipulator compositor variant: air kept, weights not detached
    (reference manipulator_render, manipulator.py:86-110)."""
    return composite(raw, z_vals, rays_d, keep_air=True, detach_ins_weights=False)


def _mani_composite_maps(raw, z_vals, rays_d):
    """Final composite (rgb + depth + ins-with-air) via the shared
    single-reduction fast path (core.compositor.composite_maps; −8 ms/image,
    per-channel math identical to _mani_composite). Returns (rgb, ins, depth)."""
    return composite_maps(raw, z_vals, rays_d, keep_air=True)


def manipulate_rays(
    cfg: Config,
    params_coarse,
    params_fine,
    ori_rays: Tuple[jnp.ndarray, jnp.ndarray],                 # (o, d) each [N, 3]
    tar_rays: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],       # K bundles
    move_labels: Sequence[int],
    query_fn: Optional[QueryFn] = None,
    key=None,
    rgb_stub: bool = True,
) -> Dict[str, jnp.ndarray]:
    """rgb_stub (default): the pass-1 label-accumulation queries (ori coarse,
    ori fine, target fine) run with rgb_stub_params — their rgb channels are
    never consumed (the 2D label maps read accumulated ins, the exchanged-coarse
    weights read sigma; reference manipulator.py:137-160), so the rgb branch's
    matmuls are dropped from those queries. Output-identical (gated by
    tests/test_manipulator_parity.py); the TARGET coarse query stays full
    because its rgb render is returned (tar_rgb, reference manipulator.py:205)."""
    if query_fn is None:
        query_fn = make_query_fn(cfg)
    from dmnerf_tpu.core.mlp import rgb_stub_params

    pc_lbl = rgb_stub_params(params_coarse) if rgb_stub else params_coarse
    pf_lbl = rgb_stub_params(params_fine) if rgb_stub else params_fine
    K = len(tar_rays)
    assert K == len(move_labels)
    n = ori_rays[0].shape[0]
    keys = jax.random.split(key, 2 * K + 2) if key is not None else [None] * (2 * K + 2)

    z_base = z_val_sample(n, cfg.near, cfg.far, cfg.N_samples)

    # ---- pass 1: coarse queries + fine-accumulated 2D labels
    ori_o, ori_d = ori_rays
    ori_raw = _query_at(query_fn, pc_lbl, ori_o, ori_d, z_base)
    ori_w = _mani_composite(ori_raw, z_base, ori_d).weights
    z_mid = 0.5 * (z_base[..., 1:] + z_base[..., :-1])
    ori_zs = sample_pdf(z_mid, ori_w[..., 1:-1], cfg.N_importance, key=keys[0])
    ori_z_full = jnp.sort(jnp.concatenate([z_base, ori_zs], -1), -1)
    ori_raw_full = _query_at(query_fn, pf_lbl, ori_o, ori_d, ori_z_full)
    ori_accum = _mani_composite(ori_raw_full, ori_z_full, ori_d).ins     # [N, ins+1]

    tar_raws, tar_accums, tar_zs_list = [], [], []
    tar_rgb = tar_accum_last = None
    for k, (to, td) in enumerate(tar_rays):
        traw = _query_at(query_fn, params_coarse, to, td, z_base)
        tcomp = _mani_composite(traw, z_base, td)
        tzs = sample_pdf(z_mid, tcomp.weights[..., 1:-1], cfg.N_importance, key=keys[1 + k])
        tz_full = jnp.sort(jnp.concatenate([z_base, tzs], -1), -1)
        traw_full = _query_at(query_fn, pf_lbl, to, td, tz_full)
        taccum = _mani_composite(traw_full, tz_full, td).ins
        tar_raws.append(traw)
        tar_accums.append(taccum)
        tar_zs_list.append(tzs)
        tar_rgb, tar_accum_last = tcomp.rgb, taccum

    # ---- exchange on the coarse raws
    ori_raw, tar_raws, _, _ = exchange(ori_raw, tar_raws, ori_accum, tar_accums, move_labels)

    # ---- pass 2: union-z re-query with the fine model
    ori_w2 = _mani_composite(ori_raw, z_base, ori_d).weights
    ori_zs2 = sample_pdf(z_mid, ori_w2[..., 1:-1], cfg.N_importance, key=keys[K + 1])
    all_tar_zs = jnp.concatenate(tar_zs_list, -1)                         # [N, K*NI]
    ori_z_union = jnp.sort(jnp.concatenate([z_base, ori_zs2, all_tar_zs], -1), -1)
    ori_raw_u = _query_at(query_fn, params_fine, ori_o, ori_d, ori_z_union)

    tar_raws_u = []
    for k, (to, td) in enumerate(tar_rays):
        tz_union = jnp.sort(jnp.concatenate([z_base, ori_zs2, all_tar_zs], -1), -1)
        tar_raws_u.append(_query_at(query_fn, params_fine, to, td, tz_union))

    ori_raw_u, _, _, _ = exchange(ori_raw_u, tar_raws_u, ori_accum, tar_accums, move_labels)
    rgb, ins, depth = _mani_composite_maps(ori_raw_u, ori_z_union, ori_d)

    return {
        "rgb": rgb,
        "ins": ins,                    # air channel kept (manipulator_render semantics)
        "depth": depth,
        "tar_rgb": tar_rgb,            # last target bundle, as the reference returns
        "tar_ins_accum": tar_accum_last,
    }


def make_manipulator_renderer(cfg: Config, n_targets: int, query_fn: Optional[QueryFn] = None):
    """Chunked full-image manipulation renderer: jit + lax.map over ray chunks
    (the reference's Python chunk loop, manipulator.py:245-267, fused into one
    program). Returns fn(params_coarse, params_fine, ori_o, ori_d,
    tar_o [K,N,3], tar_d [K,N,3], move_labels tuple) -> dict of flat maps."""
    if query_fn is None:
        query_fn = make_query_fn(cfg)
    chunk = cfg.N_test

    import functools

    @functools.partial(jax.jit, static_argnums=(6,))
    def run(params_coarse, params_fine, ori_o, ori_d, tar_o, tar_d, move_labels, key=None):
        """key=None reproduces det=True inverse-CDF sampling (linspace u);
        a PRNG key gives the reference's production behavior — its manipulator
        calls sample_pdf with the default det=False (reference
        manipulator.py:148,170,187 + helpers.py:123) — with per-chunk subkeys."""
        n = ori_o.shape[0]
        pad = (-n) % chunk

        def padded(x):
            # explicit pad shape, NOT zeros_like of a slice: for n < pad (e.g. a
            # small per-shard ray count under shard_map) the slice yields fewer
            # than pad rows and the reshape below crashes (ADVICE r3 #1 class)
            if pad:
                z = jnp.zeros(x.shape[:-2] + (pad,) + x.shape[-1:], x.dtype)
                x = jnp.concatenate([x, z], axis=-2)
            return x

        ori_o_p, ori_d_p = padded(ori_o), padded(ori_d)
        tar_o_p, tar_d_p = padded(tar_o), padded(tar_d)
        nc = (n + pad) // chunk
        ori_o_c = ori_o_p.reshape(nc, chunk, 3)
        ori_d_c = ori_d_p.reshape(nc, chunk, 3)
        tar_o_c = tar_o_p.reshape(n_targets, nc, chunk, 3).transpose(1, 0, 2, 3)
        tar_d_c = tar_d_p.reshape(n_targets, nc, chunk, 3).transpose(1, 0, 2, 3)
        chunk_keys = None if key is None else jax.random.split(key, nc)

        def one_chunk(args):
            oo, od, to, td, ck = args
            od = jnp.where(jnp.sum(od * od, -1, keepdims=True) > 0, od, jnp.ones_like(od))
            td = jnp.where(jnp.sum(td * td, -1, keepdims=True) > 0, td, jnp.ones_like(td))
            out = manipulate_rays(
                cfg, params_coarse, params_fine, (oo, od),
                [(to[k], td[k]) for k in range(n_targets)], move_labels, query_fn,
                key=ck,
            )
            return {"rgb": out["rgb"], "ins": out["ins"], "tar_rgb": out["tar_rgb"]}

        out = jax.lax.map(one_chunk, (ori_o_c, ori_d_c, tar_o_c, tar_d_c, chunk_keys))
        return {k: v.reshape(-1, v.shape[-1])[:n] for k, v in out.items()}

    return run


def deform_ray_offsets(H: int, W: int, deform_func: str, deform_v: float):
    """Per-pixel-row x-offsets for deformable edits (reference manipulator_demo,
    manipulator.py:396-426; the hardcoded 400/50/200/215 constants are behavior).
    Returns a flat [H*W] float array to ADD to ray-origin x."""
    import numpy as np

    v = np.linspace(1, H, H)
    if deform_func == "sin":
        v = np.sin((8 * np.pi) / 400 * v) * deform_v
    elif deform_func == "ex":
        v = np.exp(-v / 50.0)
    elif deform_func == "linear":
        v = (v - 200.0) / 215.0
    elif deform_func == "abs_linear":
        v = np.abs(v - 200.0) / 200.0
    elif deform_func == "ln":
        v = np.log(v / 200.0)
    else:
        raise ValueError(f"unknown deform_func {deform_func!r}")
    return np.repeat(v[:, None], W, axis=1).reshape(-1).astype(np.float32)
