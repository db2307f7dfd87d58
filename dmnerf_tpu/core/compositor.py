"""Volume-rendering compositor.

Behavioral parity with the reference train/test compositor
(/root/reference/networks/render.py:6-28):

  dists   = diff(z_vals) with 1e10 appended, scaled by ||rays_d||
  alpha   = 1 - exp(-relu(sigma) * dists)
  weights = alpha * exclusive_cumprod(1 - alpha + 1e-10)
  rgb_map = sum(w * sigmoid(raw_rgb));  depth_map = sum(w * z)
  ins_map = sigmoid(sum(stop_gradient(w) * ins_logits))[..., :-1]
            (the weight detach at render.py:22-23 and the air-channel drop at
             render.py:26 — instance gradients must not move geometry, and the
             emptiness channel is excluded from the 2D instance map)

``composite(..., keep_air=True, detach_ins_weights=False)`` reproduces the
manipulator's variant (/root/reference/networks/manipulator.py:86-110), which keeps
the air channel and uses non-detached weights (it runs under no-grad anyway).

Design note: the exclusive cumprod of transmittance is expressed as
exp(cumsum(log1p(-alpha + eps))) — an associative scan XLA parallelizes,
numerically identical to cumprod up to float round-off but differentiable in one
fused pass; a flag keeps literal-cumprod semantics for bit-parity testing.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Composited(NamedTuple):
    rgb: jnp.ndarray      # [N, 3]
    weights: jnp.ndarray  # [N, S]
    depth: jnp.ndarray    # [N]
    ins: jnp.ndarray      # [N, ins_num] (or ins_num+1 when keep_air)


def exclusive_cumprod_one_minus(alpha: jnp.ndarray, use_log_scan: bool = True) -> jnp.ndarray:
    """T_i = prod_{k<i} (1 - alpha_k + 1e-10), T_0 = 1.

    The log-scan path clamps 1-alpha at 1e-10 instead of adding it: under jit, XLA
    constant-folds ``1 - alpha + 1e-10`` to ``1 - alpha`` (1 + 1e-10 == 1 in f32),
    which is exactly 0 at saturated alpha — log(0) = -inf makes the backward pass
    emit 0·inf = NaN. max() keeps the forward within 1e-10 of the literal-cumprod
    reference semantics AND routes the clamped branch's gradient to the constant,
    so the backward stays finite at alpha == 1."""
    if use_log_scan:
        one_minus = jnp.maximum(1.0 - alpha, 1e-10)
        log_t = jnp.cumsum(jnp.log(one_minus), axis=-1)
        t = jnp.exp(log_t)
    else:
        t = jnp.cumprod(1.0 - alpha + 1e-10, axis=-1)
    return jnp.concatenate([jnp.ones_like(t[..., :1]), t[..., :-1]], axis=-1)


def composite(
    raw: jnp.ndarray,      # [N, S, 4 + ins_num + 1] = [rgb, sigma, ins_logits]
    z_vals: jnp.ndarray,   # [N, S]
    rays_d: jnp.ndarray,   # [N, 3]
    keep_air: bool = False,
    detach_ins_weights: bool = True,
    use_log_scan: bool = True,
) -> Composited:
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = jnp.concatenate([dists, jnp.full_like(dists[..., :1], 1e10)], axis=-1)
    dists = dists * jnp.linalg.norm(rays_d, axis=-1, keepdims=True)

    rgb = jax.nn.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    ins_logits = raw[..., 4:]

    alpha = 1.0 - jnp.exp(-jax.nn.relu(sigma) * dists)
    weights = alpha * exclusive_cumprod_one_minus(alpha, use_log_scan)

    rgb_map = jnp.sum(weights[..., None] * rgb, axis=-2)
    depth_map = jnp.sum(weights * z_vals, axis=-1)

    w_ins = jax.lax.stop_gradient(weights) if detach_ins_weights else weights
    ins_map = jax.nn.sigmoid(jnp.sum(w_ins[..., None] * ins_logits, axis=-2))
    if not keep_air:
        ins_map = ins_map[..., :-1]

    return Composited(rgb=rgb_map, weights=weights, depth=depth_map, ins=ins_map)


def composite_maps(raw, z_vals, rays_d, keep_air: bool = False):
    """Forward-only fast path when rgb, depth AND ins are all consumed: ONE
    weighted reduction over the channel-concat [sigmoid(rgb) | z | ins_logits]
    instead of three separate [N,S,C] reductions; per-channel math identical
    to composite() (same reference render.py:6-28 / manipulator.py:86-110
    semantics — the ins weight detach is irrelevant with no gradient path, and
    the air-drop slice commutes with the elementwise sigmoid).

    Returns (rgb [N,3], ins [N, C(-1 if not keep_air)], depth [N]). Used by the
    image renderer (keep_air=False) and the manipulator's final composite
    (keep_air=True)."""
    w = composite(raw, z_vals, rays_d, keep_air=True,
                  detach_ins_weights=False).weights  # XLA DCEs the unused maps
    vals = jnp.concatenate(
        [jax.nn.sigmoid(raw[..., :3]), z_vals[..., None], raw[..., 4:]], axis=-1)
    acc = jnp.sum(vals * w[..., None], axis=-2)
    ins = jax.nn.sigmoid(acc[..., 4:])
    if not keep_air:
        ins = ins[..., :-1]
    # forward-only by construction: the single-reduction form drops the
    # ins-weight stop_gradient wall (a load-bearing reference semantic,
    # render.py:22-23), so refuse to be differentiated through rather than
    # silently training geometry from instance gradients (ADVICE r4)
    return jax.tree.map(jax.lax.stop_gradient, (acc[..., :3], ins, acc[..., 3]))
