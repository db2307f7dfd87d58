"""The jitted training step: forward render, losses, Adam update, LR decay.

Behavioral parity with the reference train loop body
(/root/reference/train_dmsr.py:17-110, train_replica.py, train_scannet.py):

  losses  = MSE(rgb_coarse) + MSE(rgb_fine)
          + ins_criterion(ins_coarse) + ins_criterion(ins_fine)
          + [optional] emptiness penalizer on both raw bundles (train_dmsr.py:53-60)
  optim   = Adam(lr=5e-4, betas=(0.9, 0.999))  (train_dmsr.py:127-128)
  decay   = lr = lrate * 0.1 ** (step / (lrate_decay * 1000))  (train_dmsr.py:68-73)

ScanNet variant: instance supervision applies only to the last N_ins rays of the batch
(the labeled suffix produced by the crop sampler; reference render.py:88-90 sliced
inside the renderer via mutable args.N_ins — here it is a static config constant
applied in the loss, keeping the renderer shape-stable).

Design:
 * ONE fused jit: render + Hungarian (in-graph) + losses + backward + Adam. The
   reference crossed the host boundary twice per step (data H2D + Hungarian D2H);
   this step never leaves the device.
 * donate_argnums on the train state: parameters and optimizer slots are updated
   in place in device memory, halving peak memory for the update.
 * the LR schedule is a closed-form function of the step counter, traced once.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from dmnerf_tpu.configs import Config
from dmnerf_tpu.core.mlp import init_dm_nerf
from dmnerf_tpu.core.pipeline import QueryFn, make_query_fn, render_rays
from dmnerf_tpu.core.sampling import z_val_sample
from dmnerf_tpu.objfield.losses import img2mse, ins_criterion, mse2psnr
from dmnerf_tpu.objfield.penalizer import ins_penalizer


class TrainState(NamedTuple):
    step: jnp.ndarray
    params_coarse: Dict
    params_fine: Dict
    opt_state: optax.OptState


class Batch(NamedTuple):
    rays_o: jnp.ndarray    # [N, 3]
    rays_d: jnp.ndarray    # [N, 3]
    target_c: jnp.ndarray  # [N, 3]
    target_i: jnp.ndarray  # [N] int (ScanNet: only the last N_ins entries are valid)
    target_valid: Optional[jnp.ndarray] = None  # [N] bool; None = all rays supervised.
    # Carries the crop sampler's padding mask: when an image has fewer labeled
    # pixels than N_ins, the padded suffix slots must not enter the instance loss
    # (reference clamps N_ins dynamically, helpers.py:64-67; we mask instead to
    # keep the step shape-static).


def lr_at_step(cfg: Config, step) -> jnp.ndarray:
    """Exponential decay matching train_dmsr.py:68-73."""
    decay_steps = cfg.lrate_decay * 1000.0
    return cfg.lrate * jnp.power(0.1, step / decay_steps)


def make_optimizer(cfg: Config) -> optax.GradientTransformation:
    return optax.adam(learning_rate=lambda step: lr_at_step(cfg, step), b1=0.9, b2=0.999)


def create_train_state(cfg: Config, key) -> TrainState:
    kc, kf = jax.random.split(key)
    dtype = jnp.bfloat16 if cfg.precision == "bfloat16" else jnp.float32
    from dmnerf_tpu.core.embedding import embed_dim

    kwargs = dict(
        ins_num=cfg.ins_num,
        D=cfg.netdepth,
        W=cfg.netwidth,
        input_ch_pts=embed_dim(cfg.multires if cfg.i_embed == 0 else -1),
        input_ch_views=embed_dim(cfg.multires_views if cfg.i_embed == 0 else -1),
        skips=tuple(cfg.skips),
        dtype=dtype,
    )
    params_coarse = init_dm_nerf(kc, **kwargs)
    params_fine = init_dm_nerf(kf, **kwargs)
    opt_state = make_optimizer(cfg).init((params_coarse, params_fine))
    return TrainState(jnp.zeros((), jnp.int32), params_coarse, params_fine, opt_state)


def compute_losses(
    cfg: Config,
    info: Dict[str, jnp.ndarray],
    batch: Batch,
    N_ins: Optional[int],
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    rgb_loss_coarse = img2mse(info["rgb_coarse"], batch.target_c)
    rgb_loss_fine = img2mse(info["rgb_fine"], batch.target_c)

    if N_ins is not None:
        # labeled-suffix slicing (reference render.py:88-90 + train_scannet.py:31)
        ins_coarse = info["ins_coarse"][-N_ins:]
        ins_fine = info["ins_fine"][-N_ins:]
        target_i = batch.target_i[-N_ins:]
        ray_mask = None if batch.target_valid is None else batch.target_valid[-N_ins:]
    else:
        ins_coarse, ins_fine, target_i = info["ins_coarse"], info["ins_fine"], batch.target_i
        ray_mask = batch.target_valid

    # coarse+fine instance losses batched under ONE vmap: the Hungarian solves —
    # serialized lax.while_loop latency, the single largest non-matmul cost in the
    # step — run in lockstep (total iterations = max of the two, not the sum).
    # Identical math to two separate ins_criterion calls (reference train_dmsr.py:41-50).
    (ins_losses, vces, ices, vsious) = jax.vmap(
        lambda p: ins_criterion(p, target_i, cfg.ins_num, ray_mask)
    )(jnp.stack([ins_coarse, ins_fine]))
    ins_loss_coarse, ins_loss_fine = ins_losses[0], ins_losses[1]
    vce_f, ice_f, vsiou_f = vces[1], ices[1], vsious[1]

    total = rgb_loss_coarse + rgb_loss_fine + ins_loss_coarse + ins_loss_fine
    emptiness = jnp.zeros((), total.dtype)
    if cfg.penalize:
        emptiness = ins_penalizer(
            info["raw_coarse"], info["z_vals_coarse"], info["depth_coarse"],
            batch.rays_d, cfg.tolerance, cfg.deta_w,
        ) + ins_penalizer(
            info["raw_fine"], info["z_vals_fine"], info["depth_fine"],
            batch.rays_d, cfg.tolerance, cfg.deta_w,
        )
        total = total + emptiness

    aux = {
        "psnr_coarse": mse2psnr(rgb_loss_coarse),
        "psnr_fine": mse2psnr(rgb_loss_fine),
        "rgb_loss": rgb_loss_coarse + rgb_loss_fine,
        "ins_loss": ins_loss_coarse + ins_loss_fine,
        "valid_ce_fine": vce_f,
        "invalid_ce_fine": ice_f,
        "valid_siou_fine": vsiou_f,
        "emptiness_loss": emptiness,
        "total_loss": total,
    }
    return total, aux


def make_loss_fn(
    cfg: Config,
    query_fn: Optional[QueryFn] = None,
    N_ins: Optional[int] = None,
):
    """The train step's objective: loss_fn((params_coarse, params_fine), batch, key)
    -> (total_loss, aux) for a batch of cfg.N_train rays."""
    if query_fn is None:
        query_fn = make_query_fn(cfg)
    z_coarse_base = z_val_sample(cfg.N_train, cfg.near, cfg.far, cfg.N_samples)

    def loss_fn(params: Tuple[Dict, Dict], batch: Batch, key):
        pc, pf = params
        info = render_rays(
            pc, pf, batch.rays_o, batch.rays_d, z_coarse_base, query_fn,
            N_importance=cfg.N_importance, perturb=cfg.perturb > 0.0, key=key,
        )
        return compute_losses(cfg, info, batch, N_ins)

    return loss_fn


def make_train_step(
    cfg: Config,
    query_fn: Optional[QueryFn] = None,
    N_ins: Optional[int] = None,
    jit: bool = True,
):
    """Build the fused train step. Returns step_fn(state, batch, key) -> (state, aux).

    jit=False returns the untraced function so callers (parallel.mesh) can re-jit it
    with explicit mesh shardings."""
    optimizer = make_optimizer(cfg)
    loss_fn = make_loss_fn(cfg, query_fn, N_ins)

    def step_fn(state: TrainState, batch: Batch, key):
        params = (state.params_coarse, state.params_fine)
        (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch, key)
        updates, opt_state = optimizer.update(grads, state.opt_state, params)
        pc, pf = optax.apply_updates(params, updates)
        return TrainState(state.step + 1, pc, pf, opt_state), aux

    if jit:
        return jax.jit(step_fn, donate_argnums=(0,))
    return step_fn
