"""Per-stage performance profiler for the train step (SURVEY §5 tracing plan).

Times each pipeline stage jitted separately at the flagship shape, then the
backward pass by loss-term subsets. Each timing ends in block_until_ready.

This is the bucket breakdown behind docs/PERF.md and BENCH detail (the reference
has no profiling at all — wall-clock prints only, tester.py:56,148).

CLI:
  python -m dmnerf_tpu.tools.profile_step stages     # forward-stage buckets
  python -m dmnerf_tpu.tools.profile_step backward   # grad cost by loss subset
  python -m dmnerf_tpu.tools.profile_step all
Options: --rays 3072 --ins 32 --iters 30
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def _timer(iters: int):
    import jax

    def t(name, f, *args):
        g = jax.jit(f)
        jax.block_until_ready(g(*args))
        t0 = time.perf_counter()
        for _ in range(iters):
            out = g(*args)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / iters * 1000
        print(f"{name:46s} {ms:8.2f} ms", flush=True)
        return ms

    return t


def profile_stages(n_rays: int, ins_num: int, iters: int):
    import jax
    import jax.numpy as jnp

    from dmnerf_tpu.configs import Config
    from dmnerf_tpu.core.compositor import composite
    from dmnerf_tpu.core.embedding import positional_encoding
    from dmnerf_tpu.core.mlp import dm_nerf_apply
    from dmnerf_tpu.core.sampling import sample_pdf, z_val_sample
    from dmnerf_tpu.render.trainstep import create_train_state

    N, S, SF = n_rays, 64, 192
    cfg = Config(N_train=N, N_samples=S, N_importance=128, near=2.0, far=7.0, ins_num=ins_num)
    state = create_train_state(cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    rays_d = jnp.asarray(rng.randn(N, 3).astype(np.float32))
    rays_o = jnp.zeros((N, 3))
    z_c = z_val_sample(N, cfg.near, cfg.far, S)
    z_f = jnp.sort(jnp.asarray(rng.rand(N, SF).astype(np.float32)) * 5 + 2, axis=-1)
    pts_f = rays_o[:, None, :] + rays_d[:, None, :] * z_f[..., None]
    viewdirs = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    emb_p = positional_encoding(pts_f, 10)
    emb_d = jnp.broadcast_to(positional_encoding(viewdirs, 4)[:, None, :], (N, SF, 27))
    raw = jnp.asarray(rng.randn(N, SF, 4 + ins_num + 1).astype(np.float32))
    weights = jnp.asarray(rng.rand(N, S).astype(np.float32))

    t = _timer(iters)
    print(f"== forward stages, N={N} rays ==")
    t("PE (fine pts)", lambda p: positional_encoding(p, 10), pts_f)
    t("MLP fine (pre-embedded)", dm_nerf_apply, state.params_fine, emb_p, emb_d)
    t("PE+MLP fine", lambda pr, p, d: dm_nerf_apply(
        pr, positional_encoding(p, 10),
        jnp.broadcast_to(positional_encoding(d, 4)[:, None, :], p.shape[:-1] + (27,))),
      state.params_fine, pts_f, viewdirs)
    t("composite fine", composite, raw, z_f, rays_d)
    t("sample_pdf (128 from 63 bins)", lambda w: sample_pdf(
        0.5 * (z_c[:, 1:] + z_c[:, :-1]), w[:, 1:-1], 128, key=jax.random.PRNGKey(0)), weights)
    t("sort union z", lambda a: jnp.sort(a, axis=-1),
      jnp.concatenate([z_c, z_f[:, :128]], -1))


def profile_backward(n_rays: int, ins_num: int, iters: int):
    import jax
    import jax.numpy as jnp

    from dmnerf_tpu.configs import Config
    from dmnerf_tpu.core.pipeline import make_xla_query_fn, render_rays
    from dmnerf_tpu.core.sampling import z_val_sample
    from dmnerf_tpu.objfield.losses import img2mse, ins_criterion
    from dmnerf_tpu.objfield.penalizer import ins_penalizer
    from dmnerf_tpu.render.trainstep import Batch, create_train_state

    N = n_rays
    cfg = Config(N_train=N, N_samples=64, N_importance=128, near=2.0, far=7.0,
                 ins_num=ins_num, perturb=1.0, penalize=True, tolerance=0.05, deta_w=0.05)
    state = create_train_state(cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    rays_d = rng.randn(N, 3).astype(np.float32)
    rays_d[:, 2] = np.abs(rays_d[:, 2]) + 1.0
    batch = Batch(jnp.zeros((N, 3)), jnp.asarray(rays_d),
                  jnp.asarray(rng.rand(N, 3).astype(np.float32)),
                  jnp.asarray(rng.randint(0, ins_num, size=N)))
    query = make_xla_query_fn(cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))
    z = z_val_sample(N, cfg.near, cfg.far, cfg.N_samples)
    key = jax.random.PRNGKey(1)

    def make_loss(q, parts):
        def loss(ps):
            info = render_rays(ps[0], ps[1], batch.rays_o, batch.rays_d, z, q,
                               N_importance=128, perturb=True, key=key)
            l = jnp.zeros(())
            if "rgb" in parts:
                l += img2mse(info["rgb_fine"], batch.target_c) + img2mse(info["rgb_coarse"], batch.target_c)
            if "ins" in parts:
                l += ins_criterion(info["ins_coarse"], batch.target_i, ins_num)[0]
                l += ins_criterion(info["ins_fine"], batch.target_i, ins_num)[0]
            if "pen" in parts:
                l += ins_penalizer(info["raw_coarse"], info["z_vals_coarse"],
                                   info["depth_coarse"], batch.rays_d, 0.05, 0.05)
                l += ins_penalizer(info["raw_fine"], info["z_vals_fine"],
                                   info["depth_fine"], batch.rays_d, 0.05, 0.05)
            return l
        return loss

    t = _timer(iters)
    pc, pf = state.params_coarse, state.params_fine
    print(f"== backward buckets, N={N} rays ==")
    t("fwd only (rgb loss)", lambda a, b: make_loss(query, ("rgb",))((a, b)), pc, pf)
    t("grad rgb", lambda a, b: jax.grad(make_loss(query, ("rgb",)))((a, b)), pc, pf)
    t("grad rgb+ins", lambda a, b: jax.grad(make_loss(query, ("rgb", "ins")))((a, b)), pc, pf)
    t("grad rgb+ins+pen (full)",
      lambda a, b: jax.grad(make_loss(query, ("rgb", "ins", "pen")))((a, b)), pc, pf)
    t("grad full REMAT",
      lambda a, b: jax.grad(make_loss(jax.checkpoint(query), ("rgb", "ins", "pen")))((a, b)),
      pc, pf)


def main(argv=None) -> int:
    from dmnerf_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=["stages", "backward", "all"])
    ap.add_argument("--rays", type=int, default=3072)
    ap.add_argument("--ins", type=int, default=32)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    if args.mode in ("stages", "all"):
        profile_stages(args.rays, args.ins, args.iters)
    if args.mode in ("backward", "all"):
        profile_backward(args.rays, args.ins, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
