"""Benchmark harness: train, render, manipulation and mesh-sweep throughput on one
GPU, fp32 + bf16, model FLOP/s utilization, and the XLA point query's own time.

Prints ONE JSON line with the headline metric plus a detail block:
  {"metric": "train_rays_per_sec", "value": N, "unit": "rays/s", "vs_baseline": R,
   "detail": {"device": {...}, "train_fp32": {...}, "train_bf16": {...},
              "render_fp32": {...}, "render_bf16": {...}, "mfu": {...},
              "query_fine": {...}}}

Config matches the reference's training schedule (BASELINE.md): 3072 rays/step,
64 coarse + 128 fine samples/ray, ins_num=32, Hungarian instance loss + emptiness
penalizer, Adam — the full fused train step, forward+backward+update. The render
bench sweeps a 256x256 image through the chunked image renderer (the tester path,
reference networks/tester.py:62-76).

vs_baseline: the reference repo publishes NO numbers (BASELINE.md), so the
denominator is MEASURED by running the actual PyTorch reference implementation
(mounted read-only at /root/reference, imported in-place, never copied) on the same
host with the same batch geometry. Only CPU torch is available there, so the ratio is
GPU vs host-CPU — recorded as such in the detail block (denominator_kind), NOT
presented as a GPU-vs-GPU comparison. The measurement is cached in
.bench_baseline.json.

MFU: analytic matmul FLOPs (PE/compositor/losses excluded — a strict lower bound on
real work) against the card's published dense peaks (PEAKS, keyed by device_kind;
an unknown device is an error). bf16 numbers carry a parity gate: 5 train steps from
identical init must stay within 1 dB fine-PSNR of fp32.

Needs a GPU: there is no CPU fallback. Every phase that fails fails the run.
All diagnostics go to stderr; stdout carries exactly the one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".bench_baseline.json")

N_RAYS = 3072
N_SAMPLES = 64
N_IMPORTANCE = 128
INS_NUM = 32
WARMUP = 3
ITERS = 20
RENDER_H = RENDER_W = 256
RENDER_REPS = 5   # isolated render timing is stable to <1 ms at 5 reps;
                  # 3 reps right after the train section read ~6% high

# Published dense peaks by JAX device_kind. Source: NVIDIA H100 Tensor Core GPU data
# sheet, SXM part, dense (no sparsity), at the full 700 W power limit: 989 TFLOP/s
# bf16, 495 TFLOP/s TF32, 3.35 TB/s HBM3. A card set to a lower power limit cannot
# hold its top clock under matmul load; the run prints the limit beside the numbers.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "tf32_flops": 495e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peak_for(device_kind: str) -> dict:
    """The PEAKS row of a device; an unknown device is an error, not a default."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peak for device_kind {device_kind!r}; add a PEAKS "
                       f"row with its source (known: {sorted(PEAKS)})")
    return PEAKS[device_kind]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _make_cfg(precision: str):
    from dmnerf_tpu.configs import Config

    return Config(
        N_train=N_RAYS, N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
        N_test=2048, near=2.0, far=7.0, ins_num=INS_NUM, perturb=1.0,
        penalize=True, tolerance=0.05, deta_w=0.05, precision=precision,
    )


def _make_batch(dense_ins: bool = False):
    """dense_ins=False: labels drawn from 8 instances — the typical-scene case
    (valid~8 rows in the dynamic-trip Hungarian). dense_ins=True: every one of
    the INS_NUM labels present (valid=INS_NUM), the JV solve's worst case — the
    regime real many-instance ScanNet scenes hit (VERDICT r3 weak #3)."""
    import jax.numpy as jnp
    from dmnerf_tpu.render.trainstep import Batch

    rng = np.random.RandomState(0)
    rays_d = rng.randn(N_RAYS, 3).astype(np.float32)
    rays_d[:, 2] = np.abs(rays_d[:, 2]) + 1.0
    if dense_ins:
        target_i = np.arange(N_RAYS) % INS_NUM  # all INS_NUM labels present
    else:
        target_i = rng.randint(0, 8, size=N_RAYS)
    return Batch(
        rays_o=jnp.zeros((N_RAYS, 3), jnp.float32),
        rays_d=jnp.asarray(rays_d),
        target_c=jnp.asarray(rng.rand(N_RAYS, 3).astype(np.float32)),
        target_i=jnp.asarray(target_i),
    )


def analytic_matmul_flops(cfg) -> dict:
    """Per-step matmul FLOPs (2*in*out per point), fwd and train(~3x fwd: dx+dW)."""
    from dmnerf_tpu.core.embedding import embed_dim

    D, W = cfg.netdepth, cfg.netwidth
    cp, cv = embed_dim(cfg.multires), embed_dim(cfg.multires_views)
    dims = []
    in_dim = cp
    for i in range(D):
        dims.append((in_dim, W))
        in_dim = W + cp if i in cfg.skips else W
    dims += [(W, 1), (W, W), (W + cv, W // 2), (W // 2, 3),          # density + rgb head
             (W, W), (W, W // 2), (W // 2, cfg.ins_num + 1)]          # ins head
    per_point = 2 * sum(i * o for i, o in dims)
    pts_coarse = N_RAYS * cfg.N_samples
    pts_fine = N_RAYS * (cfg.N_samples + cfg.N_importance)
    fwd = per_point * (pts_coarse + pts_fine)
    return {"fwd_flops": fwd, "train_flops": 3 * fwd, "per_point_flops": per_point}


def bench_train(precision: str, dense_ins: bool = False) -> dict:
    import jax

    cfg = _make_cfg(precision)
    from dmnerf_tpu.render.trainstep import create_train_state, make_train_step

    state = create_train_state(cfg, jax.random.PRNGKey(0))
    step = make_train_step(cfg)
    batch = _make_batch(dense_ins=dense_ins)
    key = jax.random.PRNGKey(1)
    for _ in range(WARMUP):
        key, sub = jax.random.split(key)
        state, aux = step(state, batch, sub)
    jax.block_until_ready(state.params_fine)

    t0 = time.perf_counter()
    for _ in range(ITERS):
        key, sub = jax.random.split(key)
        state, aux = step(state, batch, sub)
    jax.block_until_ready(state.params_fine)
    dt = time.perf_counter() - t0
    ms = dt / ITERS * 1e3
    rays_s = N_RAYS * ITERS / dt
    tag = f"{precision}{' dense_ins' if dense_ins else ''}"
    out = {"ms_per_step": round(ms, 2), "rays_per_sec": round(rays_s, 1),
           "loss": round(float(aux["total_loss"]), 4)}
    if dense_ins:
        out["n_instances_present"] = INS_NUM
        # keep the schema uniform with the train_fp32 row
        out["psnr_at_5_steps"] = None
        psnr_txt = ""
    else:
        psnr5 = _psnr_after_5_steps(cfg)
        out["psnr_at_5_steps"] = round(psnr5, 3)
        psnr_txt = f", psnr@5 {psnr5:.2f}"
    log(f"[bench] train {tag}: {ms:.2f} ms/step, {rays_s:,.0f} rays/s "
        f"(loss {float(aux['total_loss']):.4f}{psnr_txt})")
    return out


def bench_train_packed(precision: str, pack: int = 10) -> dict:
    """Scan-packed train throughput (cfg.steps_per_dispatch mode, train.py
    make_packed_steps): `pack` full sample-free steps fused into one lax.scan
    dispatch. Its gap to the dispatched mode is the per-dispatch host overhead —
    reported as a detail metric; the headline stays the dispatched mode."""
    import functools

    import jax

    cfg = _make_cfg(precision)
    from dmnerf_tpu.render.trainstep import create_train_state, make_train_step

    state = create_train_state(cfg, jax.random.PRNGKey(0))
    raw_step = make_train_step(cfg, jit=False)
    batch = _make_batch()

    @functools.partial(jax.jit, donate_argnums=(0,))
    def packed(st, key):
        def body(carry, _):
            s, k = carry
            k, sub = jax.random.split(k)
            s, aux = raw_step(s, batch, sub)
            return (s, k), aux["total_loss"]

        (st, key), losses = jax.lax.scan(body, (st, key), None, length=pack)
        return st, key, losses

    key = jax.random.PRNGKey(1)
    for _ in range(2):
        state, key, losses = packed(state, key)
    jax.block_until_ready(state)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        state, key, losses = packed(state, key)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    ms = dt / (reps * pack) * 1e3
    rays_s = N_RAYS * reps * pack / dt
    log(f"[bench] train {precision} packed x{pack}: {ms:.2f} ms/step, "
        f"{rays_s:,.0f} rays/s (loss {float(losses[-1]):.4f})")
    return {"ms_per_step": round(ms, 2), "rays_per_sec": round(rays_s, 1),
            "steps_per_dispatch": pack, "loss": round(float(losses[-1]), 4)}


_PSNR5 = {}


def _psnr_after_5_steps(cfg) -> float:
    """Short fixed-schedule fine-PSNR probe: the bf16 parity gate compares this
    against fp32 (identical PRNG keys and batch)."""
    import jax

    from dmnerf_tpu.render.trainstep import create_train_state, make_train_step

    if cfg.precision in _PSNR5:
        return _PSNR5[cfg.precision]
    state = create_train_state(cfg, jax.random.PRNGKey(0))
    step = make_train_step(cfg)
    batch = _make_batch()
    key = jax.random.PRNGKey(2)
    for _ in range(5):
        key, sub = jax.random.split(key)
        state, aux = step(state, batch, sub)
    _PSNR5[cfg.precision] = float(aux["psnr_fine"])
    return _PSNR5[cfg.precision]


def bench_render(precision: str) -> dict:
    import jax
    import jax.numpy as jnp

    cfg = _make_cfg(precision)
    from dmnerf_tpu.core.rays import rays_from_K
    from dmnerf_tpu.render.renderer import make_image_renderer
    from dmnerf_tpu.render.trainstep import create_train_state

    state = create_train_state(cfg, jax.random.PRNGKey(0))
    renderer = make_image_renderer(cfg)
    K = jnp.asarray([[300.0, 0, RENDER_W / 2], [0, -300.0, RENDER_H / 2], [0, 0, -1.0]])
    c2w = jnp.eye(4)
    ro, rd = rays_from_K(RENDER_H, RENDER_W, K, c2w)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)

    out = renderer(state.params_coarse, state.params_fine, ro, rd)  # compile
    jax.block_until_ready(out)
    for _ in range(2):  # settle the allocator after the train section
        out = renderer(state.params_coarse, state.params_fine, ro, rd)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(RENDER_REPS):
        out = renderer(state.params_coarse, state.params_fine, ro, rd)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / RENDER_REPS
    n_rays = RENDER_H * RENDER_W
    log(f"[bench] render {precision}: {dt*1e3:.1f} ms/image ({RENDER_H}x{RENDER_W}), "
        f"{n_rays/dt:,.0f} rays/s")
    return {"ms_per_image": round(dt * 1e3, 1), "rays_per_sec": round(n_rays / dt, 1),
            "image": f"{RENDER_H}x{RENDER_W}"}


def bench_mani_render(precision: str, n_targets: int = 1) -> dict:
    """Manipulation-render throughput: the two-pass union-z edit pipeline over a
    full image — the reference's single most expensive path (~6 MLP sweeps per
    chunk, networks/manipulator.py:245-267). n_targets=2 covers the reference's
    mani_mode=multi scaling (manipulator.py:137-205 loops per target)."""
    import jax
    import jax.numpy as jnp

    cfg = _make_cfg(precision)
    from dmnerf_tpu.core.rays import rays_from_K
    from dmnerf_tpu.render.manipulator import make_manipulator_renderer
    from dmnerf_tpu.render.trainstep import create_train_state

    state = create_train_state(cfg, jax.random.PRNGKey(0))
    mani = make_manipulator_renderer(cfg, n_targets=n_targets)
    K = jnp.asarray([[300.0, 0, RENDER_W / 2], [0, -300.0, RENDER_H / 2], [0, 0, -1.0]])
    ro, rd = rays_from_K(RENDER_H, RENDER_W, K, jnp.eye(4))
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    # inverse-transformed target bundles for rigid translations (mani_eval pose math)
    offs = [jnp.asarray([0.0, 0.25 * (k + 1), 0.0]) for k in range(n_targets)]
    tar_o = jnp.stack([ro - off for off in offs])
    tar_d = jnp.broadcast_to(rd[None], (n_targets,) + rd.shape)
    labels = tuple(range(1, n_targets + 1))

    out = mani(state.params_coarse, state.params_fine, ro, rd, tar_o, tar_d, labels)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(RENDER_REPS):
        out = mani(state.params_coarse, state.params_fine, ro, rd, tar_o, tar_d, labels)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / RENDER_REPS
    n_rays = RENDER_H * RENDER_W
    log(f"[bench] mani_render {precision}: {dt*1e3:.1f} ms/image ({RENDER_H}x{RENDER_W}, "
        f"{n_targets} target(s)), {n_rays/dt:,.0f} rays/s")
    return {"ms_per_image": round(dt * 1e3, 1), "rays_per_sec": round(n_rays / dt, 1),
            "image": f"{RENDER_H}x{RENDER_W}", "n_targets": n_targets}


def bench_mesh_sigma(precision: str, grid_dim: int = 256) -> dict:
    """Mesh-extraction grid-density sweep: grid_dim³ points through the chunked
    sigma query (tools.mesh_extract.make_sigma_query — XLA query +
    sigma_stub_params). The reference's single biggest inference job
    (/root/reference/tools/mesh_generator.py:27-49); previously a docstring
    figure only (VERDICT r4 weak #4), now gated every run."""
    import jax
    import jax.numpy as jnp

    cfg = _make_cfg(precision)
    from dmnerf_tpu.render.trainstep import create_train_state
    from dmnerf_tpu.tools.mesh_extract import build_grid, make_sigma_query

    state = create_train_state(cfg, jax.random.PRNGKey(0))
    grid = jnp.asarray(build_grid(np.eye(4), np.array([1.9, 7.0, 7.0]), grid_dim))
    query = make_sigma_query(cfg)
    sig = query(state.params_fine, grid)
    jax.block_until_ready(sig)
    t0 = time.perf_counter()
    for _ in range(3):
        sig = query(state.params_fine, grid)
    jax.block_until_ready(sig)
    dt = (time.perf_counter() - t0) / 3
    n = grid_dim ** 3
    log(f"[bench] mesh_sigma {precision}: {dt*1e3:.1f} ms / {grid_dim}^3 grid "
        f"({n/dt/1e6:,.1f} Mpts/s)")
    return {"ms_per_sweep": round(dt * 1e3, 1), "mpts_per_sec": round(n / dt / 1e6, 1),
            "grid": f"{grid_dim}^3"}


def bench_query() -> dict:
    """The XLA point query (PE + MLP) alone at the flagship fine-pass shape
    (N_RAYS x (N_SAMPLES + N_IMPORTANCE) points, ins_num 32): forward and
    forward+grad, at default matmul precision (TF32 may apply) and at "highest".
    This is the time a hand-written fused query kernel would have to beat."""
    import jax
    import jax.numpy as jnp

    from dmnerf_tpu.core.mlp import init_dm_nerf
    from dmnerf_tpu.core.pipeline import make_xla_query_fn

    N, S = N_RAYS, N_SAMPLES + N_IMPORTANCE
    params = init_dm_nerf(jax.random.PRNGKey(0), ins_num=INS_NUM)
    rng = np.random.RandomState(0)
    pts = jnp.asarray(rng.uniform(-3, 3, (N, S, 3)).astype(np.float32))
    dirs = rng.randn(N, 3).astype(np.float32)
    dirs = jnp.asarray(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    query = make_xla_query_fn()
    w = jnp.asarray(np.linspace(0.5, 1.5, 4 + INS_NUM + 1), jnp.float32)

    def loss(p):
        return jnp.sum(jnp.tanh(query(p, pts, dirs)) * w)

    def _time(f, *args, reps=10):
        jax.block_until_ready(f(*args))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = f(*args)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps * 1e3

    fwd_flops = analytic_matmul_flops(_make_cfg("float32"))["per_point_flops"] * N * S
    out = {"points": N * S, "fwd_gflops": round(fwd_flops / 1e9, 1)}
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            fwd = _time(jax.jit(query), params, pts, dirs)
            grad = _time(jax.jit(jax.value_and_grad(loss)), params)
        out[prec] = {"fwd_ms": round(fwd, 3), "fwd_grad_ms": round(grad, 3),
                     "fwd_tflops": round(fwd_flops / fwd / 1e9, 1),
                     "fwd_grad_tflops": round(3 * fwd_flops / grad / 1e9, 1)}
        log(f"[bench] query {prec}: fwd {fwd:.3f} ms ({out[prec]['fwd_tflops']} TFLOP/s), "
            f"fwd+grad {grad:.3f} ms ({out[prec]['fwd_grad_tflops']} TFLOP/s)")
    return out


REF_RAYS = 512   # reference measured at a smaller ray count (cost is linear in rays;
                 # full 3072-ray torch-CPU steps take minutes on this 2-vCPU host)


def bench_reference_cpu() -> float:
    """Run the actual PyTorch reference train step (imported from /root/reference,
    read-only) on host CPU with identical batch geometry."""
    import types

    import torch

    sys.path.insert(0, "/root/reference")
    try:
        from networks.dm_nerf import DM_NeRF, get_embedder
        from networks.evaluator import img2mse, ins_criterion
        from networks.penalizer import ins_penalizer
        from networks.render import dm_nerf as ref_dm_nerf
        from networks.helpers import z_val_sample as ref_z_val_sample
    finally:
        sys.path.pop(0)
    torch.autograd.set_detect_anomaly(False)  # fair timing: drop the reference's debug tax
    torch.manual_seed(0)

    args = types.SimpleNamespace(
        perturb=1.0, N_importance=N_IMPORTANCE, is_train=True, N_ins=None,
        penalize=True, tolerance=0.05, deta_w=0.05, ins_num=INS_NUM,
    )
    pos_emb, ch_pos = get_embedder(10, 0)
    view_emb, ch_view = get_embedder(4, 0)
    coarse = DM_NeRF(8, 256, ch_pos, ch_view, [4], INS_NUM)
    fine = DM_NeRF(8, 256, ch_pos, ch_view, [4], INS_NUM)
    opt = torch.optim.Adam(list(coarse.parameters()) + list(fine.parameters()), lr=5e-4)

    rng = np.random.RandomState(0)
    rays_d = rng.randn(REF_RAYS, 3).astype(np.float32)
    rays_d[:, 2] = np.abs(rays_d[:, 2]) + 1.0
    rays = torch.stack([torch.zeros(REF_RAYS, 3), torch.from_numpy(rays_d)], 0)
    target_c = torch.from_numpy(rng.rand(REF_RAYS, 3).astype(np.float32))
    target_i = torch.from_numpy(rng.randint(0, 8, size=REF_RAYS))
    z_coarse = ref_z_val_sample(REF_RAYS, 2.0, 7.0, N_SAMPLES)

    def one_step():
        info = ref_dm_nerf(rays, pos_emb, view_emb, coarse, fine, z_coarse, args)
        loss = img2mse(info["rgb_coarse"], target_c) + img2mse(info["rgb_fine"], target_c)
        loss = loss + ins_criterion(info["ins_coarse"], target_i, INS_NUM)[0]
        loss = loss + ins_criterion(info["ins_fine"], target_i, INS_NUM)[0]
        loss = loss + ins_penalizer(info["raw_coarse"], info["z_vals_coarse"],
                                    info["depth_coarse"], rays[1], args)
        loss = loss + ins_penalizer(info["raw_fine"], info["z_vals_fine"],
                                    info["depth_fine"], rays[1], args)
        opt.zero_grad()
        loss.backward()
        opt.step()

    one_step()  # warmup
    n = 2
    t0 = time.perf_counter()
    for _ in range(n):
        one_step()
    dt = time.perf_counter() - t0
    rays_s = REF_RAYS * n / dt
    log(f"[bench] reference torch-cpu step: {dt/n*1e3:.1f} ms/step, {rays_s:,.0f} rays/s")
    return rays_s


def get_baseline() -> float:
    if os.path.exists(CACHE):
        with open(CACHE) as f:
            return json.load(f)["reference_cpu_rays_per_sec"]
    try:
        base = bench_reference_cpu()
    except Exception as e:  # reference unavailable -> record the failure, use NaN
        log(f"[bench] reference measurement failed: {e!r}")
        base = float("nan")
    with open(CACHE, "w") as f:
        json.dump({"reference_cpu_rays_per_sec": base,
                   "note": "measured from /root/reference on host CPU (no GPU available); "
                           "denominator for vs_baseline"}, f)
    return base


def main():
    from dmnerf_tpu.utils.cache import enable_persistent_cache
    from dmnerf_tpu.utils.device_info import (card_info, device_summary, matmul_precision,
                                              require_gpu)

    enable_persistent_cache()
    dev = require_gpu()
    peak = peak_for(dev.device_kind)
    card = card_info()
    log(f"[bench] device {device_summary()}; card {card}; "
        f"matmul precision {matmul_precision()}")

    baseline = get_baseline()
    detail = {"device": {**device_summary(), "card": card,
                         "matmul_precision": matmul_precision()},
              "denominator_kind": "reference torch on host CPU "
              f"({REF_RAYS}-ray steps); no reference GPU run available"}

    detail["train_fp32"] = bench_train("float32")
    detail["train_fp32_dense_ins"] = bench_train("float32", dense_ins=True)
    detail["train_fp32_packed"] = bench_train_packed("float32")
    detail["render_fp32"] = bench_render("float32")
    detail["mesh_sigma_fp32"] = bench_mesh_sigma("float32")
    detail["mani_render_fp32"] = bench_mani_render("float32")
    detail["mani_render_fp32_2t"] = bench_mani_render("float32", n_targets=2)
    detail["train_bf16"] = bench_train("bfloat16")
    detail["render_bf16"] = bench_render("bfloat16")
    dpsnr = abs(detail["train_bf16"]["psnr_at_5_steps"]
                - detail["train_fp32"]["psnr_at_5_steps"])
    detail["bf16_parity"] = {"dpsnr_at_5_steps": round(dpsnr, 3), "pass": bool(dpsnr < 1.0)}
    detail["query_fine"] = bench_query()
    detail["peak_bytes_in_use"] = (dev.memory_stats() or {}).get("peak_bytes_in_use")

    flops = analytic_matmul_flops(_make_cfg("float32"))
    mfu = {}
    for k, peak_key in (("train_fp32", "tf32_flops"), ("train_fp32_packed", "tf32_flops"),
                        ("train_bf16", "bf16_flops")):
        achieved = flops["train_flops"] / (detail[k]["ms_per_step"] / 1e3)
        mfu[k] = {"achieved_tflops": round(achieved / 1e12, 2),
                  "mfu": round(achieved / peak[peak_key], 4), "vs_peak": peak_key}
    mfu["analytic_train_gflops_per_step"] = round(flops["train_flops"] / 1e9, 1)
    mfu["peaks"] = peak
    mfu["note"] = "matmul FLOPs only (lower bound); see docs/PERF.md"
    detail["mfu"] = mfu

    rays_s = detail["train_fp32"]["rays_per_sec"]
    vs = rays_s / baseline if baseline and np.isfinite(baseline) else None
    print(json.dumps({
        "metric": "train_rays_per_sec",
        "value": rays_s,
        "unit": "rays/s",
        "vs_baseline": round(vs, 2) if vs is not None else None,
        "detail": detail,
    }))


if __name__ == "__main__":
    main()
