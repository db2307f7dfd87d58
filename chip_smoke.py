#!/usr/bin/env python3
"""Smoke test of dmnerf_tpu on an NVIDIA GPU: train, evaluate, edit and mesh.

Drives the main path once through the entry points a user calls, at the flagship
width of configs/train/dmsr/study.txt (8x256 coarse and fine MLPs, 64+128 samples
per ray, 3072 rays per step, over_penalize), from random weights made from a fixed
seed, on a synthetic DM-SR scene. Phases, in order:

  device     JAX must see a GPU (no CPU fallback); prints the device kind and count
             and the card's name and power limit as nvidia-smi gives them.
  scene      data.synthetic.write_dmsr_scene: 400x400, 20 train + 2 test views,
             6 objects, translation-edit ground truth, seed 0.
  train      python -m dmnerf_tpu.train on study.txt with datadir, basedir,
             N_iters, i_print, i_save, i_test overridden: RGB, Ins and Reg losses
             finite and falling from the first print to the last, a checkpoint
             written, ms/step after warm-up.
  resume     the train CLI again with 10 more iterations: it must resume from the
             step the first run saved last.
  reference  the XLA point query and the train step's loss+gradient at default
             matmul precision (TF32 may apply) against the same code under
             "highest", and "highest" on the GPU against the CPU backend of the
             same process (tolerances and reasons at TOL below).
  render     python -m dmnerf_tpu.test, render mode: per-view PSNR/SSIM/mAP, PNGs.
  mani_eval  python -m dmnerf_tpu.test, mani_eval with mani_mode = translation.
  mesh       python -m dmnerf_tpu.test, mesh mode.

Cuts of scale (widths are the flagship's): N_iters 501 of the reference's 500k
schedule; 22 views of a synthetic scene; mesh grid 128^3 (reference 256^3) and
iso-level 0.02 (reference 0.45: occupancy = 1-exp(-sigma*(far-near)/N_importance)
stays low for a model trained briefly at N_importance 128 — a 3000-step flagship
model on a 3-object scene peaked at occupancy 0.119); the GPU-vs-CPU comparison on
256 rays (the CPU backend would take minutes on 3072).

--four-cards runs only the multi-device path that users reach whenever more than
one device is visible (parallel/mesh.py): the sharded train step, the sharded
image render and the sharded mesh sigma sweep on a 1-D mesh of 4 GPUs under
"highest", each against the single-GPU result.

Every phase runs in a child process of its own, one after another, so one process
at a time holds the card. A failed phase stops the run with a non-zero exit. The
last line of stdout is {"ok": true, "device": {"platform", "kind", "count"}}.

Usage:  python chip_smoke.py [--four-cards] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
STUDY = os.path.join(REPO, "configs", "train", "dmsr", "study.txt")

SCENE = dict(n_train=20, n_test=2, H=400, W=400, n_objects=6, ins_num=8, seed=0,
             radius=8.0, mani_modes=["translation"])
N_ITERS, I_PRINT, I_SAVE = 501, 100, 250
RESUME_ITERS = 10
MESH_GRID, MESH_LEVEL = 128, 0.02
CPU_RAYS = 256
TARGET_LABEL = 1   # sphere_0, which the translation GT moves by [0, -0.25, 0]

# Tolerances, each a max|diff| over the scale named.
TOL = {
    # TF32 keeps 10 mantissa bits (~5e-4 relative per product); the query chains
    # 11 matmuls, so its outputs may move by ~1e-3 of their scale and no more than
    # ~1e-2.
    "tf32_query": 1e-2,
    # loss: a mean over thousands of rays, so rounding averages out.
    "tf32_loss_rel": 1e-2,
    # gradients, as ||g_a - g_b|| / ||g_b|| over the whole pytree. Every dW and db
    # is a sum over all points (589k at 3072 rays, 49k at 256) with heavy
    # cancellation, so a single leaf's max-relative error is ill-conditioned: the
    # first H100 run measured the fine trunk_0_b differing by 6.8e-3 of its max
    # between GPU and CPU under "highest" while the loss agreed to 1.3e-6, and by
    # 3.4e-2 (ins_out_b) between TF32 and "highest". The global norm bounds catch a
    # wrong gradient (an O(1) error) without failing on summation order.
    "tf32_grad": 5e-2,
    # float32 on both backends: only the summation order differs.
    "cpu_query": 1e-4,
    "cpu_loss_rel": 1e-4,
    "cpu_grad": 5e-3,
    # sharded vs single device, as in the CPU mesh tests (tests/test_data_and_train.py):
    # the gradient all-reduce adds per-device partial sums in another order.
    "mesh_loss_rel": 1e-4,
    "mesh_params_atol": 1e-5, "mesh_params_rtol": 1e-3,
    # the all-reduced gradient as a relative L2 norm: summation order only (GPU vs
    # CPU measured 2.0e-4); a missing or partial all-reduce gives O(1).
    "mesh_grad": 1e-3,
    # params outside atol/rtol after one Adam step are allowed only where the
    # single-device gradient is below this share of its leaf's largest entry:
    # there Adam's lr*g/(|g|+eps) turns summation-order noise into a sign flip.
    # The first 4-GPU run measured a worst |d|/(atol+rtol|p|) of 8.677 with the
    # loss equal to 7.9e-8.
    "mesh_grad_near_zero": 1e-2,
    # render and sigma sweep: per-ray/per-point work with the same chunk shapes on
    # every device; nothing is summed across devices.
    "mesh_render_atol": 1e-5, "mesh_render_rtol": 1e-4,
}

PHASE_TIMEOUT = {"device": 120, "scene": 300, "train": 600, "resume": 300,
                 "reference": 600, "render": 300, "mani_eval": 400, "mesh": 400,
                 "four_cards": 900}
BUDGET_S = 1150

TRAIN_RE = re.compile(
    r"\[TRAIN\] Iter: (\d+) F_PSNR: (\S+) C_PSNR: (\S+) Total: (\S+) RGB: (\S+) "
    r"Ins: (\S+) Reg: (\S+) rays/s: ([\d,.]+)")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def final_line(device: dict) -> str:
    """The last line of stdout: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {"platform": device["platform"],
                                              "kind": device["kind"],
                                              "count": device["count"]}})


def plan(four_cards: bool) -> list:
    if four_cards:
        return ["four_cards"]
    return ["device", "scene", "train", "resume", "reference", "render", "mani_eval",
            "mesh"]


def parse_train_log(text: str) -> list:
    """The [TRAIN] print lines of the train CLI, as dicts."""
    rows = []
    for m in TRAIN_RE.finditer(text):
        it, fpsnr, cpsnr, total, rgb, ins, reg, rays = m.groups()
        rows.append({"iter": int(it), "psnr_fine": float(fpsnr), "total": float(total),
                     "rgb": float(rgb), "ins": float(ins), "reg": float(reg),
                     "rays_per_s": float(rays.replace(",", ""))})
    return rows


def check_losses_fall(rows: list) -> None:
    check(len(rows) >= 2, f"need at least two [TRAIN] prints, got {len(rows)}")
    for key in ("rgb", "ins", "reg"):
        vals = [r[key] for r in rows]
        check(all(math.isfinite(v) for v in vals), f"{key} loss not finite: {vals}")
        check(vals[-1] < vals[0], f"{key} loss did not fall: first {vals[0]} last {vals[-1]}")


# ----------------------------------------------------------------------------------
# parent: runs each phase in a child, one at a time

def _run(cmd: list, timeout: float, env_extra: dict | None = None) -> str:
    """Run a child, echo its output line by line, return the output. Raises
    SmokeFailure on a non-zero exit or a timeout (the child's process group is
    killed)."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p), **(env_extra or {})}
    print(f"[smoke] $ {' '.join(cmd)}", flush=True)
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    lines = []

    def pump():
        for line in proc.stdout:
            lines.append(line)
            print("  " + line, end="", flush=True)

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        reader.join(timeout=10)
    out = "".join(lines)
    check(rc is not None, f"timed out after {timeout:.0f}s")
    check(rc == 0, f"exit code {rc}")
    return out


def _child_result(out: str) -> dict:
    found = [line[len("SMOKE_RESULT "):] for line in out.splitlines()
             if line.startswith("SMOKE_RESULT ")]
    check(bool(found), "child printed no SMOKE_RESULT line")
    return json.loads(found[-1])


def _phase_child(name: str, work: str, timeout: float, env_extra=None) -> dict:
    return _child_result(_run([sys.executable, os.path.abspath(__file__), "--phase", name,
                               "--workdir", work], timeout, env_extra))


def _ckpt_steps(log_dir: str) -> list:
    return sorted(int(os.path.basename(os.path.dirname(p)))
                  for p in glob.glob(os.path.join(log_dir, "checkpoints", "*", "state.npz")))


def _cli(module: str, work: str, *extra: str) -> list:
    return [sys.executable, "-u", "-m", module, "--config", STUDY,
            f"datadir={os.path.join(work, 'scene')}", f"basedir={os.path.join(work, 'logs')}",
            *extra]


def _log_dir(work: str) -> str:
    return os.path.join(work, "logs", "study", "run")


def phase_train(work, results, timeout):
    out = _run(_cli("dmnerf_tpu.train", work, f"N_iters={N_ITERS}", f"i_print={I_PRINT}",
                    f"i_save={I_SAVE}", f"i_test={100 * N_ITERS}"), timeout)
    rows = parse_train_log(out)
    check_losses_fall(rows)
    steps = _ckpt_steps(_log_dir(work))
    check(N_ITERS in steps, f"no checkpoint at step {N_ITERS}: {steps}")
    warm = rows[-1]
    ms = 3072 / warm["rays_per_s"] * 1e3
    first, last = rows[0], rows[-1]
    print(f"[smoke] train: RGB {first['rgb']:.4f} -> {last['rgb']:.4f}, Ins {first['ins']:.4f}"
          f" -> {last['ins']:.4f}, Reg {first['reg']:.4f} -> {last['reg']:.4f}, "
          f"F_PSNR {last['psnr_fine']:.2f}; {ms:.2f} ms/step over iters "
          f"{rows[-2]['iter'] + 1}-{last['iter']} on {results['device']['card']}",
          flush=True)
    return {"rows": rows, "ms_per_step": ms, "checkpoints": steps}


def phase_resume(work, results, timeout):
    saved = results["train"]["checkpoints"][-1]
    out = _run(_cli("dmnerf_tpu.train", work, f"N_iters={saved + RESUME_ITERS}",
                    f"i_print={I_PRINT}", f"i_save={I_SAVE}", f"i_test={100 * N_ITERS}"),
               timeout)
    m = re.search(r"\[train\] resumed from step (\d+)", out)
    check(m is not None, "train CLI did not resume")
    check(int(m.group(1)) == saved, f"resumed from step {m.group(1)}, saved {saved}")
    steps = _ckpt_steps(_log_dir(work))
    check(saved + RESUME_ITERS in steps, f"no checkpoint after resume: {steps}")
    print(f"[smoke] resume: restored step {saved}, ran to {saved + RESUME_ITERS}", flush=True)
    return {"resumed_from": saved}


def phase_render(work, results, timeout):
    out = _run(_cli("dmnerf_tpu.test", work, "--render"), timeout)
    views = re.findall(r"\[eval\] view \d+: PSNR (\S+) SSIM (\S+) AP@\.5 (\S+)", out)
    check(len(views) == SCENE["n_test"], f"expected {SCENE['n_test']} eval lines, got {views}")
    for psnr, ssim, ap in views:
        check(math.isfinite(float(psnr)) and 0.0 <= float(ssim) <= 1.0
              and 0.0 <= float(ap) <= 1.0, f"bad eval line {psnr} {ssim} {ap}")
    d = glob.glob(os.path.join(_log_dir(work), "render_path_*"))
    check(len(d) == 1, f"render dir: {d}")
    pngs = glob.glob(os.path.join(d[0], "*.png"))
    check(os.path.exists(os.path.join(d[0], "test_results.txt")), "no test_results.txt")
    check(len(pngs) >= 2 * SCENE["n_test"], f"render PNGs: {len(pngs)}")
    print(f"[smoke] render: PSNR {[float(v[0]) for v in views]}, "
          f"AP@.5 {[float(v[2]) for v in views]}, {len(pngs)} PNGs", flush=True)
    return {"psnr": [float(v[0]) for v in views]}


def phase_mani_eval(work, results, timeout):
    out = _run(_cli("dmnerf_tpu.test", work, "--mani_eval", "mani_mode=translation",
                    f"target_label={TARGET_LABEL}"), timeout)
    views = re.findall(r"\[mani_eval\] view \d+: PSNR (\S+)", out)
    check(len(views) == SCENE["n_test"], f"expected {SCENE['n_test']} mani_eval lines")
    check(all(math.isfinite(float(v)) for v in views), f"non-finite PSNR {views}")
    d = glob.glob(os.path.join(_log_dir(work), "mani_eval_*", "translation"))
    check(len(d) == 1, f"mani_eval dir: {d}")
    check(os.path.exists(os.path.join(d[0], "test_results.txt")), "no test_results.txt")
    check(len(glob.glob(os.path.join(d[0], "*_rgb.png"))) == SCENE["n_test"], "rgb PNGs")
    print(f"[smoke] mani_eval: PSNR {[float(v) for v in views]}", flush=True)
    return {"psnr": [float(v) for v in views]}


def phase_mesh(work, results, timeout):
    out = _run(_cli("dmnerf_tpu.test", work, "--mesh", f"mesh_grid_dim={MESH_GRID}",
                    f"mesh_level={MESH_LEVEL}"), timeout)
    check("Meshing Done" in out, "mesh phase did not finish")
    d = glob.glob(os.path.join(_log_dir(work), "mesh_*"))
    check(len(d) == 1, f"mesh dir: {d}")
    for f in ("mesh.ply", "color_mesh.ply"):
        check(os.path.exists(os.path.join(d[0], f)), f"no {f} (empty iso-surface?)")
    m = re.search(r"\[mesh\] cleaned: (\d+) verts, (\d+) faces", out)
    print(f"[smoke] mesh: {m.group(0) if m else 'written'}", flush=True)
    return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mesh path against one GPU")
    ap.add_argument("--workdir", default=os.path.join(REPO, "logs", "chip_smoke"))
    ap.add_argument("--phase", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    work = os.path.abspath(args.workdir)
    if args.phase:
        return child_main(args.phase, work)

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.time()
    results = {}
    parent_phases = {"train": phase_train, "resume": phase_resume, "render": phase_render,
                     "mani_eval": phase_mani_eval, "mesh": phase_mesh}
    for name in plan(args.four_cards):
        timeout = min(PHASE_TIMEOUT[name], BUDGET_S - (time.time() - t0))
        print(f"[smoke] === {name} ({time.time() - t0:.0f}s elapsed)", flush=True)
        try:
            check(timeout > 0, "time budget spent")
            if name in parent_phases:
                results[name] = parent_phases[name](work, results, timeout)
            else:
                env = {"JAX_PLATFORMS": "cpu"} if name == "scene" else None
                results[name] = _phase_child(name, work, timeout, env)
        except SmokeFailure as e:
            print(f"[smoke] FAIL {name}: {e}", flush=True)
            return 1
    device = results["four_cards" if args.four_cards else "device"]
    print(f"[smoke] card: {device['card']}", flush=True)
    print(f"[smoke] all phases passed in {time.time() - t0:.0f}s", flush=True)
    print(final_line(device), flush=True)
    return 0


# ----------------------------------------------------------------------------------
# children: one phase each, JAX imported only here

def child_main(name: str, work: str) -> int:
    fn = {"device": child_device, "scene": child_scene, "reference": child_reference,
          "four_cards": child_four_cards}[name]
    result = fn(work)
    print("SMOKE_RESULT " + json.dumps(result), flush=True)
    return 0


def _gpu_device_record() -> dict:
    from dmnerf_tpu.utils.device_info import card_info, device_summary, require_gpu

    require_gpu()
    summary = device_summary()
    card = card_info()
    print(f"[smoke] JAX devices: {summary}")
    print(card, flush=True)
    return {**summary, "card": card.replace("\n", "; ")}


def child_device(work: str) -> dict:
    from dmnerf_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    return _gpu_device_record()


def child_scene(work: str) -> dict:
    from dmnerf_tpu.data.synthetic import write_dmsr_scene

    t0 = time.time()
    write_dmsr_scene(os.path.join(work, "scene"), **SCENE)
    print(f"[smoke] scene written in {time.time() - t0:.1f}s: {SCENE}", flush=True)
    return {}


def _flagship_cfg(**kw):
    from dmnerf_tpu.configs import load_config

    return load_config(STUDY, **kw)


def _ray_batch(n: int, ins_num: int, seed: int = 0):
    import jax.numpy as jnp
    import numpy as np

    from dmnerf_tpu.render.trainstep import Batch

    rng = np.random.RandomState(seed)
    rays_d = rng.randn(n, 3).astype(np.float32)
    rays_d[:, 2] = np.abs(rays_d[:, 2]) + 1.0
    return Batch(rays_o=jnp.zeros((n, 3), jnp.float32), rays_d=jnp.asarray(rays_d),
                 target_c=jnp.asarray(rng.rand(n, 3).astype(np.float32)),
                 target_i=jnp.asarray(rng.randint(0, min(8, ins_num), size=n)))


def max_rel(a, b) -> float:
    """max|a - b| over max|b| (1 where b is all zero)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    return float(np.max(np.abs(a - b))) / (scale if scale > 0 else 1.0)


def rel_l2(ga, gb) -> float:
    """||ga - gb|| / ||gb|| over every leaf of two pytrees, in float64."""
    import jax
    import numpy as np

    pairs = [(np.asarray(a, np.float64), np.asarray(b, np.float64))
             for a, b in zip(jax.tree_util.tree_leaves(ga), jax.tree_util.tree_leaves(gb))]
    num = sum(float(np.sum((a - b) ** 2)) for a, b in pairs)
    den = sum(float(np.sum(b ** 2)) for _, b in pairs)
    return math.sqrt(num / den) if den > 0 else math.sqrt(num)


def worst_leaf(ga, gb) -> tuple:
    """(max over leaves of max_rel, name of that leaf) for two gradient pytrees."""
    import jax

    pa = jax.tree_util.tree_flatten_with_path(ga)[0]
    pb = jax.tree_util.tree_leaves(gb)
    worst = max(((max_rel(a, b), jax.tree_util.keystr(k)) for (k, a), b in zip(pa, pb)))
    return worst


def compare_precisions(cfg, n_rays: int, device=None,
                       precisions=("default", "highest")) -> dict:
    """Query outputs and the train objective's loss + grads at each matmul
    precision, on `device` (default: the default device)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dmnerf_tpu.core.pipeline import make_query_fn
    from dmnerf_tpu.render.trainstep import create_train_state, make_loss_fn

    cfg = cfg.replace(N_train=n_rays)
    state = create_train_state(cfg, jax.random.PRNGKey(0))
    params = (state.params_coarse, state.params_fine)
    rng = np.random.RandomState(1)
    S = cfg.N_samples + cfg.N_importance
    pts = jnp.asarray(rng.uniform(-3, 3, (n_rays, S, 3)).astype(np.float32))
    dirs = rng.randn(n_rays, 3).astype(np.float32)
    dirs = jnp.asarray(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    batch, key = _ray_batch(n_rays, cfg.ins_num), jax.random.PRNGKey(2)
    if device is not None:
        params, pts, dirs, batch, key = jax.device_put((params, pts, dirs, batch, key), device)
    query = jax.jit(make_query_fn(cfg))
    objective = jax.jit(jax.value_and_grad(make_loss_fn(cfg), has_aux=True))
    out = {}
    for prec in precisions:
        with jax.default_matmul_precision(prec):
            q = np.asarray(query(params[1], pts, dirs))
            (loss, _), grads = objective(params, batch, key)
            out[prec] = {"query": q, "loss": float(loss),
                         "grads": jax.tree_util.tree_map(np.asarray, grads)}
    return out


def child_reference(work: str) -> dict:
    import jax

    from dmnerf_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    device = _gpu_device_record()
    cfg = _flagship_cfg(ins_num=32)
    res = {"device": device}
    ok = True

    t0 = time.time()
    gpu = compare_precisions(cfg, cfg.N_train)
    d, h = gpu["default"], gpu["highest"]
    q = max_rel(d["query"], h["query"])
    lo = abs(d["loss"] - h["loss"]) / abs(h["loss"])
    g = rel_l2(d["grads"], h["grads"])
    wl, leaf = worst_leaf(d["grads"], h["grads"])
    passed = q <= TOL["tf32_query"] and lo <= TOL["tf32_loss_rel"] and g <= TOL["tf32_grad"]
    ok &= passed
    print(f"[smoke] default vs highest on GPU ({cfg.N_train} rays x "
          f"{cfg.N_samples + cfg.N_importance} samples, 8x256, ins_num 32): query "
          f"max|d| {q:.3e} of scale {float(abs(h['query']).max()):.3e} (tol "
          f"{TOL['tf32_query']}); loss {d['loss']:.6f} vs {h['loss']:.6f}, rel {lo:.3e} "
          f"(tol {TOL['tf32_loss_rel']}); grads rel L2 {g:.3e} (tol {TOL['tf32_grad']}), "
          f"worst leaf {leaf} max|d|/max {wl:.3e} -> {'PASS' if passed else 'FAIL'} "
          f"[{time.time() - t0:.0f}s]", flush=True)
    res["tf32_vs_highest"] = {"query": q, "loss_rel": lo, "grad_rel_l2": g,
                              "grad_worst_leaf": wl, "pass": passed}

    t0 = time.time()
    on_gpu = compare_precisions(cfg, CPU_RAYS, precisions=("highest",))["highest"]
    on_cpu = compare_precisions(cfg, CPU_RAYS, jax.devices("cpu")[0],
                                precisions=("highest",))["highest"]
    q = max_rel(on_gpu["query"], on_cpu["query"])
    lo = abs(on_gpu["loss"] - on_cpu["loss"]) / abs(on_cpu["loss"])
    g = rel_l2(on_gpu["grads"], on_cpu["grads"])
    wl, leaf = worst_leaf(on_gpu["grads"], on_cpu["grads"])
    passed = q <= TOL["cpu_query"] and lo <= TOL["cpu_loss_rel"] and g <= TOL["cpu_grad"]
    ok &= passed
    print(f"[smoke] highest GPU vs CPU ({CPU_RAYS} rays, 8x256, ins_num 32): query max|d| "
          f"{q:.3e} of scale (tol {TOL['cpu_query']}); loss {on_gpu['loss']:.6f} vs "
          f"{on_cpu['loss']:.6f}, rel {lo:.3e} (tol {TOL['cpu_loss_rel']}); grads rel L2 "
          f"{g:.3e} (tol {TOL['cpu_grad']}), worst leaf {leaf} max|d|/max {wl:.3e} -> "
          f"{'PASS' if passed else 'FAIL'} "
          f"[{time.time() - t0:.0f}s]", flush=True)
    res["gpu_vs_cpu"] = {"query": q, "loss_rel": lo, "grad_rel_l2": g,
                         "grad_worst_leaf": wl, "pass": passed}
    check(ok, "reference comparison out of tolerance")
    return res


def compare_mesh_paths(cfg, devices, render_hw: int = 128, grid_dim: int = 64) -> dict:
    """parallel/mesh.py on `devices` against one device, under "highest": the sharded
    train step (loss, all-reduced gradient, updated params), the sharded image
    render and the sharded mesh sigma sweep."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dmnerf_tpu.core.rays import rays_from_K
    from dmnerf_tpu.parallel.mesh import (make_mesh, make_sharded_image_renderer,
                                          make_sharded_sigma_query, make_sharded_train_step,
                                          shard_batch)
    from dmnerf_tpu.render.renderer import make_image_renderer
    from dmnerf_tpu.render.trainstep import create_train_state, make_loss_fn, make_train_step
    from dmnerf_tpu.tools.mesh_extract import build_grid, make_sigma_query
    from jax.sharding import NamedSharding, PartitionSpec as P

    out = {}
    with jax.default_matmul_precision("highest"):
        mesh = make_mesh(devices=devices)
        state = create_train_state(cfg, jax.random.PRNGKey(0))
        batch, key = _ray_batch(cfg.N_train, cfg.ins_num), jax.random.PRNGKey(1)
        copy = lambda: jax.tree_util.tree_map(lambda x: x.copy(), state)  # noqa: E731
        s1, a1 = make_train_step(cfg)(copy(), batch, key)
        sN, aN = make_sharded_train_step(cfg, mesh)(copy(), shard_batch(mesh, batch), key)
        l1, lN = float(a1["total_loss"]), float(aN["total_loss"])

        # the gradient the step feeds Adam: all-reduced over the mesh vs one device
        params = (state.params_coarse, state.params_fine)
        grad = jax.grad(lambda p, b, k: make_loss_fn(cfg)(p, b, k)[0])
        g1 = jax.jit(grad)(params, batch, key)
        gN = jax.jit(grad)(jax.device_put(params, NamedSharding(mesh, P())),
                           shard_batch(mesh, batch), key)
        g_rel = rel_l2(gN, g1)

        # Adam's first step is lr*g/(|g|+eps) ~ lr*sign(g): an entry whose gradient
        # sits at the summation-noise level can flip sign between the 4-way
        # all-reduce and one device and move by up to 2*lr. So params outside
        # atol/rtol are allowed only where the gradient is near zero.
        ratio, n_bad, g_at_bad = 0.0, 0, 0.0
        for a, b, g in zip(jax.tree_util.tree_leaves((sN.params_coarse, sN.params_fine)),
                           jax.tree_util.tree_leaves((s1.params_coarse, s1.params_fine)),
                           jax.tree_util.tree_leaves(g1)):
            a, b, g = np.asarray(a), np.asarray(b), np.abs(np.asarray(g))
            r = np.abs(a - b) / (TOL["mesh_params_atol"] + TOL["mesh_params_rtol"] * np.abs(b))
            ratio = max(ratio, float(r.max()))
            bad = r > 1.0
            n_bad += int(bad.sum())
            if bad.any():
                g_at_bad = max(g_at_bad, float(g[bad].max() / max(g.max(), 1e-30)))
        out["train"] = {"loss_single": l1, "loss_sharded": lN,
                        "loss_rel": abs(lN - l1) / abs(l1), "grad_rel_l2": g_rel,
                        "params_ratio": ratio, "params_out_of_tol": n_bad,
                        "grad_at_out_of_tol": g_at_bad}
        out["train"]["pass"] = (out["train"]["loss_rel"] <= TOL["mesh_loss_rel"]
                                and g_rel <= TOL["mesh_grad"]
                                and g_at_bad <= TOL["mesh_grad_near_zero"])

        hw = render_hw
        K = jnp.asarray([[hw, 0, hw / 2], [0, -hw, hw / 2], [0, 0, -1.0]], jnp.float32)
        c2w = jnp.asarray([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 9.0], [0, 0, 0, 1]],
                          jnp.float32)
        ro, rd = rays_from_K(hw, hw, K, c2w)
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        r1 = make_image_renderer(cfg)(s1.params_coarse, s1.params_fine, ro, rd)
        rN = make_sharded_image_renderer(cfg, mesh)(s1.params_coarse, s1.params_fine, ro, rd)
        out["render"] = {"rays": int(ro.shape[0])}
        ok = True
        for k in ("rgb", "ins", "depth"):
            a, b = np.asarray(rN[k]), np.asarray(r1[k])
            out["render"][k] = max_rel(a, b)
            ok &= bool(np.allclose(a, b, atol=TOL["mesh_render_atol"],
                                   rtol=TOL["mesh_render_rtol"]))
        out["render"]["pass"] = ok

        grid = jnp.asarray(build_grid(np.eye(4), np.array([1.9, 7.0, 7.0]), grid_dim))
        g1 = np.asarray(make_sigma_query(cfg)(s1.params_fine, grid))
        gN = np.asarray(make_sharded_sigma_query(cfg, mesh)(s1.params_fine, grid))
        out["sigma"] = {"points": int(grid.shape[0]), "max_rel": max_rel(gN, g1),
                        "pass": bool(np.allclose(gN, g1, atol=TOL["mesh_render_atol"],
                                                 rtol=TOL["mesh_render_rtol"]))}
    return out


def child_four_cards(work: str) -> dict:
    import jax

    from dmnerf_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    device = _gpu_device_record()
    check(device["count"] >= 4, f"--four-cards needs 4 GPUs, JAX sees {device['count']}")
    cfg = _flagship_cfg(ins_num=SCENE["ins_num"])
    t0 = time.time()
    res = compare_mesh_paths(cfg, jax.devices()[:4])
    t = res["train"]
    print(f"[smoke] 4-GPU sharded train step vs 1 GPU ({cfg.N_train} rays, 8x256, "
          f"highest): loss {t['loss_sharded']:.7f} vs {t['loss_single']:.7f}, rel "
          f"{t['loss_rel']:.3e} (tol {TOL['mesh_loss_rel']}); all-reduced grad rel L2 "
          f"{t['grad_rel_l2']:.3e} (tol {TOL['mesh_grad']}); params worst "
          f"|d|/(atol+rtol|p|) {t['params_ratio']:.3e} (atol {TOL['mesh_params_atol']}, "
          f"rtol {TOL['mesh_params_rtol']}), {t['params_out_of_tol']} entries outside, "
          f"their largest |g| {t['grad_at_out_of_tol']:.3e} of the leaf max (tol "
          f"{TOL['mesh_grad_near_zero']}) -> {'PASS' if t['pass'] else 'FAIL'}", flush=True)
    r = res["render"]
    print(f"[smoke] 4-GPU sharded render vs 1 GPU ({r['rays']} rays): max|d|/scale rgb "
          f"{r['rgb']:.3e} ins {r['ins']:.3e} depth {r['depth']:.3e} -> "
          f"{'PASS' if r['pass'] else 'FAIL'}", flush=True)
    s = res["sigma"]
    print(f"[smoke] 4-GPU sharded sigma sweep vs 1 GPU ({s['points']} points): max|d|/scale "
          f"{s['max_rel']:.3e} -> {'PASS' if s['pass'] else 'FAIL'} "
          f"[{time.time() - t0:.0f}s]", flush=True)
    check(t["pass"] and r["pass"] and s["pass"], "4-GPU mesh path differs from one GPU")
    return {**device, "count": len(jax.devices()), "mesh": res}


if __name__ == "__main__":
    sys.exit(main())
