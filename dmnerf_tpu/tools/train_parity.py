"""Measured training-trajectory parity vs the PyTorch reference (BASELINE.md item 1).

Runs the ACTUAL reference implementation (imported in place from /root/reference,
never copied) and this framework through an identical short training schedule —
identical initial parameters (copied pytree -> torch modules), identical ray batches
(precomputed once with numpy and fed to both), perturb=0 so neither framework draws
framework-local randoms (sample_pdf runs det, reference helpers.py:123), identical
Adam(5e-4, (0.9, 0.999)) with the reference's exponential LR decay
(train_dmsr.py:68-73) — and records train-batch PSNR / instance loss / emptiness
loss at fixed iterations plus a full held-out-view PSNR + instance mAP at the end,
each side evaluated by its own stack (reference networks/evaluator.py ins_eval vs
dmnerf_tpu.objfield.metrics.ins_eval).

CLI:  python -m dmnerf_tpu.tools.train_parity [--iters 2000] [--out PARITY.md]
      [--geometry {tiny,flagship}]
Writes a markdown table + parity.json. The pytest harness
(tests/test_training_parity.py) runs a shortened schedule with tolerances.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np

REF = "/root/reference"

# tiny-but-real geometry: deep enough to learn the synthetic scene, small enough
# that the torch-CPU side stays tractable
D, W, MULTIRES, MULTIRES_VIEWS, SKIPS = 4, 64, 6, 3, (2,)
N_SAMPLES, N_IMPORTANCE, N_TRAIN = 16, 16, 128
SCENE_HW = 32
NEAR, FAR = 2.0, 7.0
LRATE, LRATE_DECAY = 5e-4, 500
TOLERANCE, DETA_W = 0.05, 0.05

GEOMETRIES = {
    "tiny": dict(D=4, W=64, MULTIRES=6, MULTIRES_VIEWS=3, SKIPS=(2,),
                 N_SAMPLES=16, N_IMPORTANCE=16, N_TRAIN=128, SCENE_HW=32),
    # the reference training schedule (BASELINE.md): 8x256 net, 64+128 samples.
    # 3072 rays need a 64x64 scene (pixel picks are without replacement).
    "flagship": dict(D=8, W=256, MULTIRES=10, MULTIRES_VIEWS=4, SKIPS=(4,),
                     N_SAMPLES=64, N_IMPORTANCE=128, N_TRAIN=3072, SCENE_HW=64),
}


def set_geometry(name: str) -> None:
    """Select the run geometry by rebinding the module constants every helper
    reads (explicit and contained; the alternative is threading 9 values through
    5 call layers for a 2-choice CLI knob)."""
    globals().update(GEOMETRIES[name])


def make_config(ins_num: int):
    from dmnerf_tpu.configs import Config

    return Config(
        netdepth=D, netwidth=W, multires=MULTIRES, multires_views=MULTIRES_VIEWS,
        skips=SKIPS, N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
        N_train=N_TRAIN, N_test=512, near=NEAR, far=FAR, ins_num=ins_num,
        lrate=LRATE, lrate_decay=LRATE_DECAY, perturb=0.0,
        penalize=True, tolerance=TOLERANCE, deta_w=DETA_W,
    )


def params_to_torch_model(params, ins_num: int):
    """Copy a dmnerf_tpu param pytree into a reference DM_NeRF module
    (torch Linear stores [out, in]; ours stores [in, out])."""
    import torch

    if REF not in sys.path:
        sys.path.insert(0, REF)
    from networks.dm_nerf import DM_NeRF

    from dmnerf_tpu.core.embedding import embed_dim

    m = DM_NeRF(D=D, W=W, input_ch_pts=embed_dim(MULTIRES),
                input_ch_views=embed_dim(MULTIRES_VIEWS), skips=list(SKIPS),
                ins_num=ins_num)
    t = lambda a: torch.from_numpy(np.asarray(a).T.copy())
    v = lambda a: torch.from_numpy(np.asarray(a).copy())
    with torch.no_grad():
        for i in range(D):
            m.mlps[i].weight.copy_(t(params[f"trunk_{i}_w"]))
            m.mlps[i].bias.copy_(v(params[f"trunk_{i}_b"]))
        m.rgb_feature_linear.weight.copy_(t(params["rgb_feat_w"]))
        m.rgb_feature_linear.bias.copy_(v(params["rgb_feat_b"]))
        m.rgb_feature_linears[0].weight.copy_(t(params["rgb_hid_w"]))
        m.rgb_feature_linears[0].bias.copy_(v(params["rgb_hid_b"]))
        m.rgb_linear.weight.copy_(t(params["rgb_out_w"]))
        m.rgb_linear.bias.copy_(v(params["rgb_out_b"]))
        m.ins_feature_linear.weight.copy_(t(params["ins_feat_w"]))
        m.ins_feature_linear.bias.copy_(v(params["ins_feat_b"]))
        m.ins_feature_linears[0].weight.copy_(t(params["ins_hid_w"]))
        m.ins_feature_linears[0].bias.copy_(v(params["ins_hid_b"]))
        m.ins_linear.weight.copy_(t(params["ins_out_w"]))
        m.ins_linear.bias.copy_(v(params["ins_out_b"]))
        m.density_linear.weight.copy_(t(params["density_w"]))
        m.density_linear.bias.copy_(v(params["density_b"]))
    return m


def build_scene(tmp_dir: str):
    """Synthetic DM-SR scene loaded through the real loader."""
    from dmnerf_tpu.data.dmsr import load_dmsr
    from dmnerf_tpu.data.synthetic import write_dmsr_scene

    scene_dir = os.path.join(tmp_dir, f"study_{SCENE_HW}")
    if not os.path.isdir(scene_dir):
        write_dmsr_scene(scene_dir, n_train=6, n_test=3, H=SCENE_HW, W=SCENE_HW,
                         n_objects=3, ins_num=8)
    cfg = make_config(8).replace(datadir=scene_dir, testskip=1, views=4)
    return load_dmsr(cfg), cfg


def precompute_batches(scene, n_iters: int, seed: int = 0):
    """The shared random stream: per-step image pick + pixel ids, and the rays /
    targets they induce, computed ONCE in numpy and fed verbatim to both sides."""
    from dmnerf_tpu.core.rays import rays_for_pixels
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    Hh, Ww = scene.images.shape[1:3]
    batches = []
    K = jnp.asarray(scene.K)
    for _ in range(n_iters):
        img_i = scene.i_train[rng.randint(0, len(scene.i_train))]
        flat = rng.choice(Hh * Ww, size=N_TRAIN, replace=False)
        py, px = flat // Ww, flat % Ww
        ro, rd = rays_for_pixels(jnp.asarray(py), jnp.asarray(px), K,
                                 jnp.asarray(scene.poses[img_i]))
        batches.append(dict(
            rays_o=np.asarray(ro), rays_d=np.asarray(rd),
            target_c=scene.images[img_i][py, px].astype(np.float32),
            target_i=scene.gt_labels[img_i][py, px].astype(np.int64),
        ))
    return batches


def run_reference(init_params_c, init_params_f, scene, batches, record_at) -> Dict:
    """Reference train loop body (train_dmsr.py:17-110) driven with injected batches."""
    import torch
    import types

    if REF not in sys.path:
        sys.path.insert(0, REF)
    from networks.evaluator import img2mse, ins_criterion, mse2psnr, ins_eval
    from networks.penalizer import ins_penalizer
    from networks.render import dm_nerf as ref_dm_nerf
    from networks.dm_nerf import get_embedder
    from networks.helpers import z_val_sample as ref_z_val_sample

    torch.autograd.set_detect_anomaly(False)
    ins_num = scene.ins_num
    coarse = params_to_torch_model(init_params_c, ins_num)
    fine = params_to_torch_model(init_params_f, ins_num)
    opt = torch.optim.Adam(list(coarse.parameters()) + list(fine.parameters()),
                           lr=LRATE, betas=(0.9, 0.999))
    pos_emb, _ = get_embedder(MULTIRES, 0)
    view_emb, _ = get_embedder(MULTIRES_VIEWS, 0)
    args = types.SimpleNamespace(perturb=0.0, N_importance=N_IMPORTANCE,
                                 is_train=True, N_ins=None, penalize=True,
                                 tolerance=TOLERANCE, deta_w=DETA_W)
    z_coarse = ref_z_val_sample(N_TRAIN, NEAR, FAR, N_SAMPLES)

    trace = {}
    for it, b in enumerate(batches):
        rays = torch.stack([torch.from_numpy(b["rays_o"]), torch.from_numpy(b["rays_d"])], 0)
        target_c = torch.from_numpy(b["target_c"])
        target_i = torch.from_numpy(b["target_i"]).float()
        info = ref_dm_nerf(rays, pos_emb, view_emb, coarse, fine, z_coarse, args)
        rgb_loss = img2mse(info["rgb_coarse"], target_c) + img2mse(info["rgb_fine"], target_c)
        ins_loss = (ins_criterion(info["ins_coarse"], target_i, ins_num)[0]
                    + ins_criterion(info["ins_fine"], target_i, ins_num)[0])
        empt = (ins_penalizer(info["raw_coarse"], info["z_vals_coarse"],
                              info["depth_coarse"], rays[1], args)
                + ins_penalizer(info["raw_fine"], info["z_vals_fine"],
                                info["depth_fine"], rays[1], args))
        loss = rgb_loss + ins_loss + empt
        opt.zero_grad()
        loss.backward()
        opt.step()
        # reference LR decay (train_dmsr.py:68-73)
        new_lr = LRATE * (0.1 ** ((it + 1) / (LRATE_DECAY * 1000)))
        for g in opt.param_groups:
            g["lr"] = new_lr
        if (it + 1) in record_at:
            psnr = float(mse2psnr(img2mse(info["rgb_fine"], target_c)))
            trace[it + 1] = {"psnr_fine": psnr, "ins_loss": float(ins_loss),
                             "emptiness": float(empt), "total": float(loss)}

    # final held-out view: full-image render + PSNR + mAP, reference stack
    eval_view = _ref_eval_view(coarse, fine, pos_emb, view_emb, scene, args)
    return {"trace": trace, "eval": eval_view}


def _ref_eval_view(coarse, fine, pos_emb, view_emb, scene, args):
    import torch
    from networks.evaluator import ins_eval
    from networks.helpers import get_rays_k, z_val_sample as ref_z_val_sample
    from networks.render import dm_nerf as ref_dm_nerf

    i = scene.i_test[0]
    Hh, Ww = scene.images.shape[1:3]
    gt_img = scene.images[i]
    gt_label = torch.from_numpy(scene.gt_labels[i].astype(np.int64))
    pose = torch.from_numpy(scene.poses[i].astype(np.float32))
    rays_o, rays_d = get_rays_k(Hh, Ww, torch.from_numpy(scene.K.astype(np.float32)), pose)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    args.is_train = False
    chunk = 512
    rgbs, inss = [], []
    with torch.no_grad():
        for s in range(0, rays_o.shape[0], chunk):
            z = ref_z_val_sample(min(chunk, rays_o.shape[0] - s), NEAR, FAR, N_SAMPLES)
            info = ref_dm_nerf((rays_o[s:s + chunk], rays_d[s:s + chunk]),
                               pos_emb, view_emb, coarse, fine, z, args)
            rgbs.append(info["rgb_fine"])
            inss.append(info["ins_fine"])
    rgb = torch.cat(rgbs).reshape(Hh, Ww, 3)
    ins = torch.cat(inss).reshape(Hh, Ww, -1)
    mse = float(torch.mean((rgb - torch.from_numpy(gt_img)) ** 2))
    psnr = -10.0 * np.log10(mse)
    gt_onehot, valid_num = _torch_gt_onehot(gt_label, scene.ins_num)
    _, ap, _ = ins_eval(ins.cpu(), gt_onehot, valid_num, scene.ins_num)
    return {"psnr": psnr, "ap": [float(a) for a in np.asarray(ap).reshape(-1)]}


def _torch_gt_onehot(gt_label, ins_num):
    """The reference tester's GT one-hot prep (tester.py:101-107)."""
    import torch
    import torch.nn.functional as F

    unique_labels = torch.unique(gt_label)
    valid = len(unique_labels)
    onehot = F.one_hot(gt_label, num_classes=ins_num)
    compact = torch.zeros_like(onehot)
    for j, l in enumerate(unique_labels):
        compact[..., j] = onehot[..., l]
    return compact.float(), valid


def run_ours(init_params_c, init_params_f, scene, batches, record_at) -> Dict:
    import jax
    import jax.numpy as jnp

    from dmnerf_tpu.core.pipeline import make_xla_query_fn
    from dmnerf_tpu.objfield.metrics import compact_gt_one_hot_np, ins_eval
    from dmnerf_tpu.render.renderer import make_image_renderer
    from dmnerf_tpu.render.trainstep import (Batch, TrainState, make_optimizer,
                                             make_train_step)
    from dmnerf_tpu.utils.image_metrics import psnr_np

    cfg = make_config(scene.ins_num)
    query_fn = make_xla_query_fn(MULTIRES, MULTIRES_VIEWS, D, SKIPS)
    step = make_train_step(cfg, query_fn=query_fn)
    opt_state = make_optimizer(cfg).init((init_params_c, init_params_f))
    state = TrainState(jnp.zeros((), jnp.int32), init_params_c, init_params_f, opt_state)

    trace = {}
    key = jax.random.PRNGKey(0)  # unused under perturb=0, threaded for API parity
    for it, b in enumerate(batches):
        batch = Batch(jnp.asarray(b["rays_o"]), jnp.asarray(b["rays_d"]),
                      jnp.asarray(b["target_c"]), jnp.asarray(b["target_i"]))
        state, aux = step(state, batch, key)
        if (it + 1) in record_at:
            trace[it + 1] = {"psnr_fine": float(aux["psnr_fine"]),
                             "ins_loss": float(aux["ins_loss"]),
                             "emptiness": float(aux["emptiness_loss"]),
                             "total": float(aux["total_loss"])}

    # final held-out view, our stack
    i = scene.i_test[0]
    Hh, Ww = scene.images.shape[1:3]
    renderer = make_image_renderer(cfg, query_fn=query_fn)
    from dmnerf_tpu.core.rays import rays_from_K

    ro, rd = rays_from_K(Hh, Ww, jnp.asarray(scene.K), jnp.asarray(scene.poses[i]))
    out = renderer(state.params_coarse, state.params_fine,
                   ro.reshape(-1, 3), rd.reshape(-1, 3))
    rgb = np.asarray(out["rgb"]).reshape(Hh, Ww, 3)
    ins = np.asarray(out["ins"]).reshape(Hh, Ww, -1)
    psnr = psnr_np(rgb, scene.images[i])
    gt_onehot, valid_num, _ = compact_gt_one_hot_np(scene.gt_labels[i], scene.ins_num)
    _, ap, _ = ins_eval(ins, gt_onehot, valid_num, scene.ins_num)
    return {"trace": trace, "eval": {"psnr": float(psnr),
                                     "ap": [float(a) for a in np.asarray(ap).reshape(-1)]}}


def _shared_setup(n_iters: int, record_every: int, tmp_dir: str, seed: int):
    import jax

    scene, cfg = build_scene(tmp_dir)
    from dmnerf_tpu.core.embedding import embed_dim
    from dmnerf_tpu.core.mlp import init_dm_nerf

    kc, kf = jax.random.split(jax.random.PRNGKey(seed))
    kwargs = dict(ins_num=scene.ins_num, D=D, W=W,
                  input_ch_pts=embed_dim(MULTIRES),
                  input_ch_views=embed_dim(MULTIRES_VIEWS), skips=SKIPS)
    # snapshot to host numpy: the jitted train step donates its state buffers,
    # which would invalidate the shared init before the second side reads it
    params_c = {k: np.asarray(v) for k, v in init_dm_nerf(kc, **kwargs).items()}
    params_f = {k: np.asarray(v) for k, v in init_dm_nerf(kf, **kwargs).items()}
    record_at = set(range(record_every, n_iters + 1, record_every)) | {1, n_iters}
    batches = precompute_batches(scene, n_iters, seed)
    return scene, params_c, params_f, record_at, batches


def _diff_rows(ours: Dict, ref: Dict) -> List[Dict]:
    rows = []
    for it in sorted(ours["trace"]):
        o, r = ours["trace"][it], ref["trace"][it]
        rows.append({"iter": it,
                     "psnr_ours": o["psnr_fine"], "psnr_ref": r["psnr_fine"],
                     "ins_ours": o["ins_loss"], "ins_ref": r["ins_loss"],
                     "total_ours": o["total"], "total_ref": r["total"]})
    return rows


def run_parity(n_iters: int, record_every: int, tmp_dir: str, seed: int = 0) -> Dict:
    """Ours vs the PyTorch reference."""
    scene, params_c, params_f, record_at, batches = _shared_setup(
        n_iters, record_every, tmp_dir, seed)

    t0 = time.time()
    ours = run_ours(params_c, params_f, scene, batches, record_at)
    t_ours = time.time() - t0
    t0 = time.time()
    ref = run_reference(params_c, params_f, scene, batches, record_at)
    t_ref = time.time() - t0

    return {"rows": _diff_rows(ours, ref),
            "eval_ours": ours["eval"], "eval_ref": ref["eval"],
            "wall_ours_s": t_ours, "wall_ref_s": t_ref,
            "labels": {"ours": "ours", "ref": "reference (torch)"},
            "schedule": {"iters": n_iters, "N_train": N_TRAIN, "net": f"{D}x{W}",
                         "samples": [N_SAMPLES, N_IMPORTANCE], "seed": seed}}


def write_report(res: Dict, out_md: str) -> None:
    lo = res.get("labels", {}).get("ours", "ours")
    lr = res.get("labels", {}).get("ref", "reference")
    lines = [
        f"# Training-trajectory parity: {lo} vs {lr}",
        "",
        "Identical init params, identical injected ray batches, perturb=0, identical",
        "Adam + exp LR decay; each side records its own train metrics and evaluates a",
        "held-out view with its own full eval stack. Produced by",
        "`python -m dmnerf_tpu.tools.train_parity` (see tests/test_training_parity.py",
        "for the gated tolerances).",
        "",
        f"Schedule: {res['schedule']}",
        "",
        f"| iter | PSNR {lo} | PSNR {lr} | Δ | ins_loss {lo} | ins_loss {lr} | total {lo} | total {lr} |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in res["rows"]:
        lines.append(
            f"| {r['iter']} | {r['psnr_ours']:.3f} | {r['psnr_ref']:.3f} "
            f"| {r['psnr_ours'] - r['psnr_ref']:+.3f} | {r['ins_ours']:.4f} "
            f"| {r['ins_ref']:.4f} | {r['total_ours']:.4f} | {r['total_ref']:.4f} |")
    eo, er = res["eval_ours"], res["eval_ref"]
    lines += [
        "",
        "## Held-out view (end of schedule)",
        "",
        f"| | PSNR | AP@[.5,.75,.8,.85,.9,.95] |",
        f"|---|---|---|",
        f"| {lo} | {eo['psnr']:.3f} | {['%.3f' % a for a in eo['ap']]} |",
        f"| {lr} | {er['psnr']:.3f} | {['%.3f' % a for a in er['ap']]} |",
        "",
        f"Wall clock: {lo} {res['wall_ours_s']:.1f}s, {lr} {res['wall_ref_s']:.1f}s.",
    ]
    with open(out_md, "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--record-every", type=int, default=250)
    ap.add_argument("--out", default="PARITY.md")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--tmp", default="/tmp/dmnerf_parity_scene")
    ap.add_argument("--geometry", choices=sorted(GEOMETRIES), default="tiny")
    args = ap.parse_args(argv)

    set_geometry(args.geometry)
    os.makedirs(args.tmp, exist_ok=True)
    res = run_parity(args.iters, args.record_every, args.tmp)
    write_report(res, args.out)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(res, f, indent=1)
    for r in res["rows"]:
        print(f"iter {r['iter']:5d}: PSNR ours {r['psnr_ours']:.3f} ref {r['psnr_ref']:.3f} "
              f"(Δ {r['psnr_ours'] - r['psnr_ref']:+.3f})")
    print(f"eval: ours PSNR {res['eval_ours']['psnr']:.3f} AP@.5 {res['eval_ours']['ap'][0]:.3f} | "
          f"ref PSNR {res['eval_ref']['psnr']:.3f} AP@.5 {res['eval_ref']['ap'][0]:.3f}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
