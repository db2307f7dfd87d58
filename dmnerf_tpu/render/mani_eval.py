"""Manipulation drivers: GT-compared evaluation and multi-object demo rendering.

Behavioral parity:
 * manipulator_eval (/root/reference/networks/manipulator.py:208-363): one rigid edit
   (trans @ ori_pose target bundle), full-image chunked manipulation render per view,
   PSNR/SSIM/LPIPS + instance mAP vs the manipulated GT, per-view pred->GT matching
   log, RGB/instance/GT image dumps, test_results.txt + matching_log.json.
   Released-code fix (SURVEY.md §4): the reference feeds manipulator an un-nested
   bundle and an int target_label (a latent crash); here the single edit is a K=1
   bundle list.
 * manipulator_demo (manipulator.py:366-492): per-object transform series from
   tools.pose_gen (rigid) or deformable ray-origin warps (sin / e^x / linear /
   abs_linear / ln row profiles scaled by the 8-phase deform_v animation ramp,
   manipulator.py:380-381), K simultaneous objects, frame dumps.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

from dmnerf_tpu.configs import Config
from dmnerf_tpu.core.rays import rays_from_K
from dmnerf_tpu.objfield.metrics import compact_gt_one_hot_np, ins_eval
from dmnerf_tpu.render.manipulator import deform_ray_offsets, make_manipulator_renderer
from dmnerf_tpu.tools.visualizer import render_gt_label2img, render_label2img
from dmnerf_tpu.utils.image_io import imwrite
from dmnerf_tpu.utils.image_metrics import lpips_np, psnr_np, ssim_np, to8b
from dmnerf_tpu.utils.metrics_log import write_matching_log, write_test_results


def _make_mani_renderer(cfg, n_targets: int):
    """Single-chip manipulator renderer, or the ray-sharded one over the full
    device mesh when more than one chip is visible (parallel.mesh)."""
    import jax

    if len(jax.devices()) > 1:
        from dmnerf_tpu.parallel.mesh import make_mesh, make_sharded_manipulator_renderer

        return make_sharded_manipulator_renderer(cfg, make_mesh(), n_targets)
    return make_manipulator_renderer(cfg, n_targets)


def _flat_rays(H, W, K, c2w):
    import jax.numpy as jnp

    o, d = rays_from_K(H, W, jnp.asarray(K), jnp.asarray(c2w, jnp.float32))
    return o.reshape(-1, 3), d.reshape(-1, 3)


def manipulator_eval(
    cfg: Config,
    params_coarse,
    params_fine,
    ori_poses: np.ndarray,
    hwk,
    trans_dicts: List[Dict],
    save_dir: str,
    ins_rgbs: np.ndarray,
    gt_rgbs: Optional[np.ndarray] = None,
    gt_labels: Optional[np.ndarray] = None,
    color_dict: Optional[Dict] = None,
    target_label: Optional[int] = None,
) -> Dict:
    import jax.numpy as jnp

    H, W, K = hwk
    if color_dict is None:
        color_dict = {str(i): i for i in range(cfg.ins_num)}
    target_label = target_label if target_label is not None else cfg.target_label
    assert target_label is not None, "mani_eval needs a target_label"

    trans_dict = trans_dicts[0]
    trans = np.asarray(trans_dict["transformation"], np.float32)
    save_dir = os.path.join(save_dir, trans_dict["mode"])
    os.makedirs(save_dir, exist_ok=True)

    run = _make_mani_renderer(cfg, n_targets=1)
    psnrs, ssims, lpipses, aps, full_map = [], [], [], [], {}
    # stochastic importance sampling like the reference (sample_pdf det=False,
    # manipulator.py:148,170,187); fixed base seed for reproducible eval runs.
    # NOTE: reproducible only per DEVICE COUNT — with >1 device the sharded
    # renderer folds the device index into the key and splits per local chunk,
    # so stochastic metrics differ (validly) between mesh sizes (ADVICE r3).
    import jax
    base_key = jax.random.PRNGKey(0)

    for i, ori_pose in enumerate(np.asarray(ori_poses)):
        t0 = time.time()
        ori_o, ori_d = _flat_rays(H, W, K, ori_pose)
        tar_pose = trans @ ori_pose
        tar_o, tar_d = _flat_rays(H, W, K, tar_pose)

        out = run(params_coarse, params_fine, ori_o, ori_d,
                  tar_o[None], tar_d[None], (int(target_label),),
                  key=jax.random.fold_in(base_key, i))
        rgb = np.asarray(out["rgb"]).reshape(H, W, 3)
        ins = np.asarray(out["ins"]).reshape(H, W, -1)   # air channel kept
        tar_rgb = np.asarray(out["tar_rgb"]).reshape(H, W, 3)

        ins_map = {}
        if gt_rgbs is not None:
            gt_img = np.asarray(gt_rgbs[i])
            gt_label = np.asarray(gt_labels[i])
            psnrs.append(psnr_np(rgb, gt_img))
            ssims.append(ssim_np(rgb, gt_img))
            lpipses.append(lpips_np(rgb, gt_img))

            gt_onehot, valid_gt_num, valid_gt_labels = compact_gt_one_hot_np(gt_label, cfg.ins_num)
            if valid_gt_num > 0:
                # air channel dropped for eval (reference manipulator.py:300)
                pred_label, ap, matched = ins_eval(
                    ins[..., :-1], gt_onehot, valid_gt_num, cfg.ins_num
                )
                ins_map = {str(int(m)): int(g) for m, g in zip(matched, valid_gt_labels) if m != -1}
            else:
                pred_label, ap = -np.ones(gt_label.shape, dtype=np.int64), [1.0] * 6
            full_map[i] = ins_map
            aps.append(ap)
            print(f"[mani_eval] view {i}: PSNR {psnrs[-1]:.3f} AP {ap}")
        else:
            pred_label = np.argmax(ins, axis=-1)

        label = np.argmax(ins, axis=-1)
        imwrite(os.path.join(save_dir, f"{i}_rgb.png"), to8b(rgb))
        imwrite(os.path.join(save_dir, f"{i}_ins.png"),
                 render_label2img(label, ins_rgbs, color_dict, ins_map))
        if gt_rgbs is not None:
            imwrite(os.path.join(save_dir, f"{i}_rgb_gt.png"), to8b(np.asarray(gt_rgbs[i])))
            imwrite(os.path.join(save_dir, f"{i}_ins_gt.png"),
                     render_gt_label2img(np.asarray(gt_labels[i]), ins_rgbs, color_dict))
        print(f"[mani_eval] IMAGE[{i}] TIME: {time.time()-t0:.3f}s")

    if gt_rgbs is not None and aps:
        write_matching_log(save_dir, full_map)
        write_test_results(save_dir, psnrs, ssims, lpipses, np.asarray(aps))
    return {"psnrs": psnrs, "ssims": ssims, "lpipses": lpipses,
            "aps": np.asarray(aps) if aps else None, "full_map": full_map}


def manipulator_demo(
    cfg: Config,
    params_coarse,
    params_fine,
    hwk,
    objs_trans: Dict,
    save_dir: str,
    ins_rgbs: np.ndarray,
    objs: List[Dict],
    view_poses: np.ndarray,
    ins_map: Dict,
    color_dict: Optional[Dict] = None,
) -> None:
    import jax.numpy as jnp

    H, W, K = hwk
    if color_dict is None:
        color_dict = {str(i): i for i in range(cfg.ins_num)}
    save_dir = os.path.join(save_dir, "mani_output")
    os.makedirs(save_dir, exist_ok=True)

    # 8-phase deformation ramp (reference manipulator.py:380-381)
    deform_v = np.concatenate(
        [np.linspace(0, 0.18, 2), np.linspace(0.18, 0, 2),
         np.linspace(0, -0.18, 2), np.linspace(-0.18, 0, 2)]
    )

    n_obj = len(objs)
    run = _make_mani_renderer(cfg, n_targets=n_obj)
    import jax
    base_key = jax.random.PRNGKey(0)

    for i, ori_pose in enumerate(np.asarray(view_poses)):
        t0 = time.time()
        ori_o, ori_d = _flat_rays(H, W, K, ori_pose)

        tar_os, tar_ds, labels = [], [], []
        for obj in objs:
            labels.append(int(obj["tar_id"]))
            if obj["mani_mode"] == "deform":
                off = deform_ray_offsets(H, W, obj["deform_func"],
                                         deform_v[i % len(deform_v)])
                to = np.asarray(ori_o).copy()
                to[:, 0] += off
                tar_os.append(jnp.asarray(to))
                tar_ds.append(ori_d)
            else:
                trans = np.asarray(objs_trans[obj["obj_name"]][i]["transformation"], np.float32)
                to, td = _flat_rays(H, W, K, trans @ ori_pose)
                tar_os.append(to)
                tar_ds.append(td)

        out = run(params_coarse, params_fine, ori_o, ori_d,
                  jnp.stack(tar_os), jnp.stack(tar_ds), tuple(labels),
                  key=jax.random.fold_in(base_key, i))
        rgb = np.asarray(out["rgb"]).reshape(H, W, 3)
        ins = np.asarray(out["ins"]).reshape(H, W, -1)
        label = np.argmax(ins, axis=-1)

        imwrite(os.path.join(save_dir, f"{i}_rgb.png"), to8b(rgb))
        imwrite(os.path.join(save_dir, f"{i}_ins.png"),
                 render_label2img(label, ins_rgbs, color_dict, ins_map))
        imwrite(os.path.join(save_dir, f"{i}_ins_pred_mask.png"), label.astype(np.uint8))
        print(f"[mani_demo] Image{i}: {time.time()-t0:.3f}s")
