"""Synthetic DM-SR-format scene generator.

No datasets ship with either repo (the reference's data/ holds download READMEs only),
so the framework includes an analytic scene renderer that writes a fully valid DM-SR
directory — {train,test}/rgbs + transforms.json + semantic_instance + ins_rgb.hdf5 +
objs_info.json (format per /root/reference/datasets/loader_dmsr.py:38-175) — used by
the loader tests, the end-to-end convergence tests, and the benchmark harness.

The scene is a set of colored spheres (one instance label each) over a background;
images are ray-traced with EXACTLY the ray convention the DM-SR loader produces
(K with negative fy, fz = -1; loader_dmsr.py:172), so a NeRF trained on these images
against rays_from_K is geometrically consistent.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


def _look_at(eye: np.ndarray, target: np.ndarray, up=np.array([0.0, 0.0, 1.0])) -> np.ndarray:
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    # camera looks along -z in the blender/DM-SR convention
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, true_up, -fwd
    c2w[:3, 3] = eye
    return c2w


def default_spec(n_objects: int = 4, seed: int = 0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-1.2, 1.2, size=(n_objects, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(-0.5, 0.5, size=n_objects)
    radii = rng.uniform(0.35, 0.6, size=n_objects).astype(np.float32)
    colors = rng.uniform(0.2, 0.95, size=(n_objects, 3)).astype(np.float32)
    return {"centers": centers, "radii": radii, "colors": colors}


def render_view(c2w: np.ndarray, H: int, W: int, K: np.ndarray, spec) -> tuple:
    """Returns (rgb [H,W,3] float in [0,1], label [H,W] int). Label 0 = background,
    sphere k has label k+1."""
    j, i = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij")
    dirs = np.stack(
        [(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1], K[2, 2] * np.ones_like(i)], -1
    )
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)

    d_norm = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    best_t = np.full((H, W), np.inf, np.float32)
    label = np.zeros((H, W), np.int32)
    rgb = np.empty((H, W, 3), np.float32)
    # soft sky background
    rgb[:] = 0.25 + 0.35 * (d_norm[..., 2:3] * 0.5 + 0.5)

    light = np.array([0.4, -0.3, 0.85])
    light = light / np.linalg.norm(light)
    for k in range(len(spec["radii"])):
        c, r, col = spec["centers"][k], spec["radii"][k], spec["colors"][k]
        oc = rays_o - c
        b = np.sum(oc * d_norm, -1)
        disc = b * b - (np.sum(oc * oc, -1) - r * r)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0))
        hit &= (t > 1e-3) & (t < best_t)
        if not hit.any():
            continue
        p = rays_o[hit] + d_norm[hit] * t[hit, None]
        n = (p - c) / r
        shade = 0.35 + 0.65 * np.maximum(n @ light, 0)
        rgb[hit] = np.clip(col * shade[:, None], 0, 1)
        label[hit] = k + 1
        best_t[hit] = t[hit]
    return rgb, label


def write_dmsr_scene(
    out_dir: str,
    n_train: int = 12,
    n_test: int = 4,
    H: int = 64,
    W: int = 64,
    n_objects: int = 4,
    ins_num: int = 8,
    seed: int = 0,
    radius: float = 4.0,
    mani_modes: Optional[list] = None,
):
    """Writes a DM-SR-format scene; returns the spec. ins_num >= n_objects + 1."""
    from dmnerf_tpu.data.hdf5 import write_dataset
    from dmnerf_tpu.utils.image_io import imwrite

    spec = default_spec(n_objects, seed)
    focal = float(W)  # ~53deg fov
    angle_x = 2.0 * np.arctan(W / (2.0 * focal))
    K = np.array([[focal, 0, W * 0.5], [0, -focal, H * 0.5], [0, 0, -1]], np.float32)

    def poses_for(count, phase):
        poses = []
        for t in range(count):
            ang = phase + 2 * np.pi * t / max(count, 1)
            eye = np.array([radius * np.cos(ang), radius * np.sin(ang), 1.6 + 0.4 * np.sin(2 * ang)])
            poses.append(_look_at(eye.astype(np.float32), np.zeros(3, np.float32)))
        return poses

    for split, count, phase in [("train", n_train, 0.0), ("test", n_test, 0.13)]:
        rgb_dir = os.path.join(out_dir, split, "rgbs")
        ins_dir = os.path.join(out_dir, split, "semantic_instance")
        os.makedirs(rgb_dir, exist_ok=True)
        os.makedirs(ins_dir, exist_ok=True)
        frames = []
        for t, c2w in enumerate(poses_for(count, phase)):
            rgb, label = render_view(c2w, H, W, K, spec)
            imwrite(os.path.join(rgb_dir, f"{t:04d}.png"), (rgb * 255).astype(np.uint8))
            imwrite(os.path.join(ins_dir, f"{t:04d}.png"), label.astype(np.uint8))
            frames.append({"transform_matrix": c2w.tolist()})
        with open(os.path.join(out_dir, split, "transforms.json"), "w") as f:
            json.dump({"camera_angle_x": float(angle_x), "frames": frames}, f)

    rng = np.random.RandomState(seed + 1)
    palette = rng.randint(0, 255, size=(ins_num, 3)).astype(np.uint8)
    write_dataset(os.path.join(out_dir, "ins_rgb.hdf5"), palette)

    objs = [
        {
            "obj_name": f"sphere_{k}",
            "tar_id": k + 1,
            "mani_mode": "translation",
            "obj_center": spec["centers"][k].tolist(),
            "distance": [0.5],
        }
        for k in range(n_objects)
    ]
    with open(os.path.join(out_dir, "objs_info.json"), "w") as f:
        json.dump(
            {"objects": objs, "view_id": 0, "ins_map": {str(k + 1): k + 1 for k in range(n_objects)}},
            f,
        )

    # color_dict.json lives one level up in the reference layout (data/color_dict.json,
    # consumed by tester.py:48-50); write a per-scene copy too for self-containment.
    color_dict = {str(lbl): int(lbl) for lbl in range(ins_num)}
    with open(os.path.join(out_dir, "color_dict.json"), "w") as f:
        json.dump(color_dict, f)

    if mani_modes:
        _write_mani_gt(out_dir, spec, H, W, K, n_test, mani_modes)
    return spec


def write_replica_scene(
    out_dir: str,
    H: int = 16,
    W: int = 16,
    n_objects: int = 3,
    ins_num: int = 8,
    seed: int = 0,
    testskip: int = 10,
    with_objs_info: bool = True,
):
    """Replica-format fixture tree (reference loader_replica.py:154-192 layout):
    traj_w_c.txt (flat 4x4 rows), rgb/rgb_{i}.png, semantic_instance/
    semantic_instance_{i}.png, ins_rgb.hdf5, objs_info.json.

    The reference split is HARDCODED to ids range(0, 900, 5) for train and
    train+2 for test, so the trajectory file carries 900 rows; image files are
    written only for the ids the loader actually reads (train ids + the
    testskip-subsampled test ids) to keep the fixture fast.

    Camera convention: real Replica traj_w_c poses are OpenCV camera-to-world
    (y down, z FORWARD) and the reference builds a POSITIVE K with fz=+1
    (loader_replica.py:188-189 + helpers.py get_rays_k). The renderer here
    works in the blender convention (_look_at), so the saved trajectory rows
    are c2w_blender @ diag(1,-1,-1,1) — same convention bridge as
    write_scannet_scene (see its docstring for the failure mode this
    prevents).
    """
    from dmnerf_tpu.data.hdf5 import write_dataset
    from dmnerf_tpu.utils.image_io import imwrite

    spec = default_spec(n_objects, seed)
    focal = W / 2.0
    # render with the blender-convention K (camera looks along -z, matching
    # _look_at); centers at (W-1)/2 to match the loader's derived K exactly
    # (reference loader_replica.py:188: K centers at (W-1)*.5/(H-1)*.5)
    K_render = np.array([[focal, 0, (W - 1) * 0.5], [0, -focal, (H - 1) * 0.5],
                         [0, 0, -1]], np.float32)

    total, step = 900, 5
    train_ids = list(range(0, total, step))
    test_ids = [i + step // 2 for i in train_ids]
    read_test_ids = test_ids[::max(testskip, 1)]

    poses = np.zeros((total, 4, 4), np.float32)
    radius = 4.0
    for i in range(total):
        ang = 2 * np.pi * i / total
        eye = np.array([radius * np.cos(ang), radius * np.sin(ang), 1.6], np.float32)
        poses[i] = _look_at(eye, np.zeros(3, np.float32))
    os.makedirs(out_dir, exist_ok=True)
    # trajectory rows in the OpenCV convention (see docstring): blender -> cv
    poses_cv = poses @ np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    np.savetxt(os.path.join(out_dir, "traj_w_c.txt"), poses_cv.reshape(total, 16),
               delimiter=" ")

    rgb_dir = os.path.join(out_dir, "rgb")
    ins_dir = os.path.join(out_dir, "semantic_instance")
    os.makedirs(rgb_dir, exist_ok=True)
    os.makedirs(ins_dir, exist_ok=True)
    for i in sorted(set(train_ids) | set(read_test_ids)):
        rgb, label = render_view(poses[i], H, W, K_render, spec)
        imwrite(os.path.join(rgb_dir, f"rgb_{i}.png"), (rgb * 255).astype(np.uint8))
        imwrite(os.path.join(ins_dir, f"semantic_instance_{i}.png"),
                        label.astype(np.uint8))

    rng = np.random.RandomState(seed + 1)
    palette = rng.randint(0, 255, size=(ins_num, 3)).astype(np.uint8)
    write_dataset(os.path.join(out_dir, "ins_rgb.hdf5"), palette)

    if with_objs_info:
        objs = [{"obj_name": f"sphere_{k}", "tar_id": k + 1, "mani_mode": "translation",
                 "obj_center": spec["centers"][k].tolist(), "distance": [0.5]}
                for k in range(n_objects)]
        with open(os.path.join(out_dir, "objs_info.json"), "w") as f:
            json.dump({"objects": objs, "view_id": 0,
                       "ins_map": {str(k + 1): k + 1 for k in range(n_objects)}}, f)
    return spec


def write_scannet_scene(
    out_dir: str,
    n_train: int = 5,
    n_test: int = 3,
    H: int = 24,
    W: int = 32,
    n_objects: int = 3,
    seed: int = 0,
    unlabeled_frac: float = 0.5,
):
    """ScanNet-format fixture tree (reference loader_scannet.py:184-201 layout):
    {split}_split_idx.txt, {split}/{split}_images/{i}.jpg,
    {split}/{split}_pose/{i}.txt, {split}/{split}_ins/{i}.npz (ins_2d_label_id,
    with -1 = unlabeled), intrinsic/intrinsic_{color,depth}.txt, ins_rgb.hdf5.

    Labels use the raw ScanNet convention: -1 for unlabeled pixels, 0..L-1 for
    instances; the loader remaps -1 -> ins_num (air). A fraction of labeled
    pixels is dropped to -1 to exercise the weakly-supervised path.

    Camera convention: real ScanNet poses are OpenCV camera-to-world (y down,
    z FORWARD) with positive intrinsics — the reference feeds them to
    get_rays_k with K[2,2]=+1 (loader_scannet.py + helpers.py:50-61). The
    renderer here works in the blender convention (_look_at: camera looks
    along -z), so the saved pose is c2w_blender @ diag(1,-1,-1,1): the y/z
    column flip that maps OpenCV camera axes onto blender's. Without it the
    loaded rays point backward and vertically flipped relative to the rendered
    pixels (caught on the first on-chip ScanNet cycle, r5: train-batch PSNR
    rose but held-out views sat at ~14 dB).
    """
    from dmnerf_tpu.data.hdf5 import write_dataset
    from dmnerf_tpu.utils.image_io import imwrite

    spec = default_spec(n_objects, seed)
    focal = float(W)
    # loader-convention intrinsics (positive, ScanNet-style) in the files; the
    # pixels are rendered with the blender-convention K that matches _look_at
    K = np.array([[focal, 0, W * 0.5], [0, focal, H * 0.5], [0, 0, 1]], np.float32)
    K_render = np.array([[focal, 0, W * 0.5], [0, -focal, H * 0.5], [0, 0, -1]], np.float32)
    intr = np.eye(4, dtype=np.float32)
    intr[:3, :3] = K
    os.makedirs(os.path.join(out_dir, "intrinsic"), exist_ok=True)
    np.savetxt(os.path.join(out_dir, "intrinsic", "intrinsic_color.txt"), intr)
    np.savetxt(os.path.join(out_dir, "intrinsic", "intrinsic_depth.txt"), intr)

    rng = np.random.RandomState(seed + 2)
    radius = 4.0
    frame = 0
    for split, count in [("train", n_train), ("test", n_test)]:
        ids = list(range(frame, frame + count))
        frame += count
        np.savetxt(os.path.join(out_dir, f"{split}_split_idx.txt"), np.asarray(ids, np.int32),
                   fmt="%d")
        img_dir = os.path.join(out_dir, split, f"{split}_images")
        pose_dir = os.path.join(out_dir, split, f"{split}_pose")
        ins_dir = os.path.join(out_dir, split, f"{split}_ins")
        for d in (img_dir, pose_dir, ins_dir):
            os.makedirs(d, exist_ok=True)
        for i in ids:
            ang = 2 * np.pi * i / (n_train + n_test)
            eye = np.array([radius * np.cos(ang), radius * np.sin(ang), 1.6], np.float32)
            c2w = _look_at(eye, np.zeros(3, np.float32))
            rgb, label = render_view(c2w, H, W, K_render, spec)
            # raw ScanNet labels: -1 unlabeled; object k -> label k-1; background
            # pixels unlabeled, plus randomly dropped labeled pixels (weak labels)
            raw = label.astype(np.int32) - 1
            drop = rng.rand(H, W) < unlabeled_frac
            raw[drop] = -1
            imwrite(os.path.join(img_dir, f"{i}.jpg"), (rgb * 255).astype(np.uint8))
            # save the OpenCV-convention pose (see docstring): blender -> cv
            c2w_cv = c2w @ np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
            np.savetxt(os.path.join(pose_dir, f"{i}.txt"), c2w_cv)
            np.savez(os.path.join(ins_dir, f"{i}.npz"), ins_2d_label_id=raw)

    palette = rng.randint(0, 255, size=(n_objects + 4, 3)).astype(np.uint8)
    write_dataset(os.path.join(out_dir, "ins_rgb.hdf5"), palette)
    return spec


def _write_mani_gt(out_dir, spec, H, W, K, n_test, modes):
    """Manipulated-GT folders in the loader_dmsr_mani layout
    (indoor_{mode}_test/{rgbs, semantic_instance}); the GT is re-rendered with the
    object transform applied to the scene spec."""
    from dmnerf_tpu.utils.image_io import imwrite

    with open(os.path.join(out_dir, "test", "transforms.json")) as f:
        meta = json.load(f)
    # the mani loader reads poses from the TOP-LEVEL transforms.json
    with open(os.path.join(out_dir, "transforms.json"), "w") as f:
        json.dump(meta, f)

    for mode in modes:
        spec2 = {k: v.copy() for k, v in spec.items()}
        if mode == "translation":
            spec2["centers"][0] += np.array([0, -0.25, 0], np.float32)
        elif mode == "scale":
            spec2["radii"][0] *= 1.2
        elif mode == "rotation":
            pass  # spheres are rotation-invariant; GT equals the original render
        root = os.path.join(out_dir, f"indoor_{mode}_test")
        os.makedirs(os.path.join(root, "rgbs"), exist_ok=True)
        os.makedirs(os.path.join(root, "semantic_instance"), exist_ok=True)
        for t, fr in enumerate(meta["frames"]):
            c2w = np.array(fr["transform_matrix"], np.float32)
            rgb, label = render_view(c2w, H, W, K, spec2)
            imwrite(os.path.join(root, "rgbs", f"{t:04d}.png"), (rgb * 255).astype(np.uint8))
            imwrite(
                os.path.join(root, "semantic_instance", f"{t:04d}.png"), label.astype(np.uint8)
            )
