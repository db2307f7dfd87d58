"""DM-SR (synthetic, blender-style) dataset loader.

Behavioral parity with /root/reference/datasets/loader_dmsr.py:38-175:
 * {train,test}/rgbs/*.png sorted + {split}/transforms.json (camera_angle_x +
   per-frame transform_matrix), testskip applied to the test split;
 * {split}/semantic_instance/*.png integer label maps;
 * ins_rgb.hdf5 palette ('datasets' key) -> ins_num = palette length;
 * objs_info.json: objects / view_id / ins_map for the manipulation demo;
 * intrinsics: focal = 0.5 * W / tan(0.5 * camera_angle_x),
   K = [[f, 0, W/2], [0, -f, H/2], [0, 0, -1]]  — the NEGATIVE fy / -1 fz blender
   convention (loader_dmsr.py:172) that makes get_rays_k produce -y/-z camera rays;
 * demo view poses: repeat poses[view_id] when given, else a spherical path at
   (theta ∈ linspace(0,180,views), phi=-65, r=7) (loader_dmsr.py:155-162).
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from dmnerf_tpu.configs import Config
from dmnerf_tpu.data.hdf5 import read_dataset
from dmnerf_tpu.data.scene import SceneData
from dmnerf_tpu.utils.image_io import imread


def _read_image(path: str) -> np.ndarray:
    return imread(path)


def _sorted_files(d: str) -> List[str]:
    return [os.path.join(d, f) for f in sorted(os.listdir(d))]


def _rot_x(phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], np.float32)


def _rot_y(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], np.float32)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Reference pose_spherical (loader_dmsr.py:29-34): translate z, rotate phi, rotate
    theta, then the blender axis flip."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = radius
    c2w = _rot_x(phi_deg / 180.0 * np.pi) @ c2w
    c2w = _rot_y(theta_deg / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    return flip @ c2w


def _load_split(basedir: str, split: str, skip: int):
    rgb_dir = os.path.join(basedir, split, "rgbs")
    rgbs = [_read_image(f) for f in _sorted_files(rgb_dir)]
    with open(os.path.join(basedir, split, "transforms.json")) as f:
        meta = json.load(f)
    poses = np.array([fr["transform_matrix"] for fr in meta["frames"]], np.float32)[::skip]
    idx = np.arange(0, len(rgbs), skip)
    rgbs = (np.array(rgbs)[idx] / 255.0).astype(np.float32)[..., :3]

    ins_dir = os.path.join(basedir, split, "semantic_instance")
    labels = np.array([_read_image(f) for f in _sorted_files(ins_dir)])[idx]
    return rgbs, poses.reshape(-1, 4, 4), labels, meta["camera_angle_x"]


def load_palette(basedir: str) -> np.ndarray:
    return read_dataset(os.path.join(basedir, "ins_rgb.hdf5"), "datasets")


def load_dmsr(cfg: Config) -> SceneData:
    basedir = cfg.datadir
    skip_test = cfg.testskip if cfg.testskip != 0 else 1
    train_rgbs, train_poses, train_labels, angle_x = _load_split(basedir, "train", 1)
    test_rgbs, test_poses, test_labels, _ = _load_split(basedir, "test", skip_test)

    images = np.concatenate([train_rgbs, test_rgbs], 0)
    poses = np.concatenate([train_poses, test_poses], 0)
    gt_labels = np.concatenate([train_labels, test_labels], 0)
    i_train = np.arange(len(train_rgbs))
    i_test = np.arange(len(train_rgbs), len(images))

    with open(os.path.join(basedir, "objs_info.json")) as f:
        objs_info = json.load(f)
    objs, view_id, ins_map = objs_info["objects"], objs_info["view_id"], objs_info["ins_map"]

    if view_id is not None:
        view_poses = np.repeat(poses[view_id][None], cfg.views, axis=0)
    else:
        view_poses = np.stack(
            [pose_spherical(a, -65.0, 7.0) for a in np.linspace(0, 180, cfg.views)], 0
        )

    ins_rgbs = load_palette(basedir)
    H, W = images.shape[1:3]
    focal = 0.5 * W / np.tan(0.5 * angle_x)
    K = np.array([[focal, 0, W * 0.5], [0, -focal, H * 0.5], [0, 0, -1]], np.float32)

    return SceneData(
        images=images, poses=poses, H=int(H), W=int(W), K=K,
        i_train=i_train, i_test=i_test, gt_labels=gt_labels.astype(np.int32),
        ins_rgbs=ins_rgbs, ins_num=len(ins_rgbs),
        objs=objs, view_poses=view_poses, ins_map=ins_map,
    )
