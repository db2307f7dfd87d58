"""On-device pixel/ray samplers for training batches.

Behavioral parity:
 * make_full_sampler == reference get_select_full (/root/reference/networks/
   helpers.py:99-111): one random train image per step, N_train pixels chosen
   uniformly WITHOUT replacement, rays + rgb + instance targets gathered.
 * make_crop_sampler == reference get_select_crop (helpers.py:64-96): 30% of rays
   from the image's weakly-labeled instance pixels, the rest from the center-crop
   region; labeled rays form the batch SUFFIX, and only they carry instance targets.
   (The released code computes a labeled/unlabeled set difference and then discards
   it, indexing crop_indices by position — loader drift, SURVEY.md §4; the effective
   behavior, random crop pixels for the RGB part, is what we implement.)
   N_ins is static: int(N_train * 0.3) (helpers.py:65) — the reference's dynamic
   clamp to len(ins_index) becomes a padding mask, keeping the step shape-stable.

Design: the reference materializes the full HxW ray grid per step and
gathers on it after a host-side np.random.choice (helpers.py:102-108). Here the whole
sampler is jit-ed device code: pixel ids are drawn with jax.random (threaded keys),
and rays are computed ONLY for the selected pixels (core.rays.rays_for_pixels), so per
step the ray math is O(N_train), not O(H*W), with zero host involvement.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from dmnerf_tpu.core.rays import rays_for_pixels
from dmnerf_tpu.render.trainstep import Batch


def make_full_sampler(images, labels, poses, K, i_train, n_train: int):
    """images [M,H,W,3], labels [M,H,W], poses [M,4,4], K [3,3], i_train [T].
    Returns sample(key) -> Batch, jitted."""
    images = jnp.asarray(images)
    labels = jnp.asarray(labels, jnp.int32)
    poses = jnp.asarray(poses)
    K = jnp.asarray(K)
    i_train = jnp.asarray(i_train, jnp.int32)
    M, H, W = images.shape[0], images.shape[1], images.shape[2]

    @jax.jit
    def sample(key) -> Batch:
        k_img, k_pix = jax.random.split(key)
        img_i = i_train[jax.random.randint(k_img, (), 0, i_train.shape[0])]
        flat = jax.random.choice(k_pix, H * W, (n_train,), replace=False)
        py, px = flat // W, flat % W
        c2w = poses[img_i]
        rays_o, rays_d = rays_for_pixels(py, px, K, c2w)
        target_c = images[img_i][py, px]
        target_i = labels[img_i][py, px]
        return Batch(rays_o, rays_d, target_c, target_i)

    return sample


def make_crop_sampler(
    images, labels, poses, K, i_train, n_train: int,
    ins_indices, crop_mask,
):
    """ScanNet crop + label-balanced sampler. ins_indices: list (per train image) of
    flat labeled-pixel ids; crop_mask: [H, W] 0/1. Returns (sample(key) -> Batch, N_ins).
    """
    images = jnp.asarray(images)
    labels = jnp.asarray(labels, jnp.int32)
    poses = jnp.asarray(poses)
    K = jnp.asarray(K)
    i_train_np = np.asarray(i_train)
    M, H, W = images.shape[0], images.shape[1], images.shape[2]

    n_ins = int(n_train * 0.3)
    n_rgb = n_train - n_ins

    # pad per-image labeled ids to a static [T, L] table + validity counts;
    # L >= n_ins so top_k stays valid even when every image is under-labeled
    L = max(max(len(ix) for ix in ins_indices), n_ins)
    table = np.zeros((len(ins_indices), L), np.int32)
    counts = np.zeros((len(ins_indices),), np.int32)
    for i, ix in enumerate(ins_indices):
        table[i, : len(ix)] = ix
        counts[i] = len(ix)
    table = jnp.asarray(table)
    counts = jnp.asarray(counts)
    i_train_j = jnp.asarray(i_train_np, jnp.int32)

    crop_flat = np.where(np.asarray(crop_mask).reshape(-1) == 1)[0].astype(np.int32)
    crop_flat = jnp.asarray(crop_flat)

    @jax.jit
    def sample(key) -> Batch:
        k_img, k_lab, k_rgb = jax.random.split(key, 3)
        t = jax.random.randint(k_img, (), 0, i_train_j.shape[0])
        img_i = i_train_j[t]

        # labeled pixels: Gumbel top-k over the padded table (invalid slots sunk)
        valid = jnp.arange(L) < counts[t]
        scores = jax.random.uniform(k_lab, (L,)) + jnp.where(valid, 0.0, -1e9)
        _, top = jax.lax.top_k(scores, n_ins)
        labeled = table[t][top]
        # slots past counts[t] are padding (image has < n_ins labeled pixels);
        # they resolve to pixel table[t][...]=0 and must NOT enter the instance
        # loss — the mask reaches compute_losses via Batch.target_valid (the
        # static-shape analog of the reference's dynamic clamp, helpers.py:64-67)
        labeled_valid = valid[top]

        # rgb pixels: uniform over the crop region (without replacement)
        rgb_ids = jax.random.choice(k_rgb, crop_flat, (n_rgb,), replace=False)

        flat = jnp.concatenate([rgb_ids, labeled])   # labeled rays are the SUFFIX
        py, px = flat // W, flat % W
        c2w = poses[img_i]
        rays_o, rays_d = rays_for_pixels(py, px, K, c2w)
        target_c = images[img_i][py, px]
        target_i = labels[img_i][py, px]
        target_valid = jnp.concatenate([jnp.ones((n_rgb,), bool), labeled_valid])
        return Batch(rays_o, rays_d, target_c, target_i, target_valid)

    return sample, n_ins
