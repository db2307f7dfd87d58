"""The DM-NeRF MLP as a pure-functional pytree of parameters.

Architecture parity with the reference DM_NeRF module
(/root/reference/networks/dm_nerf.py:58-106):

  trunk:   D=8 Linear(W=256) + ReLU layers, skip-concat of the embedded position
           after the ReLU of layer index 4 (skips=[4], reference config.py:153).
  density: Linear(W -> 1) on the trunk feature (no activation here; ReLU applied
           in the compositor, reference render.py:7).
  rgb:     Linear(W -> W) (NO relu), concat embedded view dirs,
           Linear(W+Dv -> W/2) + ReLU, Linear(W/2 -> 3).
  ins:     stop_gradient(trunk feature)  [the reference's h.detach() at
           dm_nerf.py:95 — the instance head must not shape the geometry],
           Linear(W -> W) (NO relu), Linear(W -> W/2) + ReLU,
           Linear(W/2 -> ins_num+1)  [+1 = the "air"/emptiness channel].
  output:  concat [rgb(3), density(1), ins(ins_num+1)]  -> raw [..., 4+ins_num+1].

Design notes:
 * parameters are a flat dict of [in, out] matrices so every layer is a single
   row-major [rows, in] x [in, out] matmul (a plain GEMM for XLA / cuBLAS);
 * the apply function is shape-polymorphic over leading dims and dtype-polymorphic
   (bf16 perf mode casts inputs/params; accumulation stays f32 via
   preferred_element_type);
 * initialization matches torch.nn.Linear's default (U(-1/sqrt(fan_in), +1/sqrt(fan_in))
   for both weight and bias) so training dynamics are comparable.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp

Params = Dict[str, jnp.ndarray]


def _linear_init(key, fan_in: int, fan_out: int, dtype=jnp.float32) -> Tuple[jnp.ndarray, jnp.ndarray]:
    kw, kb = jax.random.split(key)
    bound = 1.0 / jnp.sqrt(jnp.asarray(float(fan_in)))
    w = jax.random.uniform(kw, (fan_in, fan_out), dtype, -1.0, 1.0) * bound
    b = jax.random.uniform(kb, (fan_out,), dtype, -1.0, 1.0) * bound
    return w, b


def init_dm_nerf(
    key,
    ins_num: int,
    D: int = 8,
    W: int = 256,
    input_ch_pts: int = 63,
    input_ch_views: int = 27,
    skips: Sequence[int] = (4,),
    dtype=jnp.float32,
) -> Params:
    keys = jax.random.split(key, D + 7)
    params: Params = {}
    in_dim = input_ch_pts
    for i in range(D):
        params[f"trunk_{i}_w"], params[f"trunk_{i}_b"] = _linear_init(keys[i], in_dim, W, dtype)
        in_dim = W + input_ch_pts if i in skips else W
    params["rgb_feat_w"], params["rgb_feat_b"] = _linear_init(keys[D], W, W, dtype)
    params["rgb_hid_w"], params["rgb_hid_b"] = _linear_init(keys[D + 1], W + input_ch_views, W // 2, dtype)
    params["rgb_out_w"], params["rgb_out_b"] = _linear_init(keys[D + 2], W // 2, 3, dtype)
    params["ins_feat_w"], params["ins_feat_b"] = _linear_init(keys[D + 3], W, W, dtype)
    params["ins_hid_w"], params["ins_hid_b"] = _linear_init(keys[D + 4], W, W // 2, dtype)
    params["ins_out_w"], params["ins_out_b"] = _linear_init(keys[D + 5], W // 2, ins_num + 1, dtype)
    params["density_w"], params["density_b"] = _linear_init(keys[D + 6], W, 1, dtype)
    return params


def _matmul(x, w, b):
    return jnp.dot(x, w, preferred_element_type=jnp.float32).astype(x.dtype) + b


def dm_nerf_apply(
    params: Params,
    pts_embedded: jnp.ndarray,   # [..., input_ch_pts]
    dirs_embedded: jnp.ndarray,  # [..., input_ch_views]
    D: int = 8,
    skips: Sequence[int] = (4,),
) -> jnp.ndarray:
    """Returns raw [..., 3 + 1 + ins_num + 1] = [rgb, sigma, ins_logits]."""
    h = pts_embedded
    for i in range(D):
        h = jax.nn.relu(_matmul(h, params[f"trunk_{i}_w"], params[f"trunk_{i}_b"]))
        if i in skips:
            # skip-concat AFTER the relu of layer i (reference dm_nerf.py:89-91)
            h = jnp.concatenate([h, pts_embedded], axis=-1)

    density = _matmul(h, params["density_w"], params["density_b"])

    rgb_feat = _matmul(h, params["rgb_feat_w"], params["rgb_feat_b"])  # no relu
    rgb_feat = jnp.concatenate([rgb_feat, dirs_embedded], axis=-1)
    rgb_feat = jax.nn.relu(_matmul(rgb_feat, params["rgb_hid_w"], params["rgb_hid_b"]))
    rgb = _matmul(rgb_feat, params["rgb_out_w"], params["rgb_out_b"])

    # the object field head reads the trunk feature through a gradient wall
    # (reference dm_nerf.py:95): instance supervision never updates the geometry.
    ins_feat = jax.lax.stop_gradient(h)
    ins_feat = _matmul(ins_feat, params["ins_feat_w"], params["ins_feat_b"])  # no relu
    ins_feat = jax.nn.relu(_matmul(ins_feat, params["ins_hid_w"], params["ins_hid_b"]))
    ins = _matmul(ins_feat, params["ins_out_w"], params["ins_out_b"])

    return jnp.concatenate([rgb, density, ins], axis=-1)


def num_params(params: Params) -> int:
    return sum(int(p.size) for p in params.values())


def rgb_stub_params(params: Params, stub_w: int = 8) -> Params:
    """Shrink ONLY the rgb branch (rgb_feat/rgb_hid/rgb_out) to `stub_w`-wide
    zero weights, keeping the trunk, density head AND instance head intact.

    For forward-only consumers that need sigma + ins but not color: the
    manipulator's pass-1 label accumulation reads only the accumulated instance
    logits, and its exchanged-coarse weight recomputation reads only sigma
    (reference manipulator.py:137-160). The stubbed pytree drops the rgb
    branch's matmuls from the query whatever the compiler's dead-code
    elimination does. The sigma and ins channels are computed by the same
    trunk/density/ins matmuls as with the full pytree; they agree with it up to
    the matmul library's choice of algorithm for the differently shaped graph
    (bit-equal on the CPU backend, tests/test_query.py). The rgb channels of the
    result are garbage and must not be consumed."""
    W, zeros = params["density_w"].shape[0], jnp.zeros
    dtype = params["density_w"].dtype
    emb_views = params["rgb_hid_w"].shape[0] - params["rgb_feat_w"].shape[1]
    out = dict(params)
    out.update(
        rgb_feat_w=zeros((W, stub_w), dtype), rgb_feat_b=zeros((stub_w,), dtype),
        rgb_hid_w=zeros((stub_w + emb_views, stub_w), dtype),
        rgb_hid_b=zeros((stub_w,), dtype),
        rgb_out_w=zeros((stub_w, 3), dtype), rgb_out_b=zeros((3,), dtype),
    )
    return out


def sigma_stub_params(params: Params, stub_w: int = 8) -> Params:
    """Shrink the rgb/ins head branches to `stub_w`-wide zero weights, keeping the
    trunk and density head intact.

    For forward-only consumers that need ONLY sigma (the test renderer's coarse
    pass exists solely to produce `sample_pdf` weights — reference
    render.py:62-68 via tester.py:62-76 — and the mesh sigma sweep). The stubbed
    pytree drops the head branches' matmuls from the query whatever the
    compiler's dead-code elimination does. The sigma column comes from the same
    trunk and density matmuls as with the full pytree; it agrees with it up to
    the matmul library's choice of algorithm for the differently shaped graph
    (bit-equal on the CPU backend, tests/test_query.py). The rgb/ins channels of
    the result are garbage and must not be consumed."""
    W, zeros = params["density_w"].shape[0], jnp.zeros
    dtype = params["density_w"].dtype
    emb_views = params["rgb_hid_w"].shape[0] - params["rgb_feat_w"].shape[1]
    out = {k: v for k, v in params.items()
           if k.startswith("trunk_") or k.startswith("density_")}
    out.update(
        rgb_feat_w=zeros((W, stub_w), dtype), rgb_feat_b=zeros((stub_w,), dtype),
        rgb_hid_w=zeros((stub_w + emb_views, stub_w), dtype),
        rgb_hid_b=zeros((stub_w,), dtype),
        rgb_out_w=zeros((stub_w, 3), dtype), rgb_out_b=zeros((3,), dtype),
        ins_feat_w=zeros((W, stub_w), dtype), ins_feat_b=zeros((stub_w,), dtype),
        ins_hid_w=zeros((stub_w, stub_w), dtype), ins_hid_b=zeros((stub_w,), dtype),
        ins_out_w=zeros((stub_w, 1), dtype), ins_out_b=zeros((1,), dtype),
    )
    return out
