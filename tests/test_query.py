"""The point query (PE + DM-NeRF MLP as plain XLA ops) against an independent
float64 numpy implementation, its gradient wall, the stubbed-head pytrees, the
config-driven choice of query, and the sharded train step over it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dmnerf_tpu.configs import Config
from dmnerf_tpu.core.embedding import embed_dim
from dmnerf_tpu.core.mlp import init_dm_nerf, rgb_stub_params, sigma_stub_params
from dmnerf_tpu.core.pipeline import make_query_fn, make_xla_query_fn

CASES = [
    # (multires, multires_views, D, W, skips, ins_num)
    (4, 2, 2, 32, (0,), 4),     # the tiny test net
    (10, 4, 8, 64, (4,), 8),    # flagship topology, narrow for CPU speed
    (6, 3, 5, 32, (1, 3), 4),   # multiple skips
]


def _setup(multires, multires_views, D, W, skips, ins_num, N=6, S=8, seed=0):
    params = init_dm_nerf(
        jax.random.PRNGKey(seed), ins_num=ins_num, D=D, W=W,
        input_ch_pts=embed_dim(multires), input_ch_views=embed_dim(multires_views),
        skips=skips,
    )
    rng = np.random.RandomState(seed)
    pts = jnp.asarray(rng.uniform(-1.0, 1.0, (N, S, 3)).astype(np.float32))
    dirs = rng.randn(N, 3).astype(np.float32)
    dirs = jnp.asarray(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    return params, pts, dirs, make_xla_query_fn(multires, multires_views, D, skips)


def _pe64(x, multires):
    """[x, sin(x f0), cos(x f0), sin(x f1), ...] with f_k = 2**k, in float64."""
    if multires <= 0:
        return x
    out = [x]
    for k in range(multires):
        out += [np.sin(x * 2.0 ** k), np.cos(x * 2.0 ** k)]
    return np.concatenate(out, axis=-1)


def _query64(params, pts, dirs, multires, multires_views, D, skips):
    """The reference DM_NeRF forward (dm_nerf.py:58-106) in float64 numpy."""
    p = {k: np.asarray(v, np.float64) for k, v in params.items()}
    lin = lambda h, name: h @ p[name + "_w"] + p[name + "_b"]  # noqa: E731
    relu = lambda h: np.maximum(h, 0.0)  # noqa: E731
    x = _pe64(np.asarray(pts, np.float64), multires)
    d = _pe64(np.asarray(dirs, np.float64), multires_views)
    d = np.broadcast_to(d[:, None, :], x.shape[:-1] + d.shape[-1:])
    h = x
    for i in range(D):
        h = relu(lin(h, f"trunk_{i}"))
        if i in skips:
            h = np.concatenate([h, x], -1)
    sigma = lin(h, "density")
    rgb = lin(relu(lin(np.concatenate([lin(h, "rgb_feat"), d], -1), "rgb_hid")), "rgb_out")
    ins = lin(relu(lin(lin(h, "ins_feat"), "ins_hid")), "ins_out")
    return np.concatenate([rgb, sigma, ins], -1)


@pytest.mark.parametrize("case", CASES)
def test_xla_query_matches_float64_numpy(case):
    """float32 under 'highest' (conftest) vs float64: rounding of ~D+4 chained
    float32 dot products of <= W+63 terms, far below 1e-4 of the output scale."""
    multires, multires_views, D, W, skips, ins_num = case
    params, pts, dirs, q = _setup(*case)
    got = np.asarray(q(params, pts, dirs))
    want = _query64(params, pts, dirs, multires, multires_views, D, skips)
    assert got.shape == want.shape == (6, 8, 3 + 1 + ins_num + 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", CASES)
def test_ins_gradient_wall(case):
    """An instance-head-only loss produces ZERO trunk, density and rgb gradients
    (the reference's h.detach() at dm_nerf.py:95)."""
    params, pts, dirs, q = _setup(*case)
    g = jax.grad(lambda p: jnp.sum(q(p, pts, dirs)[..., 4:]))(params)
    for k, v in g.items():
        if k.startswith(("trunk_", "rgb_", "density")):
            np.testing.assert_array_equal(np.asarray(v), 0.0, err_msg=f"{k} leaked ins grads")
    assert float(jnp.sum(jnp.abs(g["ins_out_w"]))) > 0.0


@pytest.mark.parametrize("case", CASES)
def test_sigma_stub_params_sigma_exact(case):
    """sigma_stub_params keeps the trunk and density head, so the sigma column is
    the same float32 computation (bit-equal on the CPU backend)."""
    params, pts, dirs, q = _setup(*case)
    full_sigma = np.asarray(q(params, pts, dirs)[..., 3])
    stub_raw = np.asarray(q(sigma_stub_params(params), pts, dirs))
    assert stub_raw.shape[-1] == 5  # rgb(3) + sigma + 1 stub ins channel
    np.testing.assert_array_equal(stub_raw[..., 3], full_sigma)


@pytest.mark.parametrize("case", CASES)
def test_rgb_stub_params_sigma_and_ins_exact(case):
    """rgb_stub_params keeps the trunk, density and instance heads: sigma and every
    instance-logit channel equal the full pytree's; only rgb may differ."""
    params, pts, dirs, q = _setup(*case)
    full = np.asarray(q(params, pts, dirs))
    stub_raw = np.asarray(q(rgb_stub_params(params), pts, dirs))
    assert stub_raw.shape == full.shape
    np.testing.assert_array_equal(stub_raw[..., 3:], full[..., 3:])


@pytest.mark.parametrize("i_embed", [0, -1])
def test_make_query_fn_is_the_xla_query(i_embed):
    """make_query_fn builds the XLA query for both embeddings: PE (i_embed 0) and
    the identity (i_embed -1, 3-channel inputs)."""
    cfg = Config(netdepth=2, netwidth=16, skips=(0,), multires=3, multires_views=2,
                 i_embed=i_embed, ins_num=4)
    mr = cfg.multires if i_embed == 0 else -1
    mrv = cfg.multires_views if i_embed == 0 else -1
    params = init_dm_nerf(jax.random.PRNGKey(0), ins_num=4, D=2, W=16,
                          input_ch_pts=embed_dim(mr), input_ch_views=embed_dim(mrv),
                          skips=(0,))
    rng = np.random.RandomState(0)
    pts = jnp.asarray(rng.uniform(-1, 1, (3, 5, 3)).astype(np.float32))
    dirs = jnp.asarray(rng.randn(3, 3).astype(np.float32))
    got = np.asarray(make_query_fn(cfg)(params, pts, dirs))
    want = _query64(params, pts, dirs, mr, mrv, 2, (0,))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_step_matches_single_device(case):
    """One train step sharded over 8 virtual CPU devices (GSPMD partitions the XLA
    query over the ray axis) equals the single-device step."""
    from dmnerf_tpu.parallel.mesh import make_mesh, make_sharded_train_step, shard_batch
    from dmnerf_tpu.render.trainstep import Batch, create_train_state, make_train_step

    multires, multires_views, D, W, skips, ins_num = case
    cfg = Config(netdepth=D, netwidth=W, multires=multires, multires_views=multires_views,
                 skips=skips, N_samples=8, N_importance=8, N_train=32, near=2.0, far=7.0,
                 ins_num=ins_num, perturb=1.0, penalize=True, tolerance=0.05, deta_w=0.05)
    state = create_train_state(cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    rays_d = rng.randn(32, 3).astype(np.float32)
    rays_d[:, 2] = np.abs(rays_d[:, 2]) + 1.0
    batch = Batch(jnp.zeros((32, 3)), jnp.asarray(rays_d),
                  jnp.asarray(rng.rand(32, 3).astype(np.float32)),
                  jnp.asarray(rng.randint(0, ins_num, size=32)))
    key = jax.random.PRNGKey(1)
    copy = lambda: jax.tree_util.tree_map(lambda x: x.copy(), state)  # noqa: E731

    s_ref, aux_ref = make_train_step(cfg)(copy(), batch, key)
    mesh = make_mesh(n_devices=8, devices=jax.devices("cpu"))
    s_sh, aux_sh = make_sharded_train_step(cfg, mesh)(copy(), shard_batch(mesh, batch), key)

    np.testing.assert_allclose(float(aux_sh["total_loss"]), float(aux_ref["total_loss"]),
                               rtol=1e-4)
    for k in s_ref.params_fine:
        np.testing.assert_allclose(np.asarray(s_sh.params_fine[k]),
                                   np.asarray(s_ref.params_fine[k]),
                                   atol=1e-5, rtol=1e-3, err_msg=k)


@pytest.mark.gpu
def test_query_default_precision_close_to_highest_on_gpu(gpu_device):
    """On the card, the query at default matmul precision (TF32 may apply) stays
    within 1e-2 of the output scale of the same query under 'highest' (TF32 keeps
    10 mantissa bits; chip_smoke.py states the same bound at flagship width)."""
    params, pts, dirs, q = _setup(*CASES[1], N=64, S=32)
    params, pts, dirs = jax.device_put((params, pts, dirs), gpu_device)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(q)(params, pts, dirs))
    with jax.default_matmul_precision("default"):
        got = np.asarray(jax.jit(q)(params, pts, dirs))
    assert np.max(np.abs(got - want)) <= 1e-2 * np.max(np.abs(want))
