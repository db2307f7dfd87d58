"""End-to-end pytest coverage of the unified eval driver (dmnerf_tpu.test.run_test)
and the manipulation drivers (VERDICT r2 item 7).

The engine below these drivers is parity-tested elsewhere
(tests/test_manipulator_parity.py, tests/test_reference_parity.py); these tests pin
the DRIVER contracts, which previously only the manual verify recipe exercised:

 * artifact formats — test_results.txt is the reference's 9-column layout with a
   trailing mean row (/root/reference/networks/tester.py:155-165), matching_log.json
   is a per-view pred->GT dict (tester.py:150-153), PNGs have the scene's H x W;
 * save-dir naming — render_{path|test}_{iter:06d} / mani_eval_{iter:06d}/<mode> /
   mani_demo_{iter:06d}/mani_output / mesh_{iter:06d} (reference test_dmsr.py:13-73);
 * pose plumbing — mani_eval composes tar_pose = trans @ ori_pose
   (reference manipulator.py:238) via tools.pose_gen + load_mani_poses;
 * the reference-layout ./data/color_dict.json keyed [dataset][scene]
   (tester.py:48-50) through load_color_dict.

A checkpoint at init params suffices: the contracts under test are formats and
plumbing, not image quality.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from dmnerf_tpu.configs import Config
from dmnerf_tpu.data.synthetic import write_dmsr_scene
from dmnerf_tpu.render.trainstep import create_train_state
from dmnerf_tpu.test import load_color_dict, run_test
from dmnerf_tpu.utils.checkpoint import save_checkpoint

H = W = 32
INS = 6
N_TEST_VIEWS = 2


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("drivers")
    datadir = root / "dmsr" / "study"
    write_dmsr_scene(str(datadir), n_train=3, n_test=N_TEST_VIEWS, H=H, W=W,
                     n_objects=3, ins_num=INS, mani_modes=["translation"])
    cfg = Config(
        expname="drv", basedir=str(root / "logs"), datadir=str(datadir),
        dataset_type="dmsr", N_samples=8, N_importance=8, N_train=64, N_test=256,
        near=1.0, far=8.0, netdepth=2, netwidth=32, multires=4, multires_views=2,
        ins_num=INS, testskip=1, views=2, mesh_grid_dim=20, mesh_level=0.1,
    )
    state = create_train_state(cfg, jax.random.PRNGKey(0))
    save_checkpoint(cfg.log_dir, state)
    return cfg


def _assert_results_txt(path, n_views):
    assert os.path.exists(path), path
    table = np.loadtxt(path)
    assert table.shape == (n_views + 1, 9), table.shape  # per-view rows + mean row
    # mean row aggregates the per-view rows (nanmean for the LPIPS column)
    got, want = table[-1], np.nanmean(table[:-1], axis=0)
    mask = ~np.isnan(want)
    np.testing.assert_allclose(got[mask], want[mask], atol=1e-5)


def _png_shape(path):
    import imageio.v2 as imageio

    return imageio.imread(path).shape


def test_run_test_render_artifacts(env):
    cfg = env.replace(render=True)
    run_test(cfg)
    savedir = os.path.join(cfg.log_dir, "render_path_000000")
    assert os.path.isdir(savedir), os.listdir(cfg.log_dir)
    _assert_results_txt(os.path.join(savedir, "test_results.txt"), N_TEST_VIEWS)
    with open(os.path.join(savedir, "matching_log.json")) as f:
        log = json.load(f)
    assert len(log) == N_TEST_VIEWS
    for _, m in log.items():
        assert all(isinstance(v, int) for v in m.values())
    for i in range(N_TEST_VIEWS):
        assert _png_shape(os.path.join(savedir, f"{i:03d}.png"))[:2] == (H, W)
        assert _png_shape(os.path.join(savedir, f"instance_{i:03d}.png"))[:2] == (H, W)
        assert _png_shape(os.path.join(savedir, f"{i}_ins_gt.png"))[:2] == (H, W)


def test_run_test_mani_eval_artifacts(env):
    cfg = env.replace(mani_eval=True, mani_mode="translation", target_label=1)
    run_test(cfg)
    savedir = os.path.join(cfg.log_dir, "mani_eval_000000", "translation")
    assert os.path.isdir(savedir), os.listdir(cfg.log_dir)
    # pose generator wrote the transformation series the driver consumed
    # (reference pose_generator.py:9-84 -> manipulator.py:238)
    tm = os.path.join(cfg.datadir, "transformation_matrix.json")
    assert os.path.exists(tm)
    with open(tm) as f:
        trans = json.load(f)
    assert any(d.get("mode") == "translation" for d in trans["transformations"]), trans
    n_views = len(
        [f for f in os.listdir(savedir) if f.endswith("_rgb.png") and "gt" not in f])
    assert n_views >= 1
    _assert_results_txt(os.path.join(savedir, "test_results.txt"), n_views)
    with open(os.path.join(savedir, "matching_log.json")) as f:
        json.load(f)
    assert _png_shape(os.path.join(savedir, "0_rgb.png"))[:2] == (H, W)
    assert _png_shape(os.path.join(savedir, "0_ins.png"))[:2] == (H, W)
    assert _png_shape(os.path.join(savedir, "0_rgb_gt.png"))[:2] == (H, W)


def test_run_test_mani_demo_artifacts(env):
    cfg = env.replace(mani_demo=True, views=2)
    run_test(cfg)
    savedir = os.path.join(cfg.log_dir, "mani_demo_000000", "mani_output")
    assert os.path.isdir(savedir), os.listdir(cfg.log_dir)
    for i in range(2):
        assert _png_shape(os.path.join(savedir, f"{i}_rgb.png"))[:2] == (H, W)
        assert _png_shape(os.path.join(savedir, f"{i}_ins.png"))[:2] == (H, W)
        mask = os.path.join(savedir, f"{i}_ins_pred_mask.png")
        assert _png_shape(mask)[:2] == (H, W)


def test_run_test_mesh_artifacts(env):
    cfg = env.replace(mesh=True)
    run_test(cfg)
    savedir = os.path.join(cfg.log_dir, "mesh_000000")
    ply = os.path.join(savedir, "color_mesh.ply")
    assert os.path.exists(ply), os.listdir(savedir)
    with open(ply, "rb") as f:
        head = f.read(200).decode("latin1")
    assert head.startswith("ply")


def test_load_color_dict_reference_nested_layout(env):
    """./data/color_dict.json keyed [dataset][scene]
    (reference networks/tester.py:48-50): datadir <root>/dmsr/study must resolve
    the nested entry two levels up."""
    root = os.path.dirname(os.path.dirname(env.datadir))
    path = os.path.join(root, "color_dict.json")
    nested = {"dmsr": {"study": {"3": 7, "1": 2}}, "replica": {"room_0": {"0": 0}}}
    with open(path, "w") as f:
        json.dump(nested, f)
    try:
        got = load_color_dict(env)
        assert got == {"3": 7, "1": 2}
    finally:
        os.remove(path)


def test_load_color_dict_fallback_identity(env):
    got = load_color_dict(env)
    assert got == {str(i): i for i in range(env.ins_num)}


def test_mesh_sigma_query_matches_direct():
    """make_sigma_query (platform query path + sigma_stub_params) must equal the
    direct PE+MLP sigma: the stub keeps sigma exact by per-column matmul
    independence, and zero view dirs cannot leak into the density branch."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dmnerf_tpu.configs import Config
    from dmnerf_tpu.core.embedding import positional_encoding
    from dmnerf_tpu.core.mlp import dm_nerf_apply
    from dmnerf_tpu.render.trainstep import create_train_state
    from dmnerf_tpu.tools.mesh_extract import make_sigma_query

    cfg = Config(netdepth=2, netwidth=32, multires=4, multires_views=2, skips=(0,),
                 N_samples=8, N_importance=8, N_train=16, near=1.0, far=8.0,
                 ins_num=4)
    state = create_train_state(cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(2)
    pts = jnp.asarray(rng.uniform(-2, 2, (300, 3)).astype(np.float32))  # odd n: pad path

    q = make_sigma_query(cfg, chunk=128, samples=8)
    sig = np.asarray(q(state.params_fine, pts))

    emb_p = positional_encoding(pts, cfg.multires)
    emb_d = positional_encoding(jnp.zeros_like(pts), cfg.multires_views)
    raw = dm_nerf_apply(state.params_fine, emb_p, emb_d, D=cfg.netdepth,
                        skips=tuple(cfg.skips))
    np.testing.assert_allclose(sig, np.asarray(raw[..., 3]), rtol=1e-6, atol=1e-6)


def test_ft_path_explicit_step_both_drivers(env):
    """ft_path names ONE checkpoint and its STEP is honored in both drivers
    (VERDICT r4 weak #5: the old train-side load silently took the LATEST step).
    With checkpoints at steps 0 and 7, pointing at checkpoints/000000 must load
    step 0 — in the test driver's eval load AND the train driver's fine-tune
    load. Reference bar: --ft_path names one specific weights file
    (/root/reference/config.py:42)."""
    from dmnerf_tpu.test import load_params
    from dmnerf_tpu.train import train
    from dmnerf_tpu.utils.checkpoint import resolve_ckpt_path, restore_from_path

    # a dedicated source run dir (don't mutate env's shared run dir) with
    # checkpoints at steps 0 and 7
    src = env.replace(expname="drv_ft_src")
    state0 = create_train_state(src, jax.random.PRNGKey(1))
    save_checkpoint(src.log_dir, state0)
    state7 = state0._replace(step=jax.numpy.asarray(7, jax.numpy.int32))
    save_checkpoint(src.log_dir, state7)
    ck0 = os.path.join(src.log_dir, "checkpoints", "000000")
    assert resolve_ckpt_path(ck0) == (src.log_dir, 0)
    # run dir / checkpoints dir forms resolve to the LATEST step
    assert resolve_ckpt_path(src.log_dir) == (src.log_dir, 7)
    assert resolve_ckpt_path(os.path.join(src.log_dir, "checkpoints")) == (src.log_dir, 7)

    # test-side eval load: exact step 0, not latest
    state, step = load_params(env.replace(ft_path=ck0))
    assert step == 0 and int(state.step) == 0

    # train-side fine-tune load: a 1-iter run from step 0 ends (and saves) at
    # step 1; had ft_path loaded the latest (7 >= N_iters), zero steps would run
    # and the final save would land at 000007 instead
    cfg2 = env.replace(expname="drv_ft", ft_path=ck0, N_iters=1,
                       i_print=1, i_save=1000, i_test=1000)
    train(cfg2)
    assert os.path.isdir(os.path.join(cfg2.log_dir, "checkpoints", "000001"))
    assert not os.path.isdir(os.path.join(cfg2.log_dir, "checkpoints", "000007"))

    # loud failures: nonexistent step dir / dir with no checkpoints at all
    with pytest.raises(FileNotFoundError):
        restore_from_path(os.path.join(env.log_dir, "checkpoints", "000042"), state7)
    with pytest.raises(FileNotFoundError):
        restore_from_path(os.path.join(env.basedir, "no_such_run"), state7)
