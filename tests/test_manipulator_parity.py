"""Manipulator parity vs the PyTorch reference (VERDICT r1 item 4).

Drives /root/reference/networks/manipulator.py's exchanger (lines 18-83) and the
full two-pass manipulator (137-205) in place on a tiny model and asserts the
repo's exchange / manipulate_rays match. The reference's importance sampling is
stochastic (sample_pdf det=False default); for a deterministic comparison the
reference module's sample_pdf is monkeypatched to det=True, matching our
key=None linspace path exactly.
"""

import os
import sys
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

REF = "/root/reference"
torch = pytest.importorskip("torch")
if not os.path.isdir(os.path.join(REF, "networks")):
    pytest.skip("reference checkout not available", allow_module_level=True)
if REF not in sys.path:
    sys.path.insert(0, REF)

# the reference module imports eval-only deps (lpips, cv2, skimage) at module
# scope; none are installed here and none are touched by exchanger/manipulator —
# stub them so the import succeeds (we never call the eval drivers)
for _mod in ("lpips", "cv2", "open3d", "trimesh"):
    sys.modules.setdefault(_mod, types.ModuleType(_mod))
if "skimage" not in sys.modules:
    _sk = types.ModuleType("skimage")
    _sk.metrics = types.ModuleType("skimage.metrics")
    sys.modules["skimage"] = _sk
    sys.modules["skimage.metrics"] = _sk.metrics

import networks.manipulator as ref_mani                       # noqa: E402
from networks.dm_nerf import get_embedder                     # noqa: E402
from networks.helpers import sample_pdf as ref_sample_pdf     # noqa: E402

import test_reference_parity as trp                           # noqa: E402
from dmnerf_tpu.configs import Config                         # noqa: E402
from dmnerf_tpu.core.mlp import init_dm_nerf                  # noqa: E402
from dmnerf_tpu.core.pipeline import make_xla_query_fn        # noqa: E402
from dmnerf_tpu.render.manipulator import exchange, manipulate_rays  # noqa: E402

INS = trp.INS


def test_exchanger_matches_reference():
    """Identical raw bundles + accumulated maps through both exchangers, single
    and multi move-label."""
    rng = np.random.RandomState(4)
    N, S, C = 16, 12, 4 + INS + 1
    ori_raw = rng.randn(N, S, C).astype(np.float32)
    tar_raws = [rng.randn(N, S, C).astype(np.float32) for _ in range(2)]
    # accumulated maps: the reference passes manipulator_render's ALREADY-sigmoided
    # ins map (incl. air) and re-sigmoids inside (a monotonic no-op on the argmax)
    ori_accum = 1 / (1 + np.exp(-rng.randn(N, INS + 1).astype(np.float32)))
    tar_accums = [1 / (1 + np.exp(-rng.randn(N, INS + 1).astype(np.float32)))
                  for _ in range(2)]

    for labels in ([2], [2, 4]):
        k = len(labels)
        ref_out, _, _, ref_tar_pred = ref_mani.exchanger(
            torch.from_numpy(ori_raw.copy()),
            [torch.from_numpy(t.copy()) for t in tar_raws[:k]],
            torch.from_numpy(ori_accum.copy()),
            [torch.from_numpy(t.copy()) for t in tar_accums[:k]],
            labels,
        )
        ours_out, _, _, ours_tar_pred = exchange(
            jnp.asarray(ori_raw), [jnp.asarray(t) for t in tar_raws[:k]],
            jnp.asarray(ori_accum), [jnp.asarray(t) for t in tar_accums[:k]],
            labels,
        )
        np.testing.assert_allclose(
            np.asarray(ours_out), ref_out.numpy(), atol=1e-6,
            err_msg=f"exchanged raw diverges (labels={labels})")
        np.testing.assert_array_equal(
            np.asarray(ours_tar_pred), ref_tar_pred.numpy(),
            err_msg=f"tar point labels diverge (labels={labels})")


def test_manipulate_rays_matches_reference(monkeypatch, setup_model):
    """Full two-pass union-z edit pipeline, deterministic sampling, K=1 target."""
    params, model = setup_model
    rng = np.random.RandomState(9)
    n = 12
    rays_o = rng.randn(n, 3).astype(np.float32) * 0.1
    rays_d = rng.randn(n, 3).astype(np.float32)
    rays_d[:, 2] = np.abs(rays_d[:, 2]) + 0.5
    tar_o = rays_o + np.array([0.3, 0.0, 0.0], np.float32)
    tar_d = rays_d.copy()

    # deterministic reference: the manipulator calls sample_pdf positionally
    # (bins, weights, N) with det defaulting to False (helpers.py:123)
    monkeypatch.setattr(ref_mani, "sample_pdf",
                        lambda b, w, ns: ref_sample_pdf(b, w, ns, det=True))

    pe, _ = get_embedder(trp.MULTIRES)
    ve, _ = get_embedder(trp.MULTIRES_VIEWS)
    args = types.SimpleNamespace(N_samples=9, N_importance=8, near=2.0, far=6.0,
                                 target_label=[2])
    with torch.no_grad():
        ref_rgb, ref_ins, ref_tar_rgb, ref_tar_accum = ref_mani.manipulator(
            pe, ve, model, model,
            (torch.from_numpy(rays_o), torch.from_numpy(rays_d)),
            [(torch.from_numpy(tar_o), torch.from_numpy(tar_d))],
            args,
        )

    cfg = Config(netdepth=trp.D, netwidth=trp.W, multires=trp.MULTIRES,
                 multires_views=trp.MULTIRES_VIEWS, skips=trp.SKIPS,
                 N_samples=9, N_importance=8, near=2.0, far=6.0, ins_num=INS)
    q = make_xla_query_fn(trp.MULTIRES, trp.MULTIRES_VIEWS, trp.D, trp.SKIPS)
    out = manipulate_rays(cfg, params, params,
                          (jnp.asarray(rays_o), jnp.asarray(rays_d)),
                          [(jnp.asarray(tar_o), jnp.asarray(tar_d))],
                          [2], query_fn=q, key=None)

    # tie-aware like test_reference_parity: inverse-CDF bin-edge ties can shift
    # isolated samples; exchanged raws make the composite a discontinuous function
    # of labels, so allow isolated outliers with a bounded envelope.
    for name, ours, ref in (("rgb", out["rgb"], ref_rgb),
                            ("ins", out["ins"], ref_ins),
                            ("tar_rgb", out["tar_rgb"], ref_tar_rgb),
                            ("tar_ins_accum", out["tar_ins_accum"], ref_tar_accum)):
        a, b = np.asarray(ours), ref.detach().numpy()
        assert a.shape == b.shape, f"{name}: shape {a.shape} vs {b.shape}"
        err = np.abs(a - b)
        frac_tight = float(np.mean(err <= 2e-3))
        assert frac_tight >= 0.95, (
            f"{name}: only {frac_tight:.1%} of elements within 2e-3 of the reference "
            f"(max err {err.max():.3e})")
        assert float(err.max()) <= 0.6, f"{name}: max err {err.max():.3e} looks structural"


@pytest.fixture(scope="module")
def setup_model():
    params = init_dm_nerf(jax.random.PRNGKey(7), ins_num=INS, D=trp.D, W=trp.W,
                          input_ch_pts=trp.CH_PTS, input_ch_views=trp.CH_VIEWS,
                          skips=trp.SKIPS)
    return params, trp._to_torch_model(params)


def test_manipulate_rays_rgb_stub_equivalent(setup_model):
    """rgb_stub=True (pass-1 label-accumulation queries run with rgb_stub_params)
    must be output-IDENTICAL to rgb_stub=False: the stubbed rgb channels are
    never consumed (labels read ins, weights read sigma; the target coarse query
    that feeds tar_rgb stays full). Checked in det AND keyed modes."""
    params, _ = setup_model
    rng = np.random.RandomState(11)
    n = 12
    rays_o = rng.randn(n, 3).astype(np.float32) * 0.1
    rays_d = rng.randn(n, 3).astype(np.float32)
    rays_d[:, 2] = np.abs(rays_d[:, 2]) + 0.5
    tar_o = rays_o + np.array([0.3, 0.0, 0.0], np.float32)
    tar_d = rays_d.copy()

    cfg = Config(netdepth=trp.D, netwidth=trp.W, multires=trp.MULTIRES,
                 multires_views=trp.MULTIRES_VIEWS, skips=trp.SKIPS,
                 N_samples=9, N_importance=8, near=2.0, far=6.0, ins_num=INS)
    q = make_xla_query_fn(trp.MULTIRES, trp.MULTIRES_VIEWS, trp.D, trp.SKIPS)
    import jax

    for key in (None, jax.random.PRNGKey(3)):
        kwargs = dict(query_fn=q, key=key)
        a = manipulate_rays(cfg, params, params,
                            (jnp.asarray(rays_o), jnp.asarray(rays_d)),
                            [(jnp.asarray(tar_o), jnp.asarray(tar_d))],
                            [2], rgb_stub=True, **kwargs)
        b = manipulate_rays(cfg, params, params,
                            (jnp.asarray(rays_o), jnp.asarray(rays_d)),
                            [(jnp.asarray(tar_o), jnp.asarray(tar_d))],
                            [2], rgb_stub=False, **kwargs)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{k} (key={key is not None})")
