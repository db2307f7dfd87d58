"""What ties the program to its hardware and installation: the compile-cache
placement, the benchmark's peak table, chip_smoke.py's control flow on a machine
without a GPU, the numpy checkpoint format, and that no code targets another
accelerator."""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from dmnerf_tpu.configs import Config  # noqa: E402
from dmnerf_tpu.utils import cache  # noqa: E402


def _python(code: str, env: dict, timeout: float = 120) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", **env}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


# ---------------------------------------------------------------- compile cache

_SHOW_CACHE = ("import jax; from dmnerf_tpu.utils.cache import enable_persistent_cache;"
               "p = enable_persistent_cache(); print(p); "
               "print(jax.config.jax_compilation_cache_dir)")


def test_cache_lands_in_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that is where the cache goes and the
    code sets no directory of its own."""
    d = str(tmp_path / "cc")
    out = _python(_SHOW_CACHE, {"JAX_COMPILATION_CACHE_DIR": d})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [d, d]


def test_cache_defaults_to_repo_dir():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    out = subprocess.run([sys.executable, "-c", _SHOW_CACHE], cwd=REPO,
                         env={**env, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = os.path.join(REPO, ".jax_cache")
    assert out.stdout.split() == [want, want]


def test_cache_path_is_fixed(monkeypatch):
    """The path is part of the cache key: no pid, time or random part."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == cache.REPO_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert str(os.getpid()) not in cache.cache_dir()
    assert not re.search(r"\d{6,}", cache.cache_dir())


# ---------------------------------------------------------------- bench peaks

def test_bench_peak_table_has_h100():
    peak = bench.peak_for("NVIDIA H100 80GB HBM3")
    assert peak == {"bf16_flops": 989e12, "tf32_flops": 495e12, "hbm_bytes_per_s": 3.35e12}


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100-SXM4-80GB"])
def test_bench_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no published peak"):
        bench.peak_for(kind)


def test_bench_analytic_flops_flagship():
    """3.28 TFLOP per flagship train step (3072 rays, 64+128 samples, ins_num 32)."""
    f = bench.analytic_matmul_flops(bench._make_cfg("float32"))
    assert f["train_flops"] == 3 * f["fwd_flops"]
    assert round(f["train_flops"] / 1e9, 1) == 3283.8


# ---------------------------------------------------------------- chip_smoke.py

def test_chip_smoke_fails_without_gpu(tmp_path):
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                          "--workdir", str(tmp_path / "w")], cwd=REPO,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "[smoke] FAIL device" in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env={**env, "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("four_cards, phases", [
    (True, ["four_cards"]),
    (False, ["device", "scene", "train", "resume", "reference", "render", "mani_eval",
             "mesh"]),
])
def test_chip_smoke_plan(four_cards, phases):
    assert chip_smoke.plan(four_cards) == phases


def test_chip_smoke_final_line():
    line = chip_smoke.final_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                                  "count": 1, "card": "NVIDIA H100 80GB HBM3, 700.00 W"})
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


_LOG = """[train] something
[TRAIN] Iter: 0 F_PSNR: 10.700 C_PSNR: 10.707 Total: 5.0737 RGB: {r0} Ins: {i0} Reg: 1.3140 rays/s: 1,234
[TRAIN] Iter: 100 F_PSNR: 20.100 C_PSNR: 19.900 Total: 3.0000 RGB: {r1} Ins: {i1} Reg: 0.9000 rays/s: 61,440
"""


@pytest.mark.parametrize("r0, i0, r1, i1, ok", [
    ("0.1700", "3.5897", "0.0200", "2.1000", True),
    ("0.1700", "3.5897", "0.1800", "2.1000", False),   # RGB rose
    ("0.1700", "nan", "0.0200", "2.1000", False),      # Ins not finite
])
def test_chip_smoke_train_log_checks(r0, i0, r1, i1, ok):
    rows = chip_smoke.parse_train_log(_LOG.format(r0=r0, i0=i0, r1=r1, i1=i1))
    assert [r["iter"] for r in rows] == [0, 100]
    assert rows[1]["rays_per_s"] == 61440.0
    if ok:
        chip_smoke.check_losses_fall(rows)
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.check_losses_fall(rows)


def test_chip_smoke_mesh_comparison_on_virtual_devices():
    """The --four-cards comparison code on 4 virtual CPU devices at a tiny width."""
    cfg = Config(netdepth=2, netwidth=32, multires=4, multires_views=2, skips=(0,),
                 N_samples=8, N_importance=8, N_train=32, N_test=64, near=2.0, far=12.0,
                 ins_num=4, perturb=1.0, penalize=True, tolerance=0.05, deta_w=0.05)
    res = chip_smoke.compare_mesh_paths(cfg, jax.devices("cpu")[:4], render_hw=12,
                                        grid_dim=8)
    assert res["train"]["pass"] and res["render"]["pass"] and res["sigma"]["pass"], res
    assert res["render"]["rays"] == 144 and res["sigma"]["points"] == 512


def test_chip_smoke_precision_comparison_shapes():
    cfg = Config(netdepth=2, netwidth=32, multires=4, multires_views=2, skips=(0,),
                 N_samples=8, N_importance=8, near=2.0, far=7.0, ins_num=4,
                 perturb=1.0, penalize=True, tolerance=0.05, deta_w=0.05)
    res = chip_smoke.compare_precisions(cfg, 16, jax.devices("cpu")[0])
    assert set(res) == {"default", "highest"}
    assert res["highest"]["query"].shape == (16, 16, 3 + 1 + 4 + 1)
    # the CPU backend computes float32 products in full at either setting
    assert chip_smoke.max_rel(res["default"]["query"], res["highest"]["query"]) == 0.0
    assert chip_smoke.worst_leaf(res["default"]["grads"], res["highest"]["grads"])[0] == 0.0
    assert chip_smoke.rel_l2(res["default"]["grads"], res["highest"]["grads"]) == 0.0


# ---------------------------------------------------------------- device info

def test_require_gpu_raises_on_cpu():
    from dmnerf_tpu.utils.device_info import device_summary, require_gpu

    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()
    assert device_summary()["platform"] == jax.devices()[0].platform


def test_graft_dryrun_needs_enough_devices():
    import __graft_entry__

    with pytest.raises(RuntimeError, match="needs 64 devices"):
        __graft_entry__.dryrun_multichip(64)


# ---------------------------------------------------------------- checkpoints

def _state(width=16, ins_num=4):
    from dmnerf_tpu.render.trainstep import create_train_state

    cfg = Config(netdepth=2, netwidth=width, multires=2, multires_views=1, skips=(0,),
                 ins_num=ins_num)
    return create_train_state(cfg, jax.random.PRNGKey(0))


def test_checkpoint_npz_round_trip(tmp_path):
    from dmnerf_tpu.utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint

    state = _state()
    state = state._replace(step=jnp.asarray(7, jnp.int32),
                           params_fine=jax.tree_util.tree_map(lambda x: x + 1.0,
                                                              state.params_fine))
    path = save_checkpoint(str(tmp_path), state)
    assert os.path.isfile(os.path.join(path, "state.npz"))
    assert latest_step(str(tmp_path)) == 7
    got = restore_checkpoint(str(tmp_path), _state())
    assert int(got.step) == 7
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kw", [{"width": 32}, {"ins_num": 6}])
def test_checkpoint_incompatible_structure_raises(tmp_path, kw):
    from dmnerf_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint

    save_checkpoint(str(tmp_path), _state())
    with pytest.raises(ValueError, match="incompatible"):
        restore_checkpoint(str(tmp_path), _state(**kw))


def test_checkpoint_incomplete_step_dir_is_ignored(tmp_path):
    """A step directory without state.npz (a save cut short) is not a checkpoint."""
    from dmnerf_tpu.utils.checkpoint import latest_step, save_checkpoint

    save_checkpoint(str(tmp_path), _state())
    os.makedirs(os.path.join(str(tmp_path), "checkpoints", "000009"))
    assert latest_step(str(tmp_path)) == 0


@pytest.mark.parametrize("name", ["7", "000007"])
def test_resolve_ckpt_path_padded_and_unpadded(tmp_path, name):
    from dmnerf_tpu.utils.checkpoint import resolve_ckpt_path, restore_from_path, save_checkpoint

    state = _state()._replace(step=jnp.asarray(7, jnp.int32))
    save_checkpoint(str(tmp_path), state)
    p = os.path.join(str(tmp_path), "checkpoints", name)
    assert resolve_ckpt_path(p) == (os.path.normpath(str(tmp_path)), 7)
    assert int(restore_from_path(p, _state()).step) == 7


# ---------------------------------------------------------------- one accelerator

def _package_sources():
    root = os.path.join(REPO, "dmnerf_tpu")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_the_mosaic_tensor_core_backend():
    """No module imports Pallas's backend for the other accelerator (the
    `pallas.[t]pu` module, conventionally imported as `plt[p]u`)."""
    pat = re.compile(r"pallas\s+import\s+[t]pu|pallas\.[t]pu|plt[p]u")
    hits = [p for p in _package_sources() if pat.search(open(p).read())]
    assert hits == []


def test_no_branch_on_another_platform():
    """No code compares the platform against the other accelerator's name."""
    pat = re.compile(r"""==\s*["'][t]pu["']|["'][t]pu["']\s*==""")
    files = list(_package_sources()) + [os.path.join(REPO, f) for f in
                                        ("bench.py", "chip_smoke.py", "__graft_entry__.py")]
    hits = [p for p in files if pat.search(open(p).read())]
    assert hits == []


def test_eval_assignment_without_cpu_backend(monkeypatch):
    """objfield.metrics runs its tiny assignment on the CPU backend where one is
    registered, and on the default device where none is (JAX_PLATFORMS=cuda)."""
    from dmnerf_tpu.objfield import metrics

    cost = np.asarray([[3.0, 1.0, 2.0], [1.0, 5.0, 4.0]], np.float32)
    want = metrics._lsa_rect(cost)

    def no_cpu(*a, backend=None, **k):
        raise RuntimeError("Unknown backend cpu")

    monkeypatch.setattr(jax, "local_devices", no_cpu)
    np.testing.assert_array_equal(metrics._lsa_rect(cost), want)
    np.testing.assert_array_equal(want, [1, 0])
