"""Frozen, explicit configuration for dmnerf_tpu.

Replaces the reference's mutable ``args`` god-object (configargparse namespace threaded
through every layer and mutated at runtime, /root/reference/config.py:9-143) with an
immutable dataclass. Runtime state that the reference stored on ``args`` (``is_train``,
``N_ins``, ``target_label``) is passed as explicit function arguments instead — mutation
would break jit tracing.

The text config format of the reference (``key = value`` lines plus bare flags,
e.g. /root/reference/configs/train/dmsr/study.txt) is accepted verbatim, including the
released config-file vocabulary drift documented in SURVEY.md §4:
``over_penalize`` == ``penalize``, ``editor_val`` == ``mani_eval``,
``editor_mode`` == ``mani_mode``, ``editor_demo`` == ``mani_demo``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    # experiment / paths  (reference config.py:15-22)
    expname: str = "study"
    basedir: str = "./logs"
    datadir: str = "./data/dmsr/study"
    log_time: Optional[str] = None
    dataset_type: str = "dmsr"  # dmsr | replica | scannet (replaces per-dataset scripts)

    # model  (reference config.py:24-27, defaults config.py:146-159)
    netdepth: int = 8
    netwidth: int = 256
    skips: Tuple[int, ...] = (4,)
    i_embed: int = 0          # 0 = positional encoding, -1 = identity
    multires: int = 10        # xyz frequencies  (config.py:57)
    multires_views: int = 4   # view-dir frequencies  (config.py:59)

    # sampling  (reference config.py:48-53)
    N_samples: int = 64
    N_importance: int = 128
    perturb: float = 1.0

    # training  (reference config.py:29-37, train_dmsr.py:20,68-73)
    N_train: int = 4096
    lrate: float = 5e-4
    lrate_decay: int = 500    # exp decay horizon in thousands of steps
    N_iters: int = 500001
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    seed: int = 0

    # inference / chunking  (reference config.py:36-37)
    N_test: int = 2048
    render_factor: int = 0    # declared for config-vocabulary parity; the
                              # reference declares it (config.py:65) but no
                              # reference code path ever reads it — inert here too

    # dataset options  (reference config.py:74-91)
    testskip: int = 10
    resize: bool = False
    white_bkgd: bool = False
    near: float = 0.0
    far: float = 1.0
    crop_width: Optional[int] = None
    crop_height: Optional[int] = None

    # logging intervals  (reference config.py:93-102)
    i_print: int = 100
    i_img: int = 500
    i_save: int = 10000
    i_test: int = 50000
    i_video: int = 50000

    # object-field / instance options  (reference config.py:104-114)
    ins_num: int = 32          # resolved from the dataset palette at load time
    weakly_mode: str = "weakly_ins"
    weakly_value: float = 1.0
    penalize: bool = False     # reference flag name: over_penalize (config.py:108)
    tolerance: float = 0.0
    deta_w: float = 0.0

    # manipulation  (reference config.py:116-138)
    mani_demo: bool = False
    mani_eval: bool = False
    mani_mode: str = "rotation"   # translation | rotation | scale | multi
    views: int = 720
    target_label: Optional[int] = None

    # mesh extraction (reference hardcodes 256^3 and level 0.45,
    # mesh_generator.py:27-28,69)
    mesh_grid_dim: int = 256
    mesh_level: float = 0.45

    # eval-mode switches  (reference config.py:61-64, 140-142)
    render: bool = False
    render_test: bool = False
    mesh: bool = False
    # ft_path: load weights from an EXPLICIT checkpoint. Accepts a specific
    # checkpoint dir (…/checkpoints/010000 -> loads step 10000, honored exactly),
    # a …/checkpoints dir, or a run log dir (both -> latest step). One meaning in
    # BOTH drivers: train fine-tunes from it, test evaluates it. Missing path or
    # absent checkpoint is a loud error, never a silent init/latest fallback
    # (reference --ft_path names one specific weights file, config.py:42).
    ft_path: Optional[str] = None
    no_reload: bool = False

    # --- additions with no reference counterpart (SURVEY.md §2.2, §5) ---
    # precision: dtype of parameters and matmul operands. float32 matmuls on a
    # GPU may run as TF32 at JAX's default matmul precision; set
    # jax.default_matmul_precision("highest") for full-float32 products.
    # bfloat16 halves parameter/optimizer memory and matmul operand bytes.
    precision: str = "float32"
    data_axis: int = 1           # number of devices on the ray-sharded 'data' mesh axis
    checkpoint_every: int = 10000
    resume: bool = True           # train resume (capability superset; reference never resumes)
    debug_nans: bool = False      # opt-in sanitizer: jax_debug_nans (SURVEY §5; the
                                  # reference left torch detect_anomaly always-on)
    profile_dir: Optional[str] = None  # write a jax.profiler trace of a few train
                                       # steps here (xprof/tensorboard-compatible)
    profile_start: int = 10       # first profiled step (post-compile)
    profile_steps: int = 5        # number of steps in the trace window
    multihost: bool = False       # call jax.distributed.initialize() before mesh
                                  # creation (also via $DMNERF_MULTIHOST=1)
    steps_per_dispatch: int = 1   # >1: the train driver fuses this many
                                  # sample+step iterations into one lax.scan
                                  # dispatch (amortizes per-dispatch host
                                  # overhead).
                                  # RNG stream, prints, checkpoints and eval
                                  # boundaries stay byte-identical to =1 (packs
                                  # containing a save/test boundary fall back to
                                  # single steps). Composes with the multi-chip
                                  # mesh: >1 device runs the scan inside the
                                  # mesh-jitted program (parallel.mesh
                                  # make_packed_sharded_steps).

    def __post_init__(self):
        # The reference ships tolerance/deta_w with default=None (config.py:110-112) and
        # crashes with a TypeError if over_penalize is set without them; a zero deta_w
        # is worse here — exp(-0/0) = NaN silently kills the instance head (the Gaussian
        # has zero width). Fail loudly at config time instead.
        if self.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {self.steps_per_dispatch}")
        if self.penalize and (self.deta_w <= 0.0 or self.tolerance <= 0.0):
            raise ValueError(
                "penalize/over_penalize requires tolerance > 0 and deta_w > 0 "
                f"(got tolerance={self.tolerance}, deta_w={self.deta_w}); the reference "
                "configs set both to 0.05 (configs/train/dmsr/study.txt:18-19)"
            )

    @property
    def log_dir(self) -> str:
        t = self.log_time if self.log_time is not None else "run"
        return os.path.join(self.basedir, self.expname, t)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# config-file key -> dataclass field, covering the reference's released vocabulary drift
# (SURVEY.md §4: over_penalize≡penalize, editor_val≡mani_eval, editor_mode≡mani_mode,
#  editor_demo≡mani_demo).
_ALIASES = {
    "over_penalize": "penalize",
    "editor_val": "mani_eval",
    "editor_mode": "mani_mode",
    "editor_demo": "mani_demo",
}

_FIELDS = {f.name: f for f in dataclasses.fields(Config)}


def _coerce(field: dataclasses.Field, raw: str):
    raw = raw.strip()
    ty = field.type
    if ty.startswith("Optional["):
        if raw.lower() in ("none", ""):
            return None
        ty = ty[len("Optional["):-1]
    if ty == "int":
        return int(raw)
    if ty == "float":
        return float(raw)
    if ty == "bool":
        # the reference used type=bool argparse flags where any string is truthy
        # (config.py:38,133-138); we parse properly.
        return raw.lower() in ("1", "true", "yes", "on")
    if ty.startswith("Tuple"):
        return tuple(int(x) for x in raw.replace(",", " ").split())
    return raw


def parse_config_text(text: str, base: Optional[Config] = None) -> Config:
    """Parse a reference-style ``key = value`` config file into a Config.

    Bare lines (no ``=``) are treated as boolean flags set to True, matching
    configargparse's handling of store_true flags in the reference configs
    (e.g. ``over_penalize`` in configs/train/dmsr/study.txt:16).
    """
    cfg = base if base is not None else Config()
    updates = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        if "=" in line:
            key, raw = line.split("=", 1)
            key = key.strip()
        else:
            key, raw = line, "true"
        key = _ALIASES.get(key, key)
        if key not in _FIELDS:
            # unknown keys are ignored (configargparse parity) but loudly: a typo'd
            # key (n_iters vs N_iters) otherwise silently trains the default 500k
            import difflib
            import warnings

            close = difflib.get_close_matches(key, _FIELDS, n=1)
            hint = f" (did you mean '{close[0]}'?)" if close else ""
            warnings.warn(f"config: ignoring unknown key '{key}'{hint}", stacklevel=2)
            continue
        updates[key] = _coerce(_FIELDS[key], raw)
    return cfg.replace(**updates)


def load_config(path: str, base: Optional[Config] = None, **overrides) -> Config:
    with open(path) as f:
        cfg = parse_config_text(f.read(), base)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def dump_config(cfg: Config, log_dir: str) -> None:
    """Snapshot the resolved config, mirroring the reference's args.txt
    (reference config.py:179-187)."""
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "args.txt"), "w") as f:
        for field in sorted(_FIELDS):
            f.write(f"{field} = {getattr(cfg, field)}\n")
