"""Multi-host worker: one process of an N-process jax.distributed run (CPU backend).

Launched by tests/test_multihost.py as `python tests/_mh_worker.py <pid> <nprocs>
<coordinator>`. Exercises the same code path train.py:85-88 enables via
cfg.multihost — explicit jax.distributed.initialize, a mesh over the GLOBAL device
set, and one sharded train step (SURVEY.md §5 distributed-backend commitment; the
reference has no distributed code at all, config.py:170-174).

Prints "MH_OK loss=<float>" on success; any failure exits nonzero.
"""

import os
import sys

proc_id, nprocs, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

# a fresh process: force the CPU backend BEFORE jax import, one local device per
# process (no xla_force_host_platform_device_count), so the global mesh is
# [nprocs] with exactly one addressable device here.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
from dmnerf_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

jax.distributed.initialize(coordinator_address=coord, num_processes=nprocs,
                           process_id=proc_id)
assert jax.process_count() == nprocs, (jax.process_count(), nprocs)
assert len(jax.devices()) == nprocs, jax.devices()
assert len(jax.local_devices()) == 1

from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from dmnerf_tpu.configs import Config  # noqa: E402
from dmnerf_tpu.parallel.mesh import Batch, make_mesh, make_sharded_train_step  # noqa: E402
from dmnerf_tpu.render.trainstep import create_train_state  # noqa: E402

N = 8
cfg = Config(N_train=N, N_samples=8, N_importance=8, netdepth=2, netwidth=16,
             multires=2, multires_views=1, near=2.0, far=6.0, ins_num=4,
             perturb=1.0, penalize=True, tolerance=0.05, deta_w=0.05)

mesh = make_mesh()  # global: nprocs devices, one per process
step = make_sharded_train_step(cfg, mesh)

# identical full batch on every process; each contributes its local row shard
rng = np.random.RandomState(0)
rays_d = rng.randn(N, 3).astype(np.float32)
rays_d[:, 2] = np.abs(rays_d[:, 2]) + 1.0
full = dict(
    rays_o=np.zeros((N, 3), np.float32),
    rays_d=rays_d,
    target_c=rng.rand(N, 3).astype(np.float32),
    target_i=rng.randint(0, cfg.ins_num, size=N),
)
data = NamedSharding(mesh, P("data"))
repl = NamedSharding(mesh, P())
lo = proc_id * (N // nprocs)
batch = Batch(**{k: jax.make_array_from_process_local_data(data, v[lo:lo + N // nprocs])
                 for k, v in full.items()})

state = create_train_state(cfg, jax.random.PRNGKey(0))  # identical init on every process
state = jax.tree_util.tree_map(
    lambda x: jax.make_array_from_process_local_data(repl, np.asarray(x)), state)

new_state, aux = step(state, batch, jax.make_array_from_process_local_data(
    repl, np.asarray(jax.random.PRNGKey(1))))
loss = float(np.asarray(aux["total_loss"].addressable_data(0)))
assert np.isfinite(loss), loss
assert int(np.asarray(new_state.step.addressable_data(0))) == 1
print(f"MH_OK loss={loss:.6f}", flush=True)
