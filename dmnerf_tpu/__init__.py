"""dmnerf_tpu — a JAX/XLA framework for decompose-and-manipulate NeRF scene
understanding, providing the full capability surface of DM-NeRF
(reference: ChenLu-china/DM-NeRF), run on NVIDIA GPUs.

Layer map (mirrors SURVEY.md §1, re-architected):

  core/      pure-jnp math: positional encoding, DM-NeRF MLP (pytree params),
             ray generation, stratified + inverse-CDF samplers, volume compositor,
             coarse→fine render pipeline. All shape-static, jit-able.
  objfield/  the "object field" instance machinery: in-graph Hungarian assignment,
             instance losses, emptiness penalizer, mAP evaluator.
  render/    jitted train step, chunked full-image renderer, manipulator.
  parallel/  jax.sharding Mesh construction, sharded train/eval steps.
  data/      host-side loaders for DM-SR / Replica / ScanNet / DM-SR-manipulation,
             pixel samplers, palettes, synthetic scene generator.
  tools/     mesh extraction (marching cubes), pose generation, visualization.
"""

__version__ = "0.1.0"
