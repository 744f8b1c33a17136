"""pg2024_dprt_tpu_torch — the PyTorch/CUDA port of `pg2024_dprt_tpu`.

A second package beside the JAX one, for one NVIDIA H100. It mirrors the
JAX package's layout so that each module has its counterpart under the same
name:

  core/    — SoA path state, bit-exact TEA/LCG RNG, camera, math
  scene/   — meshes, BVH build, cluster tables, textures, lights,
             procedural scenes
  ops/     — the resident closest-hit / any-hit trace and the fused
             whole-sample frame (hand-written CUDA kernels in csrc/, plain
             PyTorch versions beside them)
  render/  — the frame: the fused path (one kernel launch) and the composed
             wavefront path (camera paths, trace, shade + NEE, shadow trace,
             accumulation)
  utils/   — EXR IO, the per-frame device profile

The package imports torch and never JAX or the JAX package. Entry points put
tensors on CUDA unless the caller passes device="cpu"; without CUDA and
without an explicit device they raise.
"""

__version__ = "0.1.0"
