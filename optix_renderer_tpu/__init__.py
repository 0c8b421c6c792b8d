"""optix_renderer_tpu — a differentiable, physically-based rendering framework
in JAX, run on an NVIDIA H100 through XLA.

Re-implements the capabilities of the Nori/OptiX hybrid path tracer surveyed in
SURVEY.md as pure-functional sharded computation:

- scene descriptions (XML, same tag grammar as reference `src/utils/parser.cpp:61-130`)
  compile to flat struct-of-arrays pytrees (the tagged-union data model the reference
  itself uses for its GPU lowering, `cuda_shared/BsdfData.h` etc.);
- intersection / shading / sampling run as batched XLA ops over
  ray wavefronts instead of per-pixel C++ virtual calls;
- tile & sample parallelism via `shard_map` over a `jax.sharding.Mesh` with psum
  reductions (replaces TBB threads + CUDA streams, reference `src/utils/render.cpp`);
- end-to-end differentiability w.r.t. material/emitter/texture parameters.
"""

__version__ = "0.1.0"

from optix_renderer_tpu.core import math as core_math  # noqa: F401
