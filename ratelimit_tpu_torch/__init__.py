"""tpu-ratelimit on PyTorch and CUDA: the rate-limit decision service
of ``ratelimit_tpu`` ported to one NVIDIA H100.

The JAX package ``ratelimit_tpu`` stays beside this one as the
reference; this package imports neither it nor jax.  Module names
mirror the reference so each counterpart is easy to find.  Device work
runs as hand-written CUDA kernels (``csrc/``, built by ``kernels.py``);
every kernel keeps a plain PyTorch version beside it, which runs only
for tensors on the CPU.

Layering (as in the reference):

- ``api``       -- the rls.proto data model.
- ``utils``     -- time source, unit->divider, reset math.
- ``config``    -- YAML -> descriptor-trie limit config.
- ``limiter``   -- cache keys, threshold state machine, local cache,
                   descriptor-resolution cache.
- ``ops``       -- the per-slot prefix (plain version + CUDA kernel).
- ``models``    -- the fixed-window, sliding-window and GCRA models
                   (CUDA kernels) and the algorithm registry.
- ``backends``  -- counter engine, dispatcher, ``CudaRateLimitCache``.
- ``service``   -- ShouldRateLimit service logic.
- ``server``    -- gRPC + health serving surfaces.
- ``stats``     -- counter tree + statsd export.

Entry points default to ``device="cuda"``; only an explicit
``device="cpu"`` runs on the CPU.  Run the server with
``python -m ratelimit_tpu_torch.runner`` (``BACKEND_TYPE=cuda``).
"""

__version__ = "0.1.0"
