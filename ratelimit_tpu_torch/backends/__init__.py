"""Counter backends: the torch counter engine, its micro-batching
dispatcher and the CudaRateLimitCache serving seam.  Submodules import
lazily; importing this package loads no kernels."""
