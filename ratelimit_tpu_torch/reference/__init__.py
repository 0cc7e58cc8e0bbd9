"""Plain references of the service's semantics, written from the
upstream project's documentation and imported by nothing on the serving
path: the benchmark and the tests hold the port to them."""
