"""Command-line tools of the port: the gRPC smoke client (``client``)
and the offline config validator (``config_check``), ports of
ratelimit_tpu/cli/."""
