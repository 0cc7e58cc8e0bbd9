"""One process of closed-loop gRPC clients (a thread a client, a channel
a thread), started by drivers/grpc_closed_loop.py.

    python3 grpc_client.py '<json parameters>'

Reads its orders from standard input, one a line: ``port <n>`` (connect
and send each thread's first ``warm_rpcs`` requests, then print
``ready``), ``start <unix seconds>`` (every thread starts sending then,
its next request when the last one's answer is in), ``stop`` (each
thread stops after its answer in flight).  Then prints one JSON line:
for every request sent, its address id, send and reply times (unix
seconds), latency (microseconds), overall code, the descriptor's code and
remaining limit, and whether it failed.

A thread's addresses are drawn from the seed, the process and the
thread (keyspace.KeySpace, the configuration's law), in a fixed order.

The client mechanism (clients in processes of their own, a channel a
thread, closed loop) is copied from the program's
scripts/torch_lanes_throughput.py; its traffic (4096 keys under a rule no
request reaches) is replaced.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

from keyspace import KeySpace  # noqa: E402


def main() -> None:
    import grpc

    from ratelimit_tpu_torch.server import pb  # noqa: F401  (puts the protos on the path)

    from envoy.service.ratelimit.v3 import rls_pb2

    p = json.loads(sys.argv[1])
    seed, proc, threads = int(p["seed"]), int(p["proc"]), int(p["threads"])
    space = KeySpace(p["keys"], p["domain"], p["descriptor_key"], seed)
    draws = []
    for t in range(threads):
        rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 3, proc, t])
        draws.append(space.draw(rng, int(p["draws_per_thread"])).tolist())
    requests = {}

    def request(i):
        r = requests.get(i)
        if r is None:
            r = rls_pb2.RateLimitRequest(domain=p["domain"])
            e = r.descriptors.add().entries.add()
            e.key, e.value = p["descriptor_key"], space.addresses[i]
            requests[i] = r
        return r

    port = int(sys.stdin.readline().split()[1])
    channels = [grpc.insecure_channel(f"127.0.0.1:{port}") for _ in range(threads)]
    calls = [
        ch.unary_unary(
            "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit",
            request_serializer=rls_pb2.RateLimitRequest.SerializeToString,
            response_deserializer=rls_pb2.RateLimitResponse.FromString,
        )
        for ch in channels
    ]
    cols = ("id", "t_send", "t_recv", "lat_us", "overall", "code", "remaining", "err")
    logs = [{c: [] for c in cols} for _ in range(threads)]
    cursor = [0] * threads
    stop = threading.Event()
    deadline = float(p["deadline_s"])

    def one(t):
        ids = draws[t]
        i = ids[cursor[t] % len(ids)]
        cursor[t] += 1
        log = logs[t]
        ts = time.time()
        t0 = time.perf_counter()
        try:
            resp = calls[t](request(i), timeout=deadline)
            err, overall = 0, int(resp.overall_code)
            st = resp.statuses[0] if len(resp.statuses) else None
            code = int(st.code) if st is not None else 0
            rem = int(st.limit_remaining) if st is not None else -1
        except grpc.RpcError:
            err, overall, code, rem = 1, 0, 0, -1
        t1 = time.perf_counter()
        for c, v in zip(cols, (i, ts, time.time(), (t1 - t0) * 1e6, overall, code, rem, err)):
            log[c].append(v)

    for t in range(threads):
        for _ in range(int(p["warm_rpcs"])):
            one(t)
    print("ready", flush=True)
    start = float(sys.stdin.readline().split()[1])

    def worker(t):
        time.sleep(max(0.0, start - time.time()))
        while not stop.is_set():
            one(t)

    workers = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for w in workers:
        w.start()
    sys.stdin.readline()  # "stop"
    stop.set()
    for w in workers:
        w.join()
    for ch in channels:
        ch.close()
    print(json.dumps({c: sum((log[c] for log in logs), []) for c in cols}), flush=True)


if __name__ == "__main__":
    main()
