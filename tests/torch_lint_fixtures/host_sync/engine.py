"""Seeded torch-host-sync positives and negatives (line numbers are
pinned by tests/test_torch_analysis.py)."""

import numpy as np
import torch


class Engine:
    def __init__(self, device):
        self.counts = torch.zeros(8, dtype=torch.int32, device=device)
        self.staging = torch.empty(8, dtype=torch.int32, pin_memory=True)

    def step(self, slots):
        hits = self.counts[slots]
        n = hits.sum().item()  # positive: .item()
        host = hits.cpu()  # positive: .cpu()
        torch.cuda.synchronize()  # positive: device-wide wait
        torch.cuda.current_stream().synchronize()  # positive: stream wait
        done = torch.cuda.Event()
        done.record()
        done.synchronize()  # positive: event wait
        listed = self.counts.tolist()  # positive: tensor .tolist()
        arr = hits.numpy()  # positive: tensor .numpy()
        return n, host, listed, arr

    def host_side(self, rows):
        out = np.asarray(rows, dtype=np.uint32).tolist()  # negative: numpy
        view = self.staging.numpy()  # negative: pinned host tensor
        ids = [r for r in rows]
        return out, view, ids.copy()

    def suppressed(self):
        return self.counts.sum().item()  # tpu-lint: disable=torch-host-sync -- test of the suppression

    def cold(self):
        # negative: not reachable from the request path
        return self.counts.sum().item()
