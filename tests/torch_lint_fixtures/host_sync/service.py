"""The request-path root reaching the engine through a typed
attribute (the hot-path roots are found by name)."""

from .engine import Engine


class Service:
    def __init__(self, device):
        self.engine = Engine(device)

    def should_rate_limit(self, slots):
        a = self.engine.step(slots)
        b = self.engine.host_side(slots)
        c = self.engine.suppressed()
        return a, b, c
