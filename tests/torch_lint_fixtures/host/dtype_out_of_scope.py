"""Host code outside ops/, models/ and parallel/: the dtype rule does
not scan it."""

import torch


def host_only(n):
    t = torch.zeros(n)
    t.index_put_((torch.arange(n),), 1)
    return t
