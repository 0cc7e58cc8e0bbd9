"""Seeded torch-dtype-discipline positives and negatives (in ops/, so
in the rule's scope; line numbers are pinned by
tests/test_torch_analysis.py)."""

import torch


def factories(n, device, kw):
    a = torch.zeros(n, device=device)  # positive
    b = torch.arange(n)  # positive
    c = torch.full((n,), 7)  # positive
    d = torch.tensor([1, 2])  # positive
    e = torch.empty(n, device=device)  # positive
    f = torch.zeros(n, dtype=torch.int32, device=device)  # negative
    g = torch.arange(n, dtype=torch.int64, device=device)  # negative
    h = torch.empty(n, **kw)  # negative: the dtype may be in kw
    return a, b, c, d, e, f, g, h


def scatters(table, idx, src):
    table.index_put_((idx,), 1)  # positive
    table.index_add_(0, idx, 1)  # positive
    table.scatter_(0, idx, -1)  # positive
    table.scatter_(0, idx, value=2.5)  # positive
    table.scatter_add_(0, idx, src)  # negative: a tensor
    table.index_put_((idx,), torch.ones_like(idx, dtype=table.dtype))  # negative
    table.index_add_(0, idx, src, alpha=2)  # negative: alpha is no value
    return table
