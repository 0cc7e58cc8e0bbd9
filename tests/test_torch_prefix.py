"""The port's per-slot prefix (K2's plain version and its CPU dispatch)
against the JAX package: the sort-based XLA path and the Pallas kernel
in interpreter mode.  Integer arithmetic throughout, so the tolerance
is 0: every element must be equal."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ratelimit_tpu.ops.prefix import per_slot_inclusive_prefix as jax_prefix
from ratelimit_tpu.ops.prefix_pallas import per_slot_inclusive_prefix_pallas
from ratelimit_tpu_torch.ops.prefix import per_slot_inclusive_prefix
from ratelimit_tpu_torch.ops.prefix_cuda import per_slot_inclusive_prefix_cuda


def _inputs(n, max_slot, seed, max_hits=9):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, max_slot, n).astype(np.int32)
    hits = rng.integers(1, max_hits, n).astype(np.uint32)
    return slots, hits


def _port(fn, slots, hits):
    out = fn(torch.from_numpy(slots), torch.from_numpy(hits.view(np.int32)))
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize(
    "n,max_slot", [(8, 3), (100, 7), (128, 5), (512, 2000), (512, 1)]
)
def test_prefix_matches_jax_and_pallas(n, max_slot):
    slots, hits = _inputs(n, max_slot, seed=n + max_slot)
    ref = np.asarray(jax_prefix(jnp.asarray(slots), jnp.asarray(hits)))
    pallas = np.asarray(
        per_slot_inclusive_prefix_pallas(
            jnp.asarray(slots), jnp.asarray(hits), interpret=True
        )
    )
    np.testing.assert_array_equal(ref, pallas)
    np.testing.assert_array_equal(_port(per_slot_inclusive_prefix, slots, hits), ref)
    np.testing.assert_array_equal(
        _port(per_slot_inclusive_prefix_cuda, slots, hits), ref
    )


@pytest.mark.parametrize("n", [8, 128, 512])
def test_prefix_all_same_slot(n):
    slots = np.zeros(n, dtype=np.int32)
    hits = np.full(n, 3, dtype=np.uint32)
    out = _port(per_slot_inclusive_prefix_cuda, slots, hits)
    np.testing.assert_array_equal(out, 3 * np.arange(1, n + 1))
    pallas = per_slot_inclusive_prefix_pallas(
        jnp.asarray(slots), jnp.asarray(hits), interpret=True
    )
    np.testing.assert_array_equal(out, np.asarray(pallas))


def test_prefix_wraps_modulo_u32():
    """Sums past 2^32 wrap, as the reference's u32 cumsum does."""
    slots = np.array([4, 4, 9, 4], dtype=np.int32)
    hits = np.array([0xFFFFFFF0, 0x20, 5, 0xFFFFFFFF], dtype=np.uint32)
    ref = np.asarray(jax_prefix(jnp.asarray(slots), jnp.asarray(hits)))
    np.testing.assert_array_equal(_port(per_slot_inclusive_prefix, slots, hits), ref)


def _running_sum(slots, hits):
    """The Redis INCRBY sequence: each lane's slot total after its own
    hits, in batch order, mod 2^32."""
    run, out = {}, np.empty(len(slots), dtype=np.uint32)
    for i, (s, h) in enumerate(zip(slots.tolist(), hits.tolist())):
        run[s] = (run.get(s, 0) + h) % 2**32
        out[i] = run[s]
    return out


def test_prefix_wraps_inside_a_segment_like_the_pallas_kernel():
    """Slot 2's running sum wraps u32 at its first lane's base.  The port
    gives the true modular running sum, as the Pallas kernel does.  JAX's
    XLA prefix (ratelimit_tpu/ops/prefix.py) gives [0xFFFFFFF0, 0xFFFFFFF0,
    0, 1] here: it takes each segment's base as segment_min of the
    exclusive global cumsum, which is not the segment's first value once
    that cumsum wraps inside the segment."""
    slots = np.array([1, 2, 2, 2], dtype=np.int32)
    hits = np.array([0xFFFFFFF0, 8, 16, 1], dtype=np.uint32)
    want = np.array([0xFFFFFFF0, 8, 0x18, 0x19], dtype=np.uint32)
    np.testing.assert_array_equal(_running_sum(slots, hits), want)
    pallas = np.asarray(
        per_slot_inclusive_prefix_pallas(
            jnp.asarray(slots), jnp.asarray(hits), interpret=True
        )
    )
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(_port(per_slot_inclusive_prefix, slots, hits), want)
    np.testing.assert_array_equal(
        _port(per_slot_inclusive_prefix_cuda, slots, hits), want
    )


# A numpy model of K2's decomposition on the card (csrc/prefix.cu and its
# tile pass, csrc/prefix_tiles.cuh, which the fused general step runs
# too): the lower-triangle tile pairs decoded from a linear block id, the
# j <= i mask on the diagonal tile only, lanes past N staged with hits 0,
# and each lane's non-zero per-tile partials summed mod 2^32 (the
# atomics).

_CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ratelimit_tpu_torch", "csrc"
)
TILE = 128  # kTile in csrc/prefix_tiles.cuh
MAX_BLOCKS = 2048  # kMaxBlocks in csrc/prefix.cu


def _tile_pair(p):
    """tile_pair() of csrc/prefix_tiles.cuh, on int64 arrays or ints:
    p = it * (it + 1) / 2 + jt, from a correctly rounded float64 sqrt."""
    r = ((np.sqrt(8.0 * np.asarray(p, dtype=np.float64) + 1.0) - 1.0) * 0.5).astype(np.int64)
    return r, p - r * (r + 1) // 2


def _tiled_prefix_model(slots, hits, max_blocks):
    n = len(slots)
    tiles = (n + TILE - 1) // TILE
    pairs = tiles * (tiles + 1) // 2
    blocks = min(pairs, max_blocks)
    t = np.arange(TILE)
    out = np.zeros(n, dtype=np.uint64)
    seen = set()
    # Block b walks pairs b, b + blocks, ... (grid-stride past max_blocks).
    for p in (p for b in range(blocks) for p in range(b, pairs, blocks)):
        it, jt = (int(v) for v in _tile_pair(p))
        assert 0 <= jt <= it < tiles and (it, jt) not in seen
        seen.add((it, jt))
        i, j = it * TILE + t, jt * TILE + t
        s_slots = np.where(j < n, slots[np.minimum(j, n - 1)], 0)
        s_hits = np.where(j < n, hits[np.minimum(j, n - 1)], 0).astype(np.uint64)
        mine = np.where(i < n, slots[np.minimum(i, n - 1)], 0)
        mask = s_slots[None, :] == mine[:, None]
        if it == jt:
            mask &= t[None, :] <= t[:, None]
        partial = (mask * s_hits[None, :]).sum(axis=1) % 2**32
        add = (i < n) & (partial != 0)
        out[i[add]] = (out[i[add]] + partial[add]) % 2**32
    assert len(seen) == pairs
    return out.astype(np.uint32)


def test_prefix_model_constants_match_the_kernel_source():
    src = ""
    for name in ("prefix.cu", "prefix_tiles.cuh"):
        with open(os.path.join(_CSRC, name)) as f:
            src += f.read()
    assert re.search(r"constexpr int kTile = (\d+);", src).group(1) == str(TILE)
    assert re.search(r"constexpr long long kMaxBlocks = (\d+);", src).group(1) == str(
        MAX_BLOCKS
    )


@pytest.mark.parametrize("distinct", ["one_slot", "all_distinct"])
@pytest.mark.parametrize(
    "n,max_blocks",
    [(1, MAX_BLOCKS), (127, MAX_BLOCKS), (128, MAX_BLOCKS), (129, MAX_BLOCKS),
     (4097, MAX_BLOCKS), (4097, 100)],
)
def test_prefix_tiled_model_matches_plain(n, max_blocks, distinct):
    rng = np.random.default_rng(n)
    if distinct == "one_slot":
        slots = np.full(n, -7, dtype=np.int32)
    else:
        slots = rng.permutation(n).astype(np.int32) - n // 2
    hits = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hits[rng.random(n) < 0.1] = 0
    want = _port(per_slot_inclusive_prefix, slots, hits)
    np.testing.assert_array_equal(_tiled_prefix_model(slots, hits, max_blocks), want)
    if n <= 129:
        np.testing.assert_array_equal(_running_sum(slots, hits), want)


def test_prefix_tile_pair_decode_at_triangle_edges():
    """Each row's first and last pair, where a rounded sqrt would land in
    the wrong row: every row up to 2^20 tiles, then rows up to the tile
    count of N = 2^31 - 1 lanes (the largest int the launcher takes)."""
    top = (2**31 - 1 + TILE - 1) // TILE
    rows = np.unique(
        np.concatenate(
            [np.arange(1 << 20), np.geomspace(1 << 20, top, 4096).astype(np.int64), [top - 1]]
        )
    )
    first = rows * (rows + 1) // 2
    for p, want_jt in ((first, 0), (first + rows, rows)):
        it, jt = _tile_pair(p)
        np.testing.assert_array_equal(it, rows)
        np.testing.assert_array_equal(jt, want_jt)


def test_prefix_wrapper_validates_inputs():
    slots = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        per_slot_inclusive_prefix_cuda(slots, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        per_slot_inclusive_prefix_cuda(slots, torch.zeros(5, dtype=torch.int32))
