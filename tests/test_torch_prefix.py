"""The port's per-slot prefix (K2's plain version and its CPU dispatch)
against the JAX package: the sort-based XLA path and the Pallas kernel
in interpreter mode.  Integer arithmetic throughout, so the tolerance
is 0: every element must be equal."""

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


def test_prefix_wrapper_validates_inputs():
    slots = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        per_slot_inclusive_prefix_cuda(slots, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        per_slot_inclusive_prefix_cuda(slots, torch.zeros(5, dtype=torch.int32))
