"""The flat route's order among exact ties, against the reference's.

The reference picks its top k with ``lax.top_k``, which gives equal
distances to the lowest row first. Here every corpus row is one of a few
distinct (vector, range) rows repeated many times, so each query's k
nearest are exact ties; the port's ``flat_search`` must return the same
ids as the reference's at every position, not only where distances are
distinct. The reference runs its plain path and its Pallas kernel in
interpret mode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.flat import flat_search as ref_flat_search

from repro_torch.core.flat import flat_search

from _flat_cases import tied_corpus


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("mask", [15, 2, 48])
@pytest.mark.parametrize("k", [10, 150])
@pytest.mark.parametrize("seed", [0, 1])
def test_flat_search_orders_exact_ties_as_lax_top_k(seed, k, mask,
                                                    use_kernel):
    arrays = tied_corpus(seed)
    want_i, want_d = ref_flat_search(*map(jnp.asarray, arrays), mask=mask,
                                     k=k, use_kernel=use_kernel)
    want_i, want_d = np.asarray(want_i), np.asarray(want_d)
    got_i, got_d = flat_search(*map(torch.as_tensor, arrays), mask=mask,
                               k=k)
    got_i, got_d = got_i.numpy(), got_d.numpy()
    # the case holds ties: some row's k nearest repeat a distance
    fin = np.isfinite(want_d)
    assert any(len(np.unique(r[f])) < f.sum() for r, f in zip(want_d, fin))
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-4, atol=1e-4)
