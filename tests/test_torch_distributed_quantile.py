"""The port's sharded weighted quantile (``utils/quantile.py``) across 4
gloo ranks on the CPU: the eight cases of the JAX package's mesh-quantile
tests.  Six of those fail on the JAX package's own sharded path in every
run, so it is no oracle: the port's sharded result is held bit for bit to
its exact local kernel on dyadic weights (the contract: bit-identical
whenever the weight sums are exactly representable) and to the JAX
package's LOCAL ``weighted_quantile``.  The column is never gathered: a
rank sends O(bins) bytes per round, not its rows."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worker as mw
from spark_ensemble_tpu.utils import quantile as jq
from spark_ensemble_tpu_torch.utils import quantile as tq

CASES = mw.quantile_cases()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("quantile")
    try:
        mw.free_port()
    except OSError as e:  # the sandbox forbids loopback sockets
        pytest.skip(f"no loopback sockets: {e}")
    mw.spawn("quantile", str(out), timeout=300)
    return [dict(np.load(os.path.join(out, f"quantile_r{r}.npz"))) for r in range(mw.W)]


def _exact(name):
    v, w, q = CASES[name]
    if name == "nan":  # the zero-weight NaN dropped, as the JAX test does
        v, w = np.delete(v, 17), np.delete(w, 17)
    vt, wt = torch.from_numpy(v), torch.from_numpy(w)
    if q is None:
        return (tq.weighted_median(vt, wt).numpy(),
                np.asarray(jq.weighted_median(jnp.asarray(v), jnp.asarray(w))))
    return (tq.weighted_quantile(vt, torch.from_numpy(q), wt).numpy(),
            np.asarray(jq.weighted_quantile(jnp.asarray(v), jnp.asarray(q), jnp.asarray(w))))


@pytest.mark.parametrize("name", ["exact_0", "exact_1"])
def test_sharded_quantile_matches_exact_kernel(runs, name):
    port, jax_local = _exact(name)
    for r in range(mw.W):
        np.testing.assert_array_equal(runs[r][name], port)
    np.testing.assert_array_equal(port, jax_local)


def test_sharded_median_matches_exact_kernel(runs):
    port, jax_local = _exact("median")
    assert runs[0]["median"] == port == jax_local


def test_sharded_quantile_vector_q(runs):
    port, jax_local = _exact("vector_q")
    np.testing.assert_array_equal(runs[0]["vector_q"], port)
    np.testing.assert_array_equal(port, jax_local)


def test_sharded_quantile_never_gathers_the_column(runs):
    """A rank sends 4 rounds of 256 f32 bins plus the total, never its
    1024 rows (4096 bytes) more than once: the bytes it gathers stay
    O(bins), whatever n is."""
    port, _ = _exact("column")
    assert runs[0]["column"] == port
    assert int(runs[0]["column_bytes"]) == 4 * 256 * 4 + 4


def test_one_rank_axis_equals_four_ranks(runs):
    """The walk over one rank holding the whole column and over four ranks
    holding a block each land on the same exact values (the JAX package's
    two histogram paths agree; the port's one path at two rank counts)."""
    port, jax_local = _exact("one_rank")
    for r in range(mw.W):
        np.testing.assert_array_equal(runs[r]["one_rank"], port)
    np.testing.assert_array_equal(port, jax_local)


def test_zero_weight_nan_does_not_poison(runs):
    port, jax_local = _exact("nan")
    assert runs[0]["nan"] == port == jax_local


def test_target_above_total_degrades_to_max(runs):
    for r in range(mw.W):
        assert float(runs[r]["above_total"]) == 64.0


def test_zero_weight_values_not_selected(runs):
    port, jax_local = _exact("zero_weight_min")
    assert runs[0]["zero_weight_min"] == port == jax_local == 1.0
