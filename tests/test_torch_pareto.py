"""Parity of the port's Pareto layer with the JAX package's: the dominance
matrix's plain version (against the jnp oracle and the Pallas kernel in
interpret mode), front ranks with and without the early exit, crowding,
survival order and both hypervolumes. Inputs are made with numpy from a
seed and fed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.dominance as ref_dom
from repro.core import pareto as ref_pareto
from repro.core.nsga2 import survival_select as ref_survival_select
from repro.kernels import ref as jref
from repro_torch.core import pareto
from repro_torch.core.nsga2 import survival_select
from repro_torch.kernels import ops, ref

# tests/test_kernels.py's dominance shapes
DOM_SHAPES = [(8, 2), (100, 3), (128, 3), (130, 4), (256, 1), (300, 8)]

# the reference runs jitted at one shape per test family: its eager
# while_loop and lexsort retrace at every call
_ref_nds = jax.jit(ref_pareto.non_dominated_sort, static_argnames=("top",))
_ref_crowding = jax.jit(ref_pareto.crowding_distance)
_ref_survival = jax.jit(ref_survival_select, static_argnums=(1,),
                        static_argnames=("top",))
_ref_hv2d = jax.jit(ref_pareto.hypervolume_2d)


def _objectives(P, M, seed, ties=True):
    """Random objectives with quantised ties and duplicated rows."""
    rng = np.random.default_rng(seed)
    F = rng.random((P, M)).astype(np.float32)
    if ties:
        F = (np.round(F * 8) / 8).astype(np.float32)
    if P > 4:
        F[P // 2] = F[0]
        F[P - 1] = F[1]
    return F


@pytest.mark.parametrize("P,M", DOM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dominance_plain_matches_reference(P, M, dtype):
    F = _objectives(P, M, P * 31 + M)
    Fj = jnp.asarray(F, getattr(jnp, dtype))
    # the same values in torch: bf16 rounding happens once, in JAX
    Ft = torch.from_numpy(np.array(Fj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = ref.dominance_matrix(Ft).numpy()
    want = np.asarray(jref.dominance_matrix(Fj.astype(jnp.float32)))
    pallas = np.asarray(ref_dom.dominance_matrix_pallas(Fj, block=64,
                                                        interpret=True), bool)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(ops.dominance_matrix(Ft).numpy(), want)
    assert not got.diagonal().any()
    np.testing.assert_array_equal(
        ref.dominance_counts(Ft).numpy(),
        np.asarray(jref.dominance_counts(Fj.astype(jnp.float32))))


def test_dominance_plain_nan_row_never_dominates():
    F = _objectives(20, 3, 4)
    F[3, 1] = np.nan
    got = ref.dominance_matrix(torch.from_numpy(F)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jref.dominance_matrix(jnp.asarray(F))))
    assert not got[3].any() and not got[:, 3].any()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("top", [None, "half"])
def test_non_dominated_sort_ranks_exact(seed, top):
    P, M = (61, 2) if seed < 3 else (90, 4)
    F = _objectives(P, M, seed, ties=seed % 2 == 0)
    t = None if top is None else P // 2
    got = pareto.non_dominated_sort(torch.from_numpy(F), top=t).numpy()
    want = np.asarray(_ref_nds(jnp.asarray(F), top=t))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # a precomputed matrix gives the same ranks
    dom = ops.dominance_matrix(torch.from_numpy(F))
    np.testing.assert_array_equal(
        pareto.non_dominated_sort(torch.from_numpy(F), dom, top=t).numpy(),
        want)


@pytest.mark.parametrize("seed", range(6))
def test_crowding_distance_close_with_same_infs(seed):
    P, M = 90, 4
    F = _objectives(P, M, seed, ties=seed % 2 == 1)
    rank = np.array(_ref_nds(jnp.asarray(F), top=P // 2))
    got = pareto.crowding_distance(torch.from_numpy(F),
                                   torch.from_numpy(rank)).numpy()
    want = np.asarray(_ref_crowding(jnp.asarray(F), jnp.asarray(rank)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = ~np.isinf(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


@pytest.mark.parametrize("seed", range(8))
def test_survival_select_indices_exact(seed):
    P = 48
    F = _objectives(2 * P, 3, 200 + seed, ties=seed % 2 == 0)
    sel, rank, crowd = survival_select(torch.from_numpy(F), P, top=P)
    rsel, rrank, rcrowd = _ref_survival(jnp.asarray(F), P, top=P)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(rsel))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(rrank))
    np.testing.assert_allclose(crowd.numpy(), np.asarray(rcrowd), rtol=1e-6)


def test_lexsort_is_stable_like_jnp():
    rng = np.random.default_rng(1)
    primary = rng.integers(0, 4, 200).astype(np.int32)
    secondary = np.where(rng.random(200) < 0.3, -np.inf,
                         np.round(rng.random(200), 1)).astype(np.float32)
    got = pareto.lexsort(torch.from_numpy(secondary),
                         torch.from_numpy(primary)).numpy()
    want = np.asarray(jnp.lexsort((jnp.asarray(secondary),
                                   jnp.asarray(primary))))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_pareto_mask_matches_reference(seed):
    F = _objectives(40, 3, seed)
    np.testing.assert_array_equal(
        pareto.pareto_mask(torch.from_numpy(F)).numpy(),
        np.asarray(ref_pareto.pareto_mask(jnp.asarray(F))))


@pytest.mark.parametrize("seed", range(3))
def test_hypervolume_2d_close(seed):
    rng = np.random.default_rng(seed)
    F = rng.random((30, 2)).astype(np.float32)
    ref_pt = np.array([1.1, 1.2], np.float32)
    got = pareto.hypervolume_2d(torch.from_numpy(F), torch.from_numpy(ref_pt))
    want = _ref_hv2d(jnp.asarray(F), jnp.asarray(ref_pt))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("M", [2, 3])
def test_hypervolume_mc_close_on_same_samples(M):
    rng = np.random.default_rng(M)
    F = rng.random((25, M)).astype(np.float32)
    ref_pt = np.full(M, 1.0, np.float32)
    ideal = np.zeros(M, np.float32)
    key = jax.random.key(7)
    u = np.array(jax.random.uniform(key, (4096, M)))
    got = pareto.hypervolume_mc(torch.from_numpy(F), torch.from_numpy(ref_pt),
                                torch.from_numpy(ideal),
                                samples=torch.from_numpy(u))
    want = ref_pareto.hypervolume_mc(jnp.asarray(F), jnp.asarray(ref_pt),
                                     jnp.asarray(ideal), key, n_samples=4096)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # drawn from a generator, the estimate is of the same volume
    g = torch.Generator().manual_seed(0)
    est = pareto.hypervolume_mc(torch.from_numpy(F), torch.from_numpy(ref_pt),
                                torch.from_numpy(ideal), generator=g,
                                n_samples=4096)
    assert abs(float(est) - float(want)) < 0.05
