"""The port's Hungarian matcher (``models/hungarian.py``) against the JAX
package's (``omnihd_scenes_tpu/models/hungarian.py``, ``solver='scipy'``)
on the CPU:

* the focal and L1 costs within 1e-6 of max|ref|, and the masked cost with
  its NaN / inf replacements;
* the matches and positive masks equal to JAX's on random problems, with
  padded GTs, with every GT padded, with more GTs than queries, and with
  NaN and inf logits;
* the batched form (samples x decoder layers in one call, one host round
  trip) equal to one call per problem, and the matches' cost optimal.
"""

import numpy as np
import pytest
import torch

import jax

from omnihd_scenes_tpu.models import hungarian as jax_hm
from omnihd_scenes_tpu_torch.models import hungarian

torch.set_num_threads(1)
COST_TOL = 1e-6


def t(x):
    return torch.from_numpy(np.asarray(x))


def problem(rng, nq=30, ng=8, n_valid=5, c=4):
    cls = rng.randn(nq, c).astype(np.float32) * 2
    box = rng.randn(nq, 10).astype(np.float32)
    codes = rng.randn(ng, 10).astype(np.float32)
    labels = rng.randint(0, c, ng).astype(np.int32)
    mask = np.zeros(ng, bool)
    mask[:n_valid] = True
    return cls, box, codes, labels, mask


def jax_match(cls, box, codes, labels, mask):
    m, pos = jax_hm.hungarian_match(cls, box, codes, labels, mask,
                                    solver='scipy')
    return np.asarray(m), np.asarray(pos)


def assert_close(got, want, tol=COST_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def test_costs_match_jax():
    rng = np.random.RandomState(0)
    cls, box, codes, labels, mask = problem(rng)
    fc = jax.jit(jax_hm.focal_cost)(cls, labels)
    assert_close(hungarian.focal_cost(t(cls), t(labels)), fc)
    lc = jax.jit(jax_hm.bbox_l1_cost)(box, codes)
    assert_close(hungarian.bbox_l1_cost(t(box), t(codes)), lc)
    got = hungarian.match_cost(t(cls), t(box), t(codes), t(labels), t(mask))
    want = np.where(mask[None], np.asarray(fc) + np.asarray(lc), 1e8)
    assert_close(got, want)


def test_labels_index_as_jax_does():
    """A negative label counts from the end, as JAX's indexing has it
    (padded slots may carry one)."""
    rng = np.random.RandomState(1)
    cls = rng.randn(6, 4).astype(np.float32)
    labels = np.array([-1, 3, 0, -4], np.int32)
    assert_close(hungarian.focal_cost(t(cls), t(labels)),
                 jax.jit(jax_hm.focal_cost)(cls, labels))


@pytest.mark.parametrize('nq,ng,n_valid', [
    (30, 8, 5), (30, 8, 8), (30, 8, 0), (6, 9, 9), (6, 9, 4), (50, 1, 1)])
def test_matches_equal_jax(nq, ng, n_valid):
    rng = np.random.RandomState(nq * 100 + ng * 10 + n_valid)
    for _ in range(4):
        args = problem(rng, nq, ng, n_valid)
        matched, pos = hungarian.hungarian_match(*map(t, args))
        want_m, want_pos = jax_match(*args)
        np.testing.assert_array_equal(matched.numpy(), want_m)
        np.testing.assert_array_equal(pos.numpy(), want_pos)
        assert (matched.numpy()[~args[4]] == -1).all()
        assert int(pos.sum()) == min(n_valid, nq)


@pytest.mark.parametrize('bad', [np.nan, np.inf, -np.inf])
def test_non_finite_logits_match_jax(bad):
    rng = np.random.RandomState(7)
    cls, box, codes, labels, mask = problem(rng)
    cls[rng.uniform(size=cls.shape) < 0.2] = bad
    box[3, 1] = bad
    matched, pos = hungarian.hungarian_match(*map(t, (cls, box, codes,
                                                      labels, mask)))
    want_m, want_pos = jax_match(cls, box, codes, labels, mask)
    np.testing.assert_array_equal(matched.numpy(), want_m)
    np.testing.assert_array_equal(pos.numpy(), want_pos)


def test_batched_equals_one_call_per_problem():
    """Samples x layers in one call: each problem's matches are those of
    its own call, and each is an optimal assignment of its cost."""
    from scipy.optimize import linear_sum_assignment

    rng = np.random.RandomState(11)
    b, n_layers, nq, ng = 3, 4, 20, 7
    probs = [[problem(rng, nq, ng, n_valid=1 + (i + j) % ng)
              for j in range(n_layers)] for i in range(b)]
    stacked = [np.stack([np.stack([p[k] for p in row]) for row in probs])
               for k in range(5)]
    matched, pos = hungarian.hungarian_match(*map(t, stacked))
    assert matched.shape == (b, n_layers, ng) and pos.shape == (b, n_layers,
                                                               nq)
    for i in range(b):
        for j in range(n_layers):
            one_m, one_pos = hungarian.hungarian_match(*map(t, probs[i][j]))
            np.testing.assert_array_equal(matched[i, j].numpy(),
                                          one_m.numpy())
            np.testing.assert_array_equal(pos[i, j].numpy(), one_pos.numpy())
            cost = hungarian.match_cost(*map(t, probs[i][j])).numpy()
            row, col = linear_sum_assignment(cost)
            got = matched[i, j].numpy()
            valid = probs[i][j][4]
            assert np.isclose(cost[got[valid], np.flatnonzero(valid)].sum(),
                              cost[row, col][valid[col]].sum(), rtol=1e-6)


def test_one_host_copy_per_call(monkeypatch):
    """The batched call solves every problem from one host array."""
    calls = []
    solve = hungarian.solve_host
    monkeypatch.setattr(hungarian, 'solve_host',
                        lambda c: calls.append(c.shape) or solve(c))
    rng = np.random.RandomState(12)
    args = [np.stack([np.stack([a] * 6)] * 2)
            for a in problem(rng, 40, 10, 6)]
    hungarian.hungarian_match(*map(t, args))
    assert calls == [(2, 6, 40, 10)]
