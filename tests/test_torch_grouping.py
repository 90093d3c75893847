"""The port's grouping ops (`sp_gan_tpu_torch/ops/grouping.py`) against the
JAX package's on the CPU: indices and label counts exactly, grouped
coordinates and features within 2e-4. Radius tests check that every
query-to-point squared distance lies at least 1e-5 from r^2 (f64) on
inputs uniform in [-1, 1]^3, whose f32 distances round by under 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_gan_tpu.ops import grouping as jg
from sp_gan_tpu_torch.ops import grouping as pg

torch.set_num_threads(2)   # six test workers share the host's cores

TOL = 2e-4


def uniform(seed, *shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape) \
        .astype(np.float32)


def both(a):
    return jnp.asarray(a), torch.from_numpy(a)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


class TestKnnQuery:
    @pytest.mark.parametrize("k,queries", [(1, None), (8, None), (8, 24),
                                           (16, 64)])
    def test_indices_equal(self, k, queries):
        x = uniform(k, 2, 128, 3)
        q = None if queries is None else uniform(queries, 2, queries, 3)
        jx, tx = both(x)
        jq, tq = (None, None) if q is None else both(q)
        ji, jd = jg.knn_query(k, jx, jq)
        ti, td = pg.knn_query(k, tx, tq)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=TOL)
        if q is None:                      # the query itself comes first
            assert (ti[..., 0] == torch.arange(128)).all()

    def test_group_points(self):
        x = uniform(1, 2, 30, 6)
        idx = np.random.default_rng(2).integers(0, 30, (2, 9, 4)) \
            .astype(np.int32)
        want = jg.group_points(jnp.asarray(x), jnp.asarray(idx))
        got = pg.group_points(torch.from_numpy(x), torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestQueryAndGroup:
    @pytest.mark.parametrize("with_feats,use_xyz,queries", [
        (True, True, None), (True, False, None), (False, True, None),
        (True, True, 20)])
    def test_equal(self, with_feats, use_xyz, queries):
        x, f = uniform(3, 2, 96, 3), uniform(4, 2, 96, 5)
        q = None if queries is None else uniform(5, 2, queries, 3)
        jx, tx = both(x)
        jf, tf = both(f) if with_feats else (None, None)
        jq, tq = (None, None) if q is None else both(q)
        want = jg.query_and_group(jx, jf, 6, jq, use_xyz)
        got = pg.query_and_group(tx, tf, 6, tq, use_xyz)
        assert got.shape == want.shape
        close(got, want)

    def test_xyz_groups_not_recentred(self):
        jx, tx = both(uniform(6, 2, 64, 3))
        close(pg.query_and_group_xyz(tx, 5), jg.query_and_group_xyz(jx, 5))


class TestFeatureDistribute:
    @pytest.mark.parametrize("copies", [False, True])
    def test_nearest_and_gather(self, copies):
        m = uniform(7, 2, 16, 3)
        x = m[:, [3, 1, 7, 0, 3]] if copies else uniform(8, 2, 40, 3)
        (jm, tm), (jx, tx) = both(m), both(x)
        want = np.asarray(jg.feature_distribute(jm, jx))
        got = pg.feature_distribute(tm, tx)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        f = uniform(9, 2, 16, 4)
        np.testing.assert_array_equal(
            pg.feature_gather(torch.from_numpy(f), got).numpy(),
            np.asarray(jg.feature_gather(jnp.asarray(f), jnp.asarray(want))))


class TestLabelStat:
    @pytest.mark.parametrize("n_classes", [2, 5])
    def test_knn_histogram(self, n_classes):
        x = uniform(10, 2, 64, 3)
        labels = np.random.default_rng(11).integers(
            -1, n_classes + 1, (2, 64)).astype(np.int32)   # some outside
        idx = np.asarray(jg.knn_query(6, jnp.asarray(x))[0])
        want = np.asarray(jg.label_stat(jnp.asarray(labels),
                                        jnp.asarray(idx), n_classes))
        got = pg.label_stat(torch.from_numpy(labels), torch.from_numpy(idx),
                            n_classes)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("r", [0.4, 0.9, 10.0])
    def test_ball_range_histogram(self, r):
        x, q = uniform(12, 2, 128, 3), uniform(13, 2, 24, 3)
        d = ((q.astype(np.float64)[:, :, None]
              - x.astype(np.float64)[:, None]) ** 2).sum(-1)
        assert np.abs(d - r * r).min() > 1e-5
        labels = np.random.default_rng(14).integers(0, 3, (2, 128)) \
            .astype(np.int32)
        (jx, tx), (jq, tq) = both(x), both(q)
        want = np.asarray(jg.label_stat_ball_range(jnp.asarray(labels), jx,
                                                   jq, r, 3))
        got = pg.label_stat_ball_range(torch.from_numpy(labels), tx, tq, r, 3)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
