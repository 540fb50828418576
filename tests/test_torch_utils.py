"""Twins of ``tests/test_utils.py`` on the port's ``utils``, and parity with
the reference's functions on the same inputs (exact: bijections and
components are host code; order statistics compare values, and indices
only where a stable sort decides ties as ``jax.lax.top_k`` does)."""

import numpy as np
import pytest
import torch

from housescan_tpu_torch.utils import (
    biject,
    group_connected_components,
    kth_largest_by,
    kth_smallest_by,
    ord_nub,
)
from housescan_tpu_torch.utils.vector_util import top_fraction_threshold


class TestBijection:
    def test_ord_nub_keeps_first_occurrence_order(self):
        assert ord_nub([3, 1, 3, 2, 1, 5]) == [3, 1, 2, 5]

    def test_biject_round_trip(self):
        index_of, item_of = biject(["c", "a", "c", "b"])
        assert [index_of(x) for x in ["c", "a", "b"]] == [0, 1, 2]
        assert [item_of(i) for i in range(3)] == ["c", "a", "b"]

    def test_biject_unknown_key_raises(self):
        index_of, item_of = biject([1, 2])
        with pytest.raises(KeyError):
            index_of(99)
        with pytest.raises(IndexError):
            item_of(2)


class TestKthBy:
    def test_kth_smallest_numpy(self):
        pts = np.array([[5.0], [1.0], [3.0], [2.0], [4.0]])
        assert kth_smallest_by(lambda p: p[:, 0], 1, pts)[0] == 1.0
        assert kth_smallest_by(lambda p: p[:, 0], 3, pts)[0] == 3.0

    def test_kth_largest_numpy(self):
        pts = np.array([[5.0], [1.0], [3.0], [2.0], [4.0]])
        assert kth_largest_by(lambda p: p[:, 0], 1, pts)[0] == 5.0
        assert kth_largest_by(lambda p: p[:, 0], 2, pts)[0] == 4.0

    def test_kth_torch(self):
        pts = torch.tensor([[5.0, 0.0], [1.0, 1.0], [3.0, 2.0]])
        out = kth_smallest_by(lambda p: p[:, 0], 2, pts)
        assert float(out[0]) == 3.0
        assert float(kth_largest_by(lambda p: p[:, 0], 1, pts)[1]) == 0.0

    def test_invalid_k(self):
        with pytest.raises(ValueError):
            kth_smallest_by(lambda p: p, 0, np.zeros(3))
        with pytest.raises(ValueError):
            kth_largest_by(lambda p: p, 0, torch.zeros(3))

    def test_top_fraction_threshold(self):
        vals = torch.arange(10.0)  # 0..9
        # 20% of 10 = 2 discarded -> the threshold is the 2nd largest, 8
        thr = top_fraction_threshold(vals, 0.2)
        assert float(thr) == 8.0
        assert int((vals <= thr).sum()) == 9
        assert float(top_fraction_threshold(torch.arange(3.0), 0.2)) == 2.0
        assert float(top_fraction_threshold(torch.zeros(0), 0.2)) == float("inf")


class TestConnectedComponents:
    def test_two_components(self):
        comps = group_connected_components([((1, 2), "a"), ((3, 4), "b"), ((2, 5), "c")])
        assert comps == [[((1, 2), "a"), ((2, 5), "c")], [((3, 4), "b")]]

    def test_single_component_chain(self):
        edges = [((i, i + 1), i) for i in range(10)]
        assert group_connected_components(edges) == [edges]

    def test_empty(self):
        assert group_connected_components([]) == []

    def test_payloads_preserved_with_duplicate_edges(self):
        edges = [((1, 2), "x"), ((1, 2), "y")]
        assert group_connected_components(edges) == [edges]

    def test_string_nodes(self):
        edges = [(("a", "b"), 1), (("c", "d"), 2), (("b", "c"), 3), (("e", "f"), 4)]
        comps = group_connected_components(edges)
        assert len(comps) == 2
        assert sum(len(c) for c in comps) == 4


class TestParity:
    """The same inputs through the reference's functions."""

    @pytest.fixture(autouse=True)
    def _ref(self):
        pytest.importorskip("jax")

    def test_components_and_bijection_match(self):
        from housescan_tpu.utils import biject as j_biject
        from housescan_tpu.utils import group_connected_components as j_group

        rng = np.random.default_rng(0)
        for _ in range(20):
            edges = [((int(a), int(b)), k) for k, (a, b) in enumerate(rng.integers(0, 12, (15, 2)))]
            assert group_connected_components(edges) == j_group(edges)
            nodes = [n for (a, b), _ in edges for n in (a, b)]
            assert [biject(nodes)[0](n) for n in nodes] == [j_biject(nodes)[0](n) for n in nodes]

    def test_order_statistics_match_with_ties(self):
        import jax.numpy as jnp

        from housescan_tpu.utils.vector_util import kth_largest_by as j_largest
        from housescan_tpu.utils.vector_util import kth_smallest_by as j_smallest
        from housescan_tpu.utils.vector_util import top_fraction_threshold as j_top

        rng = np.random.default_rng(1)
        # keys with many ties; each point's second column is its index
        keys = rng.integers(0, 5, 40).astype(np.float32)
        pts = np.stack([keys, np.arange(40, dtype=np.float32)], axis=1)
        for k in (1, 2, 7, 20, 40):
            for port_fn, ref_fn in ((kth_smallest_by, j_smallest), (kth_largest_by, j_largest)):
                got = port_fn(lambda p: p[:, 0], k, torch.from_numpy(pts)).numpy()
                want = np.asarray(ref_fn(lambda p: p[:, 0], k, jnp.asarray(pts)))
                np.testing.assert_array_equal(got, want)
        vals = rng.normal(size=101).astype(np.float32)
        for frac in (0.2, 0.1, 0.5, 0.0):
            assert float(top_fraction_threshold(torch.from_numpy(vals), frac)) == \
                float(j_top(jnp.asarray(vals), frac))
