"""MultiMult / Relation tests (model: reference test/curves/multimult.test.ts).

The port's copy of the reference package's tests/test_multimult.py: the same
cases over ``zkecdsa_tpu_torch``'s host layer, on the port's own
deterministic tape (tests/conftest.py installs the JAX package's).
"""

import pytest
import torch

from zkecdsa_tpu_torch.curves import MultiMult, Relation, p256, tomEdwards256
from zkecdsa_tpu_torch.utils import rng as port_rng

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def port_deterministic_rng():
    """Every test runs on a reproducible random tape of the port's source."""
    with port_rng.deterministic(0xC0FFEE):
        yield


def _naive(group, pairs):
    acc = group.identity()
    for pt, s in pairs:
        acc = acc.add(pt.mul(s))
    return acc


def test_multimult_matches_naive_sum():
    g = p256
    G = g.generator()
    pairs = []
    multi = MultiMult(g)
    for i in range(6):
        pt = G.mul(g.new_scalar(i + 2))
        s = g.random_scalar()
        pairs.append((pt, s))
        multi.insert(pt, s)
    assert multi.evaluate().eq(_naive(g, pairs))


def test_multimult_known_points_merge():
    g = tomEdwards256
    G = g.generator()
    multi = MultiMult(g)
    multi.add_known(G)
    multi.add_known(G)  # dedup
    s1, s2 = g.new_scalar(11), g.new_scalar(31)
    multi.insert(G, s1)
    multi.insert(G, s2)
    assert len(multi) == 1
    assert multi.evaluate().eq(G.mul(s1.add(s2)))


def test_empty_multimult_is_identity():
    assert MultiMult(p256).evaluate().is_identity()


def test_null_relation_drains_to_identity():
    g = p256
    G = g.generator()
    rel = Relation(g)
    s = g.random_scalar()
    rel.insert(G, s)
    rel.insert(G.neg(), s)
    multi = MultiMult(g)
    rel.drain(multi)
    assert multi.evaluate().is_identity()


def test_nonnull_relation_not_identity():
    g = p256
    rel = Relation(g)
    rel.insert(g.generator(), g.new_scalar(1))
    multi = MultiMult(g)
    rel.drain(multi)
    assert not multi.evaluate().is_identity()
