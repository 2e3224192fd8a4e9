"""The port's token stream against the reference's (repro.data.tokens):
bitwise batches for every (seed, batch index, shard), the state round trip
in both directions, and the reference's own invariants
(tests/test_data_tokens.py), mirrored."""
import numpy as np
import pytest

from repro.data.tokens import TokenStream as RefTokenStream
from repro_torch.data.tokens import TokenStream


@pytest.mark.parametrize("seed,start", [(0, 0), (17, 3), (5, 11)])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_batches_bitwise_the_reference(seed, start, shards):
    for w in range(shards):
        a = TokenStream(1000, 8, 32, seed=seed, start_batch=start)
        b = RefTokenStream(1000, 8, 32, seed=seed, start_batch=start)
        for _ in range(3):
            (ta, la), (tb, lb) = a.next(shard=(w, shards)), b.next(shard=(w, shards))
            assert ta.dtype == tb.dtype == np.int32
            np.testing.assert_array_equal(ta, tb)
            np.testing.assert_array_equal(la, lb)
        assert a.state_dict() == b.state_dict()


def test_state_round_trips_between_the_packages():
    a = TokenStream(1000, 8, 32, seed=5)
    a.next(); a.next()
    ref = RefTokenStream(1000, 8, 32, seed=0)
    ref.load_state_dict(a.state_dict())
    np.testing.assert_array_equal(ref.next()[0], a.next()[0])
    back = TokenStream(1000, 8, 32, seed=1)
    back.load_state_dict(ref.state_dict())
    np.testing.assert_array_equal(back.next()[1], a.next()[1])


def test_deterministic_replay():
    a, b = TokenStream(1000, 8, 32, seed=5), TokenStream(1000, 8, 32, seed=5)
    for _ in range(3):
        (ta, la), (tb, lb) = a.next(), b.next()
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(la, lb)


def test_state_roundtrip_resumes_exactly():
    a = TokenStream(1000, 8, 32, seed=5)
    a.next(); a.next()
    saved = a.state_dict()
    want_t, want_l = a.next()
    b = TokenStream(1000, 8, 32, seed=0)
    b.load_state_dict(saved)
    got_t, got_l = b.next()
    np.testing.assert_array_equal(want_t, got_t)
    np.testing.assert_array_equal(want_l, got_l)


def test_labels_are_shifted_tokens():
    t, l = TokenStream(1000, 4, 16, seed=1).next()
    np.testing.assert_array_equal(t[:, 1:], l[:, :-1])


@pytest.mark.parametrize("nw", [1, 2, 4, 8])
@pytest.mark.parametrize("idx", [0, 5])
def test_shards_partition_the_global_batch(nw, idx):
    ft, _ = TokenStream(500, 8, 16, seed=9, start_batch=idx).next()
    parts = [TokenStream(500, 8, 16, seed=9, start_batch=idx).next(shard=(w, nw))[0]
             for w in range(nw)]
    np.testing.assert_array_equal(np.concatenate(parts, axis=0), ft)
