"""Twin of tests/test_async.py::TestBatchedFetch with fetch_batch=4: the same
40 frames through the JAX package and the port (tests/batched_fetch_twin.py),
the same number of tracked frames in both, counted from
``trajectory_lost_mask()``, and the ATE under the floor of the JAX test's
limit, 0.03 m, in both."""
import pytest

import batched_fetch_twin as twin


@pytest.fixture(scope="module")
def runs():
    return twin.run(4)


def test_tracks_as_many_frames_as_jax(runs):
    twin.check_tracked(runs)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_ate_within_the_jax_tests_limit(runs, pkg):
    twin.check_ate(runs, pkg)
