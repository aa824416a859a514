"""The frozen draws (`data/draws.py`) the reference takes its feed from
are the program's pipeline's: private batches over several epochs, the
public batches, the graph, and the teachers a seeded pool samples."""
import numpy as np
import pytest

from portbench.tests import tiny  # noqa: F401
from portbench.data import draws


@pytest.mark.parametrize("seed,client", [(0, 0), (0, 2), (2 ** 31 + 5, 1)])
def test_private_batches_follow_the_pipeline(seed, client):
    from repro_torch.data.pipeline import BatchIterator, client_stream_seed

    indices = np.arange(100, 123)  # 23 rows: batches cross epochs
    arrays = {"tokens": np.arange(200 * 3).reshape(200, 3)}
    it = BatchIterator(arrays, indices, 8,
                       seed=client_stream_seed(seed, client))
    want = draws.private_indices(indices, 8, seed, client, 9)
    for sel in want:
        assert np.array_equal(it.next()["tokens"], arrays["tokens"][sel])


def test_public_batches_follow_the_pool():
    from repro_torch.data.pipeline import PublicPool

    indices = np.arange(40, 90)
    arrays = {"tokens": np.arange(100), "labels": np.zeros(100)}
    pool = PublicPool(arrays, indices, 8, seed=3)
    for step in range(6):
        assert np.array_equal(pool.sample_ids(step),
                              draws.public_indices(indices, 8, 3, step))


def test_the_complete_graph_is_the_programs():
    from repro_torch.core import graph

    assert draws.graph("complete", 5) == \
        [tuple(n) for n in graph.complete_graph(5)]
    with pytest.raises(ValueError):
        draws.graph("no-such-graph", 5)


@pytest.mark.parametrize("delta", [1, 2])
def test_teachers_follow_the_checkpoint_pool(delta):
    from repro_torch.checkpoint.pool import CheckpointPool, PoolEntry

    for client in range(3):
        pool = CheckpointPool(2, 4, seed=7 + draws.POOL_STRIDE * client)
        entries = draws.pool([j for j in range(4) if j != client], 2)
        for j in entries:
            pool.insert(PoolEntry(j, None, 0))
        got = [[e.client_id for e in pool.sample(delta)] for _ in range(5)]
        assert got == draws.teachers(entries, delta, 7, client, 5)
