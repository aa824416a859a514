"""The port's copies of the numpy-only data modules give the JAX package's
arrays, partitions and batch streams bit for bit: every other parity test
rests on this."""
import numpy as np
import pytest

import repro.data as R
import repro.data.partition as RP
import repro_torch.data as T
import repro_torch.data.partition as TP


def test_synthetic_vision_identical():
    kw = dict(num_labels=7, samples_per_label=9, image_size=8, noise=0.7,
              seed=3, prototype_seed=5)
    a, b = R.make_synthetic_vision(**kw), T.make_synthetic_vision(**kw)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.num_labels == b.num_labels


def test_synthetic_text_identical():
    kw = dict(num_domains=3, sequences_per_domain=4, seq_len=16,
              vocab_size=32, seed=2, table_seed=9)
    a, b = R.make_synthetic_text(**kw), T.make_synthetic_text(**kw)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("assignment", ["random", "even"])
def test_partition_identical(assignment):
    labels = R.make_synthetic_vision(num_labels=12, samples_per_label=20,
                                     image_size=4, seed=0).labels
    kw = dict(num_clients=4, num_labels=12, labels_per_client=3,
              assignment=assignment, skew=10.0, gamma_pub=0.2, seed=1)
    a = RP.partition_dataset(labels, RP.PartitionConfig(**kw))
    b = TP.partition_dataset(labels, TP.PartitionConfig(**kw))
    np.testing.assert_array_equal(a.public_indices, b.public_indices)
    for x, y in zip(a.client_indices, b.client_indices):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.primary_labels, b.primary_labels):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(RP.shared_test_split(labels, 3, 12),
                                  TP.shared_test_split(labels, 3, 12))


def test_private_and_public_streams_identical():
    ds = R.make_synthetic_vision(num_labels=5, samples_per_label=10,
                                 image_size=4, seed=0)
    arrays = {"images": ds.images, "labels": ds.labels}
    idx = np.arange(0, 50, 2)
    seed = R.client_stream_seed(0, 2)
    assert seed == T.client_stream_seed(0, 2)
    a, b = R.BatchIterator(arrays, idx, 7, seed=seed), \
        T.BatchIterator(arrays, idx, 7, seed=seed)
    for _ in range(6):  # crosses an epoch boundary
        x, y = a.next(), b.next()
        np.testing.assert_array_equal(x["images"], y["images"])
        np.testing.assert_array_equal(x["labels"], y["labels"])
    pa, pb = R.PublicPool(arrays, idx, 8, seed=3), \
        T.PublicPool(arrays, idx, 8, seed=3)
    for step in (0, 1, 17):
        np.testing.assert_array_equal(pa.sample_ids(step), pb.sample_ids(step))
        np.testing.assert_array_equal(pa.sample(step)["images"],
                                      pb.sample(step)["images"])
        assert "labels" not in pb.sample(step)
