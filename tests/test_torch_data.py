"""The port's numpy data layer is bit-equal to the JAX package's."""
import numpy as np
import pytest

from repro.data import femnist as jfemnist
from repro.data import partition as jpartition
from repro.data import streaming as jstreaming
from repro_torch.data import femnist, partition, streaming


@pytest.mark.parametrize("seed", [0, 3])
def test_partition_bit_equal(seed):
    kw = dict(num_factories=4, devices_per_factory=8, alpha=0.3, seed=seed)
    a = jpartition.make_partition(jpartition.PartitionConfig(**kw))
    b = partition.make_partition(partition.PartitionConfig(**kw))
    for field in ("class_probs", "writer_ids", "data_rates", "p_real"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("seed", [0, 5])
def test_factory_streams_counts_and_images_bit_equal(seed):
    kw = dict(num_factories=3, devices_per_factory=8, seed=seed)
    pa = jpartition.make_partition(jpartition.PartitionConfig(**kw))
    pb = partition.make_partition(partition.PartitionConfig(**kw))
    sa = jstreaming.FactoryStreams(pa, batch_size=8, seed=seed)
    sb = streaming.FactoryStreams(pb, batch_size=8, seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(3):
        np.testing.assert_array_equal(sa.next_counts(), sb.next_counts())
        # unsorted picks: the gather order must be ascending device index
        masks = np.zeros((3, 8), np.float32)
        for m in range(3):
            masks[m, rng.permutation(8)[:3]] = 1.0
        ia, la = sa.fetch_selected(masks, 3)
        ib, lb = sb.fetch_selected(masks, 3)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("seed", [99, 7])
def test_test_set_bit_equal(seed):
    xa, ya = jfemnist.make_test_set(n_per_class=2, seed=seed)
    xb, yb = femnist.make_test_set(n_per_class=2, seed=seed)
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ya, yb)
