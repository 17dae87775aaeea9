from . import femnist, partition, streaming  # noqa: F401
from .partition import Partition, PartitionConfig, make_partition  # noqa: F401
from .streaming import (CORRUPTION_MODES, LAZY_POOL_THRESHOLD,  # noqa: F401
                        ClientPool, CorruptionConfig, DeviceBackedStreams,
                        DeviceSampler, DeviceStream, FactoryStreams,
                        HostClientPool, make_client_pool, make_corruption_fn,
                        make_device_sampler)
from .lm_data import MarkovLMStream  # noqa: F401
