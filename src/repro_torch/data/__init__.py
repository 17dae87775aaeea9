from . import femnist, partition, population, streaming  # noqa: F401
from .partition import Partition, PartitionConfig, make_partition  # noqa: F401
from .streaming import (AVAILABILITY_SCHEDULES,  # noqa: F401
                        CORRUPTION_MODES, DRIFT_SCHEDULES,
                        LAZY_POOL_THRESHOLD, AvailabilityConfig, AvailFn,
                        ClientPool, CorruptionConfig, DeviceBackedStreams,
                        DeviceSampler, DeviceStream, DriftConfig, DriftFn,
                        FactoryStreams, HostClientPool,
                        make_availability_fn, make_client_pool,
                        make_corruption_fn, make_device_sampler,
                        make_drift_fn)
from .population import LazyPopulation, PopulationConfig  # noqa: F401
from .lm_data import MarkovLMStream  # noqa: F401
