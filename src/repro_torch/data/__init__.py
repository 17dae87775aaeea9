from . import femnist, partition, streaming  # noqa: F401
from .partition import Partition, PartitionConfig, make_partition  # noqa: F401
from .streaming import (CORRUPTION_MODES, CorruptionConfig,  # noqa: F401
                        DeviceBackedStreams, DeviceSampler, DeviceStream,
                        FactoryStreams, make_corruption_fn,
                        make_device_sampler)
from .lm_data import MarkovLMStream  # noqa: F401
