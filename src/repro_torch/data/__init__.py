from . import femnist, partition, streaming  # noqa: F401
from .partition import Partition, PartitionConfig, make_partition  # noqa: F401
from .streaming import (CORRUPTION_MODES, CorruptionConfig,  # noqa: F401
                        FactoryStreams, make_corruption_fn)
from .lm_data import MarkovLMStream  # noqa: F401
