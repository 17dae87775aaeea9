"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with a
plain PyTorch version beside its wrapper. A wrapper given a CPU tensor runs
the plain version; given a CUDA tensor it launches the kernel or raises.
The wrappers a model or the train step reaches (``flash_attention``,
``ssd_scan``, ``agg_weighted``) also take meta tensors, by the plain
version's shape arithmetic (the dry run's route), and ``ssd_scan`` takes
DTensors, shard by shard (``shards``; the models hand ``flash_attention``
local shards); any other device raises."""
