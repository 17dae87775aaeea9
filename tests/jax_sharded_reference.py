"""The JAX package's group-sharded engine on 4 forced host devices, on the
compositions of ``torch_sharded_ranks.ARMS``: the reference of
``test_torch_sharded_jax*.py``. Run as a script, in a process of its own
(the device-count flag must not reach the test process):

  PYTHONPATH=src python tests/jax_sharded_reference.py OUT plain,robust

It drives ``fedgs.make_fedgs_experiment(..., mesh=make_group_mesh(4))``
through ``engine.run_experiment`` (without eval) and reads the params as
``np.asarray(leaf)[0]``: the package's own ``params_fn`` indexes a
group-sharded array, which this jax refuses. Each composition's records,
params and carried masks, distances, staleness clock and quarantine
counters go to OUT/<arm> (``torch_sharded_ranks.save``)."""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import femnist_cnn  # noqa: E402
from repro.core import engine, fedgs  # noqa: E402
from repro.data import (AvailabilityConfig, CorruptionConfig,  # noqa: E402
                        DeviceStream, DriftConfig, LazyPopulation,
                        PartitionConfig, PopulationConfig,
                        make_availability_fn, make_corruption_fn,
                        make_device_sampler, make_partition)
from repro.launch.mesh import make_group_mesh  # noqa: E402
from repro.models import cnn  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_sharded_ranks import ARMS, CFG, M, named_state, save  # noqa: E402


def run(arm: str):
    extra, corrupt, drift, avail, k_pop = ARMS[arm]
    cfg = fedgs.FedGSConfig(**CFG, batch_size=8, **extra)
    drift = None if drift is None else DriftConfig(**drift)
    if k_pop:
        pop = LazyPopulation(PopulationConfig(
            num_factories=M, devices_per_factory=k_pop, batch_size=8,
            seed=0))
        sampler = make_device_sampler(pop, drift=drift,
                                      candidates=CFG["devices_per_group"],
                                      candidate_every=cfg.reselect_every)
        p_real, n_dev = pop.p_real, M * k_pop
    else:
        part = make_partition(PartitionConfig(
            num_factories=M, devices_per_factory=CFG["devices_per_group"],
            seed=0))
        sampler = make_device_sampler(DeviceStream.from_partition(
            part, batch_size=8, seed=0), drift=drift)
        p_real, n_dev = part.p_real, M * CFG["devices_per_group"]
    avail_fn = None if avail is None else make_availability_fn(
        AvailabilityConfig(**avail), 0, n_dev)
    corrupt_fn = None if corrupt is None else make_corruption_fn(
        CorruptionConfig(**corrupt), 0, n_dev)
    # the JAX CLI's choice: the §16.1 superbatch step off the robust path
    group_loss_fn = None if corrupt is not None else cnn.make_group_loss_fn()
    params = cnn.init_cnn(jax.random.PRNGKey(0), femnist_cnn.smoke_config())
    mesh = make_group_mesh(M)
    assert mesh.devices.size == 4, mesh
    exp = fedgs.make_fedgs_experiment(
        params, cnn.loss_fn, sampler, p_real, cfg, avail_fn=avail_fn,
        corrupt_fn=corrupt_fn, group_loss_fn=group_loss_fn, mesh=mesh)
    state, logs = engine.run_experiment(exp, cfg.rounds, chunk=1)
    return ([rec.to_dict() for rec in logs],
            [np.asarray(leaf)[0] for leaf in jax.tree.leaves(state[0])],
            named_state(state[2], cfg.sync == "bounded_async",
                        corrupt is not None and cfg.quarantine_limit > 0))


if __name__ == "__main__":
    out, arms = sys.argv[1], sys.argv[2].split(",")
    for arm in arms:
        save(os.path.join(out, arm), *run(arm))
