"""The port's group-sharded engine (DESIGN.md §8) at world 4 against the
JAX package's 4-shard run (``jax_sharded_reference.py``, 4 forced host
devices, in a process of its own), on ``test_fedgs_fused.py``'s
multi-device config (M=4, K=8, L=4, T=5, R=2): the plain, compressed and
robust compositions here, the drift, availability and population ones in
``test_torch_sharded_jax_env.py``. Four gloo ranks, one group each, run
the port while the reference runs. Params to 1e-5 (1e-3 compressed, as in
``test_torch_fused.py``), round records to 1e-4; the masks, the
quarantine counters and staleness clocks, ``reselections``, ``corr``,
``rb``, ``participation`` and the byte ledger exactly."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_sharded_ranks as ranks

HERE = os.path.dirname(os.path.abspath(__file__))
ARMS = ("plain", "compress", "robust")
EXACT = ("reselections", "corrupted_selected", "rollbacks", "participation",
         "staleness_max", "dark_selected", "bytes_int", "bytes_ext")
# a compression error drifts with last-bit gradient differences that flip
# stochastic int8 roundings (test_torch_fused.py); its params by one int8
# quantum (~max|g|/127·lr)
PARAM_TOL = {"compress": 1e-3}
RECORD_TOL = {"compress_error": 1e-2}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sharded_runs(tmp_path_factory, arms):
    """The JAX 4-shard runs of ``arms`` and the port's at world 4, side by
    side: {arm: (reference, [rank 0..3])}. Each arm's reference runs in a
    process of its own, all beside the port's ranks: an arm's run is one
    XLA compile of ~15 s that no other arm can share, so in one process
    they would queue."""
    jax_out = tmp_path_factory.mktemp("jax4")
    port_out = tmp_path_factory.mktemp("port4")
    refs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "jax_sharded_reference.py"),
         str(jax_out), arm],
        env={**os.environ, "PYTHONPATH": "src" + os.pathsep
             + os.environ.get("PYTHONPATH", "")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arm in arms]
    try:
        ranks.spawn(4, [(arm, ranks.M) for arm in arms], str(port_out))
        errs = [ref.communicate(timeout=600)[1] for ref in refs]
    finally:
        for ref in refs:
            ref.kill()
    for ref, err in zip(refs, errs):
        assert ref.returncode == 0, err[-3000:]
    return {arm: (ranks.load(str(jax_out / arm)),
                  ranks.load_world(str(port_out), arm, ranks.M, 4))
            for arm in arms}


def assert_matches_reference(arm, ref, world):
    """Every rank's records and params against the reference's, and the
    ranks' rows of the carried state, in rank order, against its."""
    jrecs, jparams, jsel = ref
    for recs, params, _ in world:
        tol = PARAM_TOL.get(arm, 1e-5)
        diff = max(float(np.abs(a - b).max())
                   for a, b in zip(jparams, params, strict=True))
        assert diff <= tol, (arm, diff)
        assert len(recs) == len(jrecs)
        for r, o in zip(jrecs, recs):
            for key, rv in r.items():
                if key in ("round", "strategy") or rv is None:
                    assert o[key] == rv, (arm, key)
                elif key in EXACT:
                    assert o[key] == rv, (arm, key, o[key], rv)
                else:
                    tol = RECORD_TOL.get(key, 1e-4) if r["round"] else 1e-4
                    assert abs(o[key] - rv) <= tol * max(1.0, abs(rv)), (
                        arm, key, o[key], rv)
    for name, full in jsel.items():
        rows = np.concatenate([sel[name] for _, _, sel in world])
        if name == "distance":
            np.testing.assert_allclose(rows, full, atol=1e-4)
        else:
            np.testing.assert_array_equal(rows, full, err_msg=name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sharded_runs(tmp_path_factory, ARMS)


@pytest.mark.parametrize("arm", ARMS)
def test_world4_matches_jax_4shard(arm, runs):
    ref, world = runs[arm]
    assert_matches_reference(arm, ref, world)
    if arm == "robust":
        assert sum(r["corrupted_selected"] for r in ref[0]) > 0
        assert int(ref[2]["quarantine"].sum()) > 0
