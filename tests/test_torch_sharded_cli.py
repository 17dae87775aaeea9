"""``python -m repro_torch.launch.train --engine sharded`` (DESIGN.md §8)
on the CPU, on the smoke command plain and with the robust and
availability flags: at world 1 the port prints ``--engine fused``'s lines
exactly, and on the plain command the JAX CLI's ``--engine sharded``
lines (one JAX device: its one-shard mesh) to 1e-4 (``resel``, ``part``,
``stale``, ``corr``, ``rb`` equal); as two processes with torchrun's
variables (gloo, two groups a rank) rank 0 prints one line naming the
backend, the world and the shards, then the same round lines (the JAX
CLI's on the plain command, the port's ``--engine fused`` ones with the
composed flags, whose fused run the avail and robust CLI tests hold to
the JAX CLI's), and rank 1 prints none."""
import os
import re
import socket
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import train
from test_torch_train import SMOKE

COMPOSED = ["--corrupt", "scale+nan_burst+gauss_noise", "--corrupt-frac",
            "0.25", "--quarantine-limit", "2", "--robust-agg",
            "trimmed_mean", "--avail", "markov", "--avail-up-prob", "0.6",
            "--sync", "bounded_async"]
ARMS = {"plain": [], "composed": COMPOSED}
FIELD = re.compile(r"(loss|divergence|disc|resel|part|stale|corr|clip|rb|"
                   r"test acc) ([0-9./]+)")
EXACT = ("resel", "part", "stale", "corr", "rb")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(**extra) -> dict:
    return {**os.environ, "PYTHONPATH": "src" + os.pathsep
            + os.environ.get("PYTHONPATH", ""), **extra}


def _rounds(text):
    return [FIELD.findall(ln) for ln in text.splitlines()
            if ln.startswith("round")]


class ReferenceLines:
    """The round lines each arm is held to: the JAX CLI's ``--engine
    sharded`` on the plain command (its run starts at once in a process of
    its own and is waited for when first asked for), the port's
    ``--engine fused`` (in this process) on the others."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro.launch.train", "--engine",
             "sharded"] + SMOKE, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self.lines = {}

    def fused(self, arm, capsys) -> str:
        """The port's ``--engine fused`` output of ``arm`` on the CPU."""
        capsys.readouterr()
        train.main(SMOKE + ["--device", "cpu", "--engine", "fused"]
                   + ARMS[arm])
        return capsys.readouterr().out

    def get(self, arm, capsys):
        if arm not in self.lines:
            if arm == "plain":
                stdout, stderr = self.proc.communicate(timeout=600)
                assert self.proc.returncode == 0, stderr[-3000:]
            else:
                stdout = self.fused(arm, capsys)
            self.lines[arm] = _rounds(stdout)
        return self.lines[arm]

    def close(self):
        self.proc.kill()
        self.proc.communicate()


@pytest.fixture(scope="module")
def reference():
    runs = ReferenceLines()
    yield runs
    runs.close()


def _assert_lines_match(ref, out):
    assert len(ref) == len(out) == 3
    for r, o in zip(ref, out):
        assert [k for k, _ in r] == [k for k, _ in o]
        for (key, rv), (_, ov) in zip(r, o):
            if key in EXACT:
                assert rv == ov, (key, rv, ov)
            else:
                assert abs(float(rv) - float(ov)) <= 1e-4, (key, rv, ov)


@pytest.mark.parametrize("arm", list(ARMS))
def test_world1_prints_fused_and_jax_lines(arm, reference, capsys):
    fused = reference.fused(arm, capsys)
    train.main(SMOKE + ["--device", "cpu", "--engine", "sharded"]
               + ARMS[arm])
    sharded = capsys.readouterr().out
    assert sharded == fused
    _assert_lines_match(reference.get(arm, capsys), _rounds(sharded))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("arm", list(ARMS))
def test_two_ranks_print_once(arm, reference, capsys):
    port = _free_port()
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--engine",
            "sharded", "--device", "cpu"] + SMOKE + ARMS[arm]
    procs = [subprocess.Popen(
        argv, env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                       LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, stderr[-3000:]
            outs.append(stdout)
    finally:
        for proc in procs:
            proc.kill()
    lines = outs[0].splitlines()
    assert lines[0] == ("sharded engine: backend gloo | world 2 | shards 2 "
                        "| groups per shard 2")
    _assert_lines_match(reference.get(arm, capsys), _rounds(outs[0]))
    assert outs[1] == ""
