"""Multi-host path (SURVEY.md §5 comm-backend row): the sharded index
built and queried over a mesh that SPANS two jax.distributed processes
(4 virtual CPU devices each -> 8 global). Validates the claim in
parallel/sharded.py's module docstring that the shard_map build/fan-out
code runs unchanged under jax.distributed — cross-process collectives ride
the Gloo CPU backend here, the hosts' network on a real cluster.
"""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # two fresh interpreters + distributed init


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_sharded_index_spans_two_processes():
    child = os.path.join(os.path.dirname(__file__), "multihost_child.py")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_PLATFORM_NAME")}
    procs = [subprocess.Popen(
        [sys.executable, child, str(p), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for p in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost children timed out:\n" + "\n".join(outs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-15:])
        assert p.returncode == 0, f"rank {rank} rc={p.returncode}:\n{tail}"
        assert "MULTIHOST OK" in out, f"rank {rank}:\n{tail}"
