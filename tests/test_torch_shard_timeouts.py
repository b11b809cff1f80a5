"""SM-axis sharding on the golden run that its cycle cap cuts:
hotspot@0.02 on TINY at ``max_cycles = 2^15``, where 2 of its 4 kernels
time out (``timeouts`` 2, as the JAX package reads; ROADMAP.md §3).  At 2
shards on a CPU mesh, static assignment, window exchange, it must equal
tests/golden/determinism_tiny.json and read the same 2 timeouts.  Its own
file because it takes ~50 s here (tests/test_torch_shard.py holds the
other three golden cases)."""
import json

import torch

from repro_torch.core import stats as S
from repro_torch.sim.workloads import resolve_workload
from test_torch_shard import GOLDEN, run_shard


def test_hotspot_shard_keeps_its_timeouts():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = run_shard(resolve_workload("hotspot", 0.02), 2, "static",
                        "window")
    finally:
        torch.set_num_threads(n)
    with open(GOLDEN) as f:
        assert S.comparable(got) == json.load(f)["hotspot@0.02"]
    assert got["timeouts"] == 2
