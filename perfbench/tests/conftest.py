"""Shared helpers of the benchmark's own tests: run them with ``python -m
pytest perfbench/tests -q`` from the root of the repository."""

import copy
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from perfbench import harness  # noqa: E402

#: A seed above 2^31, as the driver draws them.
SEED = 2**31 + 4099


def shrink(cell: harness.Cell) -> harness.Cell:
    """The cell at a size the CPU holds: a filter of 2^16 (blocked) or 2^15
    (flat) bits, batches of 256 rows, at most five batches a step; steps
    given by keys keep a padded last batch."""
    c = copy.deepcopy(cell)
    p = c.config["params"]
    p["m"] = 1 << (16 if p.get("block_bits") else 15)
    steps = ([c.traffic["fill"]] if c.traffic.get("fill") else []) + c.traffic["epoch"]
    for s in steps:
        if "batches" in s:
            s["batches"] = min(int(s["batches"]), 5)
        else:
            s["keys"] = 3 * 256 + 37
        s["batch"] = 256
    return c


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")


def cell_names() -> list:
    import json

    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def gpu_device():
    """The card, or a skip: decided when a test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no interpret mode)")
    return torch.device("cuda")
