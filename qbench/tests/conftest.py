"""Shared fixtures of the benchmark's own tests: tiny TPC-H tables on the CPU.

Run them from the root of the repository:

    python -m pytest qbench/tests -q

The repository's ``pytest tests/`` collects nothing from here.  Tests marked
``cuda`` skip without a card, decided inside the ``card`` fixture.
"""

from __future__ import annotations

import json

import pytest
import torch

from qbench import registry
from qbench.gen import tpch

TINY_SF = 0.01
SEED = 2**31 + 17  # larger than 32 signed bits hold, as a run's seed may be
# At this scale no order's quantities sum above 312, so Q18's tests ask for less.
TINY_QUANTITY = {"range": [240, 243]}


@pytest.fixture(scope="session")
def tiny_tables():
    return tpch.generate({"scale_factor": TINY_SF}, SEED, "cpu")


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """BENCHMARK.json with tpch_sf30 cut to TINY_SF, and Q18's mix to TINY_QUANTITY."""
    bench = registry.benchmark()
    with open(registry.ROOT / "qbench" / "configs" / "tpch_sf30.json") as f:
        config = json.load(f)
    config["scale_factor"] = TINY_SF
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(config))
    for entry in bench["configs"]:
        if entry["name"] == "tpch_sf30":
            entry["file"] = str(path)
    real = registry.traffic

    def traffic(name):
        mix = real(name)
        if mix["query"] == "q18":
            mix["params"] = {"quantity": TINY_QUANTITY}
        return mix

    monkeypatch.setattr(registry, "traffic", traffic)
    return bench


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
