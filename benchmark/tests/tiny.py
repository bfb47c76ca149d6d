"""The benchmark's cells cut to a size the CPU runs in seconds (107 px, four
images a batch), for the tests: the same files, the same code paths."""

from __future__ import annotations

import copy

from benchmark import harness
from benchmark.reference import model as ref_model

SIZE = 107


def tiny_cell(name: str, root: str = harness.ROOT) -> harness.Cell:
    cell = harness.load_cell(name, root)
    config, traffic = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    model = config["model"]
    model["input_size"] = SIZE
    if model["head_type"] == "ssd":
        sizes = [ref_model.grid_size(SIZE, ep) for ep in model["ssd_endpoints"]]
        config["priors"]["feature_map_sizes"] = sizes
        model["num_priors"] = sum(g * g for g in sizes) * model["ssd_priors_per_cell"]
    else:
        model["num_priors"] = 16
    traffic.update(batch=4, canvas=SIZE if traffic["kind"] == "detect" else SIZE + 11,
                   pool_batches=4, trace_batches=2, trace_steps=2, check_images=6)
    return cell._replace(config=config, traffic=traffic)
