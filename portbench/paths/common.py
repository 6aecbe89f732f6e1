"""What every entry driver shares: the cell's pool, the sample of pool
requests whose outputs the check compares, and the program's modules."""

from __future__ import annotations

import importlib

import numpy as np

from portbench.traffic import generate

PROGRAM = "pcseg_tpu_torch"
REFERENCE = "portbench.reference.port_plain"
SAMPLE_STREAM = 2_000_000


def modules(package: str, *names):
    return [importlib.import_module(f"{package}.{n}") for n in names]


class Driver:
    """A cell's traffic and check sample; ``program`` is the package under
    test (the control passes the reference's)."""

    profile_requests = 2

    def __init__(self, torch, cell, seed: int, device, program=PROGRAM):
        self.torch = torch
        self.cell = cell
        self.cfg = cell.config
        self.frame = self.cfg["frame"]
        self.seed = seed
        self.device = torch.device(device)
        self.program = program
        self.requests = generate.pool(cell.mix, self.frame,
                                      self.cfg["batch"], seed)
        self.rays, self.origin = generate.rays_and_origin(self.frame)
        n = min(self.cfg["check"]["pool_items"], len(self.requests))
        rng = np.random.default_rng(np.random.SeedSequence([seed,
                                                            SAMPLE_STREAM]))
        self.sample = sorted(int(p) for p in rng.choice(
            len(self.requests), n, replace=False))

    def pool_index(self, i: int) -> int:
        return i % len(self.requests)

    def keep(self, i: int) -> bool:
        return self.pool_index(i) in self.sample

    @property
    def points_per_request(self) -> int:
        return self.cfg["batch"] * self.frame["rows"] * self.frame["cols"]

    def segmenter_config(self, package):
        (config,) = modules(package, "models.config")
        return config.config_from_dict(self.cfg["segmenter"])
