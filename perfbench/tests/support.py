"""A tiny run of a cell on the CPU: the configuration cut to a few
hosts, the device cache cut by the same factor so that each cell keeps
its route, and the harness driven without its look for a card."""

from __future__ import annotations

import copy
import time

import torch

from perfbench import catalog, harness

HOSTS = 12


def small_config(monkeypatch, hosts: int = HOSTS) -> None:
    original = catalog.config

    def config(bench, name):
        c = copy.deepcopy(original(bench, name))
        scan = c["storage"]["scan"]
        scan["cache_max_rows"] = max(1, scan["cache_max_rows"] * hosts
                                     // c["scale"])
        c["scale"] = hosts
        return c

    monkeypatch.setattr(catalog, "config", config)


def run_small(monkeypatch, cell: str, seed: int = 2**33 + 7,
              seconds: float = 1.5, bench: dict = None):
    small_config(monkeypatch)
    return harness.run_cell(bench or catalog.benchmark(), cell, seed,
                            seconds, False, torch.device("cpu"),
                            time.perf_counter(), "cpu")
