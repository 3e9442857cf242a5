"""Tiny sizes of every configuration and mix, for the CPU tests: the same
code paths as a run on the card, at a size a test can hold."""
from __future__ import annotations

import copy


def config(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    for o in cfg["owners"].values():
        o["entities"], o["relations"], o["triples"] = 1200, 12, 2400
    if "aligned" in cfg:
        cfg["aligned"]["entities"] = 150
    cfg["eval_triples"] = 60
    if "scheduler" in cfg:
        cfg["scheduler"]["ppat"]["steps"] = 12
        cfg["scheduler"]["score_max_test"] = 40
    return cfg


def traffic(mix: dict) -> dict:
    mix = dict(mix)
    for k, v in (("pool_rows", 2048), ("clients", 4), ("rows_max", 48), ("rows_min", 8),
                 ("size_strata", 64), ("max_batch", 96), ("check_rows", 48),
                 ("warm_rounds", 1)):
        if k in mix:
            mix[k] = v
    return mix


OVERRIDES = {"config": config, "traffic": traffic}
