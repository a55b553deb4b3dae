"""The control: the plain reference in TF32 (each matmul operand rounded to
10 mantissa bits, float32 accumulation), put in the program's place by
``--control 1``. The configurations state float32 with TF32 off, so a run
of the control must come out as not correct: that it does is what shows
the comparison can fail. The benchmark's own runs never use it."""
from __future__ import annotations

import torch

from bench.reference import loglinear as ll

PREC = "tf32"


class Control:
    def __init__(self, db: torch.Tensor, cfg: dict):
        self.db, self.cfg = db, cfg
        self.index = ll.build_index(db, cfg["index"], PREC)

    def probe(self, theta):
        return ll.probe_topk(self.index, theta, self.cfg["k"],
                             self.cfg["index"]["n_probe"], PREC)

    def sample(self, theta, keys) -> dict:
        c = self.cfg
        ids, vals = self.probe(theta)
        return ll.sample(self.db, theta, ids, vals, keys, c["n"], c["l"],
                         c["m_cap"], PREC)._asdict()

    def logz(self, theta, keys, ids, vals) -> torch.Tensor:
        return ll.logz(self.db, theta, ids, vals, keys, self.cfg["n"],
                       self.cfg["l"], PREC)

    def tables(self) -> ll.Index:
        return self.index

    @staticmethod
    def launch_counts() -> dict:
        return {}

    @staticmethod
    def reset_launch_counts() -> None:
        pass
