"""The benchmark's inputs, made on the device from ``--seed``: the feature
table and the stream of queries with their key rows.

The table is the seeded clustered table of the repository's earlier chip
figures (``chip_smoke.py``'s ``paper_table``): unit rows scattered with
Gaussian noise around Gaussian centres. A query is a row of the table drawn
uniformly, scaled by 1/τ (the paper's §4.1.2), so every seed gives the
same sizes and the same kind of work.
"""
from __future__ import annotations

import torch

# keeps the query stream's generator apart from the table's for every seed
_QUERY_SALT = 0x5DEECE66D


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2 ** 63 - 1))
    return gen


def table(seed: int, n: int, d: int, centers: int, noise: float,
          device) -> torch.Tensor:
    """(n, d) float32 unit rows around ``centers`` Gaussian centres with
    noise ``noise``, in a few large calls on the device."""
    gen = generator(seed, device)
    c = torch.randn((centers, d), generator=gen, device=device)
    assign = torch.randint(0, centers, (n,), generator=gen, device=device)
    db = c[assign]
    db += noise * torch.randn((n, d), generator=gen, device=device)
    return db / torch.linalg.norm(db, dim=1, keepdim=True)


class Queries:
    """Batches of ``batch`` queries θ = (table row) / τ, rows drawn
    uniformly, each with its (seed, query number, 0) key row."""

    def __init__(self, seed: int, n: int, batch: int, tau: float, device):
        self.seed, self.n, self.batch, self.tau = seed, n, batch, tau
        self.device = device
        self.gen = generator(seed ^ _QUERY_SALT, device)
        self.count = 0

    def rows(self) -> tuple[torch.Tensor, int]:
        """The next batch's table rows and its first query number."""
        rows = torch.randint(0, self.n, (self.batch,), generator=self.gen,
                             device=self.device)
        q0 = self.count
        self.count += self.batch
        return rows, q0

    def batch_of(self, db: torch.Tensor, rows: torch.Tensor, q0: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """(θ (b, d) float32, keys (b, 3) int64) of a batch."""
        theta = db[rows] / self.tau
        num = torch.arange(q0, q0 + rows.shape[0], device=self.device)
        keys = torch.stack([torch.full_like(num, self.seed), num,
                            torch.zeros_like(num)], dim=1)
        return theta, keys
