"""R2 good (torch twin): every draw from an explicit, seeded generator."""
import numpy as np
import torch


def draw(n, seed):
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    noise = torch.randn(n, generator=gen)
    order = torch.randperm(n, generator=gen)
    table = torch.empty(n).uniform_(-1, 1, generator=gen)
    return rng.random(n), noise, order, table
