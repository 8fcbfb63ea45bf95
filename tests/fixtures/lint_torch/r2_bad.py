"""R2 bad (torch twin): stdlib random, an unseeded module-level numpy RNG, and torch
draws from the global generator."""
import random

import numpy as np
import torch


def draw(n):
    noise = torch.randn(n)                    # global generator
    order = torch.randperm(n)                 # global generator
    table = torch.empty(n).uniform_(-1, 1)    # global generator
    return [random.random() for _ in range(n)], np.random.rand(n), noise, order, table
