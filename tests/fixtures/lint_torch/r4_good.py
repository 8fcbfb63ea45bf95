"""R4 good (torch twin): each prefix accumulation carries its dtype evidence: a dtype=
keyword, a widening cast in the input's def-use chain, or an integer/boolean source."""
import torch


def context_sums(rows):
    wide = rows.to(torch.float32)
    prefix = torch.cumsum(wide, 0)
    return prefix[4:] - prefix[:-4]


def running(rows):
    return rows.double().cumsum(0)


def counted(rows):
    return torch.cumsum(rows, 0, dtype=torch.float64)


def positions(mask, n):
    return torch.cumsum(mask > 0, 0) + torch.cumsum(torch.arange(n), 0)
