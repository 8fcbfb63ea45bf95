"""R4 bad (torch twin): prefix accumulations with no static dtype evidence; fed bf16
params they cancel the interval they compute."""
import torch


def context_sums(rows):
    prefix = torch.cumsum(rows, 0)
    return prefix[4:] - prefix[:-4]


def running(rows):
    return rows.cumsum(0)
