"""R3 good (capture twin), the helper module: the host reads sit in the arms a capture
never takes (a tensor not on the card, float64 parameters), and a Python scalar's
conversion reads nothing from the device."""
import torch


def scale_of(x, alpha):
    if not isinstance(alpha, torch.Tensor):
        alpha = torch.full((1,), float(alpha), device=x.device)
    return x.abs().amax() * alpha


def live_rows(mask, idx):
    if not mask.is_cuda:
        return idx[torch.nonzero(mask).reshape(-1)]   # the plain version, CPU only
    return torch.where(mask != 0, idx, 0)


def scatter_for(dtype):
    return _kernel_scatter if dtype in (torch.float32, torch.bfloat16) else _plain_scatter


def _kernel_scatter(mat, idx, upd):
    return mat.index_add_(0, idx, upd)


def _plain_scatter(mat, idx, upd):
    keep = torch.nonzero(upd.sum(1)).reshape(-1)      # float64 only: never captured
    return mat.index_add_(0, idx[keep], upd[keep])


def width(x, n: int):
    return int(x.shape[1] * n)
