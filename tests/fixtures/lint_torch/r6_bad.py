"""R6 bad (torch twin): host data placed on the card in the trainer outside the staging
path: blocking copies the transfer audit sees only on the paths it drives."""
import numpy as np
import torch


class Trainer:
    def _prologue(self, chunk):
        bases = torch.from_numpy(np.asarray(chunk["bases"], np.int64)).to(self.device)
        alpha = torch.tensor(chunk["alpha"], device=self.device)
        extra = torch.as_tensor(chunk["extra"], device=self.device)
        return bases, alpha, extra, torch.from_numpy(chunk["rows"]).cuda()
