"""R6 good (torch twin): the chunk's host arrays reach the card only through the
staging path (pinned memory, non-blocking copies on the staging stream)."""
import torch


class Trainer:
    def _stage(self, chunks):
        stream = torch.cuda.Stream(device=self.device)
        for chunk in chunks:
            pinned = {k: torch.from_numpy(a).pin_memory() for k, a in chunk["arrays"].items()}
            with torch.cuda.stream(stream):
                chunk["arrays"] = {k: t.to(self.device, non_blocking=True)
                                   for k, t in pinned.items()}
            yield chunk

    def _prologue(self, chunk):
        arrays = chunk["arrays"]
        return arrays["bases"].reshape(-1)
