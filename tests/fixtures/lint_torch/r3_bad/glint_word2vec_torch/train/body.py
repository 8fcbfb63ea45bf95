"""R3 bad (capture twin), the captured body: its root calls the helpers of another
module, transitively, and a capture begins outside the declared sites."""
import torch

from glint_word2vec_torch.ops import helper
from glint_word2vec_torch.ops.helper import live_rows, scale_of


class Trainer:
    def _chunk_body(self, x, mask):
        rows = live_rows(mask)
        fn = helper.pick(x)
        x.sync = torch.cuda.synchronize()
        return fn(x[rows]) * scale_of(x) + x.sum().item()

    def _recapture(self, graph):  # not a declared capture site
        graph.capture_begin()
