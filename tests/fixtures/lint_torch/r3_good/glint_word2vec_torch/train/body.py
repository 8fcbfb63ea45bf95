"""R3 good (capture twin), the captured body: the same reach with every host read
pruned or on host values."""
from glint_word2vec_torch.ops import helper
from glint_word2vec_torch.ops.helper import live_rows, scale_of


class Trainer:
    def _chunk_body(self, x, mask, idx, upd):
        rows = live_rows(mask, idx)
        scatter = helper.scatter_for(x.dtype)
        scatter(x, rows, upd)
        return x * scale_of(x, 0.5) + helper.width(x, 2)

    def _capture(self, graph):
        graph.capture_begin()
