"""A manifest whose configurations and traffic are cut to a size a CPU
test run holds: images of 32 x 32 (volumes of 8 x 32 x 32), batches of
2, the chain's grids scaled with the image."""

import copy
from pathlib import Path

from cudabench import harness

ROOT = Path(__file__).resolve().parents[2]


class TinyManifest(harness.Manifest):
    def __init__(self, root=ROOT, shape2=(32, 32), shape3=(8, 32, 32),
                 batch=2):
        super().__init__(root)
        self.shape2, self.shape3, self.batch = shape2, shape3, batch

    def config(self, name):
        c = copy.deepcopy(super().config(name))
        chain = {e["name"]: e["config"] for e in c["chain"]}
        if len(c["image"]["shape"]) == 2:
            h, w = self.shape2
            c["image"]["shape"] = [h, w]
            chain["bias"]["control_point_spacing"] = [h // 4, w // 4]
            chain["morph"]["vector_size"] = [h // 16, w // 16]
        else:
            d, h, w = self.shape3
            c["image"]["shape"] = [d, h, w]
            chain["bias"]["control_point_spacing"] = [max(d // 2, 2), h // 2,
                                                      w // 2]
            chain["morph"]["vector_size"] = [max(d // 2, 2), h // 16,
                                             w // 16]
        return c

    def traffic(self, name):
        t = dict(super().traffic(name))
        t.update(batch=self.batch, warm_steps=0, trace_steps=1)
        return t
