"""The system under test: the port's train step, built from a
configuration through the port's public API, with the weights the
benchmark made.  This is the only module of the benchmark that imports the
port."""

from __future__ import annotations

import torch


class System:
    """The port's ``SegmentationModel``, its Adam optimiser, the train
    step and its state.  ``step(image, label, generator)`` runs one step
    and returns the step's metrics (0-d tensors on the device)."""

    def __init__(self, config, step_kind, batch, weights, wrapper_seed,
                 device):
        from advchain_tpu_torch import augmentor, models, parallel
        m = config["model"]
        with torch.device(device):
            module = getattr(models, m["name"])(**m["args"])
        names = {n for n, _ in module.named_parameters()}
        if names != set(weights):
            raise ValueError(f"the port's {m['name']} has parameters "
                             f"{sorted(names ^ set(weights))} that the "
                             f"benchmark's do not match")
        with torch.no_grad():
            for n, p in module.named_parameters():
                p.copy_(weights[n])
        self.model = models.SegmentationModel(module, seed=wrapper_seed)
        tr = config["train"]
        self.optimizer = torch.optim.Adam(module.parameters(),
                                          lr=float(tr["lr"]))
        if step_kind == "adversarial":
            dims = len(config["image"]["shape"])
            size = [batch, config["image"]["channels"],
                    *config["image"]["shape"]]
            cls = {"noise": augmentor.AdvNoise, "bias": augmentor.AdvBias,
                   "affine": augmentor.AdvAffine,
                   "morph": augmentor.AdvMorph}
            chain = [cls[e["name"]](spatial_dims=dims,
                                    config_dict=dict(e["config"],
                                                     data_size=size),
                                    seed=i)
                     for i, e in enumerate(config["chain"])]
            s = config["solver"]
            solver = self.solver = augmentor.ComposeAdversarialTransformSolver(
                chain_of_transforms=chain,
                divergence_types=s["divergence_types"],
                divergence_weights=s["divergence_weights"])
            self._step = parallel.make_adversarial_train_step(
                self.model, solver, self.optimizer, n_iter=int(s["n_iter"]),
                power_iteration=s["power_iteration"],
                consistency_weight=float(tr["consistency_weight"]))
        elif step_kind == "supervised":
            self.solver = None
            self._step = parallel.make_supervised_train_step(self.model,
                                                             self.optimizer)
        else:
            raise ValueError(f"unknown step {step_kind!r}")
        self.state = parallel.TrainState.create(self.model, self.optimizer)

    def step(self, image, label, generator):
        self.state, metrics = self._step(
            self.state, {"image": image, "label": label}, generator)
        return metrics

    def parameters(self):
        return dict(self.model.module.named_parameters())

    def first_gradient(self):
        """Each parameter's gradient as Adam received it at the first
        step, worked out from its state: ``exp_avg / (1 - beta1)`` (zero
        where the optimiser holds no state)."""
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        out = {}
        for n, p in self.parameters().items():
            st = self.optimizer.state.get(p, {})
            m = st.get("exp_avg")
            out[n] = (torch.zeros_like(p) if m is None
                      else m.detach() / (1.0 - beta1)).clone()
        return out


def launch_counts():
    """The port's own launch counters: {"<family>.<fwd|bwd>": launches},
    and the dispatch predicate's under ``dispatch_slope``."""
    from advchain_tpu_torch.kernels import (band_sample, plane_sample,
                                            stencil_warp, zband_sample)
    out = {"dispatch_slope": stencil_warp.SLOPE_LAUNCHES,
           "stencil_warp.fwd": stencil_warp.FWD_LAUNCHES,
           "stencil_warp.bwd": stencil_warp.BWD_LAUNCHES}
    for fam, mod in (("band", band_sample), ("zband", zband_sample)):
        out[f"{fam}.fwd"] = mod.FWD_LAUNCHES
        out[f"{fam}.bwd"] = mod.BWD_LAUNCHES
        out[f"{fam}_grid.fwd"] = mod.GRID_FWD_LAUNCHES
        out[f"{fam}_grid.bwd"] = mod.GRID_BWD_LAUNCHES
    for route, counts in plane_sample.LAUNCHES.items():
        for way, n in counts.items():
            out[f"{route}.{way}"] = n
    return out


def reset_launch_counts():
    from advchain_tpu_torch.kernels import (band_sample, plane_sample,
                                            stencil_warp, zband_sample)
    for mod in (band_sample, plane_sample, stencil_warp, zband_sample):
        mod.reset_launch_counts()
