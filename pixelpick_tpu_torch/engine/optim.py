"""Optimizers and LR schedules.

Counterpart of ``pixelpick_tpu/engine/optim.py`` (reference
``utils/utils.py:112-306``, ``utils/lr_scheduler.py:4-21``):

- two parameter groups, the backbone at lr/10 (Adam) or the SGD table's
  hard-coded rates, and the heads at lr;
- coupled L2 weight decay (added to the gradient before the moments), as
  ``torch.optim.Adam/SGD(weight_decay=...)`` and the JAX chain
  ``add_decayed_weights -> scale_by_adam | trace -> scale_by_schedule``;
- Adam as optax's ``scale_by_adam``: bias-corrected moments and
  ``m_hat / (sqrt(v_hat) + eps)``, eps 1e-7 by default;
- Poly ``((N - t) / N) ** 0.9`` stepped per update, and MultiStep dropping
  by 10 at epochs 22 and 42: the reference passes ``epoch - 1`` to the
  scheduler, so the drops lag the milestones 20 and 40 (``optim.py:13-21``).

``optimizer_state_from_jax`` / ``optimizer_state_to_jax`` map a JAX
``TrainState``'s optimizer state onto ``Optimizer.state_dict()`` and back,
for the JAX package's mid-stage snapshots (``engine/checkpoint.py``).

The schedule factor is computed on the host in f32, as the JAX schedule
computes it on the device, and handed to the update as a device scalar;
updates use ``torch._foreach`` ops, a few launches per step for all
parameters, and write the moments in place.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

BACKBONE_PREFIXES = ("backbone.", "encoder.")


def poly_factor(n_epochs: int, iters_per_epoch: int,
                power: float = 0.9) -> Callable[[int], float]:
    total = n_epochs * iters_per_epoch

    def factor(step: int) -> float:
        frac = np.float32(total - min(step, total)) / np.float32(total)
        return float(frac ** np.float32(power))

    return factor


def multistep_factor(iters_per_epoch: int, milestones=(20, 40),
                     gamma: float = 0.1) -> Callable[[int], float]:
    def factor(step: int) -> float:
        epoch = step // iters_per_epoch + 1  # 1-indexed current epoch
        n_drops = sum(int(epoch >= m + 2) for m in milestones)
        return float(np.float32(gamma) ** np.float32(n_drops))

    return factor


def schedule_factor(args, iters_per_epoch: int) -> Callable[[int], float]:
    if args.lr_scheduler_type == "Poly":
        return poly_factor(args.n_epochs, iters_per_epoch)
    if args.lr_scheduler_type == "MultiStepLR":
        return multistep_factor(iters_per_epoch)
    raise ValueError(args.lr_scheduler_type)


def param_group_table(args) -> Dict[str, dict]:
    """{backbone, heads} settings (``optim.py:62-84``)."""
    p = args.optimizer_params
    if args.optimizer_type == "Adam":
        base = dict(opt="adam", betas=p.get("betas", (0.9, 0.999)),
                    eps=p.get("eps", 1e-7), wd=p.get("weight_decay", 0.0))
        return {"backbone": dict(base, lr=p["lr"] / 10),
                "heads": dict(base, lr=p["lr"])}
    if args.optimizer_type == "SGD":
        wd = 1e-4 if (args.dataset_name == "voc"
                      and args.network_name == "FPN") else 5e-4
        base = dict(opt="sgd", momentum=p.get("momentum", 0.9), wd=wd)
        return {"backbone": dict(base, lr=1e-3), "heads": dict(base, lr=1e-2)}
    raise ValueError(args.optimizer_type)


class Optimizer:
    """The JAX package's optimizer chain over ``torch`` parameters.
    ``groups``: [(cfg, [params])]; ``factor(step)`` scales each group's lr,
    ``step`` counting updates from 0.

    An update is two parts. :meth:`prepare`, on the host, fills each
    group's device scalars (the step size, and Adam's two bias
    corrections) for update ``step_count``; :meth:`apply`, on the device,
    reads them and updates the parameters and the moments in place. So
    :meth:`apply` changes no host state and holds no number of the update
    count, and a CUDA graph of it serves every update; :meth:`step` is
    both and advances ``step_count``. The moment tensors are never
    replaced (:meth:`load_state_dict` writes into them), so a graph
    captured once keeps reading the live state."""

    def __init__(self, groups: List[tuple], factor: Callable[[int], float]):
        self.groups = [(cfg, [p for p in params if p.requires_grad])
                       for cfg, params in groups]
        self.factor = factor
        self.step_count = 0
        self.state = [
            {"mu": [torch.zeros_like(p) for p in ps],
             "nu": [torch.zeros_like(p) for p in ps]} if cfg["opt"] == "adam"
            else {"trace": [torch.zeros_like(p) for p in ps]}
            for cfg, ps in self.groups]
        self.scalars = [
            {k: torch.zeros((), device=ps[0].device)
             for k in self.scalar_values(cfg, 0)} if ps else {}
            for cfg, ps in self.groups]

    def zero_grad(self) -> None:
        for _, ps in self.groups:
            for p in ps:
                p.grad = None

    def lr(self, cfg: dict, step: int) -> float:
        """The f32 step size of update ``step``: ``-lr * factor(step)``."""
        return float(np.float32(-cfg["lr"]) * np.float32(self.factor(step)))

    def scalar_values(self, cfg: dict, step: int) -> Dict[str, float]:
        """The f32 values of a group's device scalars at update ``step``:
        ``lr``, and for Adam the bias corrections ``bc1 = 1 - b1 ** (step
        + 1)`` and ``bc2 = 1 - b2 ** (step + 1)``."""
        values = {"lr": self.lr(cfg, step)}
        if cfg["opt"] == "adam":
            b1, b2 = cfg["betas"]
            count = np.float32(step + 1)
            values["bc1"] = float(np.float32(1) - np.float32(b1) ** count)
            values["bc2"] = float(np.float32(1) - np.float32(b2) ** count)
        return values

    def prepare(self) -> None:
        """Fill the device scalars for update ``step_count`` (one small
        launch each, no sync)."""
        for (cfg, _), scalars in zip(self.groups, self.scalars):
            if scalars:
                for k, v in self.scalar_values(cfg,
                                               self.step_count).items():
                    scalars[k].fill_(v)

    @torch.no_grad()
    def apply(self) -> None:
        """One update of every parameter from the device scalars that
        :meth:`prepare` filled; a parameter without a gradient takes a
        zero one, as optax updates every leaf (weight decay and momentum
        still move it)."""
        for (cfg, ps), st, sc in zip(self.groups, self.state, self.scalars):
            if not ps:
                continue
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in ps]
            if cfg["wd"]:
                grads = torch._foreach_add(grads, ps, alpha=cfg["wd"])
            if cfg["opt"] == "adam":
                b1, b2 = cfg["betas"]
                # optax update_moment: (1 - decay) * g + decay * t
                mu, nu = st["mu"], st["nu"]
                torch._foreach_mul_(mu, b1)
                torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
                sq = torch._foreach_mul(grads, grads)
                torch._foreach_mul_(nu, b2)
                torch._foreach_add_(nu, torch._foreach_mul(sq, 1 - b2))
                denom = torch._foreach_add(
                    torch._foreach_sqrt(torch._foreach_div(nu, sc["bc2"])),
                    cfg["eps"])
                upd = torch._foreach_div(torch._foreach_div(mu, sc["bc1"]),
                                         denom)
            else:
                upd = st["trace"]
                torch._foreach_mul_(upd, cfg["momentum"])
                torch._foreach_add_(upd, grads)
            torch._foreach_add_(ps, torch._foreach_mul(upd, sc["lr"]))

    def step(self) -> None:
        """One whole update: :meth:`prepare`, :meth:`apply`, and the count
        advanced."""
        self.prepare()
        self.apply()
        self.step_count += 1

    def state_dict(self) -> dict:
        """The update count and a copy of each group's moment lists, on
        the CPU: the moments change in place with every update."""
        return {"step_count": self.step_count,
                "state": [{k: [t.detach().to("cpu", copy=True) for t in ts]
                           for k, ts in st.items()} for st in self.state]}

    def load_state_dict(self, sd: dict) -> None:
        """Install a ``state_dict``, written into the moment tensors there
        are (a CUDA graph of :meth:`apply` reads them where they lie);
        nothing is written unless every tensor fits."""
        if len(sd["state"]) != len(self.state):
            raise ValueError(f"{len(sd['state'])} optimizer groups saved, "
                             f"{len(self.state)} here")
        for (_, ps), st, saved in zip(self.groups, self.state, sd["state"]):
            if set(saved) != set(st) or any(len(v) != len(ps)
                                            for v in saved.values()):
                raise ValueError(f"optimizer state {sorted(saved)} of "
                                 f"{[len(v) for v in saved.values()]} "
                                 f"tensors does not fit {sorted(st)} of "
                                 f"{len(ps)} parameters")
            for k, v in saved.items():
                for t, own in zip(v, st[k]):
                    if tuple(t.shape) != tuple(own.shape):
                        raise ValueError(
                            f"optimizer state {k}: a saved tensor of shape "
                            f"{tuple(t.shape)} for one of "
                            f"{tuple(own.shape)}")
        for st, saved in zip(self.state, sd["state"]):
            for k, v in saved.items():
                for own, t in zip(st[k], v):
                    own.copy_(t)
        self.step_count = int(sd["step_count"])


GROUPS = ("backbone", "heads")


def group_param_names(model: torch.nn.Module) -> List[List[str]]:
    """The trained parameters' names of each group, in ``GROUPS`` order and
    in the order the optimizer holds them."""
    names: Dict[str, List[str]] = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        if p.requires_grad:
            names["backbone" if name.startswith(BACKBONE_PREFIXES)
                  else "heads"].append(name)
    return [names[g] for g in GROUPS]


def make_optimizer(args, model: torch.nn.Module,
                   iters_per_epoch: int) -> Optimizer:
    table = param_group_table(args)
    params = dict(model.named_parameters())
    return Optimizer([(table[g], [params[n] for n in names])
                      for g, names in zip(GROUPS,
                                          group_param_names(model))],
                     schedule_factor(args, iters_per_epoch))


# JAX's optimizer state (``pixelpick_tpu/engine/optim.py:90-115``) is
# ``multi_transform({"backbone", "heads"})`` of ``chain(add_decayed_weights,
# scale_by_adam | trace, scale_by_schedule)``; in ``flax.serialization.
# to_state_dict`` layout each group's ``inner_state`` is ``{"0": {}, "1":
# {"count", "mu", "nu"} | {"trace"}, "2": {"count"}}``, each moment a tree of
# the whole params in which the other group's leaves are masked (``{}``).

def optimizer_state_from_jax(opt_state: dict, step, model: torch.nn.Module,
                             optimizer: Optimizer) -> dict:
    """A JAX ``TrainState``'s ``opt_state`` and ``step`` (numpy trees) ->
    ``optimizer.load_state_dict``'s argument. The moments map through the
    weight bridge's key table (``models/convert.py``) into each group's
    parameter order; Adam's count, each schedule's count and ``step`` must
    agree, and become ``step_count``."""
    from pixelpick_tpu_torch.models.convert import state_dict_from_jax

    params = dict(model.named_parameters())
    counts = {"TrainState.step": int(np.asarray(step))}
    state = []
    for g, (cfg, _), names in zip(GROUPS, optimizer.groups,
                                  group_param_names(model)):
        inner = opt_state["inner_states"][g]["inner_state"]
        counts[f"{g} schedule count"] = int(np.asarray(inner["2"]["count"]))
        scale = inner["1"]
        if cfg["opt"] == "adam":
            counts[f"{g} adam count"] = int(np.asarray(scale["count"]))
        group = {}
        for key in ("mu", "nu") if cfg["opt"] == "adam" else ("trace",):
            if key not in scale:
                raise ValueError(f"JAX optimizer state of group {g} has no "
                                 f"{key!r} ({sorted(scale)}): another "
                                 f"optimizer than {cfg['opt']}")
            sd = state_dict_from_jax(scale[key], {})
            if set(sd) != set(names):
                raise ValueError(
                    f"JAX {g}/{key} holds {len(sd)} leaves, the port's group "
                    f"{len(names)}: {sorted(set(sd) ^ set(names))[:5]}")
            for n in names:
                if sd[n].shape != params[n].shape:
                    raise ValueError(f"JAX {g}/{key} {n}: shape "
                                     f"{tuple(sd[n].shape)}, the port's "
                                     f"{tuple(params[n].shape)}")
            group[key] = [sd[n] for n in names]
        state.append(group)
    if len(set(counts.values())) != 1:
        raise ValueError(f"the JAX snapshot's step counts disagree: {counts}")
    return {"step_count": counts["TrainState.step"], "state": state}


def optimizer_state_to_jax(optimizer: Optimizer, model: torch.nn.Module
                           ) -> Tuple[dict, np.ndarray]:
    """The inverse: ``(opt_state, step)`` in JAX's layout, numpy trees."""
    from pixelpick_tpu_torch.models.convert import jax_tree_from_state_dict

    count = np.asarray(optimizer.step_count, np.int32)
    own = model.state_dict()

    def masked(tree):
        return {k: masked(v) if isinstance(v, dict) else {}
                for k, v in tree.items()}

    inner_states = {}
    for g, (cfg, _), names, st in zip(GROUPS, optimizer.groups,
                                      group_param_names(model),
                                      optimizer.state):
        scale = {"count": count} if cfg["opt"] == "adam" else {}
        for key, tensors in st.items():
            # the moments in the parameters' places, so that the bridge
            # tells a BatchNorm's scale from a GroupNorm's by its buffers
            sd = dict(own)
            sd.update(zip(names, tensors))
            tree = jax_tree_from_state_dict(sd)[0]
            scale[key] = {top: sub if (top in ("backbone", "encoder"))
                          == (g == "backbone") else masked(sub)
                          for top, sub in tree.items()}
        inner_states[g] = {"inner_state": {"0": {}, "1": scale,
                                           "2": {"count": count}}}
    return {"inner_states": inner_states}, count
