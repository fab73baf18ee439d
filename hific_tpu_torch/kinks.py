"""One run's side of every ReLU kink and straight-through rounding, imposed
on another run of the same model: support for holding the port against
its plain versions (card against CPU) and against the JAX package.

A ReLU input within rounding of 0 falls on either side on two devices or
in two stacks, and in a tiny model one such element moves the gradients of
the layers before it by a few tenths of a percent of their largest; so
does a latent within rounding of a half-integer, whose straight-through
rounding then differs by 1. Comparing two runs' gradients therefore needs
both runs to take the same side there, and a check that each such element
was a tie and not a different value.
"""

import contextlib
from typing import Dict, List, Tuple

import torch

from hific_tpu_torch.models import hyperprior as hyperprior_module
from hific_tpu_torch.models.layers import Norm
from hific_tpu_torch.ops.channel_norm import instance_norm
from hific_tpu_torch.ops.fused_norm import channel_norm_fused_reference


def _pre_activation(module, x: torch.Tensor) -> torch.Tensor:
    """The input of the module's ReLU: x itself for `nn.ReLU`, else the
    norm's output before its fused ReLU, by the plain version."""
    if isinstance(module, torch.nn.ReLU):
        return x
    if module.norm_type == "instance":
        return instance_norm(x, module.gamma.to(x.dtype),
                             module.beta.to(x.dtype))
    return channel_norm_fused_reference(x, module.gamma, module.beta)


def _tie_distance(v: torch.Tensor) -> torch.Tensor:
    """Distance of v from the nearest half-integer, of max(|v|, 1)."""
    return (v - torch.floor(v) - 0.5).abs() / v.abs().clamp_min(1.0)


class KinkSides:
    """Each ReLU's side and each rounding of one run, and a run that takes
    them.

    Every hooked run keeps, by module name, each ReLU's side (its output
    > 0) and pre-activation (float32, on the CPU; the norms with a fused
    ReLU and the `nn.ReLU` modules), and the input of each straight-through
    rounding, in call order: `side`, `pre` and `rounding`. A caller may
    fill them from another stack instead (the JAX package's ReLU outputs
    will do for `side` and `pre`: only their signs and magnitudes are
    read). `imposing(model, recorded)` hooks a run that keeps its own as
    above, and takes the recorded run's side of every ReLU it has (its
    pre-activation times the recorded mask) and the recorded rounding of
    every latent, when one is recorded. `apart` then lists, per layer, the
    elements the two runs decided apart and how near the tie each was;
    `check` bounds it."""

    def __init__(self):
        self.side: Dict[str, torch.Tensor] = {}
        self.pre: Dict[str, torch.Tensor] = {}
        self.rounding: List[torch.Tensor] = []
        # name -> (count, largest max(|a|, |recorded|) among them, largest
        # |a| of the layer); "rounding" -> (count, largest distance of
        # either side from the half-integer, 1)
        self.apart: Dict[str, Tuple[int, float, float]] = {}

    @contextlib.contextmanager
    def hooked(self, model, recorded: "KinkSides" = None):
        """Keep this run's sides; with `recorded`, take its decisions."""

        def hook(name):
            def fn(module, inputs, output):
                pre = _pre_activation(module, inputs[0])
                side = output > 0
                self.side[name] = side.cpu()
                self.pre[name] = pre.detach().float().cpu()
                if recorded is None or name not in recorded.side:
                    return None
                want = recorded.side[name].to(pre.device)
                flips = want != side
                if bool(flips.any()):
                    a = self.pre[name].abs()
                    b = recorded.pre[name].abs()
                    near = torch.maximum(a, b)[flips.cpu()].max()
                    self._add(name, int(flips.sum()), float(near),
                              float(a.max()))
                return pre * want.to(pre.dtype)
            return fn

        real_ste = hyperprior_module.quantize_ste
        calls = iter(range(10 ** 6))

        def ste(x, means=None):
            v = x if means is None else x - means
            r = torch.floor(v + 0.5)
            self.rounding.append(v.detach().float().cpu())
            if recorded is not None and recorded.rounding:
                theirs = recorded.rounding[next(calls)]
                want = torch.floor(theirs + 0.5).to(r.device, r.dtype)
                flips = want != r
                if bool(flips.any()):
                    mask = flips.cpu()
                    near = torch.maximum(_tie_distance(self.rounding[-1]),
                                         _tie_distance(theirs))[mask].max()
                    self._add("rounding", int(flips.sum()), float(near), 1.0)
                r = want
            out = v + (r - v).detach()
            return out if means is None else out + means

        handles = [m.register_forward_hook(hook(n))
                   for n, m in model.named_modules()
                   if isinstance(m, torch.nn.ReLU)
                   or (isinstance(m, Norm) and m.activation == "relu")]
        hyperprior_module.quantize_ste = ste
        try:
            yield self
        finally:
            hyperprior_module.quantize_ste = real_ste
            for h in handles:
                h.remove()

    def _add(self, name: str, count: int, near: float, top: float) -> None:
        n, far, t = self.apart.get(name, (0, 0.0, top))
        self.apart[name] = (n + count, max(far, near), max(t, top))

    def check(self, rel: float) -> None:
        """Every element decided apart lies within `rel` of the kink on
        both sides (of the layer's largest |pre-activation|), or within
        `rel` of the half-integer (of the value's magnitude)."""
        bad = {n: f for n, f in self.apart.items() if f[1] > rel * f[2]}
        if bad:
            raise AssertionError(
                f"ties decided apart beyond {rel:g} (layer: count, nearest "
                f"the tie, the layer's largest |pre-activation|): {bad}")

    def summary(self) -> str:
        if not self.apart:
            return "no ReLU or rounding decided apart"
        return (f"decided apart and taken from the recorded run (layer: "
                f"count, nearest the tie, the layer's largest "
                f"|pre-activation|): {self.apart}")
