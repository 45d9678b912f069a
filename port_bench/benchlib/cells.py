"""A cell as the program runs it: one configuration under one traffic mix,
built for one run's seed by the traffic's step kind
(``port_bench/kinds/<kind>.py``, found by the traffic file's ``kind``)
through the program's own builders (the ones its command line uses).

The kind declares what is its own: its seeded batches, the models it
builds and the step the window drives. The cell holds what every kind
shares: the program's settings, the pool of batches the window cycles,
weights made from the seed and loaded under the reference key names, the
same weights made again for the reference, reseeding, and teardown.
"""

from __future__ import annotations

import functools
import gc
from types import ModuleType
from typing import Dict, List

import torch

from port_bench.benchlib import inputs

# What teardown keeps: the cell's settings, not the program's objects.
_KEPT = ("traffic", "seed", "device", "kind", "cfg", "templates")


def modules_of(fn) -> List[torch.nn.Module]:
    """The ``nn.Module`` objects a callable closes over: a bound method's
    object, a partial's arguments, a closure's cells, recursively."""
    seen, out, stack = set(), [], [fn]
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, torch.nn.Module):
            out.append(obj)
        elif isinstance(obj, functools.partial):
            stack += [obj.func, *obj.args, *obj.keywords.values()]
        elif hasattr(obj, "__self__") and hasattr(obj, "__func__"):
            stack += [obj.__self__, obj.__func__]
        elif callable(obj) and getattr(obj, "__closure__", None):
            stack += [c.cell_contents for c in obj.__closure__]
    return out


def template(module: torch.nn.Module) -> Dict[str, torch.Size]:
    return {k: v.shape for k, v in module.state_dict().items()}


class Cell:
    """One configuration under one traffic mix, built for run ``seed`` on
    ``device`` by step kind ``kind`` (the traffic's kind module,
    ``Manifest.kind``). ``step(i)`` is the call the window drives; ``cfg``
    the program's settings (``configure``)."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str, kind: ModuleType):
        self.traffic, self.seed, self.device = traffic, int(seed), device
        self.kind = kind
        self.tags: Dict[str, torch.nn.Module] = {}
        self.pool = self._pool()
        self.step = self.kind.build(self, config)
        self.templates = {k: template(m) for k, m in self.tags.items()}

    def configure(self, config: Dict, **settings):
        """The program's settings: the configuration's command-line ones
        (``config["cli"]``) on this cell's device, with ``settings`` over
        them."""
        from master_thesis_tpu_torch.config import Config

        self.cfg = Config(**{**config["cli"], "device": self.device, **settings})
        return self.cfg

    def _pool(self) -> List:
        """The batches the window cycles through, made from the seed."""
        return [self.kind.batch(self.seed, i, self.traffic, self.device) for i in range(self.traffic["pool"])]

    # ------------------------------------------------------------ weights

    def _load(self, tag: str, module: torch.nn.Module) -> None:
        """Loads weights made from the seed into ``module`` as a checkpoint
        is loaded (``load_state_dict`` under the reference key names)."""
        module.load_state_dict(inputs.weights(template(module), self.seed, tag, self.device))
        self.tags[tag] = module

    def reference_weights(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The same weights again, for the reference: made anew from the
        seed, not read from the program."""
        return {tag: inputs.weights(tpl, self.seed, tag, self.device) for tag, tpl in self.templates.items()}

    def reseed(self, seed: int) -> None:
        """The same built cell with run ``seed``'s weights and batches, and
        what the kind makes anew for a seed (``kind.reseed``): for readings
        over many seeds in one process. Packed kernel weights follow the
        parameters' versions."""
        self.seed = int(seed)
        self.pool = self._pool()
        for tag, module in list(self.tags.items()):
            self._load(tag, module)
        self.kind.reseed(self)

    # ------------------------------------------------------------ teardown

    def free(self) -> None:
        """Drops the program's models, state and closures, and the pool."""
        for name in [k for k in self.__dict__ if k not in _KEPT]:
            del self.__dict__[name]
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
