"""A cell as the program runs it: the models built by the program's own
builders (the ones its command line uses), loaded with weights made from
the seed under the reference key names, the step the window drives, and
the outputs kept for the check.

Serving (``kind: serve``): the aligner from ``__main__.build_aligner``
and ``train.build.chn_infer_fn(chn, kernels=build.use_kernels(cfg))``,
the two calls ``Inpainter._refine`` makes each round, under
``torch.inference_mode``; one client, a step of ``batch`` targets each
with ``refs`` references, ending when its outputs are ready.

Training (``kind: chn_train``): the train step and state as
``__main__.run_chn_train`` assembles them (``make_train_step``,
``create_train_state`` with the command line's optimizer settings);
seeded device batches take the loader's place. Set-up drives the state
through its first ``checked_steps`` steps, on batches that all differ, and
reads what the check compares: each step's loss items and aligned
references, the first step's ``y_hat``, the first gradient as Adam holds
it after one step, and each parameter's change after the last. The
aligner and the CHN reach the train step through :class:`Recorder`, which
keeps their outputs while set-up asks it to and passes them on untouched.
"""

from __future__ import annotations

import functools
import gc
from typing import Dict, List

import torch

from port_bench.benchlib import inputs

ADAM_BETA1 = 0.9


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


class Recorder:
    """Calls ``fn``; while ``kept`` is a list, appends a detached copy of
    each call's outputs to it, on the host."""

    def __init__(self, fn):
        self.fn, self.kept = fn, None

    def __call__(self, *args):
        out = self.fn(*args)
        if self.kept is not None:
            self.kept.append(tuple(o.detach().cpu() for o in out))
        return out


def template(module: torch.nn.Module) -> Dict[str, torch.Size]:
    return {k: v.shape for k, v in module.state_dict().items()}


class Cell:
    """One configuration under one traffic mix, built for run ``seed`` on
    ``device``, with the configuration's command-line settings
    (``config["cli"]``)."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str = "cuda"):
        from master_thesis_tpu_torch.config import Config

        self.traffic, self.seed, self.device = traffic, int(seed), device
        self.kind = traffic["kind"]
        settings = {**config["cli"], "device": device}
        if self.kind == "serve":
            settings["chn_aligner"] = config["aligner"]
        self.cfg = Config(**settings)
        self.tags: Dict[str, torch.nn.Module] = {}
        self.pool = self._pool()
        getattr(self, f"_build_{self.kind}")()

    def _pool(self) -> List:
        """The batches the window cycles through, made from the seed."""
        return [inputs.BATCHES[self.kind](self.seed, i, self.traffic, self.device)
                for i in range(self.traffic["pool"])]

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
        """The same built cell with run ``seed``'s weights and batches (and,
        training, a fresh train state): for readings over many seeds in one
        process. Packed kernel weights follow the parameters' versions."""
        self.seed = int(seed)
        self.pool = self._pool()
        for tag, module in list(self.tags.items()):
            self._load(tag, module)
        if self.kind != "serve":
            self._train_state(self.model)

    # ------------------------------------------------------------ serving

    def _build_serve(self) -> None:
        from master_thesis_tpu_torch import __main__ as cli
        from master_thesis_tpu_torch.train import build

        cfg = self.cfg
        vgg = build.build_vgg(cfg, cfg.vgg_checkpoint) if cfg.chn_aligner == "dfpn" else None
        self.align_fn = cli.build_aligner(cfg, vgg)
        chn = build.build_chn(cfg).requires_grad_(False).eval()
        self.chn_fn = build.chn_infer_fn(chn, kernels=build.use_kernels(cfg))
        aligner = [m for m in modules_of(self.align_fn) if type(m).__name__ in ("CPN", "DFPN")]
        if len(aligner) != 1:
            raise RuntimeError(f"the aligner closes over {len(aligner)} CPN / DFPN modules, not 1")
        self._load(cfg.chn_aligner, aligner[0])
        if vgg is not None:
            self._load("vgg", vgg)
        self._load("chn", chn)
        self.templates = {k: template(m) for k, m in self.tags.items()}
        self.spans = None

    def serve_step(self, i: int):
        """Step ``i``: the aligner, then the CHN, on pool batch ``i %
        pool``. With ``spans`` (a list) records CUDA events around both."""
        x_t, m_t, x_r, m_r = self.pool[i % len(self.pool)]
        with torch.inference_mode():
            if self.spans is not None:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
            xa, va, vm = self.align_fn(x_t, m_t, x_r, m_r)
            if self.spans is not None:
                ev[1].record()
            y_hat, y_comp = self.chn_fn(x_t, 1 - m_t, xa, va, vm)
            if self.spans is not None:
                ev[2].record()
                self.spans.append(ev)
        return xa, va, vm, y_hat, y_comp

    # ------------------------------------------------------------ training

    def _build_chn_train(self) -> None:
        from master_thesis_tpu_torch import __main__ as cli
        from master_thesis_tpu_torch.train import build, chn_task

        cfg = self.cfg
        vgg = build.build_vgg(cfg, cfg.vgg_checkpoint)
        self.aligner = Recorder(cli.build_aligner(cfg, vgg))
        chn = build.build_chn(cfg)
        self.chn_apply = Recorder(build.chn_train_fn(cfg, chn))
        self.train_step = chn_task.make_train_step(
            chn, self.aligner, vgg, perceptual_grad=cfg.perceptual_grad, chn_apply=self.chn_apply)
        aligner = [m for m in modules_of(self.aligner.fn) if type(m).__name__ == "CPN"]
        if len(aligner) != 1:
            raise RuntimeError(f"the aligner closes over {len(aligner)} CPN modules, not 1")
        self._load("cpn", aligner[0])
        self._load("vgg", vgg)
        self._load("chn", chn)
        self._train_state(chn)

    def _train_state(self, model: torch.nn.Module) -> None:
        from master_thesis_tpu_torch.train.state import create_train_state

        model.train()
        self.model = model
        self.state = create_train_state(model, self.cfg, steps_per_epoch=self.cfg.train_max_iterations)
        self.templates = {k: template(m) for k, m in self.tags.items()}

    def train(self, i: int):
        return self.train_step(self.state, *self.pool[i % len(self.pool)])

    def first_steps(self) -> Dict[str, object]:
        """Steps 0 .. ``checked_steps - 1`` through the window's own call, on
        pool batches that all differ: each step's loss items and aligned
        references, the first step's ``y_hat``, the first gradient's norm
        by leaf (Adam's first moment after one update over ``1 - beta1``),
        and each leaf's change after the last step."""
        n = self.traffic["checked_steps"]
        if n > len(self.pool):
            raise ValueError(f"{n} checked steps need as many distinct batches; the pool has {len(self.pool)}")
        names = {id(p): k for k, p in self.model.named_parameters()}
        steps, grad0 = [], {}
        self.aligner.kept, self.chn_apply.kept = [], []
        for i in range(n):
            items = self.train(i)
            steps.append({k: float(v) for k, v in items.items()})
            if i == 0:
                grad0 = {names[id(p)]: float(torch.linalg.vector_norm(s["exp_avg"])) / (1 - ADAM_BETA1)
                         for p, s in self.state.optimizer.state.items()}
        aligned, y0 = self.aligner.kept, self.chn_apply.kept[0][0]
        self.aligner.kept = self.chn_apply.kept = None
        start = inputs.weights(self.templates["chn"], self.seed, "chn", self.device)
        with torch.no_grad():
            change = {k: float(torch.linalg.vector_norm(p.detach() - start[k]))
                      for k, p in self.model.named_parameters()}
        del start
        return {"steps": steps, "grad0": grad0, "change": change, "aligned": aligned, "y0": y0}

    # ------------------------------------------------------------ teardown

    def free(self) -> None:
        """Drops the program's models, state and closures, and the pool."""
        for name in ("align_fn", "chn_fn", "aligner", "chn_apply", "train_step", "state", "model", "tags", "pool",
                     "spans"):
            self.__dict__.pop(name, None)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
