"""The training loop of a ``train`` mix: the port's device route as
``trainer.train`` builds it (``DevicePipeline`` under
``DevicePipelineStep``, s from ``trainer.steps_per_group``), one group
call after another in a closed loop, the logs flushed every
``log_interval`` steps as the trainer flushes them.

Set-up draws the triples and the tables from the seed and makes the
first group call (eager, on the capture stream), the second (the capture
and the first replay) and the third (the second replay), keeping host
copies of the tables and their Adagrad states where ``check.marks`` asks
and the losses of the first and third calls; then groups until
``warm_seconds`` have passed.  The same objects then run the window."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from kgbench import check
from kgbench.generator import make_triples
from kgbench.loops.common import (init_state, port_config, quiet, release,
                                  sync, to_host)
from kgbench.reference import streams, train_steps
from kgbench.seeds import run_seed
from kgbench.spec import PACKAGE, load_module
from kgbench.trace import Spans, profile_window


class Run:
    def __init__(self, cell, seed: int, device, spans: Spans):
        self.cell, self.seed, self.spans = cell, seed, spans
        self.device = torch.device(device)
        self.flags = cell.config["flags"]
        self.snap: dict = {}
        self.failed = 0         # steps whose loss is not finite
        self.ctx: dict = {"flags": self.flags, "counts": cell.counts()}

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from dglke_tpu_torch import trainer
        from dglke_tpu_torch.data.dataset import KGDataset
        from dglke_tpu_torch.models.ke_model import KEModel
        from dglke_tpu_torch.models.pipeline_step import DevicePipelineStep
        conf = self.cell.config
        self.triples = make_triples(conf, self.cell.traffic,
                                    self.seed)["train"]
        cfg = self.cfg = port_config(conf, self.seed)
        ds = KGDataset(name=conf["name"], n_entities=conf["n_entities"],
                       n_relations=conf["n_relations"], train=self.triples)
        self.model = KEModel(cfg, ds.n_entities, ds.n_relations,
                             device=self.device)
        self.state = init_state(self.model, self.seed)
        self.s = trainer.steps_per_group(cfg, ds.n_train, True, log=quiet)
        if self.s < 3:
            raise ValueError(f"a group of {self.s} steps: the check reads "
                             f"the first three steps of the first group call")
        self.feed = trainer.DevicePipeline(
            self.model, ds, cfg.batch_size,
            cfg.num_chunks * cfg.neg_sample_size, seed=cfg.seed)
        self.fused = DevicePipelineStep(self.model, self.feed, self.s)
        self.marks = check.marks(self.s)
        self.snap["loss"] = {}
        self._keep(0)
        self.pending: list = []
        for call in range(3):
            first = self.feed.step_idx
            logs = (self.fused(self.state, self._snapshot) if call == 0
                    else self.fused(self.state))[1]
            total = logs["loss"] + logs.get("regularization", 0.0)
            self.snap["loss"].update(enumerate(total.tolist(), first))
            self._keep(self.feed.step_idx)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.cell.traffic["warm_seconds"]:
            self._group()
        self._flush()
        sync(self.device)

    def _keep(self, k: int) -> None:
        """Host copies of every table the port's TrainState holds and of
        their Adagrad states, in the reference's order (entity, relation,
        TransR's projection), if the check reads them after ``k`` steps."""
        if k in self.marks and k not in self.snap:
            st = self.state
            tables = [t for t in (st.entity, st.relation, st.projection)
                      if t is not None]
            self.snap[k] = {"w": [to_host(t.emb) for t in tables],
                            "s": [to_host(t.state_sum) for t in tables]}

    def _snapshot(self, *steps):
        """The span the first (eager) call wraps each step in: the copies
        ``_keep`` takes, after each step that ``check.marks`` names."""
        if len(steps) != 1 or steps[0] + 1 not in self.marks:
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def after():
            yield
            self._keep(steps[0] + 1)
        return after()

    def _group(self, spans=None) -> None:
        prev = self.feed.step_idx
        with (spans or self.spans)("kgbench.group"):
            self.pending.append(self.fused(self.state)[1])
        interval = self.cfg.log_interval
        if self.feed.step_idx // interval > prev // interval:
            with (spans or self.spans)("kgbench.flush"):
                self._flush()

    def _flush(self) -> None:
        """The trainer's log flush (each key's mean, read on the host),
        also counting the steps whose loss is not finite."""
        if not self.pending:
            return
        keys = list(self.pending[0])
        vals = {k: torch.cat([p[k].reshape(-1) for p in self.pending])
                for k in keys}
        means = torch.stack([vals[k].mean() for k in keys] + [
            (~torch.isfinite(vals["loss"])).sum().float()])
        self.failed += int(means.tolist()[-1])
        self.pending = []

    # -- window ---------------------------------------------------------
    def window(self, seconds: float) -> dict:
        self.failed = 0
        first = self.feed.step_idx
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._group()
        self._flush()
        sync(self.device)
        elapsed = time.perf_counter() - t0
        steps = self.feed.step_idx - first
        self.ctx["group_ms"] = [1e3 * x for x in
                                self.spans.seconds.get("kgbench.group", [])]
        return {"attempted": steps, "failed": self.failed,
                "train_triples_per_s": steps * self.cfg.batch_size / elapsed}

    def program_window(self) -> dict:
        """``trace_groups`` group calls with the port's own spans on
        (``dglke_tpu_torch.tracing``) and the harness's off, unprofiled;
        their snapshot goes to ``ctx["program"]``."""
        from dglke_tpu_torch import tracing
        quiet_spans = Spans(False)
        tracing.start()
        try:
            for _ in range(self.cell.traffic["trace_groups"]):
                self._group(quiet_spans)
            self._flush()
            self.ctx["program"] = tracing.snapshot()
        finally:
            tracing.stop()
        return self.ctx["program"]

    def traced(self):
        """A profiled sub-window of ``trace_groups`` groups, reduced in
        memory; also each traced step's kernel bytes and operations."""
        first = []

        def body(spans):
            first[:] = [self.feed.step_idx]
            for _ in range(self.cell.traffic["trace_groups"]):
                self._group(spans)
            self._flush()

        summary = profile_window(self.device, body)
        self.ctx["trace"] = summary
        self.ctx["steps"] = self.feed.step_idx - first[0]
        self.ctx["kernels"] = self._kernel_counts(first[0],
                                                  self.feed.step_idx)
        return summary

    def _kernel_counts(self, first: int, last: int) -> dict:
        """{kernel: (bytes, operations)} summed over steps [first, last),
        their distinct ids drawn again from the seed."""
        counts = self.cell.counts()
        trip = torch.as_tensor(np.stack(self.triples), device=self.device)
        b = self.cfg.batch_size
        batches = streams.Batches(
            run_seed(self.seed), trip, b,
            self.cfg.num_chunks * self.cfg.neg_sample_size,
            self.cell.config["n_entities"])
        total: dict = {}
        for step in range(first, last):
            h, r, t, neg, _ = batches(step)
            ent = torch.unique(torch.cat([h, t, neg.long()])).numel()
            rel = torch.unique(r).numel()
            for k, (nb, nf) in counts.kernel_bytes(self.flags, ent,
                                                    rel).items():
                ob, of = total.get(k, (0.0, 0.0))
                total[k] = (ob + nb, of + nf)
        return total

    def release(self) -> None:
        for name in ("fused", "feed", "state", "model"):
            setattr(self, name, None)
        release(self.device)

    # -- check ----------------------------------------------------------
    def check(self) -> dict:
        """The training numbers of check.py against the reference.  The
        program's readings are taken first and its copies dropped, so that
        the two sides' copies of a large table are never held at once."""
        lr = self.flags["lr"]
        self.prog_readings = check.train_readings(self.snap, lr, self.s,
                                                  self.device)
        self.snap = {}
        family = load_module(PACKAGE / "reference" / f"{self.cell.family}.py")
        trip = torch.as_tensor(np.stack(self.triples), device=self.device)
        ref = train_steps.run(family, self.cell.config, trip,
                              run_seed(self.seed), self.marks,
                              to_host=to_host)
        del trip
        self.ref_readings = check.train_readings(ref, lr, self.s,
                                                 self.device)
        return check.train_numbers(self.prog_readings, self.ref_readings)
