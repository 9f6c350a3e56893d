"""Training: a closed loop of steps of the port's ``make_train_step`` (AdamW,
remat, the MoE link states carried across steps), fed by the port's
``DataPipeline`` (packing, prefetch thread, its link) from the traffic's
document stream.

Set-up builds the one train state from the seed's weights and takes its
first ``check_steps`` steps through the same call and feed as the window,
recording each step's loss, the first gradient as the optimizer got it
(from its first moment) and, after the last, each leaf's change against a
fresh draw of the start; that gradient and the weights after the checked
steps are kept on the host for the reference to hold them to.  The window then runs steps for the given
seconds; a step's tokens count when the device has finished it.  The
traced run profiles ``traced_steps`` more steps after the window.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from h100bench.lib import checks, program, trace, weights
from h100bench.lib import traffic as trafficmod
from h100bench.lib.cell import Run
from h100bench.reference import train as reftrain


class Driver:
    kind = "train"

    def __init__(self, run: Run):
        self.run = run
        self.dev = run.device

    # ------------------------------------------------------------------ #

    def setup(self) -> None:
        from repro_torch.data.pipeline import DataConfig, DataPipeline
        from repro_torch.models.model_api import build
        from repro_torch.optim.optimizers import OptimizerConfig, opt_init
        from repro_torch.train.step import make_train_step

        run, doc, mix = self.run, self.run.doc, self.run.mix
        model_doc = doc["model"]
        self.model = build(program.arch_config(model_doc))
        ctx = program.spmd_ctx(doc)
        params = weights.make_params(model_doc, doc["init"], mix, run.seed, self.dev)
        weights.check_layout(params, self.model.specs())
        self.opt_cfg = OptimizerConfig(**doc["optimizer"])
        state = {"params": params, "opt": opt_init(self.opt_cfg, params),
                 "step": torch.zeros((), dtype=torch.int32, device=self.dev)}
        dk = self.model.dyskew_init(ctx, self.dev)
        if dk is not None:
            state["dyskew"] = dk
        self.step = make_train_step(self.model, self.opt_cfg, ctx=ctx)
        self.B, self.S = int(mix["batch"]), int(mix["seq_len"])
        self.pipe = DataPipeline(DataConfig(
            vocab_size=model_doc["vocab_size"], seq_len=self.S, global_batch=self.B,
            num_shards=int(mix["num_shards"]), prefetch=int(mix["prefetch"])), device=self.dev)
        self.pipe.docs = trafficmod.documents(run.seed, mix, model_doc["vocab_size"])
        self.pipe.start()

        self.rows: List[np.ndarray] = []
        self.prog = {"loss": []}
        for i in range(int(mix["check_steps"])):
            batch = next(self.pipe)
            self.rows.append(np.array(batch["tokens"], copy=True))
            state, metrics = self.step(state, batch)
            self.prog["loss"].append(float(metrics["loss"]))
            if i == 0:
                # The gradient as the optimizer got it: m = (1 - b1) g after one step.
                self.prog["grad"], self.prog["grad_t"] = {}, {}
                for p, m in weights.flatten(state["opt"]["m"]):
                    g = m / (1 - self.opt_cfg.b1)
                    self.prog["grad"][p] = float(torch.linalg.vector_norm(g))
                    self.prog["grad_t"][p] = g.to("cpu")
                    del g
        self.prog["change"] = {}
        self.prog["params_t"] = {}
        for p, t in weights.flatten(state["params"]):
            self.prog["params_t"][p] = t.to("cpu")
            start = weights.make_leaf(model_doc, doc["init"], mix, run.seed, p, self.dev, t.dtype)
            self.prog["change"][p] = float(torch.linalg.vector_norm(t.float() - start.float()))
            del start
        self.state = state
        program.sync(self.dev)

    def _one(self, sums: Dict[str, torch.Tensor], traced: bool) -> None:
        t0 = time.perf_counter()
        with trace.span("data_wait", traced):
            batch = next(self.pipe)
        self.run.spans.setdefault("data_wait_traced" if traced else "data_wait", []).append(time.perf_counter() - t0)
        with trace.span("train_step", traced):
            self.state, metrics = self.step(self.state, batch)
        for k in ("loss", "moe_dropped_frac", "moe_shard_imbalance", "moe_distribute_frac"):
            if k in metrics:
                v = metrics[k].detach().float()
                sums[k] = sums[k] + v if k in sums else v
        bad = (~torch.isfinite(metrics["loss"])).to(torch.int32)
        sums["nonfinite"] = sums["nonfinite"] + bad if "nonfinite" in sums else bad

    def window(self, t_start: float) -> None:
        run = self.run
        sums: Dict[str, torch.Tensor] = {}
        n = 0
        while True:
            self._one(sums, False)
            n += 1
            if time.perf_counter() - t_start >= run.seconds:
                break
        program.sync(self.dev)
        run.window_s = time.perf_counter() - t_start
        tokens = n * self.B * self.S
        run.end_to_end["train_tokens_per_s"] = tokens / run.window_s
        run.readings.update(steps=n, tokens=tokens, window_s=run.window_s,
                            **{f"window_mean_{k}": float(v) / n for k, v in sums.items() if k != "nonfinite"})
        run.attempted, run.failed = n, int(sums["nonfinite"])
        run.traced_info["window_steps"] = n

    def traced(self) -> None:
        run = self.run
        steps = int(run.mix["traced_steps"])
        sums: Dict[str, torch.Tensor] = {}
        program.reset_launch_counts()
        program.sync(self.dev)
        with trace.profiled(self.dev.type) as out:
            with trace.span("traced", True):
                for _ in range(steps):
                    self._one(sums, True)
                program.sync(self.dev)
        run.traced = out[0]
        run.traced_info.update(steps=steps, tokens=steps * self.B * self.S, batch=self.B, seq_len=self.S)
        run.readings["traced_launches"] = program.launch_counts()

    def release(self) -> None:
        self.pipe.stop()
        del self.state, self.step, self.pipe
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, Dict]:
        run, doc, mix = self.run, self.run.doc, self.run.mix
        vocab = doc["model"]["vocab_size"]
        ref = reftrain.steps(doc, mix, run.seed, self.rows, self.dev, against=self.prog)
        numbers = checks.train_numbers(self.prog, ref)
        numbers["rows_unmatched"] = reftrain.check_rows(run.seed, mix, vocab, self.rows)
        run.numbers = numbers
        run.readings.update(check_loss_program=self.prog["loss"], check_loss_reference=ref["loss"],
                            reference_readings=ref["readings"])
        return checks.judged(numbers, run.limits(self.kind))
