"""Serving: a closed loop of offline rounds through the port's
``make_prefill_step`` and ``make_decode_step``.

A round takes the traffic's ``prompts`` prompts of ``prompt_len`` tokens,
allocates a fresh decode state, prefills them in one call, then runs
``decode_steps`` greedy steps with the argmax on the device.  Each served
token goes to the host as soon as it is made, as a server streams it: a
decode step is timed from its call to its tokens' copy to the host, and the
prefill from the state's allocation to the first tokens' copy.  Set-up
serves round 0 (one prefill and two decode steps) to warm both shapes; the
window serves rounds 1, 2, ... and closes at the end of the first decode
step after the given seconds.  The traced run profiles one more prefill and
``traced_decode_steps`` decode steps after the window.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from h100bench.lib import checks, program, trace, weights
from h100bench.lib import traffic as trafficmod
from h100bench.lib.cell import Run
from h100bench.reference import serve as refserve


class Driver:
    kind = "serve"

    def __init__(self, run: Run):
        self.run = run
        self.dev = run.device

    def setup(self) -> None:
        from repro_torch.models.model_api import build
        from repro_torch.train.step import make_decode_step, make_prefill_step

        run, doc, mix = self.run, self.run.doc, self.run.mix
        model_doc = doc["model"]
        self.model = build(program.arch_config(model_doc))
        self.ctx = program.spmd_ctx(doc)
        self.params = weights.make_params(model_doc, doc["init"], mix, run.seed, self.dev)
        weights.check_layout(self.params, self.model.specs())
        self.prefill = make_prefill_step(self.model, self.ctx)
        self.decode = make_decode_step(self.model, self.ctx)
        self.B, self.S = int(mix["prompts"]), int(mix["prompt_len"])
        self.n_dec = int(mix["decode_steps"])
        self.vocab = model_doc["vocab_size"]
        self._serve(0, 2, None)
        program.sync(self.dev)

    # ------------------------------------------------------------------ #

    def _serve(self, r: int, steps: int, deadline, traced: bool = False) -> Tuple[np.ndarray, List[float], float, bool]:
        """Round ``r`` with ``steps`` decode steps: (served tokens (B, n),
        each decode step's seconds, the prefill's seconds, whether it ran to
        its end).  With a ``deadline`` it stops after the first decode step
        that ends past it."""
        prompts = torch.from_numpy(trafficmod.prompts(self.run.seed, self.run.mix, self.vocab, r)).to(self.dev)
        served = np.zeros((self.B, steps + 1), np.int64)
        t0 = time.perf_counter()
        with trace.span("prefill", traced):
            # Every round's cache holds a whole round, whatever it serves.
            state = self.model.decode_state_init(self.B, self.S + self.n_dec, device=self.dev, ctx=self.ctx)
            logits, state = self.prefill(self.params, state, {"tokens": prompts})
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            served[:, 0] = tok.cpu().numpy()[:, 0]
        prefill_s = time.perf_counter() - t0
        times: List[float] = []
        with trace.span("decode", traced):
            for i in range(steps):
                t = time.perf_counter()
                logits, state = self.decode(self.params, state, tok)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                served[:, i + 1] = tok.cpu().numpy()[:, 0]
                times.append(time.perf_counter() - t)
                if deadline is not None and time.perf_counter() >= deadline and i + 1 < steps:
                    del state
                    return served[:, :i + 2], times, prefill_s, False
        del state
        return served, times, prefill_s, True

    def window(self, t_start: float) -> None:
        run = self.run
        deadline = t_start + run.seconds
        self.rounds: Dict[int, np.ndarray] = {}
        steps_s: List[float] = []
        prefill_s: List[float] = []
        tokens, requests, cut, r = 0, 0, 0, 0
        while time.perf_counter() < deadline:
            r += 1
            served, times, pf, whole = self._serve(r, self.n_dec, deadline)
            steps_s += times
            prefill_s.append(pf)
            tokens += served.size
            if whole:
                self.rounds[r] = served
                requests += self.B
            else:
                cut += self.B
        program.sync(self.dev)
        run.window_s = time.perf_counter() - t_start
        run.spans["decode_step"] = steps_s
        run.spans["prefill"] = prefill_s
        run.end_to_end["gen_tokens_per_s"] = tokens / run.window_s
        run.end_to_end["decode_step_ms_p95"] = 1e3 * float(np.percentile(steps_s, 95)) if steps_s else float("nan")
        run.readings.update(rounds=r, rounds_whole=len(self.rounds), decode_steps=len(steps_s),
                            generated_tokens=tokens, prompt_tokens=r * self.B * self.S, window_s=run.window_s,
                            requests_cut_at_close=cut)
        run.traced_info.update(window_tokens=tokens + r * self.B * self.S)
        bad = sum(int(((s < 0) | (s >= self.vocab)).any(axis=1).sum()) for s in self.rounds.values())
        run.attempted, run.failed = requests, bad

    def traced(self) -> None:
        run = self.run
        steps = int(run.mix["traced_decode_steps"])
        program.reset_launch_counts()
        program.sync(self.dev)
        with trace.profiled(self.dev.type) as out:
            with trace.span("traced", True):
                self._serve(0, steps, None, traced=True)
                program.sync(self.dev)
        run.traced = out[0]
        run.traced_info.update(decode_steps=steps, prompts=self.B, prompt_len=self.S)
        run.readings["traced_launches"] = program.launch_counts()

    def release(self) -> None:
        del self.params, self.prefill, self.decode
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, Dict]:
        run = self.run
        if not self.rounds:
            run.numbers = {"logit_gap": float("nan"), "tokens_out_of_vocab": float("nan")}
            run.readings["check"] = "no round finished inside the window"
            return checks.judged(run.numbers, run.limits(self.kind))
        rng = np.random.default_rng([run.seed % 2**64, 0x43484B])
        r = int(rng.choice(sorted(self.rounds)))
        served = self.rounds[r]
        bad = int(((served < 0) | (served >= self.vocab)).sum())
        numbers = {"tokens_out_of_vocab": bad}
        if bad:
            numbers["logit_gap"] = float("inf")
        else:
            ref = refserve.round_gaps(run.doc, run.mix, run.seed, r, served, self.dev)
            numbers.update(logit_gap=ref["gap"], mean_gap=ref["mean_gap"], not_best=ref["not_best"])
            run.readings.update(checked_round=r, checked_tokens=int(served.size),
                                reference_readings=ref["readings"])
        run.numbers = numbers
        return checks.judged(numbers, run.limits(self.kind))
