"""Batch serving (``"driver": "serve"``): a closed loop over
``Translator.translate_batches`` at the mix's batch size and depth, as
``translate.py``'s ``run_eval`` drives it: each batch's host features are
copied to the card as its ``to_device`` copies them, and the window runs
from its start to the collection of the last caption. Batches come from
the mix's generator in its order; batches stop being issued once the
window's seconds have passed, and those in flight finish inside it. The
weights come from the configuration's weights maker, and the judge the
configuration names holds the sampled captions against its reference.
"""

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import lookup, program


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from care_tpu_torch.decoding import get_translator
        self.m, self.mix, self.device = cfg["model"], mix, device
        self.judge = lookup.module("judges", cfg["judge"])
        self.rng = np.random.default_rng(seed)
        mark = program.Marks(device)
        traffic = lookup.module("generators", mix["generator"])
        self.pool = traffic.make(self.m, mix, seed, device)
        mark("traffic")
        self.weights = lookup.module("weights", cfg["weights"]).make(
            self.judge.param_shapes(self.m), seed, device, self.m)
        mark("weights")
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.opt = program.program_opt(cfg)
        self.model = program.build_model(self.opt, self.weights, device)
        self.translator = get_translator(self.opt, device)
        mark("program")
        self.order = traffic.order(len(self.pool), self.rng)
        self.results = []
        self._run(mix["warmup_batches"], None, keep=False)
        mark("warm-up, kernels loaded or built")
        self.setup_parts = mark.parts

    def _put(self, x):
        # run_eval's put: f32 features, integer streams as int64
        t = torch.as_tensor(np.asarray(x))
        return t.to(self.device, torch.float32 if t.is_floating_point()
                    else torch.long)

    def _run(self, n_batches, t_end, keep=True):
        issued = []

        def batches():
            while (len(issued) < n_batches if t_end is None
                   else time.perf_counter() < t_end):
                idx = next(self.order)
                issued.append(idx)
                with record_function("portbench.h2d"):
                    feats = [self._put(x) for x in self.pool[idx]]
                yield {"feats": feats}

        done = 0
        for _, (hyps, scores) in self.translator.translate_batches(
                self.model, batches(), depth=self.mix.get("depth", 2)):
            if keep:
                self.results.append((issued[done], hyps, scores))
            done += 1
        return issued

    @property
    def counters(self):
        return program.counters(translator=self.translator)

    @property
    def shapes(self):
        return {"batch": self.mix["batch"], "beam": self.m["beam_size"]}

    def window(self, seconds: float, tracer) -> dict:
        program.sync(self.device)
        first = len(self.results)
        tracer.start()
        with record_function("portbench.window"):
            t0 = time.perf_counter()
            issued = self._run(None, t0 + seconds)
            t1 = time.perf_counter()
        tracer.stop()
        captions = sum(1 for _, hyps, _ in self.results[first:]
                       for h in hyps if h and len(h[0]) > 0)
        return {"window_s": t1 - t0, "batches": len(issued),
                "videos": self.mix["batch"] * len(issued),
                "captions": captions}

    def release(self):
        del self.model, self.translator
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def requests(self) -> list:
        """The sampled finished requests: (pool index, row, tokens, score),
        the longest caption among them."""
        flat = [(b, r, hyps[r][0], scores[r][0])
                for b, hyps, scores in self.results
                for r in range(len(hyps)) if hyps[r]]
        n = min(self.mix["sample"], len(flat))
        longest = max(range(len(flat)), key=lambda i: len(flat[i][2]))
        rest = [i for i in self.rng.permutation(len(flat)).tolist()
                if i != longest][:n - 1]
        return [flat[i] for i in [longest] + rest]

    def check(self, control=None):
        """(readings, attempted, failed); with ``control`` (a precision
        name) also the control's readings, under ``control_<name>``."""
        attempted = sum(len(h) for _, h, _ in self.results)
        failed = sum(1 for _, h, _ in self.results for x in h
                     if not x or not x[0])
        readings = self.judge.serve_readings(
            self.weights, self.m, dict(enumerate(self.pool)),
            self.requests(), self.device, control=control)
        return readings, attempted, failed
