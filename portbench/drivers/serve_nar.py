"""Batch serving of a NAR captioner with its AR teacher (``"driver":
"serve_nar"``): ``serve``'s closed loop over
``Translator.translate_batches(student, batches, depth, teacher=teacher)``,
the call ``translate.py``'s ``run_eval`` makes with ``--teacher_path``.
Both models come from the program, filled with the weights maker's draws
for the judge's names (the teacher's under the judge's prefix).

A caption fails only if it is empty (every token PAD); special tokens that
random weights choose stay, since the reference chooses them too. Before
the program is freed (``release``), the batches of the sampled requests
are decoded once more by the same student, teacher and translator under
the judge's ``record``, which keeps every pass's canvas and output for the
judge's comparison.
"""

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import lookup, program
from portbench.drivers import serve


class Driver(serve.Driver):
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
        self.opt, self.model, self.teacher = self.judge.build(
            cfg, self.weights, device)
        self.translator = get_translator(self.opt, device)
        mark("program")
        self.order = traffic.order(len(self.pool), self.rng)
        self.results = []
        self._run(mix["warmup_batches"], None, keep=False)
        mark("warm-up, kernels loaded or built")
        self.setup_parts = mark.parts

    def _decode(self, batches):
        return self.translator.translate_batches(
            self.model, batches, depth=self.mix.get("depth", 2),
            teacher=self.teacher)

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
        for _, (hyps, lprobs) in self._decode(batches()):
            if keep:
                self.results.append((issued[done], hyps, lprobs))
            done += 1
        return issued

    @staticmethod
    def _empty(hyp) -> bool:
        return not hyp or not any(t != 0 for t in hyp[0])

    @property
    def shapes(self):
        return {"batch": self.mix["batch"],
                "length_beam": self.m["length_beam_size"],
                "max_len": self.m["max_len"]}

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
                       for h in hyps if not self._empty(h))
        return {"window_s": t1 - t0, "batches": len(issued),
                "videos": self.mix["batch"] * len(issued),
                "captions": captions}

    def requests(self) -> list:
        """The sampled finished requests: (pool index, row, tokens,
        log-probabilities), drawn from the seed."""
        flat = [(b, r, hyps[r][0], lprobs[r][0])
                for b, hyps, lprobs in self.results
                for r in range(len(hyps)) if hyps[r]]
        n = min(self.mix["sample"], len(flat))
        return [flat[i] for i in self.rng.permutation(len(flat))[:n]]

    def release(self):
        """Replay the sampled requests' batches under the judge's record,
        then free the program."""
        self.sampled = self.requests()
        order = sorted({b for b, *_ in self.sampled})
        lbs = self.m["length_beam_size"]
        with self.judge.record(self.translator) as decodes:
            replayed = [out for _, out in self._decode(
                {"feats": [self._put(x) for x in self.pool[b]]}
                for b in order)]
        again = dict(zip(order, zip(replayed, decodes)))
        self.replays = []
        for b, row, tokens, lprobs in self.sampled:
            (hyps, lps), rec = again[b]
            self.replays.append(((hyps[row][0], lps[row][0]),
                                 self.judge.video_record(rec, row, lbs)))
        del decodes, again
        super().release()
        del self.teacher

    def check(self, control=None):
        """(readings, attempted, failed); with ``control`` (a precision
        name) also the control's readings, under ``control_<name>``."""
        attempted = sum(len(h) for _, h, _ in self.results)
        failed = sum(1 for _, h, _ in self.results for x in h
                     if self._empty(x))
        requests = [{"feats": {c: x[row:row + 1] for c, x in
                               zip(self.m["modality"], self.pool[b])},
                     "tokens": tokens, "lprobs": lprobs, "replay": replay,
                     "record": rec}
                    for (b, row, tokens, lprobs), (replay, rec)
                    in zip(self.sampled, self.replays)]
        readings = self.judge.serve_readings(self.weights, self.m, requests,
                                             self.device, control=control)
        return readings, attempted, failed
