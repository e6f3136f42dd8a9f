"""Per-video latency (``"driver": "latency"``): ``translate.py
--latency``'s protocol, one video at a time (batches of one) through
``Translator.translate_batch``, strictly in turn. A video's
latency runs from the start of its feature copy to the card until its
caption is on the host; the window closes with the first video that ends
after its seconds.
"""

import time

from torch.profiler import record_function

from portbench import program
from portbench.drivers import serve


class Driver(serve.Driver):
    def _run(self, n_videos, t_end, keep=True):
        self.latencies = []
        count = 0
        while (count < n_videos if t_end is None
               else time.perf_counter() < t_end):
            idx = next(self.order)
            t0 = time.perf_counter()
            with record_function("portbench.video"):
                batch = {"feats": [self._put(x) for x in self.pool[idx]]}
                hyps, scores = self.translator.translate_batch(self.model,
                                                               batch)
            self.latencies.append(time.perf_counter() - t0)
            if keep:
                self.results.append((idx, hyps, scores))
            count += 1

    def window(self, seconds: float, tracer) -> dict:
        program.sync(self.device)
        first = len(self.results)
        tracer.start()
        with record_function("portbench.window"):
            t0 = time.perf_counter()
            self._run(None, t0 + seconds)
            t1 = time.perf_counter()
        tracer.stop()
        return {"window_s": t1 - t0, "batches": len(self.latencies),
                "videos": len(self.latencies),
                "captions": sum(1 for _, h, _ in self.results[first:]
                                if h and h[0] and h[0][0]),
                "latencies_s": list(self.latencies)}
